"""SAM in the PyTorch port against the JAX package, on seeded Flax
parameters bridged into the port (fp32, TINY_SAM), with non-zero
relative-position tables (the JAX package's zero init would hide a
mis-scaled rel-pos bias).

Tolerances: mask logits 1e-4 of their max-abs, predicted IoU 1e-5
max-abs, the image embedding 1e-4 of its max-abs; the bridge round trips
bit-exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models import sam as jsam
from anyedit_tpu.weights.convert import convert_sam
from anyedit_tpu_torch.models import sam as tsam
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_SAM = dataclasses.replace(jsam.TINY_SAM, dtype=jnp.float32)
PORT_SAM = dataclasses.replace(tsam.TINY_SAM, dtype=torch.float32)
BOXES = np.array([[[8.0, 8.0, 40.0, 40.0], [16.0, 16.0, 56.0, 48.0],
                   [0.0, 30.0, 63.0, 63.0]]], np.float32)


def sam_params(seed=4):
    return random_flax_params(jsam.SAM(JAX_SAM),
                              (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4))), seed)


@pytest.fixture(scope="module")
def params():
    p = sam_params()
    assert np.abs(p["params"]["encoder"]["block_1"]["rel_h"]).max() > 0.1
    return p


@pytest.fixture(scope="module")
def outputs(params):
    """(JAX, port) of (embedding, masks, iou) on one seeded image."""
    px = np.random.default_rng(12).standard_normal((1, 64, 64, 3)).astype(np.float32)
    m = jsam.SAM(JAX_SAM)

    @jax.jit
    def run(p, x, b):
        emb = m.apply(p, x, method=jsam.SAM.encode)
        return (emb,) + m.apply(p, emb, b, method=jsam.SAM.decode_boxes)
    ref = [np.asarray(a) for a in run(params, jnp.asarray(px), jnp.asarray(BOXES))]
    tm = tsam.SAM(PORT_SAM)
    tm.load_state_dict(bridge.sam_state_dict(params), strict=True)
    with torch.no_grad():
        emb = tm.encode(T(px))
        got = [emb.numpy()] + [a.numpy() for a in tm.decode_boxes(emb, T(BOXES))]
    return ref, got


def test_sam_encode_matches(outputs):
    """The ViT encoder (windowed and global blocks with the rel-pos bias
    from the unscaled q) and the neck."""
    (ref, _, _), (got, _, _) = outputs
    assert got.shape == ref.shape == (1, 8, 8, 32)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sam_decode_matches(outputs):
    """Mask logits and IoU per box: the prompt encoder, the two-way blocks
    (block 0 without residual, q_pe the full token embedding), the
    ConvTranspose upscaling with tanh GELU, the hypernetworks."""
    (_, rm, ri), (_, gm, gi) = outputs
    assert gm.shape == rm.shape == (3, 4, 32, 32) and gi.shape == ri.shape == (3, 4)
    assert np.abs(gm - rm).max() <= 1e-4 * np.abs(rm).max()
    np.testing.assert_allclose(gi, ri, atol=1e-5, rtol=0)


def test_sam_bridge_round_trips_through_converter(params):
    """The bridged state dict, with the box corners stacked back into
    convert.py's `box_corner_embeddings`, gives the Flax tree back
    bit-exactly through `convert_sam`; `sam_tree` inverts the bridge."""
    sd = {k: v.numpy() for k, v in bridge.sam_state_dict(params).items()}
    assert sd["image_encoder.pos_embed"].shape == (1, 8, 8, 32)
    assert sd["prompt_encoder.no_mask_embed.weight"].shape == (1, 32)
    assert sd["mask_decoder.output_upscaling.0.weight"].shape == (32, 8, 2, 2)  # (I, O, kH, kW)
    src = dict(sd)
    src["prompt_encoder.box_corner_embeddings"] = np.concatenate(
        [src.pop("prompt_encoder.point_embeddings.2.weight"),
         src.pop("prompt_encoder.point_embeddings.3.weight")])
    back = convert_sam(params["params"], src)
    flat_a = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    tree = bridge.sam_tree(bridge.sam_state_dict(params), params)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
