"""Depth-Anything-V2 in the PyTorch port against the JAX package: DINOv2
(the class token, the patch tokens and the normed intermediate layers), the
DPT head's 4x and 2x transposed convolutions alone (the layout hazard of
PARITY.md: a kernel applied spatially reversed still runs), the whole
`DepthAnythingV2` at TINY_DEPTH, `depth_to_u8`, the zoo's `depth_fn()`
against the JAX zoo's, and the `depth` bridge slot read back by the JAX
package's `convert_depth_anything`.

Tolerances, all in fp32: the backbone's outputs, the transposed convs and
the depth map within max-abs 1e-4; `depth_to_u8` exactly on the same map;
`depth_fn`'s uint8 map within 1 level on at most 1 % of the pixels (a value
near a rounding boundary may land on either side); the bridge exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from anyedit_tpu.models import depth as jdepth
from anyedit_tpu.models import dinov2 as jdino
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import convert_depth_anything, save_params
from anyedit_tpu_torch.models import depth as tdepth
from anyedit_tpu_torch.models import dinov2 as tdino
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, TF32, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_DEPTH = dataclasses.replace(jdepth.TINY_DEPTH, backbone=dataclasses.replace(
    jdino.TINY_DINO, **F32), **F32)
PORT_DEPTH = dataclasses.replace(tdepth.TINY_DEPTH, backbone=dataclasses.replace(
    tdino.TINY_DINO, **TF32), **TF32)
S = JAX_DEPTH.backbone.img_size
ATOL = 1e-4


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _pixels(seed, size=S):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def depth_tree():
    return random_flax_params(jdepth.DepthAnythingV2(JAX_DEPTH), (_pixels(0),), 60)


def _port_model(tree):
    m = tdepth.DepthAnythingV2(PORT_DEPTH)
    m.load_state_dict(bridge.depth_state_dict(tree))
    return m.eval()


def test_dinov2_matches(depth_tree):
    """The backbone with its bridged weights: the class token, the patch
    tokens and intermediate layers 0 and 1 (after the final norm)."""
    jb = jdino.DinoV2(JAX_DEPTH.backbone, return_layers=(0, 1))
    px = _pixels(1)
    ref = jb.apply({"params": depth_tree["params"]["backbone"]}, px)
    with torch.no_grad():
        got = _port_model(depth_tree).pretrained(T(px))
    for k in ("cls", "patch"):
        _close(got[k], ref[k])
    assert sorted(got["layers"]) == [0, 1]
    for i in (0, 1):
        _close(got["layers"][i], ref["layers"][i])


class _JaxConvT(fnn.Module):
    k: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(6, (self.k, self.k), strides=(self.k, self.k),
                                 padding="VALID", transpose_kernel=True)(x)


@pytest.mark.parametrize("k", [4, 2])
def test_dpt_transposed_conv_layout(k):
    """The DPT head's learned 4x / 2x upsample: flax `ConvTranspose(
    transpose_kernel=True)` with the kernel (kH, kW, O, I) against torch's
    ConvTranspose2d with the bridge's (I, O, kH, kW), on an input whose
    every output pixel has its own kernel tap; a spatially reversed kernel
    would fail."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, 3, 5, 4)).astype(np.float32)
    kern = rng.standard_normal((k, k, 6, 4)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    ref = _JaxConvT(k).apply({"params": {"ConvTranspose_0": {"kernel": kern, "bias": bias}}}, x)
    sd = bridge.depth_state_dict({"params": {"head": {f"resize_{ {4: 0, 2: 1}[k]}": {
        "kernel": kern, "bias": bias}}}})
    w = next(v for key, v in sd.items() if key.endswith("weight"))
    assert tuple(w.shape) == (4, 6, k, k)
    conv = torch.nn.ConvTranspose2d(4, 6, k, stride=k)
    conv.load_state_dict({"weight": w, "bias": T(bias)})
    with torch.no_grad():
        got = conv(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, ref, 1e-5)
    flipped = np.asarray(ref) - np.asarray(_JaxConvT(k).apply(
        {"params": {"ConvTranspose_0": {"kernel": kern[::-1, ::-1], "bias": bias}}}, x))
    assert np.abs(flipped).max() > 0.1


def test_depth_anything_matches(depth_tree):
    """The whole TINY_DEPTH model: the relative depth map (B, S, S) within
    1e-4 (the head's antialiased bilinear resizes included), and
    `depth_to_u8` of it exactly."""
    px = _pixels(2)
    ref = jdepth.DepthAnythingV2(JAX_DEPTH).apply(depth_tree, px)
    with torch.no_grad():
        got = _port_model(depth_tree)(T(px))
    _close(got, ref)
    assert float(got.std()) > 1e-3
    np.testing.assert_array_equal(tdepth.depth_to_u8(T(np.asarray(ref))).numpy(),
                                  np.asarray(jdepth.depth_to_u8(ref)))


def test_depth_bridge_round_trips(depth_tree):
    """The `depth` slot's state dict: the official Depth-Anything-V2 names,
    which the JAX package's `convert_depth_anything` reads back into the
    tree exactly; the port module's keys exactly."""
    sd = bridge.depth_state_dict(depth_tree)
    assert set(sd) == set(tdepth.DepthAnythingV2(PORT_DEPTH).state_dict())
    for k in ("pretrained.cls_token", "pretrained.blocks.1.ls2.gamma",
              "depth_head.resize_layers.0.weight", "depth_head.scratch.output_conv2.2.bias",
              "depth_head.scratch.refinenet1.resConfUnit1.conv2.weight"):
        assert k in sd, k
    back = convert_depth_anything(depth_tree, {k: v.numpy() for k, v in sd.items()})
    fa = jax.tree_util.tree_flatten_with_path(depth_tree)[0]
    fb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, a), (_, b) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    tree = bridge.depth_tree(sd, depth_tree)
    np.testing.assert_array_equal(tree["params"]["head"]["resize_0"]["kernel"],
                                  depth_tree["params"]["head"]["resize_0"]["kernel"])


def test_depth_fn_matches(tmp_path, depth_tree):
    """`ModelZoo.depth_fn()` against the JAX zoo's on the same weights: a
    48x40 image -> a (48, 40) uint8 map."""
    save_params(depth_tree, tmp_path / "depth.msgpack")
    cfg = tiny_zoo_config()
    jzoo = JaxModelZoo(JaxZooConfig(canvas=cfg.canvas, depth_cfg=JAX_DEPTH),
                       weights_dir=tmp_path, allow_fallback_tokenizers=True)
    zoo = ModelZoo(cfg, device="cpu", params={"depth": depth_tree})
    assert zoo.cfg.depth_cfg == PORT_DEPTH
    img = np.random.default_rng(3).integers(0, 256, (48, 40, 3), np.uint8)
    ref = np.asarray(jzoo.depth_fn()(img)).astype(np.int32)
    got = zoo.depth_fn()(img)
    assert got.dtype == np.uint8 and got.shape == (48, 40)
    d = np.abs(got.astype(np.int32) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
    assert got.std() > 1.0
