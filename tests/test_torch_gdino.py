"""GroundingDINO in the PyTorch port against the JAX package: its towers
(Swin, BERT), `segment_text_masks`, the whole detector at TINY_GDINO, and
the weight bridge, on seeded Flax parameters bridged into the port (fp32).

Tolerances: Swin and BERT outputs 1e-4 of their max-abs; the text masks
identical; TINY_GDINO logits 1e-3 and boxes 1e-4 max-abs, with the same
top-k query selection; the bridge round trips bit-exactly.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models import bert as jbert
from anyedit_tpu.models import gdino as jgdino
from anyedit_tpu.models import swin as jswin
from anyedit_tpu.weights.convert import convert_gdino
from anyedit_tpu_torch.models import gdino as tgdino
from anyedit_tpu_torch.models.bert import BertEncoder
from anyedit_tpu_torch.models.layers import GroupNorm
from anyedit_tpu_torch.models.swin import SwinTransformer
from anyedit_tpu_torch.runtime.zoo import tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
F32 = dict(dtype=jnp.float32)
# the port's tiny detector (fp32 towers, BERT vocab 30522) and its JAX twin
PORT_GDINO = tiny_zoo_config().gdino
JAX_GDINO = dataclasses.replace(
    jgdino.TINY_GDINO, swin=dataclasses.replace(jswin.TINY_SWIN, **F32),
    bert=dataclasses.replace(jbert.TINY_BERT, vocab_size=30522, **F32), **F32)
CLS, SEP, DOT = 101, 102, 1012
IDS = np.array([[CLS, 7592, 3899, DOT, 2088, DOT, SEP] + [0] * 9,
                [CLS, 4937, 2003, 1037, SEP] + [0] * 11], np.int64)
MASK = IDS != 0


def _rel_close(got, ref, tol):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, (np.abs(got - ref).max(), scale)


def gdino_params(seed=3):
    return random_flax_params(jgdino.GroundingDINO(JAX_GDINO),
                              (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16), jnp.int32),
                               jnp.ones((1, 16), bool)), seed)


@pytest.fixture(scope="module")
def params():
    return gdino_params()


@pytest.fixture(scope="module")
def port(params):
    m = tgdino.GroundingDINO(PORT_GDINO)
    m.load_state_dict(bridge.gdino_state_dict(params), strict=True)
    return m.eval()


def test_segment_text_masks_match():
    """Within-phrase attention bias and per-segment positions, identical."""
    jb, jp = jax.jit(jgdino.segment_text_masks, static_argnums=2)(
        jnp.asarray(IDS), jnp.asarray(MASK), (CLS, SEP, DOT))
    tb, tp = tgdino.segment_text_masks(T(IDS), T(MASK), (CLS, SEP, DOT))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_bert_matches(params):
    """The text tower with the segment mask and restarted positions."""
    p = {"params": params["params"]["bert"]}
    bias, pos = (np.array(a) for a in jax.jit(jgdino.segment_text_masks, static_argnums=2)(
        jnp.asarray(IDS), jnp.asarray(MASK), (CLS, SEP, DOT)))
    ref = jax.jit(jbert.BertEncoder(JAX_GDINO.bert).apply)(
        p, jnp.asarray(IDS), jnp.asarray(bias), position_ids=jnp.asarray(pos))
    m = BertEncoder(PORT_GDINO.bert)
    m.load_state_dict(bridge._bridge(p, lambda path: bridge._bert_key(
        bridge._strip(path), "")), strict=True)
    with torch.no_grad():
        got = m(T(IDS), T(bias), position_ids=T(pos).long())
    _rel_close(got.numpy(), np.asarray(ref), 1e-4)


def test_swin_matches():
    """Swin at two blocks a stage (the second shifted): window padding
    (10 x 9 tokens in 4-wide windows), the roll and the shift mask, an odd
    map into patch merging, and both output strides."""
    hw = (40, 36)
    jcfg = dataclasses.replace(JAX_GDINO.swin, depths=(2, 2))
    tcfg = dataclasses.replace(PORT_GDINO.swin, depths=(2, 2))
    x = np.random.default_rng(9).standard_normal((1,) + hw + (3,)).astype(np.float32)
    m = jswin.SwinTransformer(jcfg)
    p = random_flax_params(m, (jnp.asarray(x),), 5)
    ref = jax.jit(m.apply)(p, jnp.asarray(x))
    tm = SwinTransformer(tcfg)
    tm.load_state_dict(bridge._bridge(p, lambda path: bridge._swin_key(
        bridge._strip(path), "")), strict=True)
    with torch.no_grad():
        got = tm(T(x))
    assert sorted(got) == sorted(ref) == [4, 8]
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        _rel_close(got[k].numpy(), np.asarray(ref[k]), 1e-4)


@pytest.fixture(scope="module")
def detections(params, port):
    """(JAX logits, boxes, top-k indices) and the port's, on one seeded
    image and two captions. The JAX indices are recomputed from the
    captured query-selection inputs with `jax.lax.top_k`; the port's are
    recorded from its own `top_k`."""
    px = np.random.default_rng(11).standard_normal((2, 64, 64, 3)).astype(np.float32)
    m = jgdino.GroundingDINO(JAX_GDINO)
    run = jax.jit(lambda p, x, i, k: m.apply(p, x, i, k, capture_intermediates=True,
                                             mutable=["intermediates"]))
    (jl, jb), inter = run(params, jnp.asarray(px), jnp.asarray(IDS, jnp.int32),
                          jnp.asarray(MASK))
    inter = inter["intermediates"]
    mem = inter["mem_ln"]["__call__"][0]
    txt = inter[f"enc_{JAX_GDINO.enc_layers - 1}"]["__call__"][0][1]
    sim = jnp.einsum("bsc,btc->bst", mem, txt.astype(jnp.float32))
    score = jnp.max(jnp.where(jnp.asarray(MASK)[:, None, :], sim, -1e9), axis=-1)
    j_idx = np.asarray(jax.lax.top_k(score, JAX_GDINO.num_queries)[1])

    seen = []
    orig = tgdino.top_k

    def recording_top_k(x, k):
        out = orig(x, k)
        seen.append(out[1])
        return out
    tgdino.top_k = recording_top_k
    try:
        with torch.no_grad():
            tl, tb = port(T(px), T(IDS), T(MASK))
    finally:
        tgdino.top_k = orig
    return (np.asarray(jl), np.asarray(jb), j_idx), (tl.numpy(), tb.numpy(), seen[0].numpy())


def test_gdino_query_selection_matches(detections):
    """The same top-k query indices, in the same order."""
    (_, _, j_idx), (_, _, t_idx) = detections
    np.testing.assert_array_equal(t_idx, j_idx)


def test_gdino_logits_and_boxes_match(detections):
    """TINY_GDINO end to end: phrase logits at the real tokens within 1e-3,
    boxes within 1e-4; padded tokens at -1e9 on both sides."""
    (jl, jb, _), (tl, tb, _) = detections
    assert np.abs(tl[MASK[:, None, :].repeat(tl.shape[1], 1)]
                  - jl[MASK[:, None, :].repeat(jl.shape[1], 1)]).max() <= 1e-3
    np.testing.assert_allclose(tb, jb, atol=1e-4, rtol=0)
    assert (tl[~MASK[:, None, :].repeat(tl.shape[1], 1)] == -1e9).all()
    assert np.isfinite(tb).all() and ((tb >= 0) & (tb <= 1)).all()


def _swin_merge_to_convert(key: str) -> str:
    """The bridge keeps the official `layers.I.downsample` (the merge after
    stage I); convert.py's `_swin_key` reads it as `layers.{I-1}`."""
    m = re.match(r"(backbone\.0\.layers\.)(\d+)(\.downsample\..*)$", key)
    return f"{m[1]}{int(m[2]) - 1}{m[3]}" if m else key


def test_gdino_bridge_round_trips_through_converter(params):
    """The bridged state dict, fed back through `convert_gdino`, gives the
    Flax tree back bit-exactly; the fused in_proj tensors are the three
    `_split3` thirds; and `gdino_tree` inverts the bridge."""
    sd = {k: v.numpy() for k, v in bridge.gdino_state_dict(params).items()}
    back = convert_gdino(params["params"], {_swin_merge_to_convert(k): v for k, v in sd.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    fused = sd["transformer.decoder.layers.0.ca_text.in_proj_weight"]
    c = fused.shape[1]
    np.testing.assert_array_equal(fused[c:2 * c].T,
                                  np.asarray(params["params"]["dec_0"]["ck"]["kernel"]))
    tree = bridge.gdino_tree(bridge.gdino_state_dict(params), params)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


def test_gdino_structure(port):
    """Every input-projection norm is the port's GroupNorm (K2 on the card),
    32 groups at full width; the official checkpoint's key names."""
    norms = [proj[1] for proj in port.input_proj]
    assert len(norms) == PORT_GDINO.num_levels
    assert all(isinstance(n, GroupNorm) and n.num_groups == min(32, PORT_GDINO.hidden)
               for n in norms)
    keys = set(port.state_dict())
    for want in ("backbone.0.patch_embed.proj.weight", "backbone.0.layers.0.downsample.norm.weight",
                 "bert.encoder.layer.0.attention.self.query.weight",
                 "transformer.encoder.fusion_layers.0.attn.v_proj.weight",
                 "transformer.encoder.text_layers.0.self_attn.in_proj_weight",
                 "transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
                 "transformer.decoder.layers.0.ca_text.in_proj_bias",
                 "transformer.decoder.ref_point_head.layers.1.weight",
                 "transformer.enc_out_bbox_embed.layers.2.weight",
                 "bbox_embed.0.layers.2.weight", "input_proj.1.1.weight",
                 "feat_map.weight", "transformer.tgt_embed.weight",
                 "transformer.level_embed"):
        assert want in keys, want


def test_gdino_extra_level_matches_on_odd_map():
    """TINY_GDINO with one more level than the backbone's maps, so the last
    level is the stride-2 3x3 conv of the last map, on 40 px images whose
    last map is 5x5: an odd side, where the port's (1, 1) padding and the
    JAX module's "SAME" agree. Logits 1e-3, boxes 1e-4 max-abs, as above."""
    jcfg = dataclasses.replace(JAX_GDINO, num_levels=3)
    tcfg = dataclasses.replace(PORT_GDINO, num_levels=3)
    m = jgdino.GroundingDINO(jcfg)
    params = random_flax_params(m, (jnp.zeros((1, 40, 40, 3)), jnp.zeros((1, 16), jnp.int32),
                                    jnp.ones((1, 16), bool)), 6)
    port = tgdino.GroundingDINO(tcfg)
    port.load_state_dict(bridge.gdino_state_dict(params), strict=True)
    px = np.random.default_rng(12).standard_normal((2, 40, 40, 3)).astype(np.float32)
    jl, jb = jax.jit(m.apply)(params, jnp.asarray(px), jnp.asarray(IDS, jnp.int32),
                              jnp.asarray(MASK))
    with torch.no_grad():
        levels = port.eval().vision(T(px))
        tl, tb = port(T(px), T(IDS), T(MASK))
    assert [tuple(x.shape[2:]) for x in levels] == [(10, 10), (5, 5), (3, 3)]
    keep = MASK[:, None, :].repeat(tl.shape[1], 1)
    assert np.abs(tl.numpy()[keep] - np.asarray(jl)[keep]).max() <= 1e-3
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4, rtol=0)
