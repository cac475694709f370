"""visual_reference (AnyDoor) in the PyTorch port against the JAX package:
DINOv2 with the SwiGLU FFN at a tiny width, the `dinov2_g` bridge,
`sobel_magnitude`, `build_collage`, the SD2.1-class UNet layout
(SD21_ANYDOOR_UNET's heads) and, at the tiny config, the UNet with its
ControlNet on a 4-channel hint, the zoo's `anydoor()` and `dino_embed()`
against the JAX zoo's on the same params with JAX's start noise handed to
the port, the pipeline (its completeness gate too), and one record through
both `FactoryExecutor`s.

The JAX zoo picks DINOV2_G at 224 px when it has a weights dir; the test
swaps its DINOV2_G for a 2-block SwiGLU tower of width 32 (`TINY_G`), which
the port's `ZooConfig.dino_cfg` names at the same 224 px. The JAX zoo takes
its TPU attention route (K1's max-free softmax in fp32 at 1,024 tokens, as
the port's on every device: `test_torch_ultraedit.zoo_pair`).

Tolerances, all in fp32: DINOv2's tokens, the ControlNet's residuals, the
UNet's noise prediction and the DINO embedding within max-abs 1e-4;
`sobel_magnitude` within 1e-4 + 1e-6 relative (magnitudes up to 1e3);
the collage within 1 uint8 level on at most 0.5 % of the values (each side
truncates its fp32 resize) and the HF map within 1e-3 + 1e-5 relative; the
edited frames within FRAME_MAX = 1 level and a mean of FRAME_MEAN = 0.01
(the latents agree to about 1e-5; each side rounds them to bf16 before
the decode and truncates the paste to uint8).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits import visual as jvisual
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models import dinov2 as jdino
from anyedit_tpu.models import unet_sd as junet
from anyedit_tpu.models.controlnet import ControlNet as JaxControlNet
from anyedit_tpu.models.vae import AutoencoderKL as JaxVAE
from anyedit_tpu.ops import morphology as jmorph
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import visual
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.models import dinov2 as tdino
from anyedit_tpu_torch.models import unet_sd as tunet
from anyedit_tpu_torch.models.controlnet import ControlNet
from anyedit_tpu_torch.ops.morphology import sobel_magnitude
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, JAX_VAE, random_flax_params
from test_torch_ultraedit import _k1_fp32, jattention

torch.set_num_threads(1)
T = torch.from_numpy
ATOL = 1e-4
HW = 32                     # the tiny canvas (64 px) over latent_down 2
STEPS = 3
FRAME_MAX, FRAME_MEAN = 1, 0.01
TINY_G = jdino.DinoV2Config(img_size=28, patch=14, dim=32, depth=2, heads=2, ffn="swiglu",
                            dtype=jnp.float32)
PORT_G = tdino.DinoV2Config(img_size=224, patch=14, dim=32, depth=2, heads=2, ffn="swiglu",
                            dtype=torch.float32)
JAX_AD_UNET = dataclasses.replace(junet.TINY_UNET, context_dim=64, **F32)
PORT_AD_UNET = tiny_zoo_config().anydoor_unet
N_TOK = (224 // 14) ** 2 + 1
rng0 = np.random.default_rng(120)
IMG = rng0.integers(0, 256, (48, 40, 3), np.uint8)
REF = rng0.integers(0, 256, (36, 44, 3), np.uint8)
MASK = np.zeros((48, 40), bool)
MASK[10:34, 8:30] = True
REF_MASK = np.zeros((36, 44), bool)
REF_MASK[5:30, 6:40] = True
REC = {"edit": "put the teddy bear on the chair", "edited object": "chair",
       "ref_object": "teddy bear", "input": "a chair", "output": "a teddy bear on a chair",
       "visual_input": "bear.png"}


def _close(got, ref, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


# ---- DINOv2 with SwiGLU ------------------------------------------------------------

def test_dinov2_g_is_the_jax_config():
    """DINOV2_G's fields and its SwiGLU hidden width (4,096 at 1,536) as JAX's."""
    got, ref = dataclasses.asdict(tdino.DINOV2_G), dataclasses.asdict(jdino.DINOV2_G)
    got["dtype"] = ref["dtype"] = None
    assert got == ref
    for dim in (32, 64, 1536):
        assert tdino.DinoV2Config(dim=dim).swiglu_hidden == \
            jdino.DinoV2Config(dim=dim).swiglu_hidden
    assert tdino.DINOV2_G.swiglu_hidden == 4096


@pytest.fixture(scope="module")
def dino_tree():
    cfg = dataclasses.replace(TINY_G, img_size=224)
    return random_flax_params(jdino.DinoV2(cfg), (np.zeros((1, 224, 224, 3), np.float32),), 121)


def _dino(tree):
    m = tdino.DinoV2(PORT_G)
    m.load_state_dict(bridge.dinov2_state_dict(tree))
    return m.eval()


def test_dinov2_swiglu_matches(dino_tree):
    """The SwiGLU tower at 224 px: the class and patch tokens within ATOL."""
    px = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(np.float32)
    ref = jdino.DinoV2(dataclasses.replace(TINY_G, img_size=224)).apply(dino_tree, px)
    with torch.no_grad():
        got = _dino(dino_tree)(T(px))
    for k in ("cls", "patch"):
        _close(got[k], ref[k])


def test_dinov2_bridge_round_trips(dino_tree):
    """`dinov2_g`: the hub's names (`blocks.i.mlp.w12`, `.w3`), the module's
    keys exactly, and back."""
    sd = bridge.dinov2_state_dict(dino_tree)
    assert set(sd) == set(tdino.DinoV2(PORT_G).state_dict())
    assert sd["blocks.1.mlp.w12.weight"].shape == (2 * PORT_G.swiglu_hidden, 32)
    back = bridge.dinov2_tree(sd, dino_tree)
    for path, leaf in jax.tree_util.tree_leaves_with_path(dino_tree):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


# ---- the collage ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(24, 31), (2, 9, 9)])
def test_sobel_magnitude_matches(shape):
    g = np.random.default_rng(len(shape)).uniform(0, 255, shape).astype(np.float32)
    _close(sobel_magnitude(T(g)), jmorph.sobel_magnitude(jnp.asarray(g)), rtol=1e-6)


@pytest.mark.parametrize("shrink", [True, False])
def test_build_collage_matches(shrink):
    """The reference's object shrunk (antialiased) or grown into the
    target's box: the collage and the HF map as JAX's."""
    ref_mask = REF_MASK if shrink else REF_MASK & (np.arange(44) < 14)[None]
    got = visual.build_collage(IMG, MASK, REF, ref_mask)
    ref = jvisual.build_collage(IMG, MASK, REF, ref_mask)
    d = np.abs(got[0].astype(np.int32) - ref[0].astype(np.int32))
    assert got[0].dtype == np.uint8 and d.max() <= 1 and (d > 0).mean() <= 0.005
    _close(got[1], ref[1], atol=1e-3, rtol=1e-5)
    assert (got[0] != IMG).any() and got[1].max() > 10


# ---- the SD2.1-class UNet with its ControlNet ----------------------------------------

def test_anydoor_unet_is_the_jax_config():
    """SD21_ANYDOOR_UNET's fields as JAX's: 64-channel heads (5 / 10 / 20),
    context 1,024, 1x1-conv projections."""
    got = dataclasses.asdict(tunet.SD21_ANYDOOR_UNET)
    ref = dataclasses.asdict(junet.SD21_ANYDOOR_UNET)
    assert not got.pop("use_linear_projection")
    got["dtype"] = ref["dtype"] = None
    assert got == ref
    assert [tunet.SD21_ANYDOOR_UNET.heads(ch) for ch in (320, 640, 1280)] == [5, 10, 20]


@pytest.fixture(scope="module")
def ad_trees():
    x = np.zeros((1, HW, HW, 4), np.float32)
    t, ctx = np.zeros((1,), np.int32), np.zeros((1, N_TOK, 64), np.float32)
    hint = np.zeros((1, HW * 8, HW * 8, 4), np.float32)
    return (random_flax_params(junet.UNet2DCondition(JAX_AD_UNET), (x, t, ctx), 122),
            random_flax_params(JaxControlNet(JAX_AD_UNET), (x, t, ctx, hint), 123))


def test_unet_with_controlnet_matches(ad_trees):
    """The tiny AnyDoor UNet at batch 2 with its ControlNet (every leaf
    drawn: live zero convs) on a 4-channel hint at 8x the latent size: each
    residual and the noise prediction within ATOL; the residuals change it."""
    utree, ctree = ad_trees
    g = np.random.default_rng(2)
    x = g.standard_normal((2, HW, HW, 4)).astype(np.float32)
    t = np.array([700, 30], np.int32)
    ctx = g.standard_normal((2, N_TOK, 64)).astype(np.float32)
    hint = g.uniform(0, 1, (2, HW * 8, HW * 8, 4)).astype(np.float32)

    @jax.jit
    def jax_call(utree, ctree, x, t, ctx, hint):
        res, mid = JaxControlNet(JAX_AD_UNET).apply(ctree, x, t, ctx, hint)
        eps = junet.UNet2DCondition(JAX_AD_UNET).apply(utree, x, t, ctx,
                                                       controlnet_residuals=res,
                                                       controlnet_mid=mid)
        return res, mid, eps
    res_j, mid_j, ref = jax_call(utree, ctree, x, t, ctx, hint)
    unet = tunet.UNet2DCondition(PORT_AD_UNET)
    unet.load_state_dict(bridge.unet_state_dict(utree, 2))
    cn = ControlNet(PORT_AD_UNET, 4)
    cn.load_state_dict(bridge.controlnet_state_dict(ctree, 2, False))
    with torch.no_grad():
        res, mid = cn.eval()(T(x), T(t), T(ctx), T(hint))
        got = unet.eval()(T(x), T(t), T(ctx), controlnet_residuals=res, controlnet_mid=mid)
        plain = unet(T(x), T(t), T(ctx))
    assert len(res) == len(res_j)
    for a, b in zip(res + [mid], list(res_j) + [mid_j]):
        _close(a, b)
    _close(got, ref)
    assert (got - plain).abs().max() > 1e-2


# ---- the zoo slots, the pipeline, the executors ---------------------------------------

class _Proj(fnn.Module):
    """The JAX zoo's `_Proj`: one fp32 Dense to the UNet context."""

    @fnn.compact
    def __call__(self, e):
        return fnn.Dense(64, dtype=jnp.float32)(e)


def jax_noise(seed: int) -> torch.Tensor:
    return T(np.array(jax.random.normal(jax.random.key(seed), (1, HW, HW, 4), jnp.float32)))


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory, ad_trees, dino_tree):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_on_tpu", lambda: True)
        mp.setattr(jattention, "_self_attn_flash", _k1_fp32)
        mp.setattr(jdino, "DINOV2_G", TINY_G)
        params = {"unet_anydoor": ad_trees[0], "controlnet_anydoor": ad_trees[1],
                  "dinov2_g": dino_tree,
                  "anydoor_proj": random_flax_params(
                      _Proj(), (np.zeros((1, N_TOK, 32), np.float32),), 124),
                  "vae": random_flax_params(JaxVAE(JAX_VAE),
                                            (np.zeros((1, 64, 64, 3), np.float32),), 125)}
        wdir = tmp_path_factory.mktemp("weights")
        for name, tree in params.items():
            save_params(tree, wdir / f"{name}.msgpack")
        cfg = dataclasses.replace(tiny_zoo_config(), dino_cfg=PORT_G)
        jcfg = JaxZooConfig(canvas=cfg.canvas, anydoor_unet=JAX_AD_UNET, vae=JAX_VAE)
        jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
        yield jzoo, ModelZoo(cfg, device="cpu", params=params)


def _frames_close(got, ref, shape=IMG.shape):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape == shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= FRAME_MAX and d.mean() <= FRAME_MEAN, (d.max(), d.mean())


def test_anydoor_matches(zoo_pair):
    """`anydoor()` at 3 steps on a collage: the frame within the stated
    levels of JAX's, the target's bytes outside the mask, changed inside."""
    jzoo, zoo = zoo_pair
    collage, hf = visual.build_collage(IMG, MASK, REF, REF_MASK)
    ref = jzoo.anydoor()(IMG, MASK, collage, hf, REF, steps=STEPS, seed=4)
    got = zoo.anydoor()(IMG, MASK, collage, hf, REF, steps=STEPS, seed=4, noise=jax_noise(4))
    _frames_close(got, ref)
    np.testing.assert_array_equal(got[~MASK], IMG[~MASK])
    assert np.abs(got[MASK].astype(int) - IMG[MASK]).mean() > 1.0


def test_dino_embed_matches(zoo_pair):
    jzoo, zoo = zoo_pair
    got, ref = zoo.dino_embed()(REF), np.asarray(jzoo.dino_embed()(REF))
    _close(got, ref)
    assert got.shape == (1, 32) and abs(np.linalg.norm(got) - 1) < 1e-5


def _ground(masks):
    """A stub grounder: `masks[i]` for the i-th call's image (by shape)."""
    def ground(image, phrase, mode="merge", count_k=None):
        m = masks.get(image.shape[:2])
        return None if m is None else types.SimpleNamespace(mask=m)
    return ground


def _toolboxes(zoo_pair, masks):
    jzoo, zoo = zoo_pair
    run, jrun = zoo.anydoor(), jzoo.anydoor()
    jtb = JaxToolbox(ground=_ground(masks), extra={
        "anydoor": lambda *a: jrun(*a, steps=STEPS), "load_visual": lambda r: REF})
    tb = Toolbox(ground=_ground(masks), extra={
        "anydoor": lambda *a: run(*a, steps=STEPS, noise=jax_noise(0)),
        "load_visual": lambda r: REF})
    return jtb, tb


def _record(kind, i=0):
    obj = dict(REC, edit_type="visual_reference", id=f"vr-{i}")
    return (JaxRecord if kind == "jax" else InstructionRecord).from_json(obj)


def test_visual_reference_matches(zoo_pair):
    """The record through `get_pipeline` on both toolboxes: success, the
    edit within the stated levels, the target mask and the reference
    returned as the visual input."""
    jtb, tb = _toolboxes(zoo_pair, {IMG.shape[:2]: MASK, REF.shape[:2]: REF_MASK})
    ref = jvisual.visual_reference(jtb, _record("jax"), IMG, np.random.default_rng(0))
    got = get_pipeline("visual_reference")(tb, _record("port"), IMG, np.random.default_rng(0))
    assert got.success and ref.success
    _frames_close(got.edited, ref.edited)
    np.testing.assert_array_equal(got.mask, MASK)
    assert got.visual_input is REF


@pytest.mark.parametrize("case", ["edge", "no_target", "no_reference", "no_slot"])
def test_visual_reference_gates(zoo_pair, case):
    """A target touching the frame's edge (row 1), no target, no reference
    object, no slot: each fails with the JAX package's reason."""
    edge = MASK.copy()
    edge[1:5, 10:12] = True
    masks = {"edge": {IMG.shape[:2]: edge, REF.shape[:2]: REF_MASK},
             "no_target": {REF.shape[:2]: REF_MASK},
             "no_reference": {IMG.shape[:2]: MASK},
             "no_slot": {}}[case]
    jtb, tb = _toolboxes(zoo_pair, masks)
    if case == "no_slot":
        jtb, tb = JaxToolbox(ground=jtb.ground), Toolbox(ground=tb.ground)
    ref = jvisual.visual_reference(jtb, _record("jax"), IMG, np.random.default_rng(0))
    got = visual.visual_reference(tb, _record("port"), IMG, np.random.default_rng(0))
    assert (got.success, got.reason) == (ref.success, ref.reason)
    assert not got.success


def test_executors_match(tmp_path, monkeypatch, zoo_pair):
    """One visual_reference record through both `FactoryExecutor`s (the stub
    grounder, no pre-filter, the post-filter forced open): success, equal
    records, the mask and the reference written."""
    jtb, tb = _toolboxes(zoo_pair, {IMG.shape[:2]: MASK, REF.shape[:2]: REF_MASK})
    lines = {}
    for kind, ex_mod, box in (("jax", jexecutor, jtb), ("port", executor, tb)):
        monkeypatch.setattr(ex_mod, "post_filter_decision", lambda *a, **k: True)
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(box, ex_mod.ExecutorConfig(output_root=str(root),
                                                               run_pre_filter=False))
        ex.run([_record(kind)], lambda r: IMG)
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    (a,), (b,) = lines["port"], lines["jax"]
    assert a["status"] == b["status"] == "success"
    assert a["record"] == b["record"]
    assert a["payload"].keys() == b["payload"].keys() >= {"mask_file", "visual_input_file"}
