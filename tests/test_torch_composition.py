"""composition in the PyTorch port against the JAX package:
`parse_canvas_plan`, `region_bias`, `build_regional_conditioning`, the
regional processor inside the tiny SD1.5-layout UNet (one prepared length
and one site at an unprepared length, which takes sdpa without a bias),
the zoo's `composition_fn()` against the JAX zoo's on the same params with
JAX's start noise handed to the port, the pipeline, and one record through
both `FactoryExecutor`s.

The JAX zoo takes its TPU attention route, where the tiny VAE's 1,024-token
mid attention is K1's max-free softmax in fp32, as the port's does on every
device (`test_torch_ultraedit.zoo_pair`). Tolerances: the plan and the bias
exactly; the UNet's noise prediction in fp32 within max-abs 1e-4; the
generated frames within FRAME_MAX = 1 uint8 level and a mean of
FRAME_MEAN = 0.01 levels (the latents agree to about 1e-5; each side
rounds them to bf16 before the decode and rounds the decode to uint8).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.diffusion import regional as jregional
from anyedit_tpu.edits import composition as jcomposition
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models.unet_sd import TINY_UNET as JAX_TINY_UNET
from anyedit_tpu.models.unet_sd import UNet2DCondition as JaxUNet
from anyedit_tpu.models.vae import AutoencoderKL as JaxVAE
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.diffusion import regional
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, JAX_TEXT, JAX_VAE, random_flax_params, text_params
from test_torch_ultraedit import _k1_fp32, jattention

torch.set_num_threads(1)
T = torch.from_numpy
JAX_UNET4 = dataclasses.replace(JAX_TINY_UNET, **F32)
HW = 32                     # the tiny canvas (64 px) over latent_down 2
STEPS = 3
FRAME_MAX, FRAME_MEAN = 1, 0.01
PLAN = ("global: a sunny park with a pond\n"
        "region: 0.0,0.0,0.5,1.0 | a brown dog\n"
        "REGION: 0.5,0.25,1.0,0.75 | a red kite\n"
        "region: 0,512,256,1024 | a wooden bench")
REC = {"edit": "a dog and a kite in a park", "edited object": "dog",
       "input": "a park", "output": "a dog and a kite in a park"}


@pytest.mark.parametrize("text", [
    PLAN, "region: 0.1,0.2,0.3,0.4 | only a region", "global: just a prompt",
    "no plan at all", "region: 10,20,30,40|pixels\nregion: 0.1,0.1 | malformed"])
def test_parse_canvas_plan_matches(text):
    assert regional.parse_canvas_plan(text) == jregional.parse_canvas_plan(text)


def _regions(ctx_len=40):
    return [regional.Region((0.0, 0.0, 0.5, 1.0), (8, 16)),
            regional.Region((0.25, 0.5, 1.0, 0.9), (16, 30)),
            regional.Region((0.9, 0.9, 1.0, 1.0), (30, ctx_len))]


@pytest.mark.parametrize("hw", [16, 8, 5])
def test_region_bias_matches(hw):
    """The (hw^2, L) bias equals the JAX one: 0 or -1e9, the global span
    open everywhere, a region's span open at the cells whose centres it
    covers."""
    jregions = [jregional.Region(r.box, r.span) for r in _regions()]
    got = regional.region_bias(_regions(), hw, 40, (0, 8))
    ref = np.asarray(jregional.region_bias(jregions, hw, 40, (0, 8)))
    assert got.dtype == torch.float32 and got.shape == (hw * hw, 40)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) == {0.0, -1e9}


def _encode(seed):
    """A stand-in text encoder: (1, 5 + len(text) % 4, 32) seeded by the text."""
    def enc(text):
        g = np.random.default_rng(seed + sum(map(ord, text)))
        return g.standard_normal((1, 5 + len(text) % 4, 32)).astype(np.float32)
    return enc


def test_build_regional_conditioning_matches():
    """The fused context equals JAX's, and each prepared bias too."""
    gp, regions = regional.parse_canvas_plan(PLAN)
    enc = _encode(3)
    ctx, proc = regional.build_regional_conditioning(lambda s: T(enc(s)), gp, regions, [8, 4])
    jctx, _ = jregional.build_regional_conditioning(lambda s: jnp.asarray(enc(s)), gp, regions,
                                                    [8, 4])
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
    assert ctx.shape[1] == sum(enc(s).shape[1] for s in [gp] + [p for _, p in regions])


@pytest.fixture(scope="module")
def unet_tree():
    return random_flax_params(JaxUNet(JAX_UNET4), (
        np.zeros((1, HW, HW, 4), np.float32), np.zeros((1,), np.int32),
        np.zeros((1, 77, 32), np.float32)), 110)


@pytest.mark.parametrize("prepared", [(32, 16), (32,)])
def test_regional_processor_in_the_unet(unet_tree, prepared):
    """The tiny UNet at batch 2 under the regional processor: its level-0
    cross sites (1,024 tokens) take the bias; the mid block's (256 tokens)
    takes it when 16 is prepared and plain sdpa when it is not. The noise
    prediction within 1e-4 of JAX's, and the bias changes it."""
    gp, regions = regional.parse_canvas_plan(PLAN)
    enc = _encode(5)
    ctx, proc = regional.build_regional_conditioning(lambda s: T(enc(s)), gp, regions, prepared)
    jctx, jproc = jregional.build_regional_conditioning(lambda s: jnp.asarray(enc(s)), gp,
                                                        regions, list(prepared))
    g = np.random.default_rng(6)
    x = g.standard_normal((2, HW, HW, 4)).astype(np.float32)
    t = np.array([500, 20], np.int32)
    ctx2 = np.concatenate([np.asarray(jctx)] * 2)
    ref = jax.jit(lambda p, x, t, c: JaxUNet(JAX_UNET4).apply(p, x, t, c, processor=jproc))(
        unet_tree, x, t, ctx2)
    unet = UNet2DCondition(tiny_zoo_config().sd_unet)
    unet.load_state_dict(bridge.unet_state_dict(unet_tree, 2))
    with torch.no_grad():
        got = unet.eval()(T(x), T(t), T(ctx2), processor=proc)
        plain = unet(T(x), T(t), T(ctx2), processor=regional.regional_processor({}))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert (got - plain).abs().max() > 1e-2


def jax_noise(seed: int) -> torch.Tensor:
    """The start latent the JAX slot draws at `seed`."""
    return T(np.array(jax.random.normal(jax.random.key(seed), (1, HW, HW, 4), jnp.float32)))


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory, unet_tree):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_on_tpu", lambda: True)
        mp.setattr(jattention, "_self_attn_flash", _k1_fp32)
        params = {"unet_sd": unet_tree,
                  "vae": random_flax_params(JaxVAE(JAX_VAE),
                                            (np.zeros((1, 64, 64, 3), np.float32),), 111),
                  "clip_text": text_params(112)}
        wdir = tmp_path_factory.mktemp("weights")
        for name, tree in params.items():
            save_params(tree, wdir / f"{name}.msgpack")
        cfg = tiny_zoo_config()
        jcfg = JaxZooConfig(canvas=cfg.canvas, sd_unet=JAX_UNET4, vae=JAX_VAE, text=JAX_TEXT)
        jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
        yield jzoo, ModelZoo(cfg, device="cpu", params=params)


def _frames_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (64, 64, 3)
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= FRAME_MAX and d.mean() <= FRAME_MEAN, (d.max(), d.mean())


def test_composition_fn_matches(zoo_pair):
    """`composition_fn()` at 3 steps: the frame within the stated levels of
    JAX's; the regions change it against the global prompt alone."""
    jzoo, zoo = zoo_pair
    ref = jzoo.composition_fn()(PLAN, 9, steps=STEPS)
    got = zoo.composition_fn()(PLAN, 9, steps=STEPS, noise=jax_noise(9))
    _frames_close(got, ref)
    alone = zoo.composition_fn()(PLAN.splitlines()[0], 9, steps=STEPS, noise=jax_noise(9))
    assert np.abs(alone.astype(int) - got).mean() > 0.5


def test_composition_fn_draws_its_noise(zoo_pair):
    """Without `noise=` the slot draws from `torch.Generator(seed)`."""
    _, zoo = zoo_pair
    g = torch.Generator().manual_seed(4)
    np.testing.assert_array_equal(
        zoo.composition_fn()(PLAN, 4, steps=1),
        zoo.composition_fn()(PLAN, 4, steps=1, noise=torch.randn((1, HW, HW, 4), generator=g)))


def _slot(zoo, port: bool):
    run = zoo.composition_fn()
    if port:
        return lambda plan, seed: run(plan, seed, steps=STEPS, noise=jax_noise(seed))
    return lambda plan, seed: run(plan, seed, steps=STEPS)


@pytest.mark.parametrize("in_extras", [True, False])
def test_composition_pipeline_matches(zoo_pair, in_extras):
    """The record through `get_pipeline`, the plan in `extras["canvas_plan"]`
    or as the record's edit: success, the frame within the stated levels,
    the seed drawn from the same rng; without the slot, the JAX reason."""
    jzoo, zoo = zoo_pair
    fields = dict(REC, edit_type="composition", **({"canvas_plan": PLAN} if in_extras
                                                     else {"edit": PLAN}))
    ref = jcomposition.composition(JaxToolbox(extra={"composition": _slot(jzoo, False)}),
                                   JaxRecord.from_json(fields), None, np.random.default_rng(2))
    got = get_pipeline("composition")(Toolbox(extra={"composition": _slot(zoo, True)}),
                                      InstructionRecord.from_json(fields), None,
                                      np.random.default_rng(2))
    assert got.success and ref.success
    _frames_close(got.edited, ref.edited)
    none = get_pipeline("composition")(Toolbox(), InstructionRecord.from_json(fields), None,
                                       np.random.default_rng(2))
    assert (none.success, none.reason) == (False, "composition stack unavailable")


def test_executors_match(tmp_path, monkeypatch, zoo_pair):
    """One composition record through both `FactoryExecutor`s (no
    pre-filter, the post-filter forced open): success, equal records and
    payload keys."""
    jzoo, zoo = zoo_pair
    lines = {}
    for kind, ex_mod, box, rec_cls in (
            ("jax", jexecutor, JaxToolbox(extra={"composition": _slot(jzoo, False)}), JaxRecord),
            ("port", executor, Toolbox(extra={"composition": _slot(zoo, True)}),
             InstructionRecord)):
        monkeypatch.setattr(ex_mod, "post_filter_decision", lambda *a, **k: True)
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(box, ex_mod.ExecutorConfig(output_root=str(root),
                                                               run_pre_filter=False))
        ex.run([rec_cls.from_json(dict(REC, edit_type="composition", id="c0",
                                       canvas_plan=PLAN))],
               lambda r: np.zeros((8, 8, 3), np.uint8))
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    (a,), (b,) = lines["port"], lines["jax"]
    assert a["status"] == b["status"] == "success"
    assert a["record"] == b["record"] and a["payload"].keys() == b["payload"].keys()
