"""The caption-pair editors in the PyTorch port against the JAX package, on
both tiny zoos with the same params: the zoo slots `masactrl_pair_fn()`,
`p2p_pair()`, `flux_pair_fn()` and `text2img_fn()`; the pipelines
action_change, implicit_change and textual_change through `get_pipeline`;
the registry's keys; and one record of each type through both
`FactoryExecutor`s, per record and in chunk mode.

The JAX slots draw their start noise from `jax.random.key(seed)` inside;
the port's slots are handed those draws (`noise=`). The tiny Flux has live
modulations (`test_torch_flux.flux_params`), so that the captions reach
the image. The JAX zoo takes its TPU attention route, where the tiny VAE's
1,024-token mid attention is K1's max-free softmax in fp32, as the port's
does on every device (`test_torch_ultraedit.zoo_pair`).

Tolerances: both sides of every pair within FRAME_MAX = 1 uint8 level and
a mean of FRAME_MEAN = 0.01 levels (measured: at most 1 level on at most
0.23 % of the values): the latents agree to about 1e-5, and each side
rounds them to bf16 before the VAE decode and rounds the decode to uint8,
where a value near a boundary may land on either side. The P2P keyword
masks equal. Ledger scores (pixel L1 and the best-of-3 score) within
FRAME_MEAN / 255 of each other, statuses, stages and reasons equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits.registry import EDIT_PIPELINES as JAX_PIPELINES
from anyedit_tpu.edits.registry import get_pipeline as jax_get_pipeline
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models import flux as jflux
from anyedit_tpu.models.t5 import T5Encoder as JaxT5Encoder
from anyedit_tpu.models.unet_sd import TINY_UNET as JAX_TINY_UNET
from anyedit_tpu.models.unet_sd import UNet2DCondition as JaxUNet
from anyedit_tpu.models.vae import AutoencoderKL as JaxVAE
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.registry import EDIT_PIPELINES, get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_blip2 import JAX_T5
from test_torch_bridge import F32, JAX_TEXT, JAX_VAE, random_flax_params, text_params
from test_torch_flux import flux_params
from test_torch_ultraedit import _k1_fp32, jattention

torch.set_num_threads(1)
T = torch.from_numpy
JAX_UNET4 = dataclasses.replace(JAX_TINY_UNET, **F32)
JAX_FLUX = dataclasses.replace(jflux.TINY_FLUX, context_dim=32, pooled_dim=32, **F32)
JAX_FLUX_TEXT = dataclasses.replace(JAX_T5, vocab_size=30522)
HW = 32                     # the tiny canvas (64 px) over latent_down 2
STEPS = {"masactrl_pair": 3, "p2p_pair": 2, "flux_pair": 4}
FRAME_MAX, FRAME_MEAN = 1, 0.01
TYPES = ("action_change", "implicit_change", "textual_change")
# the reference's edit types whose slots are not ported yet (ROADMAP queue 1)
QUEUED: set = set()
RECORDS = {
    "action_change": {"edit": "make the dog jump", "input": "a dog sitting on grass",
                      "output": "a dog jumping on grass", "edited object": "dog"},
    "implicit_change": {"edit": "what if the ice melted", "input": "an ice cube on a table",
                        "output": "a puddle of water on a table", "edited object": "puddle"},
    "textual_change": {"edit": "change the sign to CLOSED",
                       "input": 'a shop sign that says "OPEN"',
                       "output": 'a shop sign that says "CLOSED"'},
}


def jax_noise(seed: int, channels: int = 4) -> torch.Tensor:
    """The start latent a JAX pair slot draws at `seed`."""
    return T(np.array(jax.random.normal(jax.random.key(seed), (1, HW, HW, channels),
                                        jnp.float32)))


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_on_tpu", lambda: True)
        mp.setattr(jattention, "_self_attn_flash", _k1_fp32)
        yield _zoo_pair(tmp_path_factory)


def _zoo_pair(tmp_path_factory):
    ids = (np.zeros((1, 77), np.int32),)
    px = (np.zeros((1, 64, 64, 3), np.float32),)
    params = {
        "unet_sd": random_flax_params(JaxUNet(JAX_UNET4), (
            np.zeros((1, HW, HW, 4), np.float32), np.zeros((1,), np.int32),
            np.zeros((1, 77, 32), np.float32)), 80),
        "vae": random_flax_params(JaxVAE(JAX_VAE), px, 81),
        "clip_text": text_params(82),
        "t5": random_flax_params(JaxT5Encoder(JAX_FLUX_TEXT), ids, 83),
        "flux": flux_params(JAX_FLUX, 84),
        "flux_vae": random_flax_params(JaxVAE(JAX_VAE), px, 85),
    }
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas,
                        ip2p_unet=dataclasses.replace(JAX_UNET4, in_channels=8),
                        sd_unet=JAX_UNET4, vae=JAX_VAE, flux_vae=JAX_VAE, text=JAX_TEXT,
                        flux_text=JAX_FLUX_TEXT, flux=JAX_FLUX)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


def _frames_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (64, 64, 3)
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= FRAME_MAX and d.mean() <= FRAME_MEAN, (d.max(), d.mean())


def _slots(zoo, port: bool) -> dict:
    """The pair slots of `zoo` at the test's step counts; the port's given
    JAX's noise for the seed each is called with."""
    noise = (lambda seed, ch=4: {"noise": jax_noise(seed, ch)}) if port else \
        (lambda seed, ch=4: {})
    masa, p2p, fpair = zoo.masactrl_pair_fn(), zoo.p2p_pair(), zoo.flux_pair_fn()
    return {
        "masactrl_pair": lambda a, b, seed: masa(a, b, seed, steps=STEPS["masactrl_pair"],
                                                 **noise(seed)),
        "p2p_pair": lambda a, b, kw, seed: p2p(a, b, kw, seed, steps=STEPS["p2p_pair"],
                                               **noise(seed)),
        "flux_pair": lambda a, b, seed: fpair(a, b, seed, steps=STEPS["flux_pair"],
                                              **noise(seed)),
    }


def _toolboxes(zoo_pair):
    """A JAX and a port toolbox with the pair slots and a stub CLIP pair
    (the same function of the pixels on both sides), so the best-of-3
    selection reads a CLIP term."""
    jzoo, zoo = zoo_pair

    def clip_image(im):
        return np.asarray(im, np.float32).mean(axis=(0, 1))[None] / 255.0

    def clip_text(text):
        return np.array([[len(text) % 5, 1.0, 0.5]], np.float32) / 5.0
    jtb = JaxToolbox(clip_image=clip_image, clip_text=clip_text, extra=_slots(jzoo, False))
    tb = Toolbox(clip_image=lambda im: T(clip_image(im)), clip_text=lambda t: T(clip_text(t)),
                 extra=_slots(zoo, True))
    return jtb, tb


# ---- the zoo slots --------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11])
def test_masactrl_pair_matches(zoo_pair, seed):
    """`masactrl_pair_fn()` (3 steps): both frames within the stated levels."""
    jzoo, zoo = zoo_pair
    a, b = RECORDS["action_change"]["input"], RECORDS["action_change"]["output"]
    ref = _slots(jzoo, False)["masactrl_pair"](a, b, seed)
    got = _slots(zoo, True)["masactrl_pair"](a, b, seed)
    for g, r in zip(got, ref):
        _frames_close(g, r)
    assert np.abs(got[0].astype(int) - got[1]).mean() > 1.0     # the captions differ


def test_p2p_pair_matches(zoo_pair):
    """`p2p_pair()` (2 steps): both frames within the stated levels, the
    keyword mask (canvas-size bool) equal and neither empty nor full."""
    jzoo, zoo = zoo_pair
    rec = RECORDS["implicit_change"]
    args = (rec["input"], rec["output"], "puddle", 5)
    ref = _slots(jzoo, False)["p2p_pair"](*args)
    got = _slots(zoo, True)["p2p_pair"](*args)
    for g, r in zip(got[:2], ref[:2]):
        _frames_close(g, r)
    assert got[2].dtype == np.bool_ and got[2].shape == (64, 64)
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    assert 0 < got[2].mean() < 1


def test_keyword_token_matches(zoo_pair):
    """The keyword's CLIP token position: found, past SOT; absent: 1."""
    _, zoo = zoo_pair
    assert zoo._keyword_token("a puddle of water on a table", "puddle") == 2
    assert zoo._keyword_token("a puddle of water on a table", "water on") == 4
    assert zoo._keyword_token("a puddle of water", "ice") == 1


def test_flux_pair_matches(zoo_pair):
    """`flux_pair_fn()` (4 steps, both captions from the seed's noise):
    both frames within the stated levels; `text2img_fn()` gives the first
    caption's frame at the same seed."""
    jzoo, zoo = zoo_pair
    rec = RECORDS["textual_change"]
    ref = _slots(jzoo, False)["flux_pair"](rec["input"], rec["output"], 7)
    got = _slots(zoo, True)["flux_pair"](rec["input"], rec["output"], 7)
    for g, r in zip(got, ref):
        _frames_close(g, r)
    assert np.abs(got[0].astype(int) - got[1]).mean() > 0.5     # the captions differ
    with torch.no_grad():
        t2i = zoo._flux_sampler()(rec["input"], 7, noise=jax_noise(7))
    np.testing.assert_array_equal(t2i, got[0])
    _frames_close(jzoo.text2img_fn()(rec["input"], seed=7), got[0])


# ---- the pipelines and the registry ------------------------------------------------

def _record(kind, edit_type, i=0):
    obj = dict(RECORDS[edit_type], edit_type=edit_type, id=f"{edit_type}-{i}")
    return (JaxRecord if kind == "jax" else InstructionRecord).from_json(obj)


@pytest.mark.parametrize("edit_type", TYPES)
def test_pipeline_matches(zoo_pair, edit_type):
    """The record through `get_pipeline` on both toolboxes: success, the
    synthesized input and the edit within the stated levels, the
    implicit_change mask equal and its best-of-3 score within FRAME_MEAN /
    255; `image` is not read."""
    jtb, tb = _toolboxes(zoo_pair)
    blank = np.zeros((8, 8, 3), np.uint8)
    ref = jax_get_pipeline(edit_type)(jtb, _record("jax", edit_type), blank,
                                      np.random.default_rng(0))
    got = get_pipeline(edit_type)(tb, _record("port", edit_type), blank,
                                  np.random.default_rng(0))
    assert got.success and ref.success, (got.reason, ref.reason)
    _frames_close(got.edited, ref.edited)
    _frames_close(got.input_image, ref.input_image)
    if edit_type == "implicit_change":
        np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))
        assert got.scores["best"] == pytest.approx(ref.scores["best"], abs=FRAME_MEAN / 255)
    else:
        assert got.mask is None and ref.mask is None


@pytest.mark.parametrize("edit_type", TYPES)
def test_pipeline_without_its_slot(edit_type):
    """Without its slot each pipeline fails with the JAX package's reason."""
    ref = jax_get_pipeline(edit_type)(JaxToolbox(), _record("jax", edit_type), None,
                                      np.random.default_rng(0))
    got = get_pipeline(edit_type)(Toolbox(), _record("port", edit_type), None,
                                  np.random.default_rng(0))
    assert (got.success, got.reason) == (ref.success, ref.reason) == (False, got.reason)


def test_textual_change_ocr_gate():
    """With an OCR slot both sides must read their quoted strings."""
    for reads, ok in ((("OPEN", "CLOSED"), True), (("OPEN", "OPEN"), False)):
        frames = iter(reads)
        tb = Toolbox(ocr=lambda im: next(frames),
                     extra={"flux_pair": lambda a, b, s: (np.zeros((4, 4, 3), np.uint8),
                                                          np.ones((4, 4, 3), np.uint8))})
        out = get_pipeline("textual_change")(tb, _record("port", "textual_change"), None,
                                             np.random.default_rng(0))
        assert out.success == ok and (ok or out.reason == "OCR text mismatch")


def test_registry_keys_match_jax():
    """The port's registry equals the JAX one: every type, each with a
    pipeline of the same name."""
    assert not QUEUED
    assert set(EDIT_PIPELINES) == set(JAX_PIPELINES)
    for et in JAX_PIPELINES:
        assert get_pipeline(et).__name__ == jax_get_pipeline(et).__name__, et


# ---- both executors -----------------------------------------------------------------

@pytest.mark.parametrize("grounding_batch", [0, 4])
def test_executors_match(tmp_path, monkeypatch, zoo_pair, grounding_batch):
    """One record of each type through the port's and the JAX package's
    `FactoryExecutor` (no grounder, the stub CLIP pair, no pre-filter, the
    post-filter's decision forced open so that both synthesized sides are
    written), per record and in a chunk of 3: equal statuses, stages and
    reasons, post-filter scores within FRAME_MEAN / 255, every record a
    success."""
    lines = {}
    jtb, tb = _toolboxes(zoo_pair)
    for kind, ex_mod, box in (("jax", jexecutor, jtb), ("port", executor, tb)):
        monkeypatch.setattr(ex_mod, "post_filter_decision", lambda *a, **k: True)
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(box, ex_mod.ExecutorConfig(
            output_root=str(root), grounding_batch=grounding_batch, run_pre_filter=False))
        ex.run([_record(kind, et) for et in TYPES], lambda r: np.zeros((8, 8, 3), np.uint8))
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    assert len(lines["port"]) == len(TYPES)
    for a, b in zip(lines["port"], lines["jax"], strict=True):
        assert (a["key"], a["status"]) == (b["key"], b["status"])
        for k in ("stage", "reason"):
            assert a["payload"].get(k) == b["payload"].get(k), k
        sa, sb = a["payload"].get("scores", {}), b["payload"].get("scores", {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k] == pytest.approx(sb[k], abs=FRAME_MEAN / 255) \
                if isinstance(sa[k], float) else sa[k] == sb[k], k
    assert [x["status"] for x in lines["port"]] == ["success"] * len(TYPES)
