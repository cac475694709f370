"""The SDXL refine slots and the edits on them in the PyTorch port against
the JAX package, on both tiny zoos with the same params: `img2img_fn()`,
`sdxl_inpaint_fn()`, `canny_consistency_fn()` (the canny ControlNet and the
IP-Adapter) and `sdxl_material_fn()` (the depth ControlNet and the
IP-Adapter); implicit_change with all four stages; material_transfer
through `get_pipeline` and through both `FactoryExecutor`s, per record and
in chunk mode; the registry's entries; `install` of the new slots.

The JAX slots draw their noise from `jax.random.key(seed)` and
`fold_in(key, 1)` inside; the port's slots are handed those draws (`noise=`,
`renoise=`). Every ControlNet leaf is drawn (`random_flax_params`), so the
zero convs and the hint projection are live. The slots run at 3 steps
(`STEPS`) through wrappers on both sides. The JAX zoo takes its TPU
attention route, where the tiny VAE's 1,024-token mid attention is K1's
max-free softmax in fp32, as the port's does on every device
(`test_torch_ultraedit.zoo_pair`). The grounder is a stub that answers
every phrase with one synthetic detection, built by each package's own
`grounding_result`; `load_visual` returns a seeded exemplar.

Tolerances. Every frame within FRAME_MAX = 1 uint8 level and a mean of
FRAME_MEAN = 0.03 levels, not the 0.01 of `test_torch_synth_edits.py`. The
refine loop's latents agree to 1.7e-5 at a scale of 3.75 (img2img at 4
steps, measured; the UNet, the ControlNet, the processor and the sampler
are each held within 1e-4 in `test_torch_sdxl.py`), but each side rounds
the latents to bf16 before the VAE decode, where latents 1e-5 apart take
the other bf16 value now and then, and a flipped latent moves the decoded
pixels near it by one level. Measured on the canvas: at most 1 level, means
from 0.0002 to 0.0127 (the consistency stage of implicit_change). An
off-canvas image (48x56) goes through both packages' lanczos resizes, whose
fp32 results differ by about 1e-6: the VAE encoder's bf16 input then takes
the neighbouring bf16 value at some pixels (the latents 5e-4 apart at a
scale of 1.2), and the resize back truncates to uint8 (measured: 1 level,
mean 0.0202). The images are otherwise canvas-size (64 px), so neither side
resizes them. material_transfer's grey init truncates the fp32 luma
(`rgb_to_gray` rounds as the JAX package does, so the inits are equal). In
implicit_change each stage runs on the JAX stage's input frames, so the
chain's roundings do not accumulate; one candidate runs, since the
candidate loop and the best-of-3 choice are held in
`test_torch_synth_edits.py`. The implicit_change mask equal, its best score
within FRAME_MEAN / 255; ledger statuses, stages and reasons equal.
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
from anyedit_tpu.grounding import maskgen as jmaskgen
from anyedit_tpu.models import unet_sd as junet
from anyedit_tpu.models.clip import CLIPTextEncoder as JaxTextEncoder
from anyedit_tpu.models.controlnet import ControlNet as JaxControlNet
from anyedit_tpu.models.depth import DepthAnythingV2 as JaxDepth
from anyedit_tpu.models.ip_adapter import (
    ImageProjection as JaxImageProjection, IPAdapterWeights as JaxIPAdapterWeights,
    cross_attn_sites as jax_sites,
)
from anyedit_tpu.models.vae import AutoencoderKL as JaxVAE
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import visual
from anyedit_tpu_torch.edits.registry import EDIT_PIPELINES, get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.grounding import maskgen
from anyedit_tpu_torch.models.unet_sd import TINY_UNET
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_bridge import F32, JAX_TEXT, JAX_VAE, random_flax_params, text_params
from test_torch_depth import JAX_DEPTH
from test_torch_scorers import JAX_VISION, text_proj_params, vision_params
from test_torch_sdxl import JAX_XL
from test_torch_synth_edits import JAX_UNET4, jax_noise
from test_torch_ultraedit import JAX_TEXT_G, _k1_fp32, jattention

torch.set_num_threads(1)
T = torch.from_numpy
HW = 32                      # the tiny canvas (64 px) over latent_down 2
STEPS = 3                    # 0.98 -> 3 steps, 0.5 -> 2 (round(1.5)), 0.6 -> 2, 0.9 -> 3
FRAME_MAX, FRAME_MEAN = 1, 0.03
H = W = 64                   # the canvas: neither side resizes the image
OBJ_BOX = (12, 10, 44, 40)   # xyxy of the synthetic detection
REC = {"edit": "make the cup out of marble", "edited object": "cup",
       "input": "a cup on a table", "output": "a marble cup on a table",
       "ref_object": "marble", "visual_input": "marble.png"}
IMPLICIT = {"edit": "what if the ice melted", "input": "an ice cube on a table",
            "output": "a puddle of water on a table", "edited object": "puddle"}


def _image(seed, hw=(H, W)):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


IMG = _image(70)
EXEMPLAR = _image(71, (40, 40))


def jax_renoise(seed: int) -> torch.Tensor:
    """The re-noise draw of a JAX refine slot at `seed` (fold_in(key, 1))."""
    key = jax.random.fold_in(jax.random.key(seed), 1)
    return T(np.array(jax.random.normal(key, (1, HW, HW, 4), jnp.float32)))


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_on_tpu", lambda: True)
        mp.setattr(jattention, "_self_attn_flash", _k1_fp32)
        yield _zoo_pair(tmp_path_factory)


def _zoo_pair(tmp_path_factory):
    ids = (np.zeros((1, 77), np.int32),)
    px = (np.zeros((1, 64, 64, 3), np.float32),)
    lat = np.zeros((2, HW, HW, 4), np.float32)
    t, ctx = np.zeros((2,), np.int32), np.zeros((2, 77, 48), np.float32)
    pooled, tid = np.zeros((2, 16), np.float32), np.zeros((2, 6), np.float32)
    hint = np.zeros((2, HW * 8, HW * 8, 3), np.float32)
    names, dims = jax_sites(JAX_XL)
    proj = JaxImageProjection(num_tokens=4, context_dim=48)
    s = JAX_DEPTH.backbone.img_size
    params = {
        "unet_refine": random_flax_params(junet.UNet2DCondition(JAX_XL), (
            lat, t, ctx, None, None, None, None, pooled, tid), 100),
        "controlnet_canny": random_flax_params(JaxControlNet(JAX_XL),
                                               (lat, t, ctx, hint, pooled, tid), 101),
        "controlnet_depth": random_flax_params(JaxControlNet(JAX_XL),
                                               (lat, t, ctx, hint, pooled, tid), 102),
        "ip_proj": random_flax_params(proj, (np.zeros((1, JAX_VISION.proj_dim),
                                                      np.float32),), 103),
        "ip_adapter": random_flax_params(JaxIPAdapterWeights(names, dims, 48),
                                         (np.zeros((1, 4, 48), np.float32),), 104),
        "sdxl_vae": random_flax_params(JaxVAE(JAX_VAE), px, 105),
        "clip_text": text_params(106),
        "clip_text_g": random_flax_params(JaxTextEncoder(JAX_TEXT_G), ids, 107),
        "clip_vision": vision_params(JAX_VISION, 108),
        "clip_text_proj": text_proj_params(109),
        "depth": random_flax_params(JaxDepth(JAX_DEPTH), (np.zeros((1, s, s, 3),
                                                                  np.float32),), 110),
        "unet_sd": random_flax_params(junet.UNet2DCondition(JAX_UNET4), (
            lat[:1], t[:1], np.zeros((1, 77, 32), np.float32)), 111),
        "vae": random_flax_params(JaxVAE(JAX_VAE), px, 112),
    }
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, refine_unet=JAX_XL, sdxl_vae=JAX_VAE, vae=JAX_VAE,
                        text=JAX_TEXT, text_g=JAX_TEXT_G, vision=JAX_VISION,
                        depth_cfg=JAX_DEPTH, sd_unet=JAX_UNET4,
                        ip2p_unet=dataclasses.replace(JAX_UNET4, in_channels=8))
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


def _frames_close(got, ref, shape=None):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert shape is None or got.shape == shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= FRAME_MAX and d.mean() <= FRAME_MEAN, (d.max(), d.mean())


def _noise(port: bool, seed: int, renoise: bool = True) -> dict:
    if not port:
        return {}
    return {"noise": jax_noise(seed), **({"renoise": jax_renoise(seed)} if renoise else {})}


def _slots(zoo, port: bool) -> dict:
    """The refine slots at STEPS (and P2P at 2 steps), the port's handed
    JAX's draws for the seed each is called with."""
    i2i, inp = zoo.img2img_fn(), zoo.sdxl_inpaint_fn()
    cons, mat, p2p = zoo.canny_consistency_fn(), zoo.sdxl_material_fn(), zoo.p2p_pair()
    return {
        "sdxl_img2img": lambda im, prompt, strength, seed: i2i(
            im, prompt, strength, seed, steps=STEPS, **_noise(port, seed, False)),
        "sdxl_inpaint": lambda im, mask, prompt, seed: inp(
            im, mask, prompt, seed, steps=STEPS, **_noise(port, seed)),
        "canny_consistency": lambda im, prompt, seed, ref_image=None, mask01=None: cons(
            im, prompt, seed, steps=STEPS, ref_image=ref_image, mask01=mask01,
            **_noise(port, seed)),
        "sdxl_material": lambda init, mask, depth, ex: mat(
            init, mask, depth, ex, steps=STEPS, **_noise(port, 0, False)),
        "p2p_pair": lambda a, b, kw, seed: p2p(a, b, kw, seed, steps=2,
                                               **({"noise": jax_noise(seed)} if port else {})),
        "load_visual": lambda rec: EXEMPLAR,
    }


def _mask():
    m = np.zeros((H, W), bool)
    m[10:40, 12:44] = True
    return m


# ---- the refine slots -------------------------------------------------------------------

@pytest.mark.parametrize("size", [(H, W), (48, 56)])
def test_img2img_matches(zoo_pair, size):
    """`img2img_fn()` at strength 0.5: 2 of 3 steps from the noised image,
    on the canvas and off it (the lanczos resizes on both sides)."""
    jzoo, zoo = zoo_pair
    img = IMG if size == (H, W) else _image(72, size)
    ref = _slots(jzoo, False)["sdxl_img2img"](img, "a cup of tea", 0.5, 3)
    got = _slots(zoo, True)["sdxl_img2img"](img, "a cup of tea", 0.5, 3)
    _frames_close(got, ref, size + (3,))
    assert np.abs(got.astype(int) - img).mean() > 1.0


def test_sdxl_inpaint_matches(zoo_pair):
    """`sdxl_inpaint_fn()` at strength 0.98 (all 3 steps) inside a mask."""
    jzoo, zoo = zoo_pair
    ref = _slots(jzoo, False)["sdxl_inpaint"](IMG, _mask(), "a red cup", 4)
    got = _slots(zoo, True)["sdxl_inpaint"](IMG, _mask(), "a red cup", 4)
    _frames_close(got, ref, (H, W, 3))


def test_canny_consistency_matches(zoo_pair):
    """`canny_consistency_fn()` at strength 0.6: the canny ControlNet on the
    image's edges, the IP-Adapter on `ref_image`, inside the mask (as
    implicit_change calls it)."""
    jzoo, zoo = zoo_pair
    kw = dict(ref_image=EXEMPLAR, mask01=_mask())
    ref = _slots(jzoo, False)["canny_consistency"](IMG, "a cup", 5, **kw)
    got = _slots(zoo, True)["canny_consistency"](IMG, "a cup", 5, **kw)
    _frames_close(got, ref, (H, W, 3))
    np.testing.assert_array_equal(zoo.canny_fn(IMG), jzoo.canny_fn(IMG))


def test_sdxl_material_matches(zoo_pair):
    """`sdxl_material_fn()` at strength 0.9: the depth ControlNet on a depth
    map, the IP-Adapter on the exemplar, the background latents kept."""
    jzoo, zoo = zoo_pair
    depth = zoo.depth_fn()(IMG)
    _frames_close(depth[..., None], np.asarray(jzoo.depth_fn()(IMG))[..., None])
    ref = _slots(jzoo, False)["sdxl_material"](IMG, _mask(), depth, EXEMPLAR)
    got = _slots(zoo, True)["sdxl_material"](IMG, _mask(), depth, EXEMPLAR)
    _frames_close(got, ref, (H, W, 3))


# ---- the pipelines ------------------------------------------------------------------

def _ground(kind):
    """Every phrase answered by the one synthetic detection at OBJ_BOX."""
    def ground(image, phrase, mode="merge", count_k=None):
        h, w = image.shape[:2]
        n = jmaskgen.MAX_BOXES
        masks = -np.ones((n, h, w), np.float32)
        x1, y1, x2, y2 = OBJ_BOX
        masks[0, y1:y2, x1:x2] = 1.0
        bx, sc, valid = np.zeros((n, 4), np.float32), np.zeros(n, np.float32), np.zeros(n, bool)
        bx[0], sc[0], valid[0] = OBJ_BOX, 0.9, True
        if kind == "jax":
            return jmaskgen.grounding_result(*(jnp.asarray(a) for a in (masks, bx, sc, valid)),
                                             (h, w), mode)
        return maskgen.grounding_result(*(T(a) for a in (masks, bx, sc, valid)), (h, w), mode)

    def batch(images, phrases, modes=None, count_ks=None):
        modes = modes or ["merge"] * len(images)
        return [ground(im, ph, mode=m) for im, ph, m in zip(images, phrases, modes)]
    ground.batch = batch
    return ground


def _toolboxes(zoo_pair):
    jzoo, zoo = zoo_pair
    jtb = JaxToolbox(ground=_ground("jax"), depth=jzoo.depth_fn(), extra=_slots(jzoo, False))
    tb = Toolbox(ground=_ground("port"), depth=zoo.depth_fn(), extra=_slots(zoo, True))
    return jtb, tb


def _record(kind, fields, edit_type, i=0):
    obj = dict(fields, edit_type=edit_type, id=f"{edit_type}-{i}")
    return (JaxRecord if kind == "jax" else InstructionRecord).from_json(obj)


STAGES = ("p2p_pair", "sdxl_inpaint", "sdxl_img2img", "canny_consistency")


def _sync(got, ref):
    """A port stage argument against the JAX stage's: a frame within the
    stated levels (then JAX's frame goes on, so that the chain's roundings
    do not accumulate), anything else equal."""
    if isinstance(got, np.ndarray) and got.dtype == np.uint8:
        _frames_close(got, ref)
        return np.asarray(ref)
    if isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, np.asarray(ref))
        return got
    assert got == ref
    return got


def _stage_spies(jtb, tb):
    """Every stage slot of both toolboxes recorded; the port's i-th stage
    call is checked against the JAX pipeline's i-th (the same stage, its
    arguments by `_sync`), runs on JAX's frames and its output is held to
    JAX's. Run the JAX pipeline first. Returns the call log."""
    calls = {"jax": [], "port": []}
    for name in STAGES:
        jfn, tfn = jtb.extra[name], tb.extra[name]

        def jax_stage(*a, _fn=jfn, _name=name, **k):
            out = _fn(*a, **k)
            calls["jax"].append((_name, a, k, out))
            return out

        def port_stage(*a, _fn=tfn, _name=name, **k):
            jname, ja, jk, jout = calls["jax"][len(calls["port"])]
            assert _name == jname and k.keys() == jk.keys()
            out = _fn(*(_sync(x, y) for x, y in zip(a, ja, strict=True)),
                      **{n: v if v is None else _sync(v, jk[n]) for n, v in k.items()})
            for o, r in zip(out if isinstance(out, tuple) else (out,),
                            jout if isinstance(jout, tuple) else (jout,)):
                (_frames_close if o.dtype == np.uint8 else np.testing.assert_array_equal)(
                    o, np.asarray(r))
            calls["port"].append((_name, a, k, out))
            return out
        jtb.extra[name], tb.extra[name] = jax_stage, port_stage
    return calls


def test_implicit_change_all_stages(zoo_pair):
    """implicit_change with all four stages on both zoos, one candidate: P2P,
    the two inpaints from the stage-1 ori (seeds s and s + 1), img2img on
    the target at 0.5, the consistency pass (the new ori as the IP-Adapter
    image, the keyword mask), scored by a stub CLIP pair and SSIM. Every
    stage call of the port, in order, takes the JAX pipeline's arguments
    (frames within the stated levels) and gives its outputs (within the
    stated levels; the P2P mask equal); each stage runs on JAX's input
    frames, so each is held alone. Then the synthesized input and the edit
    within the stated levels, the mask equal, the score within FRAME_MEAN /
    255."""
    jtb, tb = _toolboxes(zoo_pair)
    calls = _stage_spies(jtb, tb)
    jtb.clip_image = lambda im: np.asarray(im, np.float32).mean(axis=(0, 1))[None] / 255.0
    jtb.clip_text = lambda text: np.array([[len(text) % 5, 1.0, 0.5]], np.float32) / 5.0
    tb.clip_image = lambda im: T(jtb.clip_image(im))
    tb.clip_text = lambda text: T(jtb.clip_text(text))
    ref = jax_get_pipeline("implicit_change")(jtb, _record("jax", IMPLICIT, "implicit_change"),
                                              IMG, np.random.default_rng(0), n_candidates=1)
    got = get_pipeline("implicit_change")(tb, _record("port", IMPLICIT, "implicit_change"),
                                          IMG, np.random.default_rng(0), n_candidates=1)
    assert got.success and ref.success, (got.reason, ref.reason)
    _frames_close(got.edited, ref.edited, (64, 64, 3))
    _frames_close(got.input_image, ref.input_image, (64, 64, 3))
    np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))
    assert got.scores["best"] == pytest.approx(ref.scores["best"], abs=FRAME_MEAN / 255)
    per_candidate = ["p2p_pair", "sdxl_inpaint", "sdxl_inpaint", "sdxl_img2img",
                     "canny_consistency"]
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]] == per_candidate


def test_material_transfer_matches(zoo_pair):
    """material_transfer through `get_pipeline` on both zoos: success, the
    object's mask equal, the exemplar returned as `visual_input`, the frame
    within the stated levels and unchanged outside the object's latents."""
    jtb, tb = _toolboxes(zoo_pair)
    ref = jax_get_pipeline("material_transfer")(jtb, _record("jax", REC, "material_transfer"),
                                                IMG, np.random.default_rng(0))
    got = get_pipeline("material_transfer")(tb, _record("port", REC, "material_transfer"), IMG,
                                            np.random.default_rng(0))
    assert got.success and ref.success, (got.reason, ref.reason)
    np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))
    assert got.visual_input is EXEMPLAR
    _frames_close(got.edited, ref.edited, (H, W, 3))


def test_material_transfer_without_its_stack():
    """Without the slot, the exemplar loader or the depth slot, both
    packages fail with the same reason; an empty grounding: "object not
    found"."""
    for kw in ({}, {"depth": lambda im: None}, {"depth": lambda im: None,
                                                 "extra": {"sdxl_material": print}}):
        ref = jax_get_pipeline("material_transfer")(JaxToolbox(**kw), _record(
            "jax", REC, "material_transfer"), IMG, None)
        got = visual.material_transfer(Toolbox(**kw), _record("port", REC, "material_transfer"),
                                       IMG, None)
        assert (got.success, got.reason) == (ref.success, ref.reason) == (
            False, "material stack unavailable")
    extra = {"sdxl_material": print, "load_visual": print}
    got = visual.material_transfer(Toolbox(ground=lambda *a, **k: None, depth=print,
                                           extra=extra), _record("port", REC, "material_transfer"),
                                   IMG, None)
    assert (got.success, got.reason) == (False, "object not found")


@pytest.mark.parametrize("grounding_batch", [0, 2])
def test_executors_match(tmp_path, monkeypatch, zoo_pair, grounding_batch):
    """Two material_transfer records (edit types material_transfer and
    visual_material_transfer) through the port's and the JAX package's
    `FactoryExecutor` (the stub grounder, no pre-filter, the post-filter's
    decision forced open), per record and in a chunk of 2: equal statuses,
    stages and reasons, both a success, the exemplar written as the
    visual input, and the post-filter scores within FRAME_MEAN / 255."""
    lines = {}
    jtb, tb = _toolboxes(zoo_pair)
    for kind, ex_mod, box in (("jax", jexecutor, jtb), ("port", executor, tb)):
        monkeypatch.setattr(ex_mod, "post_filter_decision", lambda *a, **k: True)
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(box, ex_mod.ExecutorConfig(
            output_root=str(root), grounding_batch=grounding_batch, run_pre_filter=False))
        ex.run([_record(kind, REC, et, i) for i, et in enumerate(
            ("material_transfer", "visual_material_transfer"))], lambda r: IMG)
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    assert [x["status"] for x in lines["port"]] == ["success"] * 2
    for a, b in zip(lines["port"], lines["jax"], strict=True):
        assert (a["key"], a["status"]) == (b["key"], b["status"])
        for k in ("stage", "reason"):
            assert a["payload"].get(k) == b["payload"].get(k), k
        assert a["payload"]["visual_input_file"].endswith(".png")
        sa, sb = a["payload"].get("scores", {}), b["payload"].get("scores", {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k] == pytest.approx(sb[k], abs=FRAME_MEAN / 255) \
                if isinstance(sa[k], float) else sa[k] == sb[k], k


def test_registry_has_material_transfer():
    """Both material types resolve to the port's material_transfer, as in
    the JAX registry, and every JAX type the port resolves has its name."""
    for et in ("material_transfer", "visual_material_transfer"):
        assert get_pipeline(et) is visual.material_transfer
        assert jax_get_pipeline(et).__name__ == "material_transfer"
    for et in EDIT_PIPELINES:
        assert EDIT_PIPELINES[et].__name__ == JAX_PIPELINES[et].__name__, et


def test_install_new_slots(monkeypatch):
    """`install` attaches the refine slots under `tb.extra`, `canny` and
    `depth` on the Toolbox; on the default device (the card) a slot raises
    without CUDA, with nothing built."""
    zoo = ModelZoo(tiny_zoo_config(), device="cpu")
    tb = Toolbox()
    for slot in ("sdxl_img2img", "sdxl_inpaint", "canny_consistency", "sdxl_material",
                 "canny", "depth"):
        zoo.install(tb, slot)
    assert set(tb.extra) == {"sdxl_img2img", "sdxl_inpaint", "canny_consistency",
                             "sdxl_material"}
    assert tb.canny(IMG).shape == (H, W) and tb.depth(IMG).shape == (H, W)
    with pytest.raises(KeyError, match="unknown toolbox slot"):
        zoo.install(tb, "llama")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    card = ModelZoo(tiny_zoo_config())
    for fn in (card.img2img_fn, card.sdxl_material_fn, card.depth_fn):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    assert card._cache == {}


def test_refine_slots_need_micro_conditioning():
    """A refine UNet without SDXL's pooled text and 6 time ids is refused when
    a refine slot is built, before anything is built."""
    cfg = dataclasses.replace(tiny_zoo_config(), refine_unet=TINY_UNET)
    zoo = ModelZoo(cfg, device="cpu")
    for fn in (zoo.img2img_fn, zoo.sdxl_inpaint_fn, zoo.canny_consistency_fn,
               zoo.sdxl_material_fn):
        with pytest.raises(ValueError, match="micro-conditioning"):
            fn()
    assert zoo._cache == {}
