"""The local edits (`remove`, `counting`, `add`, `replace`,
`background_change`), `style_change` and `appearance_alter` of the PyTorch
port against the JAX package's pipelines on the tiny zoos, with
`sample_inpaint` and the SD inpainter slot on their own.

The same seeded Flax parameters go to both sides (the JAX zoo reads them as
msgpack checkpoints, the port through the weight bridge): the grounder, LaMa,
the IP2P and the 9-channel inpaint UNets, the VAE and the CLIP text tower.
The diffusion noise is JAX's own draws at seed 0 handed to the port. The
pipelines ask for 50 SD-inpaint steps at scale 7.5 and for IP2P at 50 steps
(8.0 / 1.5 masked, 7.5 / 1.2 for style), which is checked; the tiny edits run
3 of them on both sides, which keeps the CPU run short.

Tolerances: `sample_inpaint`'s latents 1e-4 max-abs; the SD inpainter's and
the editors' uint8 frames within 1 level (fp32 drift through the guidance,
as in `test_torch_color_alter.py`); LaMa's frames within 1 level (its
fp32 output, 2e-5 apart, is truncated to uint8); masks equal; the tier
kernel of `_tiered_dilate_np` exact at ratios next to each boundary. Each
port pipeline is also held to the JAX pipeline given the port's own model
outputs, within 1 level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.diffusion.sampling import sample_inpaint as jax_sample_inpaint
from anyedit_tpu.edits import local as jlocal
from anyedit_tpu.edits.registry import get_pipeline as jax_get_pipeline
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models.lama import TINY_LAMA as JAX_LAMA
from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.schedulers import make_noise_schedule as jax_schedule
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.diffusion import sample_inpaint
from anyedit_tpu_torch.edits import global_, implicit, local
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import (
    JAX_TEXT, JAX_UNET, JAX_VAE, random_flax_params, text_params, unet_params, vae_params,
)
from test_torch_color_alter import _jax_noise
from test_torch_gdino import JAX_GDINO, gdino_params
from test_torch_lama import lama_params
from test_torch_sam import JAX_SAM, sam_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_INPAINT_UNET = dataclasses.replace(JAX_UNET, in_channels=9)
IMG = np.random.default_rng(71).integers(0, 256, (48, 40, 3), np.uint8)
EDIT_STEPS = 3
REC = {"edit": "remove the red square", "edited object": "red square",
       "input": "a red square", "output": "a grassy field", "new object": "blue ball",
       "remove_number": 2}


def inpaint_unet_params(seed=72):
    return random_flax_params(
        UNet2DCondition(JAX_INPAINT_UNET),
        (jnp.zeros((1, 32, 32, 9)), jnp.zeros((1,), jnp.int32),
         jnp.zeros((1, 77, JAX_UNET.context_dim))), seed)


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """Both tiny zoos on the same params, every box kept above a score of 0."""
    params = {"gdino": gdino_params(), "sam": sam_params(), "lama": lama_params(),
              "unet_ip2p": unet_params(), "unet_inpaint": inpaint_unet_params(),
              "vae": vae_params(), "clip_text": text_params()}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, gdino=JAX_GDINO, sam=JAX_SAM, lama=JAX_LAMA,
                        ip2p_unet=JAX_UNET, inpaint_unet=JAX_INPAINT_UNET, vae=JAX_VAE,
                        text=JAX_TEXT, box_threshold=0.0)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


def _recording(kind, fn, calls, **noise):
    """The zoo's ip2p or sd_inpaint at EDIT_STEPS, recording the knobs the
    pipeline asks for and the frame it returns."""
    if kind == "ip2p":
        def call(image, instruction, mask01, steps, s_txt, s_img):
            out = np.asarray(fn(image, instruction, mask01, steps=EDIT_STEPS, s_txt=s_txt,
                                s_img=s_img, **noise))
            calls.append(("ip2p", (steps, s_txt, s_img), out))
            return out
    else:
        def call(image, mask01, prompt, negative="", steps=50, scale=7.5):
            out = np.asarray(fn(image, mask01, prompt, negative, steps=EDIT_STEPS,
                                scale=scale, **noise))
            calls.append(("sd_inpaint", (steps, scale, prompt, negative), out))
            return out
    return call


def _toolboxes(zoo_pair, calls, gone=False):
    """(JAX toolbox, port toolbox); each records its model outputs in
    calls[kind] as ("lama" | "ip2p" | "sd_inpaint", knobs, frame). With
    `gone`, the grounders find nothing in any image but IMG, so the removal
    checks pass (the random detector finds its boxes everywhere)."""
    jzoo, zoo = zoo_pair
    init, renoise = _jax_noise()

    def ground(real):
        if not gone:
            return real
        return lambda image, *a, **k: real(image, *a, **k) if image is IMG else None

    def lama(fn, log):
        def inpaint(img01, mask01):
            out = np.asarray(fn(img01, mask01))
            log.append(("lama", None, out))
            return out
        return inpaint
    jtb = JaxToolbox(ground=ground(jzoo.grounder()), inpaint=lama(jzoo.inpainter(), calls["jax"]),
                     ip2p=_recording("ip2p", jzoo.ip2p(), calls["jax"]),
                     sd_inpaint=_recording("sd", jzoo.sd_inpainter(), calls["jax"]))
    noise = dict(init_latents=init, renoise=renoise)
    tb = Toolbox(ground=ground(zoo.grounder()), inpaint=lama(zoo.inpainter(), calls["port"]),
                 ip2p=_recording("ip2p", zoo.ip2p(), calls["port"], **noise),
                 sd_inpaint=_recording("sd", zoo.sd_inpainter(), calls["port"], **noise))
    return jtb, tb


def _replay(tb, log):
    """A JAX toolbox that serves the port's recorded model outputs in order."""
    frames = iter(out for _, _, out in log)
    return JaxToolbox(ground=tb.ground, inpaint=lambda *a, **k: next(frames),
                      ip2p=lambda *a, **k: next(frames),
                      sd_inpaint=lambda *a, **k: next(frames))


def _diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


KNOBS = {"replace": [(50, 7.5, "a photo of blue ball", "")],
         "background_change": [(50, 7.5, "a grassy field", local.BG_NEGATIVE_PROMPT)],
         "style_change": [(implicit.STEPS, implicit.S_TXT, implicit.S_IMG)],
         "appearance_alter": [(50, 8.0, 1.5)], "material_alter": [(50, 8.0, 1.5)]}


PIPELINE_CASES = [(t, False) for t in ("remove", "counting", "add", "replace",
                                        "background_change", "style_change",
                                        "appearance_alter", "material_alter")] \
    + [(t, True) for t in ("remove", "counting", "add")]


@pytest.mark.parametrize("edit_type,gone", PIPELINE_CASES)
def test_pipeline_matches(zoo_pair, edit_type, gone):
    """The record through `get_pipeline` on both tiny zoos: the same
    outcome (success, reason), the same model calls with the same knobs,
    each model's frame within 1 level, the same masks, and the edited (and
    synthesized input) frames within 1 level of the JAX pipeline's and of
    the JAX pipeline given the port's model outputs. The random detector
    finds the object again after a removal, so remove, counting and add
    fail their checks; with `gone` they pass and succeed."""
    calls = {"jax": [], "port": []}
    jtb, tb = _toolboxes(zoo_pair, calls, gone)
    obj = dict(REC, edit_type=edit_type)
    ref = jax_get_pipeline(edit_type)(jtb, JaxRecord.from_json(obj), IMG,
                                      np.random.default_rng(0))
    got = get_pipeline(edit_type)(tb, InstructionRecord.from_json(obj), IMG,
                                  np.random.default_rng(0))
    same = jax_get_pipeline(edit_type)(_replay(jtb, calls["port"]), JaxRecord.from_json(obj),
                                       IMG, np.random.default_rng(0))
    assert (got.success, got.reason) == (ref.success, ref.reason) == (same.success, same.reason)
    if gone:
        assert got.success
    assert [c[:2] for c in calls["port"]] == [c[:2] for c in calls["jax"]]
    if edit_type in KNOBS:
        assert [c[1] for c in calls["port"] if c[0] != "lama"] == KNOBS[edit_type]
    for (_, _, a), (_, _, b) in zip(calls["port"], calls["jax"]):
        assert a.shape == b.shape
        assert (np.abs(a - b).max() <= 2e-5) if a.dtype == np.float32 else _diff(a, b) <= 1
    for field in ("edited", "input_image"):
        a, b, c = getattr(got, field), getattr(ref, field), getattr(same, field)
        assert (a is None) == (b is None) == (c is None), field
        if a is not None:
            assert a.dtype == np.uint8 and a.shape == IMG.shape
            assert _diff(a, b) <= 1 and _diff(a, c) <= 1, field
    if ref.mask is None:
        assert got.mask is None
    else:
        np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))


@pytest.mark.parametrize("ratio", [0.0, 0.0499, 0.05, 0.0501, 0.1499, 0.15, 0.1501, 0.9])
def test_tiered_dilate_matches(ratio):
    """The tier kernel (15 / 25 / 35) on both sides of each boundary, on a
    mask near the frame's corner (the dilation clips at the border)."""
    mask = np.zeros((60, 50), bool)
    mask[3:9, 40:44] = True
    mask[30, 20] = True
    ref = np.asarray(jlocal._tiered_dilate_np(mask, ratio))
    np.testing.assert_array_equal(local._tiered_dilate_np(mask, ratio), ref)
    np.testing.assert_array_equal(local._tiered_dilate_np(T(mask), ratio), ref)
    assert local._mask_intersection_ratio(ref, mask) == jlocal._mask_intersection_ratio(ref, mask)


def test_union_ratio_tier_matches(zoo_pair):
    """The grounding that `remove` dilates: the same union ratio (1e-6) and
    the same tier on both sides, so the kernel size is decided alike."""
    jzoo, zoo = zoo_pair
    ref = float(jzoo.grounder()(IMG, "red square").union_ratio)
    got = float(zoo.grounder()(IMG, "red square").union_ratio)
    assert abs(got - ref) <= 1e-6

    def tier(r):
        return 15 if r < 0.05 else (25 if r < 0.15 else 35)
    assert tier(got) == tier(ref)


def test_sample_inpaint_matches():
    """`sample_inpaint` with the JAX noise handed in, on the bridged tiny
    9-channel UNet: latents within 1e-4 max-abs."""
    params = inpaint_unet_params()
    rng = np.random.default_rng(73)
    lat = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 8:24, 4:20] = 1.0
    cond, uncond = (rng.standard_normal((1, 77, JAX_UNET.context_dim)).astype(np.float32)
                    for _ in range(2))
    key = jax.random.key(5)
    jun = UNet2DCondition(JAX_INPAINT_UNET)
    ref = np.asarray(jax_sample_inpaint(lambda x, t, c: jun.apply(params, x, t, c),
                                        jax_schedule(), jnp.asarray(lat), jnp.asarray(mask),
                                        jnp.asarray(cond), jnp.asarray(uncond), key,
                                        num_steps=4, guidance_scale=7.5))
    init = np.array(jax.random.normal(key, lat.shape, jnp.float32))
    renoise = np.array(jax.random.normal(jax.random.fold_in(key, 1), lat.shape))
    tun = TUNet(dataclasses.replace(tiny_zoo_config().inpaint_unet))
    tun.load_state_dict(bridge.unet_state_dict(params, 2), strict=True)
    with torch.no_grad():
        got = sample_inpaint(tun.eval(), make_noise_schedule(), T(lat), T(mask), T(cond),
                             T(uncond), num_steps=4, guidance_scale=7.5,
                             init_latents=T(init), renoise=T(renoise)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    keep = mask[..., 0] == 0
    np.testing.assert_array_equal(got[keep], lat[keep])   # the last composite


def test_sd_inpainter_matches(zoo_pair):
    """The zoo's `sd_inpaint` (mask above 0.25 at latent size) on a 48x40
    image with a soft-edged mask, JAX's noise handed in: within 1 level."""
    jzoo, zoo = zoo_pair
    mask = np.zeros((48, 40), np.float32)
    mask[10:30, 6:26] = 1.0
    mask[30:34, 6:26] = 0.3          # above 0.25, below IP2P's 0.5
    init, renoise = _jax_noise()
    ref = jzoo.sd_inpainter()(IMG, mask, "a red ball", "blurry", steps=EDIT_STEPS)
    got = zoo.sd_inpainter()(IMG, mask, "a red ball", "blurry", steps=EDIT_STEPS,
                             init_latents=init, renoise=renoise)
    assert got.dtype == np.uint8 and got.shape == IMG.shape
    assert _diff(got, ref) <= 1


def test_registry_serves_the_slice():
    """Every pipeline of `edits/local.py` and `global_.py`, and style_change."""
    assert get_pipeline("counting") is get_pipeline("remove") is local.remove
    assert get_pipeline("material_alter") is get_pipeline("appearance_alter") \
        is global_.appearance_alter
    for name in ("add", "replace", "background_change"):
        assert get_pipeline(name) is getattr(local, name)
    assert get_pipeline("style_change") is implicit.style_change
    assert local.BG_NEGATIVE_PROMPT == jlocal.BG_NEGATIVE_PROMPT


@pytest.mark.parametrize("flags,ip2p_quant,inpaint_quant", [
    ({"quant_ip2p": True}, True, False), ({"quant_diffusion": True}, True, True)])
def test_quant_flags_reach_the_inpaint_unet(flags, ip2p_quant, inpaint_quant):
    """`quant_diffusion` makes the 9-channel inpaint UNet W8A8 as well, as
    the JAX zoo's `sd_inpainter` does; `quant_ip2p` leaves it float."""
    zoo = ModelZoo(dataclasses.replace(tiny_zoo_config(), **flags), device="cpu")
    assert zoo._ip2p_core()[0].cfg.quant is ip2p_quant
    unet = zoo._inpaint_core()[0]
    assert unet.cfg.quant is inpaint_quant and unet.cfg.in_channels == 9
