"""The grounding slot and the `color_alter` / `tone_transfer` edits of the
PyTorch port against the JAX package's zoo and pipelines, at the tiny
config, whose `box_threshold=0.0` keeps the random detector's boxes.

The same seeded Flax parameters go to both sides (the JAX zoo reads them as
msgpack checkpoints, the port through the weight bridge), and the IP2P
noise is JAX's own draws handed to the port. The pipelines ask the editor
for 100 steps at s_txt 8.0, s_img 0.9 (checked); the tiny edit runs 3 of
them on both sides, which keeps the CPU run short and the fp32 drift
through guidance 8 within a level (as `test_torch_slice.py`). Tolerances:
boxes 1e-3 px, scores 1e-5, keep identical, merged masks equal on >= 99.9 %
of pixels; the edited frame, `crop_composite`, and the pipelines given the
same edited frame within 1 uint8 level.

One more level separates the two whole `color_alter` pipelines: inside the
mask the feathered weight is 1 - 6e-8, not 1, so the blend lands a hair
below or above an integer, and `astype(uint8)` truncates it down one level
or not depending on the last bit of the blur (JAX and PyTorch sum the 13
taps in different orders). That level adds to the edit's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.edits import global_ as jglobal
from anyedit_tpu.edits.registry import get_pipeline as jax_get_pipeline
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import global_
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_bridge import JAX_TEXT, JAX_UNET, JAX_VAE, text_params, unet_params, vae_params
from test_torch_gdino import JAX_GDINO, gdino_params
from test_torch_sam import JAX_SAM, sam_params

torch.set_num_threads(1)
T = torch.from_numpy
IMG = np.random.default_rng(13).integers(0, 256, (48, 40, 3), np.uint8)
REC = {"edit": "make the square blue", "edited object": "red square",
       "input": "a red square", "output": "a blue square", "edit_type": "color_alter"}


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """The JAX zoo (the shared params as its checkpoints) and the port's
    tiny zoo (the same params through the bridge), both keeping every box
    above a score of 0."""
    params = {"gdino": gdino_params(), "sam": sam_params(), "unet_ip2p": unet_params(),
              "vae": vae_params(), "clip_text": text_params()}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, gdino=JAX_GDINO, sam=JAX_SAM, ip2p_unet=JAX_UNET,
                        vae=JAX_VAE, text=JAX_TEXT, box_threshold=0.0)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


def _jax_noise():
    """The start latents and re-noise draws of the JAX zoo's `ip2p` at seed 0."""
    key = jax.random.key(0)
    shape = (1, 32, 32, 4)
    return (T(np.array(jax.random.normal(key, shape, jnp.float32))),
            T(np.array(jax.random.normal(jax.random.fold_in(key, 1), shape, jnp.float32))))


EDIT_STEPS = 3


def _editor(edit, calls, **noise):
    """The zoo's ip2p, recording the knobs the pipeline asks for and the
    frame it returns, and running EDIT_STEPS steps."""
    def ip2p(image, instruction, mask01, steps, s_txt, s_img):
        out = np.asarray(edit(image, instruction, mask01, steps=EDIT_STEPS, s_txt=s_txt,
                              s_img=s_img, **noise))
        calls.append(((steps, s_txt, s_img), out))
        return out
    return ip2p


def _toolboxes(jzoo, zoo, calls):
    init, renoise = _jax_noise()
    port = Toolbox(ground=zoo.grounder(),
                   ip2p=_editor(zoo.ip2p(), calls, init_latents=init, renoise=renoise))
    return JaxToolbox(ground=jzoo.grounder(), ip2p=_editor(jzoo.ip2p(), calls)), port


@pytest.mark.parametrize("phrase", ["red square", "***"])
def test_grounder_matches(zoo_pair, phrase):
    """`ground()` on a 48x40 image: the same 32 candidate boxes (1e-3 px),
    scores and keep mask, merged masks equal on >= 99.9 % of the pixels.
    "***" has no word, so both take the whole-caption span fallback."""
    jzoo, zoo = zoo_pair
    ref = jzoo.grounder()(IMG, phrase, mode="merge")
    got = zoo.grounder()(IMG, phrase, mode="merge")
    assert ref is not None and got is not None
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.mask.shape == (48, 40)
    assert (got.mask.numpy() == np.asarray(ref.mask)).mean() >= 0.999
    assert abs(float(got.union_ratio) - float(ref.union_ratio)) <= 1e-5


def test_crop_composite_matches():
    rng = np.random.default_rng(14)
    orig, edited = (rng.integers(0, 256, (30, 26, 3), np.uint8) for _ in range(2))
    mask = np.zeros((30, 26), bool)
    mask[8:20, 5:15] = True
    ref = np.asarray(jglobal.crop_composite(orig, edited, mask)).astype(np.int32)
    got = global_.crop_composite(orig, edited, mask)
    assert got.dtype == np.uint8 and got.shape == orig.shape
    assert np.abs(got.astype(np.int32) - ref).max() <= 1
    far = np.ones((30, 26), bool)
    far[:28, :23] = False        # farther than dilate 2 + blur 6 from the mask
    np.testing.assert_array_equal(got[far], orig[far])


@pytest.mark.parametrize("edit_type", ["color_alter", "tone_transfer"])
def test_edit_matches(zoo_pair, edit_type):
    """The record through `get_pipeline` on both sides, JAX's noise handed
    to the port: both ask for 100 steps at 8.0 / 0.9; the edited frames
    within 1 uint8 level; the same mask; the JAX pipeline given the port's
    frame within 1 level of the port's record, and its own record within 2
    (color_alter, see the module docstring) or 1 (tone_transfer)."""
    jzoo, zoo = zoo_pair
    calls = []
    jtb, tb = _toolboxes(jzoo, zoo, calls)
    obj = dict(REC, edit_type=edit_type)
    ref = jax_get_pipeline(edit_type)(jtb, JaxRecord.from_json(obj), IMG,
                                      np.random.default_rng(0))
    got = get_pipeline(edit_type)(tb, InstructionRecord.from_json(obj), IMG,
                                  np.random.default_rng(0))
    assert got.success and ref.success
    (jknobs, jframe), (knobs, frame) = calls
    assert jknobs == knobs == (100, 8.0, 0.9)
    assert np.abs(frame.astype(np.int32) - jframe.astype(np.int32)).max() <= 1
    same = jax_get_pipeline(edit_type)(JaxToolbox(ground=jtb.ground, ip2p=lambda *a, **k: frame),
                                       JaxRecord.from_json(obj), IMG, np.random.default_rng(0))
    assert got.edited.dtype == np.uint8 and got.edited.shape == IMG.shape

    def diff(a, b):
        return np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max()
    assert diff(got.edited, same.edited) <= 1
    assert diff(got.edited, ref.edited) <= (2 if edit_type == "color_alter" else 1)
    if edit_type == "color_alter":
        assert got.mask.any()
        np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))
    else:
        assert got.mask is None and ref.mask is None


def test_color_alter_object_not_found(zoo_pair):
    """No box above the threshold: `ground` returns None and the record
    fails with "object not found", as in the JAX pipeline."""
    _, zoo = zoo_pair
    strict = ModelZoo(dataclasses.replace(zoo.cfg, box_threshold=1.0), device="cpu",
                      params=zoo.params)
    assert strict.grounder()(IMG, "red square") is None
    tb = Toolbox(ground=strict.grounder(), ip2p=lambda *a, **k: pytest.fail("no edit"))
    out = get_pipeline("color_alter")(tb, InstructionRecord.from_json(REC), IMG,
                                      np.random.default_rng(0))
    ref = jglobal.color_alter(JaxToolbox(ground=lambda *a, **k: None),
                              JaxRecord.from_json(REC), IMG, np.random.default_rng(0))
    assert (out.success, out.reason) == (ref.success, ref.reason) == (False, "object not found")


def test_registry_names_what_is_ported():
    assert get_pipeline("color_alter") is global_.color_alter
    assert get_pipeline("tone_transfer") is global_.tone_transfer
    with pytest.raises(KeyError, match="have: \\['action_change', 'add', "
                                       "'appearance_alter', 'background_change', "
                                       "'color_alter', 'composition', 'counting', "
                                       "'implicit_change', 'material_alter', "
                                       "'material_transfer', 'movement', 'outpainting', "
                                       "'relation', 'remove', 'replace', 'resize', "
                                       "'rotation_change', 'style_change', 'textual_change', "
                                       "'tone_transfer', 'visual_bbox', 'visual_depth', "
                                       "'visual_material_transfer', 'visual_reference', "
                                       "'visual_scribble', 'visual_segment', "
                                       "'visual_sketch'\\]"):
        get_pipeline("no_such_type")


def test_grounder_on_the_card_raises_without_cuda(monkeypatch):
    """`ModelZoo().grounder()` targets CUDA and raises where it is absent;
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = ModelZoo(tiny_zoo_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.grounder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.toolbox()
    assert zoo._cache == {}
