"""The port's evaluation harness (`runtime/evaluate.py`) against the JAX
package's.

- `evaluate_pairs` on a stub toolbox (no CLIP; the stub's DINO embedding
  gives `dino_sim`): an identical pair, a resized pair and a pair of
  different images, with gated and ungated edit types; and on the tiny
  CLIP towers, the JAX zoo reading seeded trees as `.msgpack` and the
  port's zoo reading the same tensors, bridged, as `<slot>.safetensors`
  (`require_weights`). Every metric within 1e-4 of JAX's, `passes` and
  the report's keys and counts equal; the aggregates are rounded to 4
  digits on both sides, so they are compared within 1e-4 as well.
- `run_dir_entries` and `default_loader` on a hand-written run directory
  (an absolute, a CWD-relative and a moved payload path, a synthesized
  input): the same entries, and the same pixels as the JAX loader (Pillow).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.models import clip as jclip
from anyedit_tpu.runtime import evaluate as jev
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.png import write_png
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.runtime import evaluate as pev
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.files import write_safetensors
from test_torch_bridge import F32, JAX_TEXT, random_flax_params

torch.set_num_threads(1)
RNG = np.random.default_rng(3)
A = RNG.integers(0, 256, (24, 20, 3), np.uint8)
B_ = RNG.integers(0, 256, (24, 20, 3), np.uint8)
C_ = RNG.integers(0, 256, (30, 16, 3), np.uint8)
PAIRS = {("tone_transfer", 0): (A, A.copy()), ("action_change", 1): (A, B_),
         ("appearance_alter", 2): (B_, C_), ("remove", 3): (A, C_)}
TOL = 1e-4
METRICS = ("clip_out", "clip_in", "clip_im", "dir_clip", "l1", "ssim", "dino_sim")


def _entries():
    out = []
    for (et, i), _ in PAIRS.items():
        rec = JaxRecord(edit=f"e{i}", input=f"a photo {i}", output=f"an edited photo {i}",
                        edit_type=et, image_file=f"{i}.png")
        out.append({"key": rec.key(), "record": rec.to_json(), "payload": {"i": i}})
    return out


def _loader(rec, payload):
    return next(v for (_, i), v in PAIRS.items() if i == payload["i"])


def _close(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _close(got[k], ref[k])
        elif isinstance(ref[k], float):
            assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])
        else:
            assert got[k] == ref[k], k


def _same_report(got, ref):
    assert len(got["pairs"]) == len(ref["pairs"])
    for g, r in zip(got["pairs"], ref["pairs"]):
        assert g["key"] == r["key"] and g["passes"] == r["passes"]
        for f in METRICS:
            assert (g[f] is None) == (r[f] is None), f
            if r[f] is not None:
                assert abs(g[f] - r[f]) <= TOL, (f, g[f], r[f])
    _close(got["per_type"], ref["per_type"])
    _close(got["overall"], ref["overall"])


def _dino(img):
    """A stub DINO embedding: the unit mean colour."""
    e = np.asarray(img, np.float32).reshape(-1, 3).mean(0)
    return e / np.linalg.norm(e)


def test_evaluate_pairs_stub_matches_jax():
    class JTB:
        clip_image = clip_text = None
        extra = {"dino_embed": _dino}

    tb = Toolbox(extra={"dino_embed": lambda im: torch.from_numpy(_dino(im))})
    ref = jev.evaluate_pairs(JTB(), _entries(), _loader)
    got = pev.evaluate_pairs(tb, _entries(), _loader)
    _same_report(got, ref)
    assert got["pairs"][0]["l1"] == 0.0 and got["pairs"][0]["ssim"] == pytest.approx(1.0, abs=1e-5)
    assert pev.EVAL_GATED == jev.EVAL_GATED


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """The JAX tiny zoo reading the trees as `.msgpack`; the port's reading
    them bridged as `.safetensors` under `require_weights`."""
    jvis = dataclasses.replace(jclip.TINY_VISION, **F32)
    trees = {"clip_vision": random_flax_params(jclip.CLIPVisionEncoder(jvis), (jnp.zeros(
                 (1, jvis.image_size, jvis.image_size, 3)),), 61),
             "clip_text_proj": random_flax_params(jclip.CLIPTextModel(
                 JAX_TEXT, proj_dim=jvis.proj_dim), (jnp.zeros((1, 77), jnp.int32),), 62)}
    jdir, pdir = tmp_path_factory.mktemp("jw"), tmp_path_factory.mktemp("pw")
    to_sd = {"clip_vision": bridge.clip_vision_state_dict,
             "clip_text_proj": bridge.clip_text_proj_state_dict}
    for name, tree in trees.items():
        save_params(tree, jdir / f"{name}.msgpack")
        write_safetensors(pdir / f"{name}.safetensors", to_sd[name](tree))
    cfg = tiny_zoo_config()
    jzoo = JaxModelZoo(JaxZooConfig(canvas=cfg.canvas, text=JAX_TEXT, vision=jvis),
                       weights_dir=jdir, allow_fallback_tokenizers=True)
    pzoo = ModelZoo(cfg, device="cpu", weights_dir=pdir, allow_fallback_tokenizers=True,
                    require_weights=True)
    jtb, ptb = Toolbox(), Toolbox()
    jtb.clip_image, jtb.clip_text = jzoo.clip_towers()
    pzoo.install(ptb, "clip")
    return jtb, ptb


def test_evaluate_pairs_tiny_clip_matches_jax(clip_pair):
    jtb, ptb = clip_pair
    ref = jev.evaluate_pairs(jtb, _entries(), _loader)
    got = pev.evaluate_pairs(ptb, _entries(), _loader)
    _same_report(got, ref)
    assert got["pairs"][1]["clip_out"] is not None and "pass_rate" in got["overall"]


def test_run_dir_entries_and_default_loader(tmp_path, monkeypatch):
    run = tmp_path / "run"
    imgs = tmp_path / "imgs"
    for d in ("edited_img", "input_img"):
        (run / d).mkdir(parents=True)
    imgs.mkdir()
    write_png(run / "edited_img" / "e0.png", A)
    write_png(run / "edited_img" / "e1.png", B_)
    write_png(run / "input_img" / "i1.png", C_)
    write_png(imgs / "0.png", B_)
    lines = [
        {"key": "k0", "status": "success", "record": {"edit": "e", "input": "i", "output": "o",
                                                      "edit_type": "remove",
                                                      "image_file": "0.png"},
         "payload": {"edited_file": str(run / "edited_img" / "e0.png")}},
        {"key": "k1", "status": "failure", "record": {}, "payload": {"reason": "x"}},
        {"key": "k2", "status": "success", "record": {"edit": "e", "input": "i", "output": "o",
                                                      "edit_type": "add"},
         "payload": {"edited_file": "elsewhere/edited_img/e1.png",
                     "input_file": "elsewhere/input_img/i1.png"}},
    ]
    (run / "ledger.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))
    monkeypatch.chdir(tmp_path)
    got, ref = pev.run_dir_entries(run), jev.run_dir_entries(run)
    assert got == ref and [e["key"] for e in got] == ["k0", "k2"]
    pload, jload = pev.default_loader(run, imgs), jev.default_loader(run, imgs)
    for e in got:
        rec = JaxRecord.from_json(e["record"])
        for g, r in zip(pload(rec, e["payload"]), jload(rec, e["payload"])):
            np.testing.assert_array_equal(g, r)
    with pytest.raises(FileNotFoundError):
        pev.default_loader(run, None)(JaxRecord.from_json(got[0]["record"]), got[0]["payload"]
                                      | {"edited_file": "gone.png"})
