"""The AnySD trainer's data, checkpoint, validation and command line in the
PyTorch port, against the JAX package where it has the same thing
(`AnySDEditor` is held in `test_torch_anysd_editor.py`).

Exact: the mixture sampler's draws, `pixel_batches` (Pillow-written PNG
ledgers, read with the port's decoder and its Pillow-equal LANCZOS),
`image_grid`, Pillow's resampling and PNG decoding, and the checkpointer's
decisions against Orbax's CheckpointManager, call for call. The `train`
command runs 2 tiny steps and resumes to 4, as `tests/test_train_cli.py`
does for the JAX one.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from anyedit_tpu.cli import _anysd_configs as jax_configs
from anyedit_tpu.core.schema import InstructionRecord
from anyedit_tpu.models.clip import CLIPTextEncoder
from anyedit_tpu.models.vae import AutoencoderKL
from anyedit_tpu.train import data as jdata
from anyedit_tpu.train import validation as jval
from anyedit_tpu.train.checkpoint import TrainCheckpointer as JaxCheckpointer
from anyedit_tpu_torch.cli import _anysd_configs, main as cli_main
from anyedit_tpu_torch.core.image import load_rgb, pil_resize
from anyedit_tpu_torch.core.png import decode_png, encode_png
from anyedit_tpu_torch.train import data as tdata
from anyedit_tpu_torch.train import validation as tval
from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer
from anyedit_tpu_torch.train.frozen import load_frozen_encoders
from test_torch_bridge import random_flax_params

torch.set_num_threads(1)
TYPES = ["color_alter", "remove", "add"]


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    """6 success rows over 3 edit types, 32x32 and 40x48 RGB PNGs written by
    Pillow (its adaptive row filters), plus one failure row."""
    root = tmp_path_factory.mktemp("ledger")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        a, b = root / f"in_{i}.png", root / f"ed_{i}.png"
        hw = (32, 32) if i % 2 else (40, 48)
        Image.fromarray(rng.integers(0, 255, hw + (3,), np.uint8)).save(a)
        smooth = np.add.outer(np.arange(hw[0]), np.arange(hw[1]))[..., None] * (i + 1)
        Image.fromarray((smooth * np.array([1, 2, 3]) % 256).astype(np.uint8)).save(b)
        rec = InstructionRecord(edit=f"edit {i}", input="a", output="b",
                                edit_type=TYPES[i % 3], image_file=str(a)).to_json()
        rows.append({"key": f"k{i}", "status": "success", "record": rec,
                     "payload": {"edited_file": str(b), "input_file": str(a)}})
    rows.append({"key": "bad", "status": "failure", "record": rows[0]["record"]})
    led = root / "ledger.jsonl"
    led.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return led


def test_examples_and_sampler_match(ledger):
    """The same examples, and the same 64 draws with and without weights."""
    jex, tex = jdata.examples_from_ledger(ledger), tdata.examples_from_ledger(ledger)
    assert [(e.input_file, e.edited_file) for e in jex] == \
        [(e.input_file, e.edited_file) for e in tex] and len(tex) == 6
    for w in (None, {"remove": 0.0, "add": 3.0}):
        js, ts = jdata.MixtureSampler(jex, w, seed=7), tdata.MixtureSampler(tex, w, seed=7)
        assert ts.types == js.types
        assert [js.sample().edited_file for _ in range(64)] == \
            [ts.sample().edited_file for _ in range(64)]


def test_pixel_batches_match(ledger):
    """Two batches of 3 at 24 px, byte for byte: Pillow's LANCZOS and the
    port's, the PNGs read with Pillow and with the port's decoder."""
    tok = lambda s: np.array([[len(s), 1, 2]], np.int32)
    jb = list(jdata.pixel_batches(jdata.MixtureSampler(jdata.examples_from_ledger(ledger),
                                                       seed=1), 3, 24, 2, tok))
    tb = list(tdata.pixel_batches(tdata.MixtureSampler(tdata.examples_from_ledger(ledger),
                                                       seed=1), 3, 24, 2, tok))
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("method", ["lanczos", "bicubic"])
def test_pil_resize_and_png_decode_match_pillow(method):
    """`pil_resize` equals `Image.resize` down and up; `decode_png` and
    `load_rgb` read Pillow's RGB, RGBA and L files as Pillow does."""
    rng = np.random.default_rng(2)
    f = {"lanczos": Image.LANCZOS, "bicubic": Image.BICUBIC}[method]
    for hw in ((37, 53), (256, 200)):
        im = rng.integers(0, 256, hw + (3,), np.uint8)
        for size in ((24, 24), (64, 48), (300, 19)):
            np.testing.assert_array_equal(pil_resize(im, *size, method),
                                          np.asarray(Image.fromarray(im).resize(size, f)))
    for mode, shape in (("RGB", (21, 30, 3)), ("RGBA", (21, 30, 4)), ("L", (21, 30))):
        a = rng.integers(0, 256, shape, np.uint8)
        buf = io.BytesIO()
        Image.fromarray(a, mode).save(buf, format="PNG")
        np.testing.assert_array_equal(decode_png(buf.getvalue()).reshape(shape), a)
    np.testing.assert_array_equal(decode_png(encode_png(a)), a[..., None])


def test_image_grid_matches():
    rng = np.random.default_rng(3)
    ims = [rng.integers(0, 256, (9, 7, 3), np.uint8) for _ in range(5)]
    for cols in (None, 2):
        np.testing.assert_array_equal(tval.image_grid(ims, cols), jval.image_grid(ims, cols))


def test_checkpointer_decides_as_orbax(tmp_path):
    """The same calls to both (keep 2, every 3 steps, a restart in the
    middle): the same return values, the same steps kept, the same latest
    step restored."""
    tree = {"w": np.arange(4, dtype=np.float32)}
    opt = {"count": np.zeros((), np.int32), "mu": {"w": np.zeros(4, np.float32)}}
    calls = [1, 2, 3, 3, 4, 6, 5, 9, "restart", 10, 12, 12, 13]
    j = JaxCheckpointer(tmp_path / "j", keep=2, save_interval_steps=3)
    t = TrainCheckpointer(tmp_path / "t", keep=2, save_interval_steps=3)
    for c in calls:
        if c == "restart":
            j.close()
            j = JaxCheckpointer(tmp_path / "j", keep=2, save_interval_steps=3)
            t = TrainCheckpointer(tmp_path / "t", keep=2, save_interval_steps=3)
            continue
        w = {"w": tree["w"] + c}
        topt = {"count": c, "mu": {"w": torch.zeros(4)}}
        assert t.save(c, {k: torch.from_numpy(v) for k, v in w.items()}, topt) \
            == j.save(c, w, opt), c
        j.wait()
        assert t.all_steps() == list(j.mgr.all_steps()), c
    step, ad, op = t.restore_latest()
    jstep, jad, _ = j.restore_latest(tree, opt)
    assert step == jstep == 12
    np.testing.assert_array_equal(ad["w"].numpy(), np.asarray(jad["w"]))
    assert op["count"] == 12
    j.close()
    assert TrainCheckpointer(tmp_path / "empty").restore_latest() == (None, None, None)


def test_frozen_loader_refusals(tmp_path):
    cfg, text_cfg, vis_cfg, vae_cfg = _anysd_configs(True)
    with pytest.raises(ValueError, match="needs params"):
        load_frozen_encoders(vae_cfg, text_cfg, vis_cfg, require=True, device="cpu")
    _, jtext, _, jvae = jax_configs(True)
    partial = {"vae": random_flax_params(AutoencoderKL(jvae), (jnp.zeros((1, 32, 32, 3)),), 0),
               "clip_text": random_flax_params(CLIPTextEncoder(jtext),
                                               (jnp.zeros((1, 16), jnp.int32),), 1)}
    with pytest.raises(FileNotFoundError, match="clip_vision"):
        load_frozen_encoders(vae_cfg, text_cfg, vis_cfg, params=partial, require=True,
                             device="cpu")
    with pytest.raises(FileNotFoundError, match="merges"):
        load_frozen_encoders(vae_cfg, text_cfg, vis_cfg, weights_dir=tmp_path, device="cpu")
    (tmp_path / "vae.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="msgpack"):
        load_frozen_encoders(vae_cfg, text_cfg, vis_cfg, weights_dir=tmp_path, device="cpu")


def test_train_cli_checkpoints_resumes_and_edits(ledger, tmp_path, capsys):
    """`train --tiny --device cpu`: 2 steps with a checkpoint and a
    validation grid each, then `--resume` to 4 (the draws of step s come
    from (seed << 32) + s); then `edit` from the latest checkpoint."""
    ck = tmp_path / "ckpt"
    args = ["train", "--ledger", str(ledger), "--steps", "2", "--batch-size", "2",
            "--resolution", "32", "--tiny", "--checkpoint-dir", str(ck),
            "--checkpoint-every", "1", "--log-every", "1", "--val-count", "2",
            "--val-steps", "2", "--device", "cpu"]
    assert cli_main(args) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    final = json.loads(lines[-1])
    assert final["final_step"] == 2 and np.isfinite(final["mean_loss"])
    assert final["mixture_types"] == sorted(TYPES) and final["examples"] == 6
    assert TrainCheckpointer(ck).all_steps() == [1, 2]
    grid = load_rgb(ck / "val" / "val_step_2.png")
    assert grid.shape == (2 * 32 + 2, 2 * 32 + 2, 3)

    args[args.index("--steps") + 1] = "4"
    assert cli_main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert json.loads(out.strip().splitlines()[-1])["final_step"] == 4
    assert TrainCheckpointer(ck).all_steps() == [2, 3, 4]

    dst = tmp_path / "out" / "edited.png"
    assert cli_main(["edit", "--image", str(ledger.parent / "in_0.png"), "--instruction",
                     "add a hat", "--edit-type", "add", "--checkpoint-dir", str(ck),
                     "--output", str(dst), "--tiny", "--resolution", "32", "--steps", "2",
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["size"] == [40, 48]
    assert load_rgb(dst).shape == (40, 48, 3)
