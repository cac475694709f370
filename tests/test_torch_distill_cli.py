"""`python -m anyedit_tpu_torch distill` and the frozen loader's weight
files, against the JAX command where it has the same thing.

The frozen loader reads `<slot>.safetensors`: the same first `train` step
loss as the same trees through `params=` (exact: the same tensors reach
the same modules), and the JAX loader's refusals. `distill --tiny --steps 0
--eval-count 2` in both packages on the same seeded trees (msgpacks for
JAX, `.safetensors` for the port) with JAX's draws handed to the port's
`eval_draws`: the eval PNGs within `PNG_LEVELS` uint8 levels, the three L1
numbers within `L1_ABS`, the two ledgers' records equal. Both packages' UNet
is cut to one level there (the JAX side's compiles are most of the time).
Then the port's counterparts of `tests/test_distill_cli.py`: the student
file and the eval dirs, `--resume`, the student in `ModelZoo(lcm_steps=2)`,
and `--require-weights` without a teacher.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anyedit_tpu.cli as jcli
import anyedit_tpu_torch.cli as tcli
from anyedit_tpu.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.models.vae import AutoencoderKL
from anyedit_tpu.train.frozen import load_frozen_encoders as jax_frozen
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.image import load_rgb
from anyedit_tpu_torch.train.frozen import load_frozen_encoders
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.files import read_safetensors, write_safetensors
from test_torch_bridge import random_flax_params
from test_train_cli import _make_ledger

torch.set_num_threads(1)
T = torch.from_numpy
# fp32 on both sides through 4 DDIM steps of a random one-level UNet at
# guidance 2.0 / 1.0 and 2 LCM steps: the decoded frames within 1 uint8
# level (rounding at .5), the L1 readouts (rounded to 4 decimals by both
# commands) within 2e-4
PNG_LEVELS = 1
L1_ABS = 2e-4
ARGS = ["distill", "--tiny", "--resolution", "32", "--ddim-steps", "4", "--lcm-steps", "2",
        "--guidance", "2.0", "--image-guidance", "1.0", "--lr", "1e-3", "--batch-size", "2",
        "--log-every", "1", "--checkpoint-every", "1"]


def _one_level(configs):
    def cut(tiny):
        cfg, text, vis, vae = configs(tiny)
        unet = dataclasses.replace(cfg.unet, block_channels=(32,), attn_levels=(True,))
        return dataclasses.replace(cfg, unet=unet), text, vis, vae
    return cut


@pytest.fixture
def one_level(monkeypatch):
    """Both packages' `--tiny` AnySD configs with the UNet cut to one level."""
    monkeypatch.setattr(jcli, "_anysd_configs", _one_level(jcli._anysd_configs))
    monkeypatch.setattr(tcli, "_anysd_configs", _one_level(tcli._anysd_configs))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded trees of the one-level tiny configs: {slot: tree}, a dir of
    msgpacks (JAX) and one of `<slot>.safetensors` (the port's state dicts)."""
    cfg, text, vis, vae = _one_level(jcli._anysd_configs)(True)
    ucfg = cfg.unet
    specs = {
        "vae": (AutoencoderKL(vae), (jnp.zeros((1, 32, 32, 3)),)),
        "clip_text": (CLIPTextEncoder(text), (jnp.zeros((1, text.max_len), jnp.int32),)),
        "clip_vision": (CLIPVisionEncoder(vis),
                        (jnp.zeros((1, vis.image_size, vis.image_size, 3)),)),
        "unet_ip2p": (UNet2DCondition(ucfg), (jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,), jnp.int32),
                                              jnp.zeros((1, 4, text.hidden)))),
    }
    to_sd = {"vae": lambda t: bridge.vae_state_dict(t, len(vae.block_channels)),
             "clip_text": bridge.clip_text_state_dict,
             "clip_vision": bridge.clip_vision_state_dict,
             "unet_ip2p": lambda t: bridge.unet_state_dict(t, 1)}
    root = tmp_path_factory.mktemp("distill_weights")
    jdir, tdir = root / "msgpack", root / "safetensors"
    jdir.mkdir()
    tdir.mkdir()
    trees = {}
    for i, (name, (module, args)) in enumerate(specs.items()):
        trees[name] = random_flax_params(module, args, 10 + i)
        save_params(trees[name], jdir / f"{name}.msgpack")
        write_safetensors(tdir / f"{name}.safetensors", to_sd[name](trees[name]))
    return trees, jdir, tdir


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    return _make_ledger(tmp_path_factory.mktemp("distill_ledger"))


def _report(out: str) -> dict:
    """The trailing (indent=1) JSON report of a command's output."""
    return json.loads(out[out.rindex("\n{") + 1:] if "\n{" in out else out[out.index("{"):])


def test_frozen_loader_reads_safetensors(one_level, weights, ledger, tmp_path, capsys):
    """`train --weights-dir <safetensors> --require-weights` takes the same
    first step, to the bit, as the same trees through `params=`; each tower
    holds its file's tensors, and the UNet's state dict reaches the trainer."""
    trees, _, tdir = weights
    losses = []
    for extra, params in ((["--weights-dir", str(tdir), "--require-weights"], None),
                          ([], trees)):
        assert tcli.main(["train", "--ledger", str(ledger), "--steps", "1", "--batch-size",
                          "2", "--resolution", "32", "--tiny", "--val-count", "0",
                          "--log-every", "1", "--checkpoint-dir",
                          str(tmp_path / f"ck{len(losses)}"), "--device", "cpu"] + extra,
                         params=params) == 0
        losses.append(json.loads(capsys.readouterr().out.strip().splitlines()[0])["loss"])
    assert losses[0] == losses[1] and np.isfinite(losses[0])

    _, text_cfg, vis_cfg, vae_cfg = tcli._anysd_configs(True)
    fz = load_frozen_encoders(vae_cfg, text_cfg, vis_cfg, weights_dir=tdir, require=True,
                              device="cpu", allow_fallback_tokenizers=True)
    for module, slot in ((fz.vae, "vae"), (fz.text, "clip_text"), (fz.vision, "clip_vision")):
        want = read_safetensors(tdir / f"{slot}.safetensors")
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), slot
    assert fz.unet_tree is None and sorted(fz.unet_state) == sorted(
        read_safetensors(tdir / "unet_ip2p.safetensors"))


def test_frozen_loader_refusals_match_jax(one_level, weights, tmp_path):
    """Each refusal of the JAX loader, with the same exception: require
    without a weights dir; require with a slot file missing (each package's
    files); merges missing without the fallback. The port also refuses a
    slot given both ways and a `*.msgpack` in its dir."""
    trees, jdir, tdir = weights
    _, jtext, jvis, jvae = jcli._anysd_configs(True)
    _, text, vis, vae = tcli._anysd_configs(True)

    def both(exc, match, jkw, tkw):
        with pytest.raises(exc, match=match):
            jax_frozen(jvae, jtext, jvis, resolution=32, **jkw)
        with pytest.raises(exc, match=match):
            load_frozen_encoders(vae, text, vis, device="cpu", **tkw)

    both(ValueError, "weights_dir", dict(require=True), dict(require=True))
    for d, ext in ((jdir, "msgpack"), (tdir, "safetensors")):
        (d / f"unet_ip2p.{ext}").rename(tmp_path / f"unet.{ext}")
    try:
        both(FileNotFoundError, "unet_ip2p",
             dict(weights_dir=jdir, require=True, allow_fallback_tokenizers=True),
             dict(weights_dir=tdir, require=True, allow_fallback_tokenizers=True))
    finally:
        for d, ext in ((jdir, "msgpack"), (tdir, "safetensors")):
            (tmp_path / f"unet.{ext}").rename(d / f"unet_ip2p.{ext}")
    both(FileNotFoundError, "merges", dict(weights_dir=jdir), dict(weights_dir=tdir))
    with pytest.raises(ValueError, match="both"):
        load_frozen_encoders(vae, text, vis, params={"vae": trees["vae"]}, weights_dir=tdir,
                             device="cpu", allow_fallback_tokenizers=True)
    (tmp_path / "vae.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="msgpack"):
        load_frozen_encoders(vae, text, vis, weights_dir=tmp_path, device="cpu",
                             allow_fallback_tokenizers=True)


def jax_draws(seed, j, shape, lcm_steps, device):
    """The JAX command's eval draws: x_T from fold_in(key(seed + 1), j), the
    student's re-noise draws as `lcm_edit` splits fold_in(key, 10_000 + j)."""
    key = jax.random.key(seed + 1)
    x_T = jax.random.normal(jax.random.fold_in(key, j), shape, jnp.float32)
    _, k = jax.random.split(jax.random.fold_in(key, 10_000 + j))
    renoise = []
    for _ in range(lcm_steps - 1):
        k, k2 = jax.random.split(k)
        renoise.append(T(np.array(jax.random.normal(k2, shape, jnp.float32))).to(device))
    return T(np.array(x_T)).to(device), renoise


def test_distill_eval_matches_jax(one_level, weights, ledger, tmp_path, capsys, monkeypatch):
    """`distill --tiny --steps 0 --eval-count 2` in both packages on the same
    trees and draws: the same quality readout, ledgers and PNGs."""
    _, jdir, tdir = weights
    monkeypatch.setattr(tcli, "eval_draws", jax_draws)
    base = ARGS + ["--steps", "0", "--eval-count", "2", "--ledger", str(ledger)]
    assert jcli.main(base + ["--weights-dir", str(jdir), "--checkpoint-dir", str(tmp_path / "j"),
                             "--out", str(tmp_path / "j" / "s.msgpack")]) == 0
    jrep = _report(capsys.readouterr().out)
    assert tcli.main(base + ["--weights-dir", str(tdir), "--checkpoint-dir",
                             str(tmp_path / "t"), "--out", str(tmp_path / "t" / "s.safetensors"),
                             "--device", "cpu"]) == 0
    trep = _report(capsys.readouterr().out)
    assert sorted(trep) == sorted(jrep) and sorted(trep["quality"]) == sorted(jrep["quality"])
    assert trep["examples"] == jrep["examples"] == 4 and trep["mean_loss"] is None
    jq, tq = jrep["quality"], trep["quality"]
    assert (tq["pairs"], tq["teacher_steps"], tq["student_steps"]) == (2, 4, 2) == \
        (jq["pairs"], jq["teacher_steps"], jq["student_steps"])
    for k in ("latent_l1_teacher_vs_student", "pixel_l1_teacher_vs_student",
              "pixel_l1_teacher_vs_orig"):
        assert abs(tq[k] - jq[k]) <= L1_ABS, (k, tq[k], jq[k])
    assert tq["next"].startswith("run `python -m anyedit_tpu_torch eval")
    for name in ("eval_teacher", "eval_student"):
        jl = [json.loads(x) for x in (tmp_path / "j" / name / "ledger.jsonl").read_text()
              .splitlines()]
        tl = [json.loads(x) for x in (tmp_path / "t" / name / "ledger.jsonl").read_text()
              .splitlines()]
        assert [(x["key"], x["status"], x["record"]) for x in tl] == \
            [(x["key"], x["status"], x["record"]) for x in jl]
        for jx, tx in zip(jl, tl):
            for f in ("edited_file", "input_file"):
                a = load_rgb(jx["payload"][f]).astype(int)
                b = load_rgb(tx["payload"][f]).astype(int)
                assert a.shape == b.shape == (32, 32, 3)
                assert np.abs(a - b).max() <= PNG_LEVELS, (name, f)
    # --steps 0: the student file is the teacher's state dict
    student = read_safetensors(tmp_path / "t" / "s.safetensors")
    teacher = read_safetensors(tdir / "unet_ip2p.safetensors")
    assert sorted(student) == sorted(teacher)
    assert all(torch.equal(student[k], teacher[k].float()) for k in teacher)


def test_distill_writes_student_and_eval_dirs(ledger, tmp_path, capsys):
    """2 tiny steps: finite losses, the student (every UNet key, moved off
    the seeded teacher), both eval dirs readable by `runtime/evaluate.py`
    with the same records, and a checkpoint a step."""
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet
    from anyedit_tpu_torch.runtime.evaluate import default_loader, run_dir_entries
    from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer

    ck, out = tmp_path / "dck", tmp_path / "w" / "unet_ip2p_lcm.safetensors"
    assert tcli.main(ARGS + ["--steps", "2", "--eval-count", "2", "--ledger", str(ledger),
                             "--checkpoint-dir", str(ck), "--out", str(out),
                             "--device", "cpu"]) == 0
    report = _report(capsys.readouterr().out)
    assert np.isfinite(report["mean_loss"]) and report["student_checkpoint"] == str(out)
    student = read_safetensors(out)
    ucfg = tcli._anysd_configs(True)[0].unet
    assert sorted(student) == sorted(TUNet(ucfg).state_dict())
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in student.values())
    q = report["quality"]
    assert q["pairs"] == 2 and q["teacher_steps"] == 4 and q["student_steps"] == 2
    assert all(np.isfinite(q[k]) for k in ("latent_l1_teacher_vs_student",
                                          "pixel_l1_teacher_vs_student",
                                          "pixel_l1_teacher_vs_orig"))
    for name in ("eval_teacher", "eval_student"):
        entries = run_dir_entries(ck / name)
        assert len(entries) == 2, name
        src, dst = default_loader(ck / name, None)(
            InstructionRecord.from_json(entries[0]["record"]), entries[0]["payload"])
        assert src.shape == dst.shape == (32, 32, 3)
    assert run_dir_entries(ck / "eval_teacher")[0]["record"] == \
        run_dir_entries(ck / "eval_student")[0]["record"]
    assert TrainCheckpointer(ck).all_steps() == [1, 2]


def test_distill_resumes(ledger, tmp_path, capsys):
    """`--resume` from step 2 to 4: the student, EMA and optimizer come back
    from the step-2 checkpoint (the optimizer counts 4 steps at the end, not
    2), two more steps run, and the student file is the step-4 EMA."""
    from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer

    ck = tmp_path / "dck"
    args = ARGS + ["--eval-count", "0", "--ledger", str(ledger), "--checkpoint-dir", str(ck),
                   "--out", str(ck / "s.safetensors"), "--device", "cpu"]
    assert tcli.main(args + ["--steps", "2"]) == 0
    capsys.readouterr()
    assert tcli.main(args + ["--steps", "4", "--resume"]) == 0
    out = capsys.readouterr().out
    losses = [json.loads(x)["loss"] for x in out.splitlines() if x.startswith('{"step"')]
    assert "resumed from step 2" in out and _report(out)["final_step"] == 4
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    step, masters, opt = TrainCheckpointer(ck).restore_latest()
    assert step == 4 and opt["count"] == 4
    student = read_safetensors(ck / "s.safetensors")
    assert all(torch.equal(student[k], masters["ema"][k]) for k in student)


def test_distilled_student_feeds_zoo_lcm_mode(ledger, tmp_path, capsys):
    """The written file is what `run --lcm-steps` loads: the zoo's IP2P UNet
    holds its tensors, and the few-step editor runs with it."""
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    wdir = tmp_path / "weights"
    assert tcli.main(ARGS + ["--steps", "1", "--eval-count", "0", "--ledger", str(ledger),
                             "--checkpoint-dir", str(tmp_path / "dck"), "--weights-dir",
                             str(wdir), "--device", "cpu"]) == 0
    capsys.readouterr()
    out = wdir / "unet_ip2p_lcm.safetensors"
    zoo = ModelZoo(dataclasses.replace(tiny_zoo_config(), lcm_steps=2), device="cpu",
                   weights_dir=wdir, allow_fallback_tokenizers=True)
    loaded = zoo._ip2p_core()[0].state_dict()
    want = read_safetensors(out)
    assert sorted(loaded) == sorted(want)
    assert all(torch.equal(loaded[k], want[k].to(loaded[k].dtype)) for k in want)
    img = np.random.default_rng(0).integers(0, 255, (48, 48, 3), np.uint8)
    res = zoo.ip2p()(img, "make it red", None, steps=50, seed=0)
    assert res.shape == (48, 48, 3) and res.dtype == np.uint8


def test_distill_requires_teacher_weights(ledger, tmp_path):
    """--require-weights with no unet_ip2p.safetensors fails loudly, never
    distilling from a seeded teacher; without CUDA, --device cuda raises."""
    wdir = tmp_path / "empty_weights"
    wdir.mkdir()
    args = ARGS + ["--steps", "1", "--eval-count", "0", "--ledger", str(ledger),
                   "--checkpoint-dir", str(tmp_path / "dck")]
    with pytest.raises(FileNotFoundError, match="required weights missing"):
        tcli.main(args + ["--weights-dir", str(wdir), "--require-weights", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(args)
