"""The port's command line (`anyedit_tpu_torch/cli.py`) and its tables
against the JAX package's, on the CPU at the tiny configuration.

- `core/config.py`: `FactoryConfig`, `task_config` for every preset (and a
  type without one), `from_dict`'s refusal of an unknown key, `load` and
  `override`: equal to JAX's. `SLOTS_FOR_EDIT_TYPE` equal key for key.
- `run --tiny --device cpu --no-filters` over a tone_transfer and a remove
  record (chunk mode, `--ground-batch 8`): the ledger (statuses, reasons,
  records) and the report's keys equal the port's `FactoryExecutor` driven
  directly on a toolbox built the same way (that executor is held to JAX
  in `test_torch_executor.py`), and the edited PNG bytes equal. The IP2P
  edit runs 2 DDIM steps (`ExecutorConfig.ip2p_steps_override`), not the
  preset's 100, to keep the file cheap on one core.
- `export` byte-equal to the JAX ledger's export; `generate --backend
  template` (color_alter, counting) byte-equal to JAX's `generate`;
  `generate --backend llama --tiny` on a JAX TINY_LLAMA tree (fp32)
  handed through `params`: the LLM's raw strings and the records equal to
  JAX's `InstructionGenerator` over its `LlamaBackend` on the same tree,
  byte tokens and batch (random weights parse into no record); `convert
  --list` names equal JAX `REGISTRY`'s.
- The loader hooks on a rotation record and a visual record; `run` with
  the default `--device cuda` raising where CUDA is absent; a toolbox
  built with `with_diffusion=False` builds no IP2P UNet.
"""

import contextlib
import dataclasses
import functools
import io
import json

import numpy as np
import pytest
import torch

from anyedit_tpu import cli as jcli
from anyedit_tpu.core import config as jconfig
from anyedit_tpu.runtime import zoo as jzoo
from anyedit_tpu_torch import cli
from anyedit_tpu_torch.core import config as pconfig
from anyedit_tpu_torch.core.png import read_png, write_png
from anyedit_tpu_torch.runtime import executor as pexec
from anyedit_tpu_torch.runtime import zoo as pzoo

torch.set_num_threads(1)
RECORDS = [
    {"edit": "make it warm", "input": "a photo of a dog", "output": "a warm photo of a dog",
     "edit_type": "tone_transfer", "image_file": "a.png"},
    {"edit": "remove the dog", "input": "a photo of a dog", "output": "a photo",
     "edit_type": "remove", "image_file": "b.png", "edited object": "dog"},
]
CAPTIONS = ["a red car parked next to a small house", "two dogs playing on the grass",
            "a cat sitting on a wooden chair"]


# ---- config and the slot table ------------------------------------------------

def test_factory_config_equals_jax(tmp_path):
    assert pconfig.to_dict(pconfig.FactoryConfig()) == jconfig.to_dict(jconfig.FactoryConfig())
    assert pconfig.TASK_PRESETS == jconfig.TASK_PRESETS
    for t in list(jconfig.TASK_PRESETS) + ["remove"]:
        got = pconfig.task_config(t, batch_size=3, seed=7)
        ref = jconfig.task_config(t, batch_size=3, seed=7)
        assert pconfig.to_dict(got) == jconfig.to_dict(ref), t
    for cls in ("FactoryConfig", "IOConfig"):
        bad = {"io": {"nope": 1}} if cls == "FactoryConfig" else {"nope": 1}
        with pytest.raises(KeyError) as e_p:
            pconfig.from_dict(getattr(pconfig, cls), bad)
        with pytest.raises(KeyError) as e_j:
            jconfig.from_dict(getattr(jconfig, cls), bad)
        assert str(e_p.value) == str(e_j.value)
    f = tmp_path / "cfg.json"
    f.write_text(json.dumps({"canvas": {"edit_size": 256}, "batch_size": 2}))
    got = pconfig.override(pconfig.load(pconfig.FactoryConfig, f, seed=3), batch_size=5)
    ref = jconfig.override(jconfig.load(jconfig.FactoryConfig, f, seed=3), batch_size=5)
    assert pconfig.to_dict(got) == jconfig.to_dict(ref)


def test_slots_for_edit_type_equal_jax():
    assert pzoo.SLOTS_FOR_EDIT_TYPE == jzoo.SLOTS_FOR_EDIT_TYPE
    assert list(pzoo.SLOTS_FOR_EDIT_TYPE) == list(jzoo.SLOTS_FOR_EDIT_TYPE)


def test_toolbox_without_diffusion_builds_no_unet():
    zoo = pzoo.ModelZoo(pzoo.tiny_zoo_config(), "cpu")
    tb = zoo.toolbox(with_diffusion=False)
    assert tb.ip2p is None and tb.ground is not None and tb.inpaint is not None
    assert not {"ip2p", "ip2p_core", "vae", "clip_text"} & set(zoo._cache)


# ---- run ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """The records and their PNGs; `run` through the CLI and the executor
    driven directly, each into its own output root."""
    root = tmp_path_factory.mktemp("run")
    rng = np.random.default_rng(0)
    (root / "img").mkdir()
    for name in ("a.png", "b.png"):
        write_png(root / "img" / name, rng.integers(0, 255, (48, 40, 3), dtype=np.uint8))
    (root / "recs.jsonl").write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    mp = pytest.MonkeyPatch()
    mp.setattr(pexec, "ExecutorConfig",
               functools.partial(pexec.ExecutorConfig, ip2p_steps_override=2))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(["run", "--instruction-json", str(root / "recs.jsonl"),
                             "--image-root", str(root / "img"), "--output", str(root / "cli"),
                             "--tiny", "--no-filters", "--device", "cpu"]) == 0
        zoo = pzoo.ModelZoo(pzoo.tiny_zoo_config(), "cpu")
        tb = zoo.toolbox(with_diffusion=True, slots=["clip", "aesthetic"])
        loaders = cli.record_loaders(root / "img", zoo.cfg.canvas.edit_size)
        from anyedit_tpu_torch.core.schema import read_records
        report = pexec.FactoryExecutor(tb, pexec.ExecutorConfig(
            output_root=str(root / "direct"), run_pre_filter=False, run_post_filter=False,
            grounding_batch=8)).run(read_records(root / "recs.jsonl"), loaders["load_image"])
    finally:
        mp.undo()
    return root, json.loads(out.getvalue()), report


def _ledger(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_run_matches_the_executor(run_dir):
    root, cli_report, report = run_dir
    got, ref = _ledger(root / "cli" / "ledger.jsonl"), _ledger(root / "direct" / "ledger.jsonl")
    assert [(g["key"], g["status"], g["record"]) for g in got] == \
        [(r["key"], r["status"], r["record"]) for r in ref]
    assert [g["status"] for g in got] == ["success", "failure"]
    assert got[1]["payload"] == ref[1]["payload"]
    assert np.array_equal(read_png(got[0]["payload"]["edited_file"]),
                          read_png(ref[0]["payload"]["edited_file"]))
    assert (root / "cli" / "edited_img" / "a.png").read_bytes() == \
        (root / "direct" / "edited_img" / "a.png").read_bytes()
    assert set(cli_report) == set(report) and set(cli_report["stages"]) == set(report["stages"])
    assert cli_report["counts"] == report["counts"]


def test_export_equals_jax(run_dir, tmp_path):
    from anyedit_tpu.core.ledger import RunLedger as JaxLedger
    root = run_dir[0]
    led = root / "cli" / "ledger.jsonl"
    assert cli.main(["export", "--ledger", str(led), "--output", str(tmp_path / "p")]) == 0
    jl = JaxLedger(led)
    jl.export_reference_files(tmp_path / "j", 0, None)
    jl.close()
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir()) and len(names) == 3
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_run_without_cuda_raises(run_dir, monkeypatch):
    root = run_dir[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--instruction-json", str(root / "recs.jsonl"), "--image-root",
                  str(root / "img"), "--output", str(root / "nocuda"), "--tiny"])


def test_loader_hooks(tmp_path):
    """load_visual reads visual_input under image_root, else falls back to
    the record's own image; load_rotation_pair reads extras["rotation"]
    (None without it); load_image gives a 127 canvas without image_file."""
    from anyedit_tpu_torch.core.schema import InstructionRecord
    rng = np.random.default_rng(1)
    imgs = {n: rng.integers(0, 255, (8, 6, 3), dtype=np.uint8) for n in ("s", "v", "fa", "fb")}
    for n, im in imgs.items():
        write_png(tmp_path / f"{n}.png", im)
    hooks = cli.record_loaders(tmp_path, 16)
    vis = InstructionRecord(edit="e", input="i", output="o", edit_type="visual_reference",
                            image_file="s.png", visual_input="v.png")
    assert np.array_equal(hooks["load_visual"](vis), imgs["v"])
    assert np.array_equal(hooks["load_visual"](dataclasses.replace(vis, visual_input="x.png")),
                          imgs["s"])
    rot = InstructionRecord(edit="e", input="i", output="o", edit_type="rotation_change",
                            image_file="s.png", extras={"rotation": {
                                "frame_a": "fa.png", "frame_b": "fb.png",
                                "q1": [1, 0, 0, 0], "q2": [0.5, 0.5, 0.5, 0.5]}})
    fa, fb, q1, q2 = hooks["load_rotation_pair"](rot)
    assert np.array_equal(fa, imgs["fa"]) and np.array_equal(fb, imgs["fb"])
    assert q1.dtype == np.float64 and q2.tolist() == [0.5, 0.5, 0.5, 0.5]
    assert hooks["load_rotation_pair"](dataclasses.replace(rot, extras={})) is None
    blank = hooks["load_image"](dataclasses.replace(rot, image_file=None))
    assert blank.shape == (16, 16, 3) and (blank == 127).all()


# ---- generate and convert ---------------------------------------------------------

@pytest.mark.parametrize("edit_type", ["color_alter", "counting"])
def test_generate_template_equals_jax(tmp_path, edit_type):
    caps = tmp_path / "caps.txt"
    caps.write_text("\n".join(CAPTIONS) + "\n")
    args = ["generate", "--captions", str(caps), "--edit-type", edit_type, "--seed", "3"]
    assert cli.main(args + ["--output", str(tmp_path / "p.jsonl")]) == 0
    assert jcli.main(args + ["--output", str(tmp_path / "j.jsonl")]) == 0
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert (tmp_path / "p.jsonl").read_text().strip()


def test_generate_llama_tiny_equals_jax(tmp_path, monkeypatch):
    """The tiny Llama in fp32 on both sides (the CLI's TINY_LLAMA is bf16,
    where greedy ids may part on a rounding), the JAX tree through
    `params`; 2 captions, batch 2, no self-check."""
    import jax.numpy as jnp

    from anyedit_tpu.instructions import generator as jgen
    from anyedit_tpu.instructions.generator import InstructionGenerator, LlamaBackend
    from anyedit_tpu.models import llama as jl
    from anyedit_tpu_torch.instructions import generator as pgen
    from anyedit_tpu_torch.models import llama as tl
    from test_torch_bridge import random_flax_params
    raw = {"port": [], "jax": []}
    for side, mod in (("port", pgen), ("jax", jgen)):      # the LLM's raw strings
        call = mod.LlamaBackend.__call__
        monkeypatch.setattr(mod.LlamaBackend, "__call__",
                            lambda self, prompts, call=call, side=side:
                            raw[side].append(call(self, prompts)) or raw[side][-1])
    jcfg = dataclasses.replace(jl.TINY_LLAMA, dtype=jnp.float32)
    monkeypatch.setattr(tl, "TINY_LLAMA", dataclasses.replace(tl.TINY_LLAMA,
                                                              dtype=torch.float32))
    tree = random_flax_params(jl.Llama(jcfg), (jnp.zeros((1, 8), jnp.int32),), 31)
    caps = tmp_path / "caps.txt"
    caps.write_text("\n".join(CAPTIONS[:2]) + "\n")
    assert cli.main(["generate", "--captions", str(caps), "--edit-type", "color_alter",
                     "--output", str(tmp_path / "p.jsonl"), "--backend", "llama", "--tiny",
                     "--batch-size", "2", "--no-self-check", "--device", "cpu"],
                    params={"llama": tree}) == 0
    v = jcfg.vocab_size
    llm = LlamaBackend(jl.Llama(jcfg), tree,
                       lambda s: [1 + (b % (v - 2)) for b in s.encode()][-1024:],
                       lambda ids: bytes((max(0, i - 1) % 256) for i in ids).decode(
                           "utf-8", "replace"), batch_size=2)
    ref = InstructionGenerator(llm=llm, seed=0, self_check=False, n_shots=5).generate(
        "color_alter", CAPTIONS[:2], batch_size=2)
    got = [json.loads(x) for x in (tmp_path / "p.jsonl").read_text().splitlines()]
    assert got == [r.to_json() for r in ref]
    assert raw["port"] == raw["jax"] and len(raw["port"][0]) == 2 and all(raw["port"][0])


def test_convert_list_names_equal_jax(capsys):
    from anyedit_tpu.weights.bootstrap import REGISTRY
    assert cli.main(["convert", "--list"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert names == sorted(REGISTRY)
