"""The harness on the CPU: finding cells, configurations and metrics by
name, BENCHMARK.json against the files, a cell added by files alone, the
statistics, the yardstick's arithmetic, the import guard, and run.py's
refusal without a card."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import guard, readers, registry, roofline, stats
from portbench.harness import flops
from portbench.tests import tiny

BENCH = tiny.BENCH
REPO = BENCH.parent


def test_finds_cell_config_traffic_and_metrics_by_name():
    cell = registry.load_cell(BENCH, "factory.color_alter")
    assert cell.config_name == "factory-sd15" and cell.traffic_name == "color_alter"
    assert cell.config["edit_batch_bucket"] == 4 and cell.traffic["chunk"] == 8
    assert cell.chips == 1 and cell.limits == {"pair_share_over_4": 0.05}
    assert hasattr(cell.driver, "setup") and hasattr(cell.driver, "check")
    names = {m.NAME for m in registry.metrics_for(BENCH, "factory.color_alter")}
    assert "k1_roofline.factory" in names and "mfu_pct.factory" in names
    assert registry.metrics_for(BENCH, "no.such.cell") == []
    with pytest.raises(KeyError):
        registry.load_cell(BENCH, "no.such.cell")


def test_benchmark_json_matches_the_files():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        f = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (REPO / configs[w["config"]]["file"]).is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    files = {m.NAME: m for m in registry.all_metrics(BENCH)}
    assert set(files) == {m["name"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        f = files[m["name"]]
        assert (f.UNIT, f.LAYER, f.MOVES, f.WORKLOADS) == \
            (m["unit"], m["layer"], m["moves"], m["workloads"])
    assert {m["name"] for m in b["end_to_end"]} == {"pairs_per_hour", "setup_s"}


def test_the_configuration_states_the_programs_production_towers():
    """Every tower the zoo builds besides the editor is written out in the
    configuration, and the driver refuses a program whose tower differs."""
    import dataclasses
    from anyedit_tpu_torch.runtime import zoo
    cell = registry.load_cell(BENCH, "factory.color_alter")
    zc = cell.driver.zoo_config(cell.config)
    assert (zc.ip2p_unet, zc.vae, zc.text, zc.canvas) == (zoo.ZooConfig().ip2p_unet,
                                                         zoo.ZooConfig().vae,
                                                         zoo.ZooConfig().text,
                                                         zoo.ZooConfig().canvas)
    assert set(cell.config["towers"]) == {"gdino", "sam", "vision", "eva", "qformer"}
    assert cell.config["towers"]["sam"]["enc_dim"] == 1280
    assert cell.config["towers"]["qformer"]["lm"]["dim"] == 2048
    cfg = json.loads(json.dumps(cell.config))
    cfg["towers"]["gdino"]["swin"]["depths"][2] = 6
    with pytest.raises(ValueError, match="gdino"):
        cell.driver.zoo_config(cfg)
    with pytest.raises(ValueError, match="served in"):
        cell.driver.widths(dataclasses.replace(zoo.ZooConfig().sam, dtype=torch.float32),
                           torch.bfloat16)


def test_a_cell_added_by_files_alone_runs(tmp_path):
    """A throwaway cell, configuration, traffic and per-layer metric added
    to a copy as new files, found by name and run on the CPU."""
    root = tiny.tiny_copy(tmp_path)
    cfg = json.loads((root / "configs/factory-sd15.json").read_text())
    (root / "configs/factory-throwaway.json").write_text(json.dumps(
        {**cfg, "edit_batch_bucket": 2}))
    tr = json.loads((root / "traffic/color_alter.json").read_text())
    (root / "traffic/throwaway_mix.json").write_text(json.dumps(
        {**tr, "chunk": 4, "edit_template": "turn the {object} {color}"}))
    (root / "workloads/factory.throwaway.json").write_text(json.dumps(
        {"config": "factory-throwaway", "traffic": "throwaway_mix", "driver": "factory",
         "chips": 1, "why": "a throwaway", "limits": {"pair_share_over_4": 0.05}}))
    (root / "metrics/throwaway_pairs.factory.py").write_text(
        'NAME = "throwaway_pairs.factory"\nUNIT = "pairs"\nLAYER = "executor"\n'
        'MOVES = "pairs_per_hour"\nWORKLOADS = ["factory.throwaway"]\n\n\n'
        'def read(r):\n    return float(r["units"])\n')
    assert [m.NAME for m in registry.metrics_for(root, "factory.throwaway")] == \
        ["throwaway_pairs.factory"]
    res, readings, nums = tiny.drive(root, "factory.throwaway", seed=7)
    assert res["attempted"] == 4 and set(res["end_to_end"]) == {"pairs_per_hour"}
    assert [n.name for n in nums] == ["pair_share_over_4"] and all(n.ok for n in nums), readings


def test_rate_over_whole_chunks():
    # 3 chunks of 8, 23 marked success, over a 61.5 s window
    assert stats.rate_per_hour(23, 61.5) == pytest.approx(23 * 3600 / 61.5)
    assert stats.rate_per_hour(32, 60.0) == pytest.approx(1920.0)


def test_roofline_bounds_by_hand():
    rate = 16 * 132 * 1.98e9
    # K1 at (24, 4096, 40): 24 x 4096^2 exps / rate = 0.0963 ms, above the
    # 4 x 24 x 4096^2 x 40 / 989e12 = 0.0651 ms of MMAs and 31 us of bytes
    assert roofline.k1_bound_s(24, 4096, 40, rate) == pytest.approx(24 * 4096 ** 2 / rate)
    assert roofline.k1_bound_s(24, 4096, 40, rate) * 1e3 == pytest.approx(0.0963, abs=5e-5)
    # K1 at (24, 1024, 80): the MMAs bind: 4 x 24 x 1024^2 x 80 / 989e12
    assert roofline.k1_bound_s(24, 1024, 80, rate) == pytest.approx(
        4 * 24 * 1024 ** 2 * 80 / 989e12)
    # K2 at (3, 320, 64 x 64) bf16 + SiLU: bytes bind, 2 x numel x 2 + 2 x 320 x 4
    n = 3 * 320 * 4096
    assert roofline.k2_bound_s(3, 320, 4096, 2, True, rate) == pytest.approx(
        (4 * n + 2560) / 3.35e12)
    assert roofline.share_pct([1.0, 2.0], [4.0, 8.0]) == pytest.approx(25.0)
    assert roofline.share_pct([1.0], [1.0, 2.0]) is None
    assert roofline.share_pct([], []) is None


def test_flops_by_hand():
    # CLIP text: a layer a row is 4 projections (2 L d^2 each), the MLP
    # (2 x 2 L d 4d) and attention (2 L^2 d for QK^T, as much for PV)
    d, L, layers, rows = 32, 16, 2, 3
    text = {"vocab_size": 100, "hidden": d, "layers": layers, "heads": 2, "max_len": L}
    assert flops.count("clip_text", text, rows) == rows * layers * (24 * L * d * d + 4 * L * L * d)
    # the VAE's mid attention alone is not separable, so check the UNet's
    # linearity in rows instead
    u, v = tiny.TINY_UNET, tiny.TINY_VAE
    assert flops.count("unet", u, 6, 8, 8, 5) == 2 * flops.count("unet", u, 3, 8, 8, 5)
    # an edit of n records: 3n UNet rows a step at the latent size, n VAE
    # encodes and decodes at the canvas, n + 1 prompts through CLIP text
    cfg = {"unet": u, "vae": v, "clip_text": text, "canvas": {"edit_size": 16, "latent_down": 2}}
    assert flops.ip2p_edit_flops(cfg, 2, 5) == (
        5 * flops.count("unet", u, 6, 8, 8, L) + flops.count("vae", v, 2, 16, "encode")
        + flops.count("vae", v, 2, 16, "decode") + flops.count("clip_text", text, 3))


def test_readers_find_nothing_and_say_so():
    class Spans:
        records = []

        def total_s(self, names=None):
            return 0.0
    r = {"spans": Spans(), "units": 0, "span_groups": {"editor": ("ip2p",)},
         "k1_shapes": [], "trace": None, "model_flops": 0, "window_s": 1.0}
    assert readers.ms_per_unit(r, "editor") is None
    assert readers.outside_ms_per_unit(r) is None
    assert readers.mfu_pct(r) is None


def test_import_guard_names():
    assert guard.loaded(["jax.numpy", "numpy", "anyedit_tpu_torch.cli"]) == ["jax"]
    assert guard.loaded(["anyedit_tpu.ops", "flax", "jaxlib.xla"]) == \
        ["anyedit_tpu", "flax", "jaxlib"]
    assert guard.loaded(["anyedit_tpu_torch", "jaxtyping", "portbench"]) == []


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program_or_jax():
    for p in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(p) & {"anyedit_tpu_torch", "anyedit_tpu", "jax", "jaxlib", "flax"}, p


def test_the_program_the_drivers_use_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.harness import registry, guard\n"
            "from pathlib import Path\n"
            "cell = registry.load_cell(Path(%r), 'factory.color_alter')\n"
            "cell.driver.zoo_config(cell.config)\n"
            "import anyedit_tpu_torch.cli, anyedit_tpu_torch.runtime.zoo, "
            "anyedit_tpu_torch.runtime.executor, anyedit_tpu_torch.ops.quant\n"
            "print(guard.loaded())\n") % (str(REPO), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd: Path, *args, timeout=300):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(REPO, "--workload", "factory.color_alter", "--seed", "2147483700", "--seconds",
               "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_run_in_a_directory_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, "--workload", "factory.color_alter", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_run_on_the_card_prints_a_correct_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(REPO, "--workload", "factory.color_alter", "--seed", "2147483701", "--seconds",
               "5", "--trace", "0", timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"pairs_per_hour", "setup_s"}
    assert list(res)[-1] == "compared" and set(res["compared"]) == {"pair_share_over_4"}


def test_device_trace_reduction_by_hand():
    from portbench.harness.trace import DeviceTrace, Spans
    tr = DeviceTrace()
    tr.t0, tr.t1 = 0, 100
    # overlapping kernels 10-30 and 20-40, then 60-70: busy 40, idle gaps
    # 0-10, 40-60 and 70-100
    tr.kernels = [("a", 10, 30), ("b", 20, 40), ("a", 60, 70)]
    assert tr.busy_s() == pytest.approx(40e-9)
    assert tr.named("a") == [pytest.approx(20e-9), pytest.approx(10e-9)]
    sp = Spans(sync=lambda: None)
    sp.records = [("ground", 45, 55, {})]
    bd = tr.breakdown(sp, "executor")
    assert bd["device_ops"][0] == ["a", pytest.approx(30e-9)]
    assert bd["idle_gaps"] == [["executor", pytest.approx(30e-9)],
                               ["ground", pytest.approx(20e-9)],
                               ["executor", pytest.approx(10e-9)]]
