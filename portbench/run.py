"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Set-up (building, weights from the seed, warming every shape) is timed
as setup_s; then the window runs for `--seconds` and the cell's metrics are
taken: the end-to-end ones with `--trace 0`, the per-layer ones with
`--trace 1` (spans, kernel launches and the device trace). After the window
the program is freed and its outputs are compared with the plain reference.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), the readings, then
the numbers compared beside their limits ("compared"), which also end
standard error. Without CUDA, or with fewer cards than the cell asks for,
it exits 3 and prints no result; it also prints none, and exits 4, if a
module of the JAX stack or of the JAX package is loaded after set-up,
after the window or before the result."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT.parent) not in sys.path:
    sys.path.insert(0, str(ROOT.parent))

from portbench.harness import checks, guard, registry  # noqa: E402


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: object
    workdir: Path
    limits: dict

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def cache_dirs(checkout: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(checkout / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(checkout / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=60).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def _guard(stage: str) -> bool:
    bad = guard.loaded()
    if bad:
        print(f"run: {', '.join(bad)} loaded {stage}; no result", file=sys.stderr, flush=True)
    return not bad


def per_layer(cell: str, reading: dict) -> dict:
    out = {}
    for m in registry.metrics_for(ROOT, cell):
        v = m.read(reading)
        if v is not None:
            out[m.NAME] = {"value": v, "unit": m.UNIT}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = registry.load_cell(ROOT, args.workload)
    cache_dirs(ROOT.parent)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(cell.config, cell.traffic, args.seed, dev, Path(tmp), cell.limits)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        st = cell.driver.setup(ctx)
        ctx.sync()
        setup_s = time.perf_counter() - t0
        if not _guard("after set-up"):
            return 4
        res = cell.driver.window(st, args.seconds, bool(args.trace))
        if not _guard("after the window"):
            return 4
        peak = torch.cuda.max_memory_allocated(dev)
        if args.trace:
            metrics = per_layer(args.workload, res["reading"])
        else:
            metrics = {k: {"value": v, "unit": u} for k, (v, u) in res["end_to_end"].items()}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        cell.driver.release(st)
        readings = cell.driver.check(st)
    if not _guard("before the result"):
        return 4
    nums = checks.numbers(readings, cell.limits)
    correct = bool(nums) and len(nums) == len(cell.limits) and all(n.ok for n in nums)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit_w()}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = res["reading"]["trace"].busy_s()
        device["window_s"] = res["reading"]["trace"].window_s
        out["breakdown"] = res["breakdown"]
    out["readings"] = readings
    out["compared"] = {n.name: n.as_dict() for n in nums}
    for k, v in readings.items():
        if k not in cell.limits:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr)
    for n in nums:
        print(f"{n.name} {n.value!r} limit {n.limit!r} {'ok' if n.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
