"""Readings that the limits of `correct` are set from: the program's sound
runs and the control, on several seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23]

One chunk a seed through the cell's own path (the toolbox built once, the
weights and traffic of each seed loaded into it), its pairs checked against
the reference as a run checks them. The control is the program with its
W8A8 IP2P path switched on (ZooConfig.quant_ip2p), the step below the stated
bf16. One JSON line a reading, with the seconds the chunk and the check
took. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT.parent) not in sys.path:
    sys.path.insert(0, str(ROOT.parent))

from portbench import run  # noqa: E402
from portbench.harness import registry  # noqa: E402


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def factory(cell, seeds, control_seeds, device, tmp: Path) -> None:
    d = cell.driver
    for side, quant, ss in (("program", False, seeds), ("control_w8a8", True, control_seeds)):
        if not ss:
            continue
        ctx = run.Context(cell.config, cell.traffic, ss[0], device, tmp / f"{side}_0",
                          cell.limits)
        t0 = time.perf_counter()
        st = d.setup(ctx, quant=quant)
        _emit({"side": side, "setup_s": time.perf_counter() - t0})
        for s in ss:
            d.reseed(st, s, tmp / f"{side}_{s}", quant=quant)
            t0 = time.perf_counter()
            res = d.window(st, 1e-3, False)
            t1 = time.perf_counter()
            readings = d.check(st)
            _emit({"side": side, "seed": s, "chunk_s": t1 - t0,
                   "check_s": time.perf_counter() - t1,
                   "success": res["attempted"] - res["failed"], **readings})
        d.release(st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = registry.load_cell(ROOT, args.workload)
    run.cache_dirs(ROOT.parent)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    with tempfile.TemporaryDirectory(prefix="portbench-cal-") as tmp:
        factory(cell, seeds, controls, device, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
