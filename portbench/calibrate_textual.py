"""Readings that the limits of the textual_change cell's `correct` are set
from: the program's sound runs and two controls, on several seeds in one
process.

    python3 portbench/calibrate_textual.py --seeds 11,12,... \
        [--w8a8-seeds 21,22] [--t5-77-seeds 31,32] [--out FILE]

Each seed runs one chunk through the cell's own path and samples its
records as a run does. The sound side and the T5 control build the toolbox
once and load each seed's weights and traffic into it; the W8A8 control
(the program's W8A8 Flux, the step below the stated bf16) builds it for
each seed, since its Flux is quantized at set-up. The T5 control runs the
program with T5 at 77 tokens (the context the configuration states cut
away). Once every chunk has run, the program is freed and each seed's
records are checked against the fp32 reference (T5 at the configuration's
length), as a run checks them. One JSON line a reading (with each checked
image's own, under "images"), with the seconds the chunk and the check
took; with `--out`, the lines also go to FILE. The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT.parent) not in sys.path:
    sys.path.insert(0, str(ROOT.parent))

from portbench import run  # noqa: E402
from portbench.harness import registry, synth_checks  # noqa: E402

CELL = "factory.textual_change"


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def chunks(cell, side: str, seeds, device, tmp: Path, emit) -> list:
    """(side, seed, ctx, root, records) of one chunk a seed."""
    d = cell.driver
    quant, t5_len = side == "control_w8a8", 77 if side == "control_t5_77" else None
    out, st = [], None
    for s in seeds:
        ctx = run.Context(cell.config, cell.traffic, s, device, tmp / f"{side}_{s}", cell.limits)
        if st is None or quant:
            t0 = time.perf_counter()
            st = d.setup(dataclasses.replace(ctx), quant=quant, t5_len=t5_len)
            emit({"side": side, "seed": s, "setup_s": time.perf_counter() - t0})
        else:
            d.reseed(st, s, ctx.workdir)
        t0 = time.perf_counter()
        res = d.window(st, 1e-3, False)
        out.append((side, s, ctx, st.window["root"], d.sampled(st),
                    res["attempted"] - res["failed"], time.perf_counter() - t0))
        if quant:
            d.release(st)
    if st is not None and not quant:
        d.release(st)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--w8a8-seeds", default="")
    ap.add_argument("--t5-77-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = registry.load_cell(ROOT, CELL)
    run.cache_dirs(ROOT.parent)
    import torch
    if not torch.cuda.is_available():
        print("calibrate_textual: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None

    def emit(row: dict) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    with tempfile.TemporaryDirectory(prefix="portbench-cal-") as tmp:
        done = []
        for side, seeds in (("program", args.seeds), ("control_t5_77", args.t5_77_seeds),
                            ("control_w8a8", args.w8a8_seeds)):
            done += chunks(cell, side, _seeds(seeds), device, Path(tmp), emit)
        for side, s, ctx, root, recs, success, chunk_s in done:
            t0 = time.perf_counter()
            got, want = cell.driver.sides(ctx, root, recs)
            emit({"side": side, "seed": s, "chunk_s": chunk_s,
                  "check_s": time.perf_counter() - t0, "success": success,
                  **synth_checks.synth_readings(got, want),
                  "images": [synth_checks.image_readings(p, r) for p, r in zip(got, want)]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
