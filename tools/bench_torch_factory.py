"""Factory-level benchmark of the PyTorch port on one NVIDIA GPU: a twin of
`tools/bench_factory.py --prod`.

    python3 tools/bench_torch_factory.py [n_records] [steps] [--int8] [--rounds R]

Streams n synthetic 512 px records (default 8), alternating `color_alter`
and `remove`, through the real `FactoryExecutor` with every scorer the JAX
bench installs (CLIP-L towers, the aesthetic MLP), at the production
grounding shapes: GroundingDINO SwinB at 800 px with 900 queries, SAM ViT-H
at 1024, `box_threshold=0.25`. The edits run at `steps` DDIM steps (default
50, forced through the pipelines' own 100); `--int8` makes the IP2P UNet
W8A8 (and the SD inpainter, unused here). Weights are seeded and random.

As in the JAX bench, both gates are forced open (the decision functions
patched to True) so that every record takes the whole compute path while
the scorers run for real, and the grounder keeps its real compute but
answers as real weights would: on a source image, the detection, or a
synthetic box and mask where the random detector keeps none; on any other
image (the removal check, the post-filter's existence check), None.

Each type group runs per record (one executor and one `run()` per record)
and in chunk mode (one executor, `grounding_batch` = the group size,
`ip2p_steps_override` = steps, each record its own copy of the image, as
the executor's caches key on identity), each after a warm-up, and the two
modes alternate for `--rounds` rounds (default 2) within the call. It
prints a JSON line per group and pass, then one line with records/hour per
type and mode (each round's and their median), the `StageTimer` breakdown,
the full-path rate (only groups without a failure, as the JAX bench's
`full_path_records_per_hour_chip`) beside the blended rate, the peak
`torch.cuda.max_memory_allocated`, and the card's name and power limit. It
writes no file. It exits non-zero when a chunk pass's report lacks
`ground_batch` or `clip_batch`, or `edit_batch` for a group whose type
makes an unmasked IP2P edit: such a pass would re-measure the per-record
path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch_ip2p import card  # noqa: E402  (tools/, just put on the path)
from chip_smoke import gates_open, ground_as_real_weights  # noqa: E402  (the repo root)

TYPES = ("color_alter", "remove")
SIZE = 512


def records(n: int):
    from anyedit_tpu_torch.core.schema import InstructionRecord
    out = []
    for i in range(n):
        et = TYPES[i % 2]
        out.append(InstructionRecord(
            edit="make the square red" if et == "color_alter" else "remove the square",
            input="a square on a plain background", output="a plain background",
            edit_type=et, edited_object="square", image_file=f"synthetic_{i}.png"))
    return out


def bench_toolbox(zoo, steps: int):
    """The zoo's toolbox with the JAX bench's grounding answers
    (`chip_smoke.ground_as_real_weights`) and the forced step count (each
    wrapper keeps its `.batch`). Returns (toolbox, source_ids): the ids of
    the images that count as sources."""
    tb = zoo.toolbox(slots=("clip", "aesthetic"))
    source_ids = ground_as_real_weights(tb, zoo.device)
    real_ip2p = tb.ip2p

    def ip2p(*a, **k):
        return real_ip2p(*a, **{**k, "steps": steps})
    ip2p.batch = real_ip2p.batch
    tb.ip2p = ip2p
    return tb, source_ids


def _stages(report: dict, into: dict) -> None:
    for k, v in report["stages"].items():
        s = into.setdefault(k, {"calls": 0, "total_s": 0.0})
        s["calls"] += v["count"]
        s["total_s"] += v["total_s"]


def per_record_pass(tb, group, load, root: str, sync) -> dict:
    """One executor and one run() per record; seconds summed over records."""
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor
    seconds, counts, stages = 0.0, {}, {}
    for j, rec in enumerate(group):
        ex = FactoryExecutor(tb, ExecutorConfig(output_root=f"{root}/{j}", save_images=False))
        sync()
        t0 = time.perf_counter()
        rep = ex.run([rec], load)
        sync()
        seconds += time.perf_counter() - t0
        for k, v in rep["counts"].items():
            counts[k] = counts.get(k, 0) + v
        _stages(rep, stages)
    return {"seconds": seconds, "counts": counts, "stages": stages}


def chunk_pass(tb, group, imgs: dict, root: str, steps: int, sync) -> dict:
    """One executor over the group in one chunk."""
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor
    ex = FactoryExecutor(tb, ExecutorConfig(output_root=root, save_images=False,
                                            grounding_batch=len(group),
                                            ip2p_steps_override=steps))
    sync()
    t0 = time.perf_counter()
    rep = ex.run(group, lambda r: imgs[r.key()])
    sync()
    stages = {}
    _stages(rep, stages)
    return {"seconds": time.perf_counter() - t0, "counts": rep["counts"], "stages": stages}


def run(zoo, n: int, steps: int, rounds: int, sync=lambda: None) -> dict:
    """The whole bench on `zoo` (any device; `sync` waits for it). Returns
    the result dict; `missing_batch_stages` lists the chunk passes that
    missed a batch stage."""
    import numpy as np
    import anyedit_tpu_torch.runtime.executor as executor_mod

    tb, source_ids = bench_toolbox(zoo, steps)
    img = np.random.default_rng(0).integers(0, 255, (SIZE, SIZE, 3), np.uint8)
    source_ids.add(id(img))
    by_type: dict[str, list] = {}
    for r in records(n):
        by_type.setdefault(r.edit_type, []).append(r)
    result = {mode: {et: {"records": len(g), "seconds": [], "records_per_hour": [],
                          "counts": [], "stages": []} for et, g in by_type.items()}
              for mode in ("per_record", "chunk")}
    missing = []
    # gates forced open: random weights fail the semantic thresholds; the
    # scorers still run (that is the compute)
    with tempfile.TemporaryDirectory() as root, gates_open():
        copies = {}
        for et, group in by_type.items():        # warm-ups, not timed
            copies[et] = {r.key(): img.copy() for r in group}
            source_ids.update(id(v) for v in copies[et].values())
            per_record_pass(tb, group[:1], lambda r: img, f"{root}/w_{et}", sync)
            chunk_pass(tb, group, copies[et], f"{root}/wb_{et}", steps, sync)
        for rnd in range(rounds):
            for mode in ("per_record", "chunk"):
                for et, group in by_type.items():
                    out = f"{root}/{mode}_{et}_{rnd}"
                    res = per_record_pass(tb, group, lambda r: img, out, sync) \
                        if mode == "per_record" else \
                        chunk_pass(tb, group, copies[et], out, steps, sync)
                    want = {"ground_batch", "clip_batch"} | (
                        {"edit_batch"} if et in executor_mod._IP2P_EDIT else set())
                    if mode == "chunk" and not want <= set(res["stages"]):
                        missing.append((et, rnd, sorted(want - set(res["stages"]))))
                    row = result[mode][et]
                    row["seconds"].append(res["seconds"])
                    row["records_per_hour"].append(len(group) / res["seconds"] * 3600)
                    row["counts"].append(res["counts"])
                    row["stages"].append(res["stages"])
                    print(json.dumps({"partial": mode, "edit_type": et, "round": rnd,
                                      "records": len(group), **res}), flush=True)
    for mode in ("per_record", "chunk"):
        rows = result[mode]
        for row in rows.values():
            row["median_records_per_hour"] = statistics.median(row["records_per_hour"])
        full = [r for r in rows.values() if all(c.get("failure", 0) == 0 for c in r["counts"])]
        for name, part in (("full_path", full), ("blended", list(rows.values()))):
            secs = sum(sum(r["seconds"]) for r in part)
            recs = sum(r["records"] * len(r["seconds"]) for r in part)
            result[f"{mode}_{name}_records_per_hour"] = recs / secs * 3600 if secs else None
    result["missing_batch_stages"] = missing
    return result


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="records (default 8)")
    ap.add_argument("steps", nargs="?", type=int, default=50, help="DDIM steps (default 50)")
    ap.add_argument("--int8", action="store_true", help="the W8A8 UNets")
    ap.add_argument("--rounds", type=int, default=2,
                    help="alternating per-record / chunk rounds (default 2)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_factory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    cfg = ZooConfig(box_threshold=0.25)
    if args.int8:
        cfg = dataclasses.replace(cfg, quant_ip2p=True, quant_diffusion=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zoo = ModelZoo(cfg, "cuda", seed=0)
    result = run(zoo, args.n, args.steps, args.rounds, torch.cuda.synchronize)
    result.update({"records": args.n, "steps": args.steps,
                   "mode": "int8" if args.int8 else "bf16", "card": card(),
                   "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "wall_s": time.perf_counter() - t0,
                   "note": "GDINO SwinB 900q@800px, SAM ViT-H@1024, box_threshold 0.25; "
                           f"ip2p at {args.steps} DDIM steps; gates forced open; "
                           "full_path rates count only groups without a failure"})
    print(json.dumps(result), flush=True)
    if result["missing_batch_stages"]:
        print(f"bench_torch_factory: chunk passes without their batch stages: "
              f"{result['missing_batch_stages']}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
