"""The pairs' model FLOPs in the window (8 Flux calls, 2 T5 and 2 CLIP-L
encodes, 2 Flux VAE decodes a pair; `harness/flux_flops.py`) over the
window at the bf16 dense peak."""

from portbench.harness.readers import mfu_pct

NAME = "mfu_pct.textual"
UNIT = "%"
LAYER = "device"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return mfu_pct(r)
