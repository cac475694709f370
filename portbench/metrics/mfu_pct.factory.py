"""The editor's model FLOPs in the window (UNet rows x steps, VAE encode and
decode, CLIP text) over the window at the bf16 dense peak."""

from portbench.harness.readers import mfu_pct

NAME = "mfu_pct.factory"
UNIT = "%"
LAYER = "device"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return mfu_pct(r)
