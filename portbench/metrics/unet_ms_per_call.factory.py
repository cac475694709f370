"""Median device-event time of the program's `unet` spans (one UNet call of
the batched edit, 12 rows in this cell)."""

from portbench.harness import program_trace

NAME = "unet_ms_per_call.factory"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.median_dev_ms(r, "unet")
