"""Median device-event time of the program's `flux` spans (one Flux
transformer call at batch 1: 1,024 image and 256 text tokens in this
cell)."""

from portbench.harness import program_trace

NAME = "flux_ms_per_call.textual"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return program_trace.median_dev_ms(r, "flux")
