"""Host time of the program's `load_wait` spans (the executor waiting on its
loader thread), per pair."""

from portbench.harness import program_trace

NAME = "load_wait_ms_per_pair.factory"
UNIT = "ms"
LAYER = "executor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.host_ms_per_unit(r, "load_wait")
