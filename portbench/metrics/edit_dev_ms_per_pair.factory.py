"""Device-event time of the program's outermost editor spans (`ip2p`, its
batch call), per pair."""

from portbench.harness import program_trace

NAME = "edit_dev_ms_per_pair.factory"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.dev_ms_per_unit(r, "editor")
