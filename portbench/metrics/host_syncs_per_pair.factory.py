"""The program's `host_sync` counter over the traced window (each
synchronising copy or read of the device), per pair."""

from portbench.harness import program_trace

NAME = "host_syncs_per_pair.factory"
UNIT = "count"
LAYER = "device"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.count_per_unit(r, "host_sync")
