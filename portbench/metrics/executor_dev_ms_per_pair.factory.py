"""The traced window less the device-event time of the program's outermost
grounding, editor and scorer spans, per pair."""

from portbench.harness import program_trace

NAME = "executor_dev_ms_per_pair.factory"
UNIT = "ms"
LAYER = "executor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.rest_dev_ms_per_unit(r, ("grounding", "editor", "scorers"))
