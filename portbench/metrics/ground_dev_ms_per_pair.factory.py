"""Device-event time of the program's outermost grounding spans (`ground`,
its batch call), per pair."""

from portbench.harness import program_trace

NAME = "ground_dev_ms_per_pair.factory"
UNIT = "ms"
LAYER = "grounding"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.dev_ms_per_unit(r, "grounding")
