"""The card's idle time in the traced window while the program's innermost
open span (main thread) was of layer grounding, per pair."""

from portbench.harness import program_trace

NAME = "ground_idle_ms_per_pair.factory"
UNIT = "ms"
LAYER = "grounding"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return program_trace.idle_ms_per_unit(r, "grounding")
