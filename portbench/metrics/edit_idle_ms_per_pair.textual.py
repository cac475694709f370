"""The card's idle time in the traced window while the program's innermost
open span (main thread) was of layer editor, per pair."""

from portbench.harness import program_trace

NAME = "edit_idle_ms_per_pair.textual"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return program_trace.idle_ms_per_unit(r, "editor")
