"""Device-event time of the program's outermost editor spans (`flux_pair`:
T5, CLIP-L's pooled text, 8 Flux calls and 2 Flux VAE decodes), per pair."""

from portbench.harness import program_trace

NAME = "edit_dev_ms_per_pair.textual"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return program_trace.dev_ms_per_unit(r, "editor")
