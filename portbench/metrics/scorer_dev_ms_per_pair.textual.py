"""Device-event time of the program's outermost scorer spans (`clip_image`,
`clip_text`, `aesthetic`), per pair."""

from portbench.harness import program_trace

NAME = "scorer_dev_ms_per_pair.textual"
UNIT = "ms"
LAYER = "scorers"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return program_trace.dev_ms_per_unit(r, "scorers")
