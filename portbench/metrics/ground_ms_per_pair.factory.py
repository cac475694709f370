"""Time in the grounder's spans (`tb.ground` and `.batch`: GroundingDINO, SAM),
per pair."""

from portbench.harness.readers import ms_per_unit

NAME = "ground_ms_per_pair.factory"
UNIT = "ms"
LAYER = "grounding"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return ms_per_unit(r, "grounding")
