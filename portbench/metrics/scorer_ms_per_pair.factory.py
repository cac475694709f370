"""Time in the scorers' spans (CLIP image and text, the aesthetic MLP, the
BLIP-2 VQA gate), per pair."""

from portbench.harness.readers import ms_per_unit

NAME = "scorer_ms_per_pair.factory"
UNIT = "ms"
LAYER = "scorers"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return ms_per_unit(r, "scorers")
