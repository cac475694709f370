"""Time in the IP2P editor's spans (`tb.ip2p` and `.batch`), per pair."""

from portbench.harness.readers import ms_per_unit

NAME = "edit_ms_per_pair.factory"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return ms_per_unit(r, "editor")
