"""Device-event time of the program's `t5` spans (the T5-XXL encode of each
caption, two a pair), per pair."""

from portbench.harness import program_trace

NAME = "t5_ms_per_pair.textual"
UNIT = "ms"
LAYER = "editor"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    recs = program_trace.records(r)
    ms = [x.device_ms for x in recs or () if x.name == "t5" and x.device_ms is not None]
    if not ms or not r["units"]:
        return None
    return sum(ms) / r["units"]
