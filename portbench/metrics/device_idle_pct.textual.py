"""Share of the traced window in which no operation ran on the device."""

from portbench.harness.readers import idle_pct

NAME = "device_idle_pct.textual"
UNIT = "%"
LAYER = "device"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return idle_pct(r)
