"""K2's least time at the shapes it ran over its device time, in %."""

from portbench.harness.readers import k2_roofline_pct

NAME = "k2_roofline.factory"
UNIT = "%"
LAYER = "kernels"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return k2_roofline_pct(r)
