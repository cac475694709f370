"""K1's least time at the shapes it ran over its device time, in %."""

from portbench.harness.readers import k1_roofline_pct

NAME = "k1_roofline.factory"
UNIT = "%"
LAYER = "kernels"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.color_alter"]


def read(r):
    return k1_roofline_pct(r)
