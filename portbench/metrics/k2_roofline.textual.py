"""K2's least time at the shapes it ran (the Flux VAE decoder's norms) over
its device time, in %."""

from portbench.harness.readers import k2_roofline_pct

NAME = "k2_roofline.textual"
UNIT = "%"
LAYER = "kernels"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]


def read(r):
    return k2_roofline_pct(r)
