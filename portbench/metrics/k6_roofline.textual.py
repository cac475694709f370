"""K6's least time at the shapes it ran over its device time, in %.

The least time is summed over the window's `flux` spans: each span's `k6`
launches (the program's count of one Flux call's K6 launches, which holds
while the call replays from a CUDA graph, where no wrapper runs) times
`k1_bound_s(heads x rows, tokens, head dim)`, the bound of one unmasked
self-attention over the joint sequence at the configuration's heads and
head dim. The device time is that of the kernels named `flash_sdpa_kernel`
in the trace. None where no span records a K6 launch (a program without
K6, or without the attribute), and where the kernels in the trace are not
as many as the launches the spans record."""

import json
from pathlib import Path

from portbench.harness import program_trace, roofline

NAME = "k6_roofline.textual"
UNIT = "%"
LAYER = "kernels"
MOVES = "pairs_per_hour"
WORKLOADS = ["factory.textual_change"]
KERNEL = "flash_sdpa_kernel"
_FLUX = json.loads((Path(__file__).resolve().parents[1] / "configs"
                    / "factory-flux-schnell.json").read_text())["flux"]


def read(r):
    heads, head_dim = _FLUX["heads"], _FLUX["dim"] // _FLUX["heads"]
    bounds = []
    for x in program_trace.records(r) or ():
        if x.name == "flux" and x.attrs.get("k6"):
            bound = roofline.k1_bound_s(heads * x.attrs["rows"], x.attrs["tokens"], head_dim)
            bounds += [bound] * x.attrs["k6"]
    if not bounds:
        return None
    return roofline.share_pct(bounds, r["trace"].named(KERNEL))
