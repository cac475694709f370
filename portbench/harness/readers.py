"""What the per-layer metric files read from a traced window's `reading`:
{"spans", "trace", "k1_shapes", "k2_shapes", "window_s", "units" (pairs),
"model_flops", "span_groups" (layer -> span names)}. Each returns None
where it finds nothing to read, and the run then leaves the metric out."""

from __future__ import annotations

from portbench.harness import roofline


def ms_per_unit(r: dict, layer: str):
    """Milliseconds a unit in the spans of `layer`."""
    names = r["span_groups"].get(layer)
    if not names or not r["units"]:
        return None
    if not any(n in names for n, *_ in r["spans"].records):
        return None
    return r["spans"].total_s(names) * 1e3 / r["units"]


def outside_ms_per_unit(r: dict):
    """Milliseconds a unit of window time outside every span."""
    if not r["units"]:
        return None
    return (r["window_s"] - r["spans"].total_s()) * 1e3 / r["units"]


def k1_roofline_pct(r: dict):
    bounds = [roofline.k1_bound_s(*s) for s in r["k1_shapes"]]
    return roofline.share_pct(bounds, r["trace"].named("flash_nomax_kernel"))


def k2_roofline_pct(r: dict):
    bounds = [roofline.k2_bound_s(n, c, hw, eb, silu) for n, c, hw, eb, silu in r["k2_shapes"]]
    return roofline.share_pct(bounds, r["trace"].named("group_norm_kernel"))


def idle_pct(r: dict):
    tr = r["trace"]
    if not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_pct(r: dict):
    if not r["model_flops"]:
        return None
    return 100.0 * r["model_flops"] / (r["window_s"] * roofline.PEAK_BF16)
