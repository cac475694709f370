"""What the per-layer metrics read from the program's own tracer
(`anyedit_tpu_torch.core.trace`), which records while the traced window's
profiler (`DeviceTrace`) is open: span records (id, parent, name, layer,
thread, host start and end in `time.time_ns`, the device time between the
span's two CUDA events, counters) and nothing of the program's logic.

Records are kept where they lie inside the traced window (`reading["trace"]`
t0 .. t1). Each function returns None where the program has no tracer or
recorded nothing there (the parent of the change that added the tracer),
and the run then leaves the metric out.

The card's idle time (the window less the union of the device events, as
`DeviceTrace.busy_s` counts it) is split by what the main thread was doing:
at each instant, the layer of its innermost open span, or "executor" where
none is open. The four layers' shares add up to the idle time.
"""

from __future__ import annotations

import statistics
import threading

DEFAULT_LAYER = "executor"


def records(r: dict):
    """The program's span records inside the traced window, or None."""
    try:
        from anyedit_tpu_torch.core import trace
    except ImportError:
        return None
    tr = r["trace"]
    recs = [x for x in trace.records() if tr.t0 <= x.t0_ns and x.t1_ns <= tr.t1]
    return recs or None


def idle_gaps(kernels, t0: int, t1: int) -> list[tuple[int, int]]:
    """[(start, end)] ns of t0 .. t1 in which no device event ran."""
    gaps, end = [], t0
    for _, s, e in kernels:
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


def host_layers(recs, t0: int, t1: int, thread: int) -> list[tuple[int, int, str]]:
    """[(start, end, layer)] ns covering t0 .. t1: the layer of `thread`'s
    innermost open span at each instant, DEFAULT_LAYER where none is open."""
    bounds = []
    for x in recs:
        if x.thread == thread and x.t1_ns > x.t0_ns:
            bounds.append((x.t0_ns, 1, x))
            bounds.append((x.t1_ns, 0, x))   # at one instant, ends before starts
    bounds.sort(key=lambda b: (b[0], b[1], b[2].id if b[1] else -b[2].id))
    segs, stack, at = [], [], t0
    for t, is_start, x in bounds:
        t = min(max(t, t0), t1)
        if t > at:
            segs.append((at, t, stack[-1].layer if stack else DEFAULT_LAYER))
            at = t
        if is_start:
            stack.append(x)
        elif x in stack:
            stack.remove(x)
    if t1 > at:
        segs.append((at, t1, stack[-1].layer if stack else DEFAULT_LAYER))
    return segs


def idle_by_layer(r: dict):
    """layer -> idle seconds of the card while the main thread was in it."""
    recs = records(r)
    if recs is None:
        return None
    tr = r["trace"]
    gaps = idle_gaps(tr.kernels, tr.t0, tr.t1)
    out: dict[str, int] = {}
    g = 0
    for a, b, layer in host_layers(recs, tr.t0, tr.t1, threading.main_thread().ident):
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        k = g
        while k < len(gaps) and gaps[k][0] < b:
            out[layer] = out.get(layer, 0) + min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
    return {k: v / 1e9 for k, v in out.items()}


def idle_ms_per_unit(r: dict, layer: str):
    idle = idle_by_layer(r)
    if idle is None or not r["units"]:
        return None
    return idle.get(layer, 0.0) * 1e3 / r["units"]


def outermost(recs, layer: str) -> list:
    """The records of `layer` with no ancestor of `layer`."""
    by_id = {x.id: x for x in recs}
    out = []
    for x in recs:
        if x.layer != layer:
            continue
        p = by_id.get(x.parent)
        while p is not None and p.layer != layer:
            p = by_id.get(p.parent)
        if p is None:
            out.append(x)
    return out


def _device_s(recs, layer: str) -> float:
    return sum(x.device_ms or 0.0 for x in outermost(recs, layer)) / 1e3


def dev_ms_per_unit(r: dict, layer: str):
    """Device-event milliseconds a unit in the outermost spans of `layer`."""
    recs = records(r)
    if recs is None or not r["units"]:
        return None
    if not any(x.layer == layer and x.device_ms is not None for x in recs):
        return None
    return _device_s(recs, layer) * 1e3 / r["units"]


def rest_dev_ms_per_unit(r: dict, layers):
    """The traced window less the device time of `layers`' outermost spans,
    a unit."""
    recs = records(r)
    if recs is None or not r["units"]:
        return None
    if not any(x.device_ms is not None for x in recs):
        return None
    window_s = (r["trace"].t1 - r["trace"].t0) / 1e9
    return (window_s - sum(_device_s(recs, la) for la in layers)) * 1e3 / r["units"]


def median_dev_ms(r: dict, name: str):
    """Median device-event milliseconds of the spans named `name`."""
    recs = records(r)
    ms = [x.device_ms for x in recs or () if x.name == name and x.device_ms is not None]
    return statistics.median(ms) if ms else None


def count_per_unit(r: dict, counter: str):
    """A counter summed over the window's spans, a unit."""
    recs = records(r)
    if recs is None or not r["units"]:
        return None
    return sum(x.counts.get(counter, 0) for x in recs) / r["units"]


def host_ms_per_unit(r: dict, name: str):
    """Host milliseconds a unit in the spans named `name`."""
    recs = records(r)
    if recs is None or not r["units"]:
        return None
    return sum(x.t1_ns - x.t0_ns for x in recs if x.name == name) / 1e6 / r["units"]
