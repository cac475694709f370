"""Spans and the device trace of a `--trace 1` run.

`Spans` wraps the program's layer entries (the toolbox's slots) from the
benchmark's side. Each span synchronises the device at both
ends, so a span holds the device work it queued, and records (name, start
ns, end ns, info) on the host's clock (`time.time_ns`, the clock the
profiler stamps its events with). The spies record the shapes of the hand
kernels' launches (K1 `flash_nomax`, K2 the group-norm launch) by wrapping
the wrappers the program calls them through, so that the rooflines read
the work at the shapes that ran.

`DeviceTrace` runs `torch.profiler` with CUDA activity only (host events
make a host-bound run much longer) and reduces its device events to the
busy time (the union of their intervals), the operations by total time,
and the idle gaps labelled by the span the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, sync=None):
        self.sync = sync or (torch.cuda.synchronize if torch.cuda.is_available()
                             else (lambda: None))
        self.records: list[tuple[str, int, int, dict]] = []

    @contextlib.contextmanager
    def span(self, name: str, **info):
        self.sync()
        t0 = time.time_ns()
        try:
            yield info
        finally:
            self.sync()
            self.records.append((name, t0, time.time_ns(), info))

    def wrap(self, fn, name: str, info=None):
        """fn wrapped in a span; its `.batch` (if any) wrapped too, under
        `name`. `info(args, kwargs)` gives the span's info."""
        if fn is None:
            return None

        def call(*a, **k):
            with self.span(name, **(info(a, k) if info else {})):
                return fn(*a, **k)
        batch = getattr(fn, "batch", None)
        if batch is not None:
            def call_batch(*a, **k):
                with self.span(name, **(info(a, k) if info else {})):
                    return batch(*a, **k)
            call.batch = call_batch
        return call

    def total_s(self, names=None) -> float:
        return sum(t1 - t0 for n, t0, t1, _ in self.records
                   if names is None or n in names) / 1e9

    def label_at(self, t_ns: int, default: str) -> str:
        for n, t0, t1, _ in self.records:
            if t0 <= t_ns <= t1:
                return n
        return default


class LaunchSpy:
    """Replaces `module.<attr>` (a kernel wrapper that counts its launches in
    `.launches`) with a wrapper that records `shape_of(args)` per call."""

    def __init__(self, module, attr: str, shape_of):
        self.module, self.attr, self.shape_of = module, attr, shape_of
        self.shapes: list = []
        self.real = getattr(module, attr)

    def __enter__(self):
        real, shapes, shape_of = self.real, self.shapes, self.shape_of

        def spy(*a, **k):
            shapes.append(shape_of(*a, **k))
            return real(*a, **k)
        spy.launches = getattr(real, "launches", 0)
        self.spy = spy
        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)
        if hasattr(self.real, "launches"):
            self.real.launches = self.spy.launches
        return False


class DeviceTrace:
    """`with DeviceTrace() as tr: ...` over the traced window; then
    `tr.kernels` is [(name, start_ns, end_ns)] of every device event."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        from torch.autograd import DeviceType
        ev = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                ev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        ev.sort(key=lambda x: x[1])
        self.kernels = ev
        return False

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        busy, end = 0, None
        for _, s, e in self.kernels:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def named(self, substring: str) -> list[float]:
        """Durations (s) of the events whose name holds `substring`, in order."""
        return [(e - s) / 1e9 for n, s, e in self.kernels if substring in n]

    def breakdown(self, spans: Spans, default: str) -> dict:
        """The 10 device operations with most time, and the 10 longest idle
        gaps labelled by the span the host was in at the gap's middle."""
        by = defaultdict(int)
        for n, s, e in self.kernels:
            by[n[:160]] += e - s
        ops = sorted(by.items(), key=lambda x: -x[1])[:10]
        gaps, end = [], self.t0
        for _, s, e in self.kernels:
            if s > end:
                gaps.append((s - end, (s + end) // 2))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((self.t1 - end, (self.t1 + end) // 2))
        gaps.sort(key=lambda x: -x[0])
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[spans.label_at(mid, default), ns / 1e9]
                              for ns, mid in gaps[:10]]}


def _k1_shape(q, k, v, scale):
    return tuple(q.shape)


def _k2_shape(x, scale, bias, num_groups, eps, silu):
    n, c = x.shape[:2]
    return (n, c, x.numel() // (n * c), x.element_size(), bool(silu))


@contextlib.contextmanager
def traced(on: bool):
    """(DeviceTrace, K1 spy, K2 spy) over the block where `on`, else Nones."""
    if not on:
        yield None, None, None
        return
    import anyedit_tpu_torch.ops.attention as attn_mod
    import anyedit_tpu_torch.ops.groupnorm as gn_mod
    with DeviceTrace() as dt, LaunchSpy(attn_mod, "flash_nomax", _k1_shape) as k1, \
            LaunchSpy(gn_mod, "_group_norm_launch", _k2_shape) as k2:
        yield dt, k1, k2
