"""The port's tracer: named spans at the program's layer boundaries, and
counters charged to the innermost open span.

`span(name, layer, key=None, **attrs)` is a context manager. It always keeps
a count and the host seconds per name (`totals()`), and gives them to its
caller as `.host_s` after it exits. While `torch.profiler` records
(`torch.autograd.profiler._is_profiler_enabled`, which the profiler sets on
entry and clears on exit) it also

  * appends a `Record` in memory: its id and its parent's (from a stack of
    the calling thread's open spans, so a worker thread's spans nest among
    themselves), the layer, the request's key (a record's key, or a chunk's
    index; a span given none takes its parent's), the host start and end
    from `time.time_ns()` (the clock the profiler stamps its events with),
    the attrs, and the counters charged to it;
  * on a CUDA device, records a `torch.cuda.Event(enable_timing=True)` on
    the current stream at entry and at exit, with no synchronise. The
    stream runs in order, so the time between the two is the device time of
    the work the span queued, idle while it was being queued included. The
    events are read when the records are (`records()`), after the caller has
    synchronised;
  * enters `torch.profiler.record_function(name)`, so the profiler's trace
    shows the span.

`count(name, n)` adds to a counter of the innermost open span, only while
the profiler records. On a CUDA device the tracer then also counts
`host_sync`: each synchronising copy or read of the device (`.cpu()`,
`.item()`, `float()`, `bool()` of a CUDA tensor, a copy from pageable host
memory), found through CUDA's sync debug mode, whose warnings are counted
and not shown. An explicit `torch.cuda.synchronize()` is not counted. The
mode is set at the first span after the profiler starts and restored at the
first span, warning or read of the records after it stops.

The process has one tracer (`TRACER`); the module's functions are its
methods.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from collections import defaultdict
from typing import Any, Optional

import torch
import torch.autograd.profiler as _profiler

# the executor's, the grounder's, the editors' (IP2P: `ip2p`, `unet`; the
# Flux pair: `flux_pair`, `t5`, `flux_text`, `flux`; both: `vae_encode`,
# `vae_decode`) and the scorers' spans
LAYERS = ("executor", "grounding", "editor", "scorers")
HOST_SYNC = "host_sync"
# the start of the warning CUDA's sync debug mode raises at a synchronisation
_SYNC_WARNING = "called a synchronizing CUDA operation"


def active() -> bool:
    """True while a `torch.profiler` profile records."""
    return _profiler._is_profiler_enabled


@dataclasses.dataclass(eq=False)
class Record:
    id: int
    parent: Optional[int]
    name: str
    layer: str
    key: Any
    thread: int
    t0_ns: int
    t1_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    # the device time between the entry and exit events, once read
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


class Span:
    __slots__ = ("tracer", "name", "layer", "key", "attrs", "rec", "rf", "t0", "host_s")

    def __init__(self, tracer: "Tracer", name: str, layer: str, key, attrs: dict):
        self.tracer, self.name, self.layer, self.key, self.attrs = tracer, name, layer, key, attrs
        self.rec = self.rf = None
        self.host_s = 0.0

    def __enter__(self) -> "Span":
        if active():
            self.tracer._open(self)
        elif self.tracer._syncs is not None:
            self.tracer._settle()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.host_s = time.perf_counter() - self.t0
        if self.rec is not None:
            self.tracer._close(self)
        self.tracer._total(self.name, self.host_s)
        return False


class _SyncCounter:
    """CUDA's sync debug mode at "warn", its warnings counted as `host_sync`
    by the tracer and shown only where the mode was on before."""

    def __init__(self, tracer: "Tracer"):
        self.tracer = tracer
        self.mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():    # "a prototype feature", once a process
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
        self.shown = warnings.showwarning
        warnings.filterwarnings("always", message=_SYNC_WARNING, category=UserWarning)
        self.filter = warnings.filters[0]
        warnings.showwarning = self.show

    def show(self, message, category, filename, lineno, file=None, line=None):
        if not (issubclass(category, UserWarning) and str(message).startswith(_SYNC_WARNING)):
            self.shown(message, category, filename, lineno, file, line)
            return
        if active():
            self.tracer.count(HOST_SYNC)
        else:
            self.tracer._settle()
        if self.mode:
            self.shown(message, category, filename, lineno, file, line)

    def remove(self) -> None:
        torch.cuda.set_sync_debug_mode(self.mode)
        if warnings.showwarning == self.show:
            warnings.showwarning = self.shown
        if self.filter in warnings.filters:
            warnings.filters.remove(self.filter)


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._records: list[Record] = []
        self._loose: dict[str, int] = defaultdict(int)   # counts outside any span
        self._totals: dict[str, list] = defaultdict(lambda: [0, 0.0])
        self._syncs: Optional[_SyncCounter] = None

    def span(self, name: str, layer: str, key=None, **attrs) -> Span:
        return Span(self, name, layer, key, attrs)

    def count(self, name: str, n: int = 1) -> None:
        if not active():
            return
        stack = self._stack()
        counts = stack[-1].counts if stack else self._loose
        counts[name] = counts.get(name, 0) + n

    def records(self) -> list[Record]:
        """Every record, its device time read (the device must have run the
        span's exit event: synchronise first)."""
        self._settle()
        for rec in self._records:
            if rec.events is not None and rec.t1_ns:
                start, end = rec.events
                end.synchronize()
                rec.device_ms, rec.events = start.elapsed_time(end), None
        return list(self._records)

    def counters(self) -> dict[str, int]:
        out = defaultdict(int, self._loose)
        for rec in self._records:
            for k, v in rec.counts.items():
                out[k] += v
        return dict(out)

    def totals(self) -> dict[str, tuple[int, float]]:
        """name -> (spans closed, host seconds in them), traced or not."""
        with self._lock:
            return {k: (c, s) for k, (c, s) in self._totals.items()}

    def clear(self) -> None:
        self._settle()
        with self._lock:
            self._records.clear()
            self._loose.clear()
            self._totals.clear()

    # ---- internals ------------------------------------------------------
    def _stack(self) -> list[Record]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _total(self, name: str, host_s: float) -> None:
        with self._lock:
            t = self._totals[name]
            t[0] += 1
            t[1] += host_s

    def _open(self, span: Span) -> None:
        # the events first: nothing is half-open if making them fails
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            if self._syncs is None:
                with self._lock:
                    if self._syncs is None:
                        self._syncs = _SyncCounter(self)
        stack = self._stack()
        parent = stack[-1] if stack else None
        key = span.key if span.key is not None or parent is None else parent.key
        rec = Record(next(self._ids), parent and parent.id, span.name, span.layer, key,
                     threading.get_ident(), time.time_ns(), attrs=span.attrs, events=events)
        span.rf = torch.autograd.profiler.record_function(span.name)
        span.rf.__enter__()
        if events is not None:
            events[0].record()
        stack.append(rec)
        self._records.append(rec)
        span.rec = rec

    def _close(self, span: Span) -> None:
        rec = span.rec
        if rec.events is not None:
            rec.events[1].record()
        span.rf.__exit__(None, None, None)
        rec.t1_ns = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)

    def _settle(self) -> None:
        """Restore CUDA's sync debug mode once the profiler has stopped."""
        if self._syncs is None or active():
            return
        with self._lock:
            syncs, self._syncs = self._syncs, None
        if syncs is not None:
            syncs.remove()


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
records = TRACER.records
counters = TRACER.counters
totals = TRACER.totals
clear = TRACER.clear
