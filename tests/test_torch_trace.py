"""The port's tracer (`anyedit_tpu_torch/core/trace.py`), the executor's and
the editor's spans, and the benchmark's reducer of them
(`portbench/harness/program_trace.py`), without JAX.

On the CPU: nesting and parent ids (a worker thread's spans on their own
stack), a record's key shared by its spans, nothing recorded and no CUDA
event made while no profiler records, the `host_sync` counter's warning
hook (with stand-ins for CUDA's events and sync debug mode), the executor's
`report["stages"]` unchanged on a stub chunk-mode toolbox, one `unet` span a
UNet call, and the reducer on a hand-built reading, whose four idle shares
add up to the idle time. Tests marked `cuda` hold, on the card, the
program's host clock against the profiler's device events (the offset is
printed), the span's device-event time against a known kernel's profiler
duration, and the count of `.cpu()`, `.item()`, `float()` and `bool()`:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_trace.py
"""

import dataclasses
import statistics
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from anyedit_tpu_torch.core import trace
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.diffusion.ip2p import ip2p_edit
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.schedulers import make_noise_schedule
from portbench.harness import program_trace, readers, registry
from portbench.harness.trace import DeviceTrace
from portbench.tests.tiny import BENCH

torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]
SYNC = "called a synchronizing CUDA operation (Triggered internally at CUDAFunctions.cpp:1.)"


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def _profiled(fn):
    with torch.profiler.profile(activities=CPU) as prof:
        fn()
    return prof


def test_nesting_parents_and_a_threads_own_stack():
    """Parents from the calling thread's stack: a worker's spans nest among
    themselves while the main thread's span stays open, and the profiler's
    trace names the main thread's spans."""
    def work():
        with trace.span("load", "executor", key="w"):
            with trace.span("inner", "executor"):
                pass

    def body():
        with trace.span("chunk", "executor", key=0):
            with trace.span("record", "executor", key="r"):
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
                with trace.span("unet", "editor", rows=12, step=3):
                    pass
    prof = _profiled(body)
    by = {r.name: r for r in trace.records()}
    assert set(by) == {"chunk", "record", "load", "inner", "unet"}
    assert by["chunk"].parent is None and by["record"].parent == by["chunk"].id
    assert by["unet"].parent == by["record"].id and by["unet"].attrs == {"rows": 12, "step": 3}
    assert by["load"].parent is None and by["inner"].parent == by["load"].id
    assert by["load"].thread == by["inner"].thread != by["chunk"].thread
    assert by["inner"].key == "w" and by["unet"].key == "r" and by["chunk"].key == 0
    for r in by.values():
        assert r.t0_ns <= r.t1_ns and r.device_ms is None
    assert by["chunk"].t0_ns <= by["record"].t0_ns <= by["unet"].t0_ns <= by["unet"].t1_ns \
        <= by["record"].t1_ns <= by["chunk"].t1_ns
    names = {e.name for e in prof.events()}
    assert {"chunk", "record", "unet"} <= names
    assert trace.totals()["unet"][0] == 1


def test_nothing_recorded_and_no_event_made_while_the_profiler_is_off(monkeypatch):
    """Off: the count and host seconds only, no record, no CUDA event even
    on an initialised card; on, the span reaches for its events (the stand-in
    raises), and a span that could not open leaves nothing open."""
    def no_event(*a, **k):
        raise RuntimeError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    for _ in range(3):
        with trace.span("stage", "executor") as s:
            trace.count(trace.HOST_SYNC)
    assert s.host_s >= 0.0 and trace.totals()["stage"][0] == 3
    assert trace.records() == [] and trace.counters() == {}

    def body():
        with pytest.raises(RuntimeError, match="CUDA event"):
            with trace.span("stage", "executor"):
                pass
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        with trace.span("after", "executor"):
            pass
    _profiled(body)
    recs = trace.records()
    assert [r.name for r in recs] == ["after"] and recs[0].parent is None


class _Event:
    """torch.cuda.Event's stand-in: the host clock at `record()`."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_host_syncs_are_counted_to_the_innermost_span(monkeypatch, recwarn):
    """The sync debug mode's warnings, while the profiler records, count as
    `host_sync` on the innermost open span and are not shown; other
    warnings pass; once the profiler stops the mode and the warning hook
    are restored."""
    mode = {"v": 0}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["v"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(v={"warn": 1}.get(m, m)))
    shown = warnings.showwarning

    def body():
        with trace.span("post_filter", "executor", key="r"):
            assert mode["v"] == 1
            with trace.span("vqa", "scorers"):
                warnings.warn(SYNC)
                warnings.warn(SYNC)
            warnings.warn(SYNC)
            warnings.warn("something else")
    _profiled(body)
    recs = {r.name: r for r in trace.records()}
    assert recs["vqa"].counts == {"host_sync": 2} and recs["post_filter"].counts == {"host_sync": 1}
    assert trace.counters() == {"host_sync": 3}
    assert recs["vqa"].device_ms is not None and recs["vqa"].device_ms >= 0.0
    assert [str(w.message) for w in recwarn] == ["something else"]
    assert mode["v"] == 0 and warnings.showwarning is shown
    assert not any(f[0] == "always" and f[1] is not None and f[1].pattern.startswith("called a")
                   for f in warnings.filters)


@dataclasses.dataclass
class _Ground:
    mask: torch.Tensor
    union_ratio: float


def _stub_toolbox():
    """color_alter's slots on the CPU: the red pixels, the negative image,
    and CLIP / VQA stand-ins; the slots open the zoo's spans."""
    def ground(image, phrase, mode="merge", count_k=None):
        with trace.span("ground", "grounding"):
            m = torch.from_numpy(image[..., 0] > 180)
            return _Ground(m, float(m.float().mean())) if bool(m.any()) else None

    def ground_batch(images, phrases, modes=None, count_ks=None):
        return [ground(im, ph) for im, ph in zip(images, phrases)]

    def ip2p(image, instruction, mask01, **kw):
        with trace.span("ip2p", "editor"):
            return 255 - image

    def ip2p_batch(images, instructions, **kw):
        with trace.span("ip2p", "editor"):
            return [255 - im for im in images]

    def clip_image(image):
        with trace.span("clip_image", "scorers"):
            v = torch.from_numpy(image.reshape(-1, 3).mean(0).astype(np.float32) + 1)[None]
            return v / v.norm()
    ground.batch, ip2p.batch = ground_batch, ip2p_batch
    clip_image.batch = lambda images: [clip_image(im) for im in images]
    tb = Toolbox(ground=ground, ip2p=ip2p)
    tb.clip_image = clip_image
    tb.clip_text = lambda text: torch.tensor([[0.6, 0.8, 0.0]])
    tb.vqa_yes_no = lambda image, q: True
    return tb


def _records(n=5):
    return [InstructionRecord.from_json({
        "edit": f"make it blue {i}", "edited object": "red square", "input": "a red square",
        "output": "a blue square", "edit_type": "color_alter", "image_file": f"img_{i}.png"})
        for i in range(n)]


def _load(rec):
    img = np.full((24, 20, 3), 40, np.uint8)
    img[4:12, 4:12] = (220, 30, 30)
    return img


def _run(root, profiled: bool):
    ex = executor.FactoryExecutor(_stub_toolbox(), executor.ExecutorConfig(
        output_root=str(root), grounding_batch=2))
    out = {}

    def body():
        out["report"] = ex.run(_records(), _load)
    _profiled(body) if profiled else body()
    return out["report"]


def test_report_stages_unchanged_and_record_keys_shared(tmp_path, monkeypatch):
    """A chunk-mode run of 5 records in chunks of 2, both gates open: the
    same stage names and counts with the profiler on as off; the spans
    `chunk`, `load_wait` (3 each), `record` and `write` (5 each); every span
    under a `record` or a chunk's `pre_filter` carries the record's key,
    the chunk's other spans the chunk's index."""
    monkeypatch.setattr(executor, "pre_filter_decision", lambda *a, **k: True)
    monkeypatch.setattr(executor, "post_filter_decision", lambda *a, **k: True)
    plain = _run(tmp_path / "plain", profiled=False)
    assert trace.records() == []
    traced = _run(tmp_path / "traced", profiled=True)
    assert plain["counts"] == traced["counts"] == {"success": 5, "failure": 0, "filtered": 0}
    counts = {k: v["count"] for k, v in traced["stages"].items()}
    assert counts == {k: v["count"] for k, v in plain["stages"].items()}
    assert counts == {"ground_batch": 3, "clip_batch": 3, "pre_filter": 5, "edit_batch": 3,
                      "load": 5, "edit/color_alter": 5, "post_filter": 5}
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    assert (names.count("chunk"), names.count("load_wait")) == (3, 3)
    assert (names.count("record"), names.count("write")) == (5, 5)
    for r in recs:
        assert r.layer in trace.LAYERS
        if r.name in counts:
            assert r.layer == "executor"
        top = r
        while top.name not in ("record", "pre_filter", "chunk", "load_wait"):
            top = by_id[top.parent]
        assert r.key == top.key
        if top.name in ("record", "pre_filter"):
            assert r.key.startswith("color_alter::img_")
    keys = {r.key for r in recs if r.name == "record"}
    assert len(keys) == 5 and keys == {r.key for r in recs if r.name == "pre_filter"}
    assert sorted({r.key for r in recs if r.name in ("chunk", "load_wait")}) == [0, 1, 2]
    under = {(by_id[r.parent].name, r.name) for r in recs if r.parent is not None}
    assert {("edit_batch", "ip2p"), ("ground_batch", "ground"), ("record", "write"),
            ("post_filter", "clip_image")} <= under


def test_one_unet_span_a_call():
    """`ip2p_edit` opens one `unet` span a UNet call, with its rows and step."""
    ns = make_noise_schedule(device="cpu")
    lat = torch.zeros((2, 4, 4, 4))
    ctx = torch.zeros((2, 3, 8))

    def body():
        ip2p_edit(lambda x, t, c: torch.zeros_like(x[..., :4]), ns, lat, ctx, ctx, num_steps=3)
    _profiled(body)
    recs = trace.records()
    assert [(r.name, r.layer, r.attrs) for r in recs] == \
        [("unet", "editor", {"rows": 6, "step": i}) for i in range(3)]


# ---- the benchmark's reducer on a hand-built reading ----------------------
MS = 1_000_000
T0 = 1_700_000_000 * 10 ** 9
MAIN = threading.main_thread().ident
# (id, parent, name, layer, start ms, end ms, device ms, counts)
SPANS = [
    (1, None, "chunk", "executor", 0, 90, None, {}),
    (2, 1, "ground_batch", "executor", 5, 20, None, {}),
    (3, 2, "ground", "grounding", 6, 18, 10.0, {"host_sync": 2}),
    (4, 1, "edit_batch", "executor", 20, 70, None, {}),
    (5, 4, "ip2p", "editor", 21, 69, 45.0, {}),
    (6, 5, "unet", "editor", 22, 40, 17.0, {"host_sync": 1}),
    (7, 5, "unet", "editor", 41, 60, 18.0, {}),
    (8, 5, "unet", "editor", 61, 68, 6.0, {}),
    (9, 1, "record", "executor", 70, 88, None, {}),
    (10, 9, "post_filter", "executor", 71, 80, None, {}),
    (11, 10, "aesthetic", "scorers", 72, 79, 6.0, {}),
    (12, 11, "clip_image", "scorers", 73, 78, 4.0, {}),
    (13, 9, "write", "executor", 80, 87, None, {"host_sync": 1}),
    (14, None, "load_wait", "executor", 90, 95, None, {}),
]
KERNELS = [(0, 4), (6, 16), (22, 60), (61, 67), (73, 77), (90, 92)]


def _reading(units=2):
    recs = [trace.Record(i, p, n, la, None, MAIN, T0 + a * MS, T0 + b * MS, device_ms=d,
                         counts=dict(c)) for i, p, n, la, a, b, d, c in SPANS]
    # the loader thread's span, and one before the window: neither is read
    recs.append(trace.Record(15, None, "load", "executor", None, MAIN + 1, T0, T0 + 50 * MS))
    recs.append(trace.Record(16, None, "write", "executor", None, MAIN, T0 - 9 * MS, T0 - MS,
                             counts={"host_sync": 5}))
    dt = DeviceTrace()
    dt.t0, dt.t1 = T0, T0 + 100 * MS
    dt.kernels = [("k", T0 + a * MS, T0 + b * MS) for a, b in KERNELS]
    return recs, {"trace": dt, "units": units, "window_s": 0.1}


def test_reducer_on_a_hand_built_reading(monkeypatch):
    """Idle gaps 2 + 6 + 1 + 6 + 13 + 8 = 36 ms, split by the main thread's
    innermost span: executor 27 (none open from 95 ms), grounding 2, editor
    4, scorers 3; per pair (2) the halves, adding up to the idle share times
    the window. Device time of the outermost spans: grounding 10, editor 45
    (not the UNet's 41 again), scorers 6 (not `clip_image` inside
    `aesthetic`); the executor the rest of 100."""
    recs, r = _reading()
    monkeypatch.setattr(trace, "records", lambda: recs)
    got = {m.NAME: m.read(r) for m in registry.metrics_for(BENCH, "factory.color_alter")
           if "program_trace" in m.read.__code__.co_names}
    assert got == pytest.approx({
        "executor_idle_ms_per_pair.factory": 13.5, "ground_idle_ms_per_pair.factory": 1.0,
        "edit_idle_ms_per_pair.factory": 2.0, "scorer_idle_ms_per_pair.factory": 1.5,
        "ground_dev_ms_per_pair.factory": 5.0, "edit_dev_ms_per_pair.factory": 22.5,
        "scorer_dev_ms_per_pair.factory": 3.0, "executor_dev_ms_per_pair.factory": 19.5,
        "unet_ms_per_call.factory": 17.0, "host_syncs_per_pair.factory": 2.0,
        "load_wait_ms_per_pair.factory": 2.5})
    idle = sum(v for k, v in got.items() if "_idle_" in k)
    assert idle * r["units"] == pytest.approx(readers.idle_pct(r) / 100 * 100.0)
    gaps = program_trace.idle_gaps(r["trace"].kernels, T0, T0 + 100 * MS)
    assert [((a - T0) // MS, (b - T0) // MS) for a, b in gaps] == \
        [(4, 6), (16, 22), (60, 61), (67, 73), (77, 90), (92, 100)]
    assert statistics.median([17.0, 18.0, 6.0]) == got["unet_ms_per_call.factory"]


def test_reducer_reads_nothing_from_a_program_without_the_tracer(monkeypatch):
    """Where the program has no tracer (the parent commit) or recorded
    nothing in the window, every new metric reads None and none raises."""
    import sys

    import anyedit_tpu_torch.core as core
    _, r = _reading()
    metrics = [m for m in registry.metrics_for(BENCH, "factory.color_alter")
               if "program_trace" in m.read.__code__.co_names]
    assert len(metrics) == 11
    monkeypatch.setattr(trace, "records", lambda: [])
    assert [m.read(r) for m in metrics] == [None] * 11
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "anyedit_tpu_torch.core.trace", None)
    assert [m.read(r) for m in metrics] == [None] * 11


# ---- on the card -----------------------------------------------------------
@pytest.fixture
def cuda():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events and the profiler's device clock)")
    dev = torch.device("cuda")
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize()
    return dev


def _kernels(prof):
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]


def _sleep_traced(cycles: int, n: int = 1):
    """`n` spans, each around one `torch.cuda._sleep` kernel after a
    synchronise, under the profiler (the kernel launched once before, so
    its module is loaded): [(the span's record, the kernel's event)]."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            torch.cuda.synchronize()
            with trace.span("sleep", "executor"):
                torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    recs = [r for r in trace.records() if r.name == "sleep"]
    spin = sorted((k for k in _kernels(prof) if "spin" in k[0] or "sleep" in k[0]),
                  key=lambda k: k[1])
    assert len(recs) == len(spin) == n, (recs, _kernels(prof))
    return list(zip(recs, spin))


@pytest.mark.cuda
def test_span_clock_is_the_profilers(cuda):
    """Each span's host start (`time.time_ns`) lies before the kernel it
    launched in the profiler's clock, by a launch's worth."""
    pairs = _sleep_traced(2_000_000, n=9)
    offsets = [(k0 - rec.t0_ns) / 1e6 for rec, (_, k0, _) in pairs]
    print(f"\nclock: kernel start - span host start, ms: median "
          f"{statistics.median(offsets):.4f}, min {min(offsets):.4f}, max {max(offsets):.4f} "
          f"over {len(offsets)} spans, {torch.cuda.get_device_name(0)}")
    assert all(0.0 < o < 20.0 for o in offsets), offsets


@pytest.mark.cuda
@pytest.mark.parametrize("cycles", [2_000_000, 50_000_000])
def test_span_device_time_is_the_kernels(cuda, cycles):
    """The span's device-event time holds the one kernel it queued: its
    profiler duration, and from the start event on the idle card the
    kernel's launch (under 0.25 ms)."""
    [(rec, (_, k0, k1))] = _sleep_traced(cycles)
    kernel_ms = (k1 - k0) / 1e6
    print(f"\nmarker {rec.device_ms:.4f} ms, kernel {kernel_ms:.4f} ms, "
          f"{torch.cuda.get_device_name(0)}")
    assert kernel_ms * 0.999 <= rec.device_ms <= kernel_ms * 1.001 + 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("op,n", [("cpu", 1), ("item", 1), ("float", 1), ("bool", 1),
                                  ("synchronize", 0)])
def test_host_sync_counts_each_implicit_sync_once(cuda, op, n):
    x = torch.ones(1, device=cuda) + 1
    run = {"cpu": lambda: x.cpu(), "item": lambda: x.item(), "float": lambda: float(x),
           "bool": lambda: bool(x), "synchronize": torch.cuda.synchronize}[op]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with trace.span("outer", "executor"):
            with trace.span("op", "scorers"):
                run()
    recs = {r.name: r for r in trace.records()}
    assert recs["op"].counts.get("host_sync", 0) == n
    assert recs["outer"].counts.get("host_sync", 0) == 0
    assert torch.cuda.get_sync_debug_mode() == 0
