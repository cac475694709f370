"""The benchmark's textual_change cell (`portbench/`, configuration
`factory-flux-schnell`) on the CPU at the tiny presets, without JAX.

The port's Flux and T5 encoder against the plain reference
(`portbench/reference/flux.py`) on the same seeded weights, drawn block by
block (`portbench/harness/blocks.py`); the zoo's Flux pair (the normal path)
against the reference's pair from the same start noise; the Flux T5 length
(`ZooConfig.flux_t5_len`); the Flux path's spans; the driver's refusals,
records and seeds, one run of the cell; and the cell's FLOP count at the
published widths. A reference with RoPE dropped, or with the modulation
dropped, fails the same tolerances.
"""

import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from anyedit_tpu_torch.core import trace
from anyedit_tpu_torch.models.flux import Flux
from anyedit_tpu_torch.models.t5 import T5Encoder
from anyedit_tpu_torch.runtime import zoo as zoo_mod
from portbench.drivers import factory, textual
from portbench.harness import blocks, registry, synth_checks, weights
from portbench.reference import flux as rflux
from portbench.tests import tiny

torch.set_num_threads(1)
F32 = torch.float32
CELL = "factory.textual_change"
BENCH = tiny.BENCH
TZ = zoo_mod.tiny_zoo_config()
# the tiny cell's T5 length: neither the default 77 nor the tiny T5's own
T5_LEN = 20
CAPTIONS = ('a photo of a bus with a sign that reads "open"',
            'a photo of a bus with a sign that reads "stop"')
# the port's Flux and T5 run the reference's fp32 operations, some in
# another order: relative L2 within 1e-5 (they read 0 here)
MODEL_REL = 1e-5
# the pair: the zoo casts the T5 context and the VAE's input to bf16 in
# every configuration (`_flux_sampler`, `_from_latents`), so the fp32 tiny
# pair sits a rounding away from the fp32 reference: a mean of at most 0.25
# of a level (0.10 here) and no value more than 4 levels off
PAIR_MEAN, PAIR_LEVELS = 0.25, 4


def _tiny_cfg() -> dict:
    """The cell's configuration at the tiny presets, T5 at T5_LEN."""
    cfg = json.loads((BENCH / "configs/factory-flux-schnell.json").read_text())
    w = factory.widths
    cfg.update(zoo_base="tiny", dtype="float32", t5_len=T5_LEN,
               flux=w(TZ.flux, F32), t5=w(TZ.flux_text, F32), flux_vae=w(TZ.flux_vae, F32),
               clip_text={k: v for k, v in w(TZ.text, F32).items() if k in cfg["clip_text"]},
               towers={"vision": w(TZ.vision, F32)},
               canvas={"edit_size": 64, "grounding_size": 64, "sam_size": 64, "latent_down": 2})
    return cfg


CFG = _tiny_cfg()


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _models(kind, seed=7):
    make, pcfg = {"flux": (Flux, TZ.flux), "t5": (T5Encoder, TZ.flux_text)}[kind]
    spec = textual.spec(kind, CFG)
    prog = make(pcfg, device="cpu").eval()
    blocks.load_program(prog, spec, seed, kind, "cpu")
    ref = blocks.reference_module(rflux.build(kind, CFG[kind], F32, "meta"), spec, seed, kind,
                                  "cpu")
    return prog, ref


@pytest.fixture(scope="module")
def flux_pair():
    return _models("flux")


@pytest.fixture(scope="module")
def t5_pair():
    return _models("t5")


def _flux_inputs():
    g = torch.Generator().manual_seed(1)
    return (torch.randn(2, 8, 8, 4, generator=g), torch.tensor([1000.0, 500.0]),
            torch.randn(2, 5, 32, generator=g), torch.randn(2, 32, generator=g))


def _drop(monkeypatch, control):
    if control == "no_rope":
        monkeypatch.setattr(rflux, "apply_rope", lambda x, cos, sin: x)
    elif control == "no_modulation":
        monkeypatch.setattr(rflux._Mod, "forward",
                            lambda self, vec: torch.zeros(vec.shape[0], self.linear.out_features))


@pytest.mark.parametrize("kind", ["flux", "t5"])
def test_block_draw_gives_program_and_reference_the_same_values(kind, flux_pair, t5_pair):
    prog, ref = flux_pair if kind == "flux" else t5_pair
    p, r = dict(prog.named_parameters()), dict(ref.named_parameters())
    assert set(p) == set(r)
    for k in p:
        assert p[k].shape == r[k].shape and r[k].dtype == F32
        assert torch.equal(p[k].float(), r[k]), k
    groups = blocks.groups(textual.spec(kind, CFG))
    want = ({"transformer_blocks.0", "single_transformer_blocks.1", "x_embedder",
             "time_text_embed", "norm_out"} if kind == "flux"
            else {"embed_tokens", "block.0", "block.1", "final_layer_norm"})
    assert want <= set(groups)
    # each group draws under its own tag: blocks differ, and one group's
    # draw is the same alone as among the others
    a, b = ("transformer_blocks.0", "transformer_blocks.1") if TZ.flux.double_depth > 1 \
        else ("single_transformer_blocks.0", "single_transformer_blocks.1")
    if kind == "t5":
        a, b = "block.0", "block.1"
    wa = weights.draw(groups[a], 7, f"{kind}/{a}", "cpu")
    assert all(torch.equal(v.float(), r[k]) for k, v in wa.items())
    wb = weights.draw(groups[b], 7, f"{kind}/{b}", "cpu")
    ka, kb = sorted(wa)[0], sorted(wb)[0]
    assert not torch.equal(wa[ka].float().flatten()[:8], wb[kb].float().flatten()[:8])


def test_flux_matches_reference(flux_pair):
    prog, ref = flux_pair
    with torch.no_grad():
        assert _rel(prog(*_flux_inputs()), ref(*_flux_inputs())) <= MODEL_REL


@pytest.mark.parametrize("control", ["no_rope", "no_modulation"])
def test_flux_reference_control_fails(flux_pair, monkeypatch, control):
    prog, ref = flux_pair
    _drop(monkeypatch, control)
    with torch.no_grad():
        assert _rel(prog(*_flux_inputs()), ref(*_flux_inputs())) > 100 * MODEL_REL


def test_t5_matches_reference(t5_pair):
    prog, ref = t5_pair
    ids = torch.randint(0, TZ.flux_text.vocab_size, (2, T5_LEN),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = prog(ids), ref(ids)
    assert got.shape == (2, T5_LEN, TZ.flux_text.dim) and _rel(got, want) <= MODEL_REL


def test_t5_buckets_match_the_programs():
    from anyedit_tpu_torch.models.t5 import _buckets
    for n in (20, 77, 256):
        assert torch.equal(rflux.relative_buckets(n, n, 32, 128).to(torch.int32),
                           _buckets(n, n, True, 32, 128))


def _zoo(t5_len=T5_LEN, seed=5):
    zoo = zoo_mod.ModelZoo(textual.zoo_config(CFG, t5_len), device="cpu", seed=seed)
    textual.install_weights(zoo, CFG, seed)
    return zoo


def _reference_pair(seed, noise, t5_len=T5_LEN):
    spec = textual.spec
    t5 = blocks.reference_module(rflux.build("t5", CFG["t5"], F32, "meta"), spec("t5", CFG),
                                 seed, "t5", "cpu")
    clip = weights.reference_module("clip_text", CFG["clip_text"], F32, seed, "cpu")
    conds = rflux.encode_captions(t5, clip, CFG, CAPTIONS, t5_len, "cpu")
    flux = blocks.reference_module(rflux.build("flux", CFG["flux"], F32, "meta"),
                                   spec("flux", CFG), seed, "flux", "cpu")
    lats = rflux.sample_latents(flux, CFG, conds, [noise, noise])
    vae = weights.reference_module("vae", CFG["flux_vae"], F32, seed, "cpu", tag="flux_vae")
    return rflux.decode_images(vae, CFG, lats)


@pytest.fixture(scope="module")
def program_pair():
    noise = textual.start_noise(CFG, 123, "cpu")
    a, b = _zoo().flux_pair_fn()(*CAPTIONS, 123)
    assert torch.equal(noise, textual.start_noise(CFG, 123, "cpu"))
    return noise, [torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))]


@pytest.mark.parametrize("control", ["sound", "no_rope", "no_modulation"])
def test_flux_pair_matches_reference(program_pair, monkeypatch, control):
    """The zoo's pair slot (T5 at the configured length, CLIP-L's pooled
    output, 4 flow steps, the Flux VAE, the canvas) against the reference's
    pair of the same captions from the same start noise; the controls
    break the reference and must fail."""
    noise, got = program_pair
    _drop(monkeypatch, control)
    r = synth_checks.synth_readings(got, _reference_pair(5, noise))
    ok = r["synth_mean_abs"] <= PAIR_MEAN and r[f"synth_share_over_{PAIR_LEVELS}"] == 0.0
    assert ok == (control == "sound"), r
    if control != "sound":
        assert r["synth_mean_abs"] > 10 * PAIR_MEAN, r


def _t5_lengths(zoo, fn):
    seen = []
    hook = zoo._cache["t5"].register_forward_hook(lambda m, a, out: seen.append(a[0].shape[1]))
    try:
        fn()
    finally:
        hook.remove()
    return seen


def test_flux_t5_length_is_configured_and_defaults_to_77():
    assert zoo_mod.ZooConfig().flux_t5_len == 77 and TZ.flux_t5_len == 77
    zoo = _zoo()
    assert zoo.cfg.flux_t5_len == T5_LEN
    flux_ctx = []
    hook = zoo._cache["flux"].register_forward_hook(
        lambda m, a, out: flux_ctx.append(a[2].shape[1]))
    seen = _t5_lengths(zoo, lambda: zoo.flux_pair_fn()(*CAPTIONS, 3))
    hook.remove()
    assert seen == [T5_LEN, T5_LEN] and flux_ctx == [T5_LEN] * 8
    # SD3's conditioning keeps 77 whatever the Flux length
    assert _t5_lengths(zoo, lambda: zoo.sd3_cond()(CAPTIONS[0])) == [77]
    default = _zoo(t5_len=77)
    assert _t5_lengths(default, lambda: default.text2img_fn()(CAPTIONS[0])) == [77]


def test_traced_pair_emits_the_flux_spans():
    zoo = _zoo()
    pair = zoo.flux_pair_fn()
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pair(*CAPTIONS, 4)
    recs = trace.records()
    trace.clear()
    by_id = {r.id: r for r in recs}
    top = [r for r in recs if r.name == "flux_pair"]
    assert len(top) == 1 and top[0].layer == "editor"

    def inside(r):
        while r.parent is not None:
            r = by_id[r.parent]
            if r is top[0]:
                return True
        return False
    names = [r.name for r in recs if r is not top[0]]
    assert sorted(set(names)) == ["flux", "flux_text", "t5", "vae_decode"]
    assert names.count("t5") == names.count("flux_text") == names.count("vae_decode") == 2
    flux = [r for r in recs if r.name == "flux"]
    tokens = T5_LEN + (CFG["canvas"]["edit_size"] // CFG["canvas"]["latent_down"]
                       // TZ.flux.patch) ** 2
    assert [r.attrs for r in flux] == [{"rows": 1, "tokens": tokens, "step": i, "k6": 0}
                                       for _ in CAPTIONS for i in range(4)]
    assert all(inside(r) and r.layer == "editor" for r in recs if r is not top[0])


def test_zoo_config_refuses_another_program(monkeypatch):
    """A program without the T5 length (the parent of the field) is refused
    before anything is built; so is a tower other than the file's."""
    old = dataclasses.make_dataclass(
        "ZooConfig", [(f.name, f.type) for f in dataclasses.fields(TZ) if f.name != "flux_t5_len"])
    with monkeypatch.context() as m:
        m.setattr(zoo_mod, "tiny_zoo_config",
                  lambda: old(**{f.name: getattr(TZ, f.name) for f in dataclasses.fields(old)}))
        with pytest.raises(RuntimeError, match="flux_t5_len"):
            textual.zoo_config(CFG)
    for key, change in (("flux", {"single_depth": 3}), ("t5", {"heads": 2}),
                        ("towers", {"vision": {**CFG["towers"]["vision"], "layers": 9}})):
        cfg = json.loads(json.dumps(CFG))
        cfg[key].update(change)
        with pytest.raises(ValueError, match="is not the configuration's"):
            textual.zoo_config(cfg)
    assert textual.zoo_config(CFG, 77).flux_t5_len == 77


def test_records_are_distinct_and_seeded():
    params = json.loads((BENCH / "traffic/textual_change.json").read_text())
    recs = textual.records(params, 2147483651)
    assert len(recs) == params["n_records"] == 2048
    assert len({r["edit"] for r in recs}) == len(recs)
    assert recs == textual.records(params, 2147483651) != textual.records(params, 9)
    for r in recs[:50]:
        a, b = r["input"].split('"')[1], r["output"].split('"')[1]
        assert a != b and a in r["edit"] and b in r["edit"] and "image_file" not in r


def test_record_seed_is_the_executors():
    from anyedit_tpu_torch.core.rng import host_rng
    from anyedit_tpu_torch.core.schema import InstructionRecord
    params = json.loads((BENCH / "traffic/textual_change.json").read_text())
    for seed in (0, 2147483651, 2 ** 33 + 5):
        for r in textual.records(params, seed)[:4]:
            key = InstructionRecord(**r).key()
            rng = host_rng(seed, key)
            rng.uniform()
            assert textual.record_seed(seed, key) == int(rng.integers(0, 2 ** 31))


def _tiny_bench(dst: Path) -> Path:
    root = tiny.tiny_copy(dst)
    (root / "configs/factory-flux-schnell.json").write_text(json.dumps(CFG))
    p = root / "traffic/textual_change.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), "n_records": 32}))
    return root


def test_the_cell_runs_on_the_cpu_and_its_check_passes():
    with tempfile.TemporaryDirectory() as t:
        root = _tiny_bench(Path(t))
        res, readings, nums = tiny.drive(root, CELL, 2147483651)
    assert res["attempted"] == 8 and res["failed"] == 0
    assert set(readings) == set(synth_checks.NAMES) and nums and all(n.ok for n in nums)
    assert readings["synth_mean_abs"] <= PAIR_MEAN


def test_flux_call_flops_at_published_widths():
    """The meta-device count of one Flux call at 1,024 image and 256 text
    tokens against the closed form: 57 blocks of 12 d^2 a token and 2 L^2 d
    (QK^T and PV), the patch, context and output projections, the
    modulations and embedders at batch 1, 2 FLOPs a multiply-add."""
    from portbench.harness import flux_flops
    cfg = json.loads((BENCH / "configs/factory-flux-schnell.json").read_text())
    f, d, n_img, n_txt = cfg["flux"], 3072, 1024, 256
    length = n_img + n_txt
    macs = 57 * (12 * length * d * d + 2 * length ** 2 * d)
    macs += (2 * 64 * n_img + 4096 * n_txt) * d
    macs += (12 * f["double_depth"] + 3 * f["single_depth"] + 2 + 2) * d * d \
        + (256 + 768) * d
    got = flux_flops.flux_call_flops(cfg, 256)
    assert got == 2 * macs and 17.5e12 < got < 17.9e12
    assert flux_flops.pair_flops(cfg, 256) > 8 * got


def test_benchmark_lists_the_cell_and_its_metrics():
    b = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = registry.load_cell(BENCH, CELL)
    w = [x for x in b["workloads"] if x["name"] == CELL]
    c = [x for x in b["configs"] if x["name"] == "factory-flux-schnell"]
    assert len(w) == len(c) == 1 and w[0]["why"] == cell.why and cell.chips == 1
    assert c[0]["reduced"] == [] and (BENCH.parent / c[0]["file"]).is_file()
    assert CELL in [m for m in b["end_to_end"] if m["name"] == "pairs_per_hour"][0]["workloads"]
    names = {m.NAME for m in registry.metrics_for(BENCH, CELL)}
    assert names == {m["name"] for m in b["per_layer"] if CELL in m["workloads"]} == {
        "flux_ms_per_call.textual", "t5_ms_per_pair.textual", "edit_dev_ms_per_pair.textual",
        "edit_idle_ms_per_pair.textual", "scorer_dev_ms_per_pair.textual",
        "k2_roofline.textual", "mfu_pct.textual", "device_idle_pct.textual",
        "host_syncs_per_pair.textual", "k6_roofline.textual"}
    assert set(cell.limits) <= set(synth_checks.NAMES) and cell.limits


def test_k6_roofline_reads_the_spans_launches(monkeypatch):
    """`k6_roofline.textual` on hand-built readings: each `flux` span's `k6`
    launches at K1's bound of its (24 rows, tokens, 128) attention over the
    device time of the kernels named `flash_sdpa_kernel`; None where no span
    records a launch (a program before K6), and where the trace holds
    another count of such kernels than the spans record."""
    from portbench.harness import program_trace, roofline
    metric = {m.NAME: m for m in registry.metrics_for(BENCH, CELL)}["k6_roofline.textual"]
    monkeypatch.setattr(roofline, "max_sm_clock_hz", lambda: 1.98e9)

    class Trace:
        def __init__(self, n, each_s):
            self.n, self.each_s = n, each_s

        def named(self, sub):
            return [self.each_s] * self.n if sub == "flash_sdpa_kernel" else []

    def spans(*attrs):
        return [trace.Record(i, None, "flux", "editor", None, 0, 0, 1, a)
                for i, a in enumerate(attrs)]
    bound = roofline.k1_bound_s(24, 1280, 128)
    cases = [(spans({"rows": 1, "tokens": 1280, "step": 0, "k6": 57}) * 2, Trace(114, 4e-5),
              100 * bound / 4e-5),
             (spans({"rows": 1, "tokens": 1280, "step": 0, "k6": 57}), Trace(56, 4e-5), None),
             (spans({"rows": 1, "tokens": 1280, "step": 0}), Trace(0, 4e-5), None),
             (spans({"rows": 1, "tokens": 1280, "step": 0, "k6": 0}), Trace(0, 4e-5), None),
             (None, Trace(0, 4e-5), None)]
    for recs, tr, want in cases:
        monkeypatch.setattr(program_trace, "records", lambda r, _recs=recs: _recs)
        got = metric.read({"trace": tr})
        assert got == pytest.approx(want) if want is not None else got is None


def test_program_span_metrics_are_silent_without_spans():
    """Where the program recorded nothing in the window (a program without
    the Flux spans), the metrics that read its tracer return None."""
    trace.clear()
    window = type("T", (), {"t0": 0, "t1": 1})()
    reading = {"trace": window, "units": 8}
    for m in registry.metrics_for(BENCH, CELL):
        if m.NAME.split(".")[0] in ("flux_ms_per_call", "t5_ms_per_pair", "edit_dev_ms_per_pair",
                                    "edit_idle_ms_per_pair", "scorer_dev_ms_per_pair",
                                    "host_syncs_per_pair"):
            assert m.read(reading) is None, m.NAME


def test_calibration_reads_the_sound_side_and_both_controls():
    """`portbench/calibrate_textual.py`'s sides at the tiny presets: the
    sound side loads a second seed into the built toolbox (`reseed`), the
    T5 control runs T5 at 77 while the reference keeps the configured
    length, the W8A8 control quantizes Flux block by block; each chunk's
    records are checked after the program is freed."""
    import portbench.calibrate_textual as cal
    with tempfile.TemporaryDirectory() as t:
        root = _tiny_bench(Path(t))
        cell = registry.load_cell(root, CELL)
        done = []
        for side, seeds in (("program", [11, 12]), ("control_t5_77", [13]),
                            ("control_w8a8", [14])):
            done += cal.chunks(cell, side, seeds, torch.device("cpu"), Path(t), lambda row: None)
        got = {(side, s): (success, cell.driver.check_records(ctx, r, recs))
               for side, s, ctx, r, recs, success, _ in done}
    assert [k for k in got] == [("program", 11), ("program", 12), ("control_t5_77", 13),
                                ("control_w8a8", 14)]
    assert all(success == 8 for success, _ in got.values())
    assert got[("program", 11)][1] != got[("program", 12)][1]
    for side in (("program", 11), ("program", 12)):
        assert got[side][1]["synth_mean_abs"] <= PAIR_MEAN
    # T5 at 77 against the configured 20: far off even at the tiny size
    assert got[("control_t5_77", 13)][1]["synth_mean_abs"] > 10 * PAIR_MEAN


def test_synth_readings_take_the_worst_image_and_the_mean_over_images():
    r = torch.full((4, 5, 3), 100, dtype=torch.uint8)
    off = r.clone()
    off[0, :, 0] = 110                       # 5 of 60 values 10 levels off
    got = synth_checks.synth_readings([r, off], [r, r])
    assert got["synth_share_over_8"] == 5 / 60 and got["synth_avg_share_over_8"] == 5 / 120
    assert got["synth_share_over_16"] == 0.0 and got["synth_mean_abs"] == 50 / 60
    assert set(got) == set(synth_checks.NAMES)
    assert all(v == float("inf") for v in synth_checks.synth_readings([r], [r[:2]]).values())
    assert all(v == float("inf") for v in synth_checks.synth_readings([], []).values())
