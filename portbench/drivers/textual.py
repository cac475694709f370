"""The textual_change driver: `FactoryExecutor.run` in chunk mode on the
toolbox that `python -m anyedit_tpu_torch run --edit-type textual_change
--ground-batch <chunk>` builds (the Flux pair slot and the post filter's
scorers; no OCR slot, as `run` builds none), records from the traffic file
with no image, so that both sides are synthesized, and both filter gates
forced open (`harness/gates.py`).

Set-up builds the zoo with T5 at the configuration's length
(`ZooConfig.flux_t5_len`; a program without that field is refused before
anything is built), puts the benchmark's seeded weights into the Flux,
T5, Flux VAE and CLIP text slots before they are built (Flux and T5 drawn
block by block, `harness/blocks.py`), and runs one chunk to warm every
shape. The window calls `run` once per chunk, back to back, so that a
chunk starts only while the window is open; the chunk in
flight when it closes finishes and counts, and the window ends with a
synchronise. pairs_per_hour = records marked success x 3600 / window
seconds.

The check, after the program is freed, takes 8 records that succeeded in
the window (drawn from the seed), reads both written sides of each
(`input_img/`, `edited_img/`) and compares them with the reference's pair
of the same captions from the same start latents (the record's seed as the
executor draws it: `host_rng` of (run seed, record key), one uniform for
the pre-gate, then the pipeline's integer). The fp32 reference runs in
phases, each module freed before the next is built: T5 and CLIP-L, then
Flux, then the VAE."""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench.drivers import factory
from portbench.harness import blocks, checks, flux_flops, gates, stats, synth_checks, traffic
from portbench.harness import weights
from portbench.harness.trace import Spans, traced
from portbench.reference import flux as rflux
from portbench.reference import image as ref_image

EDITOR_SPANS = ("flux_pair",)
SCORER_SPANS = ("clip_image", "clip_text", "aesthetic")
CHECKED = 8


def zoo_config(cfg: dict, t5_len: int | None = None):
    """The program's ZooConfig for the configuration: the zoo's own Flux,
    T5, Flux VAE and CLIP text towers and every tower under "towers" must
    be the file's (a program whose towers differ is refused), T5 at
    `t5_len` (default the file's)."""
    from anyedit_tpu_torch.core.config import CanvasConfig
    from anyedit_tpu_torch.runtime import zoo as zoo_mod

    base = zoo_mod.ZooConfig() if cfg["zoo_base"] == "production" else zoo_mod.tiny_zoo_config()
    if "flux_t5_len" not in {f.name for f in dataclasses.fields(base)}:
        raise RuntimeError("the program's ZooConfig has no flux_t5_len: its Flux path cannot "
                           f"take T5 at the configuration's {cfg['t5_len']} tokens")
    dt = weights.served_dtype(cfg)
    text = {k: v for k, v in factory.widths(base.text, dt).items() if k in cfg["clip_text"]}
    for name, got, want in (("flux", factory.widths(base.flux, dt), cfg["flux"]),
                            ("t5", factory.widths(base.flux_text, dt), cfg["t5"]),
                            ("flux_vae", factory.widths(base.flux_vae, dt), cfg["flux_vae"]),
                            ("clip_text", text, cfg["clip_text"]),
                            *((n, factory.widths(getattr(base, n), dt), w)
                              for n, w in cfg["towers"].items())):
        if got != want:
            raise ValueError(f"the program's {name} tower {got} is not the configuration's "
                             f"{want}")
    if base.text.text_proj:
        raise ValueError("the program's clip_text tower has a projection; Flux reads the "
                         "unprojected pooled output")
    return dataclasses.replace(base, canvas=CanvasConfig(**cfg["canvas"]),
                               flux_t5_len=t5_len or cfg["t5_len"])


def spec(kind: str, cfg: dict):
    """The parameter spec of the reference module `kind` of the
    configuration, at the served dtypes."""
    return rflux.parameter_spec(rflux.build(kind, cfg[kind], weights.served_dtype(cfg), "meta"))


@torch.no_grad()
def install_weights(zoo, cfg: dict, seed: int, quant: bool = False) -> None:
    """Put the benchmark's seeded Flux, T5, Flux VAE and CLIP text weights
    into the zoo's slots before they are built (a model found there is not
    built again). With `quant`, the Flux is the program's W8A8 module,
    quantized group by group from those weights in fp32, as the zoo
    quantizes a float checkpoint."""
    from anyedit_tpu_torch.models.clip import CLIPTextEncoder
    from anyedit_tpu_torch.models.flux import Flux
    from anyedit_tpu_torch.models.t5 import T5Encoder
    from anyedit_tpu_torch.models.vae import AutoencoderKL
    from anyedit_tpu_torch.ops.quant import quantize_state_dict

    zc, dev, served = zoo.cfg, zoo.device, weights.served_dtype(cfg)
    if {"flux", "t5", "flux_vae", "clip_text"} & set(zoo._cache):
        raise RuntimeError("a Flux slot was built before the benchmark's weights went in")
    if quant:
        flux = Flux(dataclasses.replace(zc.flux, quant=True), device="meta")
        for g, w in blocks.draw_groups(spec("flux", cfg), seed, "flux", dev):
            sub = flux.get_submodule(g)
            q = quantize_state_dict(sub, {k: v.float() for k, v in blocks.strip(g, w).items()})
            sub.load_state_dict({k: v.to(dev) for k, v in q.items()}, strict=True, assign=True)
    else:
        flux = Flux(zc.flux, device=dev)
        blocks.load_program(flux, spec("flux", cfg), seed, "flux", dev)
    t5 = T5Encoder(zc.flux_text, device=dev)
    blocks.load_program(t5, spec("t5", cfg), seed, "t5", dev)
    vae = AutoencoderKL(zc.flux_vae, device=dev)
    weights.load_into(vae, weights.program_weights("vae", cfg["flux_vae"], served, seed, dev,
                                                   tag="flux_vae"))
    text = CLIPTextEncoder(zc.text, device=dev)
    weights.load_into(text, weights.program_weights("clip_text", cfg["clip_text"], served,
                                                    seed, dev))
    for m in (flux, t5, vae, text):
        m.eval().requires_grad_(False)
    zoo._cache.update({"flux": flux, "t5": t5, "flux_vae": vae, "clip_text": text})


def records(params: dict, seed: int) -> list[dict]:
    """`n_records` textual_change records with no image: a seeded object and
    an ordered pair of distinct words each, no two records alike (the
    ledger keys a record by its edit)."""
    objs, words = params["objects"], params["words"]
    n_pairs = len(words) * (len(words) - 1)
    r = traffic.rng(seed, "records")
    out = []
    for c in r.choice(len(objs) * n_pairs, size=params["n_records"], replace=False):
        obj, pair = objs[int(c) // n_pairs], int(c) % n_pairs
        a, b = divmod(pair, len(words) - 1)
        b += b >= a
        kw = dict(object=obj, word_a=words[a], word_b=words[b])
        out.append({"edit": params["edit_template"].format(**kw),
                    "input": params["input_template"].format(**kw),
                    "output": params["output_template"].format(**kw),
                    "edit_type": params["edit_type"]})
    return out


def record_seed(run_seed: int, key: str) -> int:
    """The seed the executor hands textual_change for a record: `host_rng`
    (a numpy Generator on the first 8 bytes of SHA-256 of "seed:key"), one
    uniform drawn for the pre-gate, then an integer below 2^31."""
    h = hashlib.sha256(f"{run_seed}:{key}".encode()).digest()
    r = np.random.default_rng(int.from_bytes(h[:8], "little"))
    r.uniform()
    return int(r.integers(0, 2 ** 31))


@dataclasses.dataclass
class State:
    ctx: object
    zoo: object
    tb: object
    records: list
    gate: object
    load_image: object = None
    next_record: int = 0
    t5_len: int = 0
    window: dict = dataclasses.field(default_factory=dict)


def setup(ctx, quant: bool = False, t5_len: int | None = None) -> State:
    from anyedit_tpu_torch.cli import record_loaders
    from anyedit_tpu_torch.runtime import executor as ex_mod
    from anyedit_tpu_torch.runtime.zoo import ModelZoo

    cfg, tr = ctx.config, ctx.traffic
    zoo = ModelZoo(zoo_config(cfg, t5_len), device=ctx.device, seed=ctx.seed)
    install_weights(zoo, cfg, ctx.seed, quant)
    tb = factory.build_toolbox(zoo, tr["edit_type"])
    gate = gates.gates_open(ex_mod)
    gate.__enter__()
    st = State(ctx, zoo, tb, [], gate, t5_len=zoo.cfg.flux_t5_len)
    _traffic(st)
    st.load_image = record_loaders(ctx.workdir, cfg["canvas"]["edit_size"])["load_image"]
    _run_chunk(st, ctx.workdir / "warmup", None)            # every shape, once
    ctx.sync()
    return st


def _traffic(st: State) -> None:
    from anyedit_tpu_torch.core.schema import InstructionRecord
    st.records = [InstructionRecord(**r) for r in records(st.ctx.traffic, st.ctx.seed)]
    st.next_record = 0


def reseed(st: State, seed: int, workdir: Path) -> None:
    """The same built toolbox with the weights and traffic of another seed
    (a calibration reads many seeds in one process). Not for the W8A8
    control, whose Flux is quantized at set-up."""
    cfg, c, dev = st.ctx.config, st.zoo._cache, st.zoo.device
    served = weights.served_dtype(cfg)
    st.ctx.seed, st.ctx.workdir = seed, workdir
    for kind in ("flux", "t5"):
        blocks.load_program(c[kind], spec(kind, cfg), seed, kind, dev)
    weights.load_into(c["flux_vae"], weights.program_weights("vae", cfg["flux_vae"], served,
                                                             seed, dev, tag="flux_vae"))
    weights.load_into(c["clip_text"], weights.program_weights("clip_text", cfg["clip_text"],
                                                              served, seed, dev))
    _traffic(st)


def _executor(st: State, root: Path):
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor
    return FactoryExecutor(st.tb, ExecutorConfig(output_root=str(root), seed=st.ctx.seed,
                                                 grounding_batch=st.ctx.traffic["chunk"]))


def _run_chunk(st: State, root: Path, ex) -> dict:
    n = st.ctx.traffic["chunk"]
    chunk = st.records[st.next_record:st.next_record + n]
    if len(chunk) < n:
        raise RuntimeError("the traffic file's records ran out inside the window")
    st.next_record += n
    ex = ex or _executor(st, root)
    return ex.run(chunk, st.load_image, ledger_path=root / "ledger.jsonl")


def _wrap_spans(tb, spans: Spans) -> None:
    """Spans around the toolbox's slots, beneath the executor's own layer."""
    tb.extra["flux_pair"] = spans.wrap(tb.extra["flux_pair"], "flux_pair")
    tb.clip_image = spans.wrap(tb.clip_image, "clip_image")
    tb.clip_text = spans.wrap(tb.clip_text, "clip_text")
    tb.extra["aesthetic"] = spans.wrap(tb.extra["aesthetic"], "aesthetic")


def window(st: State, seconds: float, trace: bool) -> dict:
    ctx = st.ctx
    root = ctx.workdir / "window"
    spans = None
    if trace:
        spans = Spans(ctx.sync)
        _wrap_spans(st.tb, spans)
    ex = _executor(st, root)
    first = st.next_record
    rep = {"counts": {}}
    with traced(trace) as (dt, k1, k2):
        ctx.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rep = _run_chunk(st, root, ex)
        ctx.sync()
        wall = time.perf_counter() - t0
    attempted = st.next_record - first
    success = rep["counts"].get("success", 0)
    st.window = {"first": first, "attempted": attempted, "root": root}
    out = {"attempted": attempted, "failed": attempted - success,
           "end_to_end": {"pairs_per_hour": (stats.rate_per_hour(success, wall), "pairs/h")}}
    if trace:
        pairs = sum(1 for n, *_ in spans.records if n == "flux_pair")
        out["reading"] = {"spans": spans, "trace": dt, "k1_shapes": k1.shapes,
                          "k2_shapes": k2.shapes, "window_s": wall, "units": success,
                          "model_flops": pairs * flux_flops.pair_flops(ctx.config, st.t5_len),
                          "span_groups": {"editor": EDITOR_SPANS, "scorers": SCORER_SPANS}}
        out["breakdown"] = dt.breakdown(spans, "executor")
    return out


def release(st: State) -> None:
    st.gate.__exit__(None, None, None)
    st.tb = st.zoo = None
    _flush()


def check(st: State) -> dict:
    """Readings of the sampled records' written sides against the
    reference's."""
    return check_records(st.ctx, st.window["root"], sampled(st))


def check_records(ctx, root: Path, recs) -> dict:
    """The readings of `recs`, written under `root` by a run of `ctx`'s
    seed, against the reference's pairs."""
    return synth_checks.synth_readings(*sides(ctx, root, recs)) if recs else {}


def sides(ctx, root: Path, recs) -> tuple[list, list]:
    """(the program's, the reference's) written sides of `recs`, input then
    edited for each record."""
    got = []
    for r in recs:
        stem = Path(r.key().replace("/", "_")).stem
        for side in ("input_img", "edited_img"):
            got.append(torch.as_tensor(ref_image.decode_png(
                (root / side / f"{stem}.png").read_bytes()), device=ctx.device))
    return got, reference_pairs(ctx, recs)


def sampled(st: State) -> list:
    """CHECKED records of the window that the ledger marks success, drawn
    from the seed."""
    w = st.window
    done = set()
    for line in (w["root"] / "ledger.jsonl").read_text().splitlines():
        row = json.loads(line)
        if row["status"] == "success":
            done.add(row["key"])
    ok = [r for r in st.records[w["first"]:w["first"] + w["attempted"]] if r.key() in done]
    if not ok:
        return []
    pick = traffic.rng(st.ctx.seed, "check")
    return [ok[int(i)] for i in pick.choice(len(ok), size=min(CHECKED, len(ok)),
                                            replace=False)]


def start_noise(cfg: dict, seed: int, device) -> torch.Tensor:
    """The first N(0, 1) draw of a `torch.Generator(seed)` on the device, at
    the canvas's latent shape."""
    lat = cfg["canvas"]["edit_size"] // cfg["canvas"]["latent_down"]
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((1, lat, lat, cfg["flux"]["in_channels"]), generator=g, device=device)


def _flush() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_pairs(ctx, recs) -> list:
    """Each record's (input, edited) sides from the fp32 reference, in order,
    T5 at the configuration's length whatever the program ran."""
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    served = weights.served_dtype(cfg)
    captions = [c for r in recs for c in (r.input, r.output)]
    noises = [start_noise(cfg, record_seed(seed, r.key()), dev) for r in recs for _ in (0, 1)]
    with checks.plain_fp32():
        t5 = blocks.reference_module(rflux.build("t5", cfg["t5"], served, "meta"),
                                     spec("t5", cfg), seed, "t5", dev)
        clip = weights.reference_module("clip_text", cfg["clip_text"], served, seed, dev)
        conds = rflux.encode_captions(t5, clip, cfg, captions, cfg["t5_len"], dev)
        t5 = clip = None
        _flush()
        flux = blocks.reference_module(rflux.build("flux", cfg["flux"], served, "meta"),
                                       spec("flux", cfg), seed, "flux", dev)
        lats = rflux.sample_latents(flux, cfg, conds, noises)
        flux = None
        _flush()
        vae = weights.reference_module("vae", cfg["flux_vae"], served, seed, dev, tag="flux_vae")
        return rflux.decode_images(vae, cfg, lats)
