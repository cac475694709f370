"""The factory driver: `FactoryExecutor.run` in chunk mode on the toolbox that
`python -m anyedit_tpu_torch run --edit-type <type> --ground-batch <chunk>`
builds, records and images from the traffic file, both filter gates forced
open and the grounder answering with the record's box
(`harness/gates.py`).

Set-up builds the zoo (the IP2P slot's UNet, VAE and CLIP text tower carry
the benchmark's seeded weights), writes the traffic's images and runs one
chunk to warm every shape. The window calls `run` once per chunk, back to
back, so that a chunk starts only while the window is open; the chunk in
flight when it closes finishes and counts, and the window ends with a
synchronise. pairs_per_hour = records marked success x 3600 / window
seconds.

The check takes, for each row of the batched edit's bucket, one record of
that row that succeeded in the window (drawn from the seed), reads its pair
as written (`edited_img/<stem>.png`) and compares it with the reference's
pair of the same image, instruction, box and start latents."""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path

import torch

from portbench.harness import checks, flops, gates, stats, traffic, weights
from portbench.harness.trace import Spans, traced
from portbench.reference import edit as ref_edit, image as ref_image

SCORER_SPANS = ("clip_image", "clip_text", "aesthetic", "vqa")
EDITOR_SPANS = ("ip2p",)
GROUND_SPANS = ("ground",)
# the edit types whose toolbox has the IP2P editor (`cli.py::cmd_run`)
IP2P_TYPES = ("color_alter", "tone_transfer", "style_change")


def widths(tower, dtype) -> dict:
    """A tower's config dataclass as the configuration file writes it:
    nested dataclasses as objects, tuples as lists, without its dtypes,
    each of which must be `dtype`."""
    out = {}
    for f in dataclasses.fields(tower):
        v = getattr(tower, f.name)
        if f.name == "dtype":
            if v != dtype:
                raise ValueError(f"{type(tower).__name__} is served in {v}, the "
                                 f"configuration states {dtype}")
        elif dataclasses.is_dataclass(v):
            out[f.name] = widths(v, dtype)
        else:
            out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def zoo_config(cfg: dict):
    """The program's ZooConfig as the configuration file states it: the
    editor's UNet, VAE and CLIP text tower built from the file's widths,
    and every tower under the file's "towers" checked against the zoo's
    own (a program whose towers differ from the file is refused, so the
    widths run are always the file's)."""
    from anyedit_tpu_torch.core.config import CanvasConfig
    from anyedit_tpu_torch.runtime import zoo as zoo_mod

    base = zoo_mod.ZooConfig() if cfg["zoo_base"] == "production" else zoo_mod.tiny_zoo_config()
    dt = weights.served_dtype(cfg)
    for name, want in cfg["towers"].items():
        got = widths(getattr(base, name), dt)
        if got != want:
            raise ValueError(f"the program's {name} tower {got} is not the configuration's "
                             f"{want}")
    r = dataclasses.replace
    tup = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["unet"].items()}
    vae = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vae"].items()}
    return r(base, ip2p_unet=r(base.ip2p_unet, dtype=dt, **tup), vae=r(base.vae, dtype=dt, **vae),
             text=r(base.text, dtype=dt, **cfg["clip_text"]),
             canvas=CanvasConfig(**cfg["canvas"]), box_threshold=cfg["box_threshold"],
             edit_batch_bucket=cfg["edit_batch_bucket"])


def install_ip2p_weights(zoo, cfg: dict, seed: int, quant: bool = False) -> None:
    """Put the benchmark's seeded UNet, VAE and CLIP text weights into the
    zoo's IP2P slot before it is built (the zoo keeps each built model under
    its slot name; a model found there is not built again). With `quant`,
    the UNet is the program's W8A8 module quantized from those weights, as
    the zoo quantizes a float checkpoint."""
    from anyedit_tpu_torch.models.clip import CLIPTextEncoder
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    from anyedit_tpu_torch.models.vae import AutoencoderKL
    from anyedit_tpu_torch.ops.quant import quantize_state_dict
    from anyedit_tpu_torch.schedulers import make_noise_schedule

    zc, dev, served = zoo.cfg, zoo.device, weights.served_dtype(cfg)
    if {"ip2p_core", "vae", "clip_text"} & set(zoo._cache):
        raise RuntimeError("the IP2P slot was built before the benchmark's weights went in")
    w = weights.program_weights("unet", cfg["unet"], served, seed, dev)
    if quant:
        unet = UNet2DCondition(dataclasses.replace(zc.ip2p_unet, quant=True), device="meta")
        qsd = quantize_state_dict(unet, {k: v.float() for k, v in w.items()})
        unet.load_state_dict({k: v.to(dev) for k, v in qsd.items()}, strict=True, assign=True)
    else:
        unet = UNet2DCondition(zc.ip2p_unet, device=dev)
        weights.load_into(unet, w)
    del w
    vae = AutoencoderKL(zc.vae, device=dev)
    weights.load_into(vae, weights.program_weights("vae", cfg["vae"], served, seed, dev))
    text = CLIPTextEncoder(zc.text, device=dev)
    weights.load_into(text, weights.program_weights("clip_text", cfg["clip_text"], served,
                                                    seed, dev))
    for m in (unet, vae, text):
        m.eval().requires_grad_(False)
    zoo._cache.update({"ip2p_core": (unet, make_noise_schedule(device=dev)),
                       "vae": vae, "clip_text": text})


def build_toolbox(zoo, edit_type: str):
    """`cmd_run`'s toolbox for one edit type."""
    from anyedit_tpu_torch.runtime.zoo import SLOTS_FOR_EDIT_TYPE
    slots = list(SLOTS_FOR_EDIT_TYPE.get(edit_type, ())) + ["clip", "aesthetic"]
    if edit_type in ("background_change", "color_alter"):
        slots.append("vqa")
    return zoo.toolbox(with_diffusion=edit_type in IP2P_TYPES, slots=slots)


@dataclasses.dataclass
class State:
    ctx: object
    zoo: object
    tb: object
    sources: gates.SourceImages
    load_image: object
    records: list
    pool: list
    gate: object
    next_record: int = 0
    window: dict = dataclasses.field(default_factory=dict)


def setup(ctx, quant: bool = False) -> State:
    from anyedit_tpu_torch.grounding.maskgen import MAX_BOXES, grounding_result
    from anyedit_tpu_torch.runtime import executor as ex_mod
    from anyedit_tpu_torch.runtime.zoo import ModelZoo

    cfg, tr = ctx.config, ctx.traffic
    zoo = ModelZoo(zoo_config(cfg), device=ctx.device, seed=ctx.seed)
    install_ip2p_weights(zoo, cfg, ctx.seed, quant)
    tb = build_toolbox(zoo, tr["edit_type"])
    sources = gates.SourceImages()
    tb.ground = gates.ground_answers(tb.ground, sources, grounding_result, MAX_BOXES,
                                     zoo.device)
    gate = gates.gates_open(ex_mod)
    gate.__enter__()
    st = State(ctx, zoo, tb, sources, None, [], [], gate)
    _traffic(st)
    _run_chunk(st, ctx.workdir / "warmup", None)            # every shape, once
    ctx.sync()
    return st


def _traffic(st: State) -> None:
    """The seed's records and images under the run's directory."""
    from anyedit_tpu_torch.cli import record_loaders
    from anyedit_tpu_torch.core.schema import InstructionRecord

    root = st.ctx.workdir / "images"
    root.mkdir(parents=True, exist_ok=True)
    st.records = [InstructionRecord(**r)
                  for r in traffic.factory_records(st.ctx.traffic, st.ctx.seed, root)]
    st.pool = [ref_image.decode_png(p.read_bytes()) for p in sorted((root / "pool").glob("*.png"))]
    st.load_image = st.sources.loader(
        record_loaders(root, st.zoo.cfg.canvas.edit_size)["load_image"])
    st.next_record = 0


def reseed(st: State, seed: int, workdir: Path, quant: bool = False) -> None:
    """The same built toolbox with the weights and traffic of another seed
    (the control's calibration reads a dozen seeds in one process)."""
    from anyedit_tpu_torch.ops.quant import quantize_state_dict

    cfg, c, dev = st.ctx.config, st.zoo._cache, st.zoo.device
    served = weights.served_dtype(cfg)
    st.ctx.seed, st.ctx.workdir = seed, workdir
    unet = c["ip2p_core"][0]
    w = weights.program_weights("unet", cfg["unet"], served, seed, dev)
    if quant:
        qsd = quantize_state_dict(unet, {k: v.float() for k, v in w.items()})
        unet.load_state_dict({k: v.to(dev) for k, v in qsd.items()}, strict=True)
    else:
        weights.load_into(unet, w)
    for k in ("vae", "clip_text"):
        weights.load_into(c[k], weights.program_weights(k, cfg[k], served, seed, dev))
    _traffic(st)


def _executor(st: State, root: Path):
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor
    # "ip2p_steps_override" is for the tests' tiny traffic only: the cells
    # run the pipelines' own step counts
    return FactoryExecutor(st.tb, ExecutorConfig(
        output_root=str(root), seed=st.ctx.seed, grounding_batch=st.ctx.traffic["chunk"],
        ip2p_steps_override=st.ctx.traffic.get("ip2p_steps_override")))


def _run_chunk(st: State, root: Path, ex) -> dict:
    n = st.ctx.traffic["chunk"]
    chunk = st.records[st.next_record:st.next_record + n]
    if len(chunk) < n:
        raise RuntimeError("the traffic file's records ran out inside the window")
    st.next_record += n
    ex = ex or _executor(st, root)
    rep = ex.run(chunk, st.load_image, ledger_path=root / "ledger.jsonl")
    st.sources.clear()
    return rep


def _wrap_spans(tb, spans: Spans) -> None:
    """Spans around the toolbox's slots, beneath the executor's own layer."""
    def real(fn):
        return getattr(fn, "_real", fn)

    def edit_info(a, k):
        return {"records": len(a[0]) if isinstance(a[0], list) else 1, "steps": k["steps"]}
    tb.ground = spans.wrap(real(tb.ground), "ground")
    tb.ip2p = spans.wrap(real(tb.ip2p), "ip2p", edit_info)
    tb.clip_image = spans.wrap(tb.clip_image, "clip_image")
    tb.clip_text = spans.wrap(tb.clip_text, "clip_text")
    tb.vqa_yes_no = spans.wrap(tb.vqa_yes_no, "vqa")
    if "aesthetic" in tb.extra:
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
        edit_flops = sum(flops.ip2p_edit_flops(ctx.config, i["records"], i["steps"])
                         for n, _, _, i in spans.records if n == "ip2p")
        out["reading"] = {"spans": spans, "trace": dt, "k1_shapes": k1.shapes,
                          "k2_shapes": k2.shapes, "window_s": wall, "units": success,
                          "model_flops": edit_flops,
                          "span_groups": {"grounding": GROUND_SPANS, "editor": EDITOR_SPANS,
                                          "scorers": SCORER_SPANS}}
        out["breakdown"] = dt.breakdown(spans, "executor")
    return out


def release(st: State) -> None:
    st.gate.__exit__(None, None, None)
    st.tb = st.zoo = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(st: State) -> dict:
    """Readings of the sampled pairs against the reference's pairs."""
    recs = sampled(st)
    if not recs:
        return {}
    imgs = [image_of(st, r) for r in recs]
    root = st.window["root"] / "edited_img"
    got = [torch.as_tensor(ref_image.decode_png(
        (root / (Path(r.image_file).stem + ".png")).read_bytes()), device=st.ctx.device)
        for r in recs]
    return checks.pair_readings(imgs, got, reference_pairs(st, recs))


def sampled(st: State) -> list:
    """Records of the window that the ledger marks success: for each row of
    the batched edit's bucket (a record's place in its chunk modulo
    `edit_batch_bucket`), one of that row's, drawn from the seed."""
    w = st.window
    done = _successes(w["root"] / "ledger.jsonl")
    chunk, bucket = st.ctx.traffic["chunk"], st.ctx.config["edit_batch_bucket"]
    rows: dict[int, list] = {}
    for i, r in enumerate(st.records[w["first"]:w["first"] + w["attempted"]]):
        if r.key() in done:
            rows.setdefault(i % chunk % bucket, []).append(r)
    pick = traffic.rng(st.ctx.seed, "check")
    return [rows[k][int(pick.integers(len(rows[k])))] for k in sorted(rows)]


def image_of(st: State, rec) -> torch.Tensor:
    """The record's source image (its pool image) on the device."""
    return torch.as_tensor(st.pool[int(rec.image_file[1:6]) % len(st.pool)],
                           device=st.ctx.device)


def reference_pairs(st: State, recs) -> list:
    """The reference's pairs of `recs`, in fp32."""
    ctx = st.ctx
    cfg, dev, et = ctx.config, ctx.device, ctx.traffic["edit_type"]
    if et != "color_alter":
        raise ValueError(f"the reference has no {et} pipeline")
    imgs = [image_of(st, r) for r in recs]
    boxes = [gates.quarter_box(*x.shape[:2]) for x in imgs]
    with checks.plain_fp32():
        nets = {k: weights.reference_module(k, cfg[k], weights.served_dtype(cfg), ctx.seed, dev)
                for k in ("unet", "vae", "clip_text")}
        masks = []
        for x, (y0, y1, x0, x1) in zip(imgs, boxes):
            m = torch.zeros(x.shape[:2], dtype=torch.bool, device=dev)
            m[y0:y1, x0:x1] = True
            masks.append(m)
        lat = cfg["canvas"]["edit_size"] // cfg["canvas"]["latent_down"]
        g = torch.Generator(device=dev).manual_seed(0)
        init = torch.randn((1, lat, lat, cfg["vae"]["latent_channels"]), generator=g,
                           device=dev).expand(len(recs), -1, -1, -1)
        ca = cfg["color_alter"]
        return ref_edit.color_alter_pairs(nets, cfg, imgs, [r.edit for r in recs], masks,
                                          init, ca["steps"], ca["s_txt"], ca["s_img"])


def _successes(ledger: Path) -> set:
    import json
    out = set()
    for line in ledger.read_text().splitlines():
        row = json.loads(line)
        if row["status"] == "success":
            out.add(row["key"])
    return out

