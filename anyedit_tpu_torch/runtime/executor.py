"""The factory executor (counterpart of `anyedit_tpu/runtime/executor.py`).

Flow per record: pre_filter -> edit pipeline -> post_filter -> ledger, with
  * one resident Toolbox (each model built once and shared),
  * shard/resume through `RunLedger` (idempotent restart),
  * per-stage wall-clock counters (`StageTimer`),
  * an optional `torch.profiler` trace around the run.

Errors are contained per record and recorded with their reasons. A memo in
front of the grounder serves repeated (image, phrase, mode) calls: the
pre-scorer's object-ratio grounding and `color_alter`'s mask are one
GroundingDINO + SAM pass.

Chunk mode (`grounding_batch = N > 0`, with a toolbox whose `ground` has a
`.batch`) runs N records at a time: a loader thread decodes chunk k + 1
while chunk k runs (it calls only `load_image`, no CUDA); each chunk makes
one batched first grounding (`ground.batch`) and one batched CLIP forward
(`clip_image.batch`), pre-gates every record, batches the survivors'
unmasked IP2P edits by (steps, s_txt, s_img) (`ip2p.batch`), then runs each
record's pipeline against those caches. A batch call that raises leaves its
cache cold, prints a `# <stage> fell back to per-record` line on stderr, and
the records run per record. The ledger outcomes are per-record mode's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
import time
import traceback
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from anyedit_tpu_torch.core.ledger import RunLedger, Shard
from anyedit_tpu_torch.core.png import write_png
from anyedit_tpu_torch.core.rng import host_rng
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import global_, implicit
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.filters.post_filter import Scores, post_filter_decision
from anyedit_tpu_torch.filters.pre_filter import PreScores, pre_filter_decision
from anyedit_tpu_torch.filters.scorers import clip_score, directional_clip_score, ocr_text_match


class StageTimer:
    """Per-stage wall-clock accounting."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 3),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * self.totals[k] / max(1, self.counts[k]), 2)}
                for k in sorted(self.totals)}


@dataclasses.dataclass
class ExecutorConfig:
    output_root: str = "out"
    seed: int = 0
    save_images: bool = True
    run_pre_filter: bool = True
    run_post_filter: bool = True
    profile_trace_dir: Optional[str] = None   # torch.profiler trace output
    # > 0: chunk mode, this many records a chunk (see the module docstring)
    grounding_batch: int = 0
    # chunk mode only: batch the survivors' unmasked IP2P edits
    batch_edits: bool = True
    # chunk mode only: batch the first groundings (False grounds each
    # record through the memo; CLIP and the edits stay batched)
    batch_grounding: bool = True
    # force the edits' DDIM step count (the pipelines hardcode the
    # reference's production counts, edits/global_.py)
    ip2p_steps_override: Optional[int] = None


def _host(x) -> torch.Tensor:
    """A host tensor of a tensor (any device) or array: the scores are taken
    on the CPU, as the JAX executor takes them in numpy."""
    return torch.as_tensor(to_numpy(x))


# each edit type's FIRST tb.ground call: (record field of the phrase, mode),
# for the types `edits.registry` serves; a type gets its entry with its
# pipeline. Only these are batched ahead of the pipeline; re-detections on
# edited images always run live.
_FIRST_GROUND: dict[str, tuple[str, str]] = {
    "remove": ("edited_object", "merge"), "counting": ("edited_object", "count"),
    "add": ("edited_object", "merge"), "replace": ("edited_object", "merge"),
    "background_change": ("edited_object", "merge"),
    "color_alter": ("edited_object", "merge"),
    "appearance_alter": ("edited_object", "merge"),
    "material_alter": ("edited_object", "merge"),
    "resize": ("edited_object", "max"), "movement": ("edited_object", "max"),
    "relation": ("edited_object", "max"),
    "outpainting": ("edited_object", "merge"),
    "visual_bbox": ("edited_object", "merge"),
    "visual_reference": ("edited_object", "max"),
    "visual_material_transfer": ("edited_object", "max"),
    "material_transfer": ("edited_object", "max"),
}

# edit types whose pipeline makes exactly one unmasked full-frame ip2p call,
# with its (steps, s_txt, s_img), read from the pipelines' own constants.
# Masked calls (appearance_alter) stay per record: their mask is the
# pipeline's own.
_IP2P_EDIT: dict[str, tuple[int, float, float]] = {
    "color_alter": (global_.STEPS, global_.S_TXT, global_.S_IMG),
    "tone_transfer": (global_.STEPS, global_.S_TXT, global_.S_IMG),
    "style_change": (implicit.STEPS, implicit.S_TXT, implicit.S_IMG),
}

_NO_CACHE = object()   # "first grounding not computed yet"


def _first_ground_spec(rec) -> Optional[tuple[str, str, Optional[int]]]:
    """(phrase, mode, count_k) of the record's first grounding, or None."""
    spec = _FIRST_GROUND.get(rec.edit_type)
    if spec is None:
        return None
    phrase = getattr(rec, spec[0]) or (rec.input if rec.edit_type in ("outpainting", "visual_bbox")
                                       else None)
    if rec.edit_type == "background_change" and not phrase:
        phrase = "foreground object"
    if not phrase:
        return None
    return phrase, spec[1], rec.remove_number if spec[1] == "count" else None


def _load_chunk(chunk, load_image) -> dict:
    """record key -> image, or the exception its load raised (host only)."""
    out = {}
    for _, rec in chunk:
        try:
            out[rec.key()] = load_image(rec)
        except Exception as e:  # the record fails in the chunk, not the run
            out[rec.key()] = e
    return out


def _mark_error(ledger: RunLedger, rec, e: Exception) -> None:
    """A contained record failure, with its reason and the trace's end."""
    ledger.mark(rec, "failure", {"error": f"{type(e).__name__}: {e}",
                                 "trace": traceback.format_exc(limit=3)})


def _fell_back(stage: str, e: Exception) -> None:
    print(f"# {stage} fell back to per-record ({type(e).__name__}: {str(e)[:200]})",
          file=sys.stderr, flush=True)


@contextlib.contextmanager
def _profile(trace_dir: Optional[str]):
    """A `torch.profiler` trace of the block (the card's kernels too, where
    there is one) written to `trace_dir/trace.json`; nothing without a dir."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


class FactoryExecutor:
    def __init__(self, toolbox: Toolbox, cfg: ExecutorConfig | None = None,
                 pre_scorer: Optional[Callable] = None,
                 post_scorer: Optional[Callable] = None):
        """pre_scorer(record, image) -> PreScores;
        post_scorer(record, image, outcome) -> Scores.
        The defaults leave a score None (permissive) where its model slot
        is absent from the toolbox."""
        self.tb = toolbox
        self.cfg = cfg or ExecutorConfig()
        self.timer = StageTimer()
        self.pre_scorer = pre_scorer or self._default_pre_scorer
        self.post_scorer = post_scorer or self._default_post_scorer
        self._gcache: dict = {}    # chunk: (id(image), phrase, mode, count_k) -> result
        self._ccache: dict = {}    # chunk: id(image) -> batched CLIP image embedding
        self._ecache: dict = {}    # chunk: batched edits by (id(image), instruction, knobs, seed)
        self._gmemo: dict = {}     # grounding memo (record- or chunk-scoped)
        if self.tb.ground is not None:
            self._wrap_ground()
        if self.tb.ip2p is not None and hasattr(self.tb.ip2p, "_real"):
            # shed a previous executor's layer (shared toolbox)
            self.tb.ip2p = self.tb.ip2p._real
        if self.tb.ip2p is not None and (
                (self.cfg.grounding_batch and self.cfg.batch_edits
                 and getattr(self.tb.ip2p, "batch", None) is not None)
                or self.cfg.ip2p_steps_override):
            self._wrap_ip2p()

    def _wrap_ip2p(self) -> None:
        """Run every edit at `ip2p_steps_override` DDIM steps (when set), and
        serve the chunk's batched edits by (image identity, instruction,
        steps, scales, seed); masked or uncached calls go to the live editor."""
        real = self.tb.ip2p

        def ip2p(image, instruction, mask01, steps=50, s_txt=8.0, s_img=0.9, **kw):
            steps = self.cfg.ip2p_steps_override or steps
            if mask01 is None:
                hit = self._ecache.get((id(image), instruction, steps, s_txt, s_img,
                                        kw.get("seed", 0)))
                if hit is not None:
                    return hit
            return real(image, instruction, mask01, steps=steps, s_txt=s_txt,
                        s_img=s_img, **kw)

        ip2p._real = real
        ip2p.batch = getattr(real, "batch", None)
        self.tb.ip2p = ip2p

    def _wrap_ground(self) -> None:
        """Two caches in front of the live grounder: the chunk's batched
        first groundings (`_gcache`), and the memo: repeated (image, phrase,
        mode, count_k) calls within one record pass (one chunk in chunk
        mode) run GDINO + SAM once (the reference recomputes the same
        grounding in pre_filter and in the edit pipeline). Grounding is
        deterministic, so the memo keeps the semantics; a call on an edited
        image is fresh by construction (a new array). The memo value keeps
        the image, so an id() reused after garbage collection never aliases
        a stale entry.

        A previous executor's layer is unwrapped first: toolboxes are shared
        across executors, and stale memos must not stack up."""
        real = getattr(self.tb.ground, "_real", self.tb.ground)

        def ground(image, phrase, mode="merge", count_k=None):
            k = (id(image), phrase, mode, count_k)
            if k in self._gcache:
                return self._gcache[k]
            hit = self._gmemo.get(k)
            if hit is not None and hit[0] is image:
                return hit[1]
            g = real(image, phrase, mode=mode, count_k=count_k)
            self._gmemo[k] = (image, g)
            return g

        ground._real = real
        ground.batch = getattr(real, "batch", None)
        self.tb.ground = ground

    def _known_ground(self, image, spec):
        """The first grounding already computed for (image, spec): the
        chunk's batched result or the memo's (identity-guarded), else
        `_NO_CACHE`."""
        k = (id(image),) + spec
        if k in self._gcache:
            return self._gcache[k]
        hit = self._gmemo.get(k)
        return hit[1] if hit is not None and hit[0] is image else _NO_CACHE

    # ---- default scorers --------------------------------------------------
    def _default_pre_scorer(self, rec, image) -> PreScores:
        """Main pre-gate inputs (reference pre_filter.py:115-188): CLIP
        (image, caption), aesthetic MLP, grounded object-area ratio,
        background VQA for background_change. A field stays None
        (permissive) only when its model slot is absent."""
        h, w = image.shape[:2]
        s = PreScores(width=w, height=h)
        if self.tb.clip_image is not None and self.tb.clip_text is not None:
            s.clip = float(clip_score(_host(self._clip_image(image)),
                                      _host(self.tb.clip_text(rec.input))).squeeze())
        aesthetic = self.tb.extra.get("aesthetic")
        if aesthetic is not None:
            s.aesthetic = float(aesthetic(image))
        # object-area ratio via union_generation (pre_filter.py:164-170)
        if self.tb.ground is not None and rec.edited_object:
            g = self.tb.ground(image, rec.edited_object, mode="merge")
            if g is not None:
                s.object_ratio = float(g.union_ratio)
        if rec.edit_type == "background_change" and self.tb.vqa_yes_no is not None:
            bg = rec.extras.get("new background") or rec.output
            s.background_vqa_ok = not bool(self.tb.vqa_yes_no(
                image, f"Is the background of this image similar to {bg}?"))
        return s

    def _default_post_scorer(self, rec, image, outcome: EditOutcome) -> Scores:
        """Per-type predicate inputs (post_filter.py:15-79): CLIP,
        directional CLIP, pixel L1, detector existence, VQA, OCR match."""
        s = Scores()
        edited = outcome.edited
        src_img = outcome.input_image if outcome.input_image is not None else image
        if self.tb.clip_image is not None and self.tb.clip_text is not None \
                and edited is not None:
            ie_t = _host(self.tb.clip_image(edited))
            te_t = _host(self.tb.clip_text(rec.output))
            s.clip = float(clip_score(ie_t, te_t).squeeze())
            # directional CLIP (utils.py:284-301)
            ie_s = _host(self._clip_image(src_img))
            te_s = _host(self.tb.clip_text(rec.input))
            s.dir_clip = float(directional_clip_score(ie_s, ie_t, te_s, te_t).squeeze())
        if edited is not None and src_img.shape == edited.shape:
            # numpy's float32 mean, as the JAX executor takes it: the same
            # sum order, so the same bits (`l1_distance` sums as torch does)
            s.l1 = float(np.mean(np.abs(
                src_img.astype(np.float32) - edited.astype(np.float32))) / 255.0)
        # detector-based (non-)existence check in the edited image
        # (reference filter_tool/utils.py:212-276 object_detection)
        if self.tb.ground is not None and edited is not None:
            phrase = rec.new_object if rec.edit_type == "replace" else rec.edited_object
            if phrase and rec.edit_type in ("add", "remove", "counting", "replace"):
                g = self.tb.ground(edited, phrase, mode="merge")
                gm = None if g is None else to_numpy(g.mask)
                present = gm is not None and bool(gm.any())
                if present and outcome.mask is not None \
                        and rec.edit_type in ("remove", "counting"):
                    # must overlap the edited region to count (>= 0.2 mask-IoU
                    # rule); a Python bool, so the ledger's JSON can hold it
                    present = bool((gm & outcome.mask).sum() / max(1, gm.sum()) >= 0.2)
                s.object_present = present
        if edited is not None and self.tb.vqa_yes_no is not None:
            if rec.edit_type == "color_alter":
                # blip2_color (utils.py:55-75): the last word of the edit text
                words = re.findall(r"\w+", rec.edit)
                color = words[-1] if words else ""
                s.vqa_yes = bool(self.tb.vqa_yes_no(
                    edited, f"Is the color of {rec.edited_object} close to {color}?"))
            elif rec.edit_type == "background_change":
                bg = rec.extras.get("new background") or rec.output
                s.vqa_yes = bool(self.tb.vqa_yes_no(
                    edited, f"Is the background of this image similar to {bg}?"))
        if rec.edit_type == "textual_change" and self.tb.ocr is not None \
                and edited is not None and outcome.input_image is not None:
            quoted = re.findall(r'"([^"]+)"', rec.input) or [rec.input]
            quoted_out = re.findall(r'"([^"]+)"', rec.output) or [rec.output]
            s.ocr_match = (ocr_text_match(self.tb.ocr(outcome.input_image), quoted[0])
                           and ocr_text_match(self.tb.ocr(edited), quoted_out[0]))
        return s

    def _clip_image(self, image):
        """The chunk's batched CLIP embedding of `image`, else a live call."""
        z = self._ccache.get(id(image))
        return self.tb.clip_image(image) if z is None else z

    # ---- main loop ------------------------------------------------------
    def run(self, records: Sequence[InstructionRecord],
            load_image: Callable[[InstructionRecord], np.ndarray],
            shard: Shard | None = None,
            ledger_path: str | Path | None = None) -> dict:
        out_root = Path(self.cfg.output_root)
        ledger = RunLedger(ledger_path or out_root / "ledger.jsonl")
        for sub in ("edited_img", "input_img", "mask"):
            (out_root / sub).mkdir(parents=True, exist_ok=True)
        bs = self.cfg.grounding_batch
        with _profile(self.cfg.profile_trace_dir):
            if bs > 0 and getattr(self.tb.ground, "batch", None) is not None:
                self._run_chunks(list(ledger.pending(records, shard)), load_image,
                                 ledger, out_root, bs)
            else:
                for _, rec in ledger.pending(records, shard):
                    self._run_contained(rec, load_image, ledger, out_root)
        report = {"counts": ledger.counts(), "stages": self.timer.report()}
        ledger.close()
        return report

    def _run_contained(self, rec, load_image, ledger, out_root, **kw) -> None:
        try:
            self._run_one(rec, load_image, ledger, out_root, **kw)
        except Exception as e:  # contain per record, keep the reason
            _mark_error(ledger, rec, e)

    def _run_chunks(self, pending, load_image, ledger, out_root, bs: int) -> None:
        """Chunks of `bs` records, double-buffered: the loader thread decodes
        chunk k + 1 while chunk k runs."""
        chunks = [pending[c0:c0 + bs] for c0 in range(0, len(pending), bs)]
        if not chunks:
            return
        with ThreadPoolExecutor(max_workers=1) as loader:
            nxt = loader.submit(_load_chunk, chunks[0], load_image)
            for ci, chunk in enumerate(chunks):
                loaded = nxt.result()
                if ci + 1 < len(chunks):
                    nxt = loader.submit(_load_chunk, chunks[ci + 1], load_image)
                self._run_chunk(chunk, loaded, ledger, out_root)

    def _run_chunk(self, chunk, preloaded: dict, ledger, out_root) -> None:
        """Batch the chunk's first groundings and CLIP embeddings, pre-gate
        every record, batch the survivors' unmasked edits, then run each
        record's pipeline against those caches, in record order."""
        # the memo is chunk-scoped here: the pre-gate's groundings must
        # reach the records' pipelines; the identity guard keeps it safe
        self._gmemo.clear()
        loaded: dict[str, np.ndarray] = {}
        todo = []   # (image, phrase, mode, count_k)
        for _, rec in chunk:
            img = preloaded[rec.key()]
            if isinstance(img, Exception):
                ledger.mark(rec, "failure", {"error": f"{type(img).__name__}: {img}"})
                continue
            loaded[rec.key()] = img
            spec = _first_ground_spec(rec)
            if spec is not None:
                todo.append((img,) + spec)
        if todo and self.cfg.batch_grounding:
            try:
                with self.timer.stage("ground_batch"):
                    results = self.tb.ground.batch(
                        [t[0] for t in todo], [t[1] for t in todo],
                        modes=[t[2] for t in todo], count_ks=[t[3] for t in todo])
                for (img, phrase, mode, ck), g in zip(todo, results):
                    self._gcache[(id(img), phrase, mode, ck)] = g
            except Exception as e:  # e.g. out of memory: ground per record
                _fell_back("ground_batch", e)
        clip_batch = getattr(self.tb.clip_image, "batch", None)
        if clip_batch is not None and self.cfg.run_pre_filter and loaded:
            imgs = list(loaded.values())
            try:
                with self.timer.stage("clip_batch"):
                    zs = clip_batch(imgs)
                for img, z in zip(imgs, zs):
                    self._ccache[id(img)] = z
            except Exception as e:
                _fell_back("clip_batch", e)

        # the pre-gate over the chunk first (cheap with the caches warm), so
        # the batched edit runs for survivors only: the same decision on the
        # same scores as per-record mode, marked in record order
        pre_ok: dict[str, bool] = {}
        if self.cfg.run_pre_filter:
            for _, rec in chunk:
                if rec.key() not in loaded:
                    continue
                try:
                    with self.timer.stage("pre_filter"):
                        pre_ok[rec.key()] = self._pre_gate(rec, loaded[rec.key()])
                except Exception as e:
                    _mark_error(ledger, rec, e)
                    loaded.pop(rec.key())
        if self.cfg.batch_edits and getattr(self.tb.ip2p, "batch", None) is not None:
            self._batch_edits(chunk, loaded, pre_ok)

        for _, rec in chunk:
            if rec.key() in loaded:
                self._run_contained(rec, lambda r: loaded[r.key()], ledger, out_root,
                                    pre_ok=pre_ok.get(rec.key()), keep_memo=True)
        self._gcache.clear()
        self._ccache.clear()
        self._ecache.clear()

    def _batch_edits(self, chunk, loaded: dict, pre_ok: dict) -> None:
        """One `ip2p.batch` call per (steps, s_txt, s_img) over the pre-gate's
        survivors whose pipeline makes an unmasked edit, into `_ecache`.
        A record whose first grounding is known to have failed (from the
        batch or the memo: with `batch_grounding` off, or after a
        `ground_batch` fall-back, the pre-gate's grounding is in the memo)
        is left out: its pipeline stops before the edit."""
        groups: dict[tuple, list] = {}
        for _, rec in chunk:
            img = loaded.get(rec.key())
            knobs = _IP2P_EDIT.get(rec.edit_type)
            if img is None or knobs is None or pre_ok.get(rec.key()) is False:
                continue
            spec = _first_ground_spec(rec)
            if spec is not None:
                g = self._known_ground(img, spec)
                if g is not _NO_CACHE and (g is None or not bool(g.mask.any())):
                    continue
            steps = self.cfg.ip2p_steps_override or knobs[0]
            groups.setdefault((steps,) + knobs[1:], []).append((img, rec))
        for (steps, s_txt, s_img), items in groups.items():
            try:
                with self.timer.stage("edit_batch"):
                    outs = self.tb.ip2p.batch([im for im, _ in items],
                                              [r.edit for _, r in items], steps=steps,
                                              s_txt=s_txt, s_img=s_img,
                                              seeds=[0] * len(items))
            except Exception as e:  # the records edit one at a time
                _fell_back("edit_batch", e)
                continue
            for (im, r), o in zip(items, outs):
                self._ecache[(id(im), r.edit, steps, s_txt, s_img, 0)] = o

    def _pre_gate(self, rec: InstructionRecord, image) -> bool:
        """The pre-filter decision on the pre-scores and the record's first
        host uniform (`host_rng` is keyed by (seed, record key), so the
        chunk phase and the per-record path draw the same uniform). As in
        the JAX executor no `new_attr` is passed, so the colour rebalancing
        of `color_prefilter` never applies here."""
        rng = host_rng(self.cfg.seed, rec.key())
        ps = self.pre_scorer(rec, image)
        return pre_filter_decision(rec.edit_type, ps,
                                   edited_object=rec.edited_object or "",
                                   rng_uniform=float(rng.uniform()))

    def _run_one(self, rec: InstructionRecord, load_image, ledger: RunLedger,
                 out_root: Path, pre_ok: Optional[bool] = None,
                 keep_memo: bool = False) -> None:
        """One record; `pre_ok` is the chunk phase's pre-gate decision, and
        `keep_memo` keeps the chunk's memo (per-record mode clears it)."""
        if not keep_memo:
            self._gmemo.clear()
        rng = host_rng(self.cfg.seed, rec.key())
        with self.timer.stage("load"):
            image = load_image(rec)

        if self.cfg.run_pre_filter:
            if pre_ok is None:
                with self.timer.stage("pre_filter"):
                    pre_ok = self._pre_gate(rec, image)
            # the decision consumed the stream's first uniform, here or in
            # the chunk phase; the pipeline's rng continues after it
            rng.uniform()
            if not pre_ok:
                ledger.mark(rec, "filtered", {"stage": "pre"})
                return

        with self.timer.stage(f"edit/{rec.edit_type}"):
            outcome = get_pipeline(rec.edit_type)(self.tb, rec, image, rng)

        if not outcome.success:
            ledger.mark(rec, "failure", {"reason": outcome.reason})
            return

        if self.cfg.run_post_filter:
            with self.timer.stage("post_filter"):
                sc = self.post_scorer(rec, image, outcome)
                ok = post_filter_decision(rec.edit_type, sc)
            if not ok:
                ledger.mark(rec, "filtered",
                            {"stage": "post", "scores": dataclasses.asdict(sc)})
                return

        payload = {}
        if self.cfg.save_images and outcome.edited is not None:
            stem = Path(rec.image_file or rec.key().replace("/", "_")).stem
            ep = out_root / "edited_img" / f"{stem}.png"
            write_png(ep, outcome.edited)
            rec.edited_file = ep.name
            payload["edited_file"] = str(ep)
            if outcome.input_image is not None:
                ip = out_root / "input_img" / f"{stem}.png"
                write_png(ip, outcome.input_image)
                payload["input_file"] = str(ip)
            if outcome.mask is not None:
                mp = out_root / "mask" / f"{stem}.png"
                write_png(mp, outcome.mask.astype(np.uint8) * 255)
                payload["mask_file"] = str(mp)
            if outcome.visual_input is not None:
                # the visual_* families' product is the condition channel
                vdir = out_root / "visual_input"
                vdir.mkdir(parents=True, exist_ok=True)
                vp = vdir / f"{stem}.png"
                vi = outcome.visual_input
                if vi.dtype != np.uint8:
                    vi = np.clip(np.asarray(vi, np.float32), 0, 255).astype(np.uint8)
                write_png(vp, vi)
                rec.visual_input = vp.name
                payload["visual_input_file"] = str(vp)
        ledger.mark(rec, "success", payload)
