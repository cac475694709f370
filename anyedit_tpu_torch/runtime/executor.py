"""The factory executor, per-record mode (counterpart of
`anyedit_tpu/runtime/executor.py`).

Flow per record: pre_filter -> edit pipeline -> post_filter -> ledger, with
  * one resident Toolbox (each model built once and shared),
  * shard/resume through `RunLedger` (idempotent restart),
  * per-stage wall-clock counters (`StageTimer`),
  * an optional `torch.profiler` trace around the run.

Errors are contained per record and recorded with their reasons. A
record-scoped memo in front of the grounder serves repeated (image, phrase,
mode) calls of one record pass: the pre-scorer's object-ratio grounding and
`color_alter`'s mask are one GroundingDINO + SAM pass. The JAX executor's
chunk mode (`grounding_batch > 0`: batched grounding, CLIP and edits) is
not ported yet; asking for it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time
import traceback
from collections import defaultdict
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from anyedit_tpu_torch.core.ledger import RunLedger, Shard
from anyedit_tpu_torch.core.png import write_png
from anyedit_tpu_torch.core.rng import host_rng
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox
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
    # >0 asks for the JAX executor's chunk mode, which is not ported yet
    grounding_batch: int = 0
    # force the edits' DDIM step count (the pipelines hardcode the
    # reference's production counts, edits/global_.py)
    ip2p_steps_override: Optional[int] = None


def _np(x) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _host(x) -> torch.Tensor:
    """A host tensor of a tensor (any device) or array: the scores are taken
    on the CPU, as the JAX executor takes them in numpy."""
    return torch.as_tensor(_np(x))


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
        if self.cfg.grounding_batch > 0:
            raise NotImplementedError(
                "FactoryExecutor: chunk mode (grounding_batch > 0) is not ported "
                "yet (ROADMAP slice 2c); use grounding_batch=0 for per-record mode")
        self.timer = StageTimer()
        self.pre_scorer = pre_scorer or self._default_pre_scorer
        self.post_scorer = post_scorer or self._default_post_scorer
        self._gmemo: dict = {}     # record-scoped grounding memo
        if self.tb.ground is not None:
            self._wrap_ground()
        if self.tb.ip2p is not None and hasattr(self.tb.ip2p, "_real"):
            # shed a previous executor's layer (shared toolbox)
            self.tb.ip2p = self.tb.ip2p._real
        if self.tb.ip2p is not None and self.cfg.ip2p_steps_override:
            self._wrap_ip2p()

    def _wrap_ip2p(self) -> None:
        """Run every edit at `ip2p_steps_override` DDIM steps."""
        real = self.tb.ip2p

        def ip2p(image, instruction, mask01, steps=50, s_txt=8.0, s_img=0.9, **kw):
            return real(image, instruction, mask01, steps=self.cfg.ip2p_steps_override,
                        s_txt=s_txt, s_img=s_img, **kw)

        ip2p._real = real
        self.tb.ip2p = ip2p

    def _wrap_ground(self) -> None:
        """The record memo in front of the live grounder: within one record
        pass, repeated (image, phrase, mode, count_k) calls run GDINO + SAM
        once (the reference recomputes the same grounding in pre_filter and
        in the edit pipeline). Grounding is deterministic, so the memo keeps
        the semantics; a call on an edited image is fresh by construction (a
        new array). The memo value keeps the image, so an id() reused after
        garbage collection never aliases a stale entry.

        A previous executor's layer is unwrapped first: toolboxes are shared
        across executors, and stale memos must not stack up."""
        real = getattr(self.tb.ground, "_real", self.tb.ground)

        def ground(image, phrase, mode="merge", count_k=None):
            k = (id(image), phrase, mode, count_k)
            hit = self._gmemo.get(k)
            if hit is not None and hit[0] is image:
                return hit[1]
            g = real(image, phrase, mode=mode, count_k=count_k)
            self._gmemo[k] = (image, g)
            return g

        ground._real = real
        self.tb.ground = ground

    # ---- default scorers --------------------------------------------------
    def _default_pre_scorer(self, rec, image) -> PreScores:
        """Main pre-gate inputs (reference pre_filter.py:115-188): CLIP
        (image, caption), aesthetic MLP, grounded object-area ratio,
        background VQA for background_change. A field stays None
        (permissive) only when its model slot is absent."""
        h, w = image.shape[:2]
        s = PreScores(width=w, height=h)
        if self.tb.clip_image is not None and self.tb.clip_text is not None:
            s.clip = float(clip_score(_host(self.tb.clip_image(image)),
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
            ie_s = _host(self.tb.clip_image(src_img))
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
                gm = None if g is None else _np(g.mask)
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

    # ---- main loop ------------------------------------------------------
    def run(self, records: Sequence[InstructionRecord],
            load_image: Callable[[InstructionRecord], np.ndarray],
            shard: Shard | None = None,
            ledger_path: str | Path | None = None) -> dict:
        out_root = Path(self.cfg.output_root)
        ledger = RunLedger(ledger_path or out_root / "ledger.jsonl")
        for sub in ("edited_img", "input_img", "mask"):
            (out_root / sub).mkdir(parents=True, exist_ok=True)
        with _profile(self.cfg.profile_trace_dir):
            for _, rec in ledger.pending(records, shard):
                try:
                    self._run_one(rec, load_image, ledger, out_root)
                except Exception as e:  # contain per record, keep the reason
                    ledger.mark(rec, "failure", {"error": f"{type(e).__name__}: {e}",
                                                 "trace": traceback.format_exc(limit=3)})
        report = {"counts": ledger.counts(), "stages": self.timer.report()}
        ledger.close()
        return report

    def _pre_gate(self, rec: InstructionRecord, image) -> bool:
        """The pre-filter decision on the pre-scores and the record's first
        host uniform. As in the JAX executor no `new_attr` is passed, so the
        colour rebalancing of `color_prefilter` never applies here."""
        rng = host_rng(self.cfg.seed, rec.key())
        ps = self.pre_scorer(rec, image)
        return pre_filter_decision(rec.edit_type, ps,
                                   edited_object=rec.edited_object or "",
                                   rng_uniform=float(rng.uniform()))

    def _run_one(self, rec: InstructionRecord, load_image, ledger: RunLedger,
                 out_root: Path) -> None:
        self._gmemo.clear()     # the memo is record-scoped
        rng = host_rng(self.cfg.seed, rec.key())
        with self.timer.stage("load"):
            image = load_image(rec)

        if self.cfg.run_pre_filter:
            with self.timer.stage("pre_filter"):
                ok = self._pre_gate(rec, image)
            # the decision consumed the stream's first uniform; the
            # pipeline's rng continues after it
            rng.uniform()
            if not ok:
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
