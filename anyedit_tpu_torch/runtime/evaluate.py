"""Dataset-quality evaluation over edited pairs (`python -m
anyedit_tpu_torch eval`; the counterpart of `anyedit_tpu/runtime/evaluate.py`).

A pair is good iff it passes the post-filter predicate table built from
the CLIP / directional-CLIP / L1 scorers. Given a finished run directory
(ledger + saved images), this recomputes the metric suite per pair and
aggregates per edit type:

  * clip_out   - CLIP(edited image, output caption)
  * clip_in    - CLIP(input image, input caption)
  * clip_im    - input <-> edited image cosine
  * dir_clip   - directional CLIP
  * l1         - mean pixel L1 in [0, 1]
  * ssim       - structural similarity
  * dino_sim   - DINOv2 CLS cosine between input and edited (when the
                 toolbox carries the `dino_embed` slot)
  * pass_rate  - fraction of pairs that clear the post-filter thresholds
                 of their edit type

Images are read through `core/image.py::load_rgb` (PNG without Pillow).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.filters.post_filter import Scores, post_filter_decision

# Edit types whose post-filter predicate is fully computable from the
# (clip, dir_clip, l1) evidence this harness produces; the other gated
# types need detector, VQA or OCR evidence, so `passes` stays None for them.
EVAL_GATED = frozenset({"action_change", "appearance_alter",
                        "material_alter", "tone_transfer"})


@dataclasses.dataclass
class PairMetrics:
    key: str
    edit_type: str
    clip_out: Optional[float] = None
    clip_in: Optional[float] = None
    clip_im: Optional[float] = None
    dir_clip: Optional[float] = None
    l1: Optional[float] = None
    ssim: Optional[float] = None
    dino_sim: Optional[float] = None
    passes: Optional[bool] = None


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _resize_pair(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """L1 / SSIM need same-shape pairs: b resized to a (bilinear)."""
    from anyedit_tpu_torch.ops.resize import resize_image
    if a.shape == b.shape:
        return a, b
    h, w = a.shape[:2]
    b2 = resize_image(torch.from_numpy(np.asarray(b, np.float32))[None], h, w, "bilinear")[0]
    return a, b2.numpy().astype(b.dtype)


def evaluate_pairs(tb, entries: list[dict],
                   loader: Callable[[InstructionRecord, dict],
                                    tuple[np.ndarray, np.ndarray]]) -> dict:
    """Score (input, edited) pairs. `entries` are success-ledger lines
    ({"key", "record", "payload"}); `loader(record, payload)` returns the
    (input_u8, edited_u8) images. Returns {"pairs": [...], "per_type":
    {...}, "overall": {...}}."""
    from anyedit_tpu_torch.filters.scorers import directional_clip_score, l1_distance, ssim

    per: list[PairMetrics] = []
    for e in entries:
        rec = InstructionRecord.from_json(e["record"])
        src, dst = loader(rec, e.get("payload") or {})
        m = PairMetrics(key=e["key"], edit_type=rec.edit_type)

        if tb.clip_image is not None and tb.clip_text is not None:
            ie_s, ie_t = _host(tb.clip_image(src)), _host(tb.clip_image(dst))
            te_s, te_t = _host(tb.clip_text(rec.input)), _host(tb.clip_text(rec.output))
            m.clip_in = float((ie_s * te_s).sum())
            m.clip_out = float((ie_t * te_t).sum())
            m.clip_im = float((ie_s * ie_t).sum())
            m.dir_clip = float(directional_clip_score(
                *(torch.from_numpy(x) for x in (ie_s, ie_t, te_s, te_t))).reshape(-1)[0])

        dino = getattr(tb, "extra", {}).get("dino_embed")
        if dino is not None:
            m.dino_sim = float((_host(dino(src)) * _host(dino(dst))).sum())

        a, b = _resize_pair(src, dst)
        a01 = torch.from_numpy(a.astype(np.float32)[None] / 255.0)   # scorers take (N, ...)
        b01 = torch.from_numpy(b.astype(np.float32)[None] / 255.0)
        m.l1 = float(l1_distance(a01, b01).reshape(-1)[0])
        m.ssim = float(ssim(a01, b01).reshape(-1)[0])
        sc = Scores(clip=m.clip_out, dir_clip=m.dir_clip, l1=m.l1)
        m.passes = bool(post_filter_decision(rec.edit_type, sc)) \
            if rec.edit_type in EVAL_GATED else None
        per.append(m)

    def agg(ms: list[PairMetrics]) -> dict:
        out: dict = {"count": len(ms)}
        for f in ("clip_out", "clip_in", "clip_im", "dir_clip", "l1", "ssim", "dino_sim"):
            vals = [getattr(x, f) for x in ms if getattr(x, f) is not None]
            if vals:
                out[f] = {"mean": round(float(np.mean(vals)), 4),
                          "median": round(float(np.median(vals)), 4)}
        gated = [x.passes for x in ms if x.passes is not None]
        if gated:
            out["pass_rate"] = round(float(np.mean(gated)), 4)
        return out

    by_type: dict[str, list[PairMetrics]] = {}
    for m in per:
        by_type.setdefault(m.edit_type, []).append(m)
    return {
        "pairs": [dataclasses.asdict(m) for m in per],
        "per_type": {t: agg(ms) for t, ms in sorted(by_type.items())},
        "overall": agg(per),
    }


def run_dir_entries(run_dir: str | Path) -> list[dict]:
    """Success entries (with image payloads) from a run's ledger.jsonl."""
    out = []
    with open(Path(run_dir) / "ledger.jsonl") as f:
        for line in f:
            obj = json.loads(line)
            if obj.get("status") == "success":
                out.append(obj)
    return out


def _resolve(p: str, run_dir: Path, subdir: str) -> Path:
    """A payload image path as the executor wrote it (`out_root/<subdir>/
    <name>`, out_root verbatim from the run's --output: absolute or
    relative to the run-time CWD), else the file's place inside run_dir."""
    cand = Path(p)
    if cand.is_absolute() or cand.exists():
        return cand
    inside = run_dir / subdir / cand.name
    if inside.exists():
        return inside
    raise FileNotFoundError(f"cannot resolve {p!r}: tried CWD-relative and {inside}")


def default_loader(run_dir: str | Path, image_root: Optional[str | Path]):
    """Pair loader for a run directory: edited from payload.edited_file,
    input from payload.input_file when the pipeline synthesized one (add /
    outpainting), else the original image under image_root."""
    from anyedit_tpu_torch.core.image import load_rgb
    run_dir = Path(run_dir)

    def load(rec: InstructionRecord, payload: dict):
        ep = payload.get("edited_file")
        if ep is None:
            raise FileNotFoundError(
                f"ledger entry for {rec.key()} has no edited_file: was the run "
                "executed with save_images=True?")
        dst = load_rgb(_resolve(ep, run_dir, "edited_img"))
        ip = payload.get("input_file")
        if ip is not None:
            src = load_rgb(_resolve(ip, run_dir, "input_img"))
        else:
            if image_root is None:
                raise FileNotFoundError(
                    f"{rec.key()}: no synthesized input image in the ledger and no "
                    "--image-root given")
            src = load_rgb(Path(image_root) / rec.image_file)
        return src, dst

    return load
