"""Grounded mask generation (counterpart of `anyedit_tpu/grounding/maskgen.py`).

Detector logits + boxes -> threshold -> phrase match -> NMS -> SAM masks ->
per-mode combination (max / merge / count). Everything array-shaped runs on
the tensors' device at a fixed box count; only the phrase bookkeeping is
host-side. Orders follow the JAX package: `top_k` is descending with ties
to the lower index (`jax.lax.top_k`), and argsort is stable.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from anyedit_tpu_torch.ops.nms import nms_fixed

MAX_BOXES = 32  # static candidate budget after thresholding


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, in
    `jax.lax.top_k`'s order: descending, equal values by ascending index
    (a stable sort; `torch.topk` leaves the order of ties open)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@dataclasses.dataclass
class GroundingResult:
    """Masks in canvas pixels. All tensors fixed-shape; `count` marks valid rows."""

    boxes: torch.Tensor        # (MAX_BOXES, 4) xyxy pixels
    scores: torch.Tensor       # (MAX_BOXES,)
    valid: torch.Tensor        # (MAX_BOXES,) bool
    masks: torch.Tensor        # (MAX_BOXES, H, W) bool
    mask: torch.Tensor         # (H, W) combined per mode
    bbox_mask: torch.Tensor    # (H, W) filled boxes of selected instances
    union_ratio: torch.Tensor  # scalar: union bbox area / image area

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


def select_boxes(logits: torch.Tensor, boxes_cxcywh: torch.Tensor,
                 span: tuple[int, int], img_hw: tuple[int, int],
                 box_threshold: float = 0.25, iou_threshold: float = 0.5,
                 max_boxes: int = MAX_BOXES):
    """Detector outputs -> (boxes_xyxy_px, scores, valid) for one phrase span.

    logits: (Q, T) raw phrase logits; boxes: (Q, 4) normalized cxcywh.
    Score = max sigmoid logit inside the phrase's token span, then the
    top `max_boxes` by score, then NMS; padded to `max_boxes` rows."""
    s, e = span
    h, w = img_hw
    probs = torch.sigmoid(logits.float())
    score = (probs[:, s:e] if e > s else probs).amax(dim=-1)
    cx, cy, bw, bh = boxes_cxcywh.float().unbind(-1)
    xyxy = torch.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                        (cx + bw / 2) * w, (cy + bh / 2) * h], dim=-1)
    k = min(max_boxes, score.shape[0])
    top_score, top_idx = top_k(score, k)
    top_boxes = xyxy[top_idx]
    keep = nms_fixed(top_boxes, top_score, iou_threshold=iou_threshold,
                     score_threshold=box_threshold)
    if k < max_boxes:
        pad = max_boxes - k
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_score = torch.nn.functional.pad(top_score, (0, pad))
        keep = torch.nn.functional.pad(keep, (0, pad))
    return top_boxes, top_score, keep


def combine_masks(masks: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  mode: str, count_k: int | None = None) -> torch.Tensor:
    """(N, H, W) mask logits > 0 -> combined (H, W) bool per reference mode:
    'max' = best-scoring instance, 'merge' = union of all,
    'count' = union of the top-k instances."""
    binm = (masks > 0) & valid[:, None, None]
    if mode == "max":
        best = torch.argmax(torch.where(valid, scores, -math.inf))
        return binm[best]
    if mode == "merge":
        return binm.any(dim=0)
    if mode == "count":
        k = count_k if count_k is not None else 1
        order = torch.argsort(torch.where(valid, -scores, math.inf), stable=True)
        sel = torch.zeros_like(valid)
        sel[order[:k]] = True
        return (binm & sel[:, None, None]).any(dim=0)
    raise ValueError(mode)


def boxes_to_mask(boxes: torch.Tensor, valid: torch.Tensor,
                  img_hw: tuple[int, int]) -> torch.Tensor:
    """Filled-rectangle mask of all valid boxes (the reference's bbox-mask)."""
    h, w = img_hw
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, :]
    x1, y1, x2, y2 = (t[:, None, None] for t in boxes.unbind(-1))
    inside = (xs[None] >= x1) & (xs[None] <= x2) & (ys[None] >= y1) & (ys[None] <= y2)
    return (inside & valid[:, None, None]).any(dim=0)


def union_area_ratio(boxes: torch.Tensor, valid: torch.Tensor,
                     img_hw: tuple[int, int]) -> torch.Tensor:
    """Area of the union bounding box of valid detections / image area
    (the pre-filter's object-size gate)."""
    h, w = img_hw
    big = torch.tensor([math.inf, math.inf, -math.inf, -math.inf],
                       dtype=boxes.dtype, device=boxes.device)
    masked = torch.where(valid[:, None], boxes, big.expand_as(boxes))
    x1, y1 = masked[:, 0].min(), masked[:, 1].min()
    x2, y2 = masked[:, 2].max(), masked[:, 3].max()
    area = (x2 - x1).clamp(0, w) * (y2 - y1).clamp(0, h)
    return torch.where(valid.any(), area / (h * w), torch.zeros_like(area))


def grounding_result(masks: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, img_hw: tuple[int, int], mode: str = "merge",
                     count_k: int | None = None) -> GroundingResult:
    return GroundingResult(
        boxes=boxes, scores=scores, valid=valid, masks=masks > 0,
        mask=combine_masks(masks, scores, valid, mode, count_k),
        bbox_mask=boxes_to_mask(boxes, valid, img_hw),
        union_ratio=union_area_ratio(boxes, valid, img_hw))
