"""Fixed-size non-maximum suppression (counterpart of `anyedit_tpu/ops/nms.py`).

A static box count and a keep mask instead of a dynamic index list, so the
loop runs on the tensors' device without a host round trip.
"""

from __future__ import annotations

import math

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix for xyxy boxes: a (N, 4) x b (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.5,
              score_threshold: float = -math.inf) -> torch.Tensor:
    """Greedy NMS over a fixed N. Returns the bool keep-mask (N,).

    Boxes scoring at or below `score_threshold` are never selected. Each of
    the N rounds keeps the best live box (the lowest index among equal
    scores, as `jnp.argmax` picks it) and kills it and every box that
    overlaps it by more than `iou_threshold`."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    alive = scores > score_threshold
    keep = torch.zeros_like(alive)
    ar = torch.arange(n, device=boxes.device)
    neg_inf = torch.tensor(-math.inf, dtype=scores.dtype, device=scores.device)
    for _ in range(n):
        idx = torch.argmax(torch.where(alive, scores, neg_inf))
        any_alive = alive.any()
        chosen = ar == idx
        keep = keep | (chosen & any_alive)
        suppress = (iou[idx] > iou_threshold) | chosen
        alive = alive & ~(suppress & any_alive)
    return keep
