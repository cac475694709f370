"""Outpainting pair synthesis (counterpart of `anyedit_tpu/edits/outpainting.py`).

No diffusion: pick a grounded object whose box covers 10-50 % of the image
and keeps off its borders, crop a window around it expanded by 10 % on each
side as the *input* image; the full frame is the *edited* target; the
instruction is a template draw.
"""

from __future__ import annotations

import numpy as np

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy

OUTPAINT_TEMPLATES = (
    "Outpaint the image as you can",
    "Imagine the whole scene from this part",
    "Complete the image as you can",
)


def select_crop(boxes: np.ndarray, valid: np.ndarray, img_hw: tuple[int, int],
                area_lo: float = 0.10, area_hi: float = 0.50,
                margin: int = 5) -> tuple[int, int, int, int] | None:
    """The first valid box with an area ratio in [lo, hi] that keeps
    `margin` pixels off every border, rounded to integer xyxy."""
    h, w = img_hw
    for box, ok in zip(boxes, valid):
        if not ok:
            continue
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        area = max(0, x2 - x1) * max(0, y2 - y1) / (h * w)
        if not (area_lo <= area <= area_hi):
            continue
        if x1 < margin or y1 < margin or x2 > w - margin or y2 > h - margin:
            continue
        return x1, y1, x2, y2
    return None


def outpainting(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                rng: np.random.Generator) -> EditOutcome:
    g = tb.ground(image, rec.edited_object or rec.input, mode="merge")
    if g is None:
        return EditOutcome(False, reason="grounding failed")
    box = select_crop(to_numpy(g.boxes), to_numpy(g.valid), image.shape[:2])
    if box is None:
        return EditOutcome(False, reason="no suitable crop box")
    x1, y1, x2, y2 = box
    h, w = image.shape[:2]
    ex, ey = int(0.1 * (x2 - x1)), int(0.1 * (y2 - y1))
    x1, y1 = max(0, x1 - ex), max(0, y1 - ey)
    x2, y2 = min(w, x2 + ex), min(h, y2 + ey)
    rec.edit = str(rng.choice(OUTPAINT_TEMPLATES))
    return EditOutcome(True, edited=image, input_image=image[y1:y2, x1:x2])
