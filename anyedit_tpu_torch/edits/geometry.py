"""Geometric edits: resize / movement / relation (counterpart of
`anyedit_tpu/edits/geometry.py`).

Ground the object, check it is not occluded, LaMa-erase it, paste its pixels
back shifted or rescaled, and synthesize the instruction text from the
record's numpy generator, drawn in the JAX pipeline's order so that the text
comes out the same. Host-side numpy geometry; the grounder's tensors come
over with `to_numpy`, the dilation runs on the mask's device, and the
rescale of a pasted object is the port's bilinear antialiased resize in fp32
on the CPU.

One departure from the JAX pipeline: the occlusion check reads the valid
detections other than the selected one, where the JAX `resize_movement`
reads `g.masks[1:]`, every candidate row, kept or not (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.local import _found, _lama_u8, _tiered_dilate_np
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.ops.resize import resize_image

MOVE_WORDS = ("move", "shift", "relocate")
LEFT_WORDS = ("left", "to the left")
RIGHT_WORDS = ("right", "to the right")
BIGGER_WORDS = ("bigger", "larger", "zoom in the")
SMALLER_WORDS = ("smaller", "tinier", "zoom out the")


def _bbox_of_mask(mask: np.ndarray) -> tuple[int, int, int, int] | None:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def check_occlusion(obj_mask: np.ndarray, other_masks: np.ndarray | None,
                    thresh: float = 0.05) -> bool:
    """True = occluded (move/resize unsafe): some other mask covers more
    than `thresh` of the object (check_occlusion_by_segmentation,
    move_resize_pipeline_tool.py:54)."""
    if other_masks is None or len(other_masks) == 0:
        return False
    overlap = (obj_mask[None] & other_masks).sum(axis=(1, 2))
    return bool(np.any(overlap / max(1, obj_mask.sum()) > thresh))


def _other_detections(g) -> np.ndarray:
    """The masks of the valid detections other than the one "max" selects."""
    valid = to_numpy(g.valid).astype(bool)
    scores = np.where(valid, to_numpy(g.scores).astype(np.float32), -np.inf)
    valid[int(np.argmax(scores))] = False
    return to_numpy(g.masks)[valid]


def _resize01(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) fp32 -> (h, w, C): bilinear with antialiasing, fp32."""
    return resize_image(torch.from_numpy(a), h, w, "bilinear").numpy()


def paste_object(background: np.ndarray, obj_pixels: np.ndarray,
                 obj_mask: np.ndarray, dst_xy: tuple[int, int],
                 scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Paste the object's (pixels, mask) centred at dst, scaled, clipped to
    the canvas (`resize_cropimage2image`, move_resize_pipeline_tool.py:248).
    Returns (image uint8, the pasted mask)."""
    h, w = background.shape[:2]
    bb = _bbox_of_mask(obj_mask)
    assert bb is not None
    x1, y1, x2, y2 = bb
    crop = obj_pixels[y1:y2, x1:x2].astype(np.float32)
    cmask = obj_mask[y1:y2, x1:x2].astype(np.float32)
    if scale != 1.0:
        nh = max(1, int(round((y2 - y1) * scale)))
        nw = max(1, int(round((x2 - x1) * scale)))
        crop = _resize01(crop, nh, nw)
        cmask = _resize01(cmask[..., None], nh, nw)[..., 0]
    ch, cw = cmask.shape
    cx, cy = dst_xy
    ox1 = int(round(cx - cw / 2))
    oy1 = int(round(cy - ch / 2))
    sx1, sy1 = max(0, -ox1), max(0, -oy1)
    dx1, dy1 = max(0, ox1), max(0, oy1)
    dx2, dy2 = min(w, ox1 + cw), min(h, oy1 + ch)
    if dx2 <= dx1 or dy2 <= dy1:
        return background, np.zeros(background.shape[:2], bool)
    out = background.astype(np.float32).copy()
    sub_m = (cmask[sy1:sy1 + dy2 - dy1, sx1:sx1 + dx2 - dx1] > 0.5)[..., None]
    out[dy1:dy2, dx1:dx2] = np.where(
        sub_m, crop[sy1:sy1 + dy2 - dy1, sx1:sx1 + dx2 - dx1], out[dy1:dy2, dx1:dx2])
    new_mask = np.zeros(background.shape[:2], bool)
    new_mask[dy1:dy2, dx1:dx2] = sub_m[..., 0]
    return np.clip(out, 0, 255).astype(np.uint8), new_mask


def resize_movement(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                    rng: np.random.Generator) -> EditOutcome:
    """movement: paste shifted by dx in +-[50, 120]; resize: scale 0.7 or
    1.3 (move_resize_pipeline_tool.py:333-437)."""
    g = tb.ground(image, rec.edited_object, mode="max")
    if not _found(g):
        return EditOutcome(False, reason="object not found")
    mask = to_numpy(g.mask)
    if check_occlusion(mask, _other_detections(g)):
        return EditOutcome(False, reason="object occluded")
    x1, y1, x2, y2 = _bbox_of_mask(mask)
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    erased = _lama_u8(tb, image, _tiered_dilate_np(g.mask, float(g.union_ratio)))
    w = image.shape[1]
    if rec.edit_type == "movement":
        delta = int(rng.integers(50, 121))
        direction = rng.choice(["left", "right"])
        dx = -delta if direction == "left" else delta
        new_cx = int(np.clip(cx + dx, (x2 - x1) // 2, w - (x2 - x1) // 2))
        edited, new_mask = paste_object(erased, image, mask, (new_cx, cy))
        word = rng.choice(MOVE_WORDS)
        dword = rng.choice(LEFT_WORDS if direction == "left" else RIGHT_WORDS)
        instruction = f"{word} the {rec.edited_object} {dword}"
    else:  # resize
        scale = float(rng.choice([0.7, 1.3]))
        edited, new_mask = paste_object(erased, image, mask, (cx, cy), scale)
        word = rng.choice(SMALLER_WORDS if scale < 1 else BIGGER_WORDS)
        instruction = (f"{word} {rec.edited_object}" if "zoom" in word
                       else f"make the {rec.edited_object} {word}")
    if not bool(new_mask.any()):
        return EditOutcome(False, reason="paste out of canvas")
    out = EditOutcome(True, edited=edited, mask=mask)
    out.scores["instruction"] = 0.0
    rec.edit = instruction  # the synthesized text (reference :419-434)
    return out


def relation_change(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                    rng: np.random.Generator) -> EditOutcome:
    """'swap' relation: erase both objects and cross-paste each at the
    other's centre, scaled to the other's width within [0.6, 1.5]
    (relation_tool.py:337-537, adjust_scale_if_necessary :325)."""
    obj_a = rec.edited_object
    obj_b = rec.new_object or rec.extras.get("second object")
    if not obj_a or not obj_b:
        return EditOutcome(False, reason="need two objects")
    ga = tb.ground(image, obj_a, mode="max")
    gb = tb.ground(image, obj_b, mode="max")
    for g, name in ((ga, obj_a), (gb, obj_b)):
        if not _found(g):
            return EditOutcome(False, reason=f"{name} not found")
    ma, mb = to_numpy(ga.mask), to_numpy(gb.mask)
    ba, bb_ = _bbox_of_mask(ma), _bbox_of_mask(mb)
    ca = ((ba[0] + ba[2]) // 2, (ba[1] + ba[3]) // 2)
    cb = ((bb_[0] + bb_[2]) // 2, (bb_[1] + bb_[3]) // 2)
    # the union dilated on the grounder's device (numpy masks: the CPU)
    erased = _lama_u8(tb, image, _tiered_dilate_np(
        ga.mask | gb.mask, float(max(float(ga.union_ratio), float(gb.union_ratio)))))
    sa = min(1.5, max(0.6, (bb_[2] - bb_[0]) / max(1, ba[2] - ba[0])))
    sb = min(1.5, max(0.6, (ba[2] - ba[0]) / max(1, bb_[2] - bb_[0])))
    step1, _ = paste_object(erased, image, ma, cb, sa)
    edited, _ = paste_object(step1, image, mb, ca, sb)
    rec.edit = f"swap the positions of the {obj_a} and the {obj_b}"
    return EditOutcome(True, edited=edited, mask=ma | mb)
