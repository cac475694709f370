"""Visual-editing pipelines: the condition channels, AnyDoor's reference
insert and material transfer (counterpart of `anyedit_tpu/edits/visual.py`).

  * visual_condition (visual_condition_tool.py:33-324): derive the
    `visual_input` channel of a visual_* type from the image (canny sketch,
    depth map, segmentation rendering, HED scribble thresholded at 0.5
    without inverting, as the JAX pipeline does, or the grounded boxes
    drawn in red) and rewrite the instruction to "Follow / Refer to / Watch
    the given [v*] to edit: ...". The edited frame IS the image by design:
    the trainee learns to reproduce it from the condition.
  * visual_reference (visual_reference_tool.py:63-232): AnyDoor. Ground the
    target ("max") and reject it when its mask touches the frame's edge;
    ground the reference object in `tb.extra["load_visual"](record)`, paste
    it into the target's box (`build_collage`: collage + Sobel
    high-frequency map) and regenerate the box with
    `tb.extra["anydoor"](target, mask, collage, hf, reference)`.
  * material_transfer (material_transfer_tool.py:46-210): ground the edited
    object ("max"), grey it out inside its mask, and regenerate it with the
    depth ControlNet on the frame's depth map and the IP-Adapter on a
    material exemplar (`tb.extra["sdxl_material"]`); the exemplar comes
    from `tb.extra["load_visual"](record)` and is returned as the record's
    `visual_input`.
"""

from __future__ import annotations

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.ops.canny import canny, rgb_to_gray
from anyedit_tpu_torch.ops.morphology import sobel_magnitude
from anyedit_tpu_torch.ops.resize import resize_image

VC_PREFIX = {"visual_bbox": "[bbox]", "visual_depth": "[depth]",
             "visual_scribble": "[scribble]", "visual_segment": "[segment]",
             "visual_sketch": "[sketch]"}
VC_VERBS = ("Follow", "Refer to", "Watch")


def draw_bbox(image: np.ndarray, boxes: np.ndarray, valid: np.ndarray,
              thickness: int = 3) -> np.ndarray:
    """Red rectangle outlines of the valid boxes on a copy of the image
    (img2bbox, :154-164)."""
    out = image.copy()
    h, w = image.shape[:2]
    color = np.array([255, 0, 0], np.uint8)
    for box, ok in zip(boxes, valid):
        if not ok:
            continue
        x1, y1, x2, y2 = [int(np.clip(v, 0, lim))
                          for v, lim in zip(box, (w - 1, h - 1, w - 1, h - 1))]
        out[y1:y1 + thickness, x1:x2] = color
        out[max(0, y2 - thickness):y2, x1:x2] = color
        out[y1:y2, x1:x1 + thickness] = color
        out[y1:y2, max(0, x2 - thickness):x2] = color
    return out


def visual_condition(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                     rng: np.random.Generator) -> EditOutcome:
    """The visual_input channel of one of the five visual_* condition types.
    visual_sketch takes `tb.canny` where installed (the zoo's device), else
    the same Canny on the image's host tensor."""
    vtype = rec.edit_type
    if vtype == "visual_sketch":
        vis = np.asarray(tb.canny(image)) if tb.canny is not None else \
            canny(rgb_to_gray(torch.as_tensor(image))).numpy()
        vis = np.stack([vis] * 3, axis=-1)
    elif vtype == "visual_scribble":
        if tb.hed is None:
            return EditOutcome(False, reason="hed model unavailable")
        edges = np.asarray(tb.hed(image))
        vis = np.stack([(edges > 0.5).astype(np.uint8) * 255] * 3, axis=-1)
    elif vtype == "visual_depth":
        if tb.depth is None:
            return EditOutcome(False, reason="depth model unavailable")
        vis = np.stack([np.asarray(tb.depth(image))] * 3, axis=-1)
    elif vtype == "visual_segment":
        if tb.seg is None:
            return EditOutcome(False, reason="segmentor unavailable")
        vis = np.asarray(tb.seg(image))
    elif vtype == "visual_bbox":
        g = tb.ground(image, rec.edited_object or rec.input, mode="merge")
        if g is None:
            return EditOutcome(False, reason="grounding failed")
        vis = draw_bbox(image, to_numpy(g.boxes), to_numpy(g.valid))
    else:
        return EditOutcome(False, reason=f"unknown visual type {vtype}")
    verb = rng.choice(VC_VERBS)
    rec.edit = f"{verb} the given {VC_PREFIX[vtype]} to edit: {rec.edit}"
    return EditOutcome(True, edited=image, visual_input=vis)


# ---- AnyDoor collage (visual_reference) ----------------------------------

def build_collage(target: np.ndarray, target_mask: np.ndarray,
                  ref_image: np.ndarray, ref_mask: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(collage (H, W, 3) uint8, HF map (H, W) fp32): the reference object's
    mask box cropped, resized bilinear (antialiased) to the target mask's
    box and pasted there where its resized mask is above 0.5; the HF map is
    the Sobel magnitude of the resized crop's grey, under that mask, in the
    target box (process_pairs, visual_reference_tool.py:63-142)."""
    ys, xs = np.nonzero(target_mask)
    if len(ys) == 0:
        raise ValueError("empty target mask")
    y1, y2, x1, x2 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    rys, rxs = np.nonzero(ref_mask)
    ry1, ry2, rx1, rx2 = rys.min(), rys.max() + 1, rxs.min(), rxs.max() + 1
    th, tw = int(y2 - y1), int(x2 - x1)
    ref_crop = resize_image(torch.from_numpy(ref_image[ry1:ry2, rx1:rx2].astype(np.float32)),
                            th, tw, "bilinear")
    ref_m = resize_image(torch.from_numpy(ref_mask[ry1:ry2, rx1:rx2, None].astype(np.float32)),
                         th, tw, "bilinear")[..., 0].numpy() > 0.5
    collage = target.astype(np.float32).copy()
    collage[y1:y2, x1:x2] = np.where(ref_m[..., None], ref_crop.numpy(), collage[y1:y2, x1:x2])
    hf = np.zeros(target.shape[:2], np.float32)
    hf[y1:y2, x1:x2] = sobel_magnitude(rgb_to_gray(ref_crop)).numpy() * ref_m
    return np.clip(collage, 0, 255).astype(np.uint8), hf


def visual_reference(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                     rng: np.random.Generator) -> EditOutcome:
    """AnyDoor insert. Needs `tb.ground`, `tb.extra["anydoor"](target_u8,
    mask, collage_u8, hf, ref_u8) -> image_u8` and
    `tb.extra["load_visual"](record) -> ref_u8`."""
    anydoor = tb.extra.get("anydoor")
    load_visual = tb.extra.get("load_visual")
    if anydoor is None or load_visual is None:
        return EditOutcome(False, reason="anydoor stack unavailable")
    g = tb.ground(image, rec.edited_object, mode="max")
    if g is None or not bool(g.mask.any()):
        return EditOutcome(False, reason="target object not found")
    tmask = to_numpy(g.mask)
    # completeness gate: the mask must not touch the frame's edges (:268-281)
    ys, xs = np.nonzero(tmask)
    h, w = image.shape[:2]
    if ys.min() <= 1 or xs.min() <= 1 or ys.max() >= h - 2 or xs.max() >= w - 2:
        return EditOutcome(False, reason="target touches image edge")
    ref_image = load_visual(rec)
    gr = tb.ground(ref_image, rec.ref_object or rec.edited_object, mode="max")
    if gr is None or not bool(gr.mask.any()):
        return EditOutcome(False, reason="reference object not found")
    collage, hf = build_collage(image, tmask, ref_image, to_numpy(gr.mask))
    edited = np.asarray(anydoor(image, tmask, collage, hf, ref_image))
    return EditOutcome(True, edited=edited, mask=tmask, visual_input=ref_image)


def material_transfer(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                      rng: np.random.Generator) -> EditOutcome:
    """Needs `tb.ground`, `tb.depth(image_u8) -> (H, W) uint8`,
    `tb.extra["sdxl_material"](init_u8, mask, depth_u8, exemplar_u8) ->
    image_u8` and `tb.extra["load_visual"](record) -> exemplar_u8`."""
    runner = tb.extra.get("sdxl_material")
    load_visual = tb.extra.get("load_visual")
    if runner is None or load_visual is None or tb.depth is None:
        return EditOutcome(False, reason="material stack unavailable")
    g = tb.ground(image, rec.edited_object, mode="max")
    if g is None or not bool(g.mask.any()):
        return EditOutcome(False, reason="object not found")
    mask = to_numpy(g.mask)
    gray = to_numpy(rgb_to_gray(torch.as_tensor(image))).astype(np.uint8)
    init = image.copy()
    init[mask] = gray[mask, None]
    depth_map = np.asarray(tb.depth(image))
    exemplar = load_visual(rec)
    edited = np.asarray(runner(init, mask, depth_map, exemplar))
    return EditOutcome(True, edited=edited, mask=mask, visual_input=exemplar)
