"""Local edits: add / remove / counting / replace / background_change
(counterpart of `anyedit_tpu/edits/local.py`).

  add                — the record's image is the EDITED side: ground the
                       object and LaMa-remove it to synthesize the input;
                       the removal must hold (re-detection overlaps the
                       dilated mask < 0.5)
  remove / counting  — ground (merge, or count mode with `remove_number`),
                       tiered dilate, LaMa, the object gone (re-detection
                       overlap < 0.2)
  replace            — LaMa-erase the dilated mask, SD-inpaint "a photo of
                       {new object}" in the boxes, the new object detected
  background_change  — foreground and face masks merged, dilated by 9 and
                       inverted, SD-inpaint the background with a negative
                       prompt

Masks may come from the grounder as tensors on any device or as numpy
arrays; the dilations run on the mask's device and the outcome's masks are
numpy, as the JAX pipelines return them.
"""

from __future__ import annotations

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.ops.morphology import dilate

BG_NEGATIVE_PROMPT = ("person, people, human, man, woman, child, animal, "
                      "low quality, blurry, distorted")


def _found(g) -> bool:
    return g is not None and bool(g.mask.any())


def _dilate_np(mask, k: int) -> np.ndarray:
    """Binary dilation by a k x k square on the mask's device -> numpy bool."""
    return to_numpy(dilate(torch.as_tensor(mask).float(), k) > 0.5)


def _tiered_dilate_np(mask, union_ratio: float) -> np.ndarray:
    """cv2.dilate tiers by union area (local_pipeline_tool.py:360-365): 15
    below a ratio of 0.05, 25 below 0.15, else 35."""
    return _dilate_np(mask, 15 if union_ratio < 0.05 else (25 if union_ratio < 0.15 else 35))


def _mask_intersection_ratio(new_mask: np.ndarray, old_mask: np.ndarray) -> float:
    """|new & old| / |new|: how much of the re-detected object overlaps the
    removed region."""
    denom = max(1, int(new_mask.sum()))
    return float((new_mask & old_mask).sum()) / denom


def _lama_u8(tb: Toolbox, image: np.ndarray, mask_d: np.ndarray) -> np.ndarray:
    """LaMa over the dilated mask, back to uint8 (clipped, truncated)."""
    out = np.asarray(tb.inpaint(image.astype(np.float32) / 255.0, mask_d.astype(np.float32)))
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def remove(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
           rng: np.random.Generator) -> EditOutcome:
    counting = rec.edit_type == "counting"
    g = tb.ground(image, rec.edited_object, mode="count" if counting else "merge",
                  count_k=rec.remove_number if counting else None)
    if not _found(g):
        return EditOutcome(False, reason="object not found")
    mask = to_numpy(g.mask)
    mask_d = _tiered_dilate_np(g.mask, float(g.union_ratio))
    edited = _lama_u8(tb, image, mask_d)
    # verify: object gone or barely overlapping (intersection < 0.2, :371-393)
    g2 = tb.ground(edited, rec.edited_object, mode="merge")
    if _found(g2) and _mask_intersection_ratio(to_numpy(g2.mask), mask_d) >= 0.2:
        return EditOutcome(False, edited=edited, mask=mask,
                           reason="object still detected after removal")
    return EditOutcome(True, edited=edited, mask=mask)


def add(tb: Toolbox, rec: InstructionRecord, target_image: np.ndarray,
        rng: np.random.Generator) -> EditOutcome:
    """`target_image` is the EDITED side; the input is synthesized by removal."""
    g = tb.ground(target_image, rec.edited_object, mode="merge")
    if not _found(g):
        return EditOutcome(False, reason="object not found in target")
    mask = to_numpy(g.mask)
    mask_d = _tiered_dilate_np(g.mask, float(g.union_ratio))
    synth_input = _lama_u8(tb, target_image, mask_d)
    g2 = tb.ground(synth_input, rec.edited_object, mode="merge")
    if _found(g2) and _mask_intersection_ratio(to_numpy(g2.mask), mask_d) >= 0.5:   # :291
        return EditOutcome(False, reason="removal for add failed")
    return EditOutcome(True, edited=target_image, input_image=synth_input, mask=mask)


def replace(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
            rng: np.random.Generator) -> EditOutcome:
    g = tb.ground(image, rec.edited_object, mode="merge")
    if not _found(g):
        return EditOutcome(False, reason="object not found")
    mask = to_numpy(g.mask)
    erased = _lama_u8(tb, image, _tiered_dilate_np(g.mask, float(g.union_ratio)))
    edited = np.asarray(tb.sd_inpaint(erased, to_numpy(g.bbox_mask).astype(np.float32),
                                      f"a photo of {rec.new_object}", ""))
    if not _found(tb.ground(edited, rec.new_object, mode="merge")):
        return EditOutcome(False, edited=edited, mask=mask, reason="new object not detected")
    return EditOutcome(True, edited=edited, mask=mask)


def background_change(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                      rng: np.random.Generator) -> EditOutcome:
    """Foreground (and face) masks merged, inverted -> SD-inpaint background."""
    g = tb.ground(image, rec.edited_object or "foreground object", mode="merge")
    if not _found(g):
        return EditOutcome(False, reason="foreground not found")
    fg = to_numpy(g.mask)
    gf = tb.ground(image, "face", mode="merge")
    if gf is not None:
        fg = fg | to_numpy(gf.mask)
    fg = _dilate_np(fg, 9)
    edited = np.asarray(tb.sd_inpaint(image, (~fg).astype(np.float32),
                                      rec.output or rec.edit, BG_NEGATIVE_PROMPT))
    return EditOutcome(True, edited=edited, mask=~fg)
