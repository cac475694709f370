"""Post-filter: per-edit-type acceptance predicates.

A copy of `anyedit_tpu/filters/post_filter.py` (its package `__init__`
imports flax): the hand-tuned threshold table of reference
filter_tool/post_filter.py:15-79. These thresholds are the dataset's
quality definition, so they are data here, not code. The decision consumes
a `Scores` record of scores the executor computed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Scores:
    """Everything a predicate might need; None = not computed."""

    clip: Optional[float] = None            # CLIP(edited image, output caption)
    dir_clip: Optional[float] = None        # directional CLIP
    l1: Optional[float] = None              # pixel L1 in [0,1]
    object_present: Optional[bool] = None   # detector+SAM existence in edit region
    vqa_yes: Optional[bool] = None          # BLIP-2 / VILA yes-no answer
    ocr_match: Optional[bool] = None        # GOT-OCR both-sides text match


# threshold table (post_filter.py:15-79)
POST_THRESHOLDS: dict[str, dict[str, float]] = {
    "add":               {"clip": 0.20},
    "remove":            {"clip": 0.15},
    "counting":          {"clip": 0.15},
    "replace":           {"clip": 0.20, "dir_clip": 0.08},
    "action_change":     {"clip": 0.30, "dir_clip": 0.05},
    "appearance_alter":  {"clip": 0.25, "l1": 0.30, "dir_clip": 0.06},
    "material_alter":    {"clip": 0.25, "l1": 0.30, "dir_clip": 0.06},
    "tone_transfer":     {"clip": 0.25, "l1_lo": 0.20, "l1_hi": 0.80},
    "background_change": {"clip": 0.15, "l1_lo": 0.20, "l1_hi": 0.90},
    "color_alter":       {"clip": 0.20, "l1": 0.30},
}


def post_filter_decision(edit_type: str, s: Scores) -> bool:
    """True = accept the edited pair into the dataset."""
    th = POST_THRESHOLDS.get(edit_type, {})

    def ok(name, val, default=True):
        t = th.get(name)
        if t is None or val is None:
            return default
        return val > t

    if edit_type == "add":
        return ok("clip", s.clip) and s.object_present is True
    if edit_type in ("remove", "counting"):
        return ok("clip", s.clip) and s.object_present is False
    if edit_type == "replace":
        return ok("clip", s.clip) and ok("dir_clip", s.dir_clip) \
            and s.object_present is True
    if edit_type == "action_change":
        return ok("clip", s.clip) and ok("dir_clip", s.dir_clip)
    if edit_type in ("appearance_alter", "material_alter"):
        return ok("clip", s.clip) and ok("l1", s.l1) and ok("dir_clip", s.dir_clip)
    if edit_type == "tone_transfer":
        return ok("clip", s.clip) and s.l1 is not None \
            and th["l1_lo"] < s.l1 < th["l1_hi"]
    if edit_type == "background_change":
        return ok("clip", s.clip) and s.vqa_yes is True and s.l1 is not None \
            and th["l1_lo"] < s.l1 < th["l1_hi"]
    if edit_type == "color_alter":
        return ok("clip", s.clip) and ok("l1", s.l1) and s.vqa_yes is True
    if edit_type == "textual_change":
        return s.ocr_match is True
    # visual/implicit/camera types pass through (verified inside their pipelines)
    return True
