"""Pre-filter: instruction/image gates run before any editing.

A copy of `anyedit_tpu/filters/pre_filter.py` (its package `__init__`
imports flax). Port of reference filter_tool/pre_filter.py:115-278:
  * main gate (:148-170): aspect ratio ≤ 2, CLIP(image, caption) > 0.1,
    aesthetic MLP score > 2, grounded object-area ratio < 0.95,
  * per-type rule filters: color rebalancing basic/rare 0.8/0.2 (:190-211),
    human-exclusion for replace (:231), verb logic for action (:245),
    background VQA (:347-370).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PRE_THRESHOLDS = {
    "max_aspect": 2.0,
    "min_clip": 0.1,
    "min_aesthetic": 2.0,
    "max_object_ratio": 0.95,
}

BASIC_COLORS = frozenset("""red blue green yellow black white brown gray grey
orange purple pink""".split())
HUMAN_WORDS = frozenset("""man woman person people boy girl child children kid
kids guy lady men women human baby""".split())


@dataclasses.dataclass
class PreScores:
    width: int
    height: int
    clip: Optional[float] = None          # CLIP(image, input caption)
    aesthetic: Optional[float] = None
    object_ratio: Optional[float] = None  # union bbox area / image area
    background_vqa_ok: Optional[bool] = None


def main_gate(s: PreScores) -> bool:
    aspect = max(s.width, s.height) / max(1, min(s.width, s.height))
    if aspect > PRE_THRESHOLDS["max_aspect"]:
        return False
    if s.clip is not None and s.clip <= PRE_THRESHOLDS["min_clip"]:
        return False
    if s.aesthetic is not None and s.aesthetic <= PRE_THRESHOLDS["min_aesthetic"]:
        return False
    if s.object_ratio is not None and s.object_ratio >= PRE_THRESHOLDS["max_object_ratio"]:
        return False
    return True


def color_prefilter(new_color: str, rng_uniform: float) -> bool:
    """Rebalance basic vs rare colors: keep basic w.p. 0.8, rare w.p. 0.2
    (pre_filter.py:190-211)."""
    p = 0.8 if new_color.lower() in BASIC_COLORS else 0.2
    return rng_uniform < p


def replace_prefilter(edited_object: str) -> bool:
    """Humans are excluded from replace edits (pre_filter.py:231)."""
    words = set(edited_object.lower().split())
    return not (words & HUMAN_WORDS)


def action_prefilter(verbs: list[str]) -> bool:
    """Action edits need at least one verb in the caption (pre_filter.py:245)."""
    return len(verbs) > 0


def pre_filter_decision(edit_type: str, s: PreScores,
                        edited_object: str = "",
                        new_attr: str = "",
                        verbs: Optional[list[str]] = None,
                        rng_uniform: float = 0.0) -> bool:
    if not main_gate(s):
        return False
    if edit_type == "color_alter" and new_attr:
        if not color_prefilter(new_attr, rng_uniform):
            return False
    if edit_type == "replace" and edited_object:
        if not replace_prefilter(edited_object):
            return False
    if edit_type == "action_change":
        if not action_prefilter(verbs or []):
            return False
    if edit_type == "background_change" and s.background_vqa_ok is False:
        return False
    return True
