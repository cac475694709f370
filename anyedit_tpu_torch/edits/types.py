"""Shared types for the per-task editing pipelines.

A copy of `anyedit_tpu/edits/types.py` without its `jax` import, and
`to_numpy`. A pipeline is a function `(toolbox, record, image_u8, rng) ->
EditOutcome`; the `Toolbox` carries the zoo's model closures, so one
resident copy of each model serves every pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord


@dataclasses.dataclass
class EditOutcome:
    success: bool
    edited: Optional[np.ndarray] = None        # HWC uint8
    input_image: Optional[np.ndarray] = None   # HWC uint8 (synthesized inputs)
    mask: Optional[np.ndarray] = None          # HW bool
    visual_input: Optional[np.ndarray] = None  # extra channel for visual tasks
    reason: str = ""
    scores: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Toolbox:
    """Model closures. Every field is optional so tests/pipelines can run
    with exactly the models they need (stubs elsewhere).

    ground(image_u8, phrase, mode, count_k) -> GroundingResult | None
    inpaint(image01, mask01) -> image01            (LaMa)
    sd_inpaint(image_u8, mask, prompt, negative) -> image_u8
    ip2p(image_u8, instruction, mask01|None, steps, s_txt, s_img) -> image_u8
    text2img(prompt, seed) -> image_u8             (Flux/SD synth)
    clip_image(image_u8) -> emb; clip_text(text) -> emb
    vqa_yes_no(image_u8, question) -> bool
    depth/canny/seg/hed(image_u8) -> map
    """

    ground: Optional[Callable] = None
    inpaint: Optional[Callable] = None
    sd_inpaint: Optional[Callable] = None
    ip2p: Optional[Callable] = None
    text2img: Optional[Callable] = None
    clip_image: Optional[Callable] = None
    clip_text: Optional[Callable] = None
    vqa_yes_no: Optional[Callable] = None
    depth: Optional[Callable] = None
    canny: Optional[Callable] = None
    seg: Optional[Callable] = None
    hed: Optional[Callable] = None
    ocr: Optional[Callable] = None   # image -> recognized text (GOT-OCR2 slot)
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


# A pipeline: (toolbox, record, image_u8 HWC, rng) -> EditOutcome
Pipeline = Callable[[Toolbox, InstructionRecord, np.ndarray,
                     np.random.Generator], EditOutcome]


def to_numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or an array: grounders give
    their masks as either."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
