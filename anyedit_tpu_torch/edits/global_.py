"""Global edits: color_alter / tone_transfer via the IP2P editor and
appearance_alter via SD3-UltraEdit (counterpart of
`anyedit_tpu/edits/global_.py`).

color_alter grounds the edited object, runs the 100-step IP2P edit (s_txt
8.0, s_img 0.9) on the whole image, and pastes the edited region back onto
the original with a feathered seam; tone_transfer keeps the whole edited
frame. appearance_alter (also material_alter) grounds the object, takes
faces out of its mask, and makes a masked edit at 50 steps, 8.0 / 1.5:
through `tb.extra["ultraedit"]` (the zoo's `install(tb, "ultraedit")`, the
production route), or through the masked IP2P editor when the toolbox has
no UltraEdit slot.
"""

from __future__ import annotations

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.ops.morphology import dilate, gaussian_blur
from anyedit_tpu_torch.ops.resize import to_u8

STEPS, S_TXT, S_IMG = 100, 8.0, 0.9                  # color_alter, tone_transfer
APPEARANCE_STEPS, APPEARANCE_S_TXT, APPEARANCE_S_IMG = 50, 8.0, 1.5


def crop_composite(original: np.ndarray, edited: np.ndarray, mask,
                   feather_sigma: float = 2.0) -> np.ndarray:
    """Paste the edited region onto the original with a feathered seam:
    the mask dilated by 5, blurred with sigma 2, blended in fp32, clipped
    and truncated to uint8 (as the JAX `astype(uint8)`). Runs on the mask's
    device (the CPU for a numpy mask); returns numpy."""
    m = torch.as_tensor(mask)
    dev = m.device
    m = gaussian_blur(dilate(m.float(), 5), feather_sigma)[..., None]
    out = torch.as_tensor(edited, device=dev).float() * m \
        + torch.as_tensor(original, device=dev).float() * (1.0 - m)
    return to_u8(out).cpu().numpy()


def color_alter(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                rng: np.random.Generator) -> EditOutcome:
    g = tb.ground(image, rec.edited_object, mode="merge")
    if g is None or not bool(g.mask.any()):
        return EditOutcome(False, reason="object not found")
    edited_full = np.asarray(tb.ip2p(image, rec.edit, None,
                                     steps=STEPS, s_txt=S_TXT, s_img=S_IMG))
    edited = crop_composite(image, edited_full, g.mask)
    return EditOutcome(True, edited=edited, mask=g.mask.cpu().numpy())


def tone_transfer(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                  rng: np.random.Generator) -> EditOutcome:
    edited = np.asarray(tb.ip2p(image, rec.edit, None,
                                steps=STEPS, s_txt=S_TXT, s_img=S_IMG))
    return EditOutcome(True, edited=edited)


def appearance_alter(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                     rng: np.random.Generator) -> EditOutcome:
    """The grounded mask minus faces (attribute_pipeline_tool.py:104-130),
    edited by SD3-UltraEdit (attribute_pipeline_tool.py:85-155), or by the
    masked IP2P editor where the toolbox has no UltraEdit slot."""
    g = tb.ground(image, rec.edited_object, mode="merge")
    if g is None or not bool(g.mask.any()):
        return EditOutcome(False, reason="object not found")
    mask = to_numpy(g.mask)
    gf = tb.ground(image, "face", mode="merge")
    if gf is not None and bool(gf.mask.any()):
        mask = mask & ~to_numpy(gf.mask)
    editor = tb.extra.get("ultraedit") or tb.ip2p
    edited = np.asarray(editor(image, rec.edit, mask.astype(np.float32),
                               steps=APPEARANCE_STEPS, s_txt=APPEARANCE_S_TXT,
                               s_img=APPEARANCE_S_IMG))
    return EditOutcome(True, edited=edited, mask=mask)
