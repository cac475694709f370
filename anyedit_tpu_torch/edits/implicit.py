"""style_change through the instruction editor (counterpart of
`anyedit_tpu/edits/implicit.py::style_change`; the reference defers this
type to an external app). The file's `implicit_change` chain waits for the
P2P, SDXL-inpaint and IP-Adapter slots.
"""

from __future__ import annotations

import numpy as np

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox

STEPS, S_TXT, S_IMG = 50, 7.5, 1.2


def style_change(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                 rng: np.random.Generator) -> EditOutcome:
    """One unmasked IP2P edit of the whole frame."""
    edited = np.asarray(tb.ip2p(image, rec.edit, None, steps=STEPS, s_txt=S_TXT, s_img=S_IMG))
    return EditOutcome(True, edited=edited)
