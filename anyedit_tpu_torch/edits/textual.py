"""textual_change: same-seed caption-pair synthesis through Flux
(counterpart of `anyedit_tpu/edits/textual.py`).

Both the input and the edited image are GENERATED (flux-schnell, 4 steps)
from the two OCR-bearing captions with the same seed, so only the written
text differs. Where the toolbox has an OCR slot, both sides must read
their quoted strings.
"""

from __future__ import annotations

import re

import numpy as np

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox
from anyedit_tpu_torch.filters.scorers import ocr_text_match


def textual_change(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                   rng: np.random.Generator) -> EditOutcome:
    """Needs `tb.extra["flux_pair"](caption_a, caption_b, seed) -> (img_a,
    img_b)`; `image` is unused."""
    pair = tb.extra.get("flux_pair")
    if pair is None:
        return EditOutcome(False, reason="flux stack unavailable")
    seed = int(rng.integers(0, 2 ** 31))
    img_in, img_out = pair(rec.input, rec.output, seed)
    img_in = np.asarray(img_in)
    img_out = np.asarray(img_out)
    if tb.ocr is not None:
        # the target strings are quoted in the captions; else the whole text
        want_in = (re.findall(r'"([^"]+)"', rec.input) or [rec.input])[0]
        want_out = (re.findall(r'"([^"]+)"', rec.output) or [rec.output])[0]
        if not (ocr_text_match(tb.ocr(img_in), want_in)
                and ocr_text_match(tb.ocr(img_out), want_out)):
            return EditOutcome(False, edited=img_out, input_image=img_in,
                               reason="OCR text mismatch")
    return EditOutcome(True, edited=img_out, input_image=img_in)
