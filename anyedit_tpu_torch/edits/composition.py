"""composition: canvas-planned, region-conditioned generation (counterpart
of `anyedit_tpu/edits/composition.py`; reference
composition_image_generation.py:1-256).

The canvas plan is `rec.extras["canvas_plan"]` when the instruction
generator emitted one, else the record's `edit` text, in the `global:` /
`region: x1,y1,x2,y2 | desc` line format of
`diffusion/regional.py::parse_canvas_plan`; `tb.extra["composition"](plan,
seed)` renders it. Both sides of the record are generated: `image` is not
read.
"""

from __future__ import annotations

import numpy as np

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox


def composition(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                rng: np.random.Generator) -> EditOutcome:
    runner = tb.extra.get("composition")
    if runner is None:
        return EditOutcome(False, reason="composition stack unavailable")
    plan = rec.extras.get("canvas_plan") or rec.edit
    seed = int(rng.integers(0, 2 ** 31))
    return EditOutcome(True, edited=np.asarray(runner(plan, seed)))
