"""material_transfer (counterpart of `edits/visual.py::material_transfer` in
the JAX package; the file's other pipelines, the visual conditions and the
AnyDoor reference insert, are not ported yet).

material_transfer (material_transfer_tool.py:46-210): ground the edited
object ("max"), grey it out inside its mask, and regenerate it with the
depth ControlNet on the frame's depth map and the IP-Adapter on a material
exemplar (`tb.extra["sdxl_material"]`); the exemplar comes from
`tb.extra["load_visual"](record)` and is returned as the record's
`visual_input`.
"""

from __future__ import annotations

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.ops.canny import rgb_to_gray


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
