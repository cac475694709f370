"""Edit-type -> pipeline dispatch (counterpart of `anyedit_tpu/edits/registry.py`),
over the edit types ported so far."""

from __future__ import annotations

from anyedit_tpu_torch.edits import (
    action_change, geometry, global_, implicit, local, outpainting, textual, visual,
)
from anyedit_tpu_torch.edits.types import Pipeline

EDIT_PIPELINES: dict[str, Pipeline] = {
    "add": local.add,
    "remove": local.remove,
    "counting": local.remove,
    "replace": local.replace,
    "background_change": local.background_change,
    "action_change": action_change.action_change,
    "color_alter": global_.color_alter,
    "tone_transfer": global_.tone_transfer,
    "appearance_alter": global_.appearance_alter,
    "material_alter": global_.appearance_alter,
    "implicit_change": implicit.implicit_change,
    "style_change": implicit.style_change,
    "textual_change": textual.textual_change,
    "resize": geometry.resize_movement,
    "movement": geometry.resize_movement,
    "relation": geometry.relation_change,
    "outpainting": outpainting.outpainting,
    "visual_material_transfer": visual.material_transfer,
    "material_transfer": visual.material_transfer,
}


def get_pipeline(edit_type: str) -> Pipeline:
    if edit_type not in EDIT_PIPELINES:
        raise KeyError(f"no pipeline ported for edit_type={edit_type!r} "
                       f"(ported: {sorted(EDIT_PIPELINES)})")
    return EDIT_PIPELINES[edit_type]
