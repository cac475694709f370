"""Edit-type -> pipeline dispatch (counterpart of `anyedit_tpu/edits/registry.py`):
every type of the JAX registry."""

from __future__ import annotations

from anyedit_tpu_torch.edits import (
    action_change, composition, geometry, global_, implicit, local, outpainting, rotation,
    textual, visual,
)
from anyedit_tpu_torch.edits.types import Pipeline

EDIT_PIPELINES: dict[str, Pipeline] = {
    "visual_bbox": visual.visual_condition,
    "visual_depth": visual.visual_condition,
    "visual_scribble": visual.visual_condition,
    "visual_segment": visual.visual_condition,
    "visual_sketch": visual.visual_condition,
    "visual_reference": visual.visual_reference,
    "visual_material_transfer": visual.material_transfer,
    "material_transfer": visual.material_transfer,
    "add": local.add,
    "remove": local.remove,
    "counting": local.remove,
    "replace": local.replace,
    "background_change": local.background_change,
    "action_change": action_change.action_change,
    "composition": composition.composition,
    "rotation_change": rotation.rotation_change,
    "color_alter": global_.color_alter,
    "tone_transfer": global_.tone_transfer,
    "appearance_alter": global_.appearance_alter,
    "material_alter": global_.appearance_alter,
    "resize": geometry.resize_movement,
    "movement": geometry.resize_movement,
    "relation": geometry.relation_change,
    "outpainting": outpainting.outpainting,
    "implicit_change": implicit.implicit_change,
    "style_change": implicit.style_change,
    "textual_change": textual.textual_change,
}


def get_pipeline(edit_type: str) -> Pipeline:
    if edit_type not in EDIT_PIPELINES:
        raise KeyError(f"no pipeline registered for edit_type={edit_type!r} "
                       f"(have: {sorted(EDIT_PIPELINES)})")
    return EDIT_PIPELINES[edit_type]
