"""The instruction record — the universal interchange format of the factory.

A copy of `anyedit_tpu/core/schema.py` (which cannot be imported without
JAX: its package `__init__` imports the mesh). Exact-compatible with the reference JSON schema (reference README.md:56-67):
every pipeline consumes and emits records shaped like

    {
      "edit": "change the airplane to green",
      "edited object": "airplane",          # local edits only, else None
      "input": "a small airplane ...",      # caption of the original image
      "output": "A green small airplane ...",
      "edit_type": "color_alter",
      "visual_input": "None",               # reference image for visual edits
      "image_file": "COCO_train2014_000000521165.jpg",
      "edited_file": "xxxxx.png"
    }

plus per-type extras (``new object`` for replace, ``remove_number`` for
counting, ``ref_object`` for visual_reference — reference
adaptive_editing_pipelines/tools/tool.py:29-65).

We keep the on-disk JSON keys byte-identical (including the space in
"edited object") so datasets produced by either system interchange freely.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable, Iterator

# Canonical edit-type vocabulary (reference scripts/scripts.md + SURVEY.md §2d).
EDIT_TYPES = (
    # local
    "add", "remove", "replace", "counting", "color_alter", "appearance_alter",
    "material_alter", "action_change", "textual_change",
    # global
    "background_change", "tone_transfer", "style_change",
    # camera move
    "resize", "movement", "outpainting", "rotation_change",
    # implicit
    "implicit_change", "relation",
    # visual
    "visual_reference", "visual_bbox", "visual_depth", "visual_scribble",
    "visual_segment", "visual_sketch", "visual_material_transfer",
    "material_transfer",
)

LOCAL_TYPES = frozenset({
    "add", "remove", "replace", "counting", "color_alter", "appearance_alter",
    "material_alter", "resize", "movement",
})

_JSON_KEYS = {
    "edit": "edit",
    "edited_object": "edited object",
    "input": "input",
    "output": "output",
    "edit_type": "edit_type",
    "visual_input": "visual_input",
    "image_file": "image_file",
    "edited_file": "edited_file",
    "new_object": "new object",
    "remove_number": "remove_number",
    "ref_object": "ref_object",
}
_FROM_JSON = {v: k for k, v in _JSON_KEYS.items()}


def _none_str(v: Any) -> Any:
    # The reference serializes missing fields as the string "None".
    return None if v in ("None", "", None) else v


@dataclasses.dataclass
class InstructionRecord:
    """One editing task: instruction + captions + file pointers."""

    edit: str
    input: str
    output: str
    edit_type: str
    image_file: str | None = None
    edited_file: str | None = None
    edited_object: str | None = None
    visual_input: str | None = None
    new_object: str | None = None
    remove_number: int | None = None
    ref_object: str | None = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.edited_object = _none_str(self.edited_object)
        self.visual_input = _none_str(self.visual_input)

    # ---- JSON round-trip ------------------------------------------------
    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "InstructionRecord":
        kwargs: dict[str, Any] = {}
        extras: dict[str, Any] = {}
        for k, v in obj.items():
            field = _FROM_JSON.get(k)
            if field is None:
                extras[k] = v
            else:
                kwargs[field] = v
        kwargs.setdefault("edit", "")
        kwargs.setdefault("input", "")
        kwargs.setdefault("output", "")
        kwargs.setdefault("edit_type", "")
        return cls(extras=extras, **kwargs)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for field, key in _JSON_KEYS.items():
            v = getattr(self, field)
            if field in ("edited_object", "visual_input"):
                # preserve the reference's "None"-string convention
                out[key] = "None" if v is None else v
            elif v is not None:
                out[key] = v
        out.update(self.extras)
        return out

    # ---- convenience ----------------------------------------------------
    @property
    def is_local(self) -> bool:
        return self.edit_type in LOCAL_TYPES

    def key(self) -> str:
        """Stable identity for ledger/resume bookkeeping."""
        return f"{self.edit_type}::{self.image_file}::{self.edit}"


# ---- JSONL / JSON-array IO ----------------------------------------------

def read_records(path: str | Path) -> list[InstructionRecord]:
    """Read records from a .json (array) or .jsonl file.

    Mirrors the reference's loader which accepts both forms
    (local_pipeline_tool.py:556-561).
    """
    path = Path(path)
    text = path.read_text()
    records: list[InstructionRecord] = []
    stripped = text.lstrip()
    if stripped.startswith("["):
        for obj in json.loads(text):
            records.append(InstructionRecord.from_json(obj))
    else:
        for line in text.splitlines():
            line = line.strip()
            if line:
                records.append(InstructionRecord.from_json(json.loads(line)))
    return records


def iter_records(path: str | Path) -> Iterator[InstructionRecord]:
    yield from read_records(path)


def write_records(path: str | Path, records: Iterable[InstructionRecord],
                  jsonl: bool | None = None) -> None:
    path = Path(path)
    if jsonl is None:
        jsonl = path.suffix == ".jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    objs = [r.to_json() for r in records]
    if jsonl:
        with path.open("w") as f:
            for o in objs:
                f.write(json.dumps(o) + "\n")
    else:
        path.write_text(json.dumps(objs, indent=1))
