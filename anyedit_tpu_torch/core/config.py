"""One typed config layer for the whole factory (the counterpart of
`anyedit_tpu/core/config.py`): nested dataclasses with plain dict / JSON
overlays, and per-task presets mirroring the reference's `scripts/*.sh`
flag sets. `from_dict` refuses an unknown key, as the JAX one does."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _coerce(ftype: Any, v: Any) -> Any:
    if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
        return from_dict(ftype, v)
    return v


def from_dict(cls: Type[T], obj: dict[str, Any]) -> T:
    """Build a dataclass from a nested dict, recursing into dataclass fields."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in obj.items():
        if k not in fields:
            raise KeyError(f"{cls.__name__}: unknown config key {k!r}")
        kwargs[k] = _coerce(_resolve(cls, fields[k]), v)
    return cls(**kwargs)


def _resolve(cls: Type, field: dataclasses.Field) -> Any:
    t = field.type
    if isinstance(t, str):
        import typing
        t = typing.get_type_hints(cls).get(field.name, Any)
    return t


def to_dict(cfg: Any) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def load(cls: Type[T], path: str | Path, **overrides: Any) -> T:
    obj = json.loads(Path(path).read_text())
    obj.update(overrides)
    return from_dict(cls, obj)


def override(cfg: T, **kv: Any) -> T:
    return dataclasses.replace(cfg, **kv)


# ---- factory-level configs ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class IOConfig:
    instruction_path: str = "data"
    instruction_type: str = "remove"
    image_root: str | None = None
    output_root: str | None = None


@dataclasses.dataclass(frozen=True)
class CanvasConfig:
    """Shape buckets of the editing canvas."""
    edit_size: int = 512          # editing canvas
    grounding_size: int = 800     # detector input bucket
    sam_size: int = 1024          # SAM encoder canonical size
    latent_down: int = 8          # VAE spatial downsampling


@dataclasses.dataclass(frozen=True)
class DiffusionRunConfig:
    num_steps: int = 50
    guidance_scale: float = 7.5
    image_guidance_scale: float = 1.5
    scheduler: str = "ddim"
    dtype: str = "bfloat16"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FactoryConfig:
    io: IOConfig = IOConfig()
    canvas: CanvasConfig = CanvasConfig()
    diffusion: DiffusionRunConfig = DiffusionRunConfig()
    batch_size: int = 8
    seed: int = 0


# Per-task presets mirroring the reference's scripts/*.sh and in-code defaults:
TASK_PRESETS: dict[str, dict[str, Any]] = {
    # WYS-IP2P global edits: 100 DDIM steps, text cfg 8.0, image cfg 0.9
    "color_alter": {"diffusion": {"num_steps": 100, "guidance_scale": 8.0,
                                  "image_guidance_scale": 0.9}},
    "tone_transfer": {"diffusion": {"num_steps": 100, "guidance_scale": 8.0,
                                    "image_guidance_scale": 0.9}},
    # SD3 UltraEdit: 50 steps, cfg 8.0 / img 1.5
    "appearance_alter": {"diffusion": {"num_steps": 50, "guidance_scale": 8.0,
                                       "image_guidance_scale": 1.5}},
    # AnyDoor: 50 steps, cfg 9.0
    "visual_reference": {"diffusion": {"num_steps": 50, "guidance_scale": 9.0}},
    # Flux-schnell: 4 steps
    "textual_change": {"diffusion": {"num_steps": 4, "guidance_scale": 0.0}},
    # SDXL material transfer: 30 steps at 1024
    "material_transfer": {"diffusion": {"num_steps": 30},
                          "canvas": {"edit_size": 1024}},
}


def task_config(edit_type: str, **overrides: Any) -> FactoryConfig:
    """FactoryConfig() with the task's preset merged into its sections, the
    instruction type set, then `overrides` replacing whole top-level keys."""
    base = to_dict(FactoryConfig())
    preset = TASK_PRESETS.get(edit_type, {})
    for k, v in preset.items():
        if isinstance(v, dict):
            base[k].update(v)
        else:
            base[k] = v
    base["io"]["instruction_type"] = edit_type
    for k, v in overrides.items():
        base[k] = v
    return from_dict(FactoryConfig, base)
