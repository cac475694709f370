"""Shape buckets of the editing canvas (the `CanvasConfig` of
`anyedit_tpu/core/config.py`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CanvasConfig:
    edit_size: int = 512          # editing canvas
    grounding_size: int = 800     # detector input bucket
    sam_size: int = 1024          # SAM encoder canonical size
    latent_down: int = 8          # VAE spatial downsampling
