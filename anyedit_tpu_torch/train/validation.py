"""Validation contact sheets for the AnySD trainer (counterpart of
`anyedit_tpu/train/validation.py`): the editor runs on a fixed set of
(image, instruction) pairs each checkpoint interval and a PNG grid of
[orig | edited] goes to disk. The PNG is written by `core/png.py`, not
Pillow."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from anyedit_tpu_torch.core.png import write_png


def image_grid(images: Sequence[np.ndarray], cols: int | None = None,
               pad: int = 2) -> np.ndarray:
    """Stack HWC uint8 images (same size) into one grid image."""
    n = len(images)
    cols = cols or min(4, n)
    rows = (n + cols - 1) // cols
    h, w, c = images[0].shape
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                   255, np.uint8)
    for i, img in enumerate(images):
        r, cc = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             cc * (w + pad):cc * (w + pad) + w] = img
    return grid


def log_validation(edit_fn: Callable[[np.ndarray, str], np.ndarray],
                   val_pairs: Sequence[tuple[np.ndarray, str]],
                   out_dir: str | Path, step: int) -> Path:
    """edit_fn(image, instruction) -> edited image. Saves
    `<out_dir>/val_step_{step}.png` with [orig | edited] per pair."""
    tiles: list[np.ndarray] = []
    for img, instruction in val_pairs:
        tiles.append(img)
        tiles.append(np.asarray(edit_fn(img, instruction)))
    grid = image_grid(tiles, cols=2)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"val_step_{step}.png"
    write_png(path, grid)
    return path
