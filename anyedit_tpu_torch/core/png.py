"""A minimal PNG writer on the standard library (zlib + struct).

The executor writes its `edited_img/`, `input_img/` and `mask/` outputs with
it, so the port needs no imaging package at run time. 8-bit grayscale, RGB
or RGBA; every row with filter type 0; one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in {1, 3, 4} -> PNG bytes."""
    a = np.ascontiguousarray(image)
    if a.dtype != np.uint8:
        raise TypeError(f"encode_png: uint8 expected, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png: 1, 3 or 4 channels expected, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(image))
