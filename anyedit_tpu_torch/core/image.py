"""Image files and Pillow's resampling without Pillow.

The JAX trainers read their ledger images with Pillow (`Image.open(...)
.convert("RGB").resize(..., LANCZOS)`); the machine with the card has no
Pillow. `load_rgb` reads a PNG with the standard-library decoder of
`core/png.py` (any other format needs Pillow, imported then), and
`pil_resize` is Pillow's separable 8-bit resampling written out in numpy:
the same filter taps (computed in double with the C library's sin), the
same fixed-point coefficients (22 fractional bits, rounded half away from
zero), the horizontal pass first into a clipped uint8 image, then the
vertical pass, so its output equals `Image.resize`'s byte for byte.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from anyedit_tpu_torch.core.png import decode_png

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, method: str):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc`: for each
    output pixel its first input pixel and its int fixed-point taps."""
    fn, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    taps = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        w = [v / ww if ww != 0.0 else v for v in w]
        k = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
             else int(0.5 + v * (1 << _PRECISION_BITS)) for v in w]
        taps.append((xmin, np.asarray(k, np.int64)))
    return taps


def _pass(img: np.ndarray, out_size: int, axis: int, method: str) -> np.ndarray:
    """One 8-bit resampling pass along `axis` (0 rows, 1 columns)."""
    x = np.moveaxis(img.astype(np.int64), axis, 0)
    out = np.empty((out_size,) + x.shape[1:], np.int64)
    for i, (xmin, k) in enumerate(_coeffs(x.shape[0], out_size, method)):
        acc = np.tensordot(k, x[xmin:xmin + len(k)], axes=(0, 0))
        out[i] = acc + (1 << (_PRECISION_BITS - 1))
    out = np.clip(out >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resize(img_u8: np.ndarray, width: int, height: int,
               method: str = "lanczos") -> np.ndarray:
    """`Image.fromarray(img).resize((width, height), LANCZOS or BICUBIC)`
    for an (H, W, C) uint8 array: horizontal pass first, each pass only
    where the size changes."""
    x = np.asarray(img_u8, np.uint8)
    if x.shape[1] != width:
        x = _pass(x, width, 1, method)
    if x.shape[0] != height:
        x = _pass(x, height, 0, method)
    return x


def load_rgb(path: str | Path) -> np.ndarray:
    """`Image.open(path).convert("RGB")` as (H, W, 3) uint8: grey repeated,
    alpha dropped. PNGs need no Pillow."""
    data = Path(path).read_bytes()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        a = decode_png(data)
        return np.repeat(a[..., :1], 3, axis=-1) if a.shape[-1] <= 2 else a[..., :3].copy()
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))
