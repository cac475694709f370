"""Plain image arithmetic of the reference: separable resampling with the
`jax.image.scale_and_translate` weights (lanczos3, triangle), the [-1, 1] and
uint8 conversions, the feathered composite of color_alter (dilate by a 5 x 5
max, Gaussian blur with sigma 2, reflect padding), and a PNG reader and
writer on zlib. Written from those definitions; imports nothing of the
program."""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

_EPS32 = float(np.finfo(np.float32).eps)


def _lanczos3(x):
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > 3.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """(n_in, n_out) weights, antialiased: half-pixel centres, the kernel
    widened by the downscale factor, columns normalised to one."""
    inv = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32, device=device)
    ks = torch.clamp(inv, min=1.0)
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (pos[None] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / ks
    w = kernel(x)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * _EPS32,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[None], w, torch.zeros_like(w))


def resize(img: torch.Tensor, h: int, w: int, method: str = "lanczos") -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) fp32; an axis whose size is kept is
    left untouched."""
    kernel = {"lanczos": _lanczos3, "bilinear": _triangle}[method]
    x = img.float()
    nd = x.dim()
    for axis, size in ((nd - 3, h), (nd - 2, w)):
        if x.shape[axis] != size:
            wm = _weights(x.shape[axis], size, kernel, x.device)
            x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), wm, dims=1), -1, axis)
    return x


def to_unit(u8: torch.Tensor) -> torch.Tensor:
    return u8.float() / 127.5 - 1.0


def unit_to_u8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, rounded half to even."""
    return torch.round(torch.clamp((x.float() + 1.0) * 127.5, 0, 255)).to(torch.uint8)


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """Saturate to [0, 255], then truncate toward zero."""
    return torch.clamp(x, 0, 255).to(torch.uint8)


def feather(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) {0, 1} -> (H, W) blend weights: a 5 x 5 max, then a Gaussian
    of sigma 2 over radius 6 with numpy's "reflect" padding."""
    x = F.max_pool2d(mask.float()[None, None], 5, stride=1, padding=2)
    r, s = 6, 2.0
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32, device=x.device) / s) ** 2)
    k = k / k.sum()
    x = F.pad(x, (r,) * 4, mode="reflect")
    x = F.conv2d(F.conv2d(x, k.reshape(1, 1, -1, 1)), k.reshape(1, 1, 1, -1))
    return x[0, 0]


def composite(original_u8: torch.Tensor, edited_u8: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The edited region pasted onto the original through the feathered mask,
    truncated to uint8."""
    m = feather(mask)[..., None]
    return trunc_u8(edited_u8.float() * m + original_u8.float() * (1.0 - m))


# ---- PNG -------------------------------------------------------------------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(a: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes (filter 0, one IDAT)."""
    a = np.ascontiguousarray(a, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced grey, grey + alpha, RGB or RGBA PNG -> (H, W, C)
    uint8, any of the five row filters."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace:
        raise ValueError("only 8-bit non-interlaced PNGs")
    c = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = row
        elif f == 2:
            cur = (row + prev) & 255
        else:
            cur = np.zeros_like(row)
            for x in range(w * c):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                cc = prev[x - c] if x >= c else 0
                pred = {1: a, 3: (a + b) // 2, 4: int(_paeth(a, b, cc))}[int(f)]
                cur[x] = (row[x] + pred) & 255
        out[y] = prev = cur
    return out.reshape(h, w, c).astype(np.uint8)
