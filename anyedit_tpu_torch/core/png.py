"""A minimal PNG writer and reader on the standard library (zlib + struct).

The executor writes its `edited_img/`, `input_img/` and `mask/` outputs with
it, so the port needs no imaging package at run time. 8-bit grayscale, RGB
or RGBA; every row with filter type 0; one IDAT chunk. `decode_png` reads
8-bit, non-interlaced grayscale, grey + alpha, RGB and RGBA PNGs with any
of the five row filters (what the writer and common encoders emit); the
trainers read their ledger images with it.
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


_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # PNG colour type -> channels


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C the file's channels (1 to 4)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("decode_png: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"decode_png: 8-bit non-interlaced grey/RGB(A) only, got depth "
                         f"{depth}, colour type {ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = row
        elif f == 1:
            cur = (row.reshape(w, ch).cumsum(axis=0) & 255).reshape(stride)
        elif f == 2:
            cur = (row + prev) & 255
        elif f in (3, 4):
            # byte i depends on byte i - ch of the same row: walk the pixels
            cur = np.zeros(stride, np.int32)
            left = np.zeros(ch, np.int32)
            upleft = np.zeros(ch, np.int32)
            for x in range(0, stride, ch):
                up = prev[x:x + ch]
                pred = (left + up) // 2 if f == 3 else _paeth(left, up, upleft)
                cur[x:x + ch] = (row[x:x + ch] + pred) & 255
                left, upleft = cur[x:x + ch], up
        else:
            raise ValueError(f"decode_png: unknown row filter {f}")
        out[y], prev = cur, cur
    return out.astype(np.uint8).reshape(h, w, ch)


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
