"""Checkpoint IO with torch alone (the counterpart of `load_torch_state`,
`save_params` and `load_params_file` in `anyedit_tpu/weights/convert.py`).

The GPU machine has neither the `safetensors` package nor Flax, so the
safetensors format is read and written here by hand: an 8-byte
little-endian header length, a JSON header mapping each name to its
`dtype`, `shape` and `data_offsets` (begin, end) into the byte buffer that
follows (and an optional `__metadata__` of strings), then the raw
little-endian bytes. Tensors come back as torch tensors on the CPU:
numpy has no bfloat16.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping

import torch

_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, in the header's order."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        out: dict[str, torch.Tensor] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this "
                                 f"reader does not take ({sorted(_DTYPES)})")
            dtype = _DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            if len(buf) != end - begin:
                raise ValueError(f"{path}: {name} runs past the end of the file")
            raw = torch.frombuffer(buf, dtype=torch.uint8) if buf else \
                torch.empty(0, dtype=torch.uint8)
            out[name] = raw.view(dtype).reshape(shape)
        return out


def write_safetensors(path: str | Path, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write `tensors` (any device; stored contiguous, little-endian) to
    one `.safetensors` file."""
    header: dict = {}
    blobs, offset = [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _flatten_groups(state: Mapping) -> dict:
    """IP-Adapter bins nest {'image_proj': {...}, 'ip_adapter': {...}};
    flatten to dotted keys (a no-op for a flat dict)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, Mapping):
            for k2, v2 in v.items():
                out[f"{k}.{k2}"] = v2
        else:
            out[k] = v
    return out


def load_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A checkpoint as one flat dict of CPU tensors: a `.safetensors`
    file, a torch `.bin` / `.pt` / `.pth` / `.ckpt` file (`weights_only`;
    a `"state_dict"` entry is unwrapped, and nested groups such as
    IP-Adapter's are flattened to dotted keys), an HF `*.index.json` shard
    index, or a directory of shards (how Llama-3-8B, T5-XXL and Flux ship)."""
    path = Path(path)
    if path.name.endswith(".index.json"):
        wm = json.loads(path.read_text())["weight_map"]
        out: dict[str, torch.Tensor] = {}
        for shard in sorted(set(wm.values())):
            out.update(load_checkpoint(path.parent / shard))
        return out
    if path.is_dir():
        idx = sorted(path.glob("*.index.json"))
        if idx:
            return load_checkpoint(idx[0])
        files = (sorted(path.glob("*.safetensors")) or sorted(path.glob("*.bin"))
                 or sorted(path.glob("*.pth")) or sorted(path.glob("*.ckpt")))
        if not files:
            raise FileNotFoundError(f"no checkpoint files under {path}")
        out = {}
        for f in files:
            out.update(load_checkpoint(f))
        return out
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return _flatten_groups(sd)
