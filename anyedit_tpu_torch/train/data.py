"""AnySD training data: success-ledger examples, the per-edit-type mixture
and host-side pixel batches (counterpart of `anyedit_tpu/train/data.py`).

Copies of the JAX module's functions. The sampler draws from numpy's
`default_rng(seed)` exactly as the JAX one does, so both packages pick the
same examples in the same order. The JAX `_load_resized` reads with Pillow
(`convert("RGB")`, `resize(LANCZOS)`); here `core/image.py` gives the same
bytes without Pillow for PNGs (the machine with the card has none).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from anyedit_tpu_torch.core.image import load_rgb, pil_resize
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.train.anysd import expert_id


@dataclasses.dataclass
class TrainExample:
    record: InstructionRecord
    input_file: Path          # original image
    edited_file: Path         # edit target


def examples_from_ledger(ledger_path: str | Path,
                         image_root: str | Path | None = None
                         ) -> list[TrainExample]:
    """Collect `success` rows with both image files resolvable."""
    root = Path(image_root) if image_root else None
    out: list[TrainExample] = []
    with open(ledger_path) as f:
        for line in f:
            row = json.loads(line)
            if row.get("status") != "success":
                continue
            payload = row.get("payload") or {}
            rec = InstructionRecord.from_json(row["record"])
            edited = payload.get("edited_file")
            inp = payload.get("input_file") or rec.image_file
            if not edited or not inp:
                continue
            ip = Path(inp) if Path(inp).is_absolute() or root is None \
                else root / inp
            ep = Path(edited)
            if ip.exists() and ep.exists():
                out.append(TrainExample(rec, ip, ep))
    return out


class MixtureSampler:
    """Weighted sampling over per-edit-type buckets: weight defaults to
    bucket size (plain uniform over records); pass `weights` to rebalance
    domains."""

    def __init__(self, examples: Sequence[TrainExample],
                 weights: Optional[dict[str, float]] = None, seed: int = 0):
        if not examples:
            raise ValueError("no training examples")
        self.buckets: dict[str, list[TrainExample]] = {}
        for ex in examples:
            self.buckets.setdefault(ex.record.edit_type, []).append(ex)
        self.types = sorted(self.buckets)
        w = np.array([(weights or {}).get(t, float(len(self.buckets[t])))
                      for t in self.types], np.float64)
        self.probs = w / w.sum()
        self.rng = np.random.default_rng(seed)

    def sample(self) -> TrainExample:
        t = self.types[int(self.rng.choice(len(self.types), p=self.probs))]
        bucket = self.buckets[t]
        return bucket[int(self.rng.integers(len(bucket)))]


def _load_resized(path: Path, size: int) -> np.ndarray:
    img = pil_resize(load_rgb(path), size, size, "lanczos")
    return img.astype(np.float32) / 127.5 - 1.0     # [-1, 1]


def pixel_batches(sampler: MixtureSampler, batch_size: int, resolution: int,
                  steps: int,
                  tokenize: Callable[[str], np.ndarray]) -> Iterator[dict]:
    """Yield host-side pixel batches:
    {edited_px, orig_px (B,S,S,3 in [-1,1]), text_ids (B,L), task_id (B,)}."""
    for _ in range(steps):
        exs = [sampler.sample() for _ in range(batch_size)]
        yield {
            "edited_px": np.stack([_load_resized(e.edited_file, resolution)
                                   for e in exs]),
            "orig_px": np.stack([_load_resized(e.input_file, resolution)
                                 for e in exs]),
            "text_ids": np.concatenate([tokenize(e.record.edit)
                                        for e in exs], axis=0),
            "task_id": np.asarray([expert_id(e.record.edit_type)
                                   for e in exs], np.int32),
        }
