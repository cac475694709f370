"""The numbers that decide `correct`, each beside its limit.

A number passes when it is at most its limit. The limits live in the cell's file
(`workloads/<cell>.json`, "limits"), set from the readings that `PERF.md`
lists: the program's sound runs below and the control above."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


@dataclasses.dataclass
class Number:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def as_dict(self) -> dict:
        return {"value": self.value, "limit": self.limit, "ok": self.ok}


@contextlib.contextmanager
def plain_fp32():
    """TF32 off for matrix products and convolutions while the reference
    runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


SHARE_LEVELS = (2, 4, 8)


def pair_readings(originals, got, want) -> dict[str, float]:
    """Over the checked pairs, the worst record's readings of the program's
    pair P against the reference's pair R, X the original:
      * `pair_rel_l2` = |P - R| / |R - X|, the gap against the edit the
        reference made;
      * `pair_mean_abs`: the mean |P - R| in levels over the image;
      * `pair_share_over_<t>`, t = 2, 4, 8: the share of the edited pixels
        (R != X) whose gap is more than t levels. A pair ends in a
        truncation to uint8 after a blend whose weights sum to one within
        rounding, so the last level of a pixel turns on rounding alone; the
        gaps of a sound run stay within a few levels."""
    names = ("pair_rel_l2", "pair_mean_abs") + tuple(f"pair_share_over_{t}"
                                                     for t in SHARE_LEVELS)
    worst = dict.fromkeys(names, 0.0)
    for x, p, r in zip(originals, got, want):
        if p.shape != r.shape:
            return dict.fromkeys(names, math.inf)
        p, r, x = p.double(), r.double(), x.double()
        gap = (p - r).abs()
        edited = r != x
        one = {"pair_rel_l2": float(torch.linalg.vector_norm(gap) / torch.clamp(
                   torch.linalg.vector_norm(r - x), min=1e-9)),
               "pair_mean_abs": float(gap.mean())}
        for t in SHARE_LEVELS:
            one[f"pair_share_over_{t}"] = (float((gap > t)[edited].double().mean())
                                           if bool(edited.any()) else 0.0)
        worst = {k: max(v, one[k]) for k, v in worst.items()}
    return worst


def numbers(readings: dict[str, float], limits: dict[str, float]) -> list[Number]:
    """The readings that have a limit, as Numbers; a reading with no limit
    is not compared."""
    return [Number(k, readings[k], limits[k]) for k in limits if k in readings]
