"""The readings of a synthesized pair against the reference's: both sides of
a caption-pair record are generated, so there is no source image whose
unchanged pixels would single out the edit (`checks.pair_readings`), and
every pixel of both written images is compared.

Per image (each checked record's input and edited side), the mean |P - R|
in levels and the share of its pixel values more than t levels off, t = 2,
4, 8, 16. Over the checked images:
  * `synth_mean_abs`, `synth_share_over_<t>`: the worst image's;
  * `synth_avg_share_over_<t>`: the mean over the images.
An image ends in a truncation to uint8 after a resize whose weights sum to
one within rounding, so its last level turns on rounding alone; the gaps of
a sound run come from the program's bf16 against the reference's fp32, and
their share beyond a few levels varies from image to image (a record's
two sides alike), so the mean over the images is the steadier reading."""

from __future__ import annotations

import math

SHARE_LEVELS = (2, 4, 8, 16)
NAMES = (("synth_mean_abs",) + tuple(f"synth_share_over_{t}" for t in SHARE_LEVELS)
         + tuple(f"synth_avg_share_over_{t}" for t in SHARE_LEVELS))


def image_readings(p, r) -> dict[str, float]:
    """The mean gap and the shares over each level of one (H, W, 3) uint8
    image against the reference's."""
    gap = (p.double() - r.double()).abs()
    out = {"mean_abs": float(gap.mean())}
    for t in SHARE_LEVELS:
        out[f"share_over_{t}"] = float((gap > t).double().mean())
    return out


def synth_readings(got, want) -> dict[str, float]:
    """got, want: the same number of (H, W, 3) uint8 tensors, in pairs."""
    if len(got) != len(want) or not got or any(p.shape != r.shape for p, r in zip(got, want)):
        return dict.fromkeys(NAMES, math.inf)
    per = [image_readings(p, r) for p, r in zip(got, want)]
    out = {"synth_mean_abs": max(x["mean_abs"] for x in per)}
    for t in SHARE_LEVELS:
        k = f"share_over_{t}"
        out[f"synth_{k}"] = max(x[k] for x in per)
        out[f"synth_avg_{k}"] = sum(x[k] for x in per) / len(per)
    return out
