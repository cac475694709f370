"""Canny edge detection on the tensor's device (counterpart of
`anyedit_tpu/ops/canny.py`).

Gaussian blur -> Sobel on a reflect-padded map -> non-maximum suppression
against the two neighbours along the gradient in 4 direction bins (the
neighbours taken by `roll`, so they wrap at the borders, as the JAX
package's `jnp.roll` does) -> double threshold -> a fixed number of
hysteresis dilations (weak pixels next to strong ones survive).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from anyedit_tpu_torch.ops.morphology import dilate, gaussian_blur

_KX = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def canny(gray: torch.Tensor, low: float = 100.0, high: float = 200.0,
          sigma: float = 1.0, hysteresis_iters: int = 4) -> torch.Tensor:
    """gray (H, W) in [0, 255] -> edges (H, W) uint8 in {0, 255}."""
    g = gaussian_blur(gray.float(), sigma)
    kx = torch.tensor(_KX, device=g.device)
    x4 = F.pad(g[None, None], (1, 1, 1, 1), mode="reflect")
    gx = F.conv2d(x4, kx[None, None])[0, 0]
    gy = F.conv2d(x4, kx.T.contiguous()[None, None])[0, 0]
    mag = torch.sqrt(gx * gx + gy * gy)
    deg = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)) + 180.0, 180.0)

    def shift(a, dy, dx):
        return torch.roll(a, (dy, dx), (0, 1))
    n0 = torch.maximum(shift(mag, 0, 1), shift(mag, 0, -1))       # 0 deg: E / W
    n45 = torch.maximum(shift(mag, -1, 1), shift(mag, 1, -1))
    n90 = torch.maximum(shift(mag, 1, 0), shift(mag, -1, 0))      # 90 deg: N / S
    n135 = torch.maximum(shift(mag, -1, -1), shift(mag, 1, 1))
    neighbor = torch.where((deg < 22.5) | (deg >= 157.5), n0,
                           torch.where(deg < 67.5, n45, torch.where(deg < 112.5, n90, n135)))
    nms = torch.where(mag >= neighbor, mag, torch.zeros_like(mag))
    strong = nms >= high
    weak = (nms >= low) & ~strong
    edges = strong
    for _ in range(hysteresis_iters):
        edges = edges | ((dilate(edges.float(), 3) > 0.5) & weak)
    return edges.to(torch.uint8) * 255


_LUMA = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32).double()


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) fp32 luma 0.299 R + 0.587 G + 0.114 B (fp32
    weights), rounded as the JAX package's contraction rounds it on the CPU:
    R's product, then G's and B's each fused into the sum (one rounding to
    fp32 a step). Each step runs in float64, where the products and sums of
    fp32 values below 2^8 are exact, so it rounds once, as a fused
    multiply-add does; the truncation of material_transfer's grey init
    depends on the last digit."""
    x = rgb.double()
    w = _LUMA.to(x.device)
    g = (x[..., 0] * w[0]).float().double()
    g = (x[..., 1] * w[1] + g).float().double()
    return (x[..., 2] * w[2] + g).float()
