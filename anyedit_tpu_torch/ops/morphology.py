"""Mask morphology on the tensor's device: dilate and Gaussian blur.

Counterpart of `anyedit_tpu/ops/morphology.py`, with its border handling:
`dilate` pads k // 2 on each side with the max's identity (so an even k
grows the map by one, as `lax.reduce_window` does), and `gaussian_blur`
reflect-pads (numpy "reflect": the edge is not repeated) by the radius
before two valid 1-D convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, kernel_size: int = 3, iterations: int = 1) -> torch.Tensor:
    """Dilation with a square structuring element over the trailing (H, W)
    of a (..., H, W) mask (cv2.dilate parity); any dtype, same dtype out."""
    lead, (h, w) = mask.shape[:-2], mask.shape[-2:]
    # float64 holds every int32 and bool value exactly; the padding is -inf
    x = mask.reshape(-1, 1, h, w).to(torch.float64 if not mask.is_floating_point()
                                      else mask.dtype)
    for _ in range(iterations):
        x = F.max_pool2d(x, kernel_size, stride=1, padding=kernel_size // 2)
    return x.reshape(lead + x.shape[-2:]).to(mask.dtype)


def gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur over the trailing (H, W) of (..., H, W), in
    fp32, returned in the input's dtype."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = gaussian_kernel1d(sigma, radius, img.device)
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.float().reshape(-1, 1, h, w)
    x = F.pad(x, (radius,) * 4, mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(lead + (h, w)).to(img.dtype)
