"""Mask morphology on the tensor's device: dilate, Gaussian blur and the
Sobel gradient magnitude.

Counterpart of `anyedit_tpu/ops/morphology.py`, with its border handling:
`dilate` pads k // 2 on each side with the max's identity (so an even k
grows the map by one, as `lax.reduce_window` does), and `gaussian_blur`
reflect-pads (numpy "reflect": the edge is not repeated) by the radius
before two valid 1-D convolutions, and `sobel_magnitude` zero-pads by one.
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


def sobel_magnitude(gray: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude sqrt(gx^2 + gy^2) over the trailing (H, W)
    of (..., H, W), zero-padded, fp32: AnyDoor's high-frequency map
    (tool.py:366-386)."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=gray.device)
    lead, (h, w) = gray.shape[:-2], gray.shape[-2:]
    x = gray.float().reshape(-1, 1, h, w)
    gx = F.conv2d(x, kx[None, None], padding=1)
    gy = F.conv2d(x, kx.T.contiguous()[None, None], padding=1)
    return torch.sqrt(gx * gx + gy * gy).reshape(lead + (h, w))
