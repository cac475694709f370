"""Image resizing to the canonical buckets, on the tensor's device.

Counterpart of `anyedit_tpu/ops/resize.py`, which calls `jax.image.resize`.
PyTorch has no lanczos filter, and its bicubic is not JAX's, so the
separable weight matrices are built here the way
`jax.image.scale_and_translate` builds them: half-pixel centres, the kernel
widened by the downscale factor when antialiasing, columns normalised to sum
to one, and a dimension whose size does not change left untouched (so a
same-shape resize is the identity). "nearest" is JAX's index gather, source
index floor((i + 0.5) * in / out) in fp32 (torch's "nearest-exact", not its
"nearest"); it ignores `antialias`, as JAX does.
"""

from __future__ import annotations

import math

import torch

_EPS32 = 1.1920928955078125e-07   # np.finfo(np.float32).eps


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"lanczos": _lanczos3, "bilinear": _triangle}


def _weight_mat(in_size: int, out_size: int, kernel, antialias: bool,
                device) -> torch.Tensor:
    """(in_size, out_size) fp32 resampling weights, as JAX computes them."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(in_size: int, out_size: int) -> torch.Tensor:
    """The source index of each output position, as `jax.image.resize`'s
    nearest computes it: ((i + 0.5) * in) / out in fp32, floored. Built on
    the CPU (a CUDA division by a Python scalar may round otherwise)."""
    pos = (torch.arange(out_size, dtype=torch.float32) + 0.5) * in_size / out_size
    return torch.floor(pos).long()


def resize_image(img: torch.Tensor, height: int, width: int,
                 method: str = "lanczos", antialias: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) images; returns fp32 (integer input is promoted)."""
    if method == "nearest":
        x = img if img.is_floating_point() else img.float()
        nd = x.dim()
        for axis, size in ((nd - 3, height), (nd - 2, width)):
            if x.shape[axis] != size:
                x = x.index_select(axis, _nearest_index(x.shape[axis], size).to(x.device))
        return x
    if method not in _KERNELS:
        raise ValueError(f"resize_image: unsupported method {method!r}")
    kernel = _KERNELS[method]
    x = img if img.is_floating_point() else img.float()
    nd = x.dim()
    for axis, size in ((nd - 3, height), (nd - 2, width)):
        if x.shape[axis] == size:
            continue
        w = _weight_mat(x.shape[axis], size, kernel, antialias,
                        x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), w,
                                          dims=1), -1, axis)
    return x


def normalize_to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> fp32 [-1, 1] (diffusion convention)."""
    return img_u8.float() / 127.5 - 1.0


def denormalize_to_u8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, rounding half to even (as jnp.round does)."""
    x = torch.clamp((img.float() + 1.0) * 127.5, 0, 255)
    return torch.round(x).to(torch.uint8)


def imagenet_normalize(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float (..., C=3) -> ImageNet-normalized (detector convention)."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=img01.dtype, device=img01.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=img01.dtype, device=img01.device)
    return (img01 - mean) / std


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """Float -> uint8 the way a JAX `astype(uint8)` converts: saturate to
    [0, 255], then truncate toward zero."""
    return torch.clamp(x, 0, 255).to(torch.uint8)
