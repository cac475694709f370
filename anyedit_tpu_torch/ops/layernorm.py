"""LayerNorm over the last dimension: the hand kernel K5 and its plain version.

Counterpart of `anyedit_tpu/models/layers.py::LayerNorm`, which XLA fuses on
the TPU. Eager PyTorch runs the plain version as ten kernels (the fp32 copy,
mean, var, the four broadcast ops, rsqrt, the cast), each a pass over the
activation, so every `models/layers.py::LayerNorm` of the port's models goes
through `layer_norm`: K5 (`csrc/layer_norm.cu`, one pass) on CUDA tensors, the
plain version on CPU tensors.

The trainers differentiate through it. K5 writes into a fresh tensor through
a raw pointer, so its output has no autograd history of its own: under grad,
`layer_norm` wraps the launch in `_LayerNormFn`, whose backward recomputes
through `layer_norm_plain` on the saved x, weight and bias
(`ops/recompute.py`, as K1's and K2's). The backward launches no K5.
"""

from __future__ import annotations

import functools

import torch

from anyedit_tpu_torch.ops import _build
from anyedit_tpu_torch.ops.recompute import Recompute

# K5's launch plan (see `_k5_plan`): a thread keeps at most this many
# 16-byte accesses of its row in registers; one-warp rows go this many to a
# block; a row takes at most this many warps (a block of 256 threads).
_K5_MAX_VPL = 8
_K5_ROWS_PER_BLOCK = 4
_K5_MAX_WARPS = 8
_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=64)
def _k5_plan(c: int, elem_bytes: int, vector: bool):
    """K5's launch plan for rows of `c` elements of `elem_bytes` bytes:
    (vec, vpl, warps, rows_per_block). `vec` elements move as one access
    (16 bytes, or 1 where `vector` is False: C not a multiple of it or x not
    16-byte aligned); a row runs on the fewest warps (a power of two) whose
    threads cover it with at most `_K5_MAX_VPL` accesses each, `vpl` of
    them. One-warp rows share a block, `_K5_ROWS_PER_BLOCK` to it."""
    vec = 16 // elem_bytes if vector else 1
    nvec = c // vec
    warps = 1
    while -(-nvec // (32 * warps)) > _K5_MAX_VPL:
        warps *= 2
    if warps > _K5_MAX_WARPS:
        raise ValueError(f"layer_norm: the kernel takes rows of at most "
                         f"{_K5_MAX_WARPS * 32 * _K5_MAX_VPL * vec} elements here, got {c}")
    vpl = -(-nvec // (32 * warps))
    return vec, vpl, warps, _K5_ROWS_PER_BLOCK if warps == 1 else 1


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5, dtype=torch.bfloat16) -> torch.Tensor:
    """The math of `models/layers.LayerNorm` in plain PyTorch: fp32 mean and
    two-pass variance over the last dim (no E[x^2] - E[x]^2), the affine in
    fp32, one rounding to `dtype`."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight + bias
    return y.to(dtype)


class _LayerNormFn(Recompute):
    """K5 forward, recompute backward: the gradients of `layer_norm_plain`
    at the saved inputs, for x and for weight and bias."""


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, dtype=torch.bfloat16) -> torch.Tensor:
    """LayerNorm over x's last dim with fp32 (C,) weight and bias, output in
    `dtype`.

    CPU tensors take the plain version. CUDA tensors launch K5, which takes
    bf16 or fp32 x (made contiguous first) and gives bf16 or fp32, with a
    contiguous (C,) weight and bias of any float dtype (taken in fp32);
    anything else raises. Under grad, with an input that requires it, the
    launch goes through `_LayerNormFn` (the same forward, a recompute
    backward); otherwise it is the direct call."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNormFn.apply(_layer_norm_launch, layer_norm_plain, x, weight, bias,
                                  eps, dtype)
    return _layer_norm_launch(x, weight, bias, eps, dtype)


def _layer_norm_launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float, dtype) -> torch.Tensor:
    """`layer_norm`'s forward on a device tensor: K5."""
    if x.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"layer_norm: the kernel takes and gives bf16 or fp32, got "
                        f"{x.dtype} to {dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    c = x.shape[-1]
    w = weight if weight.dtype == torch.float32 else weight.float()
    b = bias if bias.dtype == torch.float32 else bias.float()
    for name, p in (("weight", w), ("bias", b)):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be contiguous ({c},) on {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return y
    rows = x.numel() // c
    vector = x.data_ptr() % 16 == 0 and c * x.element_size() % 16 == 0 \
        and w.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    vec, vpl, warps, rows_per_block = _k5_plan(c, x.element_size(), vector)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.anyedit_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                 rows, c, float(eps), int(x.dtype == torch.bfloat16),
                                 int(dtype == torch.bfloat16), vec, vpl, warps,
                                 rows_per_block, stream)
    _build.check("layer_norm", err)
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
