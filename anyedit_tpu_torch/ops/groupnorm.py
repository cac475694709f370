"""GroupNorm with optional fused SiLU: the hand kernel K2 and its plain version.

Counterpart of `anyedit_tpu/ops/groupnorm.py`. The port's models run their
convolutions channels-first, so these functions take NCHW (any number of
trailing spatial dims); the kernel wants each (image, group) as one
contiguous span.

The JAX package sends its model GroupNorms to XLA rather than to its Pallas
kernel only because a `pallas_call` breaks XLA's fusion on the TPU. Eager
PyTorch has no such fusion to lose, so every GroupNorm of the port's models
goes through `group_norm`: K2 on CUDA tensors, the plain version on CPU
tensors.

The trainers differentiate through it. K2 writes into a fresh tensor
through a raw pointer, so its output has no autograd history of its own:
under grad, `group_norm` wraps the launch in `_GroupNormFn`, whose backward
recomputes through `group_norm_plain` on the saved x, scale and bias (the
JAX `_gn_pallas_bwd`). The backward launches no K2.
"""

from __future__ import annotations

import functools

import torch

from anyedit_tpu_torch.ops import _build
from anyedit_tpu_torch.ops.recompute import Recompute

# K2's launch plan (see `_k2_plan`). The H100 has 132 SMs and 227 KB of
# shared memory a block; a cluster of more than 8 blocks is non-portable.
# The values were chosen on the card with `tools/bench_torch_ip2p.py
# --k2-plans` (K2's device time over the UNet's and the VAE's norms).
_K2_MAX_CLUSTER = 16
_K2_SMEM_CAP = 96 * 1024           # chunk bytes kept in shared memory: two blocks an SM
_K2_TARGET_BLOCKS = 132            # split a span until there is a block for every SM
_K2_MIN_CHUNK_BYTES = 16 * 1024    # or until its chunks are this small


@functools.lru_cache(maxsize=256)
def _k2_plan(n: int, c: int, hw: int, groups: int, elem_bytes: int):
    """K2's launch plan for x of (n, c, hw) in `elem_bytes`-wide elements:
    (cluster, chunk, cap, smem_bytes).

    Each (image, group) span of c / groups * hw elements runs on a cluster
    of `cluster` blocks; block r takes elements [r * chunk, (r + 1) * chunk)
    and keeps the first `cap` of them in shared memory (the rest it reads
    again from global memory). The cluster is the smallest power of two
    that gives a block for every SM with a chunk that fits, or that leaves
    chunks of `_K2_MIN_CHUNK_BYTES`; at most `_K2_MAX_CLUSTER`.
    `smem_bytes` adds 16 bytes for the chunk's 16-byte phase. Cached: the
    models call it with a few dozen shapes on every launch (clear the cache
    after changing the settings above)."""
    span = c // groups * hw
    vec = 16 // elem_bytes
    cap = _K2_SMEM_CAP // elem_bytes
    cluster = 1
    while True:
        chunk = -(-span // cluster)
        chunk = -(-chunk // vec) * vec
        if cluster == _K2_MAX_CLUSTER or chunk <= cap and (
                n * groups * cluster >= _K2_TARGET_BLOCKS
                or chunk * elem_bytes <= _K2_MIN_CHUNK_BYTES):
            break
        cluster *= 2
    cap = min(chunk, cap)
    return cluster, chunk, cap, cap * elem_bytes + 16


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5,
                     silu: bool = False) -> torch.Tensor:
    """The math of `models/layers.GroupNorm` in plain PyTorch: fp32
    per-channel mean and two-pass variance, pooled into the group variance
    E_g[var_c + (m_c - m_g)^2] (no E[x^2] - E[x]^2 cancellation), then
    y = x * a + b and optional SiLU. Output in x's dtype."""
    n, c = x.shape[:2]
    g = num_groups
    xf = x.float()
    red = tuple(range(2, x.dim()))
    m_c = xf.mean(dim=red)                                      # (N, C)
    v_c = xf.var(dim=red, correction=0)                         # (N, C)
    m_g = m_c.reshape(n, g, c // g).mean(dim=-1)                # (N, G)
    d_c = m_c - m_g.repeat_interleave(c // g, dim=-1)
    var_g = (v_c + d_c.square()).reshape(n, g, c // g).mean(dim=-1)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(c // g, dim=-1)
    a = inv_c * scale.float()
    b = bias.float() - m_g.repeat_interleave(c // g, dim=-1) * a
    bshape = (n, c) + (1,) * len(red)
    y = xf * a.reshape(bshape) + b.reshape(bshape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class _GroupNormFn(Recompute):
    """K2 forward, recompute backward: the gradients of `group_norm_plain`
    at the saved inputs, for x and for scale and bias."""


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over NCHW (x: (N, C, *spatial)) with optional fused SiLU.

    CPU tensors take the plain version. CUDA tensors launch K2, which takes
    contiguous bf16 or fp32 x with fp32 scale and bias; anything else
    raises. Under grad, with an input that requires it, the call goes
    through `_GroupNormFn` (the same forward, a recompute backward);
    otherwise it is the direct call."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormFn.apply(_group_norm_launch, group_norm_plain, x, scale, bias,
                                  num_groups, eps, silu)
    return _group_norm_launch(x, scale, bias, num_groups, eps, silu)


def _group_norm_launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """`group_norm`'s forward: the plain version for CPU tensors, else K2."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"group_norm: {c} channels in {num_groups} groups")
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm: the kernel takes bf16 or fp32, got {x.dtype}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (c,) or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError(f"group_norm: {name} must be contiguous fp32 ({c},) "
                             f"on {x.device}")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous NCHW")
    hw = x.numel() // (n * c)
    cluster, chunk, cap, smem = _k2_plan(n, c, hw, num_groups, x.element_size())
    y = torch.empty_like(x)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.anyedit_group_norm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                 y.data_ptr(), n, c, hw, num_groups, float(eps),
                                 int(silu), int(x.dtype == torch.bfloat16),
                                 cluster, chunk, cap, smem, stream)
    _build.check("group_norm", err)
    group_norm.launches += 1
    return y


group_norm.launches = 0


def group_norm_silu(x, scale, bias, num_groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    return group_norm(x, scale, bias, num_groups, eps, silu=True)
