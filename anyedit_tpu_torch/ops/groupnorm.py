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
"""

from __future__ import annotations

import torch

from anyedit_tpu_torch.ops import _build


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


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over NCHW (x: (N, C, *spatial)) with optional fused SiLU.

    CPU tensors take the plain version. CUDA tensors launch K2, which takes
    contiguous bf16 or fp32 x with fp32 scale and bias; anything else
    raises."""
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
    y = torch.empty_like(x)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.anyedit_group_norm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                 y.data_ptr(), n, c, hw, num_groups, float(eps),
                                 int(silu), int(x.dtype == torch.bfloat16), stream)
    _build.check("group_norm", err)
    group_norm.launches += 1
    return y


group_norm.launches = 0


def group_norm_silu(x, scale, bias, num_groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    return group_norm(x, scale, bias, num_groups, eps, silu=True)
