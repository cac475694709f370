"""Shared building blocks for the port's diffusion and grounding models.

Counterpart of `anyedit_tpu/models/layers.py`. Conventions:
  * convolutions run channels-first (NCHW); token sequences are (B, L, C);
  * Linear and Conv weights are held in the model's compute dtype (bf16 by
    default): Flax's `dtype=bf16` rounds its fp32 params to bf16 at every
    use, so bf16 weights give the same values;
  * GroupNorm / LayerNorm affine parameters and statistics stay fp32;
  * attention is the pluggable `AttnProcessor` slot, as in the JAX package.
Submodule names follow the diffusers / HF checkpoint keys, so a converted
state dict loads by name (`weights/bridge.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.ops.attention import attention as attention_op
from anyedit_tpu_torch.ops.groupnorm import group_norm
from anyedit_tpu_torch.ops.layernorm import layer_norm
from anyedit_tpu_torch.ops.quant import QuantConv, make_dense


@dataclasses.dataclass(frozen=True)
class AttnMeta:
    """Static identity of one attention site (used by processors to route)."""

    name: str           # unique path, e.g. "down_1.tf_0.self"
    is_self: bool
    num_heads: int
    head_dim: int


# AttnProcessor: (q, k, v, meta, extra) -> out. q, k, v: (B, H, L, D).
AttnProcessor = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, AttnMeta,
                          Optional[dict[str, Any]]], torch.Tensor]


def default_processor(q, k, v, meta: AttnMeta, extra=None):
    del meta, extra
    return attention_op(q, k, v)


def int8_processor(q, k, v, meta: AttnMeta, extra=None):
    """W8A8 fast-mode attention. `attention(int8=True)` takes the same route
    as the default (as in the JAX package, where the int8 flash kernel
    measured slower at the SD shapes), so int8 in this mode means int8
    convs and projections only."""
    del meta, extra
    return attention_op(q, k, v, int8=True)


class MultiHeadAttention(nn.Module):
    """Projection wrapper around the processor slot (diffusers naming:
    to_q, to_k, to_v, to_out.0)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 out_dim: int, name_tag: str, is_self: bool,
                 context_dim: int | None = None, qkv_bias: bool = False,
                 dtype=torch.bfloat16, device=None, quant: bool = False):
        super().__init__()
        kv_dim = query_dim if context_dim is None else context_dim
        self.meta = AttnMeta(name_tag, is_self, num_heads, head_dim)
        self.quant = quant
        self._build(query_dim, kv_dim, num_heads * head_dim, out_dim, qkv_bias,
                    dict(dtype=dtype, device=device))

    def _build(self, query_dim, kv_dim, inner, out_dim, qkv_bias, kw):
        kw = dict(kw, quant=self.quant)
        self.to_q = make_dense(query_dim, inner, bias=qkv_bias, **kw)
        self.to_k = make_dense(kv_dim, inner, bias=qkv_bias, **kw)
        self.to_v = make_dense(kv_dim, inner, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList([make_dense(inner, out_dim, **kw)])

    def projections(self):
        """(q, k, v, out) projection modules."""
        return self.to_q, self.to_k, self.to_v, self.to_out[0]

    def forward(self, x, context=None, processor: AttnProcessor | None = None,
                extra=None):
        context = x if context is None else context
        to_q, to_k, to_v, to_out = self.projections()
        h, d = self.meta.num_heads, self.meta.head_dim
        b, lq = x.shape[:2]
        lkv = context.shape[1]

        def split(t, l):
            return t.reshape(b, l, h, d).permute(0, 2, 1, 3)
        q = split(to_q(x), lq)
        k = split(to_k(context), lkv)
        v = split(to_v(context), lkv)
        proc = processor or (int8_processor if self.quant else default_processor)
        out = proc(q, k, v, self.meta, extra)
        return to_out(out.permute(0, 2, 1, 3).reshape(b, lq, h * d))


class GroupNorm(nn.Module):
    """fp32-stat GroupNorm over NCHW, optionally with SiLU fused in (K2 on
    CUDA tensors)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False, device=None):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, self.silu)


class LayerNorm(nn.Module):
    """fp32-stat LayerNorm over the last dim; output in the compute dtype.
    K5 on CUDA tensors, the plain version on CPU tensors (`ops/layernorm.py`)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (SD convention), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def Conv3x3(in_channels: int, out_channels: int, stride: int = 1,
            dtype=torch.bfloat16, device=None, quant: bool = False) -> nn.Module:
    """3x3 conv with symmetric padding 1 (the JAX Conv3x3); `quant` gives
    its W8A8 drop-in under the same parameter names."""
    if quant:
        return QuantConv(in_channels, out_channels, 3, stride=stride, padding=1,
                         dtype=dtype, device=device)
    return nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1,
                     dtype=dtype, device=device)


def Conv1x1(in_channels: int, out_channels: int, dtype=torch.bfloat16,
            device=None) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, 1, dtype=dtype, device=device)


class Linear(nn.Linear):
    """nn.Linear that first casts its input to the weight's dtype, as a
    Flax `Dense(dtype=...)` does (the grounding models mix fp32 and bf16
    activations, as JAX's type promotion leaves them)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with Flax's default "SAME" padding (out = ceil(in /
    stride); the extra pixel of an odd total goes after, so a stride-2 3x3
    conv of an even map pads (0, 1)) and the input cast to the weight's
    dtype. NCHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         bias=bias, dtype=dtype, device=device)

    def forward(self, x):
        pads = []
        for size, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                              reversed(self.stride)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        return super().forward(x.to(self.weight.dtype))


class GEGLU(nn.Module):
    """Gated GELU. The JAX package calls `jax.nn.gelu`, whose default is the
    tanh approximation, so this uses it too (diffusers uses exact GELU)."""

    def __init__(self, dim: int, dim_out: int, dtype=torch.bfloat16, device=None,
                 quant: bool = False):
        super().__init__()
        self.proj = make_dense(dim, dim_out * 2, quant=quant, dtype=dtype,
                               device=device)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")


class Sampler(nn.Module):
    """Holds the `conv` of a diffusers down- or upsampler; the owner applies
    the padding or the 2x upsample around it."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class Stage(nn.Module):
    """One diffusers down, mid or up block: `resnets`, `attentions`, and
    `downsamplers` / `upsamplers` (each empty or one `Sampler`). The owner
    runs them in the JAX module's order."""

    def __init__(self, resnets, attentions=(), downsamplers=(), upsamplers=()):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.downsamplers = nn.ModuleList(downsamplers)
        self.upsamplers = nn.ModuleList(upsamplers)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW (the JAX double `jnp.repeat`)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class FeedForward(nn.Module):
    """GEGLU MLP; `net.0` / `net.2` match the diffusers keys (`net.1` is the
    parameter-free dropout slot)."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.bfloat16,
                 device=None, quant: bool = False):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * mult, dtype=dtype, device=device, quant=quant),
            nn.Identity(),
            make_dense(dim * mult, dim, quant=quant, dtype=dtype, device=device),
        ])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x
