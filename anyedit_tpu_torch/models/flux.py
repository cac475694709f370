"""Flux, the rectified-flow transformer of textual_change (counterpart of
`anyedit_tpu/models/flux.py`).

  * double-stream blocks: MM-DiT joint attention over [text, image] with
    per-stream modulation, projections and FFNs;
  * single-stream blocks over the joint sequence: one Linear gives q, k, v
    and the MLP's input, one Linear maps [attention, gelu(mlp)] back;
  * 3-axis RoPE (0, h, w) on q and k, rotating interleaved pairs in fp32;
  * the conditioning vector: timestep, optional guidance and pooled
    CLIP-L embeddings.
The residual streams are fp32; block Linears, the patch, context and output
projections run in `dtype`; the modulations and the timestep, guidance and
pooled embeddings are fp32 Linears, as the JAX package's `Dense(...,
dtype=float32)`. LayerNorms are affine-free with eps 1e-6; GELU is the tanh
form. The joint attention is `sdpa_xla` in the JAX package; here it takes
K6 (`flash_sdpa`) where `takes_k6` holds (CUDA, bf16, head dim 128: the
published width, W8A8 included) and the plain `sdpa` otherwise (the CPU,
fp32, `TINY_FLUX`'s head dim 16).

Submodules carry the diffusers `FluxTransformer2DModel` names (x_embedder,
context_embedder, time_text_embed.*, transformer_blocks.N.{norm1,
norm1_context, attn, ff, ff_context}, single_transformer_blocks.N.{norm,
attn, proj_mlp, proj_out}, norm_out, proj_out); the JAX package fuses the
q, k, v (and the single blocks' MLP input) into one Dense each, which
`weights/bridge.py` splits. `norm_out` holds diffusers' (scale, shift)
order. The modulations are zero at the seeded init, as in the JAX package.

With `quant`, the block q, k, v, out-projection and FFN Linears are W8A8
(`ops/quant.make_dense`); modulations, embeddings, RoPE, attention and the
head stay float.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import timestep_embedding
from anyedit_tpu_torch.models.mmdit import _FFN, _AdaLN, _MLPEmbed, _RMSNormQK, _ln, modulate
from anyedit_tpu_torch.ops.attention import flash_sdpa, sdpa
from anyedit_tpu_torch.ops.quant import make_dense


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 16
    patch: int = 2
    dim: int = 3072
    heads: int = 24
    double_depth: int = 19
    single_depth: int = 38
    context_dim: int = 4096
    pooled_dim: int = 768
    axes_dim: tuple[int, ...] = (16, 56, 56)   # sums to head_dim 128
    guidance_embed: bool = False               # schnell: False, dev: True
    dtype: Any = torch.bfloat16
    quant: bool = False


FLUX_SCHNELL = FluxConfig()
FLUX_DEV = FluxConfig(guidance_embed=True)
TINY_FLUX = FluxConfig(in_channels=4, dim=32, heads=2, double_depth=1, single_depth=2,
                       context_dim=16, pooled_dim=8, axes_dim=(4, 6, 6))


def rope_freqs(ids: torch.Tensor, axes_dim: tuple[int, ...],
               theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """ids (L, n_axes) -> (cos, sin), each (L, head_dim / 2) fp32."""
    cos, sin = [], []
    for ax, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=ids.device)
                                 / half))
        ang = ids[:, ax:ax + 1].float() * freqs[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, L, D), D = 2 |cos|: rotate the interleaved pairs (x[2i],
    x[2i + 1]) in fp32; the result in x's dtype."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def make_ids(gh: int, gw: int, txt_len: int, device=None) -> torch.Tensor:
    """Token ids (txt_len + gh gw, 3) fp32: text ids zero, image ids (0, h, w)."""
    f32 = dict(dtype=torch.float32, device=device)
    hh = torch.arange(gh, **f32).repeat_interleave(gw)
    ww = torch.arange(gw, **f32).repeat(gh)
    img = torch.stack([torch.zeros_like(hh), hh, ww], dim=-1)
    return torch.cat([torch.zeros((txt_len, 3), **f32), img], dim=0)


def takes_k6(device_type: str, dtype: torch.dtype, head_dim: int) -> bool:
    """Flux's attention route: K6 on CUDA bf16 at head dim 128, `sdpa`
    everywhere else."""
    return device_type == "cuda" and dtype == torch.bfloat16 and head_dim == 128


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The joint attention of both block types, heads merged: (B, L, H D)."""
    attend = flash_sdpa if takes_k6(q.device.type, q.dtype, q.shape[-1]) else sdpa
    return _merge(attend(q, k, v))


def k6_per_call(cfg: "FluxConfig", device) -> int:
    """K6 launches of one Flux call on `device`: one a block where the
    route takes it (q, k and v are in `cfg.dtype`), else 0. `Flux.
    k6_launches` is this on the module's own device."""
    head_dim = cfg.dim // cfg.heads
    if not takes_k6(torch.device(device).type, cfg.dtype, head_dim):
        return 0
    return cfg.double_depth + cfg.single_depth


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, heads, d // heads).permute(0, 2, 1, 3)


def _merge(o: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = o.shape
    return o.permute(0, 2, 1, 3).reshape(b, l, h * hd)


class _DoubleAttention(nn.Module):
    """Image (to_q/k/v, to_out.0) and text (add_q/k/v_proj, to_add_out)
    projections, and the per-head RMS norms of q and k of each stream."""

    def __init__(self, c: FluxConfig, kw: dict, device):
        super().__init__()
        d, hd = c.dim, c.dim // c.heads
        self.to_q, self.to_k, self.to_v = (make_dense(d, d, **kw) for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (make_dense(d, d, **kw)
                                                             for _ in range(3))
        self.to_out = nn.ModuleList([make_dense(d, d, **kw)])
        self.to_add_out = make_dense(d, d, **kw)
        self.norm_q, self.norm_k, self.norm_added_q, self.norm_added_k = (
            _RMSNormQK(hd, device) for _ in range(4))


class DoubleBlock(nn.Module):
    def __init__(self, c: FluxConfig, device=None):
        super().__init__()
        self.cfg = c
        kw = dict(quant=c.quant, dtype=c.dtype, device=device)
        self.norm1 = _AdaLN(c.dim, 6, device)
        self.norm1_context = _AdaLN(c.dim, 6, device)
        self.attn = _DoubleAttention(c, kw, device)
        self.ff = _FFN(c.dim, kw)
        self.ff_context = _FFN(c.dim, kw)

    def forward(self, img, txt, cond, cos, sin):
        c, a = self.cfg, self.attn
        si1, sc1, g1, si2, sc2, g2 = self.norm1(cond).chunk(6, dim=-1)
        ti1, tc1, tg1, ti2, tc2, tg2 = self.norm1_context(cond).chunk(6, dim=-1)
        img_n = modulate(_ln(img), si1, sc1).to(c.dtype)
        txt_n = modulate(_ln(txt), ti1, tc1).to(c.dtype)

        def qkv(x, projs, norms):
            q, k, v = (_heads(p(x), c.heads) for p in projs)
            return norms[0](q), norms[1](k), v
        qi, ki, vi = qkv(img_n, (a.to_q, a.to_k, a.to_v), (a.norm_q, a.norm_k))
        qt, kt, vt = qkv(txt_n, (a.add_q_proj, a.add_k_proj, a.add_v_proj),
                         (a.norm_added_q, a.norm_added_k))
        q = apply_rope(torch.cat([qt, qi], dim=2), cos, sin)    # text first
        k = apply_rope(torch.cat([kt, ki], dim=2), cos, sin)
        o = _attend(q, k, torch.cat([vt, vi], dim=2))
        lt = txt.shape[1]
        ot, oi = o[:, :lt], o[:, lt:]

        img = img + g1[:, None] * a.to_out[0](oi).float()
        img = img + g2[:, None] * self.ff(modulate(_ln(img), si2, sc2).to(c.dtype)).float()
        txt = txt + tg1[:, None] * a.to_add_out(ot).float()
        txt = txt + tg2[:, None] * self.ff_context(
            modulate(_ln(txt), ti2, tc2).to(c.dtype)).float()
        return img, txt


class _SingleAttention(nn.Module):
    def __init__(self, c: FluxConfig, kw: dict, device):
        super().__init__()
        d = c.dim
        self.to_q, self.to_k, self.to_v = (make_dense(d, d, **kw) for _ in range(3))
        self.norm_q, self.norm_k = (_RMSNormQK(d // c.heads, device) for _ in range(2))


class SingleBlock(nn.Module):
    """Parallel attention and MLP over the joint sequence."""

    def __init__(self, c: FluxConfig, device=None):
        super().__init__()
        self.cfg = c
        kw = dict(quant=c.quant, dtype=c.dtype, device=device)
        self.norm = _AdaLN(c.dim, 3, device)
        self.attn = _SingleAttention(c, kw, device)
        self.proj_mlp = make_dense(c.dim, 4 * c.dim, **kw)
        self.proj_out = make_dense(5 * c.dim, c.dim, **kw)

    def forward(self, x, cond, cos, sin):
        c, a = self.cfg, self.attn
        shift, scale, gate = self.norm(cond).chunk(3, dim=-1)
        h = modulate(_ln(x), shift, scale).to(c.dtype)
        q = apply_rope(a.norm_q(_heads(a.to_q(h), c.heads)), cos, sin)
        k = apply_rope(a.norm_k(_heads(a.to_k(h), c.heads)), cos, sin)
        o = _attend(q, k, _heads(a.to_v(h), c.heads))
        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        return x + gate[:, None] * self.proj_out(torch.cat([o, mlp], dim=-1)).float()


class Flux(nn.Module):
    """(latents NHWC, t (B,) = sigma * 1000, context (B, L, Dc), pooled
    (B, Dp), guidance (B,) or None) -> velocity NHWC fp32."""

    def __init__(self, cfg: FluxConfig = FLUX_SCHNELL, device=None):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        self.x_embedder = nn.Linear(c.patch ** 2 * c.in_channels, c.dim, **kw)
        self.context_embedder = nn.Linear(c.context_dim, c.dim, **kw)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = _MLPEmbed(256, c.dim, device)
        if c.guidance_embed:
            self.time_text_embed.guidance_embedder = _MLPEmbed(256, c.dim, device)
        self.time_text_embed.text_embedder = _MLPEmbed(c.pooled_dim, c.dim, device)
        self.transformer_blocks = nn.ModuleList([DoubleBlock(c, device)
                                                 for _ in range(c.double_depth)])
        self.single_transformer_blocks = nn.ModuleList([SingleBlock(c, device)
                                                        for _ in range(c.single_depth)])
        self.norm_out = _AdaLN(c.dim, 2, device)
        self.proj_out = nn.Linear(c.dim, c.patch ** 2 * c.in_channels, **kw)

    @property
    def k6_launches(self) -> int:
        """K6 launches of one call on the parameters' device
        (`k6_per_call`): known without running the call, so it holds while
        the call replays from a CUDA graph, where no wrapper counts."""
        return k6_per_call(self.cfg, next(self.parameters()).device)

    def forward(self, x, t, context, pooled, guidance: Optional[torch.Tensor] = None):
        c = self.cfg
        b, h, w, ch = x.shape
        p = c.patch
        gh, gw = h // p, w // p
        img = x.to(c.dtype).reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 2, 4, 5)
        img = self.x_embedder(img.reshape(b, gh * gw, p * p * ch)).float()
        txt = self.context_embedder(context.to(c.dtype)).float()

        tte = self.time_text_embed
        vec = tte.timestep_embedder(timestep_embedding(t, 256))
        if c.guidance_embed:
            vec = vec + tte.guidance_embedder(timestep_embedding(guidance, 256))
        vec = vec + tte.text_embedder(pooled)

        cos, sin = rope_freqs(make_ids(gh, gw, context.shape[1], x.device), c.axes_dim)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, vec, cos, sin)
        seq = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            seq = block(seq, vec, cos, sin)
        img = seq[:, context.shape[1]:]

        sc, sh = self.norm_out(vec).chunk(2, dim=-1)
        out = self.proj_out(modulate(_ln(img), sh, sc).to(c.dtype))
        out = out.reshape(b, gh, gw, p, p, c.in_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, c.in_channels).float()
