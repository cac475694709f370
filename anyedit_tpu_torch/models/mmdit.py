"""MM-DiT, the SD3-class diffusion transformer of SD3-UltraEdit (counterpart
of `anyedit_tpu/models/mmdit.py`).

Dual-stream blocks: image and text tokens carry their own adaptive-LayerNorm
modulation, projections and FFNs but share one joint attention over the
concatenated sequence, text first. The conditioning vector is the sinusoidal
timestep embedding plus the pooled text embedding, injected through adaLN
gates. The residual streams stay fp32; projections, attention and FFNs run
in `dtype`; the modulation Linears are fp32, as the JAX package's `Dense(...,
dtype=float32)`. LayerNorms are affine-free with eps 1e-6 (Flax's default),
the FFN's GELU is the tanh form (flax's `nn.gelu`).

Submodules carry the diffusers `SD3Transformer2DModel` names (pos_embed.proj,
pos_embed.pos_embed, context_embedder, time_text_embed.timestep_embedder /
text_embedder, transformer_blocks.N.norm1 / norm1_context / attn / ff /
ff_context, norm_out, proj_out), so a diffusers checkpoint loads by name.
The adaLN-Continuous modulations (`norm_out` and the last block's
`norm1_context`) hold diffusers' (scale, shift) order; the JAX package
stores them shift first, and `weights/bridge.py` swaps the halves.

With `quant`, the block projections and FFNs are W8A8 (`ops/quant.make_dense`);
the modulations, the patch, context, time and pooled embeddings and the head
stay float, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import timestep_embedding
from anyedit_tpu_torch.ops.attention import attention as attention_op
from anyedit_tpu_torch.ops.quant import make_dense

_LN_EPS = 1e-6   # Flax LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16              # SD3 latent channels
    out_channels: int = 16
    patch: int = 2
    dim: int = 1536                    # SD3-medium
    depth: int = 24
    heads: int = 24
    context_dim: int = 4096            # T5-XXL hidden
    pooled_dim: int = 2048             # CLIP-L + CLIP-bigG pooled, concatenated
    # learned positional grid, centre-cropped to the active grid (diffusers
    # PatchEmbed pos_embed_max_size=192 for SD3-medium)
    max_hw: int = 192
    # per-head RMS q/k norm: absent in SD3-medium, present in SD3.5
    qk_norm: bool = False
    dtype: Any = torch.bfloat16
    quant: bool = False


SD3_MEDIUM = MMDiTConfig()
# UltraEdit's wiring: noisy latents (16) + source latents (16) + mask (1)
SD3_ULTRAEDIT = dataclasses.replace(SD3_MEDIUM, in_channels=33)
SD35_MEDIUM = dataclasses.replace(SD3_MEDIUM, qk_norm=True)
TINY_MMDIT = MMDiTConfig(in_channels=4, out_channels=4, patch=2, dim=32, depth=2,
                         heads=2, context_dim=16, pooled_dim=8, max_hw=8)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm in fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=_LN_EPS)


class _RMSNormQK(nn.Module):
    """Per-head RMS norm on q or k, in fp32 (diffusers attn.norm_q etc.)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (n * self.weight).to(x.dtype)


class _AdaLN(nn.Module):
    """`linear`: the fp32 modulation Dense over silu(cond), zero at init."""

    def __init__(self, dim: int, n: int, device=None):
        super().__init__()
        self.linear = nn.Linear(dim, n * dim, device=device)
        self.linear.param_init = {"weight": ("const", 0.0)}

    def forward(self, cond):
        return self.linear(F.silu(cond))


class _FFN(nn.Module):
    """`net.0.proj` -> tanh-GELU -> `net.2` (diffusers FeedForward names)."""

    def __init__(self, dim: int, kw: dict):
        super().__init__()
        first = nn.Module()
        first.proj = make_dense(dim, 4 * dim, **kw)
        self.net = nn.ModuleList([first, nn.Identity(), make_dense(4 * dim, dim, **kw)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class _JointAttention(nn.Module):
    """The projections of the joint attention: image (to_q/k/v, to_out.0)
    and text (add_q/k/v_proj, to_add_out; the last block has no text output
    projection), and with `qk_norm` the per-head q/k norms (identities
    without)."""

    def __init__(self, c: MMDiTConfig, final: bool, kw: dict, device):
        super().__init__()
        d = c.dim
        self.to_q, self.to_k, self.to_v = (make_dense(d, d, **kw) for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (make_dense(d, d, **kw)
                                                             for _ in range(3))
        self.to_out = nn.ModuleList([make_dense(d, d, **kw)])
        if not final:
            self.to_add_out = make_dense(d, d, **kw)
        norm = (lambda: _RMSNormQK(d // c.heads, device)) if c.qk_norm else nn.Identity
        self.norm_q, self.norm_k, self.norm_added_q, self.norm_added_k = (norm() for _ in range(4))


class MMDiTBlock(nn.Module):
    def __init__(self, c: MMDiTConfig, final: bool = False, device=None):
        super().__init__()
        self.cfg, self.final = c, final
        kw = dict(quant=c.quant, dtype=c.dtype, device=device)
        self.norm1 = _AdaLN(c.dim, 6, device)
        # the last block's context gets a plain (scale, shift) norm only
        self.norm1_context = _AdaLN(c.dim, 2 if final else 6, device)
        self.attn = _JointAttention(c, final, kw, device)
        self.ff = _FFN(c.dim, kw)
        if not final:
            self.ff_context = _FFN(c.dim, kw)

    def _qkv(self, x, projs, q_norm, k_norm):
        c = self.cfg
        b, l = x.shape[:2]
        q, k, v = (p(x).reshape(b, l, c.heads, c.dim // c.heads).permute(0, 2, 1, 3)
                   for p in projs)
        return q_norm(q), k_norm(k), v

    def forward(self, img, txt, cond):
        c, a = self.cfg, self.attn
        si1, sc1, g1, si2, sc2, g2 = self.norm1(cond).chunk(6, dim=-1)
        if self.final:
            tc1, ti1 = self.norm1_context(cond).chunk(2, dim=-1)
        else:
            ti1, tc1, tg1, ti2, tc2, tg2 = self.norm1_context(cond).chunk(6, dim=-1)
        img_n = modulate(_ln(img), si1, sc1).to(c.dtype)
        txt_n = modulate(_ln(txt), ti1, tc1).to(c.dtype)
        qi, ki, vi = self._qkv(img_n, (a.to_q, a.to_k, a.to_v), a.norm_q, a.norm_k)
        qt, kt, vt = self._qkv(txt_n, (a.add_q_proj, a.add_k_proj, a.add_v_proj),
                               a.norm_added_q, a.norm_added_k)
        lt = txt.shape[1]
        o = attention_op(torch.cat([qt, qi], dim=2), torch.cat([kt, ki], dim=2),
                         torch.cat([vt, vi], dim=2), int8=c.quant)   # text first
        o = o.permute(0, 2, 1, 3).reshape(img.shape[0], -1, c.dim)
        ot, oi = o[:, :lt], o[:, lt:]

        img = img + g1[:, None, :] * a.to_out[0](oi).float()
        h = self.ff(modulate(_ln(img), si2, sc2).to(c.dtype))
        img = img + g2[:, None, :] * h.float()
        if self.final:
            return img, txt
        txt = txt + tg1[:, None, :] * a.to_add_out(ot).float()
        h = self.ff_context(modulate(_ln(txt), ti2, tc2).to(c.dtype))
        txt = txt + tg2[:, None, :] * h.float()
        return img, txt


class _PatchEmbed(nn.Module):
    def __init__(self, c: MMDiTConfig, device):
        super().__init__()
        self.proj = nn.Conv2d(c.in_channels, c.dim, c.patch, stride=c.patch,
                              dtype=c.dtype, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.max_hw ** 2, c.dim, device=device))
        self.param_init = {"pos_embed": 0.02}


class _MLPEmbed(nn.Module):
    """linear_1 -> SiLU -> linear_2, fp32."""

    def __init__(self, din: int, dim: int, device):
        super().__init__()
        self.linear_1 = nn.Linear(din, dim, device=device)
        self.linear_2 = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x.float())))


class MMDiT(nn.Module):
    """(latents NHWC, t (B,) in [0, 1000], context (B, L, Dc), pooled (B, Dp))
    -> velocity NHWC fp32."""

    def __init__(self, cfg: MMDiTConfig = SD3_MEDIUM, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.pos_embed = _PatchEmbed(c, device)
        self.context_embedder = nn.Linear(c.context_dim, c.dim, dtype=c.dtype, device=device)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = _MLPEmbed(256, c.dim, device)
        self.time_text_embed.text_embedder = _MLPEmbed(c.pooled_dim, c.dim, device)
        self.transformer_blocks = nn.ModuleList([
            MMDiTBlock(c, final=i == c.depth - 1, device=device) for i in range(c.depth)])
        self.norm_out = _AdaLN(c.dim, 2, device)
        self.proj_out = nn.Linear(c.dim, c.patch ** 2 * c.out_channels, dtype=c.dtype,
                                  device=device)

    def forward(self, x, t, context, pooled):
        c = self.cfg
        b, h, w, _ = x.shape
        p = c.patch
        gh, gw = h // p, w // p
        pe = self.pos_embed
        img = pe.proj(x.to(c.dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        top, left = (c.max_hw - gh) // 2, (c.max_hw - gw) // 2
        pos = pe.pos_embed.reshape(c.max_hw, c.max_hw, c.dim)[top:top + gh, left:left + gw]
        img = (img + pos.reshape(1, gh * gw, c.dim).to(c.dtype)).float()
        txt = self.context_embedder(context.to(c.dtype)).float()
        tte = self.time_text_embed
        cond = tte.timestep_embedder(timestep_embedding(t, 256)) + tte.text_embedder(pooled)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, cond)
        sc, sh = self.norm_out(cond).chunk(2, dim=-1)
        out = self.proj_out(modulate(_ln(img), sh, sc).to(c.dtype))
        out = out.reshape(b, gh, gw, p, p, c.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, c.out_channels).float()
