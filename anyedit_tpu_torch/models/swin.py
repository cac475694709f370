"""Swin Transformer backbone, GroundingDINO's vision tower (Swin-B) and the
UperNet segmenter's (Swin-T) (counterpart of `anyedit_tpu/models/swin.py`).

Submodules carry the official Swin names (patch_embed.proj / .norm,
layers.I.blocks.J.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2},
layers.I.downsample.{norm, reduction} after stage I, norm{I} on each output
stage). Tokens stay (B, H, W, C); the patch conv runs NCHW. As in the JAX
module: the map is zero-padded after norm1 to whole windows (at 800 px,
stage 0 is 200 x 200 with 12-wide windows), shifted blocks roll by
-window/2 and add the static `_shift_mask`, q is scaled by hd^-0.5 in the
compute dtype before the product, and the outputs are the stages of
`out_indices` (strides 8, 16, 32 for Swin-B) after their norm.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm, Linear, SameConv2d
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 128                     # Swin-B
    depths: tuple[int, ...] = (2, 2, 18, 2)
    heads: tuple[int, ...] = (4, 8, 16, 32)
    window: int = 12                         # swin_B_384_22k
    patch: int = 4
    out_indices: tuple[int, ...] = (1, 2, 3)
    dtype: Any = torch.bfloat16


SWIN_B = SwinConfig()
SWIN_T = SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window=7)
TINY_SWIN = SwinConfig(embed_dim=16, depths=(1, 1), heads=(2, 2), window=4,
                       out_indices=(0, 1))


def _rel_pos_index(w: int) -> np.ndarray:
    """Static (w^2, w^2) index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(hp: int, wp: int, w: int, shift: int) -> np.ndarray:
    """Static additive mask (nW, w^2, w^2) for shifted-window attention."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _static(kind: str, device: torch.device, *args) -> torch.Tensor:
    """The block's static index and mask tensors, built once per device."""
    fn = _rel_pos_index if kind == "index" else _shift_mask
    return torch.from_numpy(fn(*args)).to(device)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, kw):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, **kw)
        self.proj = Linear(dim, dim, **kw)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads, device=kw["device"]))
        self.param_init = {"relative_position_bias_table": 0.02}


class _Mlp(nn.Module):
    def __init__(self, dim: int, kw):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim, **kw)
        self.fc2 = Linear(4 * dim, dim, **kw)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads, self.window, self.shift = heads, window, shift
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = _WindowAttention(dim, heads, window, kw)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = _Mlp(dim, kw)

    def forward(self, x):
        b, h, w, ch = x.shape
        ws, sh = self.window, self.shift
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        hp, wp = h + ph, w + pw
        nwh, nww = hp // ws, wp // ws
        y = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph))
        if sh:
            y = torch.roll(y, (-sh, -sh), dims=(1, 2))
        y = y.reshape(b, nwh, ws, nww, ws, ch).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b * nwh * nww, ws * ws, ch)

        hd = ch // self.heads
        qkv = self.attn.qkv(y).reshape(-1, ws * ws, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        idx = _static("index", x.device, ws)
        bias = self.attn.relative_position_bias_table[idx.reshape(-1)]
        bias = bias.reshape(ws * ws, ws * ws, self.heads).permute(2, 0, 1)[None]
        if sh:
            smask = _static("shift", x.device, hp, wp, ws, sh)
            bias = bias + smask[:, None].repeat(b, 1, 1, 1)
        out = sdpa(q, k, v, scale=1.0, bias=bias)
        out = self.attn.proj(out.permute(0, 2, 1, 3).reshape(-1, ws * ws, ch))

        out = out.reshape(b, nwh, nww, ws, ws, ch).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, hp, wp, ch)
        if sh:
            out = torch.roll(out, (sh, sh), dims=(1, 2))
        x = x + out[:, :h, :w]
        y = F.gelu(self.mlp.fc1(self.norm2(x)))     # exact erf, as torch nn.GELU
        return x + self.mlp.fc2(y)


class _PatchEmbed(nn.Module):
    def __init__(self, c: SwinConfig, device):
        super().__init__()
        self.proj = SameConv2d(3, c.embed_dim, c.patch, stride=c.patch, dtype=c.dtype,
                               device=device)
        self.norm = LayerNorm(c.embed_dim, dtype=c.dtype, device=device)


class _PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype=dtype, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x):
        """2x2 concat -> LN -> linear to 2*dim (odd maps padded by one)."""
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """(B, H, W, 3) -> {stride: (B, H/s, W/s, C_s)} multi-scale features."""

    def __init__(self, cfg: SwinConfig = SWIN_B, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg, device)
        stages = []
        for si, depth in enumerate(c.depths):
            dim = c.embed_dim * 2 ** si
            blocks = [SwinBlock(dim, c.heads[si], c.window,
                                0 if bi % 2 == 0 else c.window // 2, c.dtype, device)
                      for bi in range(depth)]
            down = (_PatchMerging(dim, c.dtype, device)
                    if si != len(c.depths) - 1 else None)
            stages.append(_Stage(blocks, down))
            if si in c.out_indices:
                self.add_module(f"norm{si}", LayerNorm(dim, dtype=c.dtype, device=device))
        self.layers = nn.ModuleList(stages)

    def forward(self, x):
        c = self.cfg
        x = self.patch_embed.proj(x.to(c.dtype).permute(0, 3, 1, 2))
        x = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        outs = {}
        for si, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x)
            if si in c.out_indices:
                outs[c.patch * 2 ** si] = getattr(self, f"norm{si}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
