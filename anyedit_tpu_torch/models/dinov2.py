"""DINOv2 ViT, the backbone of Depth-Anything-V2 (ViT-L) and AnyDoor's
reference encoder (ViT-g) (counterpart of `anyedit_tpu/models/dinov2.py`).

A ViT with a class token, LayerScale and the final norm applied to the
intermediate layers it returns. Submodules carry the official DINOv2 names
(`patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.i.{norm1, attn.qkv,
attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}`, `norm`), which
Depth-Anything-V2's checkpoint nests under `pretrained.`; ViT-g's FFN is the
hub's fused SwiGLU (`mlp.w12`, `mlp.w3`). Attention is the plain `sdpa`, as
the JAX module calls `sdpa_xla`: at 518 px the 1,370 tokens, and at 224 px
the 257, are off K1's route anyway. The LayerScale gains are fp32, so from
the first block on the residual stream is fp32, as JAX's promotion leaves
it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    img_size: int = 518
    patch: int = 14
    dim: int = 1024           # ViT-L
    depth: int = 24
    heads: int = 16
    layerscale_init: float = 1e-5
    # ViT-S/B/L: a GELU MLP; ViT-g ("giant2"): the hub's SwiGLUFFNFused
    ffn: str = "mlp"
    dtype: Any = torch.bfloat16

    @property
    def swiglu_hidden(self) -> int:
        return int(self.dim * 4 * 2 / 3 + 7) // 8 * 8


DINOV2_L = DinoV2Config()
DINOV2_G = DinoV2Config(dim=1536, depth=40, heads=24, ffn="swiglu")
TINY_DINO = DinoV2Config(img_size=28, patch=7, dim=32, depth=2, heads=2)


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, device=device))
        self.param_init = {"gamma": ("const", init)}

    def forward(self, x):
        return self.gamma * x


class _Attention(nn.Module):
    def __init__(self, c: DinoV2Config, device=None):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.heads = c.heads
        self.qkv = nn.Linear(c.dim, 3 * c.dim, **kw)
        self.proj = nn.Linear(c.dim, c.dim, **kw)

    def forward(self, x):
        b, l, d = x.shape
        qkv = self.qkv(x).reshape(b, l, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        o = sdpa(qkv[0], qkv[1], qkv[2])
        return self.proj(o.permute(0, 2, 1, 3).reshape(b, l, d))


class _MLP(nn.Module):
    def __init__(self, c: DinoV2Config, device=None):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.fc1 = nn.Linear(c.dim, 4 * c.dim, **kw)
        self.fc2 = nn.Linear(4 * c.dim, c.dim, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))     # exact GELU, as torch's nn.GELU


class _SwiGLU(nn.Module):
    """w12 -> (w1 | w2), out = w3(silu(w1 x) * w2 x)."""

    def __init__(self, c: DinoV2Config, device=None):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.hidden = c.swiglu_hidden
        self.w12 = nn.Linear(c.dim, 2 * self.hidden, **kw)
        self.w3 = nn.Linear(self.hidden, c.dim, **kw)

    def forward(self, x):
        h1, h2 = self.w12(x).split(self.hidden, dim=-1)
        return self.w3(F.silu(h1) * h2)


class DinoBlock(nn.Module):
    def __init__(self, c: DinoV2Config, device=None):
        super().__init__()
        kw = dict(eps=1e-6, dtype=c.dtype, device=device)
        self.norm1 = LayerNorm(c.dim, **kw)
        self.attn = _Attention(c, device)
        self.ls1 = _LayerScale(c.dim, c.layerscale_init, device)
        self.norm2 = LayerNorm(c.dim, **kw)
        self.mlp = _SwiGLU(c, device) if c.ffn == "swiglu" else _MLP(c, device)
        self.ls2 = _LayerScale(c.dim, c.layerscale_init, device)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoV2(nn.Module):
    """pixels (B, S, S, 3) ImageNet-normalized NHWC -> {"cls" (B, D),
    "patch" (B, N, D), "layers" {i: (B, N, D)}} in fp32, the layers of
    `return_layers` after the final norm."""

    def __init__(self, cfg: DinoV2Config = DINOV2_L, return_layers: tuple[int, ...] = (),
                 device=None):
        super().__init__()
        c = self.cfg = cfg
        self.return_layers = tuple(return_layers)
        n = (c.img_size // c.patch) ** 2
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c.dim, c.patch, stride=c.patch, dtype=c.dtype,
                                          device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, c.dim, device=device))
        self.param_init = {"cls_token": 0.02, "pos_embed": 0.02}
        self.blocks = nn.ModuleList([DinoBlock(c, device) for _ in range(c.depth)])
        self.norm = LayerNorm(c.dim, eps=1e-6, dtype=c.dtype, device=device)

    def forward(self, pixels):
        c = self.cfg
        b = pixels.shape[0]
        x = self.patch_embed.proj(pixels.to(c.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                       # (B, N, D), row-major
        x = torch.cat([self.cls_token.to(c.dtype).expand(b, 1, c.dim), x], dim=1)
        x = x + self.pos_embed.to(c.dtype)
        layers = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.return_layers:
                layers[i] = self.norm(x[:, 1:]).float()
        x = self.norm(x)
        return {"cls": x[:, 0].float(), "patch": x[:, 1:].float(), "layers": layers}
