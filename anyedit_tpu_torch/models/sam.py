"""SAM (Segment Anything), the promptable segmenter of the grounding stage
(counterpart of `anyedit_tpu/models/sam.py`).

`SAM(cfg).encode(pixels)` -> image embedding (B, S/16, S/16, C);
`SAM(cfg).decode_boxes(emb, boxes)` -> (mask logits (B*N, 4, 4h, 4w), iou
(B*N, 4)). Boxes-only prompts, as the factory uses it. Submodules carry the
official segment-anything names (image_encoder.*, prompt_encoder.*,
mask_decoder.*); of the prompt encoder's point embeddings only the two box
corners exist (`point_embeddings.2` / `.3`).

Hazards the JAX package's golden tests found, kept here:
  * the decomposed rel-pos bias is taken from the UNSCALED q;
  * decoder block 0 REPLACES the queries with its self-attention (no
    residual);
  * the query positional embedding re-added at every layer is the full
    initial token embedding;
  * the upscaling ConvTranspose is a plain nn.ConvTranspose2d;
  * the encoder MLP uses exact GELU, the decoder's upscaling Flax's default
    `nn.gelu`, the tanh approximation.
The encoder's attention (windowed and global) is the plain `sdpa` with the
rel-pos bias; the decoder's goes through `attention()`, whose route sends
none of its shapes (Lq != Lkv, or 7 tokens) to K1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm, Linear, SameConv2d
from anyedit_tpu_torch.ops.attention import attention as attention_op
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch: int = 16
    enc_dim: int = 1280            # ViT-H
    enc_depth: int = 32
    enc_heads: int = 16
    window: int = 14
    global_attn_idx: tuple[int, ...] = (7, 15, 23, 31)
    out_dim: int = 256             # neck / prompt / decoder dim
    dec_depth: int = 2
    dec_heads: int = 8
    num_mask_tokens: int = 4       # 1 "whole" + 3 multimask
    dtype: Any = torch.bfloat16


SAM_VIT_H = SAMConfig()
SAM_VIT_B = SAMConfig(enc_dim=768, enc_depth=12, enc_heads=12,
                      global_attn_idx=(2, 5, 8, 11))
TINY_SAM = SAMConfig(img_size=64, patch=8, enc_dim=32, enc_depth=2,
                     enc_heads=2, window=4, global_attn_idx=(1,), out_dim=32,
                     dec_heads=2)

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


# ---- encoder -----------------------------------------------------------------

def _window_partition(x: torch.Tensor, w: int):
    """(B, H, W, C) -> (B*nW, w, w, C), zero-padded; returns (windows, padded hw)."""
    b, h, ww, c = x.shape
    ph, pw = (w - h % w) % w, (w - ww % w) % w
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, ww + pw
    x = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), (hp, wp)


def _window_unpartition(win: torch.Tensor, w: int, padded, orig):
    hp, wp = padded
    h, ww = orig
    b = win.shape[0] // ((hp // w) * (wp // w))
    x = win.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :ww]


def _decomposed_rel_pos_bias(rel_h: torch.Tensor, rel_w: torch.Tensor,
                             q_hw: tuple[int, int], k_hw: tuple[int, int],
                             q: torch.Tensor) -> torch.Tensor:
    """SAM's decomposed relative position bias. rel_h / rel_w: (2 size - 1,
    head_dim) tables; q: (B, H, qh*qw, d). Returns (B, H, qh*qw, kh*kw)."""
    qh, qw = q_hw
    kh, kw = k_hw
    dev = q.device
    idx_h = torch.arange(qh, device=dev)[:, None] - torch.arange(kh, device=dev)[None] + kh - 1
    idx_w = torch.arange(qw, device=dev)[:, None] - torch.arange(kw, device=dev)[None] + kw - 1
    rh, rw = rel_h[idx_h], rel_w[idx_w]                      # (qh, kh, d), (qw, kw, d)
    b, h, _, d = q.shape
    qr = q.reshape(b, h, qh, qw, d)
    bias_h = torch.einsum("bhqwd,qkd->bhqwk", qr, rh)
    bias_w = torch.einsum("bhqwd,wkd->bhqwk", qr, rw)
    return (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, h, qh * qw, kh * kw)


class _EncAttention(nn.Module):
    def __init__(self, c: SAMConfig, size: int, kw):
        super().__init__()
        hd = c.enc_dim // c.enc_heads
        self.qkv = Linear(c.enc_dim, 3 * c.enc_dim, **kw)
        self.proj = Linear(c.enc_dim, c.enc_dim, **kw)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd, device=kw["device"]))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd, device=kw["device"]))
        self.param_init = {"rel_pos_h": ("const", 0.0), "rel_pos_w": ("const", 0.0)}


class _EncMlp(nn.Module):
    def __init__(self, c: SAMConfig, kw):
        super().__init__()
        self.lin1 = Linear(c.enc_dim, 4 * c.enc_dim, **kw)
        self.lin2 = Linear(4 * c.enc_dim, c.enc_dim, **kw)


class SAMEncBlock(nn.Module):
    def __init__(self, c: SAMConfig, use_window: bool, device=None):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.c, self.use_window = c, use_window
        self.norm1 = LayerNorm(c.enc_dim, dtype=c.dtype, device=device)
        size = c.window if use_window else c.img_size // c.patch
        self.attn = _EncAttention(c, size, kw)
        self.norm2 = LayerNorm(c.enc_dim, dtype=c.dtype, device=device)
        self.mlp = _EncMlp(c, kw)

    def forward(self, x):
        c = self.c
        b, h, w, ch = x.shape
        shortcut = x
        x = self.norm1(x)
        if self.use_window:
            x, padded = _window_partition(x, c.window)
            ah = aw = c.window
        else:
            ah, aw = h, w
        nb = x.shape[0]
        hd = ch // c.enc_heads
        qkv = self.attn.qkv(x.reshape(nb, ah * aw, ch))
        q, k, v = qkv.reshape(nb, ah * aw, 3, c.enc_heads, hd).permute(2, 0, 3, 1, 4)
        bias = _decomposed_rel_pos_bias(self.attn.rel_pos_h, self.attn.rel_pos_w,
                                        (ah, aw), (ah, aw), q.float())
        out = sdpa(q, k, v, bias=bias).permute(0, 2, 1, 3).reshape(nb, ah, aw, ch)
        if self.use_window:
            out = _window_unpartition(out, c.window, padded, (h, w))
        x = shortcut + self.attn.proj(out)
        y = F.gelu(self.mlp.lin1(self.norm2(x)))            # exact erf
        return x + self.mlp.lin2(y)


class _PatchEmbed(nn.Module):
    def __init__(self, c: SAMConfig, device):
        super().__init__()
        self.proj = SameConv2d(3, c.enc_dim, c.patch, stride=c.patch, dtype=c.dtype,
                               device=device)


class SAMImageEncoder(nn.Module):
    """(B, S, S, 3) normalized pixels -> (B, S/16, S/16, out_dim) embedding."""

    def __init__(self, c: SAMConfig, device=None):
        super().__init__()
        self.c = c
        hw = c.img_size // c.patch
        self.patch_embed = _PatchEmbed(c, device)
        self.pos_embed = nn.Parameter(torch.zeros(1, hw, hw, c.enc_dim, device=device))
        self.param_init = {"pos_embed": 0.02}
        self.blocks = nn.ModuleList([SAMEncBlock(c, i not in c.global_attn_idx, device)
                                     for i in range(c.enc_depth)])
        # neck: 1x1 -> LN -> 3x3 -> LN, both convs bias-free
        self.neck = nn.ModuleList([
            SameConv2d(c.enc_dim, c.out_dim, 1, bias=False, dtype=c.dtype, device=device),
            LayerNorm(c.out_dim, dtype=c.dtype, device=device),
            SameConv2d(c.out_dim, c.out_dim, 3, bias=False, dtype=c.dtype, device=device),
            LayerNorm(c.out_dim, dtype=c.dtype, device=device)])

    def forward(self, x):
        c = self.c
        x = self.patch_embed.proj(x.to(c.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x + self.pos_embed.to(c.dtype)
        for block in self.blocks:
            x = block(x)
        for conv, norm in ((self.neck[0], self.neck[1]), (self.neck[2], self.neck[3])):
            x = norm(conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return x


# ---- prompt encoder ----------------------------------------------------------

class _PELayer(nn.Module):
    def __init__(self, c: SAMConfig, device):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, c.out_dim // 2, device=device))
        self.param_init = {"positional_encoding_gaussian_matrix": 1.0}

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        proj = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix \
            * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def _embedding(n: int, dim: int, device) -> nn.Embedding:
    """An fp32 table drawn normal(0, 1), as the JAX params."""
    e = nn.Embedding(n, dim, device=device)
    e.param_init = {"weight": 1.0}
    return e


class SAMPromptEncoder(nn.Module):
    """Boxes (B, N, 4) in [0, img_size] pixels -> (sparse tokens (B, 2N, C)
    fp32, dense positional grid (h, w, C), the no-mask embedding (1, C))."""

    def __init__(self, c: SAMConfig, device=None):
        super().__init__()
        self.c = c
        self.pe_layer = _PELayer(c, device)
        # the box corners: top-left = 2, bottom-right = 3 (official order)
        self.point_embeddings = nn.ModuleDict(
            {str(i): _embedding(1, c.out_dim, device) for i in (2, 3)})
        self.no_mask_embed = _embedding(1, c.out_dim, device)

    def forward(self, boxes):
        c = self.c
        b, n, _ = boxes.shape
        corners = boxes.float().reshape(b, n * 2, 2)             # (x1, y1), (x2, y2)
        emb = self.pe_layer((corners + 0.5) / c.img_size)
        corner = torch.cat([self.point_embeddings["2"].weight,
                            self.point_embeddings["3"].weight])  # (2, C)
        emb = emb + corner.repeat(n, 1)[None]
        hw = c.img_size // c.patch
        g = (torch.arange(hw, dtype=torch.float32, device=boxes.device) + 0.5) / hw
        gy, gx = torch.meshgrid(g, g, indexing="ij")
        dense = self.pe_layer(torch.stack([gx, gy], dim=-1))     # (h, w, C)
        return emb, dense, self.no_mask_embed.weight


# ---- mask decoder ------------------------------------------------------------

class _Attention(nn.Module):
    """The decoder's attention (q/k/v/out_proj at an inner width of
    out_dim / downsample)."""

    def __init__(self, c: SAMConfig, downsample: int, device):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        d = c.out_dim // downsample
        self.heads = c.dec_heads
        self.q_proj = Linear(c.out_dim, d, **kw)
        self.k_proj = Linear(c.out_dim, d, **kw)
        self.v_proj = Linear(c.out_dim, d, **kw)
        self.out_proj = Linear(d, c.out_dim, **kw)

    def forward(self, q, k, v):
        qq, kk, vv = self.q_proj(q), self.k_proj(k), self.v_proj(v)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, -1).permute(0, 2, 1, 3)
        out = attention_op(split(qq), split(kk), split(vv))
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(q.shape[0], q.shape[1], -1))


class _DecMlp(nn.Module):
    def __init__(self, c: SAMConfig, device):
        super().__init__()
        self.lin1 = Linear(c.out_dim, 8 * c.out_dim, dtype=c.dtype, device=device)
        self.lin2 = Linear(8 * c.out_dim, c.out_dim, dtype=c.dtype, device=device)


class TwoWayBlock(nn.Module):
    def __init__(self, c: SAMConfig, skip_first_pe: bool, device=None):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = _Attention(c, 1, device)
        self.cross_attn_token_to_image = _Attention(c, 2, device)
        self.cross_attn_image_to_token = _Attention(c, 2, device)
        self.mlp = _DecMlp(c, device)
        for i in range(1, 5):
            self.add_module(f"norm{i}", LayerNorm(c.out_dim, dtype=c.dtype, device=device))

    def forward(self, queries, keys, q_pe, k_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q_in = queries + q_pe
            queries = queries + self.self_attn(q_in, q_in, queries)
        queries = self.norm1(queries)
        queries = queries + self.cross_attn_token_to_image(queries + q_pe, keys + k_pe, keys)
        queries = self.norm2(queries)
        queries = queries + self.mlp.lin2(F.relu(self.mlp.lin1(queries)))
        queries = self.norm3(queries)
        keys = keys + self.cross_attn_image_to_token(keys + k_pe, queries + q_pe, queries)
        return queries, self.norm4(keys)


class _TwoWayTransformer(nn.Module):
    def __init__(self, c: SAMConfig, device):
        super().__init__()
        self.layers = nn.ModuleList([TwoWayBlock(c, i == 0, device)
                                     for i in range(c.dec_depth)])
        self.final_attn_token_to_image = _Attention(c, 2, device)
        self.norm_final_attn = LayerNorm(c.out_dim, dtype=c.dtype, device=device)


class _HeadMLP(nn.Module):
    """The official 3-layer `MLP` (`layers.J`, ReLU between)."""

    def __init__(self, c: SAMConfig, out: int, device):
        super().__init__()
        dims = [c.out_dim, c.out_dim, c.out_dim, out]
        self.layers = nn.ModuleList([Linear(a, b, dtype=c.dtype, device=device)
                                     for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if j < 2:
                x = F.relu(x)
        return x


class SAMMaskDecoder(nn.Module):
    """(image_embedding (B, h, w, C), image_pe (h, w, C), prompt tokens
    (B, P, C)) -> (mask logits (B, num_mask_tokens, 4h, 4w), iou (B, nt))."""

    def __init__(self, c: SAMConfig, device=None):
        super().__init__()
        self.c = c
        kw = dict(dtype=c.dtype, device=device)
        nt = c.num_mask_tokens
        self.iou_token = _embedding(1, c.out_dim, device)
        self.mask_tokens = _embedding(nt, c.out_dim, device)
        self.transformer = _TwoWayTransformer(c, device)
        # 0 ConvT, 1 LN, 2 GELU, 3 ConvT, 4 GELU (the official indices)
        self.output_upscaling = nn.ModuleList([
            nn.ConvTranspose2d(c.out_dim, c.out_dim // 4, 2, stride=2, **kw),
            LayerNorm(c.out_dim // 4, dtype=c.dtype, device=device),
            nn.GELU(approximate="tanh"),
            nn.ConvTranspose2d(c.out_dim // 4, c.out_dim // 8, 2, stride=2, **kw),
            nn.GELU(approximate="tanh")])
        self.output_hypernetworks_mlps = nn.ModuleList(
            [_HeadMLP(c, c.out_dim // 8, device) for _ in range(nt)])
        self.iou_prediction_head = _HeadMLP(c, nt, device)

    def forward(self, img_emb, img_pe, prompts):
        c = self.c
        b, h, w, _ = img_emb.shape
        nt = c.num_mask_tokens
        toks = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        queries = torch.cat([toks[None].expand(b, -1, -1), prompts], dim=1)
        q_pe = queries                          # the full initial token embedding
        keys = img_emb.reshape(b, h * w, c.out_dim)
        k_pe = img_pe.reshape(1, h * w, c.out_dim).expand(b, -1, -1).to(keys.dtype)
        tr = self.transformer
        for block in tr.layers:
            queries, keys = block(queries, keys, q_pe, k_pe)
        queries = tr.norm_final_attn(
            queries + tr.final_attn_token_to_image(queries + q_pe, keys + k_pe, keys))

        up = self.output_upscaling
        src = keys.reshape(b, h, w, c.out_dim).permute(0, 3, 1, 2)
        src = up[0](src.to(up[0].weight.dtype))
        src = up[2](up[1](src.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
        src = up[4](up[3](src))                                       # (B, C/8, 4h, 4w)
        hyper = torch.stack([mlp(queries[:, 1 + i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bchw->bnhw", hyper.float(), src.float())
        iou = self.iou_prediction_head(queries[:, 0])
        return masks, iou.float()


# ---- assembled predictor -----------------------------------------------------

class SAM(nn.Module):
    """pixels + boxes -> per-box mask logits at img_size / 4."""

    def __init__(self, cfg: SAMConfig = SAM_VIT_H, device=None):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SAMImageEncoder(cfg, device)
        self.prompt_encoder = SAMPromptEncoder(cfg, device)
        self.mask_decoder = SAMMaskDecoder(cfg, device)

    def encode(self, pixels):
        return self.image_encoder(pixels)

    def decode_boxes(self, img_emb, boxes):
        """img_emb (B, h, w, C), boxes (B, N, 4) -> masks (B*N, nt, 4h, 4w), iou."""
        b, n = boxes.shape[:2]
        prompts, pe, no_mask = self.prompt_encoder(boxes)
        prompts = prompts.reshape(b * n, 2, self.cfg.out_dim)
        img = img_emb.repeat_interleave(n, dim=0) + no_mask.reshape(-1).to(img_emb.dtype)
        return self.mask_decoder(img, pe, prompts)

    def forward(self, pixels, boxes):
        return self.decode_boxes(self.encode(pixels), boxes)
