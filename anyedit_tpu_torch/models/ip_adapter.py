"""IP-Adapter: decoupled image-prompt attention through the processor slot
(counterpart of `anyedit_tpu/models/ip_adapter.py`).

  * `ImageProjection` maps a CLIP image embedding to `num_tokens` context
    tokens (plain IP-Adapter / IP-Adapter-XL);
  * `IPAdapterWeights` holds every cross-attention site's bias-free
    (to_k_ip, to_v_ip) projections of those tokens;
  * `ip_adapter_processor` takes each site's image K/V, computed once per
    image, and adds `scale * attention(q, k_img, v_img)` to the text
    attention at every cross-attention site. Every site under it, the
    self-attention too, takes the plain `sdpa`, as the JAX processor takes
    `sdpa_xla`: a UNet under this processor launches no K1.

The state dicts are the two groups of an IP-Adapter checkpoint:
`ImageProjection` holds `image_proj` (proj, norm) and `IPAdapterWeights`
holds `ip_adapter` (`{2 i + 1}.to_k_ip` / `.to_v_ip` for the i-th site of
`cross_attn_sites`, the index of diffusers' attention-processor list in
which the self-attention sites hold no parameters). Both stay fp32.
The perceiver `Resampler` (IP-Adapter-Plus) has no caller in the zoo and is
not ported.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from anyedit_tpu_torch.models.layers import AttnMeta, LayerNorm
from anyedit_tpu_torch.ops.attention import sdpa


class ImageProjection(nn.Module):
    """CLIP image embedding (B, D) -> (B, num_tokens, context_dim), fp32."""

    def __init__(self, emb_dim: int, num_tokens: int = 4, context_dim: int = 768,
                 device=None):
        super().__init__()
        self.num_tokens, self.context_dim = num_tokens, context_dim
        self.proj = nn.Linear(emb_dim, num_tokens * context_dim, device=device)
        self.norm = LayerNorm(context_dim, dtype=torch.float32, device=device)

    def forward(self, emb):
        x = self.proj(emb.float()).reshape(emb.shape[0], self.num_tokens, self.context_dim)
        return self.norm(x)


class _SiteKV(nn.Module):
    def __init__(self, context_dim: int, inner: int, device=None):
        super().__init__()
        self.to_k_ip = nn.Linear(context_dim, inner, bias=False, device=device)
        self.to_v_ip = nn.Linear(context_dim, inner, bias=False, device=device)


class IPAdapterWeights(nn.Module):
    """Per-site decoupled K/V projections: image tokens (B, T, context_dim)
    -> {site name: (k (B, T, inner), v (B, T, inner))}, fp32."""

    def __init__(self, site_names: tuple[str, ...], inner_dims: tuple[int, ...],
                 context_dim: int = 768, device=None):
        super().__init__()
        self.site_names = tuple(site_names)
        for i, inner in enumerate(inner_dims):     # children "1", "3", "5", ...
            self.add_module(str(2 * i + 1), _SiteKV(context_dim, inner, device))

    def forward(self, image_tokens):
        x = image_tokens.float()
        return {name: (kv.to_k_ip(x), kv.to_v_ip(x))
                for name, kv in zip(self.site_names, self.children())}


def cross_attn_sites(unet_cfg) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Every cross-attention site's name and inner width, in the order down
    -> mid -> up of `models/unet_sd.py`'s name tags (the JAX package's
    order; diffusers' `attn_processors` runs down -> up -> mid: ROADMAP
    queue 3)."""
    names, dims = [], []

    def add(tag, ch):
        names.append(f"{tag}.cross")
        heads = unet_cfg.heads(ch)
        dims.append(heads * (ch // heads))

    nlv = len(unet_cfg.block_channels)
    for lvl, ch in enumerate(unet_cfg.block_channels):
        if unet_cfg.attn_levels[lvl]:
            for i in range(unet_cfg.layers_per_block):
                for d in range(unet_cfg.depth_at(lvl)):
                    add(f"down_{lvl}.tf_{i}.tb{d}", ch)
    for d in range(unet_cfg.depth_at(nlv - 1)):
        add(f"mid.tf.tb{d}", unet_cfg.block_channels[-1])
    for lvl in reversed(range(nlv)):
        ch = unet_cfg.block_channels[lvl]
        if unet_cfg.attn_levels[lvl]:
            for i in range(unet_cfg.layers_per_block + 1):
                for d in range(unet_cfg.depth_at(lvl)):
                    add(f"up_{lvl}.tf_{i}.tb{d}", ch)
    return tuple(names), tuple(dims)


def ip_adapter_processor(site_kv: dict[str, tuple[torch.Tensor, torch.Tensor]],
                         scale: float = 1.0) -> Callable:
    """The decoupled-attention processor over precomputed per-site image
    K/V (B, T, inner): every site's text attention through `sdpa`, and at a
    cross-attention site of `site_kv` plus `scale` times the attention of
    its queries over the image tokens."""

    def proc(q, k, v, meta: AttnMeta, extra=None):
        out = sdpa(q, k, v)
        if meta.is_self or meta.name not in site_kv:
            return out
        ki, vi = site_kv[meta.name]
        b, h, _, d = q.shape
        t = ki.shape[1]

        def split(x):
            return x.reshape(b, t, h, d).permute(0, 2, 1, 3).to(q.dtype)
        return out + scale * sdpa(q, split(ki), split(vi))

    return proc
