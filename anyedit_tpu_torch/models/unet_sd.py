"""SD-family conditional UNet (counterpart of `anyedit_tpu/models/unet_sd.py`).

The public forward keeps the JAX package's layout: NHWC latents in, NHWC
fp32 prediction out. Inside, activations are NCHW in the compute dtype.
Submodules carry the diffusers `UNet2DConditionModel` names (down_blocks,
mid_block, up_blocks in diffusers order, time_embedding, conv_norm_out), so
a diffusers state dict loads by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import (
    AttnProcessor, Conv1x1, Conv3x3, FeedForward, GroupNorm, LayerNorm,
    MultiHeadAttention, Sampler, Stage, timestep_embedding, upsample2x,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attn_levels: tuple[bool, ...] = (True, True, True, False)
    transformer_depth: int | tuple[int, ...] = 1
    # SD1.x uses a FIXED head count (head_dim = C // 8: 40/80/160); SDXL and
    # SD2.x fix the head channels (64). `num_heads`, when set, wins.
    num_heads: int = 0
    num_head_channels: int = 40
    context_dim: int = 768
    time_embed_mult: int = 4
    num_groups: int = 32
    dtype: Any = torch.bfloat16

    def heads(self, channels: int) -> int:
        if self.num_heads:
            return self.num_heads
        return max(1, channels // self.num_head_channels)

    def depth_at(self, level: int) -> int:
        if isinstance(self.transformer_depth, tuple):
            return self.transformer_depth[level]
        return self.transformer_depth


SD15_UNET = UNetConfig(num_heads=8)   # head_dim 40/80/160/160 per level
SD15_IP2P_UNET = dataclasses.replace(SD15_UNET, in_channels=8)
TINY_UNET = UNetConfig(block_channels=(32, 64), attn_levels=(True, False),
                       num_head_channels=8, context_dim=32, num_groups=8,
                       layers_per_block=1)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 cfg: UNetConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        g = cfg.num_groups
        self.norm1 = GroupNorm(in_channels, g, silu=True, device=device)
        self.conv1 = Conv3x3(in_channels, out_channels, **kw)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels, **kw)
        self.norm2 = GroupNorm(out_channels, g, silu=True, device=device)
        self.conv2 = Conv3x3(out_channels, out_channels, **kw)
        self.conv_shortcut = (Conv1x1(in_channels, out_channels, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb))
        h = self.conv2(self.norm2(h + t[:, :, None, None]))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TransformerBlock(nn.Module):
    def __init__(self, channels: int, heads: int, name_tag: str,
                 cfg: UNetConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        hd = channels // heads
        self.norm1 = LayerNorm(channels, **kw)
        self.attn1 = MultiHeadAttention(channels, heads, hd, channels,
                                        f"{name_tag}.self", True, **kw)
        self.norm2 = LayerNorm(channels, **kw)
        self.attn2 = MultiHeadAttention(channels, heads, hd, channels,
                                        f"{name_tag}.cross", False,
                                        context_dim=cfg.context_dim, **kw)
        self.norm3 = LayerNorm(channels, **kw)
        self.ff = FeedForward(channels, **kw)

    def forward(self, x, context, processor=None, extra=None):
        x = x + self.attn1(self.norm1(x), None, processor, extra)
        x = x + self.attn2(self.norm2(x), context, processor, extra)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, name_tag: str, depth: int,
                 cfg: UNetConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.norm = GroupNorm(channels, cfg.num_groups, device=device)
        self.proj_in = Conv1x1(channels, channels, **kw)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, cfg.heads(channels), f"{name_tag}.tb{d}",
                             cfg, device=device)
            for d in range(depth)])
        self.proj_out = Conv1x1(channels, channels, **kw)

    def forward(self, x, context, processor=None, extra=None):
        b, c, hh, ww = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for block in self.transformer_blocks:
            x = block(x, context, processor, extra)
        x = x.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(x.contiguous()) + res


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype, device):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class UNet2DCondition(nn.Module):
    """Forward: (latents NHWC, t (B,), context (B, L, D)) -> eps NHWC fp32."""

    def __init__(self, cfg: UNetConfig = SD15_UNET, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        kw = dict(dtype=c.dtype, device=device)
        ch0 = c.block_channels[0]
        temb_dim = ch0 * c.time_embed_mult
        n_levels = len(c.block_channels)

        def res(cin, cout):
            return ResBlock(cin, cout, temb_dim, c, device=device)

        def tf(ch, tag, lvl):
            return SpatialTransformer(ch, tag, c.depth_at(lvl), c, device=device)

        self.time_embedding = TimestepEmbedding(ch0, temb_dim, **kw)
        self.conv_in = Conv3x3(c.in_channels, ch0, **kw)

        cur, skip_ch, down = ch0, [ch0], []
        for lvl, ch in enumerate(c.block_channels):
            resnets, attns = [], []
            for i in range(c.layers_per_block):
                resnets.append(res(cur, ch))
                cur = ch
                if c.attn_levels[lvl]:
                    attns.append(tf(ch, f"down_{lvl}.tf_{i}", lvl))
                skip_ch.append(ch)
            samplers = []
            if lvl != n_levels - 1:
                samplers.append(Sampler(Conv3x3(ch, ch, stride=2, **kw)))
                skip_ch.append(ch)
            down.append(Stage(resnets, attns, downsamplers=samplers))
        self.down_blocks = nn.ModuleList(down)

        mid_ch = c.block_channels[-1]
        self.mid_block = Stage(
            [res(mid_ch, mid_ch), res(mid_ch, mid_ch)],
            [tf(mid_ch, "mid.tf", n_levels - 1)])

        up = []
        for lvl in reversed(range(n_levels)):
            ch = c.block_channels[lvl]
            resnets, attns = [], []
            for i in range(c.layers_per_block + 1):
                resnets.append(res(cur + skip_ch.pop(), ch))
                cur = ch
                if c.attn_levels[lvl]:
                    attns.append(tf(ch, f"up_{lvl}.tf_{i}", lvl))
            samplers = [Sampler(Conv3x3(ch, ch, **kw))] if lvl != 0 else []
            up.append(Stage(resnets, attns, upsamplers=samplers))
        self.up_blocks = nn.ModuleList(up)   # diffusers order: lowest res first

        self.conv_norm_out = GroupNorm(ch0, c.num_groups, silu=True,
                                       device=device)
        self.conv_out = Conv3x3(ch0, c.out_channels, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                processor: Optional[AttnProcessor] = None,
                extra: Optional[dict] = None,
                controlnet_residuals: Optional[Sequence[torch.Tensor]] = None,
                controlnet_mid: Optional[torch.Tensor] = None,
                pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`pooled_text` and `time_ids` keep the JAX signature; they feed
        SDXL micro-conditioning, which is not ported yet, and are ignored
        as the JAX module ignores them for SD1.x configs. ControlNet
        residuals are NHWC, one per skip, added in pop order."""
        del pooled_text, time_ids
        c = self.cfg
        dt = c.dtype
        x = x.to(dt).permute(0, 3, 1, 2).contiguous()
        context = context.to(dt)
        temb = self.time_embedding(
            timestep_embedding(t, c.block_channels[0]).to(dt))

        h = self.conv_in(x)
        skips = [h]
        for lvl, stage in enumerate(self.down_blocks):
            for i, resnet in enumerate(stage.resnets):
                h = resnet(h, temb)
                if c.attn_levels[lvl]:
                    h = stage.attentions[i](h, context, processor, extra)
                skips.append(h)
            for sampler in stage.downsamplers:
                h = sampler.conv(h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context, processor, extra)
        h = mid.resnets[1](h, temb)
        if controlnet_mid is not None:
            h = h + controlnet_mid.to(dt).permute(0, 3, 1, 2)

        cn = list(controlnet_residuals) if controlnet_residuals is not None else None

        def pop_skip():
            s = skips.pop()
            if cn is not None:
                s = s + cn.pop().to(dt).permute(0, 3, 1, 2)
            return s

        for j, stage in enumerate(self.up_blocks):
            lvl = len(c.block_channels) - 1 - j
            for i, resnet in enumerate(stage.resnets):
                h = resnet(torch.cat([h, pop_skip()], dim=1), temb)
                if c.attn_levels[lvl]:
                    h = stage.attentions[i](h, context, processor, extra)
            for sampler in stage.upsamplers:
                h = sampler.conv(upsample2x(h))

        h = self.conv_out(self.conv_norm_out(h))
        return h.permute(0, 2, 3, 1).float()
