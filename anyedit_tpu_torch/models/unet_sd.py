"""SD-family conditional UNet (counterpart of `anyedit_tpu/models/unet_sd.py`).

The public forward keeps the JAX package's layout: NHWC latents in, NHWC
fp32 prediction out. Inside, activations are NCHW in the compute dtype.
Submodules carry the diffusers `UNet2DConditionModel` names (down_blocks,
mid_block, up_blocks in diffusers order, time_embedding, add_embedding,
conv_norm_out), so a diffusers state dict loads by name. SDXL's
configurations hold each transformer's proj_in / proj_out as a Linear
(diffusers' `use_linear_projection`), where the JAX module has a 1x1 conv
of the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import (
    AttnProcessor, Conv3x3, FeedForward, GroupNorm, LayerNorm,
    MultiHeadAttention, Sampler, Stage, timestep_embedding, upsample2x,
)
from anyedit_tpu_torch.ops.quant import make_conv1x1, make_token_proj


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
    # SDXL micro-conditioning: the pooled text embedding (addition_embed_dim)
    # and the time ids, each embedded at width 256, added to the time embedding
    addition_embed_dim: int = 0
    addition_time_dim: int = 0
    # proj_in / proj_out as Linears over the tokens (diffusers' layout for
    # SDXL and SD2.x), not as 1x1 convs; the same arithmetic
    use_linear_projection: bool = False
    dtype: Any = torch.bfloat16
    # W8A8 int8 fast mode (ops/quant.py): the ResBlock convs and skip 1x1s,
    # the transformer projections, FFNs and proj_in/out, and the down/up
    # sampler convs; conv_in, conv_out and the time embeddings stay float.
    # Convert a float state dict with ops.quant.quantize_state_dict.
    quant: bool = False

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
SD15_INPAINT_UNET = dataclasses.replace(SD15_UNET, in_channels=9)
# SDXL-base: 3 levels, depths (0, 2, 10), 2048-dim context, 64-channel
# heads (10 and 20 at levels 1 and 2), micro-conditioning on the pooled
# OpenCLIP-bigG output (1280) and 6 size / crop time ids
SDXL_UNET = UNetConfig(block_channels=(320, 640, 1280), attn_levels=(False, True, True),
                       transformer_depth=(0, 2, 10), num_head_channels=64,
                       context_dim=2048, addition_embed_dim=1280, addition_time_dim=6,
                       use_linear_projection=True)
SDXL_INPAINT_UNET = dataclasses.replace(SDXL_UNET, in_channels=9)
# AnyDoor's SD2.1-class UNet (anydoor.yaml: context 1,024, 64-channel heads:
# 5 / 10 / 20 / 20 per level). proj_in / proj_out stay 1x1 convs, as in the
# JAX package's config (anydoor.yaml's use_linear_in_transformer holds the
# same weights as Linears).
SD21_ANYDOOR_UNET = UNetConfig(num_head_channels=64, context_dim=1024)
TINY_UNET = UNetConfig(block_channels=(32, 64), attn_levels=(True, False),
                       num_head_channels=8, context_dim=32, num_groups=8,
                       layers_per_block=1)
TINY_XL_UNET = UNetConfig(block_channels=(32, 64), attn_levels=(False, True),
                          transformer_depth=(0, 2), num_head_channels=8,
                          context_dim=32, num_groups=8, layers_per_block=1,
                          addition_embed_dim=16, addition_time_dim=6,
                          use_linear_projection=True)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 cfg: UNetConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        qkw = dict(kw, quant=cfg.quant)
        g = cfg.num_groups
        self.norm1 = GroupNorm(in_channels, g, silu=True, device=device)
        self.conv1 = Conv3x3(in_channels, out_channels, **qkw)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels, **kw)
        self.norm2 = GroupNorm(out_channels, g, silu=True, device=device)
        self.conv2 = Conv3x3(out_channels, out_channels, **qkw)
        self.conv_shortcut = (make_conv1x1(in_channels, out_channels, **qkw)
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
        qkw = dict(kw, quant=cfg.quant)
        hd = channels // heads
        self.norm1 = LayerNorm(channels, **kw)
        self.attn1 = MultiHeadAttention(channels, heads, hd, channels,
                                        f"{name_tag}.self", True, **qkw)
        self.norm2 = LayerNorm(channels, **kw)
        self.attn2 = MultiHeadAttention(channels, heads, hd, channels,
                                        f"{name_tag}.cross", False,
                                        context_dim=cfg.context_dim, **qkw)
        self.norm3 = LayerNorm(channels, **kw)
        self.ff = FeedForward(channels, **qkw)

    def forward(self, x, context, processor=None, extra=None):
        x = x + self.attn1(self.norm1(x), None, processor, extra)
        x = x + self.attn2(self.norm2(x), context, processor, extra)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, name_tag: str, depth: int,
                 cfg: UNetConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device, quant=cfg.quant)
        self.linear = cfg.use_linear_projection
        proj = make_token_proj if self.linear else make_conv1x1
        self.norm = GroupNorm(channels, cfg.num_groups, device=device)
        self.proj_in = proj(channels, channels, **kw)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, cfg.heads(channels), f"{name_tag}.tb{d}",
                             cfg, device=device)
            for d in range(depth)])
        self.proj_out = proj(channels, channels, **kw)

    def forward(self, x, context, processor=None, extra=None):
        b, c, hh, ww = x.shape
        res = x
        x = self.norm(x)
        if not self.linear:
            x = self.proj_in(x)
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        if self.linear:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context, processor, extra)
        if self.linear:
            x = self.proj_out(x)
        x = x.reshape(b, hh, ww, c).permute(0, 3, 1, 2).contiguous()
        return (x if self.linear else self.proj_out(x)) + res


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype, device):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class UNetEncoder(nn.Module):
    """The time embedding, conv_in, down path and mid block that the UNet and
    its ControlNet share (diffusers names). `skip_channels` lists the
    channels of each skip connection in push order."""

    def __init__(self, c: UNetConfig, device=None):
        super().__init__()
        self.cfg = c
        kw = dict(dtype=c.dtype, device=device)
        qkw = dict(kw, quant=c.quant)
        ch0 = c.block_channels[0]
        temb_dim = ch0 * c.time_embed_mult
        n_levels = len(c.block_channels)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim, **kw)
        if c.addition_embed_dim:
            self.add_embedding = TimestepEmbedding(
                c.addition_embed_dim + 256 * c.addition_time_dim, temb_dim, **kw)
        self.conv_in = Conv3x3(c.in_channels, ch0, **kw)
        cur, skip_ch, down = ch0, [ch0], []
        for lvl, ch in enumerate(c.block_channels):
            resnets, attns = [], []
            for i in range(c.layers_per_block):
                resnets.append(ResBlock(cur, ch, temb_dim, c, device=device))
                cur = ch
                if c.attn_levels[lvl]:
                    attns.append(SpatialTransformer(ch, f"down_{lvl}.tf_{i}", c.depth_at(lvl),
                                                    c, device=device))
                skip_ch.append(ch)
            samplers = []
            if lvl != n_levels - 1:
                samplers.append(Sampler(Conv3x3(ch, ch, stride=2, **qkw)))
                skip_ch.append(ch)
            down.append(Stage(resnets, attns, downsamplers=samplers))
        self.down_blocks = nn.ModuleList(down)
        mid_ch = c.block_channels[-1]
        self.mid_block = Stage(
            [ResBlock(mid_ch, mid_ch, temb_dim, c, device=device) for _ in range(2)],
            [SpatialTransformer(mid_ch, "mid.tf", c.depth_at(n_levels - 1), c,
                                device=device)])
        self.skip_channels = skip_ch

    def embed(self, t, pooled_text=None, time_ids=None) -> torch.Tensor:
        """The time embedding; with SDXL micro-conditioning, plus the
        projection of [pooled text, the time ids embedded at width 256]."""
        c = self.cfg
        dt = c.dtype
        temb = self.time_embedding(timestep_embedding(t, c.block_channels[0]).to(dt))
        if c.addition_embed_dim:
            if pooled_text is None or time_ids is None:
                raise ValueError("an SDXL UNet needs pooled_text and time_ids")
            tid = timestep_embedding(time_ids.reshape(-1), 256).reshape(
                time_ids.shape[0], 256 * c.addition_time_dim)
            temb = temb + self.add_embedding(torch.cat([pooled_text.to(dt), tid.to(dt)], -1))
        return temb

    def encode(self, h, temb, context, processor=None, extra=None):
        """The down path from conv_in's output, then the mid block. Returns
        (h, skips in push order)."""
        c = self.cfg
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
        return mid.resnets[1](h, temb), skips


class UNet2DCondition(UNetEncoder):
    """Forward: (latents NHWC, t (B,), context (B, L, D)) -> eps NHWC fp32."""

    def __init__(self, cfg: UNetConfig = SD15_UNET, device=None):
        super().__init__(cfg, device)
        c = cfg
        kw = dict(dtype=c.dtype, device=device)
        qkw = dict(kw, quant=c.quant)
        temb_dim = c.block_channels[0] * c.time_embed_mult
        skip_ch = list(self.skip_channels)
        cur, up = c.block_channels[-1], []
        for lvl in reversed(range(len(c.block_channels))):
            ch = c.block_channels[lvl]
            resnets, attns = [], []
            for i in range(c.layers_per_block + 1):
                resnets.append(ResBlock(cur + skip_ch.pop(), ch, temb_dim, c, device=device))
                cur = ch
                if c.attn_levels[lvl]:
                    attns.append(SpatialTransformer(ch, f"up_{lvl}.tf_{i}", c.depth_at(lvl),
                                                    c, device=device))
            samplers = [Sampler(Conv3x3(ch, ch, **qkw))] if lvl != 0 else []
            up.append(Stage(resnets, attns, upsamplers=samplers))
        self.up_blocks = nn.ModuleList(up)   # diffusers order: lowest res first

        self.conv_norm_out = GroupNorm(c.block_channels[0], c.num_groups, silu=True,
                                       device=device)
        self.conv_out = Conv3x3(c.block_channels[0], c.out_channels, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                processor: Optional[AttnProcessor] = None,
                extra: Optional[dict] = None,
                controlnet_residuals: Optional[Sequence[torch.Tensor]] = None,
                controlnet_mid: Optional[torch.Tensor] = None,
                pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`pooled_text` (B, addition_embed_dim) and `time_ids` (B,
        addition_time_dim) are the SDXL micro-conditioning, required by a
        config with `addition_embed_dim` and ignored otherwise, as in the
        JAX module. ControlNet residuals are NHWC, one per skip in push
        order (added as the up path pops them), and `controlnet_mid` is
        added after the mid block."""
        c = self.cfg
        dt = c.dtype
        x = x.to(dt).permute(0, 3, 1, 2).contiguous()
        context = context.to(dt)
        temb = self.embed(t, pooled_text, time_ids)
        h, skips = self.encode(self.conv_in(x), temb, context, processor, extra)
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
