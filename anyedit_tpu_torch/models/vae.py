"""AutoencoderKL, the latent codec (counterpart of `anyedit_tpu/models/vae.py`).

Public `encode` / `decode` keep the JAX package's NHWC layout; inside,
activations are NCHW in the compute dtype. Encode returns (mean, logvar)
with logvar clipped to [-30, 20]; `scaling_factor` is applied by the
callers. Submodules carry the diffusers `AutoencoderKL` names.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import (
    Conv1x1, Conv3x3, GroupNorm, Sampler, Stage, upsample2x,
)
from anyedit_tpu_torch.ops.attention import attention as attention_op


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: Any = torch.bfloat16


SD_VAE = VAEConfig()
TINY_VAE = VAEConfig(block_channels=(16, 32), layers_per_block=1, num_groups=8,
                     scaling_factor=0.5)


class VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cfg: VAEConfig,
                 device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        g = cfg.num_groups
        self.norm1 = GroupNorm(in_channels, g, silu=True, device=device)
        self.conv1 = Conv3x3(in_channels, out_channels, **kw)
        self.norm2 = GroupNorm(out_channels, g, silu=True, device=device)
        self.conv2 = Conv3x3(out_channels, out_channels, **kw)
        self.conv_shortcut = (Conv1x1(in_channels, out_channels, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head self-attention over all pixels (head dim = channels)."""

    def __init__(self, channels: int, cfg: VAEConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.group_norm = GroupNorm(channels, cfg.num_groups, device=device)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw)])

    def forward(self, x):
        b, ch, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, ch)
        q = self.to_q(t)[:, None]
        k = self.to_k(t)[:, None]
        v = self.to_v(t)[:, None]
        out = self.to_out[0](attention_op(q, k, v)[:, 0])
        return x + out.reshape(b, h, w, ch).permute(0, 3, 1, 2)


def _mid_block(ch: int, cfg: VAEConfig, device) -> Stage:
    return Stage([VAEResBlock(ch, ch, cfg, device), VAEResBlock(ch, ch, cfg, device)],
                 [MidAttention(ch, cfg, device)])


def _run_mid(mid: Stage, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=c.dtype, device=device)
        n_levels = len(c.block_channels)
        self.conv_in = Conv3x3(c.in_channels, c.block_channels[0], **kw)
        cur, blocks = c.block_channels[0], []
        for lvl, ch in enumerate(c.block_channels):
            resnets = []
            for _ in range(c.layers_per_block):
                resnets.append(VAEResBlock(cur, ch, c, device))
                cur = ch
            # SD's downsampler: asymmetric (0, 1) pad, then a stride-2 VALID conv
            samplers = ([Sampler(nn.Conv2d(ch, ch, 3, stride=2, **kw))]
                        if lvl != n_levels - 1 else [])
            blocks.append(Stage(resnets, downsamplers=samplers))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(cur, c, device)
        self.conv_norm_out = GroupNorm(cur, c.num_groups, silu=True, device=device)
        self.conv_out = Conv3x3(cur, 2 * c.latent_channels, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for stage in self.down_blocks:
            for resnet in stage.resnets:
                h = resnet(h)
            for sampler in stage.downsamplers:
                h = sampler.conv(F.pad(h, (0, 1, 0, 1)))
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=c.dtype, device=device)
        cur = c.block_channels[-1]
        self.conv_in = Conv3x3(c.latent_channels, cur, **kw)
        self.mid_block = _mid_block(cur, c, device)
        blocks = []
        for lvl in reversed(range(len(c.block_channels))):
            ch = c.block_channels[lvl]
            resnets = []
            for _ in range(c.layers_per_block + 1):
                resnets.append(VAEResBlock(cur, ch, c, device))
                cur = ch
            samplers = [Sampler(Conv3x3(ch, ch, **kw))] if lvl != 0 else []
            blocks.append(Stage(resnets, upsamplers=samplers))
        self.up_blocks = nn.ModuleList(blocks)   # diffusers order: lowest res first
        self.conv_norm_out = GroupNorm(cur, c.num_groups, silu=True, device=device)
        self.conv_out = Conv3x3(cur, c.in_channels, **kw)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for stage in self.up_blocks:
            for resnet in stage.resnets:
                h = resnet(h)
            for sampler in stage.upsamplers:
                h = sampler.conv(upsample2x(h))
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        lc = cfg.latent_channels
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.quant_conv = Conv1x1(2 * lc, 2 * lc, **kw)
        self.post_quant_conv = Conv1x1(lc, lc, **kw)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) NHWC -> (mean, logvar), each (B, h, w, C) fp32."""
        h = x.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous()
        moments = self.quant_conv(self.encoder(h)).float().permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, h, w, C) NHWC latents -> (B, H, W, 3) fp32."""
        h = z.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous()
        return self.decoder(self.post_quant_conv(h)).float().permute(0, 2, 3, 1)
