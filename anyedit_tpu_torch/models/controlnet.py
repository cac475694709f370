"""ControlNet for the SD UNet family (counterpart of
`anyedit_tpu/models/controlnet.py`).

A copy of the UNet's time embedding, conv_in, down path and mid block
takes the latents plus the hint's features and gives one zero-conv residual
per skip connection and one after the mid block, which the UNet adds
(`controlnet_residuals`, `controlnet_mid`). The hint enters through seven
SiLU convs (16, 16, 32 s2, 32, 96 s2, 96, 256 s2) and a 3x3 projection to
the first block's channels.

Submodules carry the names of diffusers' `ControlNetModel`
(`controlnet_cond_embedding.{conv_in, blocks.i, conv_out}`,
`controlnet_down_blocks.i`, `controlnet_mid_block`, and the UNet's
down_blocks / mid_block / time_embedding / add_embedding), so a diffusers
SDXL ControlNet state dict loads by name. The zero convs and the hint
projection start at zero under `seeded_init_`, as in the JAX package: an
untrained ControlNet is then an exact no-op.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import Conv3x3
from anyedit_tpu_torch.models.unet_sd import UNetConfig, UNetEncoder

_ZERO = {"weight": ("const", 0.0)}   # seeded_init_: weight 0 (its bias is 0 anyway)


def _zero(conv: nn.Conv2d) -> nn.Conv2d:
    conv.param_init = _ZERO
    return conv


class HintEncoder(nn.Module):
    """Hint image (B, C_hint, 8h, 8w) NCHW -> features (B, out, h, w)."""

    # (channels, stride) of conv_in and each of `blocks`
    PYRAMID = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))

    def __init__(self, hint_channels: int, out_channels: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        chans = [hint_channels] + [ch for ch, _ in self.PYRAMID]
        convs = [Conv3x3(chans[i], ch, stride=s, **kw) for i, (ch, s) in enumerate(self.PYRAMID)]
        self.conv_in = convs[0]
        self.blocks = nn.ModuleList(convs[1:])
        self.conv_out = _zero(Conv3x3(chans[-1], out_channels, **kw))

    def forward(self, hint):
        h = F.silu(self.conv_in(hint))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNet(UNetEncoder):
    """(x NHWC, t, context, hint NHWC (B, 8h, 8w, C_hint)) -> (skip
    residuals [NHWC, in push order], mid residual NHWC). The transformers
    run without a processor, as in the JAX module; the residuals are NHWC
    views of NCHW tensors, which the UNet permutes back for free."""

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3, device=None):
        super().__init__(cfg, device)
        kw = dict(dtype=cfg.dtype, device=device)
        ch0 = cfg.block_channels[0]
        self.controlnet_cond_embedding = HintEncoder(hint_channels, ch0, cfg.dtype, device)
        self.controlnet_down_blocks = nn.ModuleList([
            _zero(nn.Conv2d(ch, ch, 1, **kw)) for ch in self.skip_channels])
        mid = cfg.block_channels[-1]
        self.controlnet_mid_block = _zero(nn.Conv2d(mid, mid, 1, **kw))

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                hint: torch.Tensor, pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None):
        c = self.cfg
        dt = c.dtype
        x = x.to(dt).permute(0, 3, 1, 2).contiguous()
        hint = hint.to(dt).permute(0, 3, 1, 2).contiguous()
        temb = self.embed(t, pooled_text, time_ids)
        h = self.conv_in(x) + self.controlnet_cond_embedding(hint)
        h, skips = self.encode(h, temb, context.to(dt))
        nhwc = lambda a: a.permute(0, 2, 3, 1)   # noqa: E731
        res = [nhwc(zc(s)) for zc, s in zip(self.controlnet_down_blocks, skips, strict=True)]
        return res, nhwc(self.controlnet_mid_block(h))
