"""Depth-Anything-V2: DINOv2 and the DPT head (counterpart of
`anyedit_tpu/models/depth.py`).

Four intermediate DINOv2 layers -> a 1x1 projection each and a learned
resize (4x and 2x transposed convs, identity, a stride-2 conv) -> 3x3
`layer{i}_rn` convs -> RefineNet fusion from coarse to fine, each block's
1x1 out conv after its upsample -> a two-stage output head. Submodules carry
the official checkpoint's names (`pretrained.*`, `depth_head.projects.i`,
`depth_head.resize_layers.i`, `depth_head.scratch.*`). The resizes are the
port's `resize_image` bilinear, half-pixel and antialiased, as
`jax.image.resize` (the official model interpolates with align_corners).
Convolutions run NCHW; the head returns the depth map (B, H, W) fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.dinov2 import DINOV2_L, TINY_DINO, DinoV2, DinoV2Config
from anyedit_tpu_torch.ops.resize import resize_image


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    backbone: DinoV2Config = DINOV2_L
    take_layers: tuple[int, ...] = (4, 11, 17, 23)   # ViT-L convention
    feat_dim: int = 256
    out_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    dtype: Any = torch.bfloat16


DEPTH_ANYTHING_L = DPTConfig()
TINY_DEPTH = DPTConfig(backbone=TINY_DINO, take_layers=(0, 0, 1, 1),
                       feat_dim=16, out_channels=(8, 16, 32, 32))


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW bilinear resize to hw, as `jax.image.resize` on NHWC."""
    y = resize_image(x.permute(0, 2, 3, 1), hw[0], hw[1], "bilinear")
    return y.to(x.dtype).permute(0, 3, 1, 2).contiguous()


class ResidualConvUnit(nn.Module):
    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1, dtype=dtype, device=device)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _Fusion(nn.Module):
    """One RefineNet block: `resConfUnit1` (absent in the coarsest block,
    whose official counterpart holds it unused), `resConfUnit2`, `out_conv`."""

    def __init__(self, dim: int, first: bool, dtype, device=None):
        super().__init__()
        if not first:
            self.resConfUnit1 = ResidualConvUnit(dim, dtype, device)
        self.resConfUnit2 = ResidualConvUnit(dim, dtype, device)
        self.out_conv = nn.Conv2d(dim, dim, 1, dtype=dtype, device=device)


class DPTHead(nn.Module):
    """4 token maps (B, N, D) on a (gh, gw) grid -> depth (B, H, W) fp32."""

    def __init__(self, cfg: DPTConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        d, oc, f = cfg.backbone.dim, cfg.out_channels, cfg.feat_dim
        self.projects = nn.ModuleList([nn.Conv2d(d, o, 1, **kw) for o in oc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw)])
        self.scratch = nn.Module()
        for i, o in enumerate(oc):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(o, f, 3, padding=1, bias=False, **kw))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", _Fusion(f, i == 4, c.dtype, device))
        self.scratch.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1, **kw)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2d(32, 1, 1, **kw))

    def forward(self, layer_feats, grid_hw, out_hw):
        c, sc = self.cfg, self.scratch
        gh, gw = grid_hw
        feats = []
        for i, fm in enumerate(layer_feats):
            b, _, d = fm.shape
            x = fm.to(c.dtype).transpose(1, 2).reshape(b, d, gh, gw)
            x = self.resize_layers[i](self.projects[i](x))
            feats.append(getattr(sc, f"layer{i + 1}_rn")(x))
        r4 = sc.refinenet4
        x = r4.out_conv(_resize(r4.resConfUnit2(feats[3]), feats[2].shape[2:]))
        for i in reversed(range(3)):
            r = getattr(sc, f"refinenet{i + 1}")
            x = r.resConfUnit2(x + r.resConfUnit1(feats[i]))
            nxt = feats[i - 1].shape[2:] if i > 0 else \
                (feats[0].shape[2] * 2, feats[0].shape[3] * 2)
            x = r.out_conv(_resize(x, nxt))
        x = _resize(sc.output_conv1(x), out_hw)
        x = sc.output_conv2(x)
        return F.relu(x.float())[:, 0]


class DepthAnythingV2(nn.Module):
    """pixels (B, S, S, 3) ImageNet-normalized NHWC -> relative depth (B, S, S)."""

    def __init__(self, cfg: DPTConfig = DEPTH_ANYTHING_L, device=None):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoV2(cfg.backbone, tuple(sorted(set(cfg.take_layers))), device)
        self.depth_head = DPTHead(cfg, device)

    def forward(self, pixels):
        c = self.cfg
        layers = self.pretrained(pixels)["layers"]
        g = c.backbone.img_size // c.backbone.patch
        return self.depth_head([layers[i] for i in c.take_layers], (g, g), pixels.shape[1:3])


def depth_to_u8(depth: torch.Tensor) -> torch.Tensor:
    """A relative-depth map (..., H, W) -> uint8 0-255 per map: min-max
    normalized, rounded half to even."""
    d = depth - depth.amin(dim=(-2, -1), keepdim=True)
    d = d / torch.clamp(d.amax(dim=(-2, -1), keepdim=True), min=1e-8)
    return torch.round(d * 255).to(torch.uint8)
