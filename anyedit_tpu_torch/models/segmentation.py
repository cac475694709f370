"""Semantic segmentation for visual_segment: an UperNet head on Swin-T
(counterpart of `anyedit_tpu/models/segmentation.py`).

The head is mmseg's / HF's UPerHead with its BatchNorms folded into the
convs (inference only): PSP over the coarsest map (adaptive average pools
at `pool_scales`, each a 1x1 conv + ReLU resized back, concatenated with
the raw map, 3x3 bottleneck), 1x1 + ReLU laterals on the finer maps, the
top-down sum, 3x3 + ReLU FPN convs on all but the PSP level, every level
resized to the finest and fused by a 3x3 conv, and a 1x1 classifier in
fp32, resized to the input. The head runs in `cfg.dtype` (bf16 at
published width). Resizes are `ops/resize.py`'s bilinear (JAX's antialias
semantics; in the head every resize grows the map). Submodules carry HF
`UperNetForSemanticSegmentation`'s names (`backbone.` is the port's Swin,
`decode_head.{psp_modules.i, bottleneck, lateral_convs.i, fpn_convs.i,
fpn_bottleneck, classifier}`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import SameConv2d
from anyedit_tpu_torch.models.swin import SWIN_T, TINY_SWIN, SwinConfig, SwinTransformer
from anyedit_tpu_torch.ops.resize import resize_image


@dataclasses.dataclass(frozen=True)
class SegConfig:
    backbone: SwinConfig = dataclasses.replace(SWIN_T, out_indices=(0, 1, 2, 3))
    num_classes: int = 150          # ADE20K
    feat_dim: int = 512             # openmmlab upernet-swin decode channels
    pool_scales: tuple[int, ...] = (1, 2, 3, 6)
    dtype: Any = torch.bfloat16


UPERNET_SWIN_T = SegConfig()
TINY_SEG = SegConfig(backbone=dataclasses.replace(TINY_SWIN, out_indices=(0, 1)),
                     num_classes=8, feat_dim=16, pool_scales=(1, 2))


def _resize(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """mmseg `resize(..., mode='bilinear', align_corners=False)` of an NHWC map,
    in its dtype."""
    return resize_image(x, hw[0], hw[1], "bilinear")


def adaptive_avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """torch AdaptiveAvgPool2d(s) on NHWC: output cell (i, j) averages input
    rows [floor(i h / s), ceil((i + 1) h / s)) and the same columns, exact
    for any h (the JAX function's bins)."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


class UperNetHead(nn.Module):
    """[NHWC feature maps, finest first] -> class logits (B, H, W, K) fp32 at
    `out_hw`."""

    def __init__(self, cfg: SegConfig, in_channels: Sequence[int], device=None):
        super().__init__()
        c = self.cfg = cfg
        d = c.feat_dim
        kw = dict(dtype=c.dtype, device=device)
        top = in_channels[-1]
        self.psp_modules = nn.ModuleList([SameConv2d(top, d, 1, **kw) for _ in c.pool_scales])
        self.bottleneck = SameConv2d(top + d * len(c.pool_scales), d, 3, **kw)
        self.lateral_convs = nn.ModuleList([SameConv2d(ch, d, 1, **kw)
                                            for ch in in_channels[:-1]])
        self.fpn_convs = nn.ModuleList([SameConv2d(d, d, 3, **kw) for _ in in_channels[:-1]])
        self.fpn_bottleneck = SameConv2d(d * len(in_channels), d, 3, **kw)
        self.classifier = SameConv2d(d, c.num_classes, 1, dtype=torch.float32, device=device)

    def forward(self, feats: list[torch.Tensor], out_hw) -> torch.Tensor:
        def conv(m, x):            # NHWC in and out
            return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        top = feats[-1]
        h, w = top.shape[1:3]
        psp = [top]
        for s, m in zip(self.cfg.pool_scales, self.psp_modules):
            psp.append(_resize(F.relu(conv(m, adaptive_avg_pool(top, s))), (h, w)))
        x = F.relu(conv(self.bottleneck, torch.cat(psp, dim=-1)))
        laterals = [F.relu(conv(m, f)) for m, f in zip(self.lateral_convs, feats[:-1])] + [x]
        for i in reversed(range(len(laterals) - 1)):
            laterals[i] = laterals[i] + _resize(laterals[i + 1], laterals[i].shape[1:3])
        outs = [F.relu(conv(m, lat)) for m, lat in zip(self.fpn_convs, laterals[:-1])]
        outs.append(laterals[-1])
        size0 = outs[0].shape[1:3]
        fused = F.relu(conv(self.fpn_bottleneck,
                            torch.cat([_resize(o, size0) for o in outs], dim=-1)))
        logits = conv(self.classifier, fused.float())
        return _resize(logits, out_hw)


class UperNetSegmenter(nn.Module):
    """pixels (B, S, S, 3) ImageNet-normalized -> class logits (B, S, S, K) fp32."""

    def __init__(self, cfg: SegConfig = UPERNET_SWIN_T, device=None):
        super().__init__()
        self.cfg = cfg
        b = cfg.backbone
        self.backbone = SwinTransformer(b, device=device)
        chans = [b.embed_dim * 2 ** si for si in sorted(b.out_indices)]
        self.decode_head = UperNetHead(cfg, chans, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(pixels)
        return self.decode_head([feats[k] for k in sorted(feats)], pixels.shape[1:3])


def ade_palette(num_classes: int = 150) -> np.ndarray:
    """An ADE20K-style palette for rendering class maps (the reference saves
    show_result() renderings as the visual_input channel)."""
    rng = np.random.default_rng(42)
    pal = rng.integers(0, 255, (num_classes, 3), np.uint8)
    pal[0] = (120, 120, 120)
    return pal


def render_segmentation(logits: torch.Tensor, palette: np.ndarray | None = None) -> np.ndarray:
    """(..., K) logits -> (...,  3) uint8 colours of the argmax class (the
    first of tied maxima, as `jnp.argmax`)."""
    cls = torch.argmax(logits, dim=-1).cpu().numpy()
    pal = palette if palette is not None else ade_palette(logits.shape[-1])
    return pal[cls]
