"""HED soft-edge (scribble) detector (counterpart of `anyedit_tpu/models/hed.py`).

The reference's `ControlNetHED_Apache2`: a learned per-channel input shift,
five VGG stages of `HED_STAGES` (3x3 convs with ReLU, a 2x2 max-pool before
stages 2-5), a 1x1 projection per stage resized bilinear (antialiased, as
`jax.image.resize`; every side output grows, so the filter is plain
bilinear) back to the input size; the edge map is the sigmoid of the mean
of the five. fp32, as the JAX module. Submodules carry the checkpoint's
names (`norm` (1, 3, 1, 1), `block{1..5}.convs.{i}`, `block{1..5}.projection`),
which `weights/convert.py::convert_hed` reads. The JAX module's
`scribble_postprocess` (the reference's inverted rendering) has no caller
there and is not ported: `visual_condition` thresholds without inverting.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.ops.resize import resize_image

HED_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class _DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, device=None):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1,
                                              device=device) for i in range(n)])
        self.projection = nn.Conv2d(cout, 1, 1, device=device)


class HED(nn.Module):
    """(B, H, W, 3) RGB in [0, 255] -> (B, H, W) soft edges in [0, 1]."""

    def __init__(self, device=None):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1, device=device))
        chans = [3] + [ch for ch, _ in HED_STAGES]
        for si, (ch, n) in enumerate(HED_STAGES):
            self.add_module(f"block{si + 1}", _DoubleConvBlock(chans[si], ch, n, device))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        h, w = pixels.shape[1:3]
        x = pixels.float().permute(0, 3, 1, 2) - self.norm
        sides = []
        for si in range(len(HED_STAGES)):
            block = getattr(self, f"block{si + 1}")
            if si:
                x = F.max_pool2d(x, 2, 2)
            for conv in block.convs:
                x = F.relu(conv(x))
            proj = block.projection(x).permute(0, 2, 3, 1)        # (B, h_s, w_s, 1)
            sides.append(resize_image(proj, h, w, "bilinear"))
        return torch.sigmoid(torch.cat(sides, dim=-1).mean(dim=-1))
