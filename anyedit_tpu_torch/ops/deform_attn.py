"""Multi-scale deformable attention (counterpart of `anyedit_tpu/ops/deform_attn.py`).

Each query bilinearly samples K points from each of L feature levels per
head and blends them with learned attention weights. The JAX package does
this with XLA gathers and no Pallas kernel, so the port stays plain
PyTorch: one `F.grid_sample` per level (bilinear, zero padding,
align_corners=False, which puts a normalized x at x * W - 0.5 pixels, the
JAX formula), sampled from fp32 values as the JAX blend is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _level_starts(spatial_shapes, s: int) -> list[int]:
    starts, off = [], 0
    for hh, ww in spatial_shapes:
        starts.append(off)
        off += hh * ww
    if off != s:
        raise ValueError(f"ms_deform_attn: levels hold {off} tokens, value has {s}")
    return starts


def ms_deform_attn(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, H, D), S = sum of h_l * w_l over the levels
    `spatial_shapes` ((h0, w0), ...); sampling_locations (B, Q, H, L, K, 2)
    normalized (x, y); attention_weights (B, Q, H, L, K), softmaxed over
    L * K. Returns (B, Q, H * D) in value's dtype."""
    b, s, h, d = value.shape
    _, q, _, l, k, _ = sampling_locations.shape
    if l != len(spatial_shapes):
        raise ValueError(f"ms_deform_attn: {l} levels of locations, "
                         f"{len(spatial_shapes)} shapes")
    starts = _level_starts(spatial_shapes, s)
    grid = 2.0 * sampling_locations.float() - 1.0
    out = torch.zeros(b * h, d, q, dtype=torch.float32, device=value.device)
    for li, (hh, ww) in enumerate(spatial_shapes):
        v = value[:, starts[li]:starts[li] + hh * ww].float()           # (B, hw, H, D)
        v = v.permute(0, 2, 3, 1).reshape(b * h, d, hh, ww)
        g = grid[:, :, :, li].permute(0, 2, 1, 3, 4).reshape(b * h, q, k, 2)
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)                    # (BH, D, Q, K)
        w = attention_weights[:, :, :, li].float().permute(0, 2, 1, 3)
        out += (sampled * w.reshape(b * h, 1, q, k)).sum(-1)
    out = out.reshape(b, h, d, q).permute(0, 3, 1, 2)
    return out.reshape(b, q, h * d).to(value.dtype)


def ms_deform_attn_ref(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """Slow loop reference for the tests: per level, batch, head and point,
    the four corners of each sample read one by one, each zero outside the
    map (`map_coordinates(order=1, mode="constant")` semantics)."""
    b, s, h, d = value.shape
    _, q, _, l, k, _ = sampling_locations.shape
    starts = _level_starts(spatial_shapes, s)
    out = torch.zeros(b, q, h, d, dtype=torch.float32, device=value.device)
    for li, (hh, ww) in enumerate(spatial_shapes):
        lvl = value[:, starts[li]:starts[li] + hh * ww].float().reshape(b, hh, ww, h, d)
        for bi in range(b):
            for hi in range(h):
                img = lvl[bi, :, :, hi]                               # (hh, ww, D)
                for ki in range(k):
                    loc = sampling_locations[bi, :, hi, li, ki].float()   # (Q, 2)
                    x = loc[:, 0] * ww - 0.5
                    y = loc[:, 1] * hh - 0.5
                    x0, y0 = torch.floor(x), torch.floor(y)
                    sampled = torch.zeros(q, d, dtype=torch.float32, device=value.device)
                    for dx in (0, 1):
                        for dy in (0, 1):
                            xi, yi = x0 + dx, y0 + dy
                            wgt = (1 - (x - xi).abs()) * (1 - (y - yi).abs())
                            inb = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
                            xc = xi.clamp(0, ww - 1).long()
                            yc = yi.clamp(0, hh - 1).long()
                            sampled += torch.where(inb[:, None], img[yc, xc], 0.0) \
                                * wgt[:, None]
                    w = attention_weights[bi, :, hi, li, ki].float()[:, None]
                    out[bi, :, hi] += sampled * w
    return out.reshape(b, q, h * d).to(value.dtype)
