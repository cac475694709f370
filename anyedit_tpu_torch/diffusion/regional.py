"""Region-conditioned generation for composition (counterpart of
`anyedit_tpu/diffusion/regional.py`).

A canvas plan of one `global:` line and `region: x1,y1,x2,y2 | text` lines
(`parse_canvas_plan`) becomes one fused context [global tokens | region
tokens ...] and an additive cross-attention bias that lets each image token
attend the global span plus the spans of the regions covering it
(`region_bias`, -1e9 elsewhere). `regional_processor` applies it through
the UNet's processor slot at every cross-attention site whose query length
is one of the prepared latent resolutions; self-attention, and a cross
site at any other length (the SD1.5 mid block's 64 tokens at the 512
canvas), take plain `sdpa` with no bias, as in the JAX package. No site
takes a hand kernel.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

import numpy as np
import torch

from anyedit_tpu_torch.models.layers import AttnMeta
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass
class Region:
    box: tuple[float, float, float, float]   # normalized x1, y1, x2, y2
    span: tuple[int, int]                    # token span in the fused context


def parse_canvas_plan(text: str) -> tuple[str, list[tuple[tuple[float, ...], str]]]:
    """Canvas plan -> (global prompt, [(normalized box, description)]). Boxes
    with a coordinate above 1 are divided by their largest coordinate."""
    global_prompt = ""
    regions = []
    for line in text.splitlines():
        line = line.strip()
        if line.lower().startswith("global:"):
            global_prompt = line.split(":", 1)[1].strip()
        m = re.match(r"region:\s*([\d.]+),([\d.]+),([\d.]+),([\d.]+)\s*\|\s*(.+)", line, re.I)
        if m:
            box = tuple(float(m.group(i)) for i in range(1, 5))
            if max(box) > 1.0:
                box = tuple(v / max(box) for v in box)
            regions.append((box, m.group(5).strip()))
    return global_prompt, regions


def region_bias(regions: Sequence[Region], hw: int, text_len: int,
                global_span: tuple[int, int]) -> torch.Tensor:
    """(hw^2, text_len) fp32 additive bias: 0 where an image token (cell
    centres, row-major) may attend a text token, -1e9 elsewhere."""
    allow = np.zeros((hw * hw, text_len), np.float32)
    gs, ge = global_span
    allow[:, gs:ge] = 1.0
    ys, xs = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    cy = (ys.reshape(-1) + 0.5) / hw
    cx = (xs.reshape(-1) + 0.5) / hw
    for r in regions:
        x1, y1, x2, y2 = r.box
        inside = (cx >= x1) & (cx < x2) & (cy >= y1) & (cy < y2)
        s, e = r.span
        allow[inside, s:e] = 1.0
    return torch.from_numpy(np.where(allow > 0, 0.0, -1e9).astype(np.float32))


def regional_processor(bias_by_len: dict[int, torch.Tensor]) -> Callable:
    """Attention processor: the prepared bias at every cross-attention site
    whose query length is a key of `bias_by_len`, plain sdpa elsewhere."""

    def proc(q, k, v, meta: AttnMeta, extra=None):
        if meta.is_self or q.shape[2] not in bias_by_len:
            return sdpa(q, k, v)
        return sdpa(q, k, v, bias=bias_by_len[q.shape[2]].to(q.device)[None, None])

    return proc


def build_regional_conditioning(encode_text: Callable[[str], torch.Tensor],
                                global_prompt: str,
                                region_prompts: Sequence[tuple[tuple[float, ...], str]],
                                latent_hws: Sequence[int]) -> tuple[torch.Tensor, Callable]:
    """Fused context (1, L, D) = [global tokens | region tokens ...] and the
    matching processor for the given latent resolutions."""
    parts = [encode_text(global_prompt)]
    offset = parts[0].shape[1]
    global_span = (0, offset)
    regions = []
    for box, prompt in region_prompts:
        emb = encode_text(prompt)
        parts.append(emb)
        regions.append(Region(box=box, span=(offset, offset + emb.shape[1])))
        offset += emb.shape[1]
    ctx = torch.cat(parts, dim=1)
    device = ctx.device
    bias_by_len = {hw * hw: region_bias(regions, hw, ctx.shape[1], global_span).to(device)
                   for hw in latent_hws}
    return ctx, regional_processor(bias_by_len)
