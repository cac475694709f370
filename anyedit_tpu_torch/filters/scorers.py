"""Quality scorers (counterpart of `anyedit_tpu/filters/scorers.py`).

Pure functions over embeddings the shared CLIP towers computed, on the
tensors' device, plus the LAION aesthetic MLP. The executor's post-scorer
calls `clip_score`, `directional_clip_score` and `ocr_text_match`. Its
pixel L1 stays numpy's float32 mean, as the JAX executor's is, so the two
ledgers hold the same bits. `l1_distance` and `ssim` wait for the callers
the JAX package gives them (`runtime/evaluate.py`, `edits/implicit.py`),
which later slices port; `cosine_similarity` is part of the same public
surface, as in the JAX package, which calls it nowhere either.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from anyedit_tpu_torch.ops.morphology import gaussian_blur


def clip_score(image_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of L2-normalized CLIP embeddings (utils.py:24-40):
    the raw cosine, the convention the filter thresholds are calibrated
    for."""
    return (image_emb * text_emb).sum(dim=-1)


def _unit(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def directional_clip_score(src_img: torch.Tensor, tgt_img: torch.Tensor,
                           src_txt: torch.Tensor, tgt_txt: torch.Tensor,
                           eps: float = 1e-8) -> torch.Tensor:
    """Directional CLIP (utils.py:284-301): cos(Δimage, Δtext), whether the
    image moved the way the caption edit says."""
    return (_unit(tgt_img - src_img, eps) * _unit(tgt_txt - src_txt, eps)).sum(dim=-1)


def l1_distance(img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """Mean absolute pixel difference per image of a batch (utils.py:102-110)."""
    d = (img_a.float() - img_b.float()).abs()
    return d.mean(dim=tuple(range(1, d.dim())))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return (_unit(a, eps) * _unit(b, eps)).sum(dim=-1)


def ssim(img_a: torch.Tensor, img_b: torch.Tensor, max_val: float = 1.0,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over (..., H, W, C) images in [0, max_val] (the implicit
    pipeline's best-of-N consistency score, implicit_tool.py:34-127)."""
    a = torch.movedim(img_a.float(), -1, 0)     # (C, ..., H, W)
    b = torch.movedim(img_b.float(), -1, 0)
    mu_a, mu_b = gaussian_blur(a, sigma), gaussian_blur(b, sigma)
    var_a = gaussian_blur(a * a, sigma) - mu_a * mu_a
    var_b = gaussian_blur(b * b, sigma) - mu_b * mu_b
    cov = gaussian_blur(a * b, sigma) - mu_a * mu_b
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean(dim=(0, -2, -1))


def ocr_text_match(text_a: str, text_b: str) -> bool:
    """GOT-OCR2 both-sides text check (post_filter.py:70-79 surface):
    normalized string equality of the OCR'd target strings."""
    def norm(s):
        return re.sub(r"[^a-z0-9]", "", s.lower())
    return norm(text_a) == norm(text_b) and len(norm(text_a)) > 0


class AestheticMLP(nn.Module):
    """The LAION aesthetic predictor head (pre_filter.py:38-81): a CLIP-L
    image embedding -> a scalar score, fp32, no activations. `layers` is
    the released checkpoint's torch Sequential (its dropouts at 1, 3, 5
    have no parameters and are inert at inference)."""

    def __init__(self, in_dim: int = 768, device=None):
        super().__init__()
        dims = [in_dim, 1024, 128, 64, 16, 1]
        mods: list[nn.Module] = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            mods.append(nn.Linear(a, b, device=device))
            if i < 3:
                mods.append(nn.Identity())
        self.layers = nn.Sequential(*mods)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.layers(emb.float())[..., 0]
