"""VILA-class VLM, the pre-filter's alternative VQA judge (counterpart of
`anyedit_tpu/models/vila.py`).

The llava composition: a CLIP ViT-L/14-336 tower built with its last block
dropped (HF's `vision_feature_layer=-2`), the CLS token excluded, a 2-layer
exact-GELU projector in fp32, and the image tokens spliced before the
prompt embeddings of a Llama decoder (vicuna-7B). One prefill answers the
question; yes/no compares the next-token logits. Submodules carry the HF
`LlavaForConditionalGeneration` names (model.vision_tower.vision_model.*,
model.multi_modal_projector.linear_1/2, model.language_model.*, lm_head).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionEncoder, TINY_VISION
from anyedit_tpu_torch.models.llama import (
    LLAMA3_8B, TINY_LLAMA, CausalLM, LlamaConfig, LlamaModel,
)


@dataclasses.dataclass(frozen=True)
class VilaConfig:
    # llava-1.5: CLIP ViT-L/14-336 features from hidden layer -2 (the tower
    # is built without its last block) and the CLS token excluded
    vision: CLIPVisionConfig = CLIPVisionConfig(image_size=336, patch=14,
                                                hidden=1024, layers=23,
                                                heads=16, use_proj=False)
    lm: LlamaConfig = dataclasses.replace(
        LLAMA3_8B, vocab_size=32064, kv_heads=32, ffn_dim=11008,
        rope_theta=10000.0)                      # vicuna-7b (llava-1.5)
    dtype: Any = torch.bfloat16


VILA_1_5 = VilaConfig()
TINY_VILA = VilaConfig(vision=dataclasses.replace(TINY_VISION, use_proj=False),
                       lm=TINY_LLAMA)


class MMProjector(nn.Module):
    """Vision hidden -> fp32 Linear -> exact GELU -> fp32 Linear -> lm dim
    (HF LlavaMultiModalProjector linear_1 / linear_2)."""

    def __init__(self, vision_dim: int, lm_dim: int, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(vision_dim, lm_dim, device=device)
        self.linear_2 = nn.Linear(lm_dim, lm_dim, device=device)

    def forward(self, tokens):
        return self.linear_2(F.gelu(self.linear_1(tokens.float())))


class VilaVQA(CausalLM):
    """(pixels (B, S, S, 3) normalized, prompt ids (B, L)) -> the next-token
    logits after the prompt (B, V) fp32."""

    def __init__(self, cfg: VilaConfig = VILA_1_5, device=None):
        super().__init__()
        self.cfg = cfg
        self.lm_cfg = cfg.lm
        self.model = nn.Module()
        self.model.vision_tower = CLIPVisionEncoder(cfg.vision, device=device)
        self.model.multi_modal_projector = MMProjector(cfg.vision.hidden, cfg.lm.dim, device)
        self.model.language_model = LlamaModel(cfg.lm, device)
        self.lm_head = nn.Linear(cfg.lm.dim, cfg.lm.vocab_size, bias=False, device=device)

    @property
    def lm_body(self) -> LlamaModel:
        return self.model.language_model

    def forward(self, pixels, prompt_ids):
        tokens, _ = self.model.vision_tower(pixels)
        img = self.model.multi_modal_projector(tokens[:, 1:]).to(self.lm_cfg.dtype)
        embeds = torch.cat([img, self.embed(prompt_ids)], dim=1)
        logits, _ = self.prefill(embeds, embeds.shape[1])
        return logits
