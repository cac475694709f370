"""GOT-OCR2 scene-text recognizer, the textual_change gate's reader
(counterpart of `anyedit_tpu/models/ocr.py`).

The GOT architecture: the SAM ViT-B image encoder (windowed attention,
decomposed rel-pos, the 256-channel neck; `models/sam.py`) -> two stride-2
3x3 convs without bias -> an fp32 linear projector -> a Qwen2-class decoder
(Llama blocks with q/k/v biases; the lm head tied to the embedding in the
checkpoint, held here as its own copy, as the JAX converter fills it).
Submodules: model.vision_tower (the SAM encoder's own names),
model.multi_modal_projector.conv_upsampler1 / conv_upsampler2 /
multimodal_projector, model.language_model (HF Qwen2 names), lm_head.

`greedy_decode` re-runs the full forward for every new token (no KV
cache), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from anyedit_tpu_torch.models.llama import CausalLM, LlamaConfig, LlamaModel
from anyedit_tpu_torch.models.sam import SAM_VIT_B, TINY_SAM, SAMConfig, SAMImageEncoder

# the Qwen2-0.5B-class LM inside GOT-OCR2 (HF text_config): hidden 1024,
# 24 layers, 16 heads (no GQA), ffn 2816, rope 1e6, qkv bias
QWEN2_GOT = LlamaConfig(vocab_size=151860, dim=1024, layers=24, heads=16,
                        kv_heads=16, ffn_dim=2816, rope_theta=1e6,
                        norm_eps=1e-6, qkv_bias=True)

TINY_QWEN = LlamaConfig(vocab_size=256, dim=32, layers=2, heads=4,
                        kv_heads=2, ffn_dim=64, rope_theta=10000.0,
                        norm_eps=1e-6, qkv_bias=True)


@dataclasses.dataclass(frozen=True)
class OCRConfig:
    vision: SAMConfig = SAM_VIT_B          # 1024 px, 64 x 64 x 256 neck output
    lm: LlamaConfig = QWEN2_GOT
    max_tokens: int = 32
    dtype: Any = torch.bfloat16


GOT_OCR = OCRConfig()
TINY_OCR = OCRConfig(vision=TINY_SAM, lm=TINY_QWEN, max_tokens=8)


class GotOCR(CausalLM):
    """pixels -> image tokens -> causal LM over [image, text] (GOT layout:
    image tokens first, prompt and answer after)."""

    def __init__(self, cfg: OCRConfig = GOT_OCR, device=None):
        super().__init__()
        self.cfg = cfg
        self.lm_cfg = cfg.lm
        out = cfg.vision.out_dim
        conv = dict(kernel_size=3, stride=2, padding=1, bias=False, dtype=cfg.dtype,
                    device=device)
        self.model = nn.Module()
        self.model.vision_tower = SAMImageEncoder(cfg.vision, device=device)
        proj = self.model.multi_modal_projector = nn.Module()
        proj.conv_upsampler1 = nn.Conv2d(out, 2 * out, **conv)
        proj.conv_upsampler2 = nn.Conv2d(2 * out, cfg.lm.dim, **conv)
        proj.multimodal_projector = nn.Linear(cfg.lm.dim, cfg.lm.dim, device=device)
        self.model.language_model = LlamaModel(cfg.lm, device)
        self.lm_head = nn.Linear(cfg.lm.dim, cfg.lm.vocab_size, bias=False, device=device)

    @property
    def lm_body(self) -> LlamaModel:
        return self.model.language_model

    def encode_image(self, pixels):
        """(B, S, S, 3) normalized -> (B, (S/64)^2, lm.dim) fp32 image tokens."""
        proj = self.model.multi_modal_projector
        f = self.model.vision_tower(pixels).permute(0, 3, 1, 2)
        h = proj.conv_upsampler2(proj.conv_upsampler1(f.to(self.cfg.dtype)))
        h = h.flatten(2).transpose(1, 2)                    # (B, hw, D)
        return proj.multimodal_projector(h.float())

    def lm_logits(self, image_tokens, ids):
        """Logits aligned to `ids` (B, L, V): slot i predicts ids[i + 1]."""
        emb = torch.cat([image_tokens.to(self.lm_cfg.dtype), self.embed(ids)], 1)
        return self.forward_embeds(emb)[:, image_tokens.shape[1]:]

    def lm_logits_chat(self, image_tokens, prefix_ids, ids):
        """The GOT chat layout [prefix, image tokens, ids] (the image where
        HF puts the <imgpad> run); logits aligned to `ids`."""
        emb = torch.cat([self.embed(prefix_ids), image_tokens.to(self.lm_cfg.dtype),
                         self.embed(ids)], 1)
        return self.forward_embeds(emb)[:, prefix_ids.shape[1] + image_tokens.shape[1]:]

    def forward(self, pixels, ids):
        """Logits over the whole [image, ids] sequence (B, N_img + L, V)."""
        img = self.encode_image(pixels)
        return self.forward_embeds(torch.cat([img.to(self.lm_cfg.dtype), self.embed(ids)], 1))


@torch.inference_mode()
def greedy_decode(apply_fn: Callable, image_tokens: torch.Tensor, max_tokens: int,
                  eos_id: int = 1, prompt_ids: Optional[list[int]] = None,
                  stop_ids: Optional[frozenset[int]] = None) -> np.ndarray:
    """Greedy ids (B, len(prompt) + max_tokens): apply_fn(image_tokens, ids)
    -> logits (B, L, V) with slot i predicting ids[i + 1], re-run over the
    whole id buffer for each new token. `prompt_ids` (default [0]) seeds
    the buffer; the loop ends once every row has produced a stop id
    (`stop_ids`, default {eos_id})."""
    b = image_tokens.shape[0]
    p = list(prompt_ids) if prompt_ids else [0]    # <pad>-BOS convention
    total = len(p) + max_tokens
    ids = np.zeros((b, total), np.int64)
    ids[:, :len(p)] = np.asarray(p, np.int64)
    stops = stop_ids or frozenset({eos_id})
    done = np.zeros((b,), bool)
    for i in range(len(p) - 1, total - 1):
        logits = apply_fn(image_tokens, torch.from_numpy(ids).to(image_tokens.device))
        nxt = logits[:, i].argmax(-1).cpu().numpy()
        ids[:, i + 1] = nxt
        done |= np.isin(nxt, list(stops))
        if done.all():
            break
    return ids


def detokenize_ids(ids: np.ndarray, id_to_piece: Callable[[int], str],
                   eos_id: int = 1) -> str:
    out = []
    for tid in ids[1:]:
        if tid == eos_id:
            break
        out.append(id_to_piece(int(tid)))
    return "".join(out).replace("▁", " ").strip()
