"""BLIP-2: the Q-Former yes/no VQA scorer of the filter layer (counterpart
of `anyedit_tpu/models/blip2.py`).

Frozen ViT image tokens -> Q-Former (post-norm BERT blocks whose learned
queries cross-attend to the image every `cross_every` layers) -> a linear
map to the LM width -> FLAN-T5: the encoder reads [query embeddings;
question], the decoder scores one step from the <pad> start token.
`yes_no` compares the 'yes' and 'no' logits of that step, so no generation
loop runs.

Submodules carry the HF `Blip2ForConditionalGeneration` names
(query_tokens, qformer.layernorm, qformer.encoder.layer.N.attention...,
language_projection, language_model.{encoder,decoder,lm_head}). Every
attention site is the plain `sdpa`, as the JAX package's `sdpa_xla`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm
from anyedit_tpu_torch.models.t5 import FLAN_T5_XL, TINY_T5, T5Config, T5Decoder, T5Encoder
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    num_queries: int = 32
    dim: int = 768
    layers: int = 12
    heads: int = 12
    cross_every: int = 2        # cross-attend to the image every N layers
    # EVA ViT-g's width. As in the JAX package no model reads it: the
    # cross-attention keys and values are sized from the tower's width
    # (`image_dim` of the modules below).
    image_dim: int = 1408
    lm: T5Config = FLAN_T5_XL
    dtype: Any = torch.bfloat16


BLIP2_QFORMER = QFormerConfig()
TINY_QFORMER = QFormerConfig(num_queries=4, dim=32, layers=2, heads=2,
                             cross_every=1, image_dim=16, lm=TINY_T5)


class _BertAttention(nn.Module):
    """attention.{query,key,value} -> output.dense -> output.LayerNorm(x + .)."""

    def __init__(self, cfg: QFormerConfig, kv_dim: int, device):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.heads = cfg.heads
        self.attention = nn.Module()
        self.attention.query = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.attention.key = nn.Linear(kv_dim, cfg.dim, **kw)
        self.attention.value = nn.Linear(kv_dim, cfg.dim, **kw)
        self.output = nn.Module()
        self.output.dense = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.output.LayerNorm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)

    def forward(self, x, kv):
        a = self.attention
        b, l, dim = x.shape
        hd = dim // self.heads

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, hd).permute(0, 2, 1, 3)
        o = sdpa(split(a.query(x)), split(a.key(kv)), split(a.value(kv)))
        o = self.output.dense(o.permute(0, 2, 1, 3).reshape(b, l, dim))
        return self.output.LayerNorm(x + o)


class QFormerBlock(nn.Module):
    """The HF Blip2QFormerLayer: post-norm self-attention, cross-attention
    to the raw image tokens (with `with_cross`), and the query-path FFN
    (intermediate_query / output_query, exact GELU)."""

    def __init__(self, cfg: QFormerConfig, with_cross: bool, image_dim: int, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.dtype = cfg.dtype
        self.attention = _BertAttention(cfg, cfg.dim, device)
        if with_cross:
            self.crossattention = _BertAttention(cfg, image_dim, device)
        self.intermediate_query = nn.Module()
        self.intermediate_query.dense = nn.Linear(cfg.dim, 4 * cfg.dim, **kw)
        self.output_query = nn.Module()
        self.output_query.dense = nn.Linear(4 * cfg.dim, cfg.dim, **kw)
        self.output_query.LayerNorm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)

    def forward(self, q_tokens, image_tokens):
        q_tokens = self.attention(q_tokens, q_tokens)
        if hasattr(self, "crossattention"):
            q_tokens = self.crossattention(q_tokens, image_tokens.to(self.dtype))
        h = self.output_query.dense(F.gelu(self.intermediate_query.dense(q_tokens)))
        return self.output_query.LayerNorm(q_tokens + h)


class QFormer(nn.Module):
    """image tokens (B, N, image_dim) -> query embeddings (B, Q, lm.dim)
    fp32: the learned queries through the input LayerNorm, the blocks, and
    the fp32 `language_projection`."""

    def __init__(self, cfg: QFormerConfig = BLIP2_QFORMER, image_dim: int = 1408,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.num_queries, cfg.dim,
                                                     device=device))
        self.param_init = {"query_tokens": 0.02}
        self.qformer = nn.Module()
        self.qformer.layernorm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.qformer.encoder = nn.Module()
        self.qformer.encoder.layer = nn.ModuleList([
            QFormerBlock(cfg, i % cfg.cross_every == 0, image_dim, device)
            for i in range(cfg.layers)])
        self.language_projection = nn.Linear(cfg.dim, cfg.lm.dim, device=device)

    def query_embeds(self, image_tokens):
        c = self.cfg
        x = self.query_tokens.to(c.dtype).expand(image_tokens.shape[0], -1, -1)
        x = self.qformer.layernorm(x)
        for block in self.qformer.encoder.layer:
            x = block(x, image_tokens)
        return self.language_projection(x.float())

    forward = query_embeds


class Blip2VQA(QFormer):
    """(image tokens, question ids, question mask) -> the logits of the
    decoder's first step (B, vocab), fp32. The Q-Former's parameters sit at
    the top level beside `language_model`, as in the HF checkpoint."""

    def __init__(self, cfg: QFormerConfig = BLIP2_QFORMER, image_dim: int = 1408,
                 device=None):
        super().__init__(cfg, image_dim, device)
        lm = cfg.lm
        self.language_model = nn.Module()
        self.language_model.encoder = T5Encoder(lm, device)
        self.language_model.decoder = T5Decoder(lm, device, lm_head=False)
        self.language_model.lm_head = nn.Linear(lm.dim, lm.vocab_size, bias=False,
                                                device=device)

    def forward(self, image_tokens, question_ids, question_mask):
        lm = self.language_model
        q_emb = self.query_embeds(image_tokens)                      # (B, Q, D)
        text = lm.encoder(question_ids, question_mask)               # (B, L, D)
        b = question_ids.shape[0]
        enc = torch.cat([q_emb, text], dim=1)
        enc_mask = torch.cat([torch.ones((b, q_emb.shape[1]), dtype=torch.bool,
                                         device=question_mask.device),
                              question_mask.bool()], dim=1)
        start = torch.zeros((b, 1), dtype=torch.long, device=question_ids.device)
        h = lm.decoder(start, enc, enc_mask)                         # <pad> start
        return lm.lm_head(h.float())[:, 0]


def yes_no(first_token_logits: torch.Tensor, yes_id: int, no_id: int) -> torch.Tensor:
    """(B,) bool: True where 'yes' outranks 'no'."""
    return first_token_logits[:, yes_id] > first_token_logits[:, no_id]
