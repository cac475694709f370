"""BERT text encoder, GroundingDINO's language tower (counterpart of
`anyedit_tpu/models/bert.py`).

Submodules carry the HF `BertModel` names (embeddings.word_embeddings, ...,
encoder.layer.N.attention.self.query, ..., encoder.layer.N.output.LayerNorm).
The feed-forward uses exact-erf GELU, as HF BERT does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm, Linear
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 512
    type_vocab: int = 2
    dtype: Any = torch.bfloat16


BERT_BASE = BertConfig()
TINY_BERT = BertConfig(vocab_size=128, hidden=32, layers=2, heads=2, max_len=32)


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig, device):
        super().__init__()
        # token and type tables in the compute dtype (Flax `Embed(dtype)`
        # casts its fp32 table at lookup); positions fp32, cast at use
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden, dtype=c.dtype,
                                            device=device)
        self.position_embeddings = nn.Embedding(c.max_len, c.hidden, device=device)
        self.position_embeddings.param_init = {"weight": 0.02}
        self.token_type_embeddings = nn.Embedding(c.type_vocab, c.hidden, dtype=c.dtype,
                                                  device=device)
        self.LayerNorm = LayerNorm(c.hidden, dtype=c.dtype, device=device)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig, kw):
        super().__init__()
        self.query = Linear(c.hidden, c.hidden, **kw)
        self.key = Linear(c.hidden, c.hidden, **kw)
        self.value = Linear(c.hidden, c.hidden, **kw)


class _Dense(nn.Module):
    """An HF `...Output` / `...Intermediate` block: `dense` (+ `LayerNorm`)."""

    def __init__(self, d_in: int, d_out: int, c: BertConfig, kw, norm: bool):
        super().__init__()
        self.dense = Linear(d_in, d_out, **kw)
        if norm:
            self.LayerNorm = LayerNorm(d_out, dtype=c.dtype, device=kw["device"])


class _Attention(nn.Module):
    def __init__(self, c: BertConfig, kw):
        super().__init__()
        self.self = _SelfAttention(c, kw)
        self.output = _Dense(c.hidden, c.hidden, c, kw, norm=True)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.heads = c.heads
        self.attention = _Attention(c, kw)
        self.intermediate = _Dense(c.hidden, 4 * c.hidden, c, kw, norm=False)
        self.output = _Dense(4 * c.hidden, c.hidden, c, kw, norm=True)

    def forward(self, x, bias):
        b, l, hidden = x.shape
        sa = self.attention.self

        def split(t):
            return t.reshape(b, l, self.heads, -1).permute(0, 2, 1, 3)
        out = sdpa(split(sa.query(x)), split(sa.key(x)), split(sa.value(x)), bias=bias)
        out = self.attention.output.dense(out.permute(0, 2, 1, 3).reshape(b, l, hidden))
        x = self.attention.output.LayerNorm(x + out)
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Encoder(nn.Module):
    def __init__(self, c: BertConfig, device):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(c, device) for _ in range(c.layers)])


class BertEncoder(nn.Module):
    """(ids (B, L), attn_bias, token_type, position_ids) -> hidden states
    (B, L, H) fp32. attn_bias: (B|1, 1|H, L, L) additive fp32 mask or None;
    position_ids default to 0..L-1 (GroundingDINO restarts them per
    phrase segment)."""

    def __init__(self, cfg: BertConfig = BERT_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, device)
        self.encoder = _Encoder(cfg, device)

    def forward(self, ids, attn_bias=None, token_type=None, position_ids=None):
        c = self.cfg
        e = self.embeddings
        l = ids.shape[1]
        pos = e.position_embeddings.weight
        x = e.word_embeddings(ids)
        x = x + (pos[None, :l] if position_ids is None else pos[position_ids]).to(c.dtype)
        if token_type is None:
            token_type = torch.zeros_like(ids)
        x = e.LayerNorm(x + e.token_type_embeddings(token_type))
        for layer in self.encoder.layer:
            x = layer(x, attn_bias)
        return x.float()
