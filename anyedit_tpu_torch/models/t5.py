"""T5 encoder and decoder: BLIP-2's language model (counterpart of
`anyedit_tpu/models/t5.py`).

T5 v1.1 semantics as in the JAX package: RMSNorm in fp32 (eps 1e-6), a
relative-position-bucket bias computed by block 0 and reused by every
later block (encoder bidirectional, decoder unidirectional with a causal
bias of -1e9), unscaled attention, a gated FFN on the tanh form of GELU
(flax's default `nn.gelu`), and an fp32 lm head. Submodules carry the HF
`T5Stack` names (embed_tokens, block.N.layer.0.SelfAttention.q, ...,
block.N.layer.M.DenseReluDense.wi_0, final_layer_norm).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 4096            # T5-XXL
    kv_dim: int = 64
    heads: int = 64
    ffn_dim: int = 10240
    enc_layers: int = 24
    dec_layers: int = 24
    rel_buckets: int = 32
    rel_max_dist: int = 128
    dtype: Any = torch.bfloat16


T5_XXL = T5Config()        # SD3's and Flux's text encoder (the encoder only)
FLAN_T5_XL = T5Config(dim=2048, heads=32, kv_dim=64, ffn_dim=5120,
                      enc_layers=24, dec_layers=24)
TINY_T5 = T5Config(vocab_size=64, dim=32, kv_dim=8, heads=4, ffn_dim=64,
                   enc_layers=2, dec_layers=2)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-6) * weight in fp32, cast to `dtype`."""

    def __init__(self, dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (n * self.weight).to(self.dtype)


def rel_pos_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                   max_dist: int) -> torch.Tensor:
    """T5 relative-position bucketing (log-spaced beyond max_exact), in the
    JAX package's fp32 arithmetic (the log bucket truncated to int32), so
    the buckets equal its as integers. `rel` (key - query) is int."""
    rel = rel.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    # divisions by fp32 tensors: a Python-scalar divisor is a reciprocal
    # multiply on the card, which can move a value across a bucket edge
    # (T5Attention computes its buckets on the CPU in any case)
    f32 = dict(dtype=torch.float32, device=rel.device)
    large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / torch.tensor(float(max_exact), **f32))
        / torch.tensor(math.log(max_dist / max_exact), **f32)
        * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


@functools.lru_cache(maxsize=32)
def _buckets(lq: int, lk: int, bidirectional: bool, num_buckets: int,
             max_dist: int) -> torch.Tensor:
    """(lq, lk) buckets of key - query, computed on the CPU (whose log the
    tests hold to JAX's) for every device. Made outside inference mode, so
    a cached table also serves callers that autograd tracks."""
    with torch.inference_mode(False):
        pos = torch.arange(max(lq, lk))
        return rel_pos_bucket(pos[None, :lk] - pos[:lq, None], bidirectional, num_buckets,
                              max_dist)


class T5Attention(nn.Module):
    """Unscaled multi-head attention; with `has_rel_bias` (block 0) it owns
    the bucket table and returns the position bias it computed, which
    later blocks receive and add."""

    def __init__(self, cfg: T5Config, has_rel_bias: bool = False,
                 bidirectional: bool = True, device=None):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        inner = cfg.heads * cfg.kv_dim
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        self.q = nn.Linear(cfg.dim, inner, **kw)
        self.k = nn.Linear(cfg.dim, inner, **kw)
        self.v = nn.Linear(cfg.dim, inner, **kw)
        self.o = nn.Linear(inner, cfg.dim, **kw)
        if has_rel_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.heads,
                                                        device=device)
            self.relative_attention_bias.param_init = {"weight": 0.02}

    def forward(self, x, kv=None, bias=None, pos_bias=None):
        c = self.cfg
        kv = x if kv is None else kv
        b, lq, lk = x.shape[0], x.shape[1], kv.shape[1]

        def split(t, l):
            return t.reshape(b, l, c.heads, c.kv_dim).permute(0, 2, 1, 3)
        q, k, v = split(self.q(x), lq), split(self.k(kv), lk), split(self.v(kv), lk)
        if hasattr(self, "relative_attention_bias"):
            bucket = _buckets(lq, lk, self.bidirectional, c.rel_buckets,
                              c.rel_max_dist).to(x.device)
            pos_bias = self.relative_attention_bias.weight[bucket].permute(2, 0, 1)[None]
        total = torch.zeros((1, c.heads, lq, lk), device=x.device)
        if pos_bias is not None:
            total = total + pos_bias
        if bias is not None:
            total = total + bias
        o = sdpa(q, k, v, scale=1.0, bias=total)
        return self.o(o.permute(0, 2, 1, 3).reshape(b, lq, c.heads * c.kv_dim)), pos_bias


class T5FFN(nn.Module):
    """Gated GELU (tanh form) FFN under HF's `DenseReluDense` names."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        self.wi_0 = nn.Linear(cfg.dim, cfg.ffn_dim, **kw)
        self.wi_1 = nn.Linear(cfg.dim, cfg.ffn_dim, **kw)
        self.wo = nn.Linear(cfg.ffn_dim, cfg.dim, **kw)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _Sublayer(nn.Module):
    """One `block.N.layer.M`: its RMSNorm and its attention or FFN."""

    def __init__(self, cfg: T5Config, name: str, body: nn.Module, device):
        super().__init__()
        self.layer_norm = RMSNorm(cfg.dim, cfg.dtype, device)
        setattr(self, name, body)


def _key_mask_bias(mask):
    """(B, L) bool -> (B, 1, 1, L) additive bias: 0 where kept, -1e9 where not."""
    if mask is None:
        return None
    return torch.where(mask, 0.0, -1e9)[:, None, None, :].float()


class T5Encoder(nn.Module):
    """ids (B, L), mask (B, L) bool -> hidden states (B, L, dim) fp32."""

    def __init__(self, cfg: T5Config = FLAN_T5_XL, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=cfg.dtype,
                                         device=device)
        self.block = nn.ModuleList()
        for i in range(cfg.enc_layers):
            blk = nn.Module()
            blk.layer = nn.ModuleList([
                _Sublayer(cfg, "SelfAttention",
                          T5Attention(cfg, has_rel_bias=i == 0, device=device), device),
                _Sublayer(cfg, "DenseReluDense", T5FFN(cfg, device), device)])
            self.block.append(blk)
        self.final_layer_norm = RMSNorm(cfg.dim, cfg.dtype, device)

    def forward(self, ids, mask=None):
        x = self.embed_tokens(ids)
        kpm = _key_mask_bias(mask)
        pos_bias = None
        for blk in self.block:
            sa, ff = blk.layer
            a, pos_bias = sa.SelfAttention(sa.layer_norm(x), bias=kpm, pos_bias=pos_bias)
            x = x + a
            x = x + ff.DenseReluDense(ff.layer_norm(x))
        return self.final_layer_norm(x).float()


class T5Decoder(nn.Module):
    """Single-pass decoder: ids (B, L), encoder states (B, Le, dim), their
    mask -> logits (B, L, vocab) fp32 through `lm_head`, or with
    `lm_head=False` the final-norm hidden states (the owner applies its
    own head, as BLIP-2's `language_model.lm_head`)."""

    def __init__(self, cfg: T5Config = FLAN_T5_XL, device=None, lm_head: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=cfg.dtype,
                                         device=device)
        self.block = nn.ModuleList()
        for i in range(cfg.dec_layers):
            blk = nn.Module()
            blk.layer = nn.ModuleList([
                _Sublayer(cfg, "SelfAttention",
                          T5Attention(cfg, has_rel_bias=i == 0, bidirectional=False,
                                      device=device), device),
                _Sublayer(cfg, "EncDecAttention", T5Attention(cfg, device=device), device),
                _Sublayer(cfg, "DenseReluDense", T5FFN(cfg, device), device)])
            self.block.append(blk)
        self.final_layer_norm = RMSNorm(cfg.dim, cfg.dtype, device)
        if lm_head:
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device)

    def forward(self, ids, enc_out, enc_mask=None):
        c = self.cfg
        x = self.embed_tokens(ids)
        l = ids.shape[1]
        causal = torch.triu(torch.full((l, l), -1e9, device=ids.device), diagonal=1)[None, None]
        kpm = _key_mask_bias(enc_mask)
        enc = enc_out.to(c.dtype)
        pos_bias = None
        for blk in self.block:
            sa, ca, ff = blk.layer
            a, pos_bias = sa.SelfAttention(sa.layer_norm(x), bias=causal, pos_bias=pos_bias)
            x = x + a
            x = x + ca.EncDecAttention(ca.layer_norm(x), kv=enc, bias=kpm)[0]
            x = x + ff.DenseReluDense(ff.layer_norm(x))
        x = self.final_layer_norm(x)
        return self.lm_head(x.float()) if hasattr(self, "lm_head") else x
