"""Llama-class decoder: the instruction-generation LLM and the language
tower of VILA and GOT-OCR2 (counterpart of `anyedit_tpu/models/llama.py`).

The Llama-3 block as in the JAX package: GQA attention with RoPE (the
half-split `rotate_half` layout), RMSNorm with fp32 statistics, a SwiGLU
FFN, an fp32 lm head over the final norm's output, and decode as prefill
plus one step at a time against an explicit KV cache. Submodules carry the
HF `LlamaForCausalLM` names (model.embed_tokens, model.layers.N.self_attn.
q_proj, ..., model.layers.N.mlp.gate_proj, model.norm, lm_head), so a real
checkpoint loads by name.

Numerics follow the JAX module's dtype chain: the block projections run in
`cfg.dtype` (a W8A8 `QuantDense` with `cfg.quant`), the embedding table is
fp32 and returns `cfg.dtype`, the attention logits are the fp32 product of
the (bf16) q and k divided by sqrt(hd) after the product, then the fp32
-1e9 mask bias, an fp32 softmax, p rounded to `cfg.dtype` and P.V
accumulated in fp32. The attention is computed plainly (two matmuls and a
softmax), as the JAX package computes it (an XLA einsum, no Pallas
kernel). The KV cache is held in fp32: every value written is a `cfg.dtype`
value, so the cache holds what the JAX cache holds, and the attention
reads it without a conversion. `decode_step` writes the new key and value
into the caches in place and returns them; masked slots are computed and
then zeroed by the bias, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.ops.quant import make_dense, quantize_state_dict

_NEG = -1e9


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8            # GQA (Llama-3-8B)
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    qkv_bias: bool = False       # Qwen2-family (GOT-OCR2's LM) uses biases
    dtype: Any = torch.bfloat16
    # W8A8 int8 block projections (ops/quant.py); the embedding, lm_head
    # and norms stay float
    quant: bool = False


LLAMA3_8B = LlamaConfig()
TINY_LLAMA = LlamaConfig(vocab_size=256, dim=32, layers=2, heads=4,
                         kv_heads=2, ffn_dim=64, rope_theta=10000.0)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight in fp32, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, L, D); positions (L,). The half-split rotation (HF
    rotate_half), inverse frequencies and angles in fp32."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[:, None] * inv[None]                    # (L, D/2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], -1)
    return (xf * cos + rot * sin).to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
           dtype) -> torch.Tensor:
    """q (B, H, Lq, hd) against k, v (B, KVH, S, hd), head h reading kv head
    h // (H / KVH) (`jnp.repeat` of the kv heads, here by grouping the q
    heads instead of copying k and v); bias (B or 1, 1, Lq, S) fp32.
    Returns (B, H, Lq, hd) fp32."""
    b, h, lq, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, kvh, rep * lq, hd).float()
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) / math.sqrt(hd)
    logits = logits.view(b, kvh, rep, lq, s) + bias.unsqueeze(2)
    p = torch.softmax(logits, dim=-1).to(dtype).float()
    o = torch.matmul(p.view(b, kvh, rep * lq, s), v.float())
    return o.view(b, h, lq, hd)


class _Attention(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        hd = c.dim // c.heads
        kw = dict(quant=c.quant, dtype=c.dtype, device=device)
        self.q_proj = make_dense(c.dim, c.heads * hd, bias=c.qkv_bias, **kw)
        self.k_proj = make_dense(c.dim, c.kv_heads * hd, bias=c.qkv_bias, **kw)
        self.v_proj = make_dense(c.dim, c.kv_heads * hd, bias=c.qkv_bias, **kw)
        self.o_proj = make_dense(c.heads * hd, c.dim, bias=False, **kw)


class _MLP(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        kw = dict(quant=c.quant, bias=False, dtype=c.dtype, device=device)
        self.gate_proj = make_dense(c.dim, c.ffn_dim, **kw)
        self.up_proj = make_dense(c.dim, c.ffn_dim, **kw)
        self.down_proj = make_dense(c.ffn_dim, c.dim, **kw)


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.c = c
        self.input_layernorm = RMSNorm(c.dim, c.norm_eps, device)
        self.self_attn = _Attention(c, device)
        self.post_attention_layernorm = RMSNorm(c.dim, c.norm_eps, device)
        self.mlp = _MLP(c, device)

    def forward(self, x, positions, bias, cache=None, slot: int = 0):
        """x (B, L, D); positions (L,); bias (B or 1, 1, L, S) fp32. Without
        `cache`, attends over this call's own keys and returns (x, (k, v));
        with `cache` (k, v) fp32 (B, KVH, S, hd), first writes this call's
        keys and values at `slot` = positions[0] (in place; an int, so that
        no step reads the device) and attends over every slot; returns
        (x, cache)."""
        c = self.c
        hd = c.dim // c.heads
        b, l, _ = x.shape
        a = self.self_attn
        h = self.input_layernorm(x)
        q = a.q_proj(h).view(b, l, c.heads, hd).transpose(1, 2)
        k = a.k_proj(h).view(b, l, c.kv_heads, hd).transpose(1, 2)
        v = a.v_proj(h).view(b, l, c.kv_heads, hd).transpose(1, 2)
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
        if cache is not None:
            ck, cv = cache
            ck[:, :, slot:slot + l] = k
            cv[:, :, slot:slot + l] = v
            k, v = ck, cv
        o = attend(q, k, v, bias, c.dtype)
        o = o.transpose(1, 2).reshape(b, l, c.heads * hd).to(c.dtype)
        x = x + a.o_proj(o)
        h = self.post_attention_layernorm(x)
        m = self.mlp
        x = x + m.down_proj(F.silu(m.gate_proj(h)) * m.up_proj(h))
        return x, (k, v)


class LlamaModel(nn.Module):
    """HF `LlamaModel`: embed_tokens (fp32 table), layers, norm."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.dim, device=device)
        self.layers = nn.ModuleList([LlamaBlock(c, device) for _ in range(c.layers)])
        self.norm = RMSNorm(c.dim, c.norm_eps, device)


def _causal_bias(l: int, device) -> torch.Tensor:
    return torch.triu(torch.full((l, l), _NEG, device=device), diagonal=1)[None, None]


class CausalLM(nn.Module):
    """The decoder's entry points over `lm_body` (a LlamaModel) and
    `lm_head` (fp32, no bias); `lm_cfg` is its LlamaConfig. Llama, VilaVQA
    and GotOCR hold the two modules under their own (HF) names."""

    lm_cfg: LlamaConfig
    lm_head: nn.Linear

    @property
    def lm_body(self) -> LlamaModel:
        raise NotImplementedError

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.lm_body.embed_tokens(ids).to(self.lm_cfg.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.lm_body.norm(x).float())

    def forward_hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        """The full causal forward minus norm and head: (B, L, D)."""
        l = embeds.shape[1]
        pos = torch.arange(l, device=embeds.device)
        bias = _causal_bias(l, embeds.device)
        x = embeds
        for blk in self.lm_body.layers:
            x, _ = blk(x, pos, bias)
        return x

    def forward_embeds(self, embeds: torch.Tensor) -> torch.Tensor:
        """Full causal forward over embeddings (B, L, D) -> logits (B, L, V) fp32."""
        return self._head(self.forward_hidden(embeds))

    def _prefill(self, embeds, bias, cache_len: int):
        b, l, _ = embeds.shape
        c = self.lm_cfg
        hd = c.dim // c.heads
        pos = torch.arange(l, device=embeds.device)
        x = embeds
        caches = []
        for blk in self.lm_body.layers:
            x, (k, v) = blk(x, pos, bias)
            ck = torch.zeros(b, c.kv_heads, cache_len, hd, device=embeds.device)
            cv = torch.zeros_like(ck)
            ck[:, :, :l] = k
            cv[:, :, :l] = v
            caches.append((ck, cv))
        return self._head(x[:, -1]), caches

    def prefill(self, embeds: torch.Tensor, cache_len: int):
        """embeds (B, L, D) -> (last logits (B, V), caches [(k, v)] with k, v
        (B, KVH, cache_len, hd), zero past L)."""
        return self._prefill(embeds, _causal_bias(embeds.shape[1], embeds.device), cache_len)

    def prefill_padded(self, embeds: torch.Tensor, lengths: torch.Tensor, cache_len: int):
        """A left-padded ragged batch: row b's prompt fills the last
        lengths[b] slots, every row at positions arange(L), the pad slots
        (< start = L - lengths) masked as keys here and in `decode_step`."""
        l = embeds.shape[1]
        pos = torch.arange(l, device=embeds.device)
        start = (l - lengths.to(embeds.device)).to(torch.int32)
        allow = (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] >= start[:, None, None])
        bias = torch.where(allow[:, None], 0.0, _NEG).float()
        return self._prefill(embeds, bias, cache_len)

    def decode_step(self, tok_emb: torch.Tensor, caches, pos: int,
                    start: Optional[torch.Tensor] = None):
        """tok_emb (B, 1, D) at position `pos` (an int): writes its keys and
        values at slot `pos` and attends every slot <= pos (and >= start[b]
        with `start`). Returns (logits (B, V), caches)."""
        cache_len = caches[0][0].shape[2]
        dev = tok_emb.device
        positions = torch.full((1,), pos, device=dev)
        slots = torch.arange(cache_len, device=dev)
        allow = (slots <= pos)[None, None, None]
        if start is not None:
            allow = allow & (slots[None, None, None, :] >= start[:, None, None, None])
        bias = torch.where(allow, 0.0, _NEG).float()
        x = tok_emb
        out = []
        for blk, cache in zip(self.lm_body.layers, caches):
            x, kv = blk(x, positions, bias, cache=cache, slot=pos)
            out.append(kv)
        return self._head(x[:, 0]), out


class Llama(CausalLM):
    """HF `LlamaForCausalLM`: forward(ids) -> logits (B, L, V) fp32."""

    def __init__(self, cfg: LlamaConfig = LLAMA3_8B, device=None):
        super().__init__()
        self.lm_cfg = cfg
        self.model = LlamaModel(cfg, device)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device)

    @property
    def lm_body(self) -> LlamaModel:
        return self.model

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.forward_embeds(self.embed(ids))


def quantize_llama(model: Llama) -> Llama:
    """The W8A8 Llama (`quant=True`) of a float one: the block projections
    quantized per output channel from `model`'s parameters, everything else
    copied. Built on the meta device and assigned, so the peak is `model`
    plus the int8 weights."""
    q = Llama(dataclasses.replace(model.lm_cfg, quant=True), device="meta")
    dev = next(model.parameters()).device
    sd = quantize_state_dict(q, model.state_dict())
    q.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True, assign=True)
    return q.eval().requires_grad_(False)


def _eos_mask(out: np.ndarray, eos_id: Optional[int]) -> np.ndarray:
    if eos_id is not None:
        for r in range(out.shape[0]):
            hits = np.nonzero(out[r] == eos_id)[0]
            if hits.size:
                out[r, hits[0]:] = eos_id
    return out


def _decode_loop(model: CausalLM, logits, caches, l0: int, max_new: int, start=None):
    toks = []
    for pos in range(l0, l0 + max_new):
        tok = logits.argmax(-1)                                       # (B,)
        logits, caches = model.decode_step(model.embed(tok[:, None]), caches, pos, start)
        toks.append(tok)
    return torch.stack(toks, 1).cpu().numpy()


@torch.inference_mode()
def greedy_generate(model: CausalLM, prompt_embeds: torch.Tensor, max_new: int,
                    cache_len: Optional[int] = None,
                    eos_id: Optional[int] = None) -> np.ndarray:
    """Greedy ids (B, max_new): prefill, then `max_new` decode steps (the
    last step's logits unused, as the JAX scan); every id after a row's
    first `eos_id` is set to `eos_id`."""
    l0 = prompt_embeds.shape[1]
    logits, caches = model.prefill(prompt_embeds, cache_len or (l0 + max_new))
    return _eos_mask(_decode_loop(model, logits, caches, l0, max_new), eos_id)


@torch.inference_mode()
def greedy_generate_padded(model: CausalLM, prompt_embeds: torch.Tensor,
                           lengths, max_new: int,
                           eos_id: Optional[int] = None) -> np.ndarray:
    """Greedy ids (B, max_new) over a left-padded ragged batch (see
    `prefill_padded`): always `max_new` steps, no early stop."""
    l0 = prompt_embeds.shape[1]
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                              device=prompt_embeds.device)
    logits, caches = model.prefill_padded(prompt_embeds, lengths, l0 + max_new)
    start = (l0 - lengths).to(torch.int32)
    return _eos_mask(_decode_loop(model, logits, caches, l0, max_new, start), eos_id)
