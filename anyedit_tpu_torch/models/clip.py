"""CLIP text tower (counterpart of the text half of `anyedit_tpu/models/clip.py`).

Submodules carry the HF `CLIPTextModel` names (text_model.embeddings,
text_model.encoder.layers.N.self_attn.q_proj, ..., text_model.final_layer_norm).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm, MultiHeadAttention
from anyedit_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 77
    dtype: Any = torch.bfloat16
    # "quick_gelu" for OpenAI CLIP (the SD1.x text encoder), "gelu" for OpenCLIP
    activation: str = "quick_gelu"


CLIP_L_TEXT = CLIPTextConfig()                                     # SD1.5 / ViT-L
TINY_TEXT = CLIPTextConfig(vocab_size=256, hidden=32, layers=2, heads=2, max_len=16)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: F.gelu(x)   # HF "gelu" is the exact erf form


class CLIPAttention(MultiHeadAttention):
    """MultiHeadAttention under the HF CLIP names (q_proj, ..., out_proj)."""

    def _build(self, query_dim, kv_dim, inner, out_dim, qkv_bias, kw):
        self.q_proj = nn.Linear(query_dim, inner, bias=qkv_bias, **kw)
        self.k_proj = nn.Linear(kv_dim, inner, bias=qkv_bias, **kw)
        self.v_proj = nn.Linear(kv_dim, inner, bias=qkv_bias, **kw)
        self.out_proj = nn.Linear(inner, out_dim, **kw)

    def projections(self):
        return self.q_proj, self.k_proj, self.v_proj, self.out_proj


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, activation: str, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(mlp_dim, hidden, dtype=dtype, device=device)
        self.act = _act(activation)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype, activation: str, tag: str,
                 mlp_dim: int = 0, device=None):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, dtype=dtype, device=device)
        self.self_attn = CLIPAttention(hidden, heads, hidden // heads, hidden, tag,
                                       True, qkv_bias=True, dtype=dtype,
                                       device=device)
        self.layer_norm2 = LayerNorm(hidden, dtype=dtype, device=device)
        self.mlp = CLIPMLP(hidden, mlp_dim or hidden * 4, activation, dtype, device)

    def forward(self, x, mask_bias=None):
        proc = None
        if mask_bias is not None:
            def proc(q, k, v, meta, extra):
                return sdpa(q, k, v, bias=mask_bias)
        x = x + self.self_attn(self.layer_norm1(x), None, proc, None)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig, device):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden, dtype=c.dtype,
                                            device=device)
        # fp32, cast to the compute dtype at use (as the JAX `pos_emb` param)
        self.position_embedding = nn.Embedding(c.max_len, c.hidden, device=device)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPTextConfig, device):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPBlock(c.hidden, c.heads, c.dtype, c.activation, f"text.{i}",
                      device=device)
            for i in range(c.layers)])


class _TextModel(nn.Module):
    def __init__(self, c: CLIPTextConfig, device):
        super().__init__()
        self.embeddings = _Embeddings(c, device)
        self.encoder = _Encoder(c, device)
        self.final_layer_norm = LayerNorm(c.hidden, dtype=c.dtype, device=device)


class CLIPTextEncoder(nn.Module):
    """ids (B, L) -> (last_hidden (B, L, H), pooled (B, H), penult
    (B, L, H)), all fp32. `pooled` is the hidden state at the first
    argmax id (the EOT token, CLIP convention); `penult` is the input of the
    last layer, without the final LayerNorm."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT, device=None):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg, device)

    def forward(self, ids: torch.Tensor):
        c = self.cfg
        tm = self.text_model
        b, l = ids.shape
        pos = tm.embeddings.position_embedding.weight[:l].to(c.dtype)
        x = tm.embeddings.token_embedding(ids) + pos[None]
        causal = torch.triu(torch.full((l, l), float("-inf"), device=ids.device),
                            diagonal=1)[None, None]
        penult = x
        for i, block in enumerate(tm.encoder.layers):
            if i == c.layers - 1:
                penult = x
            x = block(x, causal)
        x = tm.final_layer_norm(x)
        eos = ids.argmax(dim=-1)
        pooled = x[torch.arange(b, device=ids.device), eos].float()
        return x.float(), pooled, penult.float()
