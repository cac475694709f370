"""CLIP text and vision towers (counterpart of `anyedit_tpu/models/clip.py`).

Submodules carry the HF names: `CLIPTextModel` (text_model.embeddings,
text_model.encoder.layers.N.self_attn.q_proj, ..., text_model.final_layer_norm;
text_projection), `CLIPVisionModelWithProjection` for the CLIP vision
towers (vision_model.embeddings.patch_embedding, vision_model.pre_layrnorm,
..., visual_projection) and `Blip2VisionModel` for BLIP-2's EVA tower
(vision_model.encoder.layers.N.self_attn.qkv / .projection, a patch-conv
bias, the class and position embeddings as plain parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.models.layers import LayerNorm, MultiHeadAttention, default_processor
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
    # > 0: the checkpoint is a CLIPTextModelWithProjection, and `pooled` gets
    # a bias-free fp32 `text_projection` to this width (SDXL's second tower,
    # both SD3 towers)
    text_proj: int = 0


CLIP_L_TEXT = CLIPTextConfig()                                     # SD1.5 / ViT-L
# OpenCLIP bigG: SDXL's second tower and SD3's CLIP-G (exact GELU, projected
# pooled output)
CLIP_BIGG_TEXT = CLIPTextConfig(hidden=1280, layers=32, heads=20, activation="gelu",
                                text_proj=1280)
TINY_TEXT = CLIPTextConfig(vocab_size=256, hidden=32, layers=2, heads=2, max_len=16)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch: int = 14
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    proj_dim: int = 768
    mlp_dim: int = 0          # 0 -> 4 * hidden; EVA-g uses 6144
    # CLIP towers have a pre-LN after the embeddings and a projection head;
    # the BLIP-2 EVA tower (Blip2VisionModel) has neither: its post-LN
    # normalizes the WHOLE token sequence, and the patch conv has a bias.
    pre_ln: bool = True
    use_proj: bool = True
    patch_bias: bool = False
    dtype: Any = torch.bfloat16
    activation: str = "quick_gelu"


CLIP_L_VISION = CLIPVisionConfig()
# EVA ViT-g/14, BLIP-2's frozen image encoder (blip2-flan-t5-xl): width
# 1408, 39 layers, a 6144-wide exact-GELU MLP
EVA_VIT_G = CLIPVisionConfig(image_size=224, patch=14, hidden=1408, layers=39,
                             heads=16, proj_dim=1024, mlp_dim=6144,
                             activation="gelu", pre_ln=False, use_proj=False,
                             patch_bias=True)
TINY_VISION = CLIPVisionConfig(image_size=32, patch=8, hidden=32, layers=2,
                               heads=2, proj_dim=16)


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


class EVAAttention(MultiHeadAttention):
    """Self-attention under the HF Blip2Attention names: one fused `qkv`
    projection (q, k, v stacked along its rows) and `projection`."""

    def _build(self, query_dim, kv_dim, inner, out_dim, qkv_bias, kw):
        self.qkv = nn.Linear(query_dim, 3 * inner, bias=qkv_bias, **kw)
        self.projection = nn.Linear(inner, out_dim, **kw)

    def forward(self, x, context=None, processor=None, extra=None):
        h, d = self.meta.num_heads, self.meta.head_dim
        b, l = x.shape[:2]
        q, k, v = self.qkv(x).reshape(b, l, 3, h, d).permute(2, 0, 3, 1, 4)
        out = (processor or default_processor)(q, k, v, self.meta, extra)
        return self.projection(out.permute(0, 2, 1, 3).reshape(b, l, h * d))


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
                 mlp_dim: int = 0, device=None, fused_qkv: bool = False):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, dtype=dtype, device=device)
        attn = EVAAttention if fused_qkv else CLIPAttention
        self.self_attn = attn(hidden, heads, hidden // heads, hidden, tag, True,
                              qkv_bias=True, dtype=dtype, device=device)
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
    """ids (B, L) -> (last_hidden (B, L, H), pooled (B, H or text_proj),
    penult (B, L, H)), all fp32. `pooled` is the hidden state at the first
    argmax id (the EOT token, CLIP convention), through `text_projection`
    when `cfg.text_proj` is set (HF CLIPTextModelWithProjection's
    `text_embeds`); `penult` is the input of the last layer, without the
    final LayerNorm (the clip_skip hidden states SDXL and SD3 condition on)."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT, device=None):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg, device)
        if cfg.text_proj:
            self.text_projection = nn.Linear(cfg.hidden, cfg.text_proj, bias=False,
                                             device=device)

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
        if c.text_proj:
            pooled = self.text_projection(pooled)
        return x.float(), pooled, penult.float()


class CLIPTextModel(CLIPTextEncoder):
    """The text tower and its bias-free fp32 `text_projection` to
    `proj_dim`, L2-normed: ids (B, L) -> (B, proj_dim), for similarity
    scoring."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT, proj_dim: int = 768,
                 device=None):
        super().__init__(cfg, device)
        self.text_projection = nn.Linear(cfg.hidden, proj_dim, bias=False,
                                         device=device)

    def forward(self, ids: torch.Tensor):
        _, pooled, _ = super().forward(ids)
        z = self.text_projection(pooled)
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


class _VisionEmbeddings(nn.Module):
    """The CLIP layout holds the class embedding as (H,) and the position
    table as an `nn.Embedding`; the BLIP-2 layout (no pre-LN) holds both
    as plain parameters of shape (1, 1, H) and (1, N + 1, H)."""

    def __init__(self, c: CLIPVisionConfig, device):
        super().__init__()
        n = (c.image_size // c.patch) ** 2
        self.patch_embedding = nn.Conv2d(3, c.hidden, c.patch, stride=c.patch,
                                         bias=c.patch_bias, dtype=c.dtype, device=device)
        if c.pre_ln:
            self.class_embedding = nn.Parameter(torch.zeros(c.hidden, device=device))
            self.position_embedding = nn.Embedding(n + 1, c.hidden, device=device)
            self.param_init = {"class_embedding": 0.02}
        else:
            self.class_embedding = nn.Parameter(torch.zeros(1, 1, c.hidden, device=device))
            self.position_embedding = nn.Parameter(
                torch.zeros(1, n + 1, c.hidden, device=device))
            self.param_init = {"class_embedding": 0.02, "position_embedding": 0.01}

    def positions(self) -> torch.Tensor:
        p = self.position_embedding
        return p.weight if isinstance(p, nn.Embedding) else p[0]


class _VisionModel(nn.Module):
    def __init__(self, c: CLIPVisionConfig, device):
        super().__init__()
        self.embeddings = _VisionEmbeddings(c, device)
        if c.pre_ln:
            # (sic) HF's historical spelling of the parameter name
            self.pre_layrnorm = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            CLIPBlock(c.hidden, c.heads, c.dtype, c.activation, f"vis.{i}",
                      mlp_dim=c.mlp_dim, device=device, fused_qkv=not c.pre_ln)
            for i in range(c.layers)])
        self.post_layernorm = LayerNorm(c.hidden, dtype=c.dtype, device=device)


class CLIPVisionEncoder(nn.Module):
    """pixels (B, S, S, 3), normalized -> (tokens (B, N + 1, H) fp32, and
    with `use_proj` the projected class token L2-normed (B, proj_dim) fp32,
    else the post-LN class token (B, H) fp32)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_L_VISION, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg, device)
        if cfg.use_proj:
            self.visual_projection = nn.Linear(cfg.hidden, cfg.proj_dim, bias=False,
                                               device=device)

    def forward(self, pixels: torch.Tensor):
        c = self.cfg
        vm = self.vision_model
        emb = vm.embeddings
        b = pixels.shape[0]
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(c.dtype))
        x = x.flatten(2).transpose(1, 2)                     # (B, N, H)
        cls = emb.class_embedding.reshape(1, 1, c.hidden).to(c.dtype)
        x = torch.cat([cls.expand(b, 1, c.hidden), x], dim=1)
        x = x + emb.positions()[None].to(c.dtype)
        if c.pre_ln:
            x = vm.pre_layrnorm(x)
        for block in vm.encoder.layers:
            x = block(x)
        if c.pre_ln:
            pooled = vm.post_layernorm(x[:, 0])
        else:
            # BLIP-2/EVA: these post-LN tokens feed the Q-Former
            x = vm.post_layernorm(x)
            pooled = x[:, 0]
        if not c.use_proj:
            return x.float(), pooled.float()
        z = self.visual_projection(pooled.float())
        return x.float(), z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
