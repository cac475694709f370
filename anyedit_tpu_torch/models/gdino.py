"""GroundingDINO, the open-vocabulary detector of the grounding stage
(counterpart of `anyedit_tpu/models/gdino.py`).

`GroundingDINO(cfg)(pixels, text_ids, text_mask)` -> (pred_logits (B, Q,
T), pred_boxes (B, Q, 4) normalized cxcywh). Submodules carry the names of
the official checkpoint (groundingdino_swin*.pth without its "module."
prefix) as `anyedit_tpu/weights/convert.py::_gdino_key` derives them:
bert.*, backbone.0.*, feat_map, input_proj.I.{0,1}, transformer.{level_embed,
enc_output, enc_output_norm, tgt_embed, enc_out_bbox_embed, encoder.*,
decoder.*}, bbox_embed.I. The text self-attention and the decoder's
self-attention and `ca_text` keep the fused `in_proj_weight` /
`in_proj_bias` of torch's nn.MultiheadAttention.

As in the JAX module: every attention is the plain `sdpa` (fp32 logits and
softmax), the bi-directional fusion runs at its own ffn_dim / 2 width with
heads / 2 heads, the text enhancer at heads / 2 and ffn_dim / 2, the four
input-projection GroupNorms (32 groups) go through `layers.GroupNorm` (K2 on
the card), the extra level is a stride-2 3x3 conv of the raw last backbone
map, query selection keeps the top `num_queries` tokens by their
best text similarity (ties to the lower index), and the phrase logits are
a plain dot product with no scale (the box thresholds assume it).
Activations mix bf16 and fp32 as JAX's type promotion leaves them.

One deliberate difference: the extra level's conv pads (1, 1), as the
official model and HF's `GroundingDinoForObjectDetection` do. The JAX
module's Flax `padding="SAME"` pads (0, 1) on an even map (the two agree on
an odd one, such as Swin-B's 25x25 last map at the 800 px bucket).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.grounding.maskgen import top_k
from anyedit_tpu_torch.models.bert import BERT_BASE, TINY_BERT, BertConfig, BertEncoder
from anyedit_tpu_torch.models.layers import GroupNorm, LayerNorm, Linear, SameConv2d
from anyedit_tpu_torch.models.swin import SWIN_B, TINY_SWIN, SwinConfig, SwinTransformer
from anyedit_tpu_torch.ops.attention import sdpa
from anyedit_tpu_torch.ops.deform_attn import ms_deform_attn


@dataclasses.dataclass(frozen=True)
class GDINOConfig:
    swin: SwinConfig = SWIN_B
    bert: BertConfig = BERT_BASE
    hidden: int = 256
    heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    num_queries: int = 900
    num_levels: int = 4
    num_points: int = 4
    max_text_len: int = 256
    ffn_dim: int = 2048
    # BERT special-token ids delimiting phrase segments ([CLS], [SEP], '.')
    special_ids: tuple[int, ...] = (101, 102, 1012)
    dtype: Any = torch.bfloat16


GDINO_SWINB = GDINOConfig()
TINY_GDINO = GDINOConfig(swin=TINY_SWIN, bert=TINY_BERT, hidden=32, heads=2,
                         enc_layers=1, dec_layers=1, num_queries=12,
                         num_levels=2, num_points=2, max_text_len=16,
                         ffn_dim=64)


def _inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def segment_text_masks(text_ids: torch.Tensor, text_mask: torch.Tensor,
                       special_ids: tuple[int, ...]):
    """Within-phrase self-attention mask + per-segment position ids
    (the reference's `generate_masks_with_special_tokens_and_transfer_map`):
    tokens attend to each other iff they share a phrase segment (the run of
    tokens between two delimiters, the closing '.' included); [CLS] and
    [SEP] attend only to themselves; positions restart at 0 per segment.

    Returns (self_attn_bias (B, 1, T, T) fp32 additive, position_ids (B, T))."""
    is_special = torch.zeros_like(text_ids, dtype=torch.bool)
    for sid in special_ids:
        is_special = is_special | (text_ids == sid)
    isolate_tok = (text_ids == special_ids[0]) | (text_ids == special_ids[1])
    spec = is_special.long()
    seg = torch.cumsum(spec, dim=1) - spec
    same_seg = seg[:, :, None] == seg[:, None, :]
    valid = text_mask[:, :, None] & text_mask[:, None, :]
    t = text_ids.shape[1]
    eye = torch.eye(t, dtype=torch.bool, device=text_ids.device)[None]
    isolate = isolate_tok[:, :, None] | isolate_tok[:, None, :]
    allowed = (same_seg & ~isolate & valid) | eye
    bias = torch.where(allowed, 0.0, -1e9)[:, None].float()
    idx = torch.arange(t, device=text_ids.device)[None, :].expand_as(text_ids)
    prev_special = torch.cummax(torch.where(is_special, idx, -1), dim=1).values
    prev_excl = F.pad(prev_special[:, :-1], (1, 0), value=-1)
    position_ids = torch.where(isolate_tok, 0, (idx - prev_excl - 1).clamp(min=0))
    return bias, position_ids


def _sdpa_heads(q, k, v, heads: int, bias=None):
    """(B, Lq, E), (B, Lk, E) x2 -> plain attention over `heads` heads -> (B, Lq, E)."""
    b, lq, e = q.shape

    def split(t):
        return t.reshape(b, t.shape[1], heads, -1).permute(0, 2, 1, 3)
    out = sdpa(split(q), split(k), split(v), bias=bias)
    return out.permute(0, 2, 1, 3).reshape(b, lq, e)


class FusedAttention(nn.Module):
    """torch nn.MultiheadAttention's parameters (fused `in_proj_weight` /
    `in_proj_bias`, `out_proj`), with q, k and v projected from their own
    inputs and the plain `sdpa` in between."""

    def __init__(self, dim: int, heads: int, dtype, device):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, dtype=dtype,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, dtype=dtype, device=device))
        self.out_proj = Linear(dim, dim, dtype=dtype, device=device)
        # the Flax Dense kernels: lecun normal (var 1 / fan_in), zero bias
        self.param_init = {"in_proj_weight": 1.0 / math.sqrt(dim)}

    def forward(self, q_in, k_in, v_in, bias=None):
        w, b = self.in_proj_weight, self.in_proj_bias
        q, k, v = (F.linear(x.to(w.dtype), wi, bi)
                   for x, wi, bi in zip((q_in, k_in, v_in), w.chunk(3), b.chunk(3)))
        return self.out_proj(_sdpa_heads(q, k, v, self.heads, bias))


class DeformAttn(nn.Module):
    """Learned sampling offsets / weights + `ms_deform_attn` (the official
    MSDeformAttn names)."""

    def __init__(self, c: GDINOConfig, device):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.c = c
        h, l, k = c.heads, c.num_levels, c.num_points
        self.value_proj = Linear(c.hidden, c.hidden, **kw)
        self.sampling_offsets = Linear(c.hidden, h * l * k * 2, **kw)
        self.attention_weights = Linear(c.hidden, h * l * k, **kw)
        self.output_proj = Linear(c.hidden, c.hidden, **kw)

    def forward(self, query, value, spatial_shapes, ref_points):
        """query (B, Q, C); value (B, S, C); ref_points (B, Q, L, 2 or 4) normalized."""
        c = self.c
        b, q, _ = query.shape
        h, l, k = c.heads, c.num_levels, c.num_points
        v = self.value_proj(value).reshape(b, value.shape[1], h, c.hidden // h)
        off = self.sampling_offsets(query).reshape(b, q, h, l, k, 2).float()
        w = torch.softmax(self.attention_weights(query).reshape(b, q, h, l * k).float(),
                          dim=-1).reshape(b, q, h, l, k)
        if ref_points.shape[-1] == 2:
            wh = torch.tensor([(ww, hh) for hh, ww in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            loc = ref_points[:, :, None, :, None, :] + off / wh[None, None, None, :, None, :]
        else:  # boxes: offsets scaled by half the box size
            ctr = ref_points[..., :2][:, :, None, :, None, :]
            size = ref_points[..., 2:][:, :, None, :, None, :]
            loc = ctr + off / k * size * 0.5
        return self.output_proj(ms_deform_attn(v, spatial_shapes, loc, w))


class BiAttention(nn.Module):
    """The fusion's projections (official BiMultiHeadAttention names)."""

    def __init__(self, c: GDINOConfig, device):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        e = c.ffn_dim // 2
        self.v_proj = Linear(c.hidden, e, **kw)          # image queries
        self.l_proj = Linear(c.hidden, e, **kw)          # text keys
        self.values_l_proj = Linear(c.hidden, e, **kw)
        self.values_v_proj = Linear(c.hidden, e, **kw)
        self.out_v_proj = Linear(e, c.hidden, **kw)
        self.out_l_proj = Linear(e, c.hidden, **kw)


class BiFusion(nn.Module):
    """Bidirectional image<->text attention with gamma gates, at its own
    inner width (ffn_dim / 2, heads / 2; SwinB: 1024 wide, 4 heads of 256).
    The residual stream is layer-normed first, as the reference rebinds it."""

    def __init__(self, c: GDINOConfig, device):
        super().__init__()
        self.heads = max(1, c.heads // 2)
        self.layer_norm_v = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.layer_norm_l = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.attn = BiAttention(c, device)
        self.gamma_v = nn.Parameter(torch.full((c.hidden,), 1e-4, device=device))
        self.gamma_l = nn.Parameter(torch.full((c.hidden,), 1e-4, device=device))
        self.param_init = {"gamma_v": ("const", 1e-4), "gamma_l": ("const", 1e-4)}

    def forward(self, img, txt, txt_bias):
        a = self.attn
        img_n, txt_n = self.layer_norm_v(img), self.layer_norm_l(txt)
        qi, kt = a.v_proj(img_n), a.l_proj(txt_n)
        vt, vi = a.values_l_proj(txt_n), a.values_v_proj(img_n)
        i2t = _sdpa_heads(qi, kt, vt, self.heads, txt_bias)   # image attends text
        t2i = _sdpa_heads(kt, qi, vi, self.heads)              # text attends image
        return (img_n + self.gamma_v * a.out_v_proj(i2t),
                txt_n + self.gamma_l * a.out_l_proj(t2i))


class _FFNLayer(nn.Module):
    """The official layers' `linear1` / `linear2` and the norms around them."""

    def __init__(self, c: GDINOConfig, device, ffn: int):
        super().__init__()
        kw = dict(dtype=c.dtype, device=device)
        self.linear1 = Linear(c.hidden, ffn, **kw)
        self.linear2 = Linear(ffn, c.hidden, **kw)

    def ffn(self, x, norm):
        return norm(x + self.linear2(F.relu(self.linear1(x))))


class TextEnhancerLayer(_FFNLayer):
    """Text self-attention, post-norm, at heads / 2 and ffn_dim / 2; q and k
    carry the sine embedding of the per-segment position ids."""

    def __init__(self, c: GDINOConfig, device):
        super().__init__(c, device, max(1, c.ffn_dim // 2))
        self.self_attn = FusedAttention(c.hidden, max(1, c.heads // 2), c.dtype, device)
        self.norm1 = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.norm2 = LayerNorm(c.hidden, dtype=c.dtype, device=device)

    def forward(self, txt, txt_bias, txt_pos):
        qk = txt + txt_pos.to(txt.dtype)
        txt = self.norm1(txt + self.self_attn(qk, qk, txt, txt_bias))
        return self.ffn(txt, self.norm2)


class DeformEncoderLayer(_FFNLayer):
    """Vision deformable self-attention, post-norm (deformable DETR)."""

    def __init__(self, c: GDINOConfig, device):
        super().__init__(c, device, c.ffn_dim)
        self.self_attn = DeformAttn(c, device)
        self.norm1 = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.norm2 = LayerNorm(c.hidden, dtype=c.dtype, device=device)

    def forward(self, img, pos, spatial_shapes, ref_points):
        img = self.norm1(img + self.self_attn(img + pos, img, spatial_shapes, ref_points))
        return self.ffn(img, self.norm2)


class DecoderLayer(_FFNLayer):
    """Query self-attention -> norm2, text cross-attention -> catext_norm,
    deformable image cross-attention -> norm1, ffn -> norm3 (all post-norm)."""

    def __init__(self, c: GDINOConfig, device):
        super().__init__(c, device, c.ffn_dim)
        self.c = c
        self.self_attn = FusedAttention(c.hidden, c.heads, c.dtype, device)
        self.ca_text = FusedAttention(c.hidden, c.heads, c.dtype, device)
        self.cross_attn = DeformAttn(c, device)
        for name in ("norm1", "norm2", "catext_norm", "norm3"):
            self.add_module(name, LayerNorm(c.hidden, dtype=c.dtype, device=device))

    def forward(self, tgt, img, txt, spatial_shapes, ref_boxes, q_pos, txt_kpm_bias):
        qk = tgt + q_pos
        tgt = self.norm2(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.catext_norm(tgt + self.ca_text(tgt + q_pos, txt, txt, txt_kpm_bias))
        b, q = tgt.shape[:2]
        ref = ref_boxes[:, :, None, :].expand(b, q, self.c.num_levels, 4)
        tgt = self.norm1(tgt + self.cross_attn(tgt + q_pos, img, spatial_shapes, ref))
        return self.ffn(tgt, self.norm3)


class MLP(nn.Module):
    """The official `MLP` (`layers.J`, ReLU between)."""

    def __init__(self, dims: list[int], dtypes: list, device):
        super().__init__()
        self.layers = nn.ModuleList([Linear(a, b, dtype=dt, device=device)
                                     for a, b, dt in zip(dims[:-1], dims[1:], dtypes)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _box_head(c: GDINOConfig, device) -> MLP:
    """hidden -> hidden -> hidden -> 4, the last layer in fp32."""
    return MLP([c.hidden] * 3 + [4], [c.dtype, c.dtype, torch.float32], device)


def _dim_t(n: int, temp: float, device) -> torch.Tensor:
    """The sine embeddings' per-feature divisor temp ** (2 * (i // 2) / n)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return temp ** (2 * torch.div(i, 2, rounding_mode="floor") / n)


def sine_pos_1d(vals: torch.Tensor, num_feats: int, temp: float = 10000.0) -> torch.Tensor:
    """get_sine_pos_embed of a scalar per position: vals (...) ->
    (..., num_feats), interleaved sin/cos, scale 2 pi."""
    p = vals.float()[..., None] * (2 * math.pi) / _dim_t(num_feats, temp, vals.device)
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(*vals.shape, num_feats)


def _sine_hw(vals: torch.Tensor, half: int, temp: float) -> torch.Tensor:
    """vals (L,) in radians -> (L, half) interleaved sin/cos."""
    p = vals[:, None] / _dim_t(half, temp, vals.device)
    return torch.stack([torch.sin(p[:, 0::2]), torch.cos(p[:, 1::2])],
                       dim=-1).reshape(-1, half)


@functools.lru_cache(maxsize=16)
def _level_geometry(hidden: int, spatial_shapes: tuple, device: torch.device):
    """Per token of the flattened multi-level map: the sine position
    without the level embed (S, hidden), the reference point (S, 2) and the
    level index (S,). PositionEmbeddingSineHW: temperature 20, (idx + 1) /
    extent * 2 pi, interleaved sin/cos, [pos_y | pos_x]."""
    pos, ref, lvl = [], [], []
    half = hidden // 2
    for li, (hh, ww) in enumerate(spatial_shapes):
        ys = (torch.arange(hh, dtype=torch.float32, device=device) + 0.5) / hh
        xs = (torch.arange(ww, dtype=torch.float32, device=device) + 0.5) / ww
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        ref.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        ny = (torch.arange(hh, dtype=torch.float32, device=device) + 1.0) / hh * 2 * math.pi
        nx = (torch.arange(ww, dtype=torch.float32, device=device) + 1.0) / ww * 2 * math.pi
        ey, ex = _sine_hw(ny, half, 20.0), _sine_hw(nx, half, 20.0)
        pos.append(torch.cat([ey.repeat_interleave(ww, dim=0), ex.repeat(hh, 1)], dim=-1))
        lvl.append(torch.full((hh * ww,), li, dtype=torch.long, device=device))
    return torch.cat(pos), torch.cat(ref), torch.cat(lvl)


def _box_query_sine(hidden: int, ref_boxes: torch.Tensor) -> torch.Tensor:
    """Query position input from the reference boxes: interleaved sin/cos
    per coord, coords ordered (y, x, w, h). (B, nq, 2 * hidden)."""
    b, nq = ref_boxes.shape[:2]
    coords = ref_boxes[..., [1, 0, 2, 3]]
    p = coords[..., None] * 2 * math.pi / _dim_t(hidden // 2, 10000.0, ref_boxes.device)
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(b, nq, 2 * hidden)


class _Encoder(nn.Module):
    def __init__(self, c: GDINOConfig, device):
        super().__init__()
        n = c.enc_layers
        self.fusion_layers = nn.ModuleList([BiFusion(c, device) for _ in range(n)])
        self.text_layers = nn.ModuleList([TextEnhancerLayer(c, device) for _ in range(n)])
        self.layers = nn.ModuleList([DeformEncoderLayer(c, device) for _ in range(n)])


class _Decoder(nn.Module):
    def __init__(self, c: GDINOConfig, device):
        super().__init__()
        self.layers = nn.ModuleList([DecoderLayer(c, device) for _ in range(c.dec_layers)])
        self.norm = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.ref_point_head = MLP([2 * c.hidden, c.hidden, c.hidden], [c.dtype] * 2, device)


class _Transformer(nn.Module):
    def __init__(self, c: GDINOConfig, device):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(c.num_levels, c.hidden, device=device))
        self.encoder = _Encoder(c, device)
        self.enc_output = Linear(c.hidden, c.hidden, dtype=c.dtype, device=device)
        self.enc_output_norm = LayerNorm(c.hidden, dtype=c.dtype, device=device)
        self.enc_out_bbox_embed = _box_head(c, device)
        self.tgt_embed = nn.Embedding(c.num_queries, c.hidden, device=device)
        self.tgt_embed.param_init = {"weight": 1.0}
        self.decoder = _Decoder(c, device)
        self.param_init = {"level_embed": 1.0}


class _ExtraLevelConv(nn.Conv2d):
    """nn.Conv2d with the input cast to the weight's dtype (NCHW)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GDINOConfig = GDINO_SWINB, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.bert = BertEncoder(c.bert, device)
        self.backbone = nn.ModuleList([SwinTransformer(c.swin, device)])
        self.feat_map = Linear(c.bert.hidden, c.hidden, dtype=c.dtype, device=device)
        groups = min(32, c.hidden)
        dims = [c.swin.embed_dim * 2 ** i for i in c.swin.out_indices]
        # each level: `0` the conv, `1` the GroupNorm
        projs = [nn.Sequential(SameConv2d(d, c.hidden, 1, dtype=c.dtype, device=device),
                               GroupNorm(c.hidden, groups, device=device)) for d in dims]
        for _ in range(c.num_levels - len(dims)):
            d_in = dims[-1] if len(projs) == len(dims) else c.hidden
            projs.append(nn.Sequential(
                _ExtraLevelConv(d_in, c.hidden, 3, stride=2, padding=1, dtype=c.dtype,
                                device=device),
                GroupNorm(c.hidden, groups, device=device)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = _Transformer(c, device)
        self.bbox_embed = nn.ModuleList([_box_head(c, device) for _ in range(c.dec_layers)])

    def text(self, text_ids, text_mask):
        """-> (txt (B, T, C), seg_bias, kpm_bias, txt_pos)."""
        c = self.cfg
        kpm_bias = torch.where(text_mask, 0.0, -1e9)[:, None, None, :].float()
        seg_bias, position_ids = segment_text_masks(text_ids, text_mask, c.special_ids)
        txt = self.bert(text_ids, seg_bias, position_ids=position_ids)
        return self.feat_map(txt), seg_bias, kpm_bias, sine_pos_1d(position_ids, c.hidden)

    def vision(self, pixels):
        """pixels (B, H, W, 3) -> the projected levels, NCHW."""
        c = self.cfg
        feats = self.backbone[0](pixels)
        maps = [feats[k].permute(0, 3, 1, 2) for k in sorted(feats)]
        proj = [p(m.contiguous()) for p, m in zip(self.input_proj, maps)]
        src = maps[-1]
        while len(proj) < c.num_levels:
            src = self.input_proj[len(proj)](src.contiguous())
            proj.append(src)
        return proj

    def forward(self, pixels, text_ids, text_mask):
        """pixels (B, H, W, 3) ImageNet-normalized; text_ids (B, T) int;
        text_mask (B, T) bool (True = real token)."""
        c = self.cfg
        tr = self.transformer
        txt, seg_bias, kpm_bias, txt_pos = self.text(text_ids, text_mask)
        proj = self.vision(pixels)
        spatial_shapes = tuple((int(m.shape[2]), int(m.shape[3])) for m in proj)
        b = proj[0].shape[0]
        img = torch.cat([m.flatten(2).transpose(1, 2) for m in proj], dim=1)  # (B, S, C)
        s = img.shape[1]
        pos_base, ref2d, tok_level = _level_geometry(c.hidden, spatial_shapes, img.device)
        pos = (pos_base + tr.level_embed[tok_level])[None].expand(b, s, c.hidden).to(c.dtype)
        ref_pts = ref2d[None, :, None, :].expand(b, s, c.num_levels, 2)

        enc = tr.encoder
        for fusion, text_layer, layer in zip(enc.fusion_layers, enc.text_layers, enc.layers):
            img, txt = fusion(img, txt, kpm_bias)
            txt = text_layer(txt, seg_bias, txt_pos)
            img = layer(img, pos, spatial_shapes, ref_pts)

        # language-guided query selection
        out_mem = tr.enc_output_norm(tr.enc_output(img))
        sim = torch.einsum("bsc,btc->bst", out_mem.float(), txt.float())
        sim = torch.where(text_mask[:, None, :], sim, -1e9)
        nq = min(c.num_queries, s)
        _, top_idx = top_k(sim.amax(dim=-1), nq)                           # (B, nq)
        anchors = torch.gather(ref2d[None].expand(b, s, 2), 1,
                               top_idx[..., None].expand(b, nq, 2))
        wh_sel = (0.05 * 2.0 ** tok_level.float())[top_idx][..., None]    # (B, nq, 1)
        prop_boxes = torch.cat([anchors, wh_sel, wh_sel], dim=-1)          # cxcywh
        sel_mem = torch.gather(out_mem, 1, top_idx[..., None].expand(b, nq, c.hidden))
        delta = tr.enc_out_bbox_embed(sel_mem)
        ref_boxes = torch.sigmoid(_inverse_sigmoid(prop_boxes) + delta)
        tgt = tr.tgt_embed.weight[None, :nq].expand(b, nq, c.hidden).to(c.dtype)

        # decoder with iterative box refinement
        dec = tr.decoder
        for layer, head in zip(dec.layers, self.bbox_embed):
            q_pos = dec.ref_point_head(_box_query_sine(c.hidden, ref_boxes).to(c.dtype))
            tgt = layer(tgt, img, txt, spatial_shapes, ref_boxes, q_pos, kpm_bias)
            ref_boxes = torch.sigmoid(_inverse_sigmoid(ref_boxes) + head(tgt))
        tgt = dec.norm(tgt)

        # contrastive phrase logits: plain dot product, no scale, no bias
        logits = torch.einsum("bqc,btc->bqt", tgt.float(), txt.float())
        return torch.where(text_mask[:, None, :], logits, -1e9), ref_boxes
