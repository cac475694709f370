"""Plain PyTorch reference networks: the SD1.5-style conditional UNet, the
SD AutoencoderKL and the CLIP text tower, written from their published
descriptions (diffusers `UNet2DConditionModel` / `AutoencoderKL`, HF
`CLIPTextModel`).

They import nothing of the program. Parameter names follow the diffusers /
HF checkpoint keys, which the program's modules also carry, so that one
state dict made by `harness/weights.py` loads into both. Each module is
built with the dtype its weights are served in (matrices in the served
dtype, norm parameters and a few embeddings in fp32), so that the weights
are drawn in that dtype; `.float()` afterwards computes in fp32 on the same
values.

Departures from the published models, each shared with the program under
test (the reference follows the computation the benchmark asks for):
  * GEGLU uses the tanh form of GELU (diffusers uses the erf form);
  * every GroupNorm has eps 1e-5 (diffusers' VAE uses 1e-6);
  * no dropout anywhere (inference).
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn


# ---- plain ops ---------------------------------------------------------------

class Norm(nn.Module):
    """GroupNorm (groups > 0, NCHW) or LayerNorm (groups == 0, last dim),
    fp32 parameters, optional SiLU after it."""

    norm_params = True

    def __init__(self, channels: int, groups: int = 0, eps: float = 1e-5,
                 silu: bool = False, device=None):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        if self.groups:
            y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        else:
            y = F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        return F.silu(y) if self.silu else y


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (B, H, L, D), fp32 logits."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def causal_attention(q, k, v):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    n = s.shape[-1]
    mask = torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1)
    return torch.matmul(torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1), v)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding, cos first (diffusers flip_sin_to_cos=True, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device,
                                                        dtype=torch.float32) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def _conv(cin, cout, k=3, stride=1, padding=1, dtype=None, device=None, bias=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias,
                     dtype=dtype, device=device)


def _lin(cin, cout, bias=True, dtype=None, device=None):
    return nn.Linear(cin, cout, bias=bias, dtype=dtype, device=device)


class _Holder(nn.Module):
    """A named container (diffusers' down / mid / up block, sampler)."""

    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, v)


class Attn(nn.Module):
    """Multi-head attention, diffusers names (to_q, to_k, to_v, to_out.0)."""

    def __init__(self, dim, heads, ctx_dim=None, dtype=None, device=None, qkv_bias=False):
        super().__init__()
        kv = ctx_dim or dim
        self.heads = heads
        self.to_q = _lin(dim, dim, qkv_bias, dtype, device)
        self.to_k = _lin(kv, dim, qkv_bias, dtype, device)
        self.to_v = _lin(kv, dim, qkv_bias, dtype, device)
        self.to_out = nn.ModuleList([_lin(dim, dim, True, dtype, device)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, lq, c = x.shape
        h = self.heads

        def split(t):
            return t.reshape(b, t.shape[1], h, c // h).transpose(1, 2)
        o = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)))
        return self.to_out[0](o.transpose(1, 2).reshape(b, lq, c))


# ---- UNet --------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, cin, cout, temb, groups, dtype, device):
        super().__init__()
        self.norm1 = Norm(cin, groups, silu=True, device=device)
        self.conv1 = _conv(cin, cout, dtype=dtype, device=device)
        self.time_emb_proj = _lin(temb, cout, True, dtype, device)
        self.norm2 = Norm(cout, groups, silu=True, device=device)
        self.conv2 = _conv(cout, cout, dtype=dtype, device=device)
        self.conv_shortcut = (_conv(cin, cout, 1, padding=0, dtype=dtype, device=device)
                              if cin != cout else None)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h + self.time_emb_proj(F.silu(temb))[:, :, None, None]))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class GEGLU(nn.Module):
    def __init__(self, dim, dtype, device):
        super().__init__()
        self.proj = _lin(dim, 8 * dim, True, dtype, device)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")


class TransformerBlock(nn.Module):
    def __init__(self, c, heads, ctx_dim, dtype, device):
        super().__init__()
        self.norm1 = Norm(c, device=device)
        self.attn1 = Attn(c, heads, dtype=dtype, device=device)
        self.norm2 = Norm(c, device=device)
        self.attn2 = Attn(c, heads, ctx_dim, dtype=dtype, device=device)
        self.norm3 = Norm(c, device=device)
        self.ff = _Holder(net=nn.ModuleList([GEGLU(c, dtype, device), nn.Identity(),
                                             _lin(4 * c, c, True, dtype, device)]))

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        h = self.norm3(x)
        for layer in self.ff.net:
            h = layer(h)
        return x + h


class SpatialTransformer(nn.Module):
    def __init__(self, c, heads, depth, ctx_dim, groups, dtype, device):
        super().__init__()
        self.norm = Norm(c, groups, device=device)
        self.proj_in = _conv(c, c, 1, padding=0, dtype=dtype, device=device)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(c, heads, ctx_dim, dtype, device) for _ in range(depth)])
        self.proj_out = _conv(c, c, 1, padding=0, dtype=dtype, device=device)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for blk in self.transformer_blocks:
            h = blk(h, ctx)
        return self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)) + x


class UNet(nn.Module):
    """(latents NHWC, t (B,), context (B, L, D)) -> eps NHWC.

    cfg: in_channels, out_channels, block_channels, layers_per_block,
    attn_levels, transformer_depth, num_heads (0: channels //
    num_head_channels), num_head_channels, context_dim, time_embed_mult,
    num_groups (the keys of `configs/*.json`'s "unet")."""

    def __init__(self, cfg: dict, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = c = cfg
        chans = list(c["block_channels"])
        g, lpb, ctx = c["num_groups"], c["layers_per_block"], c["context_dim"]
        temb = chans[0] * c["time_embed_mult"]
        heads = (lambda ch: c["num_heads"] or max(1, ch // c["num_head_channels"]))
        kw = dict(dtype=dtype, device=device)
        self.time_embedding = _Holder(linear_1=_lin(chans[0], temb, True, **kw),
                                      linear_2=_lin(temb, temb, True, **kw))
        self.conv_in = _conv(c["in_channels"], chans[0], **kw)
        cur, skips, down = chans[0], [chans[0]], []
        for lvl, ch in enumerate(chans):
            res, att = [], []
            for _ in range(lpb):
                res.append(ResBlock(cur, ch, temb, g, **kw))
                cur = ch
                if c["attn_levels"][lvl]:
                    att.append(SpatialTransformer(ch, heads(ch), c["transformer_depth"],
                                                  ctx, g, **kw))
                skips.append(ch)
            samp = []
            if lvl != len(chans) - 1:
                samp.append(_Holder(conv=_conv(ch, ch, stride=2, **kw)))
                skips.append(ch)
            down.append(_Holder(resnets=nn.ModuleList(res), attentions=nn.ModuleList(att),
                                downsamplers=nn.ModuleList(samp)))
        self.down_blocks = nn.ModuleList(down)
        mid = chans[-1]
        self.mid_block = _Holder(
            resnets=nn.ModuleList([ResBlock(mid, mid, temb, g, **kw) for _ in range(2)]),
            attentions=nn.ModuleList([SpatialTransformer(mid, heads(mid),
                                                         c["transformer_depth"], ctx, g,
                                                         **kw)]))
        up = []
        for lvl in reversed(range(len(chans))):
            ch = chans[lvl]
            res, att = [], []
            for _ in range(lpb + 1):
                res.append(ResBlock(cur + skips.pop(), ch, temb, g, **kw))
                cur = ch
                if c["attn_levels"][lvl]:
                    att.append(SpatialTransformer(ch, heads(ch), c["transformer_depth"],
                                                  ctx, g, **kw))
            samp = [_Holder(conv=_conv(ch, ch, **kw))] if lvl else []
            up.append(_Holder(resnets=nn.ModuleList(res), attentions=nn.ModuleList(att),
                              upsamplers=nn.ModuleList(samp)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = Norm(chans[0], g, silu=True, device=device)
        self.conv_out = _conv(chans[0], c["out_channels"], **kw)

    def forward(self, x, t, ctx):
        c = self.cfg
        chans = c["block_channels"]
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(timestep_embedding(t, chans[0]))))
        h = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [h]
        for lvl, blk in enumerate(self.down_blocks):
            for i, r in enumerate(blk.resnets):
                h = r(h, temb)
                if c["attn_levels"][lvl]:
                    h = blk.attentions[i](h, ctx)
                skips.append(h)
            for s in blk.downsamplers:
                h = s.conv(h)
                skips.append(h)
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h, temb), ctx), temb)
        for j, blk in enumerate(self.up_blocks):
            lvl = len(chans) - 1 - j
            for i, r in enumerate(blk.resnets):
                h = r(torch.cat([h, skips.pop()], dim=1), temb)
                if c["attn_levels"][lvl]:
                    h = blk.attentions[i](h, ctx)
            for s in blk.upsamplers:
                h = s.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(h)).permute(0, 2, 3, 1)


# ---- VAE ---------------------------------------------------------------------

class VAEResBlock(nn.Module):
    def __init__(self, cin, cout, groups, dtype, device):
        super().__init__()
        self.norm1 = Norm(cin, groups, silu=True, device=device)
        self.conv1 = _conv(cin, cout, dtype=dtype, device=device)
        self.norm2 = Norm(cout, groups, silu=True, device=device)
        self.conv2 = _conv(cout, cout, dtype=dtype, device=device)
        self.conv_shortcut = (_conv(cin, cout, 1, padding=0, dtype=dtype, device=device)
                              if cin != cout else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEMidAttention(nn.Module):
    """Single-head self-attention over the pixels (head dim = channels)."""

    def __init__(self, c, groups, dtype, device):
        super().__init__()
        self.group_norm = Norm(c, groups, device=device)
        self.to_q = _lin(c, c, True, dtype, device)
        self.to_k = _lin(c, c, True, dtype, device)
        self.to_v = _lin(c, c, True, dtype, device)
        self.to_out = nn.ModuleList([_lin(c, c, True, dtype, device)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        o = attention(self.to_q(t)[:, None], self.to_k(t)[:, None], self.to_v(t)[:, None])
        return x + self.to_out[0](o[:, 0]).reshape(b, h, w, c).permute(0, 3, 1, 2)


def _vae_mid(c, g, dtype, device):
    return _Holder(resnets=nn.ModuleList([VAEResBlock(c, c, g, dtype, device)
                                          for _ in range(2)]),
                   attentions=nn.ModuleList([VAEMidAttention(c, g, dtype, device)]))


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class VAE(nn.Module):
    """encode(x NHWC in [-1, 1]) -> (mean, logvar) NHWC; decode(z) -> NHWC.

    cfg: in_channels, latent_channels, block_channels, layers_per_block,
    num_groups, scaling_factor."""

    def __init__(self, cfg: dict, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = c = cfg
        chans, g, lpb = list(c["block_channels"]), c["num_groups"], c["layers_per_block"]
        lc = c["latent_channels"]
        kw = dict(dtype=dtype, device=device)
        enc = _Holder(conv_in=_conv(c["in_channels"], chans[0], **kw))
        cur, blocks = chans[0], []
        for lvl, ch in enumerate(chans):
            res = []
            for _ in range(lpb):
                res.append(VAEResBlock(cur, ch, g, **kw))
                cur = ch
            samp = ([_Holder(conv=_conv(ch, ch, stride=2, padding=0, **kw))]
                    if lvl != len(chans) - 1 else [])
            blocks.append(_Holder(resnets=nn.ModuleList(res), downsamplers=nn.ModuleList(samp)))
        enc.down_blocks = nn.ModuleList(blocks)
        enc.mid_block = _vae_mid(cur, g, **kw)
        enc.conv_norm_out = Norm(cur, g, silu=True, device=device)
        enc.conv_out = _conv(cur, 2 * lc, **kw)
        self.encoder = enc
        cur = chans[-1]
        dec = _Holder(conv_in=_conv(lc, cur, **kw), mid_block=_vae_mid(cur, g, **kw))
        blocks = []
        for lvl in reversed(range(len(chans))):
            ch = chans[lvl]
            res = []
            for _ in range(lpb + 1):
                res.append(VAEResBlock(cur, ch, g, **kw))
                cur = ch
            samp = [_Holder(conv=_conv(ch, ch, **kw))] if lvl else []
            blocks.append(_Holder(resnets=nn.ModuleList(res), upsamplers=nn.ModuleList(samp)))
        dec.up_blocks = nn.ModuleList(blocks)
        dec.conv_norm_out = Norm(cur, g, silu=True, device=device)
        dec.conv_out = _conv(cur, c["in_channels"], **kw)
        self.decoder = dec
        self.quant_conv = _conv(2 * lc, 2 * lc, 1, padding=0, **kw)
        self.post_quant_conv = _conv(lc, lc, 1, padding=0, **kw)

    def encode(self, x):
        e = self.encoder
        h = e.conv_in(x.permute(0, 3, 1, 2))
        for blk in e.down_blocks:
            for r in blk.resnets:
                h = r(h)
            for s in blk.downsamplers:
                h = s.conv(F.pad(h, (0, 1, 0, 1)))
        h = e.conv_out(e.conv_norm_out(_run_mid(e.mid_block, h)))
        mean, logvar = self.quant_conv(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        d = self.decoder
        h = _run_mid(d.mid_block, d.conv_in(self.post_quant_conv(z.permute(0, 3, 1, 2))))
        for blk in d.up_blocks:
            for r in blk.resnets:
                h = r(h)
            for s in blk.upsamplers:
                h = s.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return d.conv_out(d.conv_norm_out(h)).permute(0, 2, 3, 1)


# ---- CLIP --------------------------------------------------------------------

class CLIPLayer(nn.Module):
    def __init__(self, dim, heads, mlp, dtype, device):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = Norm(dim, device=device)
        self.self_attn = _Holder(q_proj=_lin(dim, dim, True, dtype, device),
                                 k_proj=_lin(dim, dim, True, dtype, device),
                                 v_proj=_lin(dim, dim, True, dtype, device),
                                 out_proj=_lin(dim, dim, True, dtype, device))
        self.layer_norm2 = Norm(dim, device=device)
        self.mlp = _Holder(fc1=_lin(dim, mlp, True, dtype, device),
                           fc2=_lin(mlp, dim, True, dtype, device))

    def forward(self, x, causal: bool):
        a = self.self_attn
        b, n, c = x.shape
        h = self.layer_norm1(x)

        def split(t):
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)
        fn = causal_attention if causal else attention
        o = fn(split(a.q_proj(h)), split(a.k_proj(h)), split(a.v_proj(h)))
        x = x + a.out_proj(o.transpose(1, 2).reshape(b, n, c))
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """ids (B, L) -> last hidden state (B, L, H), causal, final LayerNorm.

    cfg: vocab_size, hidden, layers, heads, max_len."""

    def __init__(self, cfg: dict, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        h = c["hidden"]
        emb = _Holder(token_embedding=nn.Embedding(c["vocab_size"], h, dtype=dtype,
                                                   device=device),
                      position_embedding=nn.Embedding(c["max_len"], h, device=device))
        emb.position_embedding.init_std = 0.01
        self.text_model = _Holder(
            embeddings=emb,
            encoder=_Holder(layers=nn.ModuleList([CLIPLayer(h, c["heads"], 4 * h, dtype, device)
                                                  for _ in range(c["layers"])])),
            final_layer_norm=Norm(h, device=device))

    def forward(self, ids):
        tm = self.text_model
        x = tm.embeddings.token_embedding(ids) \
            + tm.embeddings.position_embedding.weight[:ids.shape[1]][None]
        for layer in tm.encoder.layers:
            x = layer(x, causal=True)
        return tm.final_layer_norm(x)


def parameter_spec(module: nn.Module) -> list[tuple[str, tuple, torch.dtype, str, float]]:
    """(name, shape, dtype, kind, scale) of every parameter, in name order:
    kind "matrix" (scale = 1 / sqrt(fan in)), "norm_weight", "bias" or
    "normal" (scale = the std). `harness/weights.py` draws from it."""
    out = []
    for mname, sub in module.named_modules():
        for pname, p in sub.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if getattr(sub, "norm_params", False):
                out.append((name, tuple(p.shape), p.dtype,
                            "norm_weight" if pname == "weight" else "bias", 0.0))
            elif isinstance(sub, nn.Embedding):
                out.append((name, tuple(p.shape), p.dtype, "normal",
                            getattr(sub, "init_std", 1.0 / math.sqrt(p.shape[1]))))
            elif pname == "bias":
                out.append((name, tuple(p.shape), p.dtype, "bias", 0.0))
            else:
                fan_in = p[0].numel()
                out.append((name, tuple(p.shape), p.dtype, "matrix", 1.0 / math.sqrt(fan_in)))
    return sorted(out)


def build(kind: str, cfg: dict, dtype: torch.dtype, device) -> nn.Module:
    """The reference module of `kind` ("unet", "vae", "clip_text") at the
    served `dtype`."""
    return {"unet": UNet, "vae": VAE, "clip_text": CLIPText}[kind](cfg, dtype=dtype,
                                                                 device=device)


def frozen(module: nn.Module) -> nn.Module:
    return module.eval().requires_grad_(False)

