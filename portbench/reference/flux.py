"""Plain PyTorch reference of the factory's textual_change pair: the
FLUX.1-schnell transformer, the T5 v1.1 encoder, the flow-match Euler sampler
at shift 1.0, and the pair itself (two captions sampled from the same start
latents, each decoded by the Flux VAE and brought to the canvas). Written
from the published descriptions (diffusers `FluxTransformer2DModel`,
`FlowMatchEulerDiscreteScheduler`, `FluxPipeline`; HF `T5EncoderModel`);
the VAE and the CLIP-L text tower are `nets.VAE` and `nets.CLIPText`.

It imports nothing of the program. Parameter names follow the diffusers /
HF checkpoint keys, which the program's modules carry, so that one set of
seeded weights (`harness/blocks.py`) loads into both. Each module is built
with the dtype its weights are served in (the Flux block, patch, context and
output Linears and every T5 matrix in the served dtype; the Flux
modulations, the timestep and pooled embedders, the q / k RMS norms, T5's
RMS norms and its position bias in fp32), so that the weights are drawn in
that dtype; `.float()` afterwards computes in fp32 on the same values.

Published and kept: the LayerNorms are affine-free with eps 1e-6, the GELUs
(Flux's FFNs and single-block MLP, T5's gated FFN) are the tanh form, the
q / k RMS norms and T5's norms have eps 1e-6, T5's attention is unscaled.

Departures from the published models, each shared with the program under
test (the reference follows the computation the benchmark asks for):
  * a patch's 64 input features are ordered (row, column, channel) of the
    2 x 2 patch (the program's NHWC latents); diffusers packs them
    (channel, row, column);
  * the Flux VAE has the SD VAE's layout with 16 latent channels
    (`quant_conv` / `post_quant_conv`, no 0.1159 shift before the scale),
    as the program keeps it; diffusers' Flux VAE has neither conv and
    shifts;
  * the T5 context is the encoder's output for hash ids (no tokenizer
    ships), zero-padded to the configured length, with no mask, as
    FluxPipeline passes none;
  * the nets.py departures of the VAE and the CLIP text tower.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import image as im
from portbench.reference import nets
from portbench.reference.edit import clip_hash_ids

# T5's hash ids (the BERT-style word hash that stands in for SentencePiece)
T5_CLS, T5_SEP, T5_RESERVED, T5_HASH_VOCAB = 101, 102, 999, 30522


def t5_hash_ids(text: str, vocab_size: int, max_len: int) -> list[int]:
    """[CLS], one bucket id per lower-case word (polynomial hash base 131
    modulo 30522 - 999, plus 999), [SEP]; cut to `max_len`, zero-padded,
    each id modulo `vocab_size`."""
    ids = [T5_CLS]
    for w in re.findall(r"[a-z0-9]+", text.lower()):
        h = 0
        for ch in w:
            h = (h * 131 + ord(ch)) % (T5_HASH_VOCAB - T5_RESERVED)
        ids.append(h + T5_RESERVED)
    ids.append(T5_SEP)
    ids = ids[:max_len]
    return [i % vocab_size for i in ids + [0] * (max_len - len(ids))]


def _lin(cin, cout, bias=True, dtype=None, device=None):
    return nn.Linear(cin, cout, bias=bias, dtype=dtype, device=device)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, fp32 weight."""

    norm_params = True

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + self.eps) * self.weight


def layer_norm(x):
    """Affine-free LayerNorm, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


# ---- Flux --------------------------------------------------------------------

def rope(ids: torch.Tensor, axes_dim, theta: float = 10000.0):
    """ids (L, 3) -> (cos, sin) (L, head_dim / 2): each axis a's positions
    times theta^(-2i / d_a), i < d_a / 2, the axes concatenated."""
    cos, sin = [], []
    for a, d in enumerate(axes_dim):
        freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d)
        ang = ids[:, a:a + 1].float() * freqs[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x, cos, sin):
    """Rotate the interleaved pairs (x[2i], x[2i + 1]) of (B, H, L, D) by
    the angle of pair i."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)


def position_ids(gh: int, gw: int, txt_len: int, device) -> torch.Tensor:
    """(txt_len + gh gw, 3): text ids zero, image ids (0, row, column)."""
    rows = torch.arange(gh, dtype=torch.float32, device=device)[:, None].expand(gh, gw)
    cols = torch.arange(gw, dtype=torch.float32, device=device)[None, :].expand(gh, gw)
    img = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1).reshape(gh * gw, 3)
    return torch.cat([torch.zeros(txt_len, 3, device=device), img])


class _Mod(nn.Module):
    """`linear` over silu(vec): AdaLN's n modulation vectors (fp32)."""

    def __init__(self, dim, n, device):
        super().__init__()
        self.linear = _lin(dim, n * dim, device=device)

    def forward(self, vec):
        return self.linear(F.silu(vec))


class _Embed(nn.Module):
    """linear_1 -> SiLU -> linear_2 (fp32)."""

    def __init__(self, din, dim, device):
        super().__init__()
        self.linear_1 = _lin(din, dim, device=device)
        self.linear_2 = _lin(dim, dim, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _FF(nn.Module):
    """net.0.proj -> tanh GELU -> net.2 (diffusers FeedForward names)."""

    def __init__(self, dim, dtype, device):
        super().__init__()
        first = nn.Module()
        first.proj = _lin(dim, 4 * dim, dtype=dtype, device=device)
        self.net = nn.ModuleList([first, nn.Identity(), _lin(4 * dim, dim, dtype=dtype,
                                                             device=device)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


def _heads(t, h):
    b, n, c = t.shape
    return t.reshape(b, n, h, c // h).transpose(1, 2)


def _merge(o):
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


class DoubleBlock(nn.Module):
    """Joint attention over [text, image], each stream with its own
    modulation (shift, scale, gate twice), projections, q / k RMS norms and
    FFN."""

    def __init__(self, dim, heads, dtype, device):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.norm1 = _Mod(dim, 6, device)
        self.norm1_context = _Mod(dim, 6, device)
        a = self.attn = nn.Module()
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                  "to_add_out"):
            setattr(a, n, _lin(dim, dim, dtype=dtype, device=device))
        a.to_out = nn.ModuleList([_lin(dim, dim, dtype=dtype, device=device)])
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(a, n, RMSNorm(hd, device=device))
        self.ff = _FF(dim, dtype, device)
        self.ff_context = _FF(dim, dtype, device)

    def forward(self, img, txt, vec, cos, sin):
        a, h = self.attn, self.heads
        m = [x[:, None] for x in self.norm1(vec).chunk(6, dim=-1)]
        mc = [x[:, None] for x in self.norm1_context(vec).chunk(6, dim=-1)]
        xi = layer_norm(img) * (1 + m[1]) + m[0]
        xt = layer_norm(txt) * (1 + mc[1]) + mc[0]
        q = torch.cat([a.norm_added_q(_heads(a.add_q_proj(xt), h)),
                       a.norm_q(_heads(a.to_q(xi), h))], dim=2)
        k = torch.cat([a.norm_added_k(_heads(a.add_k_proj(xt), h)),
                       a.norm_k(_heads(a.to_k(xi), h))], dim=2)
        v = torch.cat([_heads(a.add_v_proj(xt), h), _heads(a.to_v(xi), h)], dim=2)
        o = _merge(nets.attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v))
        ot, oi = o[:, :txt.shape[1]], o[:, txt.shape[1]:]
        img = img + m[2] * a.to_out[0](oi)
        img = img + m[5] * self.ff(layer_norm(img) * (1 + m[4]) + m[3])
        txt = txt + mc[2] * a.to_add_out(ot)
        txt = txt + mc[5] * self.ff_context(layer_norm(txt) * (1 + mc[4]) + mc[3])
        return img, txt


class SingleBlock(nn.Module):
    """Attention and the MLP in parallel over the joint sequence, their
    outputs concatenated into one projection."""

    def __init__(self, dim, heads, dtype, device):
        super().__init__()
        self.heads = heads
        self.norm = _Mod(dim, 3, device)
        a = self.attn = nn.Module()
        for n in ("to_q", "to_k", "to_v"):
            setattr(a, n, _lin(dim, dim, dtype=dtype, device=device))
        a.norm_q, a.norm_k = RMSNorm(dim // heads, device=device), RMSNorm(dim // heads,
                                                                           device=device)
        self.proj_mlp = _lin(dim, 4 * dim, dtype=dtype, device=device)
        self.proj_out = _lin(5 * dim, dim, dtype=dtype, device=device)

    def forward(self, x, vec, cos, sin):
        a, h = self.attn, self.heads
        shift, scale, gate = (t[:, None] for t in self.norm(vec).chunk(3, dim=-1))
        n = layer_norm(x) * (1 + scale) + shift
        q = apply_rope(a.norm_q(_heads(a.to_q(n), h)), cos, sin)
        k = apply_rope(a.norm_k(_heads(a.to_k(n), h)), cos, sin)
        o = _merge(nets.attention(q, k, _heads(a.to_v(n), h)))
        mlp = F.gelu(self.proj_mlp(n), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([o, mlp], dim=-1))


class Flux(nn.Module):
    """(latents (B, h, w, C), t (B,) = sigma x 1000, context (B, L, Dc),
    pooled (B, Dp)) -> velocity (B, h, w, C).

    cfg: in_channels (latent channels), patch, dim, heads, double_depth,
    single_depth, context_dim, pooled_dim, axes_dim (the keys of
    `configs/factory-flux-schnell.json`'s "flux"); no guidance embedder
    (schnell)."""

    def __init__(self, cfg: dict, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = c = cfg
        d, p = c["dim"], c["patch"]
        kw = dict(dtype=dtype, device=device)
        self.x_embedder = _lin(p * p * c["in_channels"], d, **kw)
        self.context_embedder = _lin(c["context_dim"], d, **kw)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = _Embed(256, d, device)
        self.time_text_embed.text_embedder = _Embed(c["pooled_dim"], d, device)
        self.transformer_blocks = nn.ModuleList(
            [DoubleBlock(d, c["heads"], dtype, device) for _ in range(c["double_depth"])])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleBlock(d, c["heads"], dtype, device) for _ in range(c["single_depth"])])
        self.norm_out = _Mod(d, 2, device)
        self.proj_out = _lin(d, p * p * c["in_channels"], **kw)

    def forward(self, x, t, ctx, pooled):
        c = self.cfg
        b, h, w, ch = x.shape
        p = c["patch"]
        gh, gw = h // p, w // p
        img = self.x_embedder(x.reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 2, 4, 5)
                              .reshape(b, gh * gw, p * p * ch))
        txt = self.context_embedder(ctx)
        tte = self.time_text_embed
        vec = tte.timestep_embedder(nets.timestep_embedding(t, 256)) \
            + tte.text_embedder(pooled)
        cos, sin = rope(position_ids(gh, gw, ctx.shape[1], x.device), c["axes_dim"])
        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, vec, cos, sin)
        seq = torch.cat([txt, img], dim=1)
        for blk in self.single_transformer_blocks:
            seq = blk(seq, vec, cos, sin)
        scale, shift = (z[:, None] for z in self.norm_out(vec).chunk(2, dim=-1))
        out = self.proj_out(layer_norm(seq[:, ctx.shape[1]:]) * (1 + scale) + shift)
        return out.reshape(b, gh, gw, p, p, ch).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, ch)


# ---- T5 ----------------------------------------------------------------------

def relative_buckets(lq: int, lk: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """(lq, lk) bidirectional buckets of key - query (HF T5's
    `_relative_position_bucket`), computed in fp32 on the CPU."""
    rel = torch.arange(lk)[None, :] - torch.arange(lq)[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = torch.clamp(large, max=half - 1)
    return out + torch.where(n < exact, n, large)


class T5Layer(nn.Module):
    """`block.N.layer.M`: an RMS norm and its self-attention or gated FFN."""

    def __init__(self, name, body, dim, device):
        super().__init__()
        self.layer_norm = RMSNorm(dim, device=device)
        setattr(self, name, body)


class T5Encoder(nn.Module):
    """ids (B, L) -> the final RMS norm's output (B, L, dim).

    cfg: vocab_size, dim, kv_dim, heads, ffn_dim, enc_layers, rel_buckets,
    rel_max_dist. Block 0's attention owns the position bias, which every
    block adds; attention is unscaled, the FFN gated on tanh GELU."""

    def __init__(self, cfg: dict, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = c = cfg
        inner = c["heads"] * c["kv_dim"]
        kw = dict(bias=False, dtype=dtype, device=device)
        self.embed_tokens = nn.Embedding(c["vocab_size"], c["dim"], dtype=dtype, device=device)
        self.block = nn.ModuleList()
        for i in range(c["enc_layers"]):
            sa = nn.Module()
            sa.q, sa.k, sa.v = (_lin(c["dim"], inner, **kw) for _ in range(3))
            sa.o = _lin(inner, c["dim"], **kw)
            # T5's own init folds the unscaled attention's 1 / sqrt(kv_dim)
            # into q (`parameter_spec` reads it)
            sa.q.init_gain = 1.0 / math.sqrt(c["kv_dim"])
            if i == 0:
                sa.relative_attention_bias = nn.Embedding(c["rel_buckets"], c["heads"],
                                                          device=device)
            ff = nn.Module()
            ff.wi_0 = _lin(c["dim"], c["ffn_dim"], **kw)
            ff.wi_1 = _lin(c["dim"], c["ffn_dim"], **kw)
            ff.wo = _lin(c["ffn_dim"], c["dim"], **kw)
            blk = nn.Module()
            blk.layer = nn.ModuleList([T5Layer("SelfAttention", sa, c["dim"], device),
                                       T5Layer("DenseReluDense", ff, c["dim"], device)])
            self.block.append(blk)
        self.final_layer_norm = RMSNorm(c["dim"], device=device)

    def forward(self, ids):
        c = self.cfg
        b, n = ids.shape
        x = self.embed_tokens(ids)
        bias_mod = self.block[0].layer[0].SelfAttention.relative_attention_bias
        bucket = relative_buckets(n, n, c["rel_buckets"], c["rel_max_dist"]).to(ids.device)
        pos = bias_mod(bucket).permute(2, 0, 1)[None]            # (1, H, L, L)

        def split(t):
            return t.reshape(b, n, c["heads"], c["kv_dim"]).transpose(1, 2)
        for blk in self.block:
            att, ff = blk.layer
            a, h = att.SelfAttention, att.layer_norm(x)
            s = torch.matmul(split(a.q(h)), split(a.k(h)).transpose(-1, -2)) + pos
            o = torch.matmul(torch.softmax(s, dim=-1), split(a.v(h)))
            x = x + a.o(o.transpose(1, 2).reshape(b, n, -1))
            f, h = ff.DenseReluDense, ff.layer_norm(x)
            x = x + f.wo(F.gelu(f.wi_0(h), approximate="tanh") * f.wi_1(h))
        return self.final_layer_norm(x)


# ---- weights -----------------------------------------------------------------

def parameter_spec(module: nn.Module) -> list:
    """`nets.parameter_spec`, with a matrix's scale times the `init_gain` its
    module carries (T5's q)."""
    gains = {f"{n}.weight": m.init_gain for n, m in module.named_modules()
             if hasattr(m, "init_gain")}
    return [(name, shape, dtype, kind, scale * gains.get(name, 1.0))
            for name, shape, dtype, kind, scale in nets.parameter_spec(module)]


def build(kind: str, cfg: dict, dtype: torch.dtype, device) -> nn.Module:
    """The reference module of `kind` ("flux", "t5", or a `nets` kind) at
    the served `dtype`."""
    if kind == "flux":
        return Flux(cfg, dtype=dtype, device=device)
    if kind == "t5":
        return T5Encoder(cfg, dtype=dtype, device=device)
    return nets.build(kind, cfg, dtype, device)


# ---- the sampler and the pair ------------------------------------------------

def flow_sigmas(steps: int, shift: float):
    """FlowMatchEulerDiscrete's sigmas 1 .. 1 / steps, shifted, then 0."""
    s = torch.linspace(1.0, 1.0 / steps, steps, dtype=torch.float32)
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return torch.cat([s, torch.zeros(1)]).tolist()


def flow_sample(flux, noise, ctx, pooled, steps: int, shift: float):
    """Euler steps x += (sigma_next - sigma) v(x, sigma x 1000)."""
    sig = flow_sigmas(steps, shift)
    x = noise.float()
    for i in range(steps):
        t = torch.full((x.shape[0],), sig[i] * 1000.0, dtype=torch.float32, device=x.device)
        x = x + (sig[i + 1] - sig[i]) * flux(x, t, ctx, pooled)
    return x


@torch.no_grad()
def encode_captions(t5, clip, cfg: dict, captions, t5_len: int, device):
    """[(T5 context (1, t5_len, dim), CLIP-L pooled (1, hidden))] of each
    caption: the T5 encoder on its hash ids; CLIP-L's final-norm hidden
    state at the first end token."""
    tc, cc = cfg["t5"], cfg["clip_text"]
    out = []
    for text in captions:
        ids = torch.tensor([t5_hash_ids(text, tc["vocab_size"], t5_len)], device=device)
        cids = torch.tensor([clip_hash_ids(text, cc["vocab_size"], cc["max_len"])],
                            device=device)
        hid = clip(cids)
        out.append((t5(ids), hid[torch.arange(1, device=device), cids.argmax(dim=-1)]))
    return out


@torch.no_grad()
def sample_latents(flux, cfg: dict, conds, noises):
    """The sampled latents of each (context, pooled) from its start noise."""
    s = cfg["scheduler"]
    return [flow_sample(flux, z, ctx, pooled, s["steps"], s["shift"])
            for (ctx, pooled), z in zip(conds, noises)]


@torch.no_grad()
def decode_images(vae, cfg: dict, latents) -> list:
    """Each latent through the VAE decoder, to uint8 at the canvas size."""
    size, sf = cfg["canvas"]["edit_size"], cfg["flux_vae"]["scaling_factor"]
    out = []
    for z in latents:
        d = vae.decode(z / sf)[0]
        out.append(im.trunc_u8(im.resize(im.unit_to_u8(d).float(), size, size)))
    return out
