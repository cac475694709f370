"""Attention for the diffusion stacks: the hand kernels K1, K3, K4 and plain sdpa.

Counterpart of `anyedit_tpu/ops/attention.py`. Layout is (B, H, L, D), as
in the JAX package; the kernels take (BH, L, D).

  * `sdpa` — plain attention with fp32 logits and softmax, probabilities
    cast to v's dtype (mirrors `sdpa_xla`). Cross-attention, the VAE mid
    attention (D = 512) and every shape off K1's route take it.
  * `flash_sdpa` — `sdpa`'s function with an online softmax and no bias,
    through K6 (`csrc/flash_sdpa.cu`); Flux's joint attention at D = 128
    takes it (`models/flux.py::takes_k6`).
  * `flash_nomax` — unmasked self-attention through K1
    (`csrc/flash_nomax.cu`).
  * `flash_attention` — online-softmax attention in fp32 with key padding
    masked at `kv_len`, through K3 (`csrc/flash_attention.cu`); reached by
    `attention(use_flash=True)`.
  * `flash_int8` — online-softmax attention with int8 products, through K4
    (`csrc/flash_int8.cu`); `self_attn_int8` is its (B, H, L, D) wrapper.
  * `attention` — the public entry, with the JAX package's route.
Each kernel wrapper takes its plain version for CPU tensors, launches its
kernel for CUDA tensors (raising on what the kernel does not take), and
counts its launches in `<wrapper>.launches`.

Gradients, as in the JAX package: a kernel writes into a fresh tensor
through a raw pointer, so under grad K1 (`attention`'s route) and K4
(`self_attn_int8`) run inside `_RecomputeAttnFn`, whose backward is the
autograd of `sdpa` on the saved q, k, v (the JAX `_self_attn_flash_bwd`;
for K4 on the unquantized inputs). Without grad they are the direct calls.
K3 has no VJP: `flash_attention` raises when a gradient is asked for.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from anyedit_tpu_torch.ops import _build
from anyedit_tpu_torch.ops.quant import absmax_scale, div127, quantize_int8
from anyedit_tpu_torch.ops.recompute import Recompute

_LOG2E = 1.4426950408889634
# Logit clamp of the max-free softmax (base-2 logits above 80 saturate
# instead of overflowing fp32), as in the JAX kernel.
_NOMAX_CLAMP = 80.0
_K1_BLOCK = 64
_K3_MAX_D = 256
_K4_MAX_D = 128
_K4_TILE = 64   # K4's key tile: its blocks are whole tiles
_K6_BLOCK = 128  # K6's key tile: the online softmax's blocks
_K6_D = 128


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: float | None = None,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention. q, k, v: (B, H, L, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def flash_sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch. q, k, v: (B, H, L, D).

    Logits in fp32 from q and k as they are, in base 2 (times scale *
    log2(e)); an online softmax over 128-key blocks, each block's p taken
    against the running row max and the earlier sums rescaled; for bf16
    inputs p is rounded to bf16 for the P.V product (the row sums take the
    fp32 p), for fp32 inputs it stays fp32. The sum is divided out at the
    end and the result cast to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    c = scale * _LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    acc = torch.zeros_like(qf)
    m = torch.full(q.shape[:-1] + (1,), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(0, k.shape[-2], _K6_BLOCK):
        t = torch.matmul(qf, kf[..., k0:k0 + _K6_BLOCK, :].transpose(-1, -2)) * c
        m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if q.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr + torch.matmul(p, vf[..., k0:k0 + _K6_BLOCK, :])
        m = m_new
    return (acc / l).to(q.dtype)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float | None = None) -> torch.Tensor:
    """`sdpa`'s function without a bias, by an online softmax. q, k, v:
    (B, H, L, D), one shape; returns (B, H, L, D).

    CPU tensors take `flash_sdpa_plain`. CUDA tensors launch K6, which
    takes bf16 with D = 128, read through their strides with unit stride in
    D (each stride a multiple of 8, each base 16-byte aligned); anything
    else raises. The result is a (B, H, L, D) view of a (B, L, H, D) buffer,
    so merging the heads back to (B, L, H D) copies nothing. K6 has no VJP:
    under grad it raises. It replaces no Pallas kernel: the JAX package
    runs this attention as `sdpa_xla`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _wants_grad(q, k, v):
        raise RuntimeError("flash_sdpa (K6) has no VJP: take sdpa or run under "
                           "torch.no_grad()")
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v, scale)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v)):
        raise ValueError(f"flash_sdpa: unsupported devices {q.device}, {k.device}, {v.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_sdpa: the kernel takes bf16, got "
                        f"{[t.dtype for t in (q, k, v)]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] != _K6_D:
        raise ValueError(f"flash_sdpa: q/k/v must share one (B, H, L, {_K6_D}) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_sdpa: {name} needs unit stride in D, strides a "
                             f"multiple of 8 and a 16-byte aligned base, got strides "
                             f"{t.stride()}")
    b, h, l, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)

    def strides(t):
        return (ctypes.c_longlong * 3)(*t.stride()[:3])
    err = _build.library().anyedit_flash_sdpa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides(q), strides(k),
        strides(v), strides(out), b, h, l, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("flash_sdpa", err)
    flash_sdpa.launches += 1
    return out


flash_sdpa.launches = 0


def flash_nomax_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch. q, k, v: (BH, L, D).

    For bf16 inputs it rounds the prescaled q and the probabilities to bf16
    where the kernel does; for fp32 inputs it stays fp32 throughout."""
    lowp = q.dtype == torch.bfloat16
    qs = q.float() * (scale * _LOG2E)
    if lowp:
        qs = qs.to(torch.bfloat16).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(s, max=_NOMAX_CLAMP))
    l = p.sum(dim=-1, keepdim=True)
    if lowp:
        p = p.to(torch.bfloat16).float()
    pv = torch.matmul(p, v.float())
    return (pv / torch.clamp(l, min=1e-30)).to(q.dtype)


def _k1_blocks(l: int, d: int) -> tuple[int, int]:
    """K1's block shape: (warps, m16 tiles of q rows per warp), 128 q rows
    where L allows, else 64. D <= 48 takes 4 warps of 2 tiles (each K/V
    fragment feeds two products), larger D 8 warps of 1 tile (fewer
    registers): the faster of the two at (BH, 4096, 40) and (BH, 1024, 80)
    on the H100 (`tools/bench_torch_ip2p.py --k1-blocks`)."""
    if l % 128:
        return 4, 1
    return (4, 2) if d <= 48 else (8, 1)


def flash_nomax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Unmasked self-attention, q/k/v: (BH, L, D) with Lq == Lkv.

    CPU tensors take the plain version. CUDA tensors launch K1, which needs
    bf16, L % 64 == 0 and D <= 128; anything else raises. L is never padded:
    each zero key would add exp2(0) = 1 to the softmax sum."""
    if q.device.type == "cpu":
        return flash_nomax_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_nomax: unsupported device {q.device}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_nomax: q/k/v must share one (BH, L, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, l, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_nomax: the kernel takes bf16, got {q.dtype}")
    if l % _K1_BLOCK or d > 128:
        raise ValueError(f"flash_nomax: needs L % {_K1_BLOCK} == 0 and D <= 128, "
                         f"got L={l}, D={d}")
    if not all(t.is_contiguous() and t.device == q.device for t in (k, v)) \
            or not q.is_contiguous():
        raise ValueError("flash_nomax: q/k/v must be contiguous on one device")
    out = torch.empty_like(q)
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.anyedit_flash_nomax_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       out.data_ptr(), bh, l, d,
                                       float(scale * _LOG2E), *_k1_blocks(l, d), stream)
    _build.check("flash_nomax", err)
    flash_nomax.launches += 1
    return out


flash_nomax.launches = 0


def _check_cuda(name: str, tensors, dtypes) -> None:
    """Device, dtype and contiguity checks shared by the kernel wrappers."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if tensors[0].dtype not in dtypes or any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{name}: the kernel takes one of {dtypes}, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, kv_len: int | None = None) -> torch.Tensor:
    """K3's function in plain PyTorch: fp32 throughout, keys at index
    >= kv_len masked, output in q's dtype. q: (BH, Lq, D); k, v: (BH, Lkv, D)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if kv_len is not None and kv_len < k.shape[1]:
        s[..., kv_len:] = -math.inf
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _k3_warps(d: int) -> int:
    """K3's warps a block, each owning 16 q rows: 8 up to D = 128, 4 above
    (more warps share each K/V tile; at D = 160 eight hold too many
    registers). The fastest in device time at 6 of the UNet's 8 K3 shapes,
    and within 0.0003 ms of it at the other two, on the H100
    (`tools/bench_torch_ip2p.py --k34-blocks`; PERF.md)."""
    return 8 if d <= 128 else 4


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, kv_len: int | None = None) -> torch.Tensor:
    """Online-softmax attention in fp32, q: (BH, Lq, D), k/v: (BH, Lkv, D),
    any Lq and Lkv. Keys at index >= kv_len (default Lkv) are masked, so a
    caller that pads the keys passes the true count.

    CPU tensors take the plain version. CUDA tensors launch K3, which takes
    contiguous bf16 or fp32 and D <= 256; anything else raises. Under grad
    with an input that requires it, it raises on every device: K3 has no
    VJP, as the JAX `flash_attention` has none."""
    if _wants_grad(q, k, v):
        raise RuntimeError("flash_attention (K3) has no VJP, as in the JAX package: "
                           "take attention(use_flash=None) or run under torch.no_grad()")
    kv_len = k.shape[1] if kv_len is None else kv_len
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, kv_len)
    _check_cuda("flash_attention", (q, k, v), (torch.bfloat16, torch.float32))
    bh, lq, d = q.shape
    lkv = k.shape[1]
    if k.shape != (bh, lkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not pair")
    if d > _K3_MAX_D or not 1 <= kv_len <= lkv:
        raise ValueError(f"flash_attention: needs D <= {_K3_MAX_D} and "
                         f"1 <= kv_len <= Lkv, got D={d}, kv_len={kv_len}, Lkv={lkv}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().anyedit_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, lq, lkv,
        kv_len, d, float(scale), int(q.dtype == torch.bfloat16),
        _k3_warps(d), stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """K4's wrapper quantization (the JAX `flash_int8`): k per tensor, v per
    (head, channel) over L. Returns (k8, v8, sk (1,1,1), sv (BH,1,D))."""
    sk = absmax_scale(k)
    sv = absmax_scale(v, 1)
    return quantize_int8(k, sk), quantize_int8(v, sv), sk, sv


def flash_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, kv_len: int | None = None,
                     block_k: int = 512) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch, in the JAX kernel's order over its
    key blocks [b * block_k, (b + 1) * block_k) cut at kv_len. Each block
    rounds p8 against the running max taken over the whole block and adds
    its P.V as one int32 product. q, k, v: (BH, L, D) float. The int8
    products are taken in float64, which is exact for them."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    k8, v8, sk, sv = _quantize_kv(k, v)
    qf = q.float()
    sq = absmax_scale(qf, -1)                                  # (BH, L, 1)
    q8 = torch.round(qf / sq).double()
    row_f = sq * (sk * scale).reshape(())
    acc = torch.zeros_like(qf)
    m = torch.full_like(sq, -math.inf)
    l = torch.zeros_like(sq)
    for k0 in range(0, kv_len, block_k):
        k1 = min(k0 + block_k, kv_len)
        s = torch.matmul(q8, k8[:, k0:k1].double().transpose(-1, -2)).float() * row_f
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        pv = torch.matmul(torch.round(p * 127.0).double(), v8[:, k0:k1].double()).float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    out = acc * div127(sv) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def _k4_key_order() -> list[int]:
    """K4's key order inside each 32-key group of v8ᵀ: position p holds key
    16 h + 2 t + 8 (i // 2) + i % 2, for p = 16 h + 4 t + i (h < 2, t < 4,
    i < 4). A lane's m16n8 accumulators hold keys 2t, 2t + 1, 8 + 2t, 9 + 2t
    of each 16, which this order makes the 4 adjacent keys of an int8 A
    fragment register, so P is packed in registers without a shuffle. With
    a key written 16 h + 8 a + 2 t + b, it is the permutation (h, a, t, b)
    -> (h, t, a, b) of its digits, which `k4_layout` applies as a view."""
    return [16 * (p // 16) + 2 * (p % 16 // 4) + 8 * (p % 4 // 2) + p % 2
            for p in range(32)]


def k4_layout(k8: torch.Tensor, v8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(BH, L, D) int8 k8, v8 -> K4's operands, as its quantization kernel
    writes them on the card (this is their reference): k8 zero-padded to
    (BH, LP, DP), and v8 zero-padded and transposed to (BH, DP, LP) with
    the keys of each 32-key group in `_k4_key_order`; DP = round16(D),
    LP = round64(L). A zero column changes no product and no absmax, and a
    zero key past L is masked, so the pads are exact. The int8 B operand of
    `mma.sync` is k-major, so P.V needs V with keys along its rows."""
    bh, l, d = k8.shape
    dp, lp = -(-d // 16) * 16, -(-l // _K4_TILE) * _K4_TILE
    pad = (0, dp - d, 0, lp - l)
    vt = F.pad(v8, pad).view(bh, lp // 32, 2, 2, 4, 2, dp)  # keys as (h, a, t, b)
    return F.pad(k8, pad), vt.permute(0, 6, 1, 2, 4, 3, 5).contiguous().view(bh, dp, lp)


def _k4_warps(bh: int, l: int) -> int:
    """K4's warps a block (16 q rows each): 4 where that gives two blocks
    for each of the H100's 132 SMs, else fewer. On the H100 4 warps are
    the fastest at (24, 1024, 80) and within 3 % of 8 at (24, 4096, 40)
    (`tools/bench_torch_ip2p.py --k34-blocks`; PERF.md)."""
    for warps in (4, 2):
        if bh * -(-l // (16 * warps)) >= 264:
            return warps
    return 1


def flash_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               kv_len: int | None = None, block_k: int = 512) -> torch.Tensor:
    """INT8-product online-softmax attention, q/k/v: (BH, L, D) float, over
    key blocks of `block_k` (the JAX `flash_int8`'s default 512). k is
    quantized per tensor and v per channel (on the card by K4's
    quantization kernels), q per row in the attention kernel. Keys at index
    >= kv_len (default L) are masked.

    CPU tensors take the plain version. CUDA tensors launch K4, which takes
    contiguous bf16 or fp32, D <= 128 and block_k a multiple of 64;
    anything else raises."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    if q.device.type == "cpu":
        return flash_int8_plain(q, k, v, scale, kv_len, block_k)
    _check_cuda("flash_int8", (q, k, v), (torch.bfloat16, torch.float32))
    bh, l, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_int8: q/k/v must share one (BH, L, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d > _K4_MAX_D or not 1 <= kv_len <= l or block_k < 1 or block_k % _K4_TILE:
        raise ValueError(f"flash_int8: needs D <= {_K4_MAX_D}, 1 <= kv_len <= L and "
                         f"block_k a multiple of {_K4_TILE}, got D={d}, "
                         f"kv_len={kv_len}, L={l}, block_k={block_k}")
    k8, v8t, scratch = _k4_quantize(k, v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().anyedit_flash_int8(
        q.data_ptr(), k8.data_ptr(), v8t.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        bh, l, k8.shape[1], kv_len, d, float(scale), block_k,
        int(q.dtype == torch.bfloat16), _k4_warps(bh, l), stream)
    _build.check("flash_int8", err)
    flash_int8.launches += 1
    return out


def _k4_quantize(k: torch.Tensor, v: torch.Tensor):
    """`_quantize_kv` and `k4_layout` in one pass on the card (K4's first
    two kernels). k, v: contiguous CUDA (BH, L, D), checked by the caller.
    Returns (k8 (BH, LP, DP), v8ᵀ (BH, DP, LP), scratch): scratch holds the
    bits of k's absmax, then of v's per (head, channel)."""
    bh, l, d = k.shape
    dp, lp = -(-d // 16) * 16, -(-l // _K4_TILE) * _K4_TILE
    scratch = torch.empty(1 + bh * d, dtype=torch.int32, device=k.device)
    k8 = torch.empty((bh, lp, dp), dtype=torch.int8, device=k.device)
    v8t = torch.empty((bh, dp, lp), dtype=torch.int8, device=k.device)
    err = _build.library().anyedit_k4_quantize(
        k.data_ptr(), v.data_ptr(), scratch.data_ptr(), k8.data_ptr(), v8t.data_ptr(),
        bh, l, lp, d, int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check("flash_int8 (quantize)", err)
    return k8, v8t, scratch


flash_int8.launches = 0


def _heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.reshape(b * h, l, d).contiguous()


class _RecomputeAttnFn(Recompute):
    """A hand kernel's forward over (B, H, L, D) q, k, v; the backward is
    the autograd of `sdpa` at the same scale on the saved inputs (fp32
    logits and softmax, probabilities cast to v's dtype)."""


def _k1(q, k, v, scale):
    b, h, l, d = q.shape
    return flash_nomax(_heads(q), _heads(k), _heads(v), scale).reshape(b, h, l, d)


def _k4(q, k, v, scale):
    b, h, l, d = q.shape
    return flash_int8(_heads(q), _heads(k), _heads(v), scale).reshape(b, h, l, d)


def _recompute_route(kernel, q, k, v, scale):
    """`kernel(q, k, v, scale)`, through `_RecomputeAttnFn` under grad."""
    if _wants_grad(q, k, v):
        return _RecomputeAttnFn.apply(kernel, sdpa, q, k, v, scale)
    return kernel(q, k, v, scale)


def self_attn_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """INT8 self-attention over (B, H, L, D) through `flash_int8` at its
    default 512-key blocks (the JAX `_self_attn_int8`). Under grad, the
    backward recomputes through `sdpa` on the unquantized inputs, as the
    JAX VJP does: the int8 path serves only, but a stray gradient must not
    crash or stop silently."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _recompute_route(_k4, q, k, v, scale)


def _on_k1_route(lq: int, lkv: int, d: int) -> bool:
    return lq == lkv and lq >= 1024 and lq % 512 == 0 and d <= 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None, use_flash: bool | None = None,
              int8: bool = False) -> torch.Tensor:
    """Public attention op. q, k, v: (B, H, L, D); returns (B, H, Lq, D).

    The JAX package's route, on every device:
      * use_flash=None: large unmasked self-attention (Lq == Lkv >= 1024,
        Lq % 512 == 0, D <= 128: the UNet's level-0 and level-1
        self-attention) goes to K1, everything else to `sdpa`;
      * use_flash=False: `sdpa`;
      * use_flash=True: K3 at every shape, keys masked at the true Lkv
        (it raises under grad: K3 has no VJP).
    Under grad, K1 runs inside `_RecomputeAttnFn`.
    `int8` (the W8A8 fast mode's flag) is accepted and changes nothing, as
    in the JAX package, where `attention()` never reads it: the int8 kernel
    K4 is reached only through `self_attn_int8`."""
    del int8
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if use_flash is None:
        if _on_k1_route(lq, lkv, d):
            return _recompute_route(_k1, q, k, v, scale)
        use_flash = False
    if not use_flash:
        return sdpa(q, k, v, scale=scale)
    return flash_attention(_heads(q), _heads(k), _heads(v), scale).reshape(b, h, lq, d)
