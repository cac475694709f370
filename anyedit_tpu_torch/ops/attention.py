"""Attention for the diffusion stacks: the hand kernels K1, K3, K4 and plain sdpa.

Counterpart of `anyedit_tpu/ops/attention.py`. Layout is (B, H, L, D), as
in the JAX package; the kernels take (BH, L, D).

  * `sdpa` — plain attention with fp32 logits and softmax, probabilities
    cast to v's dtype (mirrors `sdpa_xla`). Cross-attention, the VAE mid
    attention (D = 512) and every shape off K1's route take it.
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
"""

from __future__ import annotations

import math

import torch

from anyedit_tpu_torch.ops import _build
from anyedit_tpu_torch.ops.quant import absmax_scale, quantize_int8

_LOG2E = 1.4426950408889634
# Logit clamp of the max-free softmax (base-2 logits above 80 saturate
# instead of overflowing fp32), as in the JAX kernel.
_NOMAX_CLAMP = 80.0
_K1_BLOCK = 64
_K3_MAX_D = 256
_K4_MAX_D = 128
# K4's key tile. p8 is rounded against the running max of its tile, so the
# plain version walks the same tiles as the kernel.
_K4_BLOCK_K = 64


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, kv_len: int | None = None) -> torch.Tensor:
    """Online-softmax attention in fp32, q: (BH, Lq, D), k/v: (BH, Lkv, D),
    any Lq and Lkv. Keys at index >= kv_len (default Lkv) are masked, so a
    caller that pads the keys passes the true count.

    CPU tensors take the plain version. CUDA tensors launch K3, which takes
    contiguous bf16 or fp32 and D <= 256; anything else raises."""
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
        kv_len, d, float(scale), int(q.dtype == torch.bfloat16), stream)
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
                     scale: float, kv_len: int | None = None) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch, in the kernel's order and over its
    64-key tiles. q, k, v: (BH, L, D) float. The int8 products are taken in
    float64, which is exact for them."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    k8, v8, sk, sv = _quantize_kv(k, v)
    qf = q.float()
    sq = absmax_scale(qf, -1)                                  # (BH, L, 1)
    q8 = torch.round(qf / sq).double()
    row_f = sq * (sk * scale).reshape(())
    acc = torch.zeros_like(qf)
    m = torch.full_like(sq, -math.inf)
    l = torch.zeros_like(sq)
    for k0 in range(0, kv_len, _K4_BLOCK_K):
        kt = k8[:, k0:k0 + _K4_BLOCK_K].double()
        vt = v8[:, k0:k0 + _K4_BLOCK_K].double()
        s = torch.matmul(q8, kt.transpose(-1, -2)).float() * row_f
        col = torch.arange(k0, k0 + kt.shape[1], device=q.device)
        s = s.masked_fill(col >= kv_len, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        pv = torch.matmul(torch.round(p * 127.0).double(), vt).float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    out = acc * (sv / 127.0) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               kv_len: int | None = None) -> torch.Tensor:
    """INT8-product online-softmax attention, q/k/v: (BH, L, D) float.
    k is quantized per tensor and v per channel here; q per row in the
    kernel. Keys at index >= kv_len (default L) are masked.

    CPU tensors take the plain version. CUDA tensors launch K4, which takes
    contiguous bf16 or fp32 and D <= 128; anything else raises."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    if q.device.type == "cpu":
        return flash_int8_plain(q, k, v, scale, kv_len)
    _check_cuda("flash_int8", (q, k, v), (torch.bfloat16, torch.float32))
    bh, l, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_int8: q/k/v must share one (BH, L, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d > _K4_MAX_D or not 1 <= kv_len <= l:
        raise ValueError(f"flash_int8: needs D <= {_K4_MAX_D} and 1 <= kv_len <= L, "
                         f"got D={d}, kv_len={kv_len}, L={l}")
    k8, v8, sk, sv = _quantize_kv(k, v)
    fac = (sk * scale).reshape(1).float()
    sv = sv.reshape(bh, d).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.library().anyedit_flash_int8(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), fac.data_ptr(), sv.data_ptr(),
        out.data_ptr(), bh, l, kv_len, d, int(q.dtype == torch.bfloat16), stream)
    _build.check("flash_int8", err)
    flash_int8.launches += 1
    return out


flash_int8.launches = 0


def _heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.reshape(b * h, l, d).contiguous()


def self_attn_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """INT8 self-attention over (B, H, L, D) through `flash_int8` (the JAX
    `_self_attn_int8`, forward only: its recompute backward comes with the
    training slice)."""
    b, h, l, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return flash_int8(_heads(q), _heads(k), _heads(v), scale).reshape(b, h, l, d)


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
      * use_flash=True: K3 at every shape, keys masked at the true Lkv.
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
            return flash_nomax(_heads(q), _heads(k), _heads(v), scale).reshape(b, h, lq, d)
        use_flash = False
    if not use_flash:
        return sdpa(q, k, v, scale=scale)
    return flash_attention(_heads(q), _heads(k), _heads(v), scale).reshape(b, h, lq, d)
