"""Attention for the diffusion stacks: the max-free kernel K1 and plain sdpa.

Counterpart of `anyedit_tpu/ops/attention.py`. Layout is (B, H, L, D), as
in the JAX package.

  * `sdpa` — plain attention with fp32 logits and softmax, probabilities
    cast to v's dtype (mirrors `sdpa_xla`). Cross-attention, the VAE mid
    attention (D = 512) and every shape off the kernel's route take it.
  * `flash_nomax` — unmasked self-attention through the hand kernel K1
    (`csrc/flash_nomax.cu`) on CUDA tensors; its plain version on CPU
    tensors.
  * `attention` — the public entry, with the JAX package's route.
"""

from __future__ import annotations

import math

import torch

from anyedit_tpu_torch.ops import _build

_LOG2E = 1.4426950408889634
# Logit clamp of the max-free softmax (base-2 logits above 80 saturate
# instead of overflowing fp32), as in the JAX kernel.
_NOMAX_CLAMP = 80.0
_K1_BLOCK = 64


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
                                       float(scale * _LOG2E), stream)
    _build.check("flash_nomax", err)
    flash_nomax.launches += 1
    return out


flash_nomax.launches = 0


def _on_k1_route(lq: int, lkv: int, d: int) -> bool:
    return lq == lkv and lq >= 1024 and lq % 512 == 0 and d <= 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float | None = None) -> torch.Tensor:
    """Public attention op. q, k, v: (B, H, L, D); returns (B, H, Lq, D).

    Large unmasked self-attention (Lq == Lkv >= 1024, Lq % 512 == 0,
    D <= 128: the UNet's level-0 and level-1 self-attention) goes to K1;
    everything else to `sdpa`. The route is the JAX package's, on every
    device."""
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _on_k1_route(lq, lkv, d):
        def heads(t):
            return t.reshape(b * h, lq, d).contiguous()
        out = flash_nomax(heads(q), heads(k), heads(v), scale)
        return out.reshape(b, h, lq, d)
    return sdpa(q, k, v, scale=scale)
