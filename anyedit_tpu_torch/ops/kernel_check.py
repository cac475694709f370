"""The hand kernels against their plain versions on the card, with timings.

Shared by `chip_smoke.py` and `tools/bench_torch_ip2p.py`. Every function
here needs a CUDA device; the plain references run with TF32 off.
"""

from __future__ import annotations

import math

import torch

from anyedit_tpu_torch.ops.attention import flash_nomax, flash_nomax_plain
from anyedit_tpu_torch.ops.groupnorm import group_norm, group_norm_plain


def time_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds of `fn()` over `iters` back-to-back runs
    (CUDA events, after one warm-up run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (out.float() - ref.float()).abs()
    return {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "finite": bool(torch.isfinite(out.float()).all())}


def check_flash_nomax(bh: int, l: int, d: int, device, seed: int = 0,
                      iters: int = 10) -> dict:
    """K1 vs its plain version on N(0, 1) bf16 q/k/v of shape (bh, l, d)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(bh, l, d, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    out = flash_nomax(q, k, v, scale)
    res = _errors(out, flash_nomax_plain(q, k, v, scale))
    res["ms"] = time_ms(lambda: flash_nomax(q, k, v, scale), iters)
    res["plain_ms"] = time_ms(lambda: flash_nomax_plain(q, k, v, scale), iters)
    res["tflops"] = 4 * bh * l * l * d / res["ms"] * 1e-9
    return res


def check_flash_nomax_clamp(device) -> dict:
    """Logits far past the clamp (q = k = 30, D = 128): the max-free softmax
    saturates to uniform weights, so the output must equal v (= 1)."""
    q = torch.full((1, 512, 128), 30.0, dtype=torch.bfloat16, device=device)
    v = torch.ones_like(q)
    out = flash_nomax(q, q, v, 1.0)
    return _errors(out, v)


def check_group_norm(shape, silu: bool, device, dtype=torch.bfloat16,
                     magnitude: float = 0.0, seed: int = 1, iters: int = 10) -> dict:
    """K2 vs its plain version on one input of `shape` (NCHW), 32 groups.
    `magnitude` > 0 adds a per-channel offset near it with spread 1e-3 of it
    (the |mean| / std = 1e3 cancellation case)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device=device)
    if magnitude:
        base = magnitude + 1e-4 * magnitude * torch.randn(
            (1, c, 1, 1), generator=g, device=device)
        x = base + 1e-3 * magnitude * x
    x = x.to(dtype)
    scale = torch.randn(c, generator=g, device=device) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=device) * 0.1
    out = group_norm(x, scale, bias, 32, silu=silu)
    res = _errors(out, group_norm_plain(x, scale, bias, 32, silu=silu))
    res["ms"] = time_ms(lambda: group_norm(x, scale, bias, 32, silu=silu), iters)
    res["plain_ms"] = time_ms(lambda: group_norm_plain(x, scale, bias, 32, silu=silu),
                              iters)
    res["gbps"] = 4 * x.numel() * x.element_size() / res["ms"] * 1e-6
    return res
