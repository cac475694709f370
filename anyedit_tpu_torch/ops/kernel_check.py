"""The hand kernels against their plain versions on the card, with timings.

Shared by `chip_smoke.py` and `tools/bench_torch_ip2p.py`. Every function
here needs a CUDA device; the plain references run with TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from anyedit_tpu_torch.ops.attention import (
    flash_attention, flash_attention_plain, flash_int8, flash_int8_plain,
    flash_nomax, flash_nomax_plain, sdpa,
)
from anyedit_tpu_torch.ops.groupnorm import group_norm, group_norm_plain
from anyedit_tpu_torch.ops.quant import int8_conv2d, int8_matmul


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


def _bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| in units of one bf16 rounding at the larger of
    the two magnitudes (2^-7 of it bounds the spacing of bf16 values), plus
    1e-5 for fp32 sums taken in another order, which matters only for
    outputs near zero."""
    o, r = out.float(), ref.float()
    unit = torch.maximum(o.abs(), r.abs()) * 2.0 ** -7 + 1e-5
    return float(((o - r).abs() / unit).max())


def check_flash_attention(bh: int, lq: int, lkv: int, d: int, device,
                          dtype=torch.bfloat16, seed: int = 2, iters: int = 10) -> dict:
    """K3 vs its plain version on N(0, 1) q/k/v: q (bh, lq, d), k/v
    (bh, lkv, d). `bf16_ulps` is the largest difference in bf16 roundings
    of the output (the bound for bf16 inputs is 1); fp32 inputs are held to
    max_abs_err."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bh, lq, d, generator=g, device=device).to(dtype)
    k, v = (torch.randn(bh, lkv, d, generator=g, device=device).to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    out = flash_attention(q, k, v, scale)
    ref = flash_attention_plain(q, k, v, scale)
    res = _errors(out, ref)
    res["bf16_ulps"] = _bf16_ulps(out, ref)
    res["ms"] = time_ms(lambda: flash_attention(q, k, v, scale), iters)
    res["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v, scale), iters)
    res["tflops"] = 4 * bh * lq * lkv * d / res["ms"] * 1e-9
    return res


def check_flash_int8(bh: int, l: int, d: int, device, dtype=torch.bfloat16,
                     seed: int = 3, iters: int = 10) -> dict:
    """K4 vs its plain version on N(0, 1) q/k/v (bh, l, d), and its relative
    L2 distance to fp32 `sdpa` (`rel_l2_sdpa`; the JAX package bounds it by
    0.03 at (2, 1024, 128) in fp32, tests/test_quant.py:207)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(bh, l, d, generator=g, device=device).to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    out = flash_int8(q, k, v, scale)
    res = _errors(out, flash_int8_plain(q, k, v, scale))
    exact = sdpa(*(t.float()[:, None] for t in (q, k, v)), scale=scale)[:, 0]
    res["rel_l2_sdpa"] = float((out.float() - exact).norm() / exact.norm())
    res["ms"] = time_ms(lambda: flash_int8(q, k, v, scale), iters)
    res["plain_ms"] = time_ms(lambda: flash_int8_plain(q, k, v, scale), iters)
    res["tops"] = 4 * bh * l * l * d / res["ms"] * 1e-9
    return res


def check_int8_contraction(kind: str, device, seed: int = 4, iters: int = 10) -> dict:
    """The W8A8 int32 contraction on the card against a float64 contraction
    of the same full-range int8 operands (|x| <= 127, so partial sums pass
    2^24): `exact` is True when every int32 equals the float64 result. Times
    the int8 route (`ms`), the float64 one (`plain_ms`) and a bf16 cuDNN /
    cuBLAS product of the same shape (`bf16_ms`), TF32 off.

    kind "conv": 3x3, pad 1, x (3, 320, 64, 64), w (320, 320, 3, 3).
    kind "dense": (4096, 320) x (320 -> 2560)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=device,
                             dtype=torch.int32).to(torch.int8)
    if kind == "conv":
        x, w = codes(3, 320, 64, 64), codes(320, 320, 3, 3)
        run = lambda: int8_conv2d(x, w, 1, 1)
        plain = lambda: F.conv2d(x.double(), w.double(), padding=1).permute(0, 2, 3, 1)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        bf16 = lambda: F.conv2d(xb, wb, padding=1)
        flops = 2 * 3 * 64 * 64 * 320 * 320 * 9
    else:
        x, w = codes(4096, 320), codes(2560, 320)
        run = lambda: int8_matmul(x, w.t())
        plain = lambda: x.double() @ w.double().t()
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        bf16 = lambda: xb @ wb.t()
        flops = 2 * 4096 * 320 * 2560
    out = run()
    res = {"exact": bool(torch.equal(out.double(), plain())),
           "dtype": str(out.dtype), "shape": list(out.shape)}
    res["ms"] = time_ms(run, iters)
    res["plain_ms"] = time_ms(plain, iters)
    res["bf16_ms"] = time_ms(bf16, iters)
    res["tops"] = flops / res["ms"] * 1e-9
    return res
