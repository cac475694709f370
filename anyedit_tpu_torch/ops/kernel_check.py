"""The hand kernels against their plain versions on the card, with timings.

Shared by `chip_smoke.py` and `tools/bench_torch_ip2p.py`. Every function
here needs a CUDA device; the plain references run with TF32 off.

Each `check_*` of a kernel also returns its yardsticks:
  * `bound_ms`, `bound_by`, `bound_term`: the least time the card could
    take, the largest of the operations over the published dense peak for
    their type, the exps over the SFU's rate, and the bytes (each input
    read once, each output written once) over 3.35 TB/s (NVIDIA's H100 SXM
    data sheet); `bound_by` is "operations" (exps included) or "bytes",
    and `bound_term` names the term: the operations' type, "exp" or
    "bytes";
  * `library_ms`, `library`, `library_kernel`: one PyTorch call that
    computes the same function on the same inputs, its name, and the
    kernel that took most of its device time (for attention: the backend
    PyTorch chose); None where there is none. The port never calls it;
  * `device_ms`, `library_device_ms`: the device time alone of the kernel
    and of the library call, without the host's launch overhead.
"""

from __future__ import annotations

import functools
import itertools
import math

import torch
import torch.nn.functional as F

from anyedit_tpu_torch.ops.attention import (
    flash_attention, flash_attention_plain, flash_int8, flash_int8_plain,
    flash_nomax, flash_nomax_plain, flash_sdpa, flash_sdpa_plain, sdpa,
)
from anyedit_tpu_torch.ops.groupnorm import group_norm, group_norm_plain
from anyedit_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
from anyedit_tpu_torch.ops.quant import (
    absmax_scale, int8_conv2d, int8_matmul, quantize_int8,
)


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


# Published dense peaks of one H100 SXM (at its 700 W limit).
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_TF32 = 494.7e12    # FLOP/s, tensor cores
PEAK_FP32 = 67e12       # FLOP/s, outside the tensor cores
PEAK_INT8 = 1979e12     # OP/s, tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_NAMES = {PEAK_BF16: "bf16 tensor", PEAK_TF32: "tf32 tensor", PEAK_FP32: "fp32",
              PEAK_INT8: "int8 tensor"}
# exp2 (MUFU) results a clock on one SM of compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), and the H100's SMs
EXP_PER_CLOCK_SM = 16
SMS = 132


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, from `nvidia-smi --query-gpu=clocks.max.sm`."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


@functools.cache
def exp_per_s() -> float:
    """The SFU's exp2 rate: 16 a clock an SM x 132 SMs x the highest SM clock."""
    return EXP_PER_CLOCK_SM * SMS * max_sm_clock_hz()


def roofline(ops: float, peak: float, nbytes: float, exps: float = 0.0) -> dict:
    """bound_ms = max(ops / peak, exps / SFU rate, bytes / HBM rate), and
    which one binds."""
    terms = {PEAK_NAMES[peak]: ops / peak * 1e3,
             "exp": exps / exp_per_s() * 1e3 if exps else 0.0,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_term": term,
            "bound_by": "bytes" if term == "bytes" else "operations"}


def _kernel_us(fn, iters: int, tries: int = 3) -> list[tuple[str, float]]:
    """(kernel name, device microseconds in all) over `iters` calls of
    `fn()` after a warm-up, from `torch.profiler`. CUPTI now and then
    delivers no kernel records for a short session; such a session is run
    again, up to `tries` times in all, and [] means that none saw any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            rows.append((e.key, e.self_cuda_time_total if us is None else us))
        if sum(us for _, us in rows) > 0:
            return rows
    return []


def device_profile(fn, iters: int = 10) -> tuple[float, str]:
    """(device ms per call, name of the kernel with the most device time)
    of `fn()`. Unlike `time_ms` this leaves out the host's launch overhead,
    which bounds `time_ms` for kernels of a few microseconds; the name says
    which backend a PyTorch call took. Where the profiler saw no device
    time, the ms are `time_ms`'s (CUDA events) and the name says so."""
    rows = _kernel_us(fn, iters)
    if not rows:
        return time_ms(fn, iters), NO_PROFILE
    name = max(rows, key=lambda r: r[1])[0]
    return sum(us for _, us in rows) / iters / 1e3, name[:120]


NO_PROFILE = "unknown: the profiler saw no device time, CUDA events instead"


def named_device_ms(fn, name: str, iters: int = 10) -> float | None:
    """Device ms per call of `fn()` in the kernels whose name holds `name`:
    a hand kernel alone, without the PyTorch ops its wrapper runs around it.
    None where the profiler saw no device time."""
    rows = _kernel_us(fn, iters)
    if not rows:
        return None
    return sum(us for key, us in rows if name in key) / iters / 1e3


def _timings(res: dict, kernel, plain, library, iters: int) -> None:
    """ms / plain_ms / library_ms: CUDA events around back-to-back calls;
    device_ms / library_device_ms: device time alone (`device_profile`)."""
    res["ms"] = time_ms(kernel, iters)
    res["device_ms"] = device_profile(kernel, iters)[0]
    res["plain_ms"] = time_ms(plain, iters)
    if library is None:
        res["library_ms"] = res["library_device_ms"] = None
        return
    res["library_ms"] = time_ms(library, iters)
    res["library_device_ms"], res["library_kernel"] = device_profile(library, iters)


def _sdpa(q, k, v, scale: float):
    """`F.scaled_dot_product_attention` on (1, BH, L, D) views of q, k, v."""
    q4, k4, v4 = (t[None] for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)


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
    _timings(res, lambda: flash_nomax(q, k, v, scale),
             lambda: flash_nomax_plain(q, k, v, scale), _sdpa(q, k, v, scale), iters)
    res["library"] = "F.scaled_dot_product_attention"
    res["tflops"] = 4 * bh * l * l * d / res["ms"] * 1e-9
    res.update(roofline(4 * bh * l * l * d, PEAK_BF16, 4 * q.numel() * 2, exps=bh * l * l))
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
    (the |mean| / std = 1e3 cancellation case). `gbps` counts one read and
    one write of x over the kernel's time."""
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
    ws, bs = scale.to(dtype), bias.to(dtype)
    if silu:
        lib = lambda: F.silu(F.group_norm(x, 32, ws, bs, 1e-5))
    else:
        lib = lambda: F.group_norm(x, 32, ws, bs, 1e-5)
    _timings(res, lambda: group_norm(x, scale, bias, 32, silu=silu),
             lambda: group_norm_plain(x, scale, bias, 32, silu=silu), lib, iters)
    res["library"] = "F.group_norm, then F.silu (two calls)" if silu else "F.group_norm"
    res["gbps"] = 2 * x.numel() * x.element_size() / res["device_ms"] * 1e-6
    # about 10 fp32 operations an element (two statistics passes, the
    # affine, SiLU) and SiLU's exp; the bytes bind by far
    res.update(roofline(10 * x.numel(), PEAK_FP32,
                        2 * x.numel() * x.element_size() + 2 * c * 4,
                        exps=x.numel() if silu else 0))
    return res


def _layer_norm_inputs(shape, in_dtype, device, seed: int):
    """x of `shape` (rows, C) in `in_dtype`, N(0, 1) scaled by 4 with
    per-row offsets up to 8 (each row's mean matters), and fp32 weight and
    bias near 1 and 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows, c = shape
    x = torch.randn(shape, generator=g, device=device) * 4 \
        + 8 * torch.rand((rows, 1), generator=g, device=device)
    weight = torch.randn(c, generator=g, device=device) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=device) * 0.1
    return x.to(in_dtype), weight, bias


# The H100's L2: an input smaller than this, read again at once, comes from
# the L2 and not from HBM
L2_BYTES = 50 * 2 ** 20


def _rotation(x: torch.Tensor, out_bytes: int) -> list:
    """x and copies of it, so many that they and one output of `out_bytes`
    each hold more than twice the L2: a timing that takes them in turn reads
    every input from HBM."""
    per = x.numel() * x.element_size() + out_bytes
    return [x] + [x.clone() for _ in range(2 * L2_BYTES // per + 1)]


def _rotated(fn, xs: list):
    """`fn(x)` over `xs` in turn, each output kept until its input comes
    round again (so the outputs rotate through as many buffers)."""
    outs, turn = [None] * len(xs), itertools.count()

    def call():
        i = next(turn) % len(xs)
        outs[i] = None
        outs[i] = fn(xs[i])
    return call


def check_layer_norm(shape, in_dtype, out_dtype, device, eps: float = 1e-5,
                     seed: int = 7, iters: int = 10) -> dict:
    """K5 vs its plain version on one (rows, C) input in `in_dtype`, output
    in `out_dtype`: `max_abs_err`, `mean_abs_err`, `bf16_ulps` (the largest
    distance in bf16 roundings, `_bf16_ulps`) and `rel_err` (the largest
    distance over the largest |plain output|). `launches`: K5's in one call.
    Every time is taken over a rotation of copies of x larger than the L2
    (`_rotation`, `copies` of them), so each call reads its input from HBM.
    `gbps` counts one read of x and one write of y over the kernel's device
    time, and `bound_share` is `bound_ms` over that time. The library call
    is `F.layer_norm` on x with the affine in x's dtype, then a cast where
    the output dtype differs (two calls)."""
    x, weight, bias = _layer_norm_inputs(shape, in_dtype, device, seed)
    n0 = layer_norm.launches
    out = layer_norm(x, weight, bias, eps, out_dtype)
    res = {"launches": layer_norm.launches - n0, "dtype": str(out.dtype)}
    ref = layer_norm_plain(x, weight, bias, eps, out_dtype)
    res.update(_errors(out, ref))
    res["bf16_ulps"] = _bf16_ulps(out, ref)
    res["rel_err"] = res["max_abs_err"] / float(ref.float().abs().max())
    del ref
    c = shape[1]
    xs = _rotation(x, out.numel() * out.element_size())
    res["copies"] = len(xs)
    wl, bl = weight.to(in_dtype), bias.to(in_dtype)
    if out_dtype == in_dtype:
        lib = lambda x: F.layer_norm(x, (c,), wl, bl, eps)
    else:
        lib = lambda x: F.layer_norm(x, (c,), wl, bl, eps).to(out_dtype)
    _timings(res, _rotated(lambda x: layer_norm(x, weight, bias, eps, out_dtype), xs),
             _rotated(lambda x: layer_norm_plain(x, weight, bias, eps, out_dtype), xs),
             _rotated(lib, xs), iters)
    res["library"] = ("F.layer_norm" if out_dtype == in_dtype
                      else "F.layer_norm, then a cast (two calls)")
    nbytes = x.numel() * (x.element_size() + out.element_size()) + 2 * c * 4
    res["gbps"] = nbytes / res["device_ms"] * 1e-6
    # about 8 fp32 operations an element (two sums, the centring, the
    # square, the affine); the bytes bind by far
    res.update(roofline(8 * x.numel(), PEAK_FP32, nbytes))
    res["bound_share"] = res["bound_ms"] / res["device_ms"]
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
                          dtype=torch.bfloat16, kv_len: int | None = None,
                          seed: int = 2, iters: int = 10) -> dict:
    """K3 vs its plain version on N(0, 1) q/k/v: q (bh, lq, d), k/v
    (bh, lkv, d), keys at or past `kv_len` (default lkv) masked.
    `bf16_ulps` is the largest difference in bf16 roundings of the output
    (the bound for bf16 inputs is 1); fp32 inputs are held to max_abs_err."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bh, lq, d, generator=g, device=device).to(dtype)
    k, v = (torch.randn(bh, lkv, d, generator=g, device=device).to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    kv_len = lkv if kv_len is None else kv_len
    out = flash_attention(q, k, v, scale, kv_len)
    ref = flash_attention_plain(q, k, v, scale, kv_len)
    res = _errors(out, ref)
    res["bf16_ulps"] = _bf16_ulps(out, ref)
    kv = (t[:, :kv_len].float() for t in (k, v))
    _timings(res, lambda: flash_attention(q, k, v, scale, kv_len),
             lambda: flash_attention_plain(q, k, v, scale, kv_len),
             _sdpa(q.float(), *kv, scale), iters)
    res["library"] = "F.scaled_dot_product_attention on fp32 copies"
    res["tflops"] = 4 * bh * lq * kv_len * d / res["ms"] * 1e-9
    # tensor-core products: the bf16 peak for bf16 inputs, TF32's for fp32
    # (3xTF32 runs three TF32 products for each); one exp a logit
    res.update(roofline(4 * bh * lq * kv_len * d,
                        PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32,
                        (2 * q.numel() + 2 * bh * kv_len * d) * q.element_size(),
                        exps=bh * lq * kv_len))
    return res


def check_flash_sdpa(b: int, h: int, l: int, device, seed: int = 3, iters: int = 10) -> dict:
    """K6 vs its plain version and vs `sdpa` (the route it replaces in Flux)
    on N(0, 1) bf16 q, k, v of (b, h, l, 128), each launch followed by a
    synchronise: `max_abs_err`, `mean_abs_err`, `bf16_ulps` and `rel_l2`
    against the plain version, `max_abs_sdpa` and `rel_l2_sdpa` against
    `sdpa`, and `strided_equal`: v handed as Flux's single block has it (a
    permuted (B, L, H, D) view) gives the same bits. `launches`: K6's over
    those two calls. Times: `kernel_device_ms` is K6 alone (the kernels
    named `flash_sdpa_kernel`), `device_ms` the call's device time, `ms`
    the call with the wrapper's host work, `plain_ms` the plain version,
    `sdpa_ms` the plain `sdpa`, and the library call
    `F.scaled_dot_product_attention` on the same bf16 tensors. The bound is
    K1's (`k1_bound_s` in the benchmark's roofline): QK^T and P.V on the
    bf16 tensor cores, one exp a logit, q, k, v read and o written once."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, 128, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    n0 = flash_sdpa.launches
    out = flash_sdpa(q, k, v)
    torch.cuda.synchronize()
    strided = flash_sdpa(q, k, v.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    res = {"launches": flash_sdpa.launches - n0, "strided_equal": bool(torch.equal(out, strided))}
    ref = flash_sdpa_plain(q, k, v)
    res.update(_errors(out, ref))
    res["bf16_ulps"] = _bf16_ulps(out, ref)
    res["rel_l2"] = float((out.float() - ref.float()).norm() / ref.float().norm())
    base = sdpa(q, k, v).float()
    res["max_abs_sdpa"] = float((out.float() - base).abs().max())
    res["rel_l2_sdpa"] = float((out.float() - base).norm() / base.norm())
    del ref, base, strided
    _timings(res, lambda: flash_sdpa(q, k, v), lambda: flash_sdpa_plain(q, k, v),
             lambda: F.scaled_dot_product_attention(q, k, v), iters)
    res["library"] = "F.scaled_dot_product_attention on the same bf16 tensors"
    res["kernel_device_ms"] = named_device_ms(lambda: flash_sdpa(q, k, v),
                                              "flash_sdpa_kernel", iters)
    res["sdpa_ms"] = time_ms(lambda: sdpa(q, k, v), iters)
    flops = 4 * b * h * l * l * 128
    res["tflops"] = flops / res["kernel_device_ms"] * 1e-9 if res["kernel_device_ms"] else None
    res.update(roofline(flops, PEAK_BF16, 4 * q.numel() * q.element_size(), exps=b * h * l * l))
    return res


def check_flash_int8(bh: int, l: int, d: int, device, dtype=torch.bfloat16,
                     kv_len: int | None = None, block_k: int = 512,
                     seed: int = 3, iters: int = 10) -> dict:
    """K4 vs its plain version on N(0, 1) q/k/v (bh, l, d) at the same key
    blocks, keys at or past `kv_len` (default l) masked, and its relative L2
    distance to fp32 `sdpa` over the unmasked keys (`rel_l2_sdpa`; the JAX
    package bounds it by 0.03 at (2, 1024, 128) in fp32,
    tests/test_quant.py:207)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(bh, l, d, generator=g, device=device).to(dtype)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    kv_len = l if kv_len is None else kv_len
    out = flash_int8(q, k, v, scale, kv_len, block_k)
    res = _errors(out, flash_int8_plain(q, k, v, scale, kv_len, block_k))
    exact = sdpa(q.float()[:, None], *(t[:, None, :kv_len].float() for t in (k, v)),
                 scale=scale)[:, 0]
    res["rel_l2_sdpa"] = float((out.float() - exact).norm() / exact.norm())
    _timings(res, lambda: flash_int8(q, k, v, scale, kv_len, block_k),
             lambda: flash_int8_plain(q, k, v, scale, kv_len, block_k), None, iters)
    # the wrapper quantizes k and v and writes their layout with PyTorch ops
    res["kernel_device_ms"] = named_device_ms(
        lambda: flash_int8(q, k, v, scale, kv_len, block_k), "flash_int8_kernel", iters)
    res["library"] = ("none: no PyTorch call computes attention with the /127 "
                      "probability grid and int8 products")
    res["tops"] = 4 * bh * l * kv_len * d / res["ms"] * 1e-9
    res.update(roofline(4 * bh * l * kv_len * d, PEAK_INT8,
                        4 * q.numel() * q.element_size(), exps=bh * l * kv_len))
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


def check_div_ties(device, seed: int = 4) -> dict:
    """The W8A8 quantization on the card (absmax scale, then codes) against
    the CPU's, byte for byte, on two tensors full of x / s = 63.5 ties
    (x = absmax / 2, s = absmax / 127): K4's v at (24, 4096, 40) bf16,
    quantized per (head, channel) as `_quantize_kv` does, and 65,536 rows
    of 64 bf16 values, each row holding its absmax and 32 values of
    +-absmax / 2. `mismatches` counts the codes that differ from the CPU's;
    `scalar_div_mismatches` those of scales taken as `amax / 127.0` on the
    card (PyTorch's reciprocal multiply, the parent's `absmax_scale`);
    `ties` the elements whose quotient lies within 1e-5 of +-63.5."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(24, 4096, 40, generator=g, device=device).to(torch.bfloat16)
    amax = (1 + torch.rand(65536, 1, generator=g, device=device)).to(torch.bfloat16)
    rows = ((torch.rand(65536, 64, generator=g, device=device) * 2 - 1) * 0.99 * amax
            ).to(torch.bfloat16)
    rows[:, :1] = amax
    rows[:, 1:17] = amax / 2
    rows[:, 17:33] = -amax / 2
    res = {"mismatches": 0, "scalar_div_mismatches": 0, "ties": 0, "codes": 0}
    for x, dim in ((v, 1), (rows, -1)):
        ref = quantize_int8(x.cpu(), absmax_scale(x.cpu(), dim))
        scale = absmax_scale(x, dim)
        got = quantize_int8(x, scale).cpu()
        amax_x = torch.linalg.vector_norm(x, float("inf"), dim=dim, keepdim=True).float()
        scalar = quantize_int8(x, torch.clamp(amax_x, min=1e-8) / 127.0).cpu()
        q = (x.double() / scale.double()).abs()
        res["mismatches"] += int((got != ref).sum())
        res["scalar_div_mismatches"] += int((scalar != ref).sum())
        res["ties"] += int(((q - 63.5).abs() < 1e-5).sum())
        res["codes"] += x.numel()
    return res


# ---- backward passes (the trainers' route) --------------------------------

def _grad_errors(got, ref) -> dict:
    """Largest absolute and relative-L2 distance over a list of gradients."""
    diffs = [(a.float() - b.float()) for a, b in zip(got, ref)]
    return {"max_abs_err": max(float(d.abs().max()) for d in diffs),
            "rel_l2": max(float(d.norm() / b.float().norm().clamp(min=1e-30))
                          for d, b in zip(diffs, ref)),
            "finite": all(bool(torch.isfinite(a.float()).all()) for a in got)}


def _bwd_ms(fn, inputs, grad, iters: int) -> float:
    """ms of the backward alone: `fn(*inputs)` once, then
    `torch.autograd.grad` over its graph, kept between runs."""
    out = fn(*inputs)
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True), iters)


def _fwd_bwd_ms(fn, inputs, grad, iters: int) -> float:
    return time_ms(lambda: torch.autograd.grad(fn(*inputs), inputs, grad), iters)


def check_flash_nomax_grad(bh: int, l: int, d: int, device, seed: int = 5,
                           iters: int = 5) -> dict:
    """K1 under grad (`attention`'s route: K1 forward, the recompute
    backward through `sdpa`) against the autograd of K1's plain version, on
    the same N(0, 1) bf16 q, k, v of shape (1, bh, l, d) and a N(0, 1) bf16
    output gradient. `max_abs_err` and `rel_l2` are the worst over dq, dk,
    dv; `fwd_max_abs_err`, `fwd_mean_abs_err` and `fwd_finite` hold the
    Function's output against the plain version's; `launches` counts K1 in
    one forward and backward (1: the backward launches none). Times: `fwd_ms` (the Function's forward), `ms` (its
    backward alone), `plain_ms` (the plain version's backward alone),
    `library_ms` (`F.scaled_dot_product_attention`'s backward alone) and
    `library_fwd_bwd_ms`, `fwd_bwd_ms` (both passes). `bound_ms` is the
    backward's: 2.5x the forward's tensor-core operations (the products
    QK^T and PV again, then dP, dQ, dK, dV, half of which the forward's
    two stand for), one exp a logit, and q, k, v, dO read and dq, dk, dv
    written once."""
    from anyedit_tpu_torch.ops.attention import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(1, bh, l, d, generator=g, device=device).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    ins = [t.requires_grad_() for t in (q, k, v)]

    def plain(q, k, v):
        return flash_nomax_plain(q[0], k[0], v[0], scale)[None]

    n0 = flash_nomax.launches
    out = attention(*ins, scale=scale)
    got = torch.autograd.grad(out, ins, do)
    res = {"launches": flash_nomax.launches - n0, "has_grad_fn": out.grad_fn is not None}
    ref = plain(*ins)
    res.update(_grad_errors(got, torch.autograd.grad(ref, ins, do)))
    res.update({f"fwd_{k}": x for k, x in _errors(out.detach(), ref.detach()).items()})
    lib = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=scale)
    fn = lambda q, k, v: attention(q, k, v, scale=scale)
    with torch.no_grad():
        res["fwd_ms"] = time_ms(lambda: attention(q, k, v, scale=scale), iters)
    res["ms"] = _bwd_ms(fn, ins, do, iters)
    res["fwd_bwd_ms"] = _fwd_bwd_ms(fn, ins, do, iters)
    res["plain_ms"] = _bwd_ms(plain, ins, do, iters)
    res["library_ms"] = _bwd_ms(lib, ins, do, iters)
    res["library_fwd_bwd_ms"] = _fwd_bwd_ms(lib, ins, do, iters)
    res["library"] = "F.scaled_dot_product_attention, backward"
    res.update(roofline(2.5 * 4 * bh * l * l * d, PEAK_BF16, 7 * q.numel() * 2,
                        exps=bh * l * l))
    return res


def check_group_norm_grad(shape, silu: bool, device, seed: int = 6,
                          iters: int = 5) -> dict:
    """K2 under grad (`group_norm`'s route: K2 forward, the recompute
    backward through `group_norm_plain`) against the autograd of the plain
    version, on the same bf16 x of `shape` (NCHW, 32 groups), fp32 scale
    and bias near 1 and 0, and a N(0, 1) bf16 output gradient: dx, dscale,
    dbias, and the output (`fwd_*`, as `check_flash_nomax_grad`'s). Times as `check_flash_nomax_grad`'s; the library is
    `F.group_norm` (then `F.silu`) on bf16 copies of the affine. `bound_ms`
    is the backward's: x and dy read, dx written, the affine and its
    gradients once."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    dy = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    scale = (torch.randn(c, generator=g, device=device) * 0.1 + 1)
    bias = torch.randn(c, generator=g, device=device) * 0.1
    ins = [t.requires_grad_() for t in (x, scale, bias)]
    fn = lambda x, s, b: group_norm(x, s, b, 32, silu=silu)
    plain = lambda x, s, b: group_norm_plain(x, s, b, 32, silu=silu)

    n0 = group_norm.launches
    out = fn(*ins)
    got = torch.autograd.grad(out, ins, dy)
    res = {"launches": group_norm.launches - n0, "has_grad_fn": out.grad_fn is not None}
    ref = plain(*ins)
    res.update(_grad_errors(got, torch.autograd.grad(ref, ins, dy)))
    res.update({f"fwd_{k}": x for k, x in _errors(out.detach(), ref.detach()).items()})
    lib_ins = [x, scale.detach().to(torch.bfloat16).requires_grad_(),
               bias.detach().to(torch.bfloat16).requires_grad_()]
    if silu:
        lib = lambda x, s, b: F.silu(F.group_norm(x, 32, s, b, 1e-5))
    else:
        lib = lambda x, s, b: F.group_norm(x, 32, s, b, 1e-5)
    with torch.no_grad():
        res["fwd_ms"] = time_ms(lambda: fn(x, scale, bias), iters)
    res["ms"] = _bwd_ms(fn, ins, dy, iters)
    res["fwd_bwd_ms"] = _fwd_bwd_ms(fn, ins, dy, iters)
    res["plain_ms"] = _bwd_ms(plain, ins, dy, iters)
    res["library_ms"] = _bwd_ms(lib, lib_ins, dy, iters)
    res["library_fwd_bwd_ms"] = _fwd_bwd_ms(lib, lib_ins, dy, iters)
    res["library"] = ("F.group_norm, then F.silu, backward" if silu
                      else "F.group_norm, backward")
    res.update(roofline(20 * x.numel(), PEAK_FP32, 3 * x.numel() * 2 + 4 * c * 4,
                        exps=x.numel() if silu else 0))
    return res


def check_layer_norm_grad(shape, device, eps: float = 1e-5, seed: int = 8,
                          iters: int = 5) -> dict:
    """K5 under grad (`layer_norm`'s route: K5 forward, the recompute
    backward through `layer_norm_plain`) against the autograd of the plain
    version, on the same bf16 x of `shape` (rows, C), fp32 weight and bias
    near 1 and 0, bf16 output and a N(0, 1) bf16 output gradient: dx,
    dweight, dbias, and the output (`fwd_*`, as `check_flash_nomax_grad`'s).
    Times as `check_flash_nomax_grad`'s; the library is `F.layer_norm` on
    bf16 copies of the affine. `bound_ms` is the backward's: x and dy read,
    dx written, the affine and its gradients once."""
    x, weight, bias = _layer_norm_inputs(shape, torch.bfloat16, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    ins = [t.requires_grad_() for t in (x, weight, bias)]
    fn = lambda x, w, b: layer_norm(x, w, b, eps, torch.bfloat16)
    plain = lambda x, w, b: layer_norm_plain(x, w, b, eps, torch.bfloat16)

    n0 = layer_norm.launches
    out = fn(*ins)
    got = torch.autograd.grad(out, ins, dy)
    res = {"launches": layer_norm.launches - n0, "has_grad_fn": out.grad_fn is not None}
    ref = plain(*ins)
    res.update(_grad_errors(got, torch.autograd.grad(ref, ins, dy)))
    res.update({f"fwd_{k}": v for k, v in _errors(out.detach(), ref.detach()).items()})
    res["fwd_bf16_ulps"] = _bf16_ulps(out.detach(), ref.detach())
    c = shape[1]
    lib_ins = [x, weight.detach().to(torch.bfloat16).requires_grad_(),
               bias.detach().to(torch.bfloat16).requires_grad_()]
    lib = lambda x, w, b: F.layer_norm(x, (c,), w, b, eps)
    with torch.no_grad():
        res["fwd_ms"] = time_ms(lambda: fn(x, weight, bias), iters)
    res["ms"] = _bwd_ms(fn, ins, dy, iters)
    res["fwd_bwd_ms"] = _fwd_bwd_ms(fn, ins, dy, iters)
    res["plain_ms"] = _bwd_ms(plain, ins, dy, iters)
    res["library_ms"] = _bwd_ms(lib, lib_ins, dy, iters)
    res["library_fwd_bwd_ms"] = _fwd_bwd_ms(lib, lib_ins, dy, iters)
    res["library"] = "F.layer_norm, backward"
    # the backward's ~20 small kernels can outrun the host's launches: its
    # device time alone, against the events' `ms`
    y = fn(*ins)
    res["bwd_device_ms"], _ = device_profile(
        lambda: torch.autograd.grad(y, ins, dy, retain_graph=True), iters)
    res.update(roofline(16 * x.numel(), PEAK_FP32, 3 * x.numel() * 2 + 4 * c * 4))
    return res
