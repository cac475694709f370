"""The port's hand kernels and their wrappers, without JAX.

Tests marked `cuda` hold K1-K4 against their plain versions, and the W8A8
int8 contraction against float64, on the card, and skip without one. This file imports no JAX, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import math

import pytest
import torch

from anyedit_tpu_torch.ops import attention as tattn
from anyedit_tpu_torch.ops import groupnorm as tgn
from anyedit_tpu_torch.ops import kernel_check as kc

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, for tests of the hand kernels; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("lq,lkv,d,routed", [
    (4096, 4096, 40, True), (1024, 1024, 80, True), (256, 256, 160, False),
    (1024, 77, 40, False), (1536, 1536, 40, True), (1000, 1000, 40, False),
    (4096, 4096, 512, False)])
def test_attention_route(monkeypatch, lq, lkv, d, routed):
    """K1 takes Lq == Lkv >= 1024, Lq % 512 == 0, D <= 128 (the JAX route)."""
    calls = []
    monkeypatch.setattr(tattn, "flash_nomax",
                        lambda q, k, v, s: calls.append(q.shape) or q)
    monkeypatch.setattr(tattn, "sdpa", lambda q, k, v, scale: q)
    q = torch.zeros(1, 1, lq, d)
    tattn.attention(q, torch.zeros(1, 1, lkv, d), torch.zeros(1, 1, lkv, d))
    assert calls == ([(1, lq, d)] if routed else [])


@pytest.mark.parametrize("use_flash", [None, False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("lq,lkv,d", [(4096, 4096, 40), (1024, 77, 80), (64, 64, 160)])
def test_attention_route_use_flash_and_int8(monkeypatch, use_flash, int8, lq, lkv, d):
    """use_flash=True sends every shape to K3 (keys masked at the true Lkv),
    False every shape to sdpa, None takes K1's route; `int8` changes
    nothing (the JAX route: `attention()` never reads it)."""
    calls = []
    monkeypatch.setattr(tattn, "flash_nomax",
                        lambda q, k, v, s: calls.append("k1") or q)
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda q, k, v, s: calls.append(("k3", k.shape[1])) or q)
    monkeypatch.setattr(tattn, "flash_int8", lambda *a, **kw: calls.append("k4"))
    monkeypatch.setattr(tattn, "sdpa", lambda q, k, v, scale: calls.append("sdpa") or q)
    q = torch.zeros(1, 1, lq, d)
    kv = torch.zeros(1, 1, lkv, d)
    tattn.attention(q, kv, kv, use_flash=use_flash, int8=int8)
    want = {True: [("k3", lkv)], False: ["sdpa"],
            None: ["k1" if lq == lkv == 4096 else "sdpa"]}[use_flash]
    assert calls == want


def test_flash_nomax_clamp_saturates_not_overflows():
    """Logits beyond the clamp saturate to a uniform softmax (test_ops.py:201)."""
    q = torch.full((1, 512, 128), 30.0, dtype=torch.bfloat16)
    v = torch.ones((1, 512, 128), dtype=torch.bfloat16)
    out = tattn.flash_nomax(q, q, v, 1.0).float()
    assert torch.isfinite(out).all()
    assert float((out - 1.0).abs().max()) < 1e-2


@pytest.mark.parametrize("op", ["flash_nomax", "group_norm", "flash_attention",
                                "flash_int8", "int8_matmul"])
def test_wrappers_raise_off_cpu_and_cuda(op):
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""
    x = torch.zeros(1, 64, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if op == "group_norm":
            c = torch.zeros(64, device="meta")
            tgn.group_norm(x, c, c, num_groups=8)
        elif op == "int8_matmul":
            from anyedit_tpu_torch.ops.quant import int8_matmul
            a = torch.zeros(32, 8, dtype=torch.int8, device="meta")
            int8_matmul(a, a.t())
        else:
            getattr(tattn, op)(x, x, x, 1.0)


# Every GroupNorm shape of the main path (NCHW): the SD1.5 IP2P UNet at
# batch 3 (one request, 3-way CFG) and 24 (the bench's batch 8), and the SD
# VAE's encoder and decoder at 512 px.
UNET_NORMS = [(320, 32, 32), (320, 64, 64), (640, 16, 16), (640, 32, 32),
              (640, 64, 64), (960, 32, 32), (960, 64, 64), (1280, 8, 8),
              (1280, 16, 16), (1280, 32, 32), (1920, 16, 16), (1920, 32, 32),
              (2560, 8, 8), (2560, 16, 16)]
VAE_NORMS = [(128, 256, 256), (128, 512, 512), (256, 128, 128), (256, 256, 256),
             (256, 512, 512), (512, 64, 64), (512, 128, 128), (512, 256, 256)]
MAIN_PATH_NORMS = ([(b,) + s for b in (3, 24) for s in UNET_NORMS]
                   + [(1,) + s for s in VAE_NORMS])


@pytest.mark.parametrize("shape", MAIN_PATH_NORMS, ids=str)
def test_k2_plan_covers_every_span(shape):
    """K2's launch plan at every main-path norm, in bf16 and fp32: the
    cluster's chunks cover each span exactly (no gap, no empty block), the
    chunks keep 16-byte steps, the shared memory stays within a block's
    227 KB, the cluster within 16 blocks, and the grid divides into whole
    clusters."""
    n, c, h, w = shape
    span = c // 32 * h * w
    for eb in (2, 4):
        cluster, chunk, cap, smem = tgn._k2_plan(n, c, h * w, 32, eb)
        assert cluster in (1, 2, 4, 8, 16)
        assert cluster * chunk >= span > (cluster - 1) * chunk
        assert chunk * eb % 16 == 0 and 0 < cap <= chunk
        assert cap * eb + 16 <= smem <= 232448 - 1024
        assert n * 32 * cluster % cluster == 0


@pytest.mark.parametrize("l", [64, 128, 192, 1024, 1536, 4096])
@pytest.mark.parametrize("d", [1, 36, 40, 48, 64, 80, 96, 128])
def test_k1_blocks_divide_l(l, d):
    """K1's block shape is one the kernel takes, and its q rows divide L."""
    warps, tiles = tattn._k1_blocks(l, d)
    assert (warps, tiles) in ((4, 1), (8, 1), (4, 2)) and (tiles == 1 or d <= 48)
    assert l % (16 * warps * tiles) == 0


# ---- the hand kernels on the card ---------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bh,l,d", [
    (16, 4096, 40), (16, 1024, 80), (2, 128, 128),
    (4, 64, 40), (4, 1024, 40), (4, 64, 80), (4, 1024, 80),
    (4, 64, 36), (4, 1024, 36), (4, 64, 128), (4, 1024, 128)])
def test_flash_nomax_kernel_matches_plain(cuda, bh, l, d):
    """K1 vs its plain version on the same bf16 inputs: mean-abs <= 2e-3,
    max-abs <= 3e-2 (bf16 output quanta; fp32 sums in another order).
    L = 64 takes 64-row blocks, L = 1024 128-row ones; D = 36 takes the
    plain-load path (rows are not whole 16-byte units) and D = 40 the k8
    tail of QK^T."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(bh, l, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    before = tattn.flash_nomax.launches
    out = tattn.flash_nomax(q, k, v, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert tattn.flash_nomax.launches == before + 1
    err = (out.float() - tattn.flash_nomax_plain(q, k, v, 1.0 / math.sqrt(d)).float()).abs()
    assert float(err.mean()) <= 2e-3 and float(err.max()) <= 3e-2


@pytest.mark.cuda
def test_flash_nomax_kernel_clamp(cuda):
    """Logits far past the clamp saturate to uniform weights on the card:
    the output equals v (= 1) within 1e-2 (chip_smoke.py's bound)."""
    r = kc.check_flash_nomax_clamp(cuda)
    assert r["finite"] and r["max_abs_err"] <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,silu,dtype,magnitude,reread", [
    ((2, 64, 7, 9), True, torch.bfloat16, 0.0, False),
    ((2, 64, 7, 9), True, torch.float32, 0.0, False),
    ((1, 64, 99, 101), True, torch.bfloat16, 0.0, False),
    ((1, 64, 99, 101), False, torch.float32, 0.0, False),
    ((1, 128, 512, 512), True, torch.bfloat16, 0.0, True),
    ((1, 128, 512, 512), False, torch.float32, 0.0, True),
    ((1, 128, 511, 513), True, torch.bfloat16, 0.0, True),
    ((2, 320, 16, 16), True, torch.float32, 100.0, False),
    ((1, 128, 512, 512), True, torch.float32, 100.0, True)])
def test_group_norm_kernel_regimes(cuda, shape, silu, dtype, magnitude, reread):
    """K2 vs its plain version where H*W is not a multiple of 8 (scalar
    head and tail), where a span is split over a cluster with chunks that
    start off 16-byte boundaries, where each chunk stays in shared memory
    and where part of it is read again from global memory (`reread`; with
    H*W odd at (1, 128, 511, 513)), in
    bf16 and fp32, and at |mean| / std = 1e3: max-abs <= 5e-2, mean-abs <=
    2e-3 (chip_smoke.py's bound); 1e-5 max-abs in fp32 without the offset."""
    n, c = shape[:2]
    hw = shape[2] * shape[3]
    _, chunk, cap, _ = tgn._k2_plan(n, c, hw, 32, torch.empty((), dtype=dtype).element_size())
    assert (chunk > cap) == reread
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda)
    if magnitude:
        x = magnitude + 1e-4 * magnitude * torch.randn((1, c, 1, 1), generator=g,
                                                       device=cuda) + 1e-3 * magnitude * x
    x = x.to(dtype)
    scale = torch.randn(c, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    out = tgn.group_norm(x, scale, bias, 32, silu=silu)
    torch.cuda.synchronize()
    err = (out.float() - tgn.group_norm_plain(x, scale, bias, 32, silu=silu).float()).abs()
    assert bool(torch.isfinite(out).all())
    if dtype == torch.float32 and not magnitude:
        assert float(err.max()) <= 1e-5
    else:
        assert float(err.max()) <= 5e-2 and float(err.mean()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,silu,dtype", [
    ((6, 320, 64, 64), True, torch.bfloat16), ((6, 640, 32, 32), False, torch.bfloat16),
    ((2, 64, 8, 8), True, torch.float32)])
def test_group_norm_kernel_matches_plain(cuda, shape, silu, dtype):
    """K2 vs its plain version on the same input: max-abs <= 5e-2 and
    mean-abs <= 2e-3 in bf16 (output quanta); 1e-5 in fp32."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda) * 3 + 1).to(dtype)
    c = shape[1]
    scale = torch.randn(c, generator=g, device=cuda) * 0.1 + 1
    bias = torch.randn(c, generator=g, device=cuda) * 0.1
    before = tgn.group_norm.launches
    out = tgn.group_norm(x, scale, bias, 32, silu=silu)
    torch.cuda.synchronize()
    assert tgn.group_norm.launches == before + 1
    err = (out.float() - tgn.group_norm_plain(x, scale, bias, 32, silu=silu).float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert float(err.max()) <= 5e-2 and float(err.mean()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lkv,d,dtype", [
    (24, 1024, 77, 80, torch.bfloat16), (24, 64, 64, 160, torch.bfloat16),
    (4, 1000, 1000, 40, torch.bfloat16), (6, 300, 77, 40, torch.float32)])
def test_flash_attention_kernel_matches_plain(cuda, bh, lq, lkv, d, dtype):
    """K3 vs its plain version: fp32 inputs within 2e-5 (test_ops.py:26);
    bf16 inputs within one bf16 rounding of the output plus 1e-5 for fp32
    sums taken in another order near zero."""
    before = tattn.flash_attention.launches
    r = kc.check_flash_attention(bh, lq, lkv, d, cuda, dtype=dtype, iters=1)
    assert tattn.flash_attention.launches > before and r["finite"]
    if dtype == torch.float32:
        assert r["max_abs_err"] <= 2e-5
    else:
        assert r["bf16_ulps"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bh,l,d", [(24, 1024, 80), (4, 1000, 40)])
def test_flash_int8_kernel_matches_plain(cuda, bh, l, d):
    """K4 vs its plain version on the same bf16 inputs (same quantization,
    same 64-key tiles): mean-abs <= 1e-4, max-abs <= 3e-2; and within the
    JAX package's relative-L2 bound of fp32 sdpa at these lengths (0.03)."""
    before = tattn.flash_int8.launches
    r = kc.check_flash_int8(bh, l, d, cuda, iters=1)
    assert tattn.flash_int8.launches > before and r["finite"]
    assert r["mean_abs_err"] <= 1e-4 and r["max_abs_err"] <= 3e-2
    assert r["rel_l2_sdpa"] < 0.03


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_int8_contraction_is_exact_on_the_card(cuda, kind):
    """The W8A8 int32 contraction (int8 im2col + torch._int_mm) equals a
    float64 contraction of the same full-range codes, bit for bit."""
    assert kc.check_int8_contraction(kind, cuda, iters=1)["exact"]
