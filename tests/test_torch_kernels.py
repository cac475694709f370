"""The port's hand kernels and their wrappers, without JAX.

Tests marked `cuda` hold K1-K6 against their plain versions, and the W8A8
int8 contraction against float64, on the card, and skip without one. This file imports no JAX, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import math
import re

import pytest
import torch

from anyedit_tpu_torch.models.layers import LayerNorm
from anyedit_tpu_torch.ops import _build
from anyedit_tpu_torch.ops import attention as tattn
from anyedit_tpu_torch.ops import groupnorm as tgn
from anyedit_tpu_torch.ops import kernel_check as kc
from anyedit_tpu_torch.ops import layernorm as tln

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
                                "flash_int8", "int8_matmul", "layer_norm", "flash_sdpa"])
def test_wrappers_raise_off_cpu_and_cuda(op):
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""
    x = torch.zeros(1, 64, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if op == "group_norm":
            c = torch.zeros(64, device="meta")
            tgn.group_norm(x, c, c, num_groups=8)
        elif op == "layer_norm":
            c = torch.zeros(8, device="meta")
            tln.layer_norm(x, c, c, 1e-5, torch.bfloat16)
        elif op == "int8_matmul":
            from anyedit_tpu_torch.ops.quant import int8_matmul
            a = torch.zeros(32, 8, dtype=torch.int8, device="meta")
            int8_matmul(a, a.t())
        else:
            getattr(tattn, op)(x, x, x, 1.0)


@pytest.mark.parametrize("x_dtype,dtype", [
    (torch.float16, torch.bfloat16), (torch.float64, torch.float32),
    (torch.float32, torch.float16), (torch.bfloat16, torch.float64)])
def test_layer_norm_raises_on_dtypes_k5_does_not_take(x_dtype, dtype):
    """Off the CPU, `layer_norm` takes bf16 or fp32 x and gives bf16 or fp32
    (K5's four instantiations); any other dtype raises before the device is
    looked at."""
    x = torch.zeros(4, 64, dtype=x_dtype, device="meta")
    c = torch.zeros(64, device="meta")
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tln.layer_norm(x, c, c, 1e-5, dtype)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_plain_route_is_the_layernorm_arithmetic(x_dtype, dtype):
    """On CPU tensors `layer_norm` and `models/layers.LayerNorm` compute what
    `LayerNorm.forward` computed before K5, bit for bit, with and without
    grad (the direct autograd of the plain ops, not K5's Function), and
    launch nothing."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, 48, generator=g) * 4 + 7).to(x_dtype)
    w = torch.randn(48, generator=g) * 0.1 + 1
    b = torch.randn(48, generator=g) * 0.1
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    want = ((xf - mean) * torch.rsqrt(var + 1e-6) * w + b).to(dtype)
    m = LayerNorm(48, eps=1e-6, dtype=dtype)
    m.load_state_dict({"weight": w, "bias": b})
    before = tln.layer_norm.launches
    with torch.no_grad():
        outs = [tln.layer_norm(x, w, b, 1e-6, dtype), m(x)]
    outs.append(m(x.clone().requires_grad_()))
    for got in outs:
        assert got.dtype == dtype and torch.equal(got, want)
    assert type(outs[-1].grad_fn).__name__ != "_LayerNormFnBackward"
    assert tln.layer_norm.launches == before


def test_layer_norm_function_routes_and_recomputes(monkeypatch):
    """Off the CPU, `layer_norm` under grad with an input that requires it
    goes through `_LayerNormFn`, and otherwise makes the direct call; the
    Function's backward is the plain version's autograd on the saved
    inputs, for whichever of x, weight and bias need it. The launch is
    replaced by the plain forward, so this runs on meta tensors (the route)
    and CPU tensors (the gradients)."""
    calls = []

    def launch(x, w, b, eps, dtype):
        calls.append(x.device.type)
        return tln.layer_norm_plain(x, w, b, eps, dtype).detach()
    monkeypatch.setattr(tln, "_layer_norm_launch", launch)
    x, c = torch.zeros(2, 8, device="meta"), torch.zeros(8, device="meta")
    assert tln.layer_norm(x, c, c, 1e-5, torch.bfloat16).grad_fn is None
    with torch.no_grad():
        assert tln.layer_norm(x, c.requires_grad_(), c, 1e-5, torch.bfloat16).grad_fn is None
    y = tln.layer_norm(x, c, c, 1e-5, torch.bfloat16)
    assert type(y.grad_fn).__name__ == "_LayerNormFnBackward" and calls == ["meta"] * 3

    g = torch.Generator().manual_seed(1)
    x = (torch.randn(6, 40, generator=g) * 3 + 2).to(torch.bfloat16)
    w = torch.randn(40, generator=g) * 0.1 + 1
    b = torch.randn(40, generator=g) * 0.1
    dy = torch.randn(6, 40, generator=g).to(torch.bfloat16)
    for need in ((True, True, True), (True, False, False), (False, True, True)):
        ins = [t.clone().requires_grad_(r) for t, r in zip((x, w, b), need)]
        wrt = [t for t in ins if t.requires_grad]
        y = tln._LayerNormFn.apply(launch, tln.layer_norm_plain, *ins, 1e-5, torch.bfloat16)
        got = torch.autograd.grad(y, wrt, dy)
        ref = torch.autograd.grad(tln.layer_norm_plain(*ins, 1e-5, torch.bfloat16), wrt, dy)
        assert all(torch.equal(a, r) for a, r in zip(got, ref))


# The LayerNorm widths of the port's models: GroundingDINO and SAM's neck
# (256), the SD UNets (320, 640, 1280), BERT, BLIP-2's Q-Former and CLIP-L
# text (768), CLIP-L vision (1024), EVA ViT-g (1408), DINOv2-g (1536), SAM
# ViT-H (1280), Swin-B's stages and patch merges (128 to 2048), SAM's
# upscaling (64).
MODEL_LN_WIDTHS = [64, 128, 256, 320, 512, 640, 768, 1024, 1280, 1408, 1536, 2048]


@pytest.mark.parametrize("c", MODEL_LN_WIDTHS + [20, 2056, 4096])
def test_k5_plan_covers_each_row(c):
    """K5's launch plan in bf16 and fp32, vector and scalar (up to 2,048,
    the scalar path's reach): the threads' accesses cover the row (no
    element left, none past a whole access),
    at most 8 accesses a thread, 1 to 8 warps a row in powers of two, at
    most 256 threads a block, several rows a block only for one-warp rows;
    one warp a row at every model width in bf16 (the registers hold it)."""
    for eb in (2, 4):
        for vector in (True, False):
            if vector and c * eb % 16 or not vector and c > 2048:
                continue
            vec, vpl, warps, rpb = tln._k5_plan(c, eb, vector)
            assert vec == (16 // eb if vector else 1) and c % vec == 0
            assert 32 * warps * vpl >= c // vec > 32 * warps * (vpl - 1)
            assert 1 <= vpl <= 8 and warps in (1, 2, 4, 8) and 32 * warps * rpb <= 256
            assert rpb == 1 or warps == 1
            if vector and eb == 2 and c in MODEL_LN_WIDTHS:
                assert warps == 1


def test_k5_plan_refuses_rows_past_its_registers():
    with pytest.raises(ValueError, match="at most 2048"):
        tln._k5_plan(2056, 2, False)


def test_signatures_hold_every_entry_point():
    """`_build._SIGNATURES` holds each C entry point of csrc/*.cu that
    returns an error code (K5's `anyedit_layer_norm` among them), with one
    argument type per parameter."""
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = len(m.group(2).split(","))
    assert "anyedit_layer_norm" in found
    assert found == {name: len(types) for name, types in _build._SIGNATURES.items()}


# Every GroupNorm shape of the main path (NCHW): the SD1.5 IP2P UNet at
# batch 3 (one request, 3-way CFG) and 24 (the bench's batch 8), and the SD
# VAE's encoder and decoder at 512 px, and GroundingDINO's input projections
# at 800 px (strides 8, 16, 32 and the extra stride-2 level: short, odd spans).
UNET_NORMS = [(320, 32, 32), (320, 64, 64), (640, 16, 16), (640, 32, 32),
              (640, 64, 64), (960, 32, 32), (960, 64, 64), (1280, 8, 8),
              (1280, 16, 16), (1280, 32, 32), (1920, 16, 16), (1920, 32, 32),
              (2560, 8, 8), (2560, 16, 16)]
VAE_NORMS = [(128, 256, 256), (128, 512, 512), (256, 128, 128), (256, 256, 256),
             (256, 512, 512), (512, 64, 64), (512, 128, 128), (512, 256, 256)]
GDINO_NORMS = [(256, 100, 100), (256, 50, 50), (256, 25, 25), (256, 13, 13)]
MAIN_PATH_NORMS = ([(b,) + s for b in (3, 24) for s in UNET_NORMS]
                   + [(1,) + s for s in VAE_NORMS + GDINO_NORMS])


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


@pytest.mark.parametrize("bh,l,d", [(2, 1000, 40), (1, 64, 128), (3, 77, 1), (2, 4096, 80)])
def test_k4_layout_round_trips(bh, l, d):
    """`k4_layout` pads k8 to (BH, round64(L), round16(D)) with zeros and
    writes v8 transposed and padded, the keys of each 32-key group in
    `_k4_key_order` (a permutation): undoing the order and the transpose
    gives v8 back, and every pad byte is zero."""
    g = torch.Generator().manual_seed(0)
    k8, v8 = (torch.randint(-127, 128, (bh, l, d), generator=g).to(torch.int8)
              for _ in range(2))
    kp, vt = tattn.k4_layout(k8, v8)
    lp, dp = -(-l // 64) * 64, -(-d // 16) * 16
    assert kp.shape == (bh, lp, dp) and vt.shape == (bh, dp, lp)
    assert kp.dtype == vt.dtype == torch.int8 and vt.is_contiguous()
    order = tattn._k4_key_order()
    assert sorted(order) == list(range(32))
    inverse = torch.tensor(order).argsort()
    v_back = vt.view(bh, dp, lp // 32, 32)[..., inverse].reshape(bh, dp, lp).transpose(1, 2)
    assert torch.equal(kp[:, :l, :d], k8) and torch.equal(v_back[:, :l, :d], v8)
    assert not kp[:, l:].any() and not kp[..., d:].any()
    assert not v_back[:, l:].any() and not v_back[..., d:].any()


def test_k4_fragments_compute_p_dot_v():
    """The register path of K4's P.V, emulated lane by lane for one 32-key
    group: P8 packed from m16n8 accumulators as the kernel packs it, v8ᵀ
    read from `k4_layout` as `ldmatrix` reads it, through the PTX fragment
    layouts of `mma.m16n8k32.s8`, equals P8 . V8."""
    g = torch.Generator().manual_seed(1)
    p8 = torch.randint(0, 128, (16, 32), generator=g)
    v8 = torch.randint(-127, 128, (1, 32, 8), generator=g).to(torch.int8)
    _, vt = tattn.k4_layout(v8, v8)
    vt = vt[0, :8, :32].long()                       # (channels, keys in K4's order)
    a = torch.zeros(16, 32, dtype=torch.long)        # the MMA's logical A
    b = torch.zeros(32, 8, dtype=torch.long)         # and B
    for lane in range(32):
        gr, t = lane // 4, lane % 4
        for half in range(2):                        # a0/a1, then a2/a3
            keys = [16 * half + 2 * t, 16 * half + 2 * t + 1,   # accumulator pairs
                    16 * half + 8 + 2 * t, 16 * half + 9 + 2 * t]  # of two n8 tiles
            for i, key in enumerate(keys):
                a[gr, 16 * half + 4 * t + i] = p8[gr, key]
                a[gr + 8, 16 * half + 4 * t + i] = p8[gr + 8, key]
                b[16 * half + 4 * t + i, gr] = vt[gr, 16 * half + 4 * t + i]
    assert torch.equal(a @ b, p8 @ v8[0].long())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as `cvt.rna.tf32.f32` does: the 13 low mantissa
    bits dropped, to nearest, ties away from zero."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _k3_split_emulation(q, k, v, scale, block_k):
    """K3's arithmetic in torch, tile by tile: base-2 online softmax with
    ex2 on the scaled logits; bf16 inputs: exact products and p split into
    bf16 hi + lo for P.V; fp32 inputs: 3xTF32 for both products."""
    if q.dtype == torch.bfloat16:
        qf, kf, vf = q.float(), k.float(), v.float()
        mm = torch.matmul

        def pv(p, vt):
            hi = p.to(torch.bfloat16).float()
            return mm(hi, vt) + mm((p - hi).to(torch.bfloat16).float(), vt)
    else:
        qf, kf, vf = q, k, v

        def mm(a, b):
            ab, bb = _tf32(a), _tf32(b)
            return mm_f(_tf32(a - ab), bb) + mm_f(ab, _tf32(b - bb)) + mm_f(ab, bb)
        mm_f = torch.matmul
        pv = mm
    qk_scale = scale * 1.4426950408889634
    m = torch.full(q.shape[:2] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, k.shape[1], block_k):
        s = mm(qf, kf[:, k0:k0 + block_k].transpose(1, 2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * qk_scale)
        p = torch.exp2(s * qk_scale - m_new)
        c = torch.exp2(m - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + pv(p, vf[:, k0:k0 + block_k])
        m = m_new
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,lq,lkv,d", [(2, 64, 77, 40), (2, 37, 200, 80),
                                         (1, 48, 77, 160), (1, 20, 96, 256)])
def test_k3_split_arithmetic_holds_the_card_bounds(dtype, bh, lq, lkv, d):
    """K3's numeric recipe, emulated in torch, within the card's bounds of
    `flash_attention_plain`: bf16 inputs (exact products, p = bf16 hi + lo
    for P.V) within one bf16 rounding of the output; fp32 inputs (3xTF32
    for both products) within 2e-5 max-abs. One TF32 pass misses it."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(bh, lq, d, generator=g).to(dtype)
    k, v = (torch.randn(bh, lkv, d, generator=g).to(dtype) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    ref = tattn.flash_attention_plain(q, k, v, scale)
    out = _k3_split_emulation(q, k, v, scale, 64 if d <= 128 else 32)
    if dtype == torch.bfloat16:
        assert kc._bf16_ulps(out, ref) <= 1.0
    else:
        assert float((out - ref).abs().max()) <= 2e-5
        one_pass = torch.softmax(torch.matmul(_tf32(q), _tf32(k).transpose(1, 2)) * scale, -1)
        one_pass = torch.matmul(_tf32(one_pass), _tf32(v))
        assert float((one_pass - ref).abs().max()) > 2e-5


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
@pytest.mark.parametrize("b,h,l", [(1, 24, 1280), (1, 24, 1101), (2, 24, 1280), (1, 2, 77)])
def test_flash_sdpa_kernel_matches_plain(cuda, b, h, l):
    """K6 vs its plain version on the same bf16 inputs at Flux's 24 heads
    and D 128 (1,280 and the ragged 1,101 joint tokens, batch 2, a sequence
    shorter than a key tile): max-abs <= 8e-3 and relative L2 <= 1e-3 (fp32
    sums in another order and `ex2.approx` move a p or an output across a
    bf16 rounding boundary). v as Flux's single block hands it, a permuted
    (B, L, H, D) view, gives the same bits; the result is a (B, H, L, D)
    view of a (B, L, H, D) buffer."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, h, l, 128, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    before = tattn.flash_sdpa.launches
    out = tattn.flash_sdpa(q, k, v)
    torch.cuda.synchronize()
    strided = tattn.flash_sdpa(q, k, v.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    assert tattn.flash_sdpa.launches == before + 2
    assert out.shape == q.shape and out.permute(0, 2, 1, 3).is_contiguous()
    assert torch.equal(out, strided)
    ref = tattn.flash_sdpa_plain(q, k, v).float()
    err = out.float() - ref
    assert float(err.abs().max()) <= 8e-3 and float(err.norm() / ref.norm()) <= 1e-3


@pytest.mark.cuda
def test_flash_sdpa_kernel_refuses_what_it_does_not_take(cuda):
    """K6 takes bf16 at D 128 with strides a multiple of 8: fp32, another D
    and an odd row stride raise, and nothing launches."""
    x = torch.zeros(1, 2, 64, 128, device=cuda, dtype=torch.bfloat16)
    before = tattn.flash_sdpa.launches
    with pytest.raises(TypeError, match="bf16"):
        tattn.flash_sdpa(x.float(), x.float(), x.float())
    with pytest.raises(ValueError, match="shape"):
        y = x[..., :64]
        tattn.flash_sdpa(y, y, y)
    odd = torch.zeros(1, 2, 64, 132, device=cuda, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="stride"):
        tattn.flash_sdpa(odd, x, x)
    assert tattn.flash_sdpa.launches == before


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
@pytest.mark.parametrize("shape,x_dtype,dtype,offset", [
    ((49152, 320), torch.bfloat16, torch.bfloat16, 0), ((300, 1280), torch.bfloat16,
                                                         torch.bfloat16, 0),
    ((1000, 256), torch.float32, torch.bfloat16, 0), ((77, 768), torch.float32,
                                                      torch.float32, 0),
    ((64, 2048), torch.bfloat16, torch.float32, 0), ((33, 4096), torch.bfloat16,
                                                     torch.bfloat16, 0),
    ((33, 4096), torch.float32, torch.float32, 0), ((50, 37), torch.bfloat16,
                                                    torch.bfloat16, 0),
    ((50, 320), torch.bfloat16, torch.bfloat16, 1)])
def test_layer_norm_kernel_matches_plain(cuda, shape, x_dtype, dtype, offset):
    """K5 vs its plain version on the same input, one launch: a bf16 output
    within one bf16 rounding, an fp32 one within 1e-5 of the largest
    |output|. One-warp rows (320 to 2,048), rows of 2 to 4 warps (4,096),
    the scalar path where C is not a multiple of the vector (37) or x
    starts off a 16-byte boundary (`offset` elements in), all four dtype
    pairs."""
    x, w, b = kc._layer_norm_inputs((shape[0], shape[1] + offset), x_dtype, cuda, 3)
    x = x.flatten()[offset:offset + shape[0] * shape[1]].view(shape)
    w, b = w[:shape[1]], b[:shape[1]]
    before = tln.layer_norm.launches
    out = tln.layer_norm(x, w, b, 1e-5, dtype)
    torch.cuda.synchronize()
    assert tln.layer_norm.launches == before + 1 and out.dtype == dtype
    ref = tln.layer_norm_plain(x, w, b, 1e-5, dtype)
    assert bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        assert kc._bf16_ulps(out, ref) <= 1.0
    else:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_layer_norm_kernel_takes_a_strided_input(cuda):
    """The transformer's token view of NCHW activations (B, HW, C) is not
    contiguous: `LayerNorm` copies it first and K5 agrees with the plain
    version on it."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 320, 16, 16, generator=g, device=cuda).to(torch.bfloat16)
    x = x.permute(0, 2, 3, 1).reshape(2, 256, 320)
    assert not x.is_contiguous()
    m = LayerNorm(320, device=cuda)
    with torch.no_grad():
        out = m(x)
        assert kc._bf16_ulps(out, tln.layer_norm_plain(x, m.weight, m.bias)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lkv,d,dtype,kv_len", [
    (24, 1024, 77, 80, torch.bfloat16, None), (24, 64, 64, 160, torch.bfloat16, None),
    (4, 1000, 1000, 40, torch.bfloat16, None), (6, 300, 77, 40, torch.float32, None),
    (2, 100, 300, 256, torch.bfloat16, None), (2, 100, 300, 256, torch.float32, None),
    (4, 200, 77, 160, torch.float32, None), (3, 77, 130, 80, torch.bfloat16, 100),
    (2, 50, 128, 36, torch.bfloat16, 77), (2, 50, 128, 36, torch.float32, 77)])
def test_flash_attention_kernel_matches_plain(cuda, bh, lq, lkv, d, dtype, kv_len):
    """K3 vs its plain version: fp32 inputs within 2e-5 (test_ops.py:26);
    bf16 inputs within one bf16 rounding of the output plus 1e-5 for fp32
    sums taken in another order near zero. Covers D = 256 (Q fragments read
    from shared memory), fp32 at D = 160 and 256, Lq not a multiple of the
    block's rows, keys masked at kv_len < Lkv, and D = 36 (plain loads)."""
    before = tattn.flash_attention.launches
    r = kc.check_flash_attention(bh, lq, lkv, d, cuda, dtype=dtype, kv_len=kv_len, iters=1)
    assert tattn.flash_attention.launches > before and r["finite"]
    if dtype == torch.float32:
        assert r["max_abs_err"] <= 2e-5
    else:
        assert r["bf16_ulps"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bh,l,d,dtype,kv_len,block_k", [
    (24, 1024, 80, torch.bfloat16, None, 512), (4, 1000, 40, torch.bfloat16, None, 512),
    (4, 1000, 40, torch.bfloat16, 900, 512), (4, 1000, 40, torch.bfloat16, 900, 64),
    (2, 1024, 128, torch.float32, None, 512), (2, 300, 16, torch.float32, None, 128)])
def test_flash_int8_kernel_matches_plain(cuda, bh, l, d, dtype, kv_len, block_k):
    """K4 vs its plain version on the same inputs (same quantization, same
    key blocks; L = 1000 ends in a short block, kv_len < L masks keys, and
    block 64 against block 512): mean-abs <= 1e-4, max-abs <= 3e-2; and
    within the JAX package's relative-L2 bound of fp32 sdpa at these
    lengths (0.03)."""
    before = tattn.flash_int8.launches
    r = kc.check_flash_int8(bh, l, d, cuda, dtype=dtype, kv_len=kv_len, block_k=block_k,
                            iters=1)
    assert tattn.flash_int8.launches > before and r["finite"]
    assert r["mean_abs_err"] <= 1e-4 and r["max_abs_err"] <= 3e-2
    assert r["rel_l2_sdpa"] < 0.03


@pytest.mark.cuda
@pytest.mark.parametrize("bh,l,d,dtype", [(24, 4096, 40, torch.bfloat16),
                                         (4, 1000, 80, torch.float32), (3, 77, 1, torch.bfloat16),
                                         (2, 300, 128, torch.bfloat16)])
def test_k4_quantize_kernel_writes_the_layout(cuda, bh, l, d, dtype):
    """K4's quantization kernels write, byte for byte, what `_quantize_kv`
    and `k4_layout` give on the CPU (codes, pads, v8ᵀ's key order), and the
    bits of k's and v's absmaxes. The reference runs on the CPU, whose
    division is correctly rounded as the kernel's and JAX's are: PyTorch's
    CUDA division rounds some ties x / s = 63.5 (x = absmax / 2) the other
    way."""
    g = torch.Generator(device=cuda).manual_seed(4)
    k, v = (torch.randn(bh, l, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    k8, v8t, scratch = tattn._k4_quantize(k, v)
    torch.cuda.synchronize()
    rk8, rv8, _, _ = tattn._quantize_kv(k.cpu(), v.cpu())
    rk8, rv8t = tattn.k4_layout(rk8, rv8)
    assert torch.equal(k8.cpu(), rk8) and torch.equal(v8t.cpu(), rv8t)
    amax = scratch.view(torch.float32)
    assert float(amax[0]) == float(k.abs().max())
    assert torch.equal(amax[1:].view(bh, d), v.abs().amax(1).float())


@pytest.mark.cuda
def test_flash_int8_kernel_rounds_on_its_blocks(cuda):
    """The block size changes K4's result as it changes the JAX kernel's:
    at (4, 1024, 40) the kernel at block 512 is far closer to the plain
    version at block 512 than to the plain version at block 64."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(4, 1024, 40, generator=g, device=cuda) for _ in range(3))
    out = tattn.flash_int8(q, k, v, 40 ** -0.5)
    same = (out - tattn.flash_int8_plain(q, k, v, 40 ** -0.5)).abs().mean()
    other = (out - tattn.flash_int8_plain(q, k, v, 40 ** -0.5, block_k=64)).abs().mean()
    assert float(same) <= 1e-5 < float(other)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_int8_contraction_is_exact_on_the_card(cuda, kind):
    """The W8A8 int32 contraction (int8 im2col + torch._int_mm) equals a
    float64 contraction of the same full-range codes, bit for bit."""
    assert kc.check_int8_contraction(kind, cuda, iters=1)["exact"]
