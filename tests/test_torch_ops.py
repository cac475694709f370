"""Ops of the PyTorch port against the JAX package's ops.

Inputs are drawn with numpy and handed to both sides. The JAX Pallas
kernels run as `tests/test_ops.py` runs them (`interpret=True`); on the CPU
the port's wrappers take their plain versions. The hand kernels themselves
are tested in `test_torch_kernels.py`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.ops.attention import attention as jax_attention
from anyedit_tpu.ops.attention import flash_attention as jax_flash_attention
from anyedit_tpu.ops.attention import flash_int8 as jax_flash_int8
from anyedit_tpu.ops.attention import flash_nomax as jax_flash_nomax, sdpa_xla
from anyedit_tpu.ops.groupnorm import group_norm as jax_group_norm
from anyedit_tpu.ops.resize import denormalize_to_u8 as jax_denorm
from anyedit_tpu.ops.resize import resize_image as jax_resize
from anyedit_tpu_torch.ops import attention as tattn
from anyedit_tpu_torch.ops import groupnorm as tgn
from anyedit_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---- attention ----------------------------------------------------------

def test_flash_nomax_plain_matches_jax_kernel_bf16():
    """K1's plain version vs the Pallas kernel (interpret mode) at
    (4, 1024, 40 -> 128 padded) in bf16: mean-abs <= 2e-3 (test_ops.py:180)."""
    rng = np.random.default_rng(0)
    bh, l, d = 4, 1024, 40
    q, k, v = (rng.standard_normal((bh, l, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    pad = ((0, 0), (0, 0), (0, 128 - d))
    jq, jk, jv = (jnp.pad(jnp.asarray(a, jnp.bfloat16), pad) for a in (q, k, v))
    ref = jax_flash_nomax(jq, jk, jv, scale=scale, interpret=True)[..., :d]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tattn.flash_nomax(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (bh, l, d)
    err = np.abs(_np(out) - _np(ref))
    assert err.mean() <= 2e-3, err.mean()


@pytest.mark.parametrize("lq,lkv,d", [(1024, 1024, 40), (300, 77, 40)])
def test_attention_matches_sdpa_xla(lq, lkv, d):
    """`attention()` vs `sdpa_xla` in fp32 (1e-5), on K1's route (1024
    self-attention tokens) and off it (300 x 77 cross-attention)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 2, lq, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, lkv, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, lkv, d)).astype(np.float32)
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lq,lkv,d", [(256, 256, 64), (300, 77, 40), (128, 512, 80)])
def test_flash_attention_plain_matches_jax_use_flash(lq, lkv, d):
    """`attention(use_flash=True)` (K3's plain version on the CPU) vs the
    JAX `attention(use_flash=True, interpret=True)` (the Pallas kernel with
    its pads) at the test_ops.py:17 shapes, fp32: 2e-5."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 3, lq, d)).astype(np.float32)
    k = rng.standard_normal((2, 3, lkv, d)).astype(np.float32)
    v = rng.standard_normal((2, 3, lkv, d)).astype(np.float32)
    ref = jax_attention(*(jnp.asarray(a) for a in (q, k, v)), use_flash=True,
                        interpret=True)
    out = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)), use_flash=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


def test_flash_attention_kv_len_masks_key_padding():
    """Keys past `kv_len` are masked, as in the JAX kernel: the same zero-
    padded k/v (77 keys padded to 128) through `flash_attention` and the
    Pallas kernel agree at 2e-5 in fp32 (q padded to the JAX block)."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((6, 64, 40)).astype(np.float32)
    k, v = (np.pad(rng.standard_normal((6, 77, 40)), ((0, 0), (0, 51), (0, 0)))
            .astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(40)
    pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, 88)))
    ref = jax_flash_attention(pad(q), pad(k), pad(v), scale, kv_len=77, block_q=64,
                              block_k=128, interpret=True)[..., :40]
    out = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                                kv_len=77)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


# K6's lengths: Flux-schnell's joint sequence at the benchmark's T5 length
# (256 + 1,024 tokens), at the zoo's default T5 length (77 + 1,024: a ragged
# last key block), and one shorter than a block
K6_LENGTHS = [1280, 1101, 77]


def _k6_inputs(l, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, 2, l, 128)).astype(np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("l", K6_LENGTHS)
def test_flash_sdpa_plain_matches_sdpa_fp32(l):
    """K6's plain version (`flash_sdpa` on CPU tensors) vs `sdpa` in fp32:
    the online softmax over 128-key blocks is the same function, within
    1e-5."""
    q, k, v = _k6_inputs(l, 20)
    out = tattn.flash_sdpa(q, k, v)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(tattn.sdpa(q, k, v)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("l", K6_LENGTHS)
def test_flash_sdpa_plain_matches_sdpa_bf16(l):
    """The same in bf16. Both round the probabilities to bf16 for P.V, at
    different points: `sdpa` the normalised p, K6 the unnormalised p (at
    most 1) before the row sum is divided out. Each p carries at most 2^-9
    relative rounding on either side, so the outputs differ by at most
    2^-8 max|v|, plus each output's own bf16 rounding (2^-9 relative)."""
    q, k, v = _k6_inputs(l, 21, torch.bfloat16)
    out = tattn.flash_sdpa_plain(q, k, v)
    ref = tattn.sdpa(q, k, v)
    assert out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs()
    tol = 2 ** -8 * float(v.float().abs().max()) + 2 ** -8 * float(ref.float().abs().max())
    assert float(err.max()) <= tol, (float(err.max()), tol)


@pytest.mark.parametrize("l", K6_LENGTHS)
def test_flash_sdpa_plain_matches_sdpa_xla(l):
    """K6's plain version vs the JAX package's `sdpa_xla`, which Flux runs
    there, in fp32: 1e-5."""
    q, k, v = _k6_inputs(l, 22)
    ref = sdpa_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(_np(tattn.flash_sdpa_plain(q, k, v)), _np(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("block_k", [64, 512])
@pytest.mark.parametrize("l,d,kv_len", [(512, 40, None), (256, 80, 200), (1000, 40, None)])
def test_flash_int8_plain_matches_jax_kernel(l, d, kv_len, block_k):
    """K4's plain version vs the Pallas kernel (interpret mode, D padded to
    128 as `_self_attn_int8` does, the same key blocks), fp32 inputs:
    max-abs 1e-3 and mean-abs 1e-5. The JAX side takes L padded with zero
    keys to a whole number of blocks and the true key count as `kv_len`
    (L = 1000 against 1024 at block 512: a short last block); the port
    takes L as it is. The quantization is the same; what differs is fp32
    order, which flips the odd p8 = round(127 p) code."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((2, l, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    lp = -(-l // block_k) * block_k
    pad = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, lp - l), (0, 128 - d)))
    ref = jax_flash_int8(pad(q), pad(k), pad(v), scale, block_q=lp // 2, block_k=block_k,
                         kv_len=l if kv_len is None else kv_len, interpret=True)[:, :l, :d]
    out = tattn.flash_int8(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                           kv_len=kv_len, block_k=block_k)
    err = np.abs(_np(out) - _np(ref))
    assert err.max() <= 1e-3 and err.mean() <= 1e-5, (err.max(), err.mean())


def test_self_attn_int8_matches_jax_default_blocks():
    """`self_attn_int8` at (1, 2, 1024, 40) against what the JAX
    `_self_attn_int8` runs: `flash_int8` at its default 512-key blocks on D
    padded to 128 (interpret mode), fp32: max-abs 1e-3 and mean-abs 1e-5.
    Rounded on 64-key tiles instead, p8 lands on another grid: mean-abs
    5.7e-4."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((1, 2, 1024, 40)).astype(np.float32) for _ in range(3))
    scale = 1.0 / math.sqrt(40)
    pad = lambda a: jnp.pad(jnp.asarray(a[0]), ((0, 0), (0, 0), (0, 88)))
    ref = jax_flash_int8(pad(q), pad(k), pad(v), scale, block_q=512, block_k=512,
                         interpret=True)[..., :40]
    out = tattn.self_attn_int8(*(torch.from_numpy(a) for a in (q, k, v)))
    err = np.abs(_np(out[0]) - _np(ref))
    assert err.max() <= 1e-3 and err.mean() <= 1e-5, (err.max(), err.mean())


def test_self_attn_int8_tracks_sdpa():
    """`self_attn_int8` over (B, H, L, D) is `flash_int8` per head, and stays
    within the JAX package's bound of fp32 sdpa (relative L2 < 0.03,
    test_quant.py:207)."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 40)).astype(np.float32))
               for _ in range(3))
    out = tattn.self_attn_int8(q, k, v)
    heads = tattn.flash_int8(q[0], k[0], v[0], 1.0 / math.sqrt(40))
    torch.testing.assert_close(out[0], heads, rtol=0, atol=0)
    ref = _np(sdpa_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v))))
    assert np.linalg.norm(_np(out) - ref) / np.linalg.norm(ref) < 0.03


# ---- groupnorm ----------------------------------------------------------

def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_plain_matches_jax_kernel(silu):
    """K2's plain version vs the Pallas kernel (interpret mode): 1e-5
    (test_ops.py:38)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    scale = (rng.standard_normal(128) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.1).astype(np.float32)
    ref = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                         num_groups=32, silu=silu, use_pallas=True, interpret=True)
    out = tgn.group_norm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                         num_groups=32, silu=silu)
    np.testing.assert_allclose(_np(out).transpose(0, 2, 3, 1), _np(ref),
                               atol=1e-5, rtol=1e-5)


def test_group_norm_plain_high_magnitude_flat():
    """|mean|/std = 1e3: the pooled two-pass variance must not cancel;
    2e-3 against the Pallas kernel (test_ops.py:49)."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1, 1, 1, 320)) * 0.01 + 100.0
    x = (np.broadcast_to(base, (2, 16, 16, 320))
         + rng.standard_normal((2, 16, 16, 320)) * 0.1).astype(np.float32)
    ones, zeros = np.ones(320, np.float32), np.zeros(320, np.float32)
    ref = jax_group_norm(jnp.asarray(x), jnp.asarray(ones), jnp.asarray(zeros),
                         num_groups=32, silu=True, use_pallas=True, interpret=True)
    out = tgn.group_norm(_nchw(x), torch.from_numpy(ones), torch.from_numpy(zeros),
                         num_groups=32, silu=True)
    np.testing.assert_allclose(_np(out).transpose(0, 2, 3, 1), _np(ref),
                               atol=2e-3, rtol=2e-3)


def test_group_norm_module_matches_jax_layers_module_bf16():
    """The port's GroupNorm module vs the JAX `layers.GroupNorm` the kernel
    replaces, in bf16 at an SD shape: 3e-2, bf16 output quanta
    (test_ops.py:68)."""
    from anyedit_tpu.models.layers import GroupNorm as JaxGroupNorm
    from anyedit_tpu_torch.models.layers import GroupNorm
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 16, 16, 320)) * 3.0 + 5.0).astype(np.float32)
    scale = (rng.standard_normal(320) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(320) * 0.1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = JaxGroupNorm(num_groups=32, silu=True).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, xb)
    gn = GroupNorm(320, 32, silu=True)
    gn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    out = gn(_nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out).transpose(0, 2, 3, 1), _np(ref),
                               atol=3e-2, rtol=3e-2)


# ---- resize -------------------------------------------------------------

@pytest.mark.parametrize("method", ["lanczos", "bilinear"])
@pytest.mark.parametrize("src,dst", [((48, 40), (64, 64)), ((64, 64), (48, 40)),
                                     ((37, 53), (64, 21)), ((48, 40), (48, 40))])
def test_resize_matches_jax_image_resize(method, src, dst):
    """`resize_image` vs `jax.image.resize` (antialiased lanczos3 and
    bilinear, down, up, mixed, and same shape = identity): atol 1e-3 on the
    0-255 scale."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, src + (3,)).astype(np.float32)
    ref = jax_resize(jnp.asarray(img), *dst, method)
    out = tresize.resize_image(torch.from_numpy(img), *dst, method)
    assert tuple(out.shape) == dst + (3,)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-3, rtol=0)
    if src == dst:
        np.testing.assert_array_equal(_np(out), img)


def test_u8_conversions_match_jax():
    """denormalize_to_u8 rounds half to even; the float -> uint8 cast
    saturates and truncates, as a JAX `astype(uint8)` does."""
    x = np.array([-1.5, -1.0, -0.9960785, 0.5, 1.0 / 255, 0.99, 1.0, 1.7],
                 np.float32)
    np.testing.assert_array_equal(tresize.denormalize_to_u8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_denorm(jnp.asarray(x))))
    y = np.array([-300.0, -3.7, -0.5, 0.4, 1.5, 2.5, 254.9, 255.6, 300.0], np.float32)
    np.testing.assert_array_equal(tresize.to_u8(torch.from_numpy(y)).numpy(),
                                  np.asarray(jnp.asarray(y).astype(jnp.uint8)))
