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
