"""The port's hand kernels and their wrappers, without JAX.

Tests marked `cuda` hold K1 and K2 against their plain versions on the
card and skip without one. This file imports no JAX, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import math

import pytest
import torch

from anyedit_tpu_torch.ops import attention as tattn
from anyedit_tpu_torch.ops import groupnorm as tgn

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


def test_flash_nomax_clamp_saturates_not_overflows():
    """Logits beyond the clamp saturate to a uniform softmax (test_ops.py:201)."""
    q = torch.full((1, 512, 128), 30.0, dtype=torch.bfloat16)
    v = torch.ones((1, 512, 128), dtype=torch.bfloat16)
    out = tattn.flash_nomax(q, q, v, 1.0).float()
    assert torch.isfinite(out).all()
    assert float((out - 1.0).abs().max()) < 1e-2


@pytest.mark.parametrize("op", ["flash_nomax", "group_norm"])
def test_wrappers_raise_off_cpu_and_cuda(op):
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""
    x = torch.zeros(1, 64, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if op == "flash_nomax":
            tattn.flash_nomax(x, x, x, 1.0)
        else:
            c = torch.zeros(64, device="meta")
            tgn.group_norm(x, c, c, num_groups=8)


# ---- the hand kernels on the card ---------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bh,l,d", [(16, 4096, 40), (16, 1024, 80), (2, 128, 128)])
def test_flash_nomax_kernel_matches_plain(cuda, bh, l, d):
    """K1 vs its plain version on the same bf16 inputs: mean-abs <= 2e-3,
    max-abs <= 3e-2 (bf16 output quanta; fp32 sums in another order)."""
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
