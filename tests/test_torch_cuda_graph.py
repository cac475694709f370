"""`ops/cuda_graph.py::Graphed`: a module's inference call replayed from a
CUDA graph, and the zoo's Flux samplers taking it.

On the CPU: calls on CPU tensors, and calls while autograd records, go to
the module itself and capture nothing; the zoo's Flux sampler wraps its Flux
module. On the card (`cuda`, skipped without one): the tiny Flux, in bf16
and in W8A8, replayed against its eager call on fresh inputs of one
signature, one graph a signature, and weights copied in place reaching the
replay.
"""

import dataclasses

import pytest
import torch

from anyedit_tpu_torch.models.flux import TINY_FLUX, Flux
from anyedit_tpu_torch.ops.cuda_graph import Graphed
from anyedit_tpu_torch.ops.quant import quantize_state_dict
from anyedit_tpu_torch.runtime import zoo as zoo_mod

torch.set_num_threads(1)
BF16 = dataclasses.replace(TINY_FLUX, dtype=torch.bfloat16)


@pytest.fixture
def cuda():
    """The card; skips where there is none (a CUDA graph has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed: int, device, hw: int = 8):
    g = torch.Generator().manual_seed(seed)
    c = TINY_FLUX
    args = (torch.randn(1, hw, hw, c.in_channels, generator=g),
            torch.rand(1, generator=g) * 1000,
            torch.randn(1, 6, c.context_dim, generator=g).to(torch.bfloat16),
            torch.randn(1, c.pooled_dim, generator=g))
    return tuple(a.to(device) for a in args)


def test_cpu_calls_go_to_the_module():
    m = Flux(BF16, device="cpu").eval()
    g = Graphed(m)
    assert g.cfg is m.cfg
    args = _inputs(0, "cpu")
    with torch.inference_mode():
        assert torch.equal(g(*args), m(*args))
    assert g.graphs == {}


def test_recording_calls_go_to_the_module():
    """A call while autograd records is the module's, gradients and all."""
    m = Flux(BF16, device="cpu")
    out = Graphed(m)(*_inputs(1, "cpu"))
    assert out.requires_grad
    out.float().sum().backward()
    assert m.proj_out.weight.grad is not None


def test_the_zoo_flux_sampler_wraps_its_flux(monkeypatch):
    wrapped = []

    class Spy(Graphed):
        def __init__(self, module):
            super().__init__(module)
            wrapped.append(module)

    monkeypatch.setattr(zoo_mod, "Graphed", Spy)
    zoo = zoo_mod.ModelZoo(zoo_mod.tiny_zoo_config(), device="cpu", seed=0)
    zoo.flux_pair_fn()
    assert wrapped == [zoo._cache["flux"]]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_replay_matches_the_eager_call(cuda, quant):
    """Fresh inputs of one signature replay one graph and give the eager
    call's velocity: the replay runs the kernels the capture recorded, on
    the copied inputs, so within 1e-5 of the largest value (the libraries may
    take another GEMM algorithm under capture: fp32 sums in another order).
    Another latent size captures a second graph. W8A8 as well."""
    if quant:
        float_m = Flux(BF16, device="cpu")
        m = Flux(dataclasses.replace(BF16, quant=True), device="meta")
        q = quantize_state_dict(m, {k: v.float() for k, v in float_m.state_dict().items()})
        m.load_state_dict({k: v.to(cuda) for k, v in q.items()}, strict=True, assign=True)
    else:
        m = Flux(BF16, device=cuda)
    m.eval()
    g = Graphed(m)
    with torch.inference_mode():
        for seed in (2, 3, 4):
            args = _inputs(seed, cuda)
            got, want = g(*args), m(*args)
            assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
        assert len(g.graphs) == 1
        args = _inputs(5, cuda, hw=4)
        assert g(*args).shape == m(*args).shape
        assert len(g.graphs) == 2


@pytest.mark.cuda
def test_weights_copied_in_place_reach_the_replay(cuda):
    m = Flux(BF16, device=cuda).eval()
    g = Graphed(m)
    args = _inputs(6, cuda)
    with torch.inference_mode():
        before = g(*args)
        m.proj_out.bias.copy_(m.proj_out.bias + 1)
        after = g(*args)
        want = m(*args)
    assert not torch.allclose(before, after)
    assert torch.allclose(after, want, rtol=0, atol=1e-5 * float(want.abs().max()))
