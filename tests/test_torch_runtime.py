"""The port's entry point targets the card unless the caller asks for the
CPU, and never falls back to it. No JAX here."""

import pytest
import torch

from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config


def test_zoo_defaults_to_the_card():
    """`ModelZoo()` with no device targets CUDA; nothing is built yet."""
    zoo = ModelZoo(tiny_zoo_config())
    assert zoo.device.type == "cuda" and zoo._cache == {}


def test_zoo_on_the_card_raises_without_cuda(monkeypatch):
    """Building a model for the card where CUDA is absent raises; it does
    not move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = ModelZoo(tiny_zoo_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo._vae()
    assert zoo._cache == {}


def test_zoo_on_the_cpu_when_asked():
    """device='cpu' builds the slot's models on the CPU."""
    zoo = ModelZoo(tiny_zoo_config(), device="cpu")
    assert next(zoo._vae().parameters()).device.type == "cpu"
