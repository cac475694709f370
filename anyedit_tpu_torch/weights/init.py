"""Seeded random parameters drawn on the device, with the Flax initializers'
distributions, so activation scales match the JAX package's random-init
runs:

  * Linear / Conv kernels: lecun-normal (truncated normal at +-2 std,
    variance 1/fan_in);
  * biases: zero; GroupNorm / LayerNorm scales one, biases zero;
  * token embeddings: Flax `Embed`'s truncated normal, variance 1/features;
  * the CLIP position embedding: normal(0.01) (the JAX `pos_emb` param).

Values differ from the JAX package's (torch and jax.random draw different
numbers); parity tests load JAX's params through `weights/bridge.py`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from anyedit_tpu_torch.models.layers import GroupNorm, LayerNorm

# std of a standard normal truncated to [-2, 2] (Flax's variance_scaling
# divides by it so that the truncated draw keeps the target variance)
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(shape, fan_in: int, generator: torch.Generator, device):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter of `module` in place, from `seed`, on the
    device the parameters live on. Returns the module."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, sub in module.named_modules():
        if isinstance(sub, (nn.Linear, nn.Conv2d)):
            w = sub.weight
            fan_in = w[0].numel()   # in * kh * kw
            w.copy_(_trunc_normal(w.shape, fan_in, gen, device))
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            w = sub.weight
            if name.endswith("position_embedding"):
                w.copy_(torch.randn(w.shape, generator=gen, device=device) * 0.01)
            else:
                w.copy_(_trunc_normal(w.shape, w.shape[1], gen, device))
        elif isinstance(sub, (GroupNorm, LayerNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
    return module
