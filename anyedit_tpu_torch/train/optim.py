"""`optax.chain(clip_by_global_norm(max_norm), adamw(lr))` written out, at
optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0 and a weight decay
of 1e-4 on every leaf (torch's AdamW decays at 1e-2 by default). The clip
scales by max_norm / norm only when norm >= max_norm, with no epsilon
(`torch.nn.utils.clip_grad_norm_` adds 1e-6). Both trainers use it.

State: {"count": int, "mu": {name: fp32}, "nu": {name: fp32}}; params are
updated in place.
"""

from __future__ import annotations

from typing import Mapping

import torch


class ClippedAdamW:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4, max_norm: float = 1.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                state: dict) -> dict:
        """One step on fp32 `params` (in place) from `grads`; returns the
        new state (its moments updated in place)."""
        grads = {k: g.float() for k, g in grads.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        for k, p in params.items():
            g = torch.where(norm < self.max_norm, grads[k], grads[k] / norm * self.max_norm)
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.add_(-self.lr * upd)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}
