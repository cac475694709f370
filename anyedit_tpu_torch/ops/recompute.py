"""The trainers' route through a hand kernel: its forward, and a backward
that recomputes through its plain version.

A kernel writes into a fresh tensor through a raw pointer, so its output has
no autograd history of its own. `Recompute.apply(launch, plain, *args)`
returns `launch(*args)` and saves the tensor arguments; its backward is the
autograd of `plain(*args)` at those saved tensors, for each that needs a
gradient, and launches no kernel (the JAX package's recompute VJPs). Each
kernel names a subclass of its own, so a grad_fn says which kernel made it
and a caller can patch one kernel's `apply`.
"""

from __future__ import annotations

import torch


class Recompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.where = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*(args[i] for i in ctx.where))
        ctx.args = [None if isinstance(a, torch.Tensor) else a for a in args]
        return launch(*args)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        args = list(ctx.args)
        with torch.enable_grad():
            for i, t in zip(ctx.where, ctx.saved_tensors):
                args[i] = t.detach().requires_grad_(need[i])
            wrt = [i for i in ctx.where if need[i]]
            got = dict(zip(wrt, torch.autograd.grad(ctx.plain(*args), [args[i] for i in wrt],
                                                    grad)))
        return (None, None) + tuple(got.get(i) for i in range(len(args)))
