"""Seeded weights, made on the device by the benchmark and handed to both the
program and the reference.

Each module's weights come from one `torch.randn` over all its parameters,
drawn by a `torch.Generator` on the device seeded from (run seed, module
name), then cut into the parameters in name order and scaled by kind
(`reference.nets.parameter_spec`): matrices by 1 / sqrt(fan in) (Lecun's
normal), norm scales 1 + 0.1 n, biases 0.02 n, embeddings by their std; each
cast to the dtype the parameter is served in."""

from __future__ import annotations

import torch

from portbench.reference import nets
from portbench.reference.edit import sub_seed


def served_dtype(cfg: dict) -> torch.dtype:
    """The dtype a configuration states for its models' weights."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


@torch.no_grad()
def draw(spec, seed: int, tag: str, device) -> dict[str, torch.Tensor]:
    """{name: tensor} of a `parameter_spec`, on `device`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    total = sum(_numel(shape) for _, shape, *_ in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, dtype, kind, scale in spec:
        n = _numel(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "norm_weight":
            x = 1.0 + 0.1 * x
        elif kind == "bias":
            x = 0.02 * x
        else:
            x = x * scale
        out[name] = x.to(dtype)
    del flat
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def reference_module(kind: str, cfg: dict, served: torch.dtype, seed: int, device,
                     tag: str | None = None):
    """The reference module of `kind` with the seeded weights, in fp32, frozen."""
    m = nets.build(kind, cfg, served, "meta")
    w = draw(nets.parameter_spec(m), seed, tag or kind, device)
    m = nets.build(kind, cfg, served, device)
    load_into(m, w)
    return nets.frozen(m.float())


@torch.no_grad()
def load_into(program_module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy `weights` into the parameters of the same names (buffers, such
    as a frozen BatchNorm's statistics, keep their initial values). Raises
    where the names, shapes or dtypes differ: the weights must reach the
    program as they were drawn."""
    params = dict(program_module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: module only "
                         f"{sorted(set(params) - set(weights))[:5]}, drawn only "
                         f"{sorted(set(weights) - set(params))[:5]}")
    for k, w in weights.items():
        p = params[k]
        if p.shape != w.shape or p.dtype != w.dtype:
            raise ValueError(f"{k}: program {tuple(p.shape)} {p.dtype}, "
                             f"drawn {tuple(w.shape)} {w.dtype}")
        p.copy_(w)


def program_weights(kind: str, cfg: dict, served: torch.dtype, seed: int, device,
                    tag: str | None = None) -> dict[str, torch.Tensor]:
    """The seeded weights of `kind`, drawn for loading into the program."""
    return draw(nets.parameter_spec(nets.build(kind, cfg, served, "meta")), seed,
                tag or kind, device)
