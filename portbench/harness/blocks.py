"""Seeded weights drawn block by block, for modules whose one flat draw
(`weights.draw`) would not fit beside the rest of the card's load: the Flux
transformer (11.9 B parameters, 47.6 GB as one fp32 draw) and T5-XXL.

A module's parameters are grouped by their top-level submodule, a block of a
ModuleList counting as one (`transformer_blocks.7`, `block.3`, `x_embedder`).
Each group is drawn with `weights.draw` under the tag `<kind>/<group>`, so
the program and the reference get the same values whichever loads them, and
at most one group's fp32 draw is alive beside the module."""

from __future__ import annotations

import torch

from portbench.harness import weights


def group_of(name: str) -> str:
    """The group of a parameter name: its path up to the first block index,
    else its first component."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return ".".join(parts[:i + 1])
    return parts[0]


def groups(spec) -> dict[str, list]:
    """group -> the spec's entries in it, in name order."""
    out: dict[str, list] = {}
    for entry in spec:
        out.setdefault(group_of(entry[0]), []).append(entry)
    return out


def draw_groups(spec, seed: int, kind: str, device):
    """Yields (group, {name: tensor}) over the spec's groups."""
    for g, entries in groups(spec).items():
        yield g, weights.draw(entries, seed, f"{kind}/{g}", device)


def strip(g: str, w: dict) -> dict:
    """A group's draw under the names relative to its submodule."""
    return {k[len(g) + 1:]: v for k, v in w.items()}


@torch.no_grad()
def load_program(module: torch.nn.Module, spec, seed: int, kind: str, device) -> None:
    """Copy the drawn groups into the program's `module`, whose parameter
    names, shapes and dtypes must be the spec's."""
    params = dict(module.named_parameters())
    want = {name for name, *_ in spec}
    if set(params) != want:
        raise ValueError(f"parameter names differ: module only "
                         f"{sorted(set(params) - want)[:5]}, drawn only "
                         f"{sorted(want - set(params))[:5]}")
    for _, w in draw_groups(spec, seed, kind, device):
        for k, v in w.items():
            p = params[k]
            if p.shape != v.shape or p.dtype != v.dtype:
                raise ValueError(f"{k}: program {tuple(p.shape)} {p.dtype}, "
                                 f"drawn {tuple(v.shape)} {v.dtype}")
            p.copy_(v)


@torch.no_grad()
def reference_module(meta_module: torch.nn.Module, spec, seed: int, kind: str, device):
    """The reference module built on the meta device at the served dtypes,
    its parameters assigned group by group in fp32 on `device`, frozen."""
    for g, w in draw_groups(spec, seed, kind, device):
        sub = meta_module.get_submodule(g)
        sub.load_state_dict({k: v.float() for k, v in strip(g, w).items()}, strict=True,
                            assign=True)
        del w
    return meta_module.eval().requires_grad_(False)
