"""The import guard: no module of the JAX stack or of the JAX package may be
loaded in the process that prints a result. Names are compared by their top
level (the part before the first dot), whole: `anyedit_tpu_torch` is not
`anyedit_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "anyedit_tpu")


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
