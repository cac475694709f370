"""Deterministic RNG threading (counterpart of `anyedit_tpu/core/rng.py`).

Every stochastic decision of a factory run derives from one root seed and a
stable record key, so a run is a pure function of (seed, records). The
executor draws only from `host_rng`. No module of either package calls
`record_key` yet; it is kept as the JAX package keeps it, for a caller
that seeds device noise per record.
"""

from __future__ import annotations

import hashlib

import numpy as np


def record_key(root_seed: int, record_id: str) -> int:
    """The per-record seed of a `torch.Generator`: the JAX package's 32-bit
    hash of the record id (the value it folds into the root key) in the
    low word, the root seed's low 32 bits in the high word.

    The record-level determinism contract across the two packages:
      * `host_rng(seed, record_id)` is numpy in both, so it draws the same
        values: the pre-filter's uniform and every host-side choice of a
        pipeline (word templates, jitter) agree between the packages;
      * this seed and the JAX package's `record_key` key (a `jax.random`
        key) give device noise (diffusion start latents, re-noise draws)
        that is deterministic within each package but differs between
        them, so pixels that depend on it are compared only with the noise
        handed from one side to the other."""
    h = int.from_bytes(hashlib.sha256(record_id.encode()).digest()[:4], "little")
    return ((root_seed & 0xFFFFFFFF) << 32) | h


def host_rng(root_seed: int, record_id: str) -> np.random.Generator:
    """A numpy Generator for host-side choices (word templates, jitter)."""
    h = hashlib.sha256(f"{root_seed}:{record_id}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))
