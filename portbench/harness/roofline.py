"""The yardstick's table of peaks and the least time of each hand kernel at
the shapes it ran. Frozen from the program's `ops/kernel_check.py` at
commit c19ba6c (the published peaks, `roofline`, and the operation and
byte counts of `check_flash_nomax` and `check_group_norm`).

A bound is the largest of: the operations over the published dense peak
for their type, the exponentials over the SFU's rate (16 a clock on each
of the 132 SMs at the card's highest SM clock), and the bytes (each input
read once, each output written once) over the HBM rate. NVIDIA's H100 SXM
data sheet gives the peaks at the card's 700 W limit."""

from __future__ import annotations

import functools
import subprocess

PEAK_BF16 = 989e12       # FLOP/s, tensor cores
PEAK_FP32 = 67e12        # FLOP/s, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
EXP_PER_CLOCK_SM = 16
SMS = 132


@functools.cache
def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def bound_s(ops: float, peak: float, nbytes: float, exps: float = 0.0,
            exp_rate: float | None = None) -> float:
    terms = [ops / peak, nbytes / HBM_BYTES_PER_S]
    if exps:
        terms.append(exps / (exp_rate or EXP_PER_CLOCK_SM * SMS * max_sm_clock_hz()))
    return max(terms)


def k1_bound_s(bh: int, l: int, d: int, exp_rate: float | None = None) -> float:
    """K1, unmasked self-attention over (BH, L, D) bf16: QK^T and PV at 2 L^2 D
    each per head, L^2 exponentials per head, q, k, v read and o written."""
    return bound_s(4 * bh * l * l * d, PEAK_BF16, 4 * bh * l * d * 2, bh * l * l, exp_rate)


def k2_bound_s(n: int, c: int, hw: int, elem_bytes: int, silu: bool,
               exp_rate: float | None = None) -> float:
    """K2, GroupNorm over (N, C, HW): about 10 fp32 operations an element,
    x read and y written, fp32 scale and bias read; SiLU's exponential."""
    numel = n * c * hw
    return bound_s(10 * numel, PEAK_FP32, 2 * numel * elem_bytes + 2 * c * 4,
                   numel if silu else 0, exp_rate)


def share_pct(bounds_s: list[float], times_s: list[float]):
    """Σ bound / Σ time in %, or None where there is nothing to read: no
    launch, or launches and device events that do not pair one to one."""
    if not bounds_s or len(bounds_s) != len(times_s) or sum(times_s) <= 0:
        return None
    return 100.0 * sum(bounds_s) / sum(times_s)
