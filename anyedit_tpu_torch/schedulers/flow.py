"""Rectified-flow Euler sampler of the SD3 and Flux families (counterpart of
`anyedit_tpu/schedulers/flow.py`).

FlowMatchEulerDiscrete semantics: x_t = (1 - sigma_t) x0 + sigma_t eps, the
model predicts the velocity v = eps - x0, and an Euler step is
x_{t+1} = x_t + (sigma_next - sigma_t) v. The sigmas are shifted by the
resolution-dependent `shift` (SD3: 3.0) or, with dynamic shifting, by
exp(mu) (Flux, `flux_mu`). All schedule arithmetic is fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FlowState(NamedTuple):
    timesteps: torch.Tensor  # (S,) in training-time units (sigma * 1000)
    sigmas: torch.Tensor     # (S + 1,) descending 1 -> 0


def flow_init(num_inference_steps: int, shift: float = 3.0,
              use_dynamic_shifting: bool = False, mu: float | None = None,
              num_train_steps: int = 1000, device=None) -> FlowState:
    f32 = dict(dtype=torch.float32, device=device)
    sigmas = torch.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps, **f32)
    if use_dynamic_shifting and mu is not None:
        e = torch.exp(torch.tensor(mu, **f32))
        sigmas = e / (e + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    timesteps = sigmas * num_train_steps
    return FlowState(timesteps, torch.cat([sigmas, torch.zeros(1, **f32)]))


def flow_step(st: FlowState, i: int, model_out: torch.Tensor,
              sample: torch.Tensor) -> torch.Tensor:
    """One Euler step at loop index i, in fp32, cast back to the sample's dtype."""
    dx = st.sigmas[i + 1] - st.sigmas[i]
    return (sample.float() + dx * model_out.float()).to(sample.dtype)


def flow_add_noise(st: FlowState, i: int, x0: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    s = st.sigmas[i]
    return (1.0 - s) * x0 + s * noise


def flux_mu(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
            base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """The resolution-dependent dynamic-shift parameter (Flux convention)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    return image_seq_len * m + (base_shift - m * base_seq_len)
