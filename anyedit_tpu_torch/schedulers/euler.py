"""Euler-ancestral sampler in sigma space, k-diffusion's formulation
(counterpart of `anyedit_tpu/schedulers/euler.py`; diffusers'
EulerAncestralDiscreteScheduler): x = x0 + sigma eps, the model input
scaled by 1 / sqrt(sigma^2 + 1). The ancestral noise is an argument."""

from __future__ import annotations

from typing import NamedTuple

import torch

from anyedit_tpu_torch.schedulers.common import NoiseSchedule, spaced_timesteps


class EulerState(NamedTuple):
    timesteps: torch.Tensor  # (S,) descending training timesteps
    sigmas: torch.Tensor     # (S + 1,) descending, the last 0


def euler_ancestral_init(ns: NoiseSchedule, num_inference_steps: int) -> EulerState:
    acp_all = ns.alphas_cumprod
    ts = spaced_timesteps(ns.num_train_steps, num_inference_steps, device=acp_all.device)
    acp = acp_all[ts]
    sigmas = torch.sqrt((1.0 - acp) / acp)
    return EulerState(ts, torch.cat([sigmas, sigmas.new_zeros(1)]))


def euler_scale_input(st: EulerState, i: int, sample: torch.Tensor) -> torch.Tensor:
    return (sample / torch.sqrt(st.sigmas[i] ** 2 + 1.0)).to(sample.dtype)


def euler_ancestral_step(ns: NoiseSchedule, st: EulerState, i: int, model_out: torch.Tensor,
                         sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One step at loop index i (epsilon prediction, as the ancestral form
    assumes); `noise`: N(0, 1) of the sample's shape (unused at the last)."""
    del ns
    x = sample.float()
    eps = model_out.float()
    sigma, sigma_next = st.sigmas[i], st.sigmas[i + 1]
    x0 = x - sigma * eps
    sigma_up = torch.sqrt(torch.clamp(
        sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / torch.clamp(sigma ** 2, min=1e-12),
        min=0.0))
    sigma_down = torch.sqrt(torch.clamp(sigma_next ** 2 - sigma_up ** 2, min=0.0))
    d = (x - x0) / torch.clamp(sigma, min=1e-12)
    x_next = x + d * (sigma_down - sigma)
    x_next = x_next + torch.where(sigma_next > 0, sigma_up, 0.0) * noise.float()
    return x_next.to(sample.dtype)
