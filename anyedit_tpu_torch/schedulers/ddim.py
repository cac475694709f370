"""DDIM sampler as step functions, including inversion (counterpart of
`anyedit_tpu/schedulers/ddim.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from anyedit_tpu_torch.schedulers.common import (
    NoiseSchedule, pred_x0, spaced_timesteps,
)


class DDIMState(NamedTuple):
    timesteps: torch.Tensor            # (S,) descending
    alphas_cumprod: torch.Tensor       # (S,) acp at each timestep
    alphas_cumprod_prev: torch.Tensor  # (S,) acp at the next (lower) timestep
    eta: float


def ddim_init(ns: NoiseSchedule, num_inference_steps: int, eta: float = 0.0,
              style: str = "leading") -> DDIMState:
    acp_all = ns.alphas_cumprod
    ts = spaced_timesteps(ns.num_train_steps, num_inference_steps, style,
                          device=acp_all.device)
    step = ns.num_train_steps // num_inference_steps
    prev_ts = ts - step
    # Below t=0 the SD convention (ldm ddim_alphas_prev[0], diffusers
    # set_alpha_to_one=False) is alphas_cumprod[0], not 1.0.
    acp_prev = torch.where(prev_ts >= 0, acp_all[torch.clamp(prev_ts, min=0)],
                           acp_all[0])
    return DDIMState(ts, acp_all[ts], acp_prev, eta)


def ddim_step(ns: NoiseSchedule, st: DDIMState, i: int,
              model_out: torch.Tensor, sample: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """One x_t -> x_{t-1} update at loop index i (0 = highest noise)."""
    x0, eps = pred_x0(ns, model_out.float(), sample.float(), st.timesteps[i])
    acp_prev = st.alphas_cumprod_prev[i]
    acp_t = st.alphas_cumprod[i]
    sigma = st.eta * torch.sqrt((1 - acp_prev) / (1 - acp_t)) \
        * torch.sqrt(1 - acp_t / acp_prev)
    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma ** 2, min=0.0)) * eps
    prev = torch.sqrt(acp_prev) * x0 + dir_xt
    if st.eta > 0:
        if generator is None:
            raise ValueError("eta > 0 DDIM needs a torch.Generator")
        prev = prev + sigma * torch.randn(sample.shape, generator=generator,
                                          device=sample.device)
    return prev.to(sample.dtype)


def ddim_inversion_step(ns: NoiseSchedule, st: DDIMState, i: int,
                        model_out: torch.Tensor,
                        sample: torch.Tensor) -> torch.Tensor:
    """One x_{t-1} -> x_t inversion update (deterministic; eta must be 0):
    from the level `alphas_cumprod_prev[i]` up to `alphas_cumprod[i]`."""
    acp_prev = st.alphas_cumprod_prev[i]
    acp_t = st.alphas_cumprod[i]
    x = sample.float()
    eps = model_out.float()
    x0 = (x - torch.sqrt(1.0 - acp_prev) * eps) / torch.sqrt(acp_prev)
    nxt = torch.sqrt(acp_t) * x0 + torch.sqrt(1.0 - acp_t) * eps
    return nxt.to(sample.dtype)
