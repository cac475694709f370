"""Noise-schedule math shared by the samplers (counterpart of
`anyedit_tpu/schedulers/common.py`). Schedule tensors are fp32 on the
schedule's device; timesteps are int64 index tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch

# SD-family defaults (ldm configs: linear_start 0.00085, linear_end 0.012).
DEFAULT_BETA_START = 0.00085
DEFAULT_BETA_END = 0.012
DEFAULT_TRAIN_STEPS = 1000


class NoiseSchedule(NamedTuple):
    """Static per-model arrays over the full training-time discretization."""

    betas: torch.Tensor            # (T,)
    alphas_cumprod: torch.Tensor   # (T,)
    num_train_steps: int
    prediction_type: str = "epsilon"   # epsilon | v_prediction | sample


def make_noise_schedule(num_train_steps: int = DEFAULT_TRAIN_STEPS,
                        beta_start: float = DEFAULT_BETA_START,
                        beta_end: float = DEFAULT_BETA_END,
                        beta_schedule: str = "scaled_linear",
                        prediction_type: str = "epsilon",
                        device=None) -> NoiseSchedule:
    f32 = dict(dtype=torch.float32, device=device)
    if beta_schedule == "scaled_linear":
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                               num_train_steps, **f32) ** 2
    elif beta_schedule == "linear":
        betas = torch.linspace(beta_start, beta_end, num_train_steps, **f32)
    elif beta_schedule == "squaredcos_cap_v2":
        t = torch.arange(num_train_steps + 1, **f32) / num_train_steps
        f = torch.cos((t + 0.008) / 1.008 * torch.pi / 2) ** 2
        betas = torch.clamp(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    return NoiseSchedule(betas, alphas_cumprod, num_train_steps, prediction_type)


def spaced_timesteps(num_train_steps: int, num_inference_steps: int,
                     style: str = "leading", steps_offset: int = 1,
                     device=None) -> torch.Tensor:
    """Descending timesteps for the sampling loop.

    "leading" matches diffusers' default: t_i = i * (T // S) + steps_offset,
    returned high -> low (the SD/IP2P 50-step grid is 981, ..., 21, 1)."""
    if style == "leading":
        step = num_train_steps // num_inference_steps
        ts = torch.arange(num_inference_steps, device=device) * step + steps_offset
        ts = torch.clamp(ts, max=num_train_steps - 1)
    elif style == "trailing":
        ts = torch.round(torch.arange(num_train_steps, 0,
                                      -num_train_steps / num_inference_steps,
                                      dtype=torch.float32, device=device)
                         ).long() - 1
        ts = ts.flip(0)
    else:
        raise ValueError(style)
    return ts.flip(0)


def _at(ns: NoiseSchedule, t, like: torch.Tensor) -> torch.Tensor:
    """alphas_cumprod[t] in like's dtype, shaped to broadcast over a batch
    when t is per-sample."""
    t = torch.as_tensor(t, device=ns.alphas_cumprod.device)
    acp = ns.alphas_cumprod[t].to(like.dtype)
    return acp.reshape((-1,) + (1,) * (like.dim() - 1)) if acp.dim() else acp


def add_noise(ns: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t) -> torch.Tensor:
    """Forward process q(x_t | x_0)."""
    acp = _at(ns, t, x0)
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def velocity_target(ns: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
                    t) -> torch.Tensor:
    """The v-prediction target sqrt(acp) noise - sqrt(1 - acp) x0."""
    acp = _at(ns, t, x0)
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * x0


def pred_x0(ns: NoiseSchedule, model_out: torch.Tensor, sample: torch.Tensor,
            t) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert a model output into (x0_hat, eps_hat) per prediction_type."""
    acp = _at(ns, t, sample)
    sqrt_acp = torch.sqrt(acp)
    sqrt_1macp = torch.sqrt(1.0 - acp)
    if ns.prediction_type == "epsilon":
        eps = model_out
        x0 = (sample - sqrt_1macp * eps) / sqrt_acp
    elif ns.prediction_type == "v_prediction":
        x0 = sqrt_acp * sample - sqrt_1macp * model_out
        eps = sqrt_acp * model_out + sqrt_1macp * sample
    elif ns.prediction_type == "sample":
        x0 = model_out
        eps = (sample - sqrt_acp * x0) / sqrt_1macp
    else:
        raise ValueError(ns.prediction_type)
    return x0, eps
