"""Ancestral DDPM step (counterpart of `anyedit_tpu/schedulers/ddpm.py`;
reference: ldm/models/diffusion/ddpm.py p_sample). The JAX step draws its
noise from a key; here it is an argument."""

from __future__ import annotations

import torch

from anyedit_tpu_torch.schedulers.common import NoiseSchedule, pred_x0


def ddpm_step(ns: NoiseSchedule, t, model_out: torch.Tensor, sample: torch.Tensor,
              noise: torch.Tensor, clip_x0: bool = True) -> torch.Tensor:
    """One ancestral x_t -> x_{t-1} update at (full-resolution) timestep t;
    `noise`: N(0, 1) of the sample's shape (unused at t = 0)."""
    t = torch.as_tensor(t, device=ns.alphas_cumprod.device)
    x = sample.float()
    x0, _ = pred_x0(ns, model_out.float(), x, t)
    if clip_x0:
        x0 = torch.clamp(x0, -1.0, 1.0)
    acp_t = ns.alphas_cumprod[t]
    acp_prev = torch.where(t > 0, ns.alphas_cumprod[torch.clamp(t - 1, min=0)], 1.0)
    beta_t = ns.betas[t]
    # the posterior q(x_{t-1} | x_t, x0)
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(1.0 - beta_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x
    var = torch.clamp(beta_t * (1.0 - acp_prev) / (1.0 - acp_t), min=1e-20)
    prev = mean + torch.where(t > 0, torch.sqrt(var), 0.0) * noise.float()
    return prev.to(sample.dtype)
