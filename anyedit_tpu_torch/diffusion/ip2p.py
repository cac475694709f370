"""InstructPix2Pix editor with masked compositing (counterpart of
`anyedit_tpu/diffusion/ip2p.py`).

3-way classifier-free guidance in ONE batched UNet call per step, in the
batch order [text+image, image only, neither]:
    eps = e_uncond + s_txt * (e_full - e_img) + s_img * (e_img - e_uncond).
The JAX package draws its start latents and re-noise noise from a PRNG key
inside the function; here both are inputs (drawn from a `torch.Generator`
when absent), because jax.random and torch give different numbers for one
seed and the parity tests hand both sides the same noise. Each UNet call
is a `core.trace` span, "unet" (layer "editor", attrs rows and step).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from anyedit_tpu_torch.core import trace
from anyedit_tpu_torch.schedulers import (
    NoiseSchedule, add_noise, ddim_init, ddim_step,
)

# eps_fn(latents (B,H,W,C), t (B,), context (B,L,D)) -> eps (B,H,W,C)
EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _noise(like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=torch.float32)


def ip2p_edit(eps_fn: EpsFn,
              ns: NoiseSchedule,
              image_latents: torch.Tensor,
              cond_text: torch.Tensor,
              uncond_text: torch.Tensor,
              num_steps: int = 100,
              guidance_scale: float = 8.0,
              image_guidance_scale: float = 0.9,
              mask: Optional[torch.Tensor] = None,
              init_latents: Optional[torch.Tensor] = None,
              renoise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run the (optionally masked) IP2P edit; returns edited latents (B,H,W,C).

    image_latents: VAE-encoded original (the conditioning channels).
    mask: (B,H,W,1) in [0, 1], 1 = editable region; None = global edit.
    init_latents: start point (default: N(0, 1) from `generator`).
    renoise: the noise that re-noises the original for masked compositing
    (default: N(0, 1) from `generator`, drawn after init_latents).
    """
    b = image_latents.shape[0]
    st = ddim_init(ns, num_steps)
    lat = _noise(image_latents, generator) if init_latents is None \
        else init_latents.float()
    if mask is not None and renoise is None:
        renoise = _noise(image_latents, generator)

    ctx = torch.cat([cond_text, uncond_text, uncond_text], dim=0)
    img_cond = torch.cat([image_latents, image_latents,
                          torch.zeros_like(image_latents)], dim=0)
    for i in range(num_steps):
        t = st.timesteps[i]
        unet_in = torch.cat([torch.cat([lat, lat, lat], dim=0), img_cond], dim=-1)
        with trace.span("unet", "editor", rows=3 * b, step=i):
            e_full, e_img, e_unc = eps_fn(unet_in, t.expand(3 * b), ctx).chunk(3, dim=0)
        eps = e_unc + guidance_scale * (e_full - e_img) \
            + image_guidance_scale * (e_img - e_unc)
        lat = ddim_step(ns, st, i, eps, lat)
        if mask is not None:
            # re-noise the original to the NEXT noise level and composite
            renoised = (add_noise(ns, image_latents, renoise, st.timesteps[i + 1])
                        if i + 1 < num_steps else image_latents)
            lat = mask * lat + (1.0 - mask) * renoised
    return lat


def noise_diff_heatmap(eps_fn: EpsFn,
                       ns: NoiseSchedule,
                       image_latents: torch.Tensor,
                       cond_text: torch.Tensor,
                       uncond_text: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       t_frac: float = 0.6,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """|eps(text) - eps(image only)| at one mid-noise level -> (B,H,W) fp32."""
    b = image_latents.shape[0]
    t = torch.full((b,), int(ns.num_train_steps * t_frac),
                   device=image_latents.device)
    if noise is None:
        noise = _noise(image_latents, generator)
    noisy = add_noise(ns, image_latents, noise, t)
    lat2 = torch.cat([noisy, noisy], dim=0)
    img2 = torch.cat([image_latents, image_latents], dim=0)
    ctx = torch.cat([cond_text, uncond_text], dim=0)
    eps2 = eps_fn(torch.cat([lat2, img2], dim=-1), torch.cat([t, t]), ctx)
    e_text, e_img = eps2.chunk(2, dim=0)
    return (e_text - e_img).abs().mean(dim=-1)


def predict_edit_mask(heat: torch.Tensor, threshold: float = 0.5,
                      sharpness: float = 12.0) -> torch.Tensor:
    """IQR-normalise the heatmap and softly threshold -> (B,H,W,1) in [0, 1]."""
    b = heat.shape[0]
    flat = heat.reshape(b, -1).float()
    qs = torch.quantile(flat, torch.tensor([0.25, 0.5, 0.75], device=flat.device),
                        dim=-1, keepdim=True)
    q1, med, q3 = qs[0], qs[1], qs[2]
    normed = (flat - med) / torch.clamp(q3 - q1, min=1e-6)
    mask = torch.sigmoid(sharpness * (normed - threshold))
    return mask.reshape(heat.shape + (1,))
