"""Classifier-free-guidance samplers over an `eps_fn` (counterpart of
`anyedit_tpu/diffusion/sampling.py`): masked inpainting, SDEdit img2img
(with an optional mask: the SDXL-inpaint loop), the Prompt-to-Prompt
pair sampler of the JAX zoo's `p2p_pair`, and the plain 2-way CFG loop of
the JAX zoo's `composition_fn` and `anydoor` (`sample_cfg`).

The JAX package draws the start noise from `key` and the re-noise noise
from `fold_in(key, 1)` inside the function; here both are inputs
(`sample_inpaint` draws them from a `torch.Generator` when absent, start
noise first, as `diffusion/ip2p.py` does; `sample_img2img` requires them).
"""

from __future__ import annotations

from typing import Optional

import torch

from anyedit_tpu_torch.diffusion.ip2p import EpsFn, _noise
from anyedit_tpu_torch.diffusion.processors import AttentionStore
from anyedit_tpu_torch.schedulers import NoiseSchedule, add_noise, ddim_init, ddim_step


def sample_inpaint(eps_fn: EpsFn, ns: NoiseSchedule,
                   image_latents: torch.Tensor, mask_latent: torch.Tensor,
                   cond_text: torch.Tensor, uncond_text: torch.Tensor,
                   num_steps: int = 50, guidance_scale: float = 7.5,
                   masked_image_latents: Optional[torch.Tensor] = None,
                   init_latents: Optional[torch.Tensor] = None,
                   renoise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The 9-channel SD-inpaint loop: UNet input [latents, mask,
    masked-image latents], 2-way CFG as one batch-2b UNet call per step in
    the order [cond, uncond], and after every step the latents composited
    with the original re-noised to the next level (the clean original after
    the last step). Returns the latents (B, h, w, C).

    mask_latent: (B, h, w, 1), 1 = the region to repaint, at latent size.
    masked_image_latents: default `image_latents * (1 - mask_latent)`.
    """
    b = image_latents.shape[0]
    st = ddim_init(ns, num_steps)
    lat = _noise(image_latents, generator) if init_latents is None \
        else init_latents.float()
    if renoise is None:
        renoise = _noise(image_latents, generator)
    if masked_image_latents is None:
        masked_image_latents = image_latents * (1.0 - mask_latent)
    ctx = torch.cat([cond_text, uncond_text], dim=0)
    cond_ch = torch.cat([mask_latent, masked_image_latents], dim=-1)
    cond_ch2 = torch.cat([cond_ch, cond_ch], dim=0)
    for i in range(num_steps):
        t = st.timesteps[i]
        unet_in = torch.cat([torch.cat([lat, lat], dim=0), cond_ch2], dim=-1)
        e_c, e_u = eps_fn(unet_in, t.expand(2 * b), ctx).chunk(2, dim=0)
        lat = ddim_step(ns, st, i, e_u + guidance_scale * (e_c - e_u), lat)
        ren = (add_noise(ns, image_latents, renoise, st.timesteps[i + 1])
               if i + 1 < num_steps else image_latents)
        lat = mask_latent * lat + (1.0 - mask_latent) * ren
    return lat


def sample_img2img(eps_fn: EpsFn, ns: NoiseSchedule, image_latents: torch.Tensor,
                   cond_text: torch.Tensor, uncond_text: torch.Tensor,
                   num_steps: int = 50, strength: float = 0.5,
                   guidance_scale: float = 7.5, mask: Optional[torch.Tensor] = None,
                   *, noise: torch.Tensor,
                   renoise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SDEdit img2img: the latents noised to step i0 = num_steps - n_run of
    the DDIM grid, n_run = max(1, min(num_steps, round(num_steps *
    strength))) (Python's round: 29.4 gives 29), then denoised from i0 with
    2-way CFG, one batch-2b call a step in the order [cond, uncond].
    Returns the latents (B, h, w, C).

    mask: optional (B, h, w, 1), 1 = repaint. With it, every step
    composites against the original re-noised to the next timestep (the
    clean original after the last): the SDXL-inpaint loop on the base model.
    `noise` noises the input; `renoise`, required with a mask, re-noises
    the original."""
    b = image_latents.shape[0]
    st = ddim_init(ns, num_steps)
    n_run = max(1, min(num_steps, int(round(num_steps * strength))))
    i0 = num_steps - n_run
    if mask is not None and renoise is None:
        raise ValueError("sample_img2img with a mask needs renoise")
    lat = add_noise(ns, image_latents, noise.float(), st.timesteps[i0])
    ctx = torch.cat([cond_text, uncond_text], dim=0)
    for i in range(i0, num_steps):
        t = st.timesteps[i]
        e_c, e_u = eps_fn(torch.cat([lat, lat], dim=0), t.expand(2 * b), ctx).chunk(2, dim=0)
        lat = ddim_step(ns, st, i, e_u + guidance_scale * (e_c - e_u), lat)
        if mask is not None:
            ren = (add_noise(ns, image_latents, renoise, st.timesteps[i + 1])
                   if i + 1 < num_steps else image_latents)
            lat = mask * lat + (1.0 - mask) * ren
    return lat


def sample_cfg(eps_fn: EpsFn, ns: NoiseSchedule, noise: torch.Tensor, ctx2: torch.Tensor,
               num_steps: int = 50, guidance_scale: float = 7.5) -> torch.Tensor:
    """DDIM from the start latents `noise` (B, h, w, C) with 2-way CFG, one
    batch-2B `eps_fn` call a step over ctx2 = [cond rows, uncond rows].
    Returns the latents (B, h, w, C) fp32."""
    b = noise.shape[0]
    st = ddim_init(ns, num_steps)
    lat = noise.float()
    for i in range(num_steps):
        e_c, e_u = eps_fn(torch.cat([lat, lat], dim=0), st.timesteps[i].expand(2 * b),
                          ctx2).chunk(2, dim=0)
        lat = ddim_step(ns, st, i, e_u + guidance_scale * (e_c - e_u), lat)
    return lat


def p2p_sample(unet, ns: NoiseSchedule, ctx4: torch.Tensor, z0: torch.Tensor,
               store: AttentionStore, num_steps: int = 20,
               guidance_scale: float = 7.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Both captions of a pair from one shared start latent z0 (1, h, w, C):
    one batch-4 UNet call a step over ctx4 = [uncond, uncond, cond_src,
    cond_tgt] under `store`'s processor; the conditional rows [2:4] of the
    FIRST largest map the store kept are summed over the steps. Returns
    (latents (2, h, w, C), accumulated maps (2, L, T))."""
    st = ddim_init(ns, num_steps)
    lat = torch.cat([z0, z0], dim=0).float()
    acc = None
    for i in range(num_steps):
        store.reset()
        eps4 = unet(torch.cat([lat, lat], dim=0), st.timesteps[i].expand(4), ctx4,
                    processor=store.processor())
        maps = store.collect()
        best = maps[max(maps, key=lambda n: maps[n].shape[1])][2:4]
        acc = best if acc is None else acc + best
        e_u, e_c = eps4.chunk(2, dim=0)
        lat = ddim_step(ns, st, i, e_u + guidance_scale * (e_c - e_u), lat)
    return lat, acc
