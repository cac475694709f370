"""SD3-UltraEdit masked instruction editing and Flux pair synthesis
(counterpart of `anyedit_tpu/diffusion/ultraedit.py`).

The 3-way-CFG flow-matching edit loop of the SD3 InstructPix2Pix pipeline:
one batched velocity call a step over the conditioning rows [full,
image-only, uncond], each row's input the current latents, the source
image's latents (zeros for uncond) and the mask channel, concatenated on
channels. With a mask, the source is re-noised to the next noise level and
composited outside the mask after each step. The JAX function draws its
start latents and re-noise noise from a key inside; here both are inputs
(the zoo's `ultraedit_fn` draws them), so the parity tests hand both sides
the same noise.

`flux_sample` is plain rectified-flow sampling (flux-schnell: 4 steps, no
CFG, shift 1.0), one velocity call a step; `flux_pair` samples two
captions from the SAME start noise, so only what the captions change
differs (textual_change). The noise is an input here too.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from anyedit_tpu_torch.core import trace
from anyedit_tpu_torch.schedulers.flow import flow_add_noise, flow_init, flow_step

# v_fn(x_cat (B, h, w, C), t (B,), context, pooled) -> velocity (B, h, w, C_out)
VFn = Callable[..., torch.Tensor]


def ultraedit_edit(v_fn: VFn,
                   image_latents: torch.Tensor,
                   cond_ctx: torch.Tensor, cond_pooled: torch.Tensor,
                   uncond_ctx: torch.Tensor, uncond_pooled: torch.Tensor,
                   init_latents: torch.Tensor,
                   num_steps: int = 50,
                   guidance_scale: float = 8.0,
                   image_guidance_scale: float = 1.5,
                   mask: Optional[torch.Tensor] = None,
                   shift: float = 3.0,
                   renoise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked SD3 instruction edit -> edited latents (B, h, w, C) fp32.

    image_latents (B, h, w, C); init_latents: the start point, N(0, 1) of
    the same shape; mask (B, h, w, 1), 1 = editable (None = global);
    renoise: the N(0, 1) noise that re-noises the source for the composite,
    required with a mask."""
    if mask is not None and renoise is None:
        raise ValueError("ultraedit_edit: a masked edit needs `renoise`")
    b = image_latents.shape[0]
    dev = image_latents.device
    st = flow_init(num_steps, shift=shift, device=dev)
    lat = init_latents.float()

    ctx = torch.cat([cond_ctx, uncond_ctx, uncond_ctx], dim=0)
    pooled = torch.cat([cond_pooled, uncond_pooled, uncond_pooled], dim=0)
    img_cond = torch.cat([image_latents, image_latents, torch.zeros_like(image_latents)])
    mask_ch = (torch.ones(image_latents.shape[:-1] + (1,), device=dev)
               if mask is None else mask.float())
    mask3 = torch.cat([mask_ch] * 3, dim=0)
    for i in range(num_steps):
        x_in = torch.cat([torch.cat([lat] * 3, dim=0), img_cond, mask3], dim=-1)
        v_full, v_img, v_unc = v_fn(x_in, st.timesteps[i].expand(3 * b), ctx,
                                    pooled).chunk(3, dim=0)
        v = v_unc + guidance_scale * (v_full - v_img) \
            + image_guidance_scale * (v_img - v_unc)
        lat = flow_step(st, i, v, lat)
        if mask is not None:
            ren = (flow_add_noise(st, i + 1, image_latents, renoise)
                   if i + 1 < num_steps else image_latents)
            lat = mask * lat + (1.0 - mask) * ren
    return lat


def flux_sample(v_fn: VFn, noise: torch.Tensor, ctx: torch.Tensor, pooled: torch.Tensor,
                num_steps: int = 4, shift: float = 1.0,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """noise: the start latents (B, h, w, C), N(0, 1). Returns the sampled
    latents fp32. `guidance` (B,) goes to guidance-distilled models (FLUX_DEV).
    Each velocity call is a `flux` span (attrs `rows`, `tokens`: the joint
    sequence, text and the image's patches of `v_fn.cfg.patch`, `step`, and
    `k6`: `v_fn.k6_launches`, the K6 launches of one call as the model
    reports them, 0 for a model without it)."""
    st = flow_init(num_steps, shift=shift, device=noise.device)
    lat = noise.float()
    b, h, w = lat.shape[:3]
    patch = getattr(getattr(v_fn, "cfg", None), "patch", 1)
    tokens = ctx.shape[1] + (h // patch) * (w // patch)
    k6 = getattr(v_fn, "k6_launches", 0)
    for i in range(num_steps):
        t = st.timesteps[i].expand(b)
        with trace.span("flux", "editor", rows=b, tokens=tokens, step=i, k6=k6):
            v = v_fn(lat, t, ctx, pooled) if guidance is None else \
                v_fn(lat, t, ctx, pooled, guidance)
        lat = flow_step(st, i, v, lat)
    return lat


def flux_pair(v_fn: VFn, noise: torch.Tensor,
              ctx_a: torch.Tensor, pooled_a: torch.Tensor,
              ctx_b: torch.Tensor, pooled_b: torch.Tensor,
              num_steps: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """textual_change: the SAME start noise for both captions."""
    return (flux_sample(v_fn, noise, ctx_a, pooled_a, num_steps),
            flux_sample(v_fn, noise, ctx_b, pooled_b, num_steps))
