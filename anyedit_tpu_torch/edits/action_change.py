"""action_change: MasaCtrl consistent pair synthesis (counterpart of
`anyedit_tpu/edits/action_change.py`).

Both sides of the record are generated from its (input, output) caption
pair, from ONE shared start latent; from step MASA_STEP and self-attention
site MASA_LAYER on, the target branch reads the source branch's
self-attention keys and values, so identity and layout stay while the
action changes. The JAX function draws the start latent from a key inside;
here it is an input (`z0`), drawn by the zoo's `masactrl_pair_fn`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from anyedit_tpu_torch.diffusion.processors import masactrl_processor
from anyedit_tpu_torch.edits.types import EditOutcome
from anyedit_tpu_torch.schedulers import NoiseSchedule, ddim_init, ddim_step

# UNetApply: (x, t, ctx, processor, extra) -> eps
UNetApply = Callable[..., torch.Tensor]

MASA_STEP = 5
MASA_LAYER = 12


def consistent_synthesis(unet_apply: UNetApply, ns: NoiseSchedule,
                         ctx_src: torch.Tensor, ctx_tgt: torch.Tensor,
                         uncond: torch.Tensor, z0: torch.Tensor,
                         num_steps: int = 50, guidance_scale: float = 7.5,
                         start_step: int = MASA_STEP,
                         start_layer: int = MASA_LAYER) -> torch.Tensor:
    """z0: the shared start latent (1, hw, hw, C). Returns the latents
    (2, hw, hw, C): [source image, action image]. One batch-4 UNet call a
    step, the CFG rows [uc_src, uc_tgt, c_src, c_tgt]: odd rows are targets
    in both halves, the masactrl processor's default pair layout."""
    st = ddim_init(ns, num_steps)
    lat = torch.cat([z0, z0], dim=0).float()
    ctx = torch.cat([uncond, uncond, ctx_src, ctx_tgt], dim=0)
    proc = masactrl_processor(start_step, start_layer)
    for i in range(num_steps):
        eps4 = unet_apply(torch.cat([lat, lat], dim=0), st.timesteps[i].expand(4), ctx,
                          proc, {"step": i})
        e_uc, e_c = eps4.chunk(2, dim=0)
        lat = ddim_step(ns, st, i, e_uc + guidance_scale * (e_c - e_uc), lat)
    return lat


def action_change(tb, rec, image, rng):
    """Record-level pipeline: both sides SYNTHESIZED from the (input,
    output) caption pair by `tb.extra["masactrl_pair"](src_caption,
    tgt_caption, seed)`; `image` is unused."""
    pair = tb.extra.get("masactrl_pair")
    if pair is None:
        return EditOutcome(False, reason="masactrl stack unavailable")
    seed = int(rng.integers(0, 2 ** 31))
    src, tgt = pair(rec.input, rec.output, seed)
    return EditOutcome(True, edited=np.asarray(tgt), input_image=np.asarray(src))
