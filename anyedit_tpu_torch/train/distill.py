"""LCM consistency distillation of the IP2P editor into a few-step student
(counterpart of `anyedit_tpu/train/distill.py`).

The teacher folds the editor's 3-way classifier-free guidance at a fixed
operating point into one ODE step down the trailing DDIM grid; the student
f(x_t, t) = c_skip x_t + c_out x0_hat is pulled, under a pseudo-Huber loss,
towards the EMA target's value one grid step lower. AdamW + clip as the
AnySD trainer (`train/optim.py`), EMA d e + (1 - d) s.

Weights: the JAX distiller keeps fp32 params and updates them at lr 1e-5;
Flax's `dtype=bf16` rounds them at each use. A bf16 module updated in place
would lose a relative step of 1e-5 in bf16's 2^-8 rounding and never move,
so the student and the EMA target here are `Replica`s: the module in the
config's dtype, and fp32 master tensors, one per parameter. The optimizer
and the EMA act on the masters; the module's weights are written from them
after each step (bf16 rounding for bf16 parameters, exact for the fp32
norm affines). The gradient of a bf16 weight is taken up in fp32, as the
JAX gradient of the cast is.

The JAX `loss_fn` draws the grid index n and the noise from a key; here
they are `draws = {"n", "noise"}` (`LCMDistiller.draw` makes them).
The JAX step is dp-batched on the mesh; here, with a `core.dist.Group`,
each rank holds its rows, `draw` keeps the rank's rows of the whole batch's
draws and `distill_step` averages the gradients (fp32) and the loss over
the ranks before the update, so the masters, and the EMA computed from
them, stay equal bit for bit on every rank.
`lcm_edit` takes its start latents and re-noise draws from the caller or
from a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from anyedit_tpu_torch.core.dist import Group, average, batch_rows
from anyedit_tpu_torch.models.unet_sd import (
    SD15_IP2P_UNET, TINY_UNET, UNet2DCondition, UNetConfig,
)
from anyedit_tpu_torch.schedulers import (
    NoiseSchedule, add_noise, ddim_init, make_noise_schedule, pred_x0,
)
from anyedit_tpu_torch.train.optim import ClippedAdamW


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    unet: UNetConfig = SD15_IP2P_UNET
    num_ddim_steps: int = 50
    skip: int = 1
    guidance_scale: float = 8.0
    image_guidance_scale: float = 0.9
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    ema_decay: float = 0.95
    huber_c: float = 0.001
    learning_rate: float = 1e-5


TINY_DISTILL = DistillConfig(
    unet=dataclasses.replace(TINY_UNET, in_channels=8),
    num_ddim_steps=8, learning_rate=1e-3)


def boundary_scalings(cfg: DistillConfig, t: torch.Tensor):
    """c_skip(t), c_out(t): c_skip = 1, c_out = 0 at t = 0."""
    ts = t.float() * cfg.timestep_scaling
    sd2 = cfg.sigma_data ** 2
    return sd2 / (ts ** 2 + sd2), ts / torch.sqrt(ts ** 2 + sd2)


def _bc(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


class Replica:
    """A UNet module and the fp32 masters of its parameters."""

    def __init__(self, unet: UNet2DCondition, masters: dict[str, torch.Tensor]):
        self.unet, self.masters = unet, masters
        self.sync_()

    @torch.no_grad()
    def sync_(self) -> None:
        """Write every module parameter from its master (rounded to the
        parameter's dtype)."""
        for name, p in self.unet.named_parameters():
            p.copy_(self.masters[name])


def _consistency(ns, cfg, unet, x_t, t, ctx, img_cond):
    """f(x_t, t | text, image) -> x0-space prediction, fp32."""
    eps = unet(torch.cat([x_t, img_cond], dim=-1), t, ctx).float()
    x0_hat, _ = pred_x0(ns, eps, x_t.float(), t)
    c_skip, c_out = boundary_scalings(cfg, t)
    return _bc(c_skip) * x_t.float() + _bc(c_out) * x0_hat


class LCMDistiller:
    """Distills a frozen IP2P teacher UNet into a few-step student.

    batch (latent space, NHWC): edited_latents (B,h,w,4), orig_latents
    (B,h,w,4), text_emb (B,L,Dc), uncond_emb (B,L,Dc)."""

    def __init__(self, cfg: DistillConfig, ns: NoiseSchedule | None = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.ns = ns or make_noise_schedule(device=self.device)
        if self.ns.prediction_type != "epsilon":
            raise ValueError("LCMDistiller requires an epsilon-prediction schedule, got "
                             f"{self.ns.prediction_type!r}")
        self.st = ddim_init(self.ns, cfg.num_ddim_steps, style="trailing")
        self.tx = ClippedAdamW(cfg.learning_rate)

    # ---- init ------------------------------------------------------------
    def _module(self, state: Mapping[str, torch.Tensor], trainable: bool) -> UNet2DCondition:
        unet = UNet2DCondition(self.cfg.unet, device=self.device)
        unet.load_state_dict(state, strict=True)
        return unet.train(False).requires_grad_(trainable)

    def init(self, teacher_state: Mapping[str, torch.Tensor]):
        """(teacher, student, ema, opt_state) from the teacher's fp32 state
        dict (`bridge.unet_state_dict` of its Flax tree, or a seeded fp32
        module's): the teacher module frozen, the student and its EMA target
        starting at the teacher, their masters fp32 copies of it."""
        masters = {k: v.to(self.device, torch.float32) for k, v in teacher_state.items()}
        teacher = self._module(masters, False)
        student = Replica(self._module(masters, True),
                          {k: v.clone() for k, v in masters.items()})
        ema = Replica(self._module(masters, False),
                      {k: v.clone() for k, v in masters.items()})
        return teacher, student, ema, self.tx.init(student.masters)

    def draw(self, generator: torch.Generator, batch: dict,
             group: Optional[Group] = None) -> dict:
        """The grid indices and the noise; with a group, the rank's rows of
        the whole batch's draws (`AnySDTrainer.draw`)."""
        lat = batch["edited_latents"]
        b = lat.shape[0] * (1 if group is None else group.size)
        return batch_rows({"n": torch.randint(0, self.cfg.num_ddim_steps - self.cfg.skip, (b,),
                                              generator=generator, device=lat.device),
                           "noise": torch.randn((b,) + lat.shape[1:], generator=generator,
                                                device=lat.device)}, group)

    # ---- pieces ----------------------------------------------------------
    def _teacher_eps(self, teacher, x_t, t, batch):
        """3-way-CFG-folded teacher noise prediction (no grad)."""
        c = self.cfg
        img = batch["orig_latents"]
        lat3 = torch.cat([x_t, x_t, x_t], dim=0)
        img3 = torch.cat([img, img, torch.zeros_like(img)], dim=0)
        ctx3 = torch.cat([batch["text_emb"], batch["uncond_emb"], batch["uncond_emb"]], dim=0)
        eps3 = teacher(torch.cat([lat3, img3], dim=-1), torch.cat([t, t, t]), ctx3).float()
        e_full, e_img, e_unc = eps3.chunk(3, dim=0)
        return (e_unc + c.guidance_scale * (e_full - e_img)
                + c.image_guidance_scale * (e_img - e_unc))

    def _ddim_skip(self, x_t, eps, t_hi, t_lo):
        acp_hi = _bc(self.ns.alphas_cumprod[t_hi])
        acp_lo = _bc(self.ns.alphas_cumprod[t_lo])
        x = x_t.float()
        x0 = (x - torch.sqrt(1.0 - acp_hi) * eps) / torch.sqrt(acp_hi)
        return torch.sqrt(acp_lo) * x0 + torch.sqrt(1.0 - acp_lo) * eps

    # ---- the distillation update ------------------------------------------
    def loss_fn(self, student, ema, teacher, batch: dict, draws: dict) -> torch.Tensor:
        """student, ema, teacher: UNet modules. The gradient reaches the
        student's parameters only."""
        cfg = self.cfg
        grid = self.st.timesteps
        n = draws["n"]
        t_hi, t_lo = grid[n], grid[n + cfg.skip]
        ctx, img = batch["text_emb"], batch["orig_latents"]
        with torch.no_grad():
            x_hi = add_noise(self.ns, batch["edited_latents"].float(), draws["noise"], t_hi)
            eps_t = self._teacher_eps(teacher, x_hi, t_hi, batch)
            x_lo = self._ddim_skip(x_hi, eps_t, t_hi, t_lo)
            target = _consistency(self.ns, cfg, ema, x_lo, t_lo, ctx, img)
        online = _consistency(self.ns, cfg, student, x_hi, t_hi, ctx, img)
        d = online - target
        return torch.mean(torch.sqrt(torch.square(d) + cfg.huber_c ** 2) - cfg.huber_c)

    def distill_step(self, student: Replica, ema: Replica, opt_state: dict, teacher,
                     batch: dict, draws: dict, group: Optional[Group] = None):
        """Gradients -> AdamW on the student's masters -> EMA of the masters;
        both modules rewritten from their masters. Returns (student, ema,
        opt_state, loss). With a group, the gradients and the loss are
        averaged over the ranks (fp32) before the update."""
        params = dict(student.unet.named_parameters())
        loss = self.loss_fn(student.unet, ema.unet, teacher, batch, draws)
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = loss.detach()
        if group is not None:
            grads, loss = average(grads, loss, group)
        opt_state = self.tx.update_(student.masters, dict(zip(params, grads)), opt_state)
        d = self.cfg.ema_decay
        with torch.no_grad():
            for k, e in ema.masters.items():
                ema.masters[k] = d * e + (1.0 - d) * student.masters[k]
        student.sync_()
        ema.sync_()
        return student, ema, opt_state, loss


@torch.no_grad()
def lcm_edit(unet, ns: NoiseSchedule, cfg: DistillConfig, image_latents: torch.Tensor,
             cond_text: torch.Tensor, num_steps: int = 4,
             x_init: Optional[torch.Tensor] = None,
             renoise: Optional[Sequence[torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Few-step consistency sampling: one UNet pass a step, x0 predicted,
    then re-noised to the next level of the trailing grid; the last step
    keeps x0. Returns edited latents (B,h,w,4), fp32.

    x_init: the start latents; renoise: the re-noise draws of steps 0 ..
    num_steps - 2 (the JAX sampler draws one more after the last step and
    discards it). Each defaults to N(0, 1) from `generator`, x_init first."""
    st = ddim_init(ns, num_steps, style="trailing")
    b = image_latents.shape[0]
    dev = image_latents.device

    def noise():
        return torch.randn(image_latents.shape, generator=generator, device=dev)
    x = (noise() if x_init is None else x_init.to(dev)).float()
    for i in range(num_steps):
        t = st.timesteps[i].expand(b)
        eps = unet(torch.cat([x, image_latents.to(x.dtype)], dim=-1), t, cond_text).float()
        x0_hat, _ = pred_x0(ns, eps, x, t)
        c_skip, c_out = boundary_scalings(cfg, t)
        x0_pred = _bc(c_skip) * x + _bc(c_out) * x0_hat
        if i + 1 < num_steps:
            r = noise() if renoise is None else renoise[i].to(dev)
            x = add_noise(ns, x0_pred, r.float(), st.timesteps[i + 1])
        else:
            x = x0_pred
    return x
