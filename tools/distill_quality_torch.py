"""LCM distillation quality at a tiny scale, on the card: the twin of
`tools/distill_quality.py` (the same protocol and JSON keys).

A tiny IP2P teacher UNet is first trained (eps-MSE on structured synthetic
latents: a random UNet's ODE flow has no smooth endpoint map to distil),
then distilled into a consistency student (`train/distill.py`), and the
tool reports how much closer the one-step consistency sample f(x_T, T)
lands to the teacher's 8-step DDIM endpoint from the same x_T after
distillation than before. The CFG operating point is softened to 2.0 / 1.0
(a random-scale teacher under guidance 8 gives exploding latents);
production keeps 8.0 / 0.9.

    python3 tools/distill_quality_torch.py [distill_steps] [--device cpu]

Runs on the card by default ("cuda"; raises without CUDA); `--device cpu`
asks for the CPU. The teacher and the student compute in the tiny UNet's
bf16 with fp32 masters, as the JAX tool's fp32 params at bf16 compute; the
draws come from `torch.Generator(0)` on the device (jax.random draws other
numbers). Prints one JSON line:
  {"pre_distill_l1", "post_distill_l1", "improvement_pct",
   "teacher_selfdrift_l1_8v4step" (teacher 8-step vs 4-step DDIM: the
   no-training alternative's gap, for scale), ...}
and the device on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX tool's step counts and sizes
DISTILL_STEPS = 400
TEACHER_STEPS = 600
TEACHER_LR = 2e-3
BATCH, HW, TOKENS = 8, 8, 5


def device_line(dev) -> str:
    """The device a result ran on: the card's name and power limit as
    nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def adam(lr: float):
    """optax.adam(lr): `train/optim.py`'s AdamW without decay or clipping."""
    from anyedit_tpu_torch.train.optim import ClippedAdamW
    return ClippedAdamW(lr, weight_decay=0.0, max_norm=float("inf"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("steps", nargs="?", type=int, default=DISTILL_STEPS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from anyedit_tpu_torch.diffusion.ip2p import ip2p_edit
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    from anyedit_tpu_torch.schedulers import add_noise
    from anyedit_tpu_torch.train.distill import TINY_DISTILL, LCMDistiller, Replica, lcm_edit
    from anyedit_tpu_torch.weights.init import seeded_init_

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distill_quality_torch: CUDA is not available; pass --device cpu "
                           "to run on the CPU")
    print(f"# device: {device_line(dev)}", file=sys.stderr, flush=True)
    cfg = dataclasses.replace(TINY_DISTILL, guidance_scale=2.0, image_guidance_scale=1.0,
                              ema_decay=0.9)
    dist = LCMDistiller(cfg, device=dev)
    ns = dist.ns
    g = torch.Generator(device=dev).manual_seed(0)
    cd = cfg.unet.context_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # the teacher: fp32 masters of a bf16 module, trained before distilling
    fp32 = dataclasses.replace(cfg.unet, dtype=torch.float32)
    masters = seeded_init_(UNet2DCondition(fp32, device=dev), 0).state_dict()
    teacher = Replica(UNet2DCondition(cfg.unet, device=dev), masters)

    # structured data: low-rank latents, so the ODE has a learnable signal
    basis = randn(4, HW, HW, 4)
    t_emb = randn(1, TOKENS, cd).expand(BATCH, TOKENS, cd)
    u_emb = torch.zeros_like(t_emb)

    def make_batch():
        w = randn(BATCH, 4, 1, 1, 1) * 0.6
        x0 = torch.sum(w * basis[None], dim=1)
        return {"edited_latents": x0, "orig_latents": x0 + 0.1 * randn(*x0.shape),
                "text_emb": t_emb, "uncond_emb": u_emb}

    # stage 0: the teacher's eps-MSE fit with the IP2P input layout
    tx = adam(TEACHER_LR)
    opt = tx.init(teacher.masters)
    params = dict(teacher.unet.requires_grad_(True).named_parameters())
    for i in range(TEACHER_STEPS):
        bt = make_batch()
        t = torch.randint(0, ns.num_train_steps, (BATCH,), generator=g, device=dev)
        noise = randn(*bt["edited_latents"].shape)
        x_t = add_noise(ns, bt["edited_latents"], noise, t)
        eps = teacher.unet(torch.cat([x_t, bt["orig_latents"]], dim=-1), t, bt["text_emb"])
        loss = torch.mean(torch.square(eps.float() - noise))
        grads = torch.autograd.grad(loss, list(params.values()))
        opt = tx.update_(teacher.masters, dict(zip(params, grads)), opt)
        teacher.sync_()
        if i % 200 == 0:
            print(f"# teacher step {i}: mse {float(loss.detach()):.4f}", file=sys.stderr,
                  flush=True)
    teacher.unet.requires_grad_(False)

    batch = make_batch()
    img_lat = batch["orig_latents"]
    x_T = randn(*img_lat.shape)

    @torch.no_grad()
    def teacher_edit(n_steps):
        """The folded 3-way-CFG DDIM edit from the pinned x_T (seed parity
        with the student: the consistency function maps a given x_T to the
        ODE endpoint)."""
        return ip2p_edit(teacher.unet, ns, img_lat, t_emb, u_emb, num_steps=n_steps,
                         guidance_scale=cfg.guidance_scale,
                         image_guidance_scale=cfg.image_guidance_scale, init_latents=x_T)

    ref = teacher_edit(cfg.num_ddim_steps)
    self_drift = float(torch.mean(torch.abs(ref - teacher_edit(4))))

    def one_step(unet):
        """f(x_T, T) in one consistency step from the same x_T."""
        return lcm_edit(unet, ns, cfg, img_lat, t_emb, num_steps=1, x_init=x_T)

    pre = float(torch.mean(torch.abs(ref - one_step(teacher.unet))))
    teacher_module, student, ema, dopt = dist.init(teacher.masters)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        bt = make_batch()
        student, ema, dopt, loss = dist.distill_step(student, ema, dopt, teacher_module, bt,
                                                     dist.draw(g, bt))
        if i % 100 == 0:
            print(f"# step {i}: loss {float(loss):.5f}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    post = float(torch.mean(torch.abs(ref - one_step(ema.unet))))
    print(json.dumps({
        "metric": "tiny-scale LCM distillation: L1(student ONE-step f(x_T,T), teacher "
                  "%d-step ODE endpoint, same x_T)" % cfg.num_ddim_steps,
        "pre_distill_l1": round(pre, 4),
        "post_distill_l1": round(post, 4),
        "improvement_pct": round(100 * (pre - post) / max(pre, 1e-9), 1),
        "teacher_selfdrift_l1_8v4step": round(self_drift, 4),
        "distill_steps": args.steps,
        "train_s": round(train_s, 1),
        "note": "tiny-scale evidence that the distillation converges toward the teacher; "
                "the real-checkpoint quality table waits for the weights (the protocol: "
                "`python -m anyedit_tpu_torch distill --eval-count N`, then `eval` on both "
                "eval dirs)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
