"""LCM quality gate at a tiny trained scale, on the card: the twin of
`tools/lcm_quality_gate.py` (the same protocol and JSON keys): a
CLIP / dirCLIP / L1 / pass-rate table of the teacher's DDIM edits against
the distilled student's few-step edits, scored by the port's evaluation
harness (`runtime/evaluate.py::evaluate_pairs`, the post-filter thresholds).

  stage 0  toy edit domain: solid-colour 32 px images; the task is
           tone_transfer "make it {colour}" (a gated type whose predicate
           is computable from CLIP and L1)
  stage 1  train a tiny VAE (reconstruction) so the latents carry colour
  stage 2  train a tiny CLIP contrastively on (image, "a {c} photo")
  stage 3  train the tiny IP2P teacher UNet (eps-MSE, [x_t | orig] layout)
  stage 4  LCM-distil it (`train/distill.py`, CFG softened to 2.0 / 1.0 as
           `tools/distill_quality_torch.py` explains; production keeps
           8.0 / 0.9)
  stage 5  edit held-out pairs with the teacher's 8-step DDIM and the
           student's K-step consistency sampling from the same x_T, decode,
           and score both with `evaluate_pairs`

Every stage trains with `train/optim.py` (as optax.adam: no decay, no
clipping), in fp32. Prints one JSON line: {"teacher": {clip_out, dir_clip,
l1, pass_rate}, "student": {...}, "no_distill_student": {...} (the teacher's
weights in the consistency sampler: what `run --lcm-steps` does without
`distill`), "student_1step", "no_distill_1step", "pass_rate_delta", ...},
and the device on standard error.

    python3 tools/lcm_quality_gate_torch.py [distill_steps] [--fast] [--device cpu]

Runs on the card by default ("cuda"; raises without CUDA); `--device cpu`
asks for the CPU. The draws come from `torch.Generator` and numpy seeds
(jax.random draws other numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COLORS = {"red": (220, 40, 30), "green": (40, 200, 50), "blue": (30, 60, 210)}
CAPTIONS = {c: f"a {c} photo" for c in COLORS}
EOT = 255
MAX_LEN = 16
RES = 32
# the JAX tool's step counts (full, --fast)
VAE_STEPS, VAE_STEPS_FAST = 500, 150
CLIP_STEPS = 600
TEACHER_STEPS, TEACHER_STEPS_FAST = 1200, 400
DISTILL_STEPS, DISTILL_STEPS_FAST = 1500, 300
TEACHER_BATCH = 6


def _image(color, seed=0):
    rng = np.random.default_rng(seed)
    base = np.asarray(COLORS[color], np.float32)[None, None]
    img = base + rng.normal(0.0, 6.0, (RES, RES, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _ids(text):
    b = list(text.encode("utf-8"))[: MAX_LEN - 1] + [EOT]
    return np.asarray(b + [0] * (MAX_LEN - len(b)), np.int64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("steps", nargs="?", type=int, default=DISTILL_STEPS)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.diffusion.ip2p import ip2p_edit
    from anyedit_tpu_torch.models.clip import (
        TINY_TEXT, TINY_VISION, CLIPTextEncoder, CLIPTextModel, CLIPVisionEncoder,
    )
    from anyedit_tpu_torch.models.unet_sd import TINY_UNET, UNet2DCondition
    from anyedit_tpu_torch.models.vae import TINY_VAE, AutoencoderKL
    from anyedit_tpu_torch.ops.resize import resize_image
    from anyedit_tpu_torch.runtime.evaluate import evaluate_pairs
    from anyedit_tpu_torch.schedulers import add_noise
    from anyedit_tpu_torch.train.distill import DistillConfig, LCMDistiller, lcm_edit
    from anyedit_tpu_torch.weights.init import seeded_init_
    from tools.distill_quality_torch import adam, device_line

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lcm_quality_gate_torch: CUDA is not available; pass --device cpu "
                           "to run on the CPU")
    print(f"# device: {device_line(dev)}", file=sys.stderr, flush=True)
    distill_steps = min(args.steps, DISTILL_STEPS_FAST) if args.fast else args.steps
    t_start = time.perf_counter()
    names = sorted(COLORS)
    f32 = dict(dtype=torch.float32)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)

    def train(module, loss_fn, steps, lr, stop=None):
        """`steps` Adam steps of `loss_fn()` on `module`'s parameters; stops
        early once the loss is below `stop`. Returns the last loss."""
        params = dict(module.requires_grad_(True).named_parameters())
        masters = {k: v.detach() for k, v in params.items()}
        tx = adam(lr)
        opt = tx.init(masters)
        loss = float("nan")
        for _ in range(steps):
            lv = loss_fn()
            grads = torch.autograd.grad(lv, list(params.values()))
            opt = tx.update_(masters, dict(zip(params, grads)), opt)
            loss = float(lv.detach())
            if stop is not None and loss < stop:
                break
        module.requires_grad_(False)
        return loss

    def px(img_u8):
        return torch.as_tensor(img_u8, device=dev).float()[None] / 127.5 - 1.0

    # ---- stage 1: the tiny VAE, trained to reconstruct the toy domain -----
    vae_cfg = dataclasses.replace(TINY_VAE, **f32)
    vae = seeded_init_(AutoencoderKL(vae_cfg, device=dev), 0)
    sf = vae_cfg.scaling_factor
    lhw = RES // (2 ** (len(vae_cfg.block_channels) - 1))

    def vae_loss():
        x = torch.cat([px(_image(names[i % 3], int(s)))
                       for i, s in enumerate(rng.integers(0, 10_000, 8))])
        mean, logvar = vae.encode(x)
        kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1 - logvar)
        return torch.mean((vae.decode(mean) - x) ** 2) + 1e-4 * kl

    vl = train(vae, vae_loss, VAE_STEPS_FAST if args.fast else VAE_STEPS, 2e-3)
    print(f"# stage1 VAE recon mse {vl:.5f} ({time.perf_counter() - t_start:.0f}s)",
          file=sys.stderr, flush=True)

    @torch.no_grad()
    def encode(x):
        return vae.encode(x)[0] * sf

    @torch.no_grad()
    def decode(z):
        return vae.decode(z / sf)

    # ---- stage 2: the tiny CLIP (contrastive) -------------------------------
    vis_cfg = dataclasses.replace(TINY_VISION, **f32)
    txt_cfg = dataclasses.replace(TINY_TEXT, **f32)
    vis = seeded_init_(CLIPVisionEncoder(vis_cfg, device=dev), 0)
    txt = seeded_init_(CLIPTextModel(txt_cfg, proj_dim=vis_cfg.proj_dim, device=dev), 1)
    clip = torch.nn.ModuleDict({"vis": vis, "txt": txt})

    def clip_px(img_u8):
        s = vis_cfg.image_size
        return (resize_image(torch.as_tensor(img_u8, device=dev).float() / 255.0, s, s,
                             "bilinear") * 2.0 - 1.0)[None]

    pixels = torch.cat([clip_px(_image(c)) for c in names])
    ids = torch.from_numpy(np.stack([_ids(CAPTIONS[c]) for c in names])).to(dev)
    labels = torch.arange(len(names), device=dev)

    def clip_loss():
        logits = (vis(pixels)[1] @ txt(ids).T) / 0.07
        return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))

    cl = train(clip, clip_loss, CLIP_STEPS, 3e-3, stop=1e-3)
    if not cl < 0.05:
        raise RuntimeError(f"tiny CLIP failed to align: {cl}")
    print(f"# stage2 CLIP loss {cl:.5f}", file=sys.stderr, flush=True)

    @torch.no_grad()
    def clip_image(img_u8):
        return vis(clip_px(img_u8))[1].cpu().numpy()

    @torch.no_grad()
    def clip_text(text):
        return txt(torch.from_numpy(_ids(text))[None].to(dev)).cpu().numpy()

    # ---- stage 3: the tiny IP2P teacher --------------------------------------
    # the conditioning context: a frozen random text encoder (instructions
    # need only distinct embeddings for the teacher to condition on)
    unet_cfg = dataclasses.replace(TINY_UNET, in_channels=8, **f32)
    ctx_enc = seeded_init_(CLIPTextEncoder(dataclasses.replace(
        txt_cfg, hidden=unet_cfg.context_dim), device=dev), 9).requires_grad_(False)

    @torch.no_grad()
    def ctx_of(text):
        return ctx_enc(torch.from_numpy(_ids(text))[None].to(dev))[0][0]

    instr = {c: f"make it {c}" for c in names}
    ctx_cache = {c: ctx_of(instr[c]) for c in names}
    uncond_ctx = ctx_of("")
    unet = seeded_init_(UNet2DCondition(unet_cfg, device=dev), 5)
    dist = LCMDistiller(DistillConfig(unet=unet_cfg, num_ddim_steps=8, guidance_scale=2.0,
                                      image_guidance_scale=1.0, ema_decay=0.9,
                                      learning_rate=1e-3), device=dev)
    dcfg, ns = dist.cfg, dist.ns
    b = TEACHER_BATCH

    def teacher_batch():
        """(orig latents, edited latents, ctx) for random ordered colour pairs."""
        src = rng.integers(0, 3, b)
        dst = (src + rng.integers(1, 3, b)) % 3
        seeds = rng.integers(0, 10_000, b)
        origs = torch.cat([px(_image(names[s], int(k))) for s, k in zip(src, seeds)])
        edits = torch.cat([px(_image(names[d], int(k) + 77)) for d, k in zip(dst, seeds)])
        return encode(origs), encode(edits), torch.stack([ctx_cache[names[d]] for d in dst])

    def teacher_loss():
        ol, el, cx = teacher_batch()
        t = torch.randint(0, ns.num_train_steps, (b,), generator=g, device=dev)
        noise = torch.randn(el.shape, generator=g, device=dev)
        eps = unet(torch.cat([add_noise(ns, el, noise, t), ol], dim=-1), t, cx)
        return torch.mean((eps.float() - noise) ** 2)

    tl = train(unet, teacher_loss, TEACHER_STEPS_FAST if args.fast else TEACHER_STEPS, 2e-3)
    print(f"# stage3 teacher mse {tl:.4f}", file=sys.stderr, flush=True)

    # ---- stage 4: distil ------------------------------------------------------
    teacher_sd = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    teacher, student, ema, dstate = dist.init(teacher_sd)
    for i in range(distill_steps):
        ol, el, cx = teacher_batch()
        batch = {"edited_latents": el, "orig_latents": ol, "text_emb": cx,
                 "uncond_emb": uncond_ctx[None].expand_as(cx)}
        student, ema, dstate, dl = dist.distill_step(student, ema, dstate, teacher, batch,
                                                     dist.draw(g, batch))
        if i % 300 == 0:
            print(f"# stage4 distill step {i}: loss {float(dl):.5f}", file=sys.stderr,
                  flush=True)

    # ---- stage 5: edit held-out pairs, score through the eval harness --------
    def teacher_edit(ol, cx, x_T, gen):
        return ip2p_edit(teacher, ns, ol, cx, uncond_ctx[None].expand_as(cx),
                         num_steps=dcfg.num_ddim_steps, guidance_scale=dcfg.guidance_scale,
                         image_guidance_scale=dcfg.image_guidance_scale, init_latents=x_T)

    def student_edit(module, n_steps=4):
        def run(ol, cx, x_T, gen):
            return lcm_edit(module, ns, dcfg, ol, cx, num_steps=n_steps, x_init=x_T,
                            generator=gen)
        return run

    def to_u8(dec_px):
        return torch.clamp((dec_px[0] + 1.0) * 127.5, 0, 255).to(torch.uint8).cpu().numpy()

    class TB:
        extra: dict = {}
    tb = TB()
    tb.clip_image, tb.clip_text = clip_image, clip_text

    # 3 held-out seeds per (src, dst) colour pair: 18 scored entries an
    # editor; the 1-step rows isolate what distillation buys
    pairs = [(s, d, r) for s in names for d in names if s != d for r in range(3)]
    editors = {"teacher": teacher_edit, "student": student_edit(ema.unet),
               "no_distill_student": student_edit(teacher),
               "student_1step": student_edit(ema.unet, 1),
               "no_distill_1step": student_edit(teacher, 1)}
    tables = {}
    with torch.no_grad():
        for editor_name, run in editors.items():
            entries, imgs = [], []
            for j, (s, d, r) in enumerate(pairs):
                orig_u8 = _image(s, seed=60_000 + j)          # held-out noise draws
                ol = encode(px(orig_u8))
                x_T = torch.randn(ol.shape, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(80_000 + j))
                lat = run(ol, ctx_cache[d][None], x_T,
                          torch.Generator(device=dev).manual_seed(90_000 + j))
                rec = InstructionRecord(edit=instr[d], input=CAPTIONS[s], output=CAPTIONS[d],
                                        edit_type="tone_transfer", image_file=f"{s}_{d}_{r}.png")
                entries.append({"key": f"{s}->{d}#{r}", "record": rec.to_json(),
                                "payload": {}})
                imgs.append((orig_u8, to_u8(decode(lat))))
            it = iter(imgs)
            o = evaluate_pairs(tb, entries, lambda r, p: next(it))["overall"]
            tables[editor_name] = {"clip_out": o["clip_out"], "dir_clip": o["dir_clip"],
                                   "l1": o["l1"], "pass_rate": o["pass_rate"]}
            print(f"# stage5 {editor_name}: {tables[editor_name]}", file=sys.stderr,
                  flush=True)

    print(json.dumps({
        "metric": "tiny-trained LCM quality gate: tone_transfer over %d held-out colour-pair "
                  "edits, teacher %d-step DDIM vs student 4-step consistency (same x_T), "
                  "scored by evaluate_pairs with a trained tiny CLIP; *_1step rows isolate "
                  "the distillation effect" % (len(pairs), dcfg.num_ddim_steps),
        **tables,
        "pass_rate_delta": round(tables["student"]["pass_rate"]
                                 - tables["teacher"]["pass_rate"], 4),
        "distill_steps": distill_steps,
        "wall_s": round(time.perf_counter() - t_start, 1),
        "note": "no_distill_student = the teacher's weights in the consistency sampler (what "
                "--lcm-steps without `python -m anyedit_tpu_torch distill` does), the ablation "
                "the distillation must beat; the real-weights procedure: `python -m "
                "anyedit_tpu_torch distill --eval-count N`, then `eval` on both eval dirs",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
