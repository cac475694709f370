"""`python -m anyedit_tpu_torch` — the port's command line (counterpart of
`anyedit_tpu/cli.py`).

  run       stream records through pre_filter -> edit -> post_filter
  eval      score a run's edited pairs (CLIP / dirCLIP / L1 / SSIM / DINO,
            the post-filter pass rate per edit type)
  export    ledger -> reference-format result JSONs
  generate  captions -> instruction records (template or llama backend)
  convert   an official torch checkpoint -> the zoo's <slot>.safetensors;
            --plan prints the fetch-and-convert script for every registry
            name, --verify holds the source's HF module against the port's
            (where `transformers` is installed)
  bench     throughput benchmark (`tools/bench_torch_ip2p.py`)
  train     AnySD Stage-II fine-tune from a factory success ledger
  edit      edit one image with a trained AnySD adapter checkpoint
  distill   LCM-distill the IP2P editor into the few-step student that
            `run --lcm-steps` serves, with teacher / student eval run dirs

The flags and defaults are the JAX commands', plus `--device` (default
"cuda": the card; "cpu" where the caller asks for it; without CUDA,
"cuda" raises). A weights directory (`run --weights`, `eval --weights`,
`generate --weights`, `train` / `edit` / `distill --weights-dir`) holds
`<slot>.safetensors` files as `convert` writes them, under the JAX zoo's
slot names, and the tokenizer assets; Flax `.msgpack` trees are refused.
`main(argv, params=...)` takes Flax trees by slot name instead ("vae",
"clip_text", "clip_vision", "unet_ip2p" for `train` / `edit` / `distill`,
the zoo's slot names and "llama" for `run` / `generate`), which the tests
use; a slot given both ways is refused. Images are read with
`core/image.py::load_rgb`, which decodes PNG without Pillow; the GPU
machine has no Pillow, so inputs there must be PNG. In `train` and
`distill`, step s draws from `torch.Generator` seeded with (seed << 32) +
s, so a resumed run draws what an uninterrupted one would.

Data parallelism (the JAX mesh's `dp` axis; `core/dist.py`): `train` runs
under `torchrun --nproc_per_node N -m anyedit_tpu_torch train ...`, one
rank a card over NCCL (`--device cpu`: gloo), N = 1 included. N must
divide `--batch-size`;
every rank reads the same sampler stream, encodes its rows of each batch,
draws the whole batch's draws and keeps its rows, and averages the
gradients with the others, so the run computes what one process does at
that batch. Rank 0 alone writes the checkpoints and the validation grids
and prints; `--resume` reads the same step on every rank. `distill` stays
one process, as the JAX command does, and refuses a world above 1. The JAX
`tp` / `ep` axes have no counterpart.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _anysd_configs(tiny: bool):
    """(AnySDConfig, text_cfg, vis_cfg, vae_cfg) shared by train and edit."""
    import dataclasses

    import torch

    from anyedit_tpu_torch.models.clip import (
        CLIP_L_TEXT, CLIP_L_VISION, TINY_TEXT, TINY_VISION,
    )
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, TINY_UNET
    from anyedit_tpu_torch.models.vae import SD_VAE, TINY_VAE
    from anyedit_tpu_torch.train.anysd import AnySDConfig

    if tiny:
        f32 = dict(dtype=torch.float32)
        text_cfg = dataclasses.replace(TINY_TEXT, vocab_size=49408, max_len=16, **f32)
        vis_cfg = dataclasses.replace(TINY_VISION, **f32)
        vae_cfg = dataclasses.replace(TINY_VAE, **f32)
        unet_cfg = dataclasses.replace(TINY_UNET, in_channels=8,
                                       context_dim=text_cfg.hidden, **f32)
        num_experts = 4
    else:
        text_cfg, vis_cfg, vae_cfg = CLIP_L_TEXT, CLIP_L_VISION, SD_VAE
        unet_cfg = SD15_IP2P_UNET
        num_experts = 11
    cfg = AnySDConfig(unet=unet_cfg, num_experts=num_experts,
                      image_embed_dim=vis_cfg.proj_dim)
    return cfg, text_cfg, vis_cfg, vae_cfg


def cmd_edit(args, params=None) -> int:
    """Apply a trained AnySD adapter checkpoint to an image; writes a PNG."""
    from anyedit_tpu_torch.core.image import load_rgb
    from anyedit_tpu_torch.core.png import write_png
    from anyedit_tpu_torch.train.inference import AnySDEditor

    cfg, text_cfg, vis_cfg, vae_cfg = _anysd_configs(args.tiny)
    editor = AnySDEditor.from_checkpoint(
        cfg, args.checkpoint_dir, params=params, weights_dir=args.weights_dir,
        require_weights=args.require_weights, seed=args.seed,
        resolution=args.resolution, allow_fallback_tokenizers=args.tiny,
        text_cfg=text_cfg, vis_cfg=vis_cfg, vae_cfg=vae_cfg, device=args.device)
    out = editor.edit(load_rgb(args.image), args.instruction, args.edit_type,
                      steps=args.steps, text_scale=args.guidance,
                      image_scale=args.image_guidance, seed=args.seed)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    write_png(args.output, out)
    print(json.dumps({"output": str(args.output), "edit_type": args.edit_type,
                      "size": list(out.shape[:2])}))
    return 0


def cmd_train(args, params=None) -> int:
    """AnySD Stage-II fine-tune from a factory success ledger: mixture
    sampler -> encode on the device (no grad) -> adapter train step ->
    checkpoint / rotate / resume, with validation grids."""
    from anyedit_tpu_torch.core import dist

    dist.check_batch(args.batch_size, dist.env_world())     # refused before the group
    group = dist.from_env(args.device)
    try:
        return _train(args, params, group)
    finally:
        dist.destroy(group)


def _train(args, params, group) -> int:
    import torch

    from anyedit_tpu_torch.core.dist import barrier, batch_rows, is_main
    from anyedit_tpu_torch.core.image import load_rgb, pil_resize
    from anyedit_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from anyedit_tpu_torch.train.anysd import AnySDTrainer
    from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer
    from anyedit_tpu_torch.train.data import (
        MixtureSampler, examples_from_ledger, pixel_batches,
    )
    from anyedit_tpu_torch.train.frozen import load_frozen_encoders

    cfg, text_cfg, vis_cfg, vae_cfg = _anysd_configs(args.tiny)
    dev = torch.device(args.device) if group is None else group.device
    main = is_main(group)
    trainer = AnySDTrainer(cfg, learning_rate=args.lr, device=dev)
    res = args.resolution
    frozen = load_frozen_encoders(
        vae_cfg, text_cfg, vis_cfg, params=params, weights_dir=args.weights_dir,
        require=args.require_weights, seed=args.seed, device=dev,
        allow_fallback_tokenizers=args.tiny)
    vae, text, vision = frozen.vae, frozen.text, frozen.vision
    sf = vae_cfg.scaling_factor

    @torch.no_grad()
    def encode_batch(pixel):
        edited = torch.from_numpy(pixel["edited_px"]).to(dev)
        orig = torch.from_numpy(pixel["orig_px"]).to(dev)
        px = resize_image(orig * 0.5 + 0.5, vis_cfg.image_size, vis_cfg.image_size,
                          "bilinear")
        return {"edited_latents": vae.encode(edited)[0] * sf,
                "orig_latents": vae.encode(orig)[0] * sf,
                "text_emb": text(torch.from_numpy(pixel["text_ids"]).to(dev))[0],
                "image_embed": vision(imagenet_normalize(px))[1],
                "task_id": torch.from_numpy(pixel["task_id"]).long().to(dev)}

    unet, adapter, opt_state = trainer.init(args.seed, frozen.unet_tree,
                                             unet_state=frozen.unet_state)
    ckpt = TrainCheckpointer(args.checkpoint_dir, keep=args.keep_checkpoints,
                             save_interval_steps=args.checkpoint_every)
    start_step = 0
    if args.resume:
        step0, ad, op = ckpt.restore_latest(map_location=dev)
        if step0 is not None:
            adapter.load_state_dict(ad, strict=True)
            start_step, opt_state = step0, op
            if main:
                print(f"resumed from step {start_step}")

    examples = examples_from_ledger(args.ledger, args.image_root)
    if not examples:
        print("no trainable success records in ledger", file=sys.stderr)
        return 1
    sampler = MixtureSampler(examples, seed=args.seed)

    val_pairs = []
    if args.val_count > 0 and main:
        from anyedit_tpu_torch.train.inference import AnySDEditor
        from anyedit_tpu_torch.train.validation import log_validation

        for ex in examples[:args.val_count]:
            # the JAX trainer's `Image.resize((res, res))`: Pillow's default BICUBIC
            im = pil_resize(load_rgb(ex.input_file), res, res, "bicubic")
            val_pairs.append((im, ex.record.edit, ex.record.edit_type))
        editor = AnySDEditor(cfg, frozen, unet, resolution=res)

        def run_validation(step):
            path = log_validation(
                lambda im, it: editor.edit(im, it[0], it[1], adapter_params=adapter,
                                           steps=args.val_steps, seed=args.seed),
                [(im, (instr, et)) for im, instr, et in val_pairs],
                Path(args.checkpoint_dir) / "val", step)
            print(json.dumps({"validation_grid": str(path), "step": step}))

    losses = []
    last_val = -1
    bit = pixel_batches(sampler, args.batch_size, res, args.steps - start_step,
                        frozen.tokenize)
    for step, pixel in enumerate(bit, start=start_step):
        # every rank reads the whole batch's stream and encodes its rows
        batch = encode_batch(batch_rows(pixel, group))
        gen = torch.Generator(device=dev).manual_seed((args.seed << 32) + step)
        draws = trainer.draw(gen, batch, group)
        adapter, opt_state, loss = trainer.train_step(adapter, opt_state, unet, batch, draws,
                                                      group=group)
        losses.append(float(loss))
        if main and (step + 1) % args.log_every == 0:
            print(json.dumps({"step": step + 1, "loss": losses[-1]}))
        if (step + 1) % args.checkpoint_every == 0:
            if main:
                ckpt.save(step + 1, adapter, opt_state)
                if val_pairs:
                    run_validation(step + 1)
                    last_val = step + 1
            barrier(group)
    if main:
        ckpt.save(args.steps, adapter, opt_state)
        if val_pairs and last_val != args.steps:
            run_validation(args.steps)
        ckpt.wait()
        ckpt.close()
    barrier(group)
    if not main:
        return 0
    print(json.dumps({"final_step": args.steps,
                      "mean_loss": float(np.mean(losses)) if losses else None,
                      "examples": len(examples),
                      "mixture_types": sorted(sampler.buckets)}))
    return 0


def eval_draws(seed: int, j: int, shape, lcm_steps: int, device):
    """`distill`'s eval draws for held-out pair j: the start latents x_T
    that the teacher and the student share, and the student's
    lcm_steps - 1 re-noise draws, in that order from `torch.Generator`
    seeded with ((seed + 1) << 32) + j. (The JAX command draws x_T from
    fold_in(key(seed + 1), j) and the student's from fold_in(key,
    10_000 + j); torch draws other numbers, so a test hands those in here.)"""
    import torch
    gen = torch.Generator(device=device).manual_seed(((seed + 1) << 32) + j)
    x_T = torch.randn(shape, generator=gen, device=device)
    return x_T, [torch.randn(shape, generator=gen, device=device)
                 for _ in range(lcm_steps - 1)]


def cmd_distill(args, params=None) -> int:
    """LCM guidance distillation of the IP2P editor into the few-step
    student that `run --lcm-steps` serves (`unet_ip2p_lcm.safetensors`,
    the EMA target's fp32 masters as the port UNet's state dict).

    Data: (orig, edited, instruction) pairs of a factory success ledger
    through the trainer's mixture pipeline; the first min(eval_count,
    len - 1) examples are held out. The VAE means (x scaling factor), the
    instruction's and the empty prompt's CLIP text are encoded without
    grad; step s draws its grid indices and noise from `torch.Generator`
    seeded with (seed << 32) + s, so a resumed run draws what an
    uninterrupted one would. Checkpoints (the student's and the EMA's fp32
    masters and the optimizer state) rotate and resume as `train`'s. With
    `--eval-count N` it also writes <checkpoint-dir>/eval_teacher and
    eval_student: the held-out pairs edited by the teacher at
    --ddim-steps and by the student at --lcm-steps from the same x_T
    (`eval_draws`), ready for `eval`, and prints the L1 readout."""
    import dataclasses

    import torch

    from anyedit_tpu_torch.core.dist import env_world
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer
    from anyedit_tpu_torch.train.data import (
        MixtureSampler, examples_from_ledger, pixel_batches,
    )
    from anyedit_tpu_torch.train.distill import DistillConfig, LCMDistiller
    from anyedit_tpu_torch.train.frozen import load_frozen_encoders
    from anyedit_tpu_torch.weights import bridge
    from anyedit_tpu_torch.weights.files import write_safetensors
    from anyedit_tpu_torch.weights.init import seeded_init_

    if env_world() > 1:
        raise RuntimeError(
            f"distill runs as one process, as the JAX command does (it builds no mesh); got "
            f"WORLD_SIZE={env_world()}: run it without torchrun (`LCMDistiller.distill_step` "
            f"takes a group for data-parallel distillation through the library)")
    anysd_cfg, text_cfg, vis_cfg, vae_cfg = _anysd_configs(args.tiny)
    ucfg = anysd_cfg.unet
    dcfg = DistillConfig(unet=ucfg, num_ddim_steps=args.ddim_steps, skip=args.skip,
                         guidance_scale=args.guidance,
                         image_guidance_scale=args.image_guidance,
                         ema_decay=args.ema_decay, learning_rate=args.lr)
    dev = torch.device(args.device)
    res = args.resolution
    frozen = load_frozen_encoders(
        vae_cfg, text_cfg, vis_cfg, params=params, weights_dir=args.weights_dir,
        require=args.require_weights, seed=args.seed, device=dev,
        allow_fallback_tokenizers=args.tiny)
    if frozen.unet_tree is not None:
        teacher_sd = bridge.unet_state_dict(frozen.unet_tree, len(ucfg.block_channels),
                                            ucfg.use_linear_projection)
    elif frozen.unet_state is not None:
        teacher_sd = frozen.unet_state            # the converted IP2P checkpoint
    else:
        # no teacher given (--require-weights raised above): seeded in fp32,
        # as the zoo seeds its slots
        fp32 = dataclasses.replace(ucfg, dtype=torch.float32)
        teacher_sd = seeded_init_(UNet2DCondition(fp32, device=dev), args.seed).state_dict()
    dist = LCMDistiller(dcfg, device=dev)
    teacher, student, ema, opt_state = dist.init(teacher_sd)
    del teacher_sd
    sf = vae_cfg.scaling_factor
    uncond_ids = torch.from_numpy(frozen.tokenize("")).to(dev)

    @torch.no_grad()
    def encode(pixel):
        hidden = frozen.text(torch.from_numpy(pixel["text_ids"]).to(dev))[0]
        u_hidden = frozen.text(uncond_ids)[0]
        return {"edited_latents":
                frozen.vae.encode(torch.from_numpy(pixel["edited_px"]).to(dev))[0] * sf,
                "orig_latents": frozen.vae.encode(torch.from_numpy(pixel["orig_px"]).to(dev))[0] * sf,
                "text_emb": hidden, "uncond_emb": u_hidden.expand_as(hidden)}

    ckpt = TrainCheckpointer(args.checkpoint_dir, keep=args.keep_checkpoints,
                             save_interval_steps=args.checkpoint_every)
    start_step = 0
    if args.resume:
        step0, masters, op = ckpt.restore_latest(map_location=dev)
        if step0 is not None:
            student.masters, ema.masters = masters["student"], masters["ema"]
            student.sync_()
            ema.sync_()
            start_step, opt_state = step0, op
            print(f"resumed from step {start_step}")

    examples = examples_from_ledger(args.ledger, args.image_root)
    if not examples:
        print("no trainable success records in ledger", file=sys.stderr)
        return 1
    # hold out the eval set from training when there are examples to spare
    n_eval = min(args.eval_count, max(0, len(examples) - 1))
    train_ex = examples[n_eval:] if len(examples) > n_eval else examples
    sampler = MixtureSampler(train_ex, seed=args.seed)

    losses = []
    for i, pixel in enumerate(pixel_batches(sampler, args.batch_size, res,
                                            args.steps - start_step, frozen.tokenize),
                              start=start_step):
        batch = encode(pixel)
        gen = torch.Generator(device=dev).manual_seed((args.seed << 32) + i)
        draws = dist.draw(gen, batch)
        student, ema, opt_state, loss = dist.distill_step(student, ema, opt_state, teacher,
                                                          batch, draws)
        losses.append(float(loss))
        if (i + 1) % args.log_every == 0:
            print(json.dumps({"step": i + 1, "loss": losses[-1]}))
        ckpt.save(i + 1, {"student": student.masters, "ema": ema.masters}, opt_state)
    ckpt.wait()
    ckpt.close()

    out = Path(args.out or (Path(args.weights_dir or args.checkpoint_dir)
                            / "unet_ip2p_lcm.safetensors"))
    out.parent.mkdir(parents=True, exist_ok=True)
    write_safetensors(out, ema.masters)

    report = {"final_step": args.steps, "student_checkpoint": str(out),
              "mean_loss": float(np.mean(losses)) if losses else None,
              "examples": len(train_ex)}
    if n_eval > 0:
        report["quality"] = _distill_eval(args, dcfg, dist, teacher, ema, frozen,
                                          examples[:n_eval], res)
    print(json.dumps(report, indent=1))
    return 0


def _distill_eval(args, dcfg, dist, teacher, ema, frozen, eval_ex, res) -> dict:
    """Teacher-vs-student readout on the held-out ledger pairs: both
    editors start from the same x_T (the consistency function approximates
    the teacher ODE's endpoint map), the teacher's 3-way-CFG DDIM at
    --ddim-steps (`diffusion/ip2p.py::ip2p_edit`), the student's
    `lcm_edit` at --lcm-steps. Writes eval_teacher/ and eval_student/ (PNGs
    through `core/png.py`, a `RunLedger` each) and returns the L1 summary."""
    import torch

    from anyedit_tpu_torch.core.ledger import RunLedger
    from anyedit_tpu_torch.core.png import write_png
    from anyedit_tpu_torch.diffusion.ip2p import ip2p_edit
    from anyedit_tpu_torch.ops.resize import denormalize_to_u8
    from anyedit_tpu_torch.train.data import _load_resized
    from anyedit_tpu_torch.train.distill import lcm_edit

    dev = dist.device
    vae, text = frozen.vae, frozen.text
    sf = vae.cfg.scaling_factor
    uncond_ids = torch.from_numpy(frozen.tokenize("")).to(dev)
    dirs = {}
    for name in ("eval_teacher", "eval_student"):
        d = Path(args.checkpoint_dir) / name
        (d / "edited_img").mkdir(parents=True, exist_ok=True)
        (d / "input_img").mkdir(parents=True, exist_ok=True)
        dirs[name] = (d, RunLedger(d / "ledger.jsonl"))

    lat_l1, px_l1, edit_mag = [], [], []
    with torch.no_grad():
        for j, ex in enumerate(eval_ex):
            orig = torch.from_numpy(_load_resized(ex.input_file, res)[None]).to(dev)
            ids = torch.from_numpy(frozen.tokenize(ex.record.edit)).to(dev)
            img_lat = vae.encode(orig)[0] * sf
            cond, uncond = text(ids)[0], text(uncond_ids)[0]
            x_T, renoise = eval_draws(args.seed, j, tuple(img_lat.shape), args.lcm_steps, dev)
            t_lat = ip2p_edit(teacher, dist.ns, img_lat, cond, uncond,
                              num_steps=dcfg.num_ddim_steps,
                              guidance_scale=dcfg.guidance_scale,
                              image_guidance_scale=dcfg.image_guidance_scale,
                              init_latents=x_T)
            s_lat = lcm_edit(ema.unet, dist.ns, dcfg, img_lat, cond, args.lcm_steps,
                             x_init=x_T, renoise=renoise)
            lat_l1.append(float(torch.mean(torch.abs(t_lat - s_lat))))
            t_px = vae.decode(t_lat / sf).float()
            s_px = vae.decode(s_lat / sf).float()
            px_l1.append(float(torch.mean(torch.abs(t_px - s_px))) / 2.0)
            edit_mag.append(float(torch.mean(torch.abs(t_px - orig))) / 2.0)
            orig_u8 = denormalize_to_u8(orig[0]).cpu().numpy()
            for name, px in (("eval_teacher", t_px), ("eval_student", s_px)):
                d, led = dirs[name]
                ep = d / "edited_img" / f"eval_{j}.png"
                ip = d / "input_img" / f"eval_{j}.png"
                write_png(ep, denormalize_to_u8(px[0]).cpu().numpy())
                write_png(ip, orig_u8)
                led.mark(ex.record, "success", {"edited_file": str(ep), "input_file": str(ip)})
    for _, led in dirs.values():
        led.close()
    return {
        "pairs": len(eval_ex),
        "teacher_steps": dcfg.num_ddim_steps,
        "student_steps": args.lcm_steps,
        "latent_l1_teacher_vs_student": round(float(np.mean(lat_l1)), 4),
        "pixel_l1_teacher_vs_student": round(float(np.mean(px_l1)), 4),
        "pixel_l1_teacher_vs_orig": round(float(np.mean(edit_mag)), 4),
        "eval_dirs": {k: str(v[0]) for k, v in dirs.items()},
        "next": "run `python -m anyedit_tpu_torch eval --run-dir <dir>` on both eval "
                "dirs for the CLIP/dirCLIP/pass-rate quality-delta table",
    }


def _add_shard_args(p):
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--shard-count", type=int, default=1)
    p.add_argument("--start-idx", type=int, default=None)
    p.add_argument("--end-idx", type=int, default=None)


def _zoo_cfg(args):
    import dataclasses

    from anyedit_tpu_torch.runtime.zoo import ZooConfig, tiny_zoo_config
    cfg = tiny_zoo_config() if args.tiny else ZooConfig()
    if getattr(args, "int8", False):
        cfg = dataclasses.replace(cfg, quant_ip2p=True, quant_diffusion=True)
    if getattr(args, "lcm_steps", 0):
        cfg = dataclasses.replace(cfg, lcm_steps=args.lcm_steps)
    return cfg


def cmd_run(args, params=None) -> int:
    """Stream records through the factory: the slots the records' edit
    types need (`SLOTS_FOR_EDIT_TYPE`) plus the gate scorers, the IP2P
    editor only for color_alter / tone_transfer / style_change, then
    `FactoryExecutor` (chunk mode with --ground-batch > 0)."""
    from anyedit_tpu_torch.core.ledger import Shard
    from anyedit_tpu_torch.core.schema import read_records
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor
    from anyedit_tpu_torch.runtime.zoo import SLOTS_FOR_EDIT_TYPE, ModelZoo

    records = read_records(args.instruction_json)
    if args.edit_type:
        records = [r for r in records if r.edit_type == args.edit_type]
    if not records:
        print("no records to process", file=sys.stderr)
        return 1

    zoo_cfg = _zoo_cfg(args)
    zoo = ModelZoo(zoo_cfg, device=args.device, seed=args.seed, params=params,
                   weights_dir=args.weights, require_weights=args.require_weights)
    types = {r.edit_type for r in records}
    # the WYS-IP2P editor backs color / tone / style (and appearance's fallback)
    needs_ip2p = bool(types & {"color_alter", "tone_transfer", "style_change"})
    slots = [s for t in sorted(types) for s in SLOTS_FOR_EDIT_TYPE.get(t, ())]
    slots += ["clip", "aesthetic"]          # the filter gates' scorers
    if types & {"background_change", "color_alter"}:
        slots += ["vqa"]
    tb = zoo.toolbox(with_diffusion=needs_ip2p, slots=slots)
    loaders = record_loaders(Path(args.image_root), zoo_cfg.canvas.edit_size)
    tb.extra.setdefault("load_visual", loaders["load_visual"])
    tb.extra.setdefault("load_rotation_pair", loaders["load_rotation_pair"])

    ex = FactoryExecutor(tb, ExecutorConfig(
        output_root=args.output, seed=args.seed,
        run_pre_filter=not args.no_filters, run_post_filter=not args.no_filters,
        profile_trace_dir=args.profile_trace, grounding_batch=args.ground_batch))
    shard = Shard(args.shard_index, args.shard_count, args.start_idx, args.end_idx)
    report = ex.run(records, loaders["load_image"], shard=shard)
    print(json.dumps(report, indent=2))
    return 0


def record_loaders(image_root: Path, canvas: int) -> dict:
    """`run`'s image hooks: "load_image" (a neutral 127 canvas when the
    record has no image_file: composition and textual_change synthesize
    both sides), "load_visual" (the record's visual_input under
    image_root, else the record's own image) and "load_rotation_pair"
    (extras["rotation"] = {frame_a, frame_b (paths), q1, q2 (wxyz)}: the
    capture pair and its COLMAP quaternions, or None)."""
    from anyedit_tpu_torch.core.image import load_rgb

    def load_image(rec):
        if not rec.image_file:
            return np.full((canvas, canvas, 3), 127, np.uint8)
        return load_rgb(image_root / rec.image_file)

    def load_visual(rec):
        if rec.visual_input and (image_root / rec.visual_input).exists():
            return load_rgb(image_root / rec.visual_input)
        return load_image(rec)

    def load_rotation_pair(rec):
        rot = rec.extras.get("rotation")
        if not rot:
            return None
        return (load_rgb(image_root / rot["frame_a"]), load_rgb(image_root / rot["frame_b"]),
                np.asarray(rot["q1"], np.float64), np.asarray(rot["q2"], np.float64))
    return {"load_image": load_image, "load_visual": load_visual,
            "load_rotation_pair": load_rotation_pair}


def cmd_eval(args, params=None) -> int:
    """Score a finished run's edited pairs (`runtime/evaluate.py`) on a
    bare Toolbox with only the CLIP towers and the DINO embedding."""
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.runtime.evaluate import default_loader, evaluate_pairs, run_dir_entries
    from anyedit_tpu_torch.runtime.zoo import ModelZoo

    entries = run_dir_entries(args.run_dir)
    if not entries:
        print("no success entries in ledger", file=sys.stderr)
        return 1
    zoo = ModelZoo(_zoo_cfg(args), device=args.device, seed=args.seed, params=params,
                   weights_dir=args.weights, require_weights=args.require_weights)
    tb = Toolbox(ground=None, inpaint=None)
    zoo.install(tb, "clip")
    zoo.install(tb, "dino")
    report = evaluate_pairs(tb, entries, default_loader(args.run_dir, args.image_root))
    with open(args.output, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"overall": report["overall"], "per_type": report["per_type"]}))
    return 0


def cmd_export(args, params=None) -> int:
    from anyedit_tpu_torch.core.ledger import RunLedger
    led = RunLedger(args.ledger)
    led.export_reference_files(args.output, args.start or 0, args.end)
    led.close()
    print(f"exported to {args.output}")
    return 0


def _llama(args, params):
    """The instruction generator's Llama: TINY_LLAMA with --tiny, else
    Llama-3-8B (W8A8 with --int8); from `params["llama"]` (a Flax tree),
    else `<weights>/llama.safetensors`, else seeded."""
    import dataclasses

    import torch

    from anyedit_tpu_torch.models.llama import LLAMA3_8B, TINY_LLAMA, Llama, quantize_llama
    from anyedit_tpu_torch.weights import bridge
    from anyedit_tpu_torch.weights.files import read_safetensors
    from anyedit_tpu_torch.weights.init import seeded_init_

    cfg = TINY_LLAMA if args.tiny else LLAMA3_8B
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("generate: device cuda requested but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    model = Llama(cfg, device=args.device)
    wf = Path(args.weights) / "llama.safetensors" if args.weights else None
    if params and "llama" in params:
        if wf is not None and wf.exists():
            raise ValueError(f"llama is given both in params= and as {wf}")
        model.load_state_dict(bridge.llama_state_dict(params["llama"]), strict=True)
    elif wf is not None and wf.exists():
        model.load_state_dict(read_safetensors(wf), strict=True)
    elif args.require_weights:
        raise FileNotFoundError(f"required weights missing: {wf} (for Llama); convert the "
                                "checkpoint first or drop --require-weights")
    else:
        seeded_init_(model, args.seed)
    model = model.eval().requires_grad_(False)
    return quantize_llama(model) if args.int8 and not args.tiny else model


def cmd_generate(args, params=None) -> int:
    """Captions -> instruction-record JSONL: few-shot prompt -> LLM generate
    -> parse -> self-check; the rule-based types (counting, relation,
    resize, movement) go to the rule generators. Backends: `template`
    (deterministic) or `llama` (byte tokens; random weights give
    throughput only)."""
    import random as _random

    from anyedit_tpu_torch.core.schema import write_records
    from anyedit_tpu_torch.grounding.tags import generate_tags
    from anyedit_tpu_torch.instructions.generator import (
        InstructionGenerator, LlamaBackend, TemplateBackend, rule_based_counting,
        rule_based_relation, rule_based_resize_movement,
    )

    captions = [ln.strip() for ln in open(args.captions) if ln.strip()][:args.limit or None]
    rng = _random.Random(args.seed)

    if args.edit_type in ("counting", "resize", "movement", "relation"):
        recs = []
        for cap in captions:
            nouns = generate_tags(cap)["nouns"]
            if not nouns:
                continue
            if args.edit_type == "counting":
                recs.append(rule_based_counting(cap, nouns[0], rng.randint(2, 6), rng))
            elif args.edit_type == "relation":
                if len(nouns) >= 2:
                    recs.append(rule_based_relation(cap, nouns[0], nouns[1]))
            else:
                recs.append(rule_based_resize_movement(cap, nouns[0], args.edit_type, rng))
    else:
        if args.backend == "llama":
            model = _llama(args, params)
            v = model.lm_cfg.vocab_size
            tokenize = lambda s: [1 + (b % (v - 2)) for b in s.encode()][-1024:]  # noqa: E731
            detok = lambda ids: bytes((max(0, i - 1) % 256)  # noqa: E731
                                      for i in ids).decode("utf-8", "replace")
            llm = LlamaBackend(model, tokenize, detok, batch_size=args.batch_size)
        else:
            llm = TemplateBackend()
        gen = InstructionGenerator(llm=llm, seed=args.seed, self_check=not args.no_self_check,
                                   n_shots=args.shots)
        recs = gen.generate(args.edit_type, captions, batch_size=args.batch_size)

    write_records(args.output, recs)
    print(json.dumps({"captions": len(captions), "records": len(recs),
                      "output": args.output}))
    return 0


def cmd_convert(args, params=None) -> int:
    """An official torch checkpoint -> the zoo's `<slot>.safetensors`
    (`weights/bootstrap.py`; no JAX, Flax or safetensors package). `--plan`
    prints the fetch-and-convert script for every registry name
    (`weights/manifest.py`); `--verify` holds the source's HF module
    against the converted port module first (`weights/verify.py`; needs
    `transformers`) and writes nothing when they disagree."""
    from anyedit_tpu_torch.weights.bootstrap import REGISTRY, convert_checkpoint
    if args.list:
        for k, e in sorted(REGISTRY.items()):
            print(f"{k:16s} ← {e.hint}")
        return 0
    if args.plan is not None:
        from anyedit_tpu_torch.weights.manifest import emit_plan
        print(emit_plan(args.plan, args.weights_dir), end="")
        return 0
    if args.model is None or args.src is None:
        print("convert needs --model and --src (or --list / --plan)", file=sys.stderr)
        return 2
    out = args.out or str(Path(args.weights_dir) / f"{args.model}.safetensors")
    if args.verify:
        from anyedit_tpu_torch.weights.verify import verify_conversion
        err = verify_conversion(args.model, args.src)
        print(f"verify {args.model}: max abs err {err:.3e}")
    convert_checkpoint(args.model, args.src, out)
    print(f"wrote {out}")
    return 0


def cmd_bench(args, params=None) -> int:
    """`tools/bench_torch_ip2p.py`'s main (bench.py's workload on the
    card), loaded by path from the repository root."""
    import importlib.util

    if args.device != "cuda":
        print("bench runs on the card only (--device cuda)", file=sys.stderr)
        return 2
    path = Path(__file__).resolve().parents[1] / "tools" / "bench_torch_ip2p.py"
    spec = importlib.util.spec_from_file_location("bench_torch_ip2p", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv, sys.argv = sys.argv, [str(path)]
    try:
        return mod.main()
    finally:
        sys.argv = argv


def main(argv=None, params=None) -> int:
    """`params`: Flax trees by slot name (see the module docstring)."""
    p = argparse.ArgumentParser(prog="anyedit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run editing pipelines over a record stream "
                                    "(images: PNG; the GPU machine has no Pillow)")
    pr.add_argument("--instruction-json", required=True)
    pr.add_argument("--image-root", required=True)
    pr.add_argument("--edit-type", default=None)
    pr.add_argument("--output", default="out")
    pr.add_argument("--weights", default=None,
                    help="dir of converted <slot>.safetensors checkpoints "
                         "(`convert`) and tokenizer assets")
    pr.add_argument("--require-weights", action="store_true",
                    help="refuse to run any model slot without its converted "
                         "<slot>.safetensors (no silent random init)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--profile-trace", default=None,
                    help="write a torch.profiler trace here")
    pr.add_argument("--tiny", action="store_true",
                    help="tiny random-weight models (hermetic smoke runs)")
    pr.add_argument("--ground-batch", type=int, default=8,
                    help="device-batch N records' first grounding (0=off)")
    pr.add_argument("--no-filters", action="store_true",
                    help="skip pre/post gates (random-weight smoke runs)")
    pr.add_argument("--int8", action="store_true",
                    help="W8A8 int8 UNet fast mode for the IP2P editor (ops/quant.py)")
    pr.add_argument("--lcm-steps", type=int, default=0,
                    help="distilled few-step consistency editor for the IP2P slot "
                         "(train/distill.py; loads unet_ip2p_lcm.safetensors when "
                         "present). 0 = off")
    _add_shard_args(pr)
    pr.add_argument("--device", default="cuda")
    pr.set_defaults(fn=cmd_run)

    pt = sub.add_parser("train", help="AnySD fine-tune from a success ledger")
    pt.add_argument("--ledger", required=True)
    pt.add_argument("--image-root", default=None)
    pt.add_argument("--steps", type=int, default=1000)
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--resolution", type=int, default=256)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--checkpoint-dir", default="ckpt")
    pt.add_argument("--checkpoint-every", type=int, default=500)
    pt.add_argument("--keep-checkpoints", type=int, default=3)
    pt.add_argument("--log-every", type=int, default=10)
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--tiny", action="store_true")
    pt.add_argument("--weights-dir", default=None,
                    help="dir of converted <slot>.safetensors frozen towers (vae / "
                         "clip_text / clip_vision / unet_ip2p) and tokenizer assets")
    pt.add_argument("--require-weights", action="store_true",
                    help="error out if any frozen tower has no converted file")
    pt.add_argument("--val-count", type=int, default=4,
                    help="validation pairs per grid (0 disables grids)")
    pt.add_argument("--val-steps", type=int, default=20,
                    help="DDIM steps for validation edits")
    pt.add_argument("--device", default="cuda")
    pt.set_defaults(fn=cmd_train)

    pd = sub.add_parser("edit", help="edit one image with a trained AnySD "
                                     "adapter checkpoint")
    pd.add_argument("--image", required=True)
    pd.add_argument("--instruction", required=True)
    pd.add_argument("--edit-type", required=True)
    pd.add_argument("--checkpoint-dir", required=True,
                    help="checkpoint dir written by `train`")
    pd.add_argument("--output", default="edited.png", help="PNG path")
    pd.add_argument("--weights-dir", default=None,
                    help="dir of converted <slot>.safetensors frozen towers and "
                         "tokenizer assets")
    pd.add_argument("--require-weights", action="store_true")
    pd.add_argument("--resolution", type=int, default=256)
    pd.add_argument("--steps", type=int, default=20)
    pd.add_argument("--guidance", type=float, default=7.5)
    pd.add_argument("--image-guidance", type=float, default=1.5)
    pd.add_argument("--seed", type=int, default=0)
    pd.add_argument("--tiny", action="store_true")
    pd.add_argument("--device", default="cuda")
    pd.set_defaults(fn=cmd_edit)

    px = sub.add_parser("distill", help="LCM-distill the IP2P editor into the few-step "
                        "student (`run --lcm-steps` loads the resulting "
                        "unet_ip2p_lcm.safetensors)")
    px.add_argument("--ledger", required=True, help="factory success ledger (training pairs)")
    px.add_argument("--image-root", default=None)
    px.add_argument("--steps", type=int, default=2000)
    px.add_argument("--batch-size", type=int, default=8)
    px.add_argument("--resolution", type=int, default=512)
    px.add_argument("--lr", type=float, default=1e-5)
    px.add_argument("--ddim-steps", type=int, default=50,
                    help="teacher ODE grid (the factory's DDIM step count)")
    px.add_argument("--skip", type=int, default=1, help="grid skip k per consistency target")
    px.add_argument("--guidance", type=float, default=8.0)
    px.add_argument("--image-guidance", type=float, default=0.9)
    px.add_argument("--ema-decay", type=float, default=0.95)
    px.add_argument("--lcm-steps", type=int, default=4,
                    help="student sampling steps for the eval readout")
    px.add_argument("--eval-count", type=int, default=8,
                    help="held-out pairs for the teacher-vs-student quality readout "
                         "(0 disables)")
    px.add_argument("--seed", type=int, default=0)
    px.add_argument("--checkpoint-dir", default="distill_ckpt")
    px.add_argument("--checkpoint-every", type=int, default=500)
    px.add_argument("--keep-checkpoints", type=int, default=3)
    px.add_argument("--log-every", type=int, default=50)
    px.add_argument("--resume", action="store_true")
    px.add_argument("--tiny", action="store_true")
    px.add_argument("--weights-dir", default=None,
                    help="dir of converted <slot>.safetensors (teacher unet_ip2p, frozen "
                         "vae / clip_text / clip_vision) and tokenizer assets; the student "
                         "is written here")
    px.add_argument("--require-weights", action="store_true")
    px.add_argument("--out", default=None,
                    help="student path (default <weights-dir>/unet_ip2p_lcm.safetensors)")
    px.add_argument("--device", default="cuda")
    px.set_defaults(fn=cmd_distill)

    pc = sub.add_parser("convert", help="torch checkpoint -> zoo <slot>.safetensors")
    pc.add_argument("--model", default=None)
    pc.add_argument("--src", default=None)
    pc.add_argument("--out", default=None)
    pc.add_argument("--weights-dir", default="weights")
    pc.add_argument("--list", action="store_true")
    pc.add_argument("--plan", default=None, metavar="DOWNLOADS_DIR",
                    help="print the fetch + convert shell script for every registry "
                         "checkpoint (weights/manifest.py) instead of converting one")
    pc.add_argument("--verify", action="store_true",
                    help="run the source's HF module against the converted port module "
                         "on a fixed input (fp32, CPU) and refuse to write on a mismatch "
                         "(needs transformers and an HF model dir as --src)")
    pc.add_argument("--device", default="cuda",
                    help="unused: conversion reads and writes on the host")
    pc.set_defaults(fn=cmd_convert)

    pv = sub.add_parser("eval", help="score a run's edited pairs (CLIP/dirCLIP/L1/SSIM "
                                     "+ post-filter pass-rate per edit type)")
    pv.add_argument("--run-dir", required=True,
                    help="a `run` output dir (ledger.jsonl + saved images)")
    pv.add_argument("--image-root", default=None,
                    help="original images (for records whose input is not synthesized)")
    pv.add_argument("--output", default="eval.json")
    pv.add_argument("--weights", default=None)
    pv.add_argument("--require-weights", action="store_true")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--tiny", action="store_true")
    pv.add_argument("--device", default="cuda")
    pv.set_defaults(fn=cmd_eval)

    pe = sub.add_parser("export", help="ledger -> reference-format JSONs")
    pe.add_argument("--ledger", required=True)
    pe.add_argument("--output", required=True)
    pe.add_argument("--start", type=int, default=0)
    pe.add_argument("--end", type=int, default=None)
    pe.add_argument("--device", default="cuda", help="unused: the export runs on the host")
    pe.set_defaults(fn=cmd_export)

    pg = sub.add_parser("generate", help="captions -> instruction records "
                                         "(template or llama backend)")
    pg.add_argument("--captions", required=True, help="text file, one caption per line")
    pg.add_argument("--edit-type", required=True)
    pg.add_argument("--output", required=True, help=".jsonl or .json path")
    pg.add_argument("--backend", choices=("template", "llama"), default="template")
    pg.add_argument("--weights", default=None, help="dir holding llama.safetensors")
    pg.add_argument("--require-weights", action="store_true")
    pg.add_argument("--tiny", action="store_true")
    pg.add_argument("--int8", action="store_true", help="W8A8 llama decoder")
    pg.add_argument("--batch-size", type=int, default=16)
    pg.add_argument("--limit", type=int, default=0)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--no-self-check", action="store_true")
    pg.add_argument("--shots", type=int, default=5,
                    help="few-shot examples per prompt (5 = reference setting)")
    pg.add_argument("--device", default="cuda")
    pg.set_defaults(fn=cmd_generate)

    pb = sub.add_parser("bench", help="throughput benchmark (tools/bench_torch_ip2p.py)")
    pb.add_argument("--device", default="cuda")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args, params)


if __name__ == "__main__":
    raise SystemExit(main())
