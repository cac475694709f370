"""`python -m anyedit_tpu_torch` — the port's command line (counterpart of
`anyedit_tpu/cli.py`; its `train` and `edit` commands).

  train     AnySD Stage-II fine-tune from a factory success ledger
  edit      edit one image with a trained AnySD adapter checkpoint

The flags and defaults are the JAX commands', plus `--device` (default
"cuda": the card; "cpu" where the caller asks for it). The port reads no
`.msgpack`: `--weights-dir` gives tokenizer assets only, and the frozen
towers' Flax trees come through `main(argv, params=...)` ("vae",
"clip_text", "clip_vision", "unet_ip2p"); without them the towers are
seeded on the device. The JAX mesh (dp / tp / ep sharding) has no
counterpart: one process trains on one device. Step s draws its timesteps,
noise and dropout from `torch.Generator` seeded with (seed << 32) + s, so a
resumed run draws what an uninterrupted one would.
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
    import torch

    from anyedit_tpu_torch.core.image import load_rgb, pil_resize
    from anyedit_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from anyedit_tpu_torch.train.anysd import AnySDTrainer
    from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer
    from anyedit_tpu_torch.train.data import (
        MixtureSampler, examples_from_ledger, pixel_batches,
    )
    from anyedit_tpu_torch.train.frozen import load_frozen_encoders

    cfg, text_cfg, vis_cfg, vae_cfg = _anysd_configs(args.tiny)
    dev = torch.device(args.device)
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

    unet, adapter, opt_state = trainer.init(args.seed, frozen.unet_tree)
    ckpt = TrainCheckpointer(args.checkpoint_dir, keep=args.keep_checkpoints,
                             save_interval_steps=args.checkpoint_every)
    start_step = 0
    if args.resume:
        step0, ad, op = ckpt.restore_latest(map_location=dev)
        if step0 is not None:
            adapter.load_state_dict(ad, strict=True)
            start_step, opt_state = step0, op
            print(f"resumed from step {start_step}")

    examples = examples_from_ledger(args.ledger, args.image_root)
    if not examples:
        print("no trainable success records in ledger", file=sys.stderr)
        return 1
    sampler = MixtureSampler(examples, seed=args.seed)

    val_pairs = []
    if args.val_count > 0:
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
        batch = encode_batch(pixel)
        gen = torch.Generator(device=dev).manual_seed((args.seed << 32) + step)
        draws = trainer.draw(gen, batch)
        adapter, opt_state, loss = trainer.train_step(adapter, opt_state, unet, batch, draws)
        losses.append(float(loss))
        if (step + 1) % args.log_every == 0:
            print(json.dumps({"step": step + 1, "loss": losses[-1]}))
        if (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, adapter, opt_state)
            if val_pairs:
                run_validation(step + 1)
                last_val = step + 1
    ckpt.save(args.steps, adapter, opt_state)
    if val_pairs and last_val != args.steps:
        run_validation(args.steps)
    ckpt.wait()
    ckpt.close()
    print(json.dumps({"final_step": args.steps,
                      "mean_loss": float(np.mean(losses)) if losses else None,
                      "examples": len(examples),
                      "mixture_types": sorted(sampler.buckets)}))
    return 0


def main(argv=None, params=None) -> int:
    """`params`: Flax trees of the frozen towers by slot name (see the
    module docstring)."""
    p = argparse.ArgumentParser(prog="anyedit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

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
                    help="dir of tokenizer assets (the CLIP BPE merges)")
    pt.add_argument("--require-weights", action="store_true",
                    help="error out if any frozen tower has no Flax tree in params")
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
                    help="dir of tokenizer assets (the CLIP BPE merges)")
    pd.add_argument("--require-weights", action="store_true")
    pd.add_argument("--resolution", type=int, default=256)
    pd.add_argument("--steps", type=int, default=20)
    pd.add_argument("--guidance", type=float, default=7.5)
    pd.add_argument("--image-guidance", type=float, default=1.5)
    pd.add_argument("--seed", type=int, default=0)
    pd.add_argument("--tiny", action="store_true")
    pd.add_argument("--device", default="cuda")
    pd.set_defaults(fn=cmd_edit)

    args = p.parse_args(argv)
    return args.fn(args, params)


if __name__ == "__main__":
    raise SystemExit(main())
