"""AnySD inference: edit images with a trained task-routed adapter
(counterpart of `anyedit_tpu/train/inference.py`).

`AnySDEditor.edit(image, instruction, edit_type)`: bilinear resize to the
training resolution, SD VAE encode, CLIP-L vision on the bilinear-resized
image with the ImageNet normalisation for the image embedding, the adapter's
tokens appended to the CLIP text context of the instruction (and of all-zero
ids for the unconditional rows), the IP2P 3-way-CFG DDIM loop
(`diffusion/ip2p.py`), VAE decode and a bilinear resize back. Everything runs
under `torch.no_grad()`: the adapter may be the live one of a training run
(`cli.py train`'s validation grids). The JAX editor draws its start latents
as `normal(key(seed))`; here they are `noise`, or the first draw of
`torch.Generator(seed)`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from anyedit_tpu_torch.diffusion.ip2p import ip2p_edit
from anyedit_tpu_torch.ops.resize import imagenet_normalize, resize_image, to_u8
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.train.anysd import AnySDConfig, TaskMoEAdapter, expert_id
from anyedit_tpu_torch.train.frozen import FrozenEncoders, load_frozen_encoders


class AnySDEditor:
    """Task-routed instruction editor over a trained AnySD adapter: the
    frozen towers and UNet, and the adapter (from a training checkpoint, or
    passed per call)."""

    def __init__(self, cfg: AnySDConfig, frozen: FrozenEncoders, unet,
                 adapter: Optional[TaskMoEAdapter] = None, resolution: int = 256):
        self.cfg, self.frozen, self.unet = cfg, frozen, unet
        self.adapter = adapter
        self.resolution = resolution
        self.device = next(unet.parameters()).device
        self.ns = make_noise_schedule(device=self.device)
        self._sf = frozen.vae.cfg.scaling_factor

    @classmethod
    def from_checkpoint(cls, cfg: AnySDConfig, checkpoint_dir: str | Path,
                        params=None, weights_dir=None, require_weights: bool = False,
                        seed: int = 0, resolution: int = 256,
                        allow_fallback_tokenizers: bool = False,
                        text_cfg=None, vis_cfg=None, vae_cfg=None,
                        device="cuda") -> "AnySDEditor":
        """The frozen towers (`load_frozen_encoders`) and the LATEST adapter
        of a training checkpoint dir (`cli.py train --checkpoint-dir`)."""
        from anyedit_tpu_torch.models.clip import CLIP_L_TEXT, CLIP_L_VISION
        from anyedit_tpu_torch.models.vae import SD_VAE
        from anyedit_tpu_torch.train.anysd import AnySDTrainer
        from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer

        frozen = load_frozen_encoders(
            vae_cfg or SD_VAE, text_cfg or CLIP_L_TEXT, vis_cfg or CLIP_L_VISION,
            params=params, weights_dir=weights_dir, require=require_weights, seed=seed,
            device=device, allow_fallback_tokenizers=allow_fallback_tokenizers)
        step, adapter_sd, _ = TrainCheckpointer(checkpoint_dir).restore_latest()
        if step is None:
            raise FileNotFoundError(f"no training checkpoint found in {checkpoint_dir}")
        unet, adapter, _ = AnySDTrainer(cfg, device=device).init(
            seed, frozen.unet_tree, unet_state=frozen.unet_state)
        adapter.load_state_dict(adapter_sd, strict=True)
        return cls(cfg, frozen, unet, adapter, resolution=resolution)

    @torch.no_grad()
    def edit(self, image_u8: np.ndarray, instruction: str, edit_type: str,
             adapter_params: Optional[TaskMoEAdapter] = None, steps: int = 20,
             text_scale: float = 7.5, image_scale: float = 1.5, seed: int = 0,
             noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """Edit one HWC uint8 image; returns HWC uint8 at the input size.
        `noise`: the start latents (1, res/8, res/8, 4)."""
        adapter = adapter_params if adapter_params is not None else self.adapter
        if adapter is None:
            raise ValueError("no adapter: pass adapter_params or build via from_checkpoint()")
        f, res, dev = self.frozen, self.resolution, self.device
        h0, w0 = image_u8.shape[:2]
        px = resize_image(torch.as_tensor(image_u8, device=dev).float()[None] / 127.5 - 1.0,
                          res, res, "bilinear")
        mean, _ = f.vae.encode(px)
        vsize = f.vision.cfg.image_size
        _, emb = f.vision(imagenet_normalize(resize_image(px * 0.5 + 0.5, vsize, vsize,
                                                          "bilinear")))
        ids = torch.from_numpy(f.tokenize(instruction)).to(dev)
        task = torch.tensor([expert_id(edit_type)], device=dev)
        tok = adapter(emb, task)
        hidden = f.text(ids)[0]
        cond = torch.cat([hidden, tok.to(hidden.dtype)], dim=1)
        hid_u = f.text(torch.zeros_like(ids))[0]
        uncond = torch.cat([hid_u, tok.to(hid_u.dtype)], dim=1)
        lat_in = mean * self._sf
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn(lat_in.shape, generator=gen, device=dev)
        out = ip2p_edit(self.unet, self.ns, lat_in, cond, uncond, num_steps=steps,
                        guidance_scale=text_scale, image_guidance_scale=image_scale,
                        init_latents=noise.to(dev))
        img = f.vae.decode(out / self._sf)[0]
        img = torch.clamp((img.float() + 1.0) * 127.5, 0, 255)
        img = resize_image(img[None], h0, w0, "bilinear")[0]
        return to_u8(img).cpu().numpy()
