"""The frozen towers of the AnySD trainer and the distiller: SD VAE, CLIP
text and CLIP vision (counterpart of `anyedit_tpu/train/frozen.py`).

Parameters come as Flax trees through the weight bridge (`params` under the
slot names "vae", "clip_text", "clip_vision", "unet_ip2p"), or from a seeded
init drawn on the device, as the port's `ModelZoo` takes them: the port
never reads `.msgpack` files, and a `weights_dir` holding one is refused.
`require=True` without `params`, or without a tower's tree, raises, as the
JAX loader does without its files. The CLIP BPE merges come from
`weights_dir` (required there unless `allow_fallback_tokenizers`), else the
hash tokenizer. Every tower is eval and requires no grad.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from anyedit_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from anyedit_tpu_torch.models.clip_tokenizer import (
    ClipBPETokenizer, SimpleClipTokenizer, find_clip_merges,
)
from anyedit_tpu_torch.models.vae import AutoencoderKL
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.init import seeded_init_


@dataclasses.dataclass
class FrozenEncoders:
    vae: AutoencoderKL
    text: CLIPTextEncoder
    vision: CLIPVisionEncoder
    clip_tokenizer: object          # .encode(str) -> list[int]
    unet_tree: Optional[dict]       # the IP2P UNet's Flax tree, or None (seeded)

    def tokenize(self, s: str) -> np.ndarray:
        """(1, max_len) ids, truncated and zero-padded (the JAX trainer's)."""
        n = self.text.cfg.max_len
        ids = self.clip_tokenizer.encode(s)[:n]
        arr = np.zeros((1, n), np.int64)
        arr[0, :len(ids)] = ids
        return arr


def load_frozen_encoders(vae_cfg, text_cfg, vis_cfg,
                         params: Optional[Mapping[str, Any]] = None,
                         weights_dir: Optional[str | Path] = None,
                         require: bool = False, seed: int = 0, device="cuda",
                         allow_fallback_tokenizers: bool = False) -> FrozenEncoders:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_frozen_encoders: device {device} requested but CUDA "
                           "is not available; pass device='cpu' to run on the CPU")
    params = dict(params or {})
    if require and not params:
        raise ValueError("require=True needs params (otherwise every frozen tower "
                         "would silently random-init)")
    wdir = Path(weights_dir) if weights_dir else None
    if wdir is not None:
        packed = sorted(p.name for p in wdir.glob("*.msgpack"))
        if packed:
            raise ValueError(f"weights_dir={wdir} holds {packed}: the port reads only "
                             "tokenizer assets there; pass the trees as params=")

    def tower(module, slot, to_sd):
        if slot in params:
            module.load_state_dict(to_sd(params[slot]), strict=True)
        elif require:
            raise FileNotFoundError(f"required weights missing: no {slot!r} tree in params")
        else:
            seeded_init_(module, seed)
        return module.eval().requires_grad_(False)

    vae = tower(AutoencoderKL(vae_cfg, device=device), "vae",
                lambda t: bridge.vae_state_dict(t, len(vae_cfg.block_channels)))
    text = tower(CLIPTextEncoder(text_cfg, device=device), "clip_text",
                 bridge.clip_text_state_dict)
    vision = tower(CLIPVisionEncoder(vis_cfg, device=device), "clip_vision",
                   bridge.clip_vision_state_dict)
    if require and "unet_ip2p" not in params:
        raise FileNotFoundError("required weights missing: no 'unet_ip2p' tree in params")

    merges = None
    if wdir is not None:
        merges = find_clip_merges(wdir)
        if merges is None and not allow_fallback_tokenizers:
            raise FileNotFoundError(
                f"weights_dir={wdir} is set but the CLIP BPE merges are missing "
                "(bpe_simple_vocab_16e6.txt.gz); converted text-encoder weights "
                "would receive hash-bucket token ids.")
    clip_tok = ClipBPETokenizer(merges) if merges else SimpleClipTokenizer(text_cfg.vocab_size)
    return FrozenEncoders(vae, text, vision, clip_tok, params.get("unet_ip2p"))
