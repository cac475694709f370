"""The frozen towers of the AnySD trainer and the distiller: SD VAE, CLIP
text and CLIP vision, and the IP2P UNet's weights (counterpart of
`anyedit_tpu/train/frozen.py`).

Each slot ("vae", "clip_text", "clip_vision", "unet_ip2p") comes from its
Flax tree in `params` (through the weight bridge), else from
`<weights_dir>/<slot>.safetensors` as `convert` writes it and the zoo reads
it (the port module's state dict), else from a seeded init drawn on the
device. A slot given both ways is refused, as the zoo refuses it; a
`*.msgpack` in `weights_dir` is refused (the port reads no Flax files).
`require=True` needs a `weights_dir` or `params`, and raises
`FileNotFoundError` for a slot found in neither (the JAX loader's rule
for its files). The UNet is not built here: its tree or state dict is
handed on (`AnySDTrainer.init`, the distiller's teacher). The CLIP BPE
merges come from `weights_dir` (required there unless
`allow_fallback_tokenizers`), else the hash tokenizer. Every tower is
eval and requires no grad.
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
from anyedit_tpu_torch.weights.files import read_safetensors
from anyedit_tpu_torch.weights.init import seeded_init_


@dataclasses.dataclass
class FrozenEncoders:
    vae: AutoencoderKL
    text: CLIPTextEncoder
    vision: CLIPVisionEncoder
    clip_tokenizer: object          # .encode(str) -> list[int]
    unet_tree: Optional[dict]       # the IP2P UNet's Flax tree (params=), or None
    unet_state: Optional[dict] = None   # its state dict (unet_ip2p.safetensors), or None

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
    wdir = Path(weights_dir) if weights_dir else None
    if require and wdir is None and not params:
        raise ValueError("require=True needs params or a weights_dir (otherwise every "
                         "frozen tower would silently random-init)")
    if wdir is not None:
        packed = sorted(p.name for p in wdir.glob("*.msgpack"))
        if packed:
            raise ValueError(f"weights_dir={wdir} holds {packed}: the port reads "
                             "<slot>.safetensors, not Flax trees; convert the official "
                             "checkpoints with `python -m anyedit_tpu_torch convert`")

    def state(slot, to_sd):
        """The slot's state dict from params= or its file; None: not given."""
        wf = wdir / f"{slot}.safetensors" if wdir is not None else None
        if wf is not None and not wf.exists():
            wf = None
        if slot in params:
            if wf is not None:
                raise ValueError(f"slot {slot!r} is given both in params= and as {wf}")
            return to_sd(params[slot])
        if wf is not None:
            return read_safetensors(wf)
        if require:
            where = (f"{wdir / f'{slot}.safetensors'}" if wdir is not None
                     else f"no {slot!r} tree in params")
            raise FileNotFoundError(f"required weights missing: {where}; convert the "
                                    "checkpoint first (`python -m anyedit_tpu_torch "
                                    "convert`) or drop --require-weights")
        return None

    def tower(module, slot, to_sd):
        sd = state(slot, to_sd)
        if sd is None:
            seeded_init_(module, seed)
        else:
            module.load_state_dict(sd, strict=True)
        return module.eval().requires_grad_(False)

    vae = tower(AutoencoderKL(vae_cfg, device=device), "vae",
                lambda t: bridge.vae_state_dict(t, len(vae_cfg.block_channels)))
    text = tower(CLIPTextEncoder(text_cfg, device=device), "clip_text",
                 bridge.clip_text_state_dict)
    vision = tower(CLIPVisionEncoder(vis_cfg, device=device), "clip_vision",
                   bridge.clip_vision_state_dict)
    # the UNet's tree is bridged by its user, which knows the UNet config
    unet_state = state("unet_ip2p", lambda t: None)

    merges = None
    if wdir is not None:
        merges = find_clip_merges(wdir)
        if merges is None and not allow_fallback_tokenizers:
            raise FileNotFoundError(
                f"weights_dir={wdir} is set but the CLIP BPE merges are missing "
                "(bpe_simple_vocab_16e6.txt.gz); converted text-encoder weights "
                "would receive hash-bucket token ids.")
    clip_tok = ClipBPETokenizer(merges) if merges else SimpleClipTokenizer(text_cfg.vocab_size)
    return FrozenEncoders(vae, text, vision, clip_tok, params.get("unet_ip2p"), unet_state)
