"""The IP2P editor slot of the model zoo (counterpart of the `ip2p()` slot of
`anyedit_tpu/runtime/zoo.py`).

`ModelZoo(cfg, device).ip2p()` returns `edit(image_u8, instruction, mask01,
steps, s_txt, s_img, seed)`: lanczos resize to the canvas -> VAE encode ->
CLIP text for the instruction and for "" -> 3-way-CFG DDIM loop on the IP2P
UNet -> VAE decode -> lanczos resize back to the input size. Parameters come
from Flax trees through `weights/bridge.py` (`params=`), or from a seeded
init on the device. The JAX zoo's fused/stepwise compile split and its LCM
branch have no counterpart here: the port runs one Python denoise loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from anyedit_tpu_torch.core.config import CanvasConfig
from anyedit_tpu_torch.diffusion import ip2p_edit
from anyedit_tpu_torch.models.clip import CLIP_L_TEXT, TINY_TEXT, CLIPTextConfig, CLIPTextEncoder
from anyedit_tpu_torch.models.clip_tokenizer import SimpleClipTokenizer
from anyedit_tpu_torch.models.unet_sd import (
    SD15_IP2P_UNET, TINY_UNET, UNet2DCondition, UNetConfig,
)
from anyedit_tpu_torch.models.vae import SD_VAE, TINY_VAE, AutoencoderKL, VAEConfig
from anyedit_tpu_torch.ops.resize import (
    denormalize_to_u8, normalize_to_unit, resize_image, to_u8,
)
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.init import seeded_init_


@dataclasses.dataclass
class ZooConfig:
    """The fields of the JAX `ZooConfig` that the IP2P slot reads."""

    canvas: CanvasConfig = CanvasConfig()
    ip2p_unet: UNetConfig = SD15_IP2P_UNET
    vae: VAEConfig = SD_VAE
    text: CLIPTextConfig = CLIP_L_TEXT


def tiny_zoo_config() -> ZooConfig:
    """The IP2P fields of the JAX package's hermetic tiny config
    (`anyedit_tpu/cli.py::tiny_zoo_config`): tiny fp32 models, 64 px canvas."""
    f32 = dict(dtype=torch.float32)
    return ZooConfig(
        canvas=CanvasConfig(edit_size=64, grounding_size=64, sam_size=64,
                            latent_down=2),
        ip2p_unet=dataclasses.replace(TINY_UNET, in_channels=8, **f32),
        vae=dataclasses.replace(TINY_VAE, **f32),
        text=dataclasses.replace(TINY_TEXT, vocab_size=30522, max_len=77, **f32))


class ModelZoo:
    """Builds the slot's models lazily on `device`.

    params: optional Flax parameter trees (numpy leaves, as the JAX
    package's `load_params` returns them) under the JAX slot names
    "unet_ip2p", "vae" and "clip_text"; a missing slot gets a seeded init.
    Tokens come from the hash tokenizer the JAX zoo uses with no weights
    dir."""

    def __init__(self, cfg: ZooConfig | None = None, device: str | torch.device = "cpu",
                 seed: int = 0, params: Optional[Mapping[str, Any]] = None):
        self.cfg = cfg or ZooConfig()
        self.device = torch.device(device)
        self.seed = seed
        self.params = dict(params or {})
        self._cache: dict[str, Any] = {}
        self.clip_tokenizer = SimpleClipTokenizer(self.cfg.text.vocab_size)

    def _get(self, name: str, build: Callable[[], Any]):
        if name not in self._cache:
            self._cache[name] = build()
        return self._cache[name]

    def _load(self, module: torch.nn.Module, slot: str, to_state_dict):
        if slot in self.params:
            module.load_state_dict(to_state_dict(self.params[slot]), strict=True)
        else:
            seeded_init_(module, self.seed)
        return module.eval().requires_grad_(False)

    # ---- tokenization ----------------------------------------------------
    def _clip_ids(self, text: str, max_len: int) -> np.ndarray:
        """CLIP ids, EOT-padded (HF CLIPTokenizer convention: pooled =
        first-argmax token = the real EOT)."""
        ids = self.clip_tokenizer.encode(text)
        if len(ids) > max_len:                   # keep EOT when truncating
            ids = ids[:max_len - 1] + [ids[-1]]
        ids_a = np.full((1, max_len), ids[-1], np.int64)
        ids_a[0, :len(ids)] = ids
        return ids_a

    # ---- models ----------------------------------------------------------
    def _text_model(self, cache_name: str, tcfg: CLIPTextConfig) -> CLIPTextEncoder:
        return self._get(cache_name, lambda: self._load(
            CLIPTextEncoder(tcfg, device=self.device), cache_name,
            bridge.clip_text_state_dict))

    def _text_raw(self, cache_name: str, tcfg: CLIPTextConfig):
        """text -> (hidden (1,L,H), pooled, penult (1,L,H)), fp32."""
        te = self._text_model(cache_name, tcfg)

        def encode(text: str):
            ids = torch.from_numpy(self._clip_ids(text, tcfg.max_len))
            return te(ids.to(self.device))
        return encode

    def _text_encoder(self):
        """hidden-states-only closure (the SD UNet context input)."""
        raw = self._text_raw("clip_text", self.cfg.text)
        return lambda text: raw(text)[0]

    def _vae(self) -> AutoencoderKL:
        vcfg = self.cfg.vae
        return self._get("vae", lambda: self._load(
            AutoencoderKL(vcfg, device=self.device), "vae",
            lambda t: bridge.vae_state_dict(t, len(vcfg.block_channels))))

    def _ip2p_core(self):
        """(unet, noise_schedule)."""
        ucfg = self.cfg.ip2p_unet

        def build():
            unet = self._load(UNet2DCondition(ucfg, device=self.device), "unet_ip2p",
                              lambda t: bridge.unet_state_dict(
                                  t, len(ucfg.block_channels)))
            return unet, make_noise_schedule(device=self.device)
        return self._get("ip2p_core", build)

    # ---- the slot --------------------------------------------------------
    def ip2p(self):
        def build():
            c = self.cfg
            unet, ns = self._ip2p_core()
            vae = self._vae()
            text = self._text_encoder()
            dev = self.device
            sf = c.vae.scaling_factor

            @torch.inference_mode()
            def edit(image_u8, instruction: str, mask01=None, steps: int = 50,
                     s_txt: float = 8.0, s_img: float = 0.9, seed: int = 0,
                     init_latents: Optional[torch.Tensor] = None,
                     renoise: Optional[torch.Tensor] = None) -> np.ndarray:
                """Edit one (H, W, 3) uint8 image; returns (H, W, 3) uint8.

                The start latents and the masked edit's re-noise noise are
                drawn from `torch.Generator(seed)` unless given (NHWC,
                (1, size/down, size/down, latent channels))."""
                size = c.canvas.edit_size
                img = torch.as_tensor(image_u8, device=dev)
                x = resize_image(img.float(), size, size, "lanczos")
                lat_in = vae.encode(normalize_to_unit(x)[None].to(torch.bfloat16)
                                    )[0] * sf
                cond = text(instruction).to(torch.bfloat16)
                uncond = text("").to(torch.bfloat16)
                m = None
                if mask01 is not None:
                    lh = size // c.canvas.latent_down
                    mask = torch.as_tensor(mask01, device=dev).float()
                    m = (resize_image(mask[..., None], lh, lh, "bilinear") > 0.5
                         ).float()[None]
                gen = torch.Generator(device=dev).manual_seed(seed)
                if init_latents is None:
                    init_latents = torch.randn(lat_in.shape, generator=gen, device=dev)
                if renoise is None:
                    renoise = torch.randn(lat_in.shape, generator=gen, device=dev)
                out = ip2p_edit(unet, ns, lat_in, cond, uncond, num_steps=steps,
                                guidance_scale=s_txt, image_guidance_scale=s_img,
                                mask=m, init_latents=init_latents.to(dev),
                                renoise=renoise.to(dev))
                img_out = vae.decode((out / sf).to(torch.bfloat16))[0]
                u8 = denormalize_to_u8(img_out)
                h, w = img.shape[:2]
                return to_u8(resize_image(u8.float(), h, w, "lanczos")).cpu().numpy()
            return edit
        return self._get("ip2p", build)
