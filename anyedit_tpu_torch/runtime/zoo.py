"""The model zoo's grounding, editing, inpainting, pair-synthesis, refine,
condition and scorer slots (counterpart of the `grounder()`, `ip2p()`,
`inpainter()`, `sd_inpainter()`, `ultraedit_fn()`, `masactrl_pair_fn()`,
`p2p_pair()`, `flux_pair_fn()`, `text2img_fn()`, `img2img_fn()`,
`sdxl_inpaint_fn()`, `canny_consistency_fn()`, `sdxl_material_fn()`,
`canny_fn()`, `depth_fn()`, `hed_fn()`, `seg_fn()`, `composition_fn()`,
`anydoor()`, `dino_embed()`, `clip_towers()`, `aesthetic_fn()`, `vqa_fn()`,
`vila_fn()`, `ocr_fn()`, `select_tokenizers` and `toolbox()` of
`anyedit_tpu/runtime/zoo.py`).

`ModelZoo(cfg, device).grounder()` returns `ground(image_u8, phrase, mode,
count_k)`: bilinear resize to the 800 px detector bucket, ImageNet
normalisation, the phrase as a caption ending in "." through GroundingDINO,
the phrase's token span (or the whole caption when the phrase is not
found), box selection and NMS, SAM at its own 1024 bucket with the boxes
scaled into its space, the best of each box's masks by predicted IoU, a
bilinear resize back to (h, w), and the per-mode combination; `None` when no
box is kept. `ground.batch(images, phrases, modes, count_ks)` (the
chunk-mode executor's) makes one detector forward and one SAM encode for
the whole list, then the same per-record tail.

`ModelZoo(cfg, device).ip2p()` returns `edit(image_u8, instruction, mask01,
steps, s_txt, s_img, seed)`: lanczos resize to the canvas -> VAE encode ->
CLIP text for the instruction and for "" -> 3-way-CFG DDIM loop on the IP2P
UNet -> VAE decode -> lanczos resize back to the input size. With
`ZooConfig.lcm_steps` > 0 the loop is the distilled student's
`lcm_edit` (one UNet row a step, a masked edit composited once at x0), the
student's tree given as "unet_ip2p", as the JAX zoo's LCM branch.
`edit.batch(images, instructions, masks, steps, s_txt, s_img, seeds)` runs
the same over chunks of at most `edit_batch_bucket` records, one batch-3n
UNet call per step, each record's start latents drawn as `edit` draws them
for its seed. Parameters come from Flax trees through `weights/bridge.py`
(`params=`), or from a seeded init on the device. With `quant_ip2p` (or
`quant_diffusion`) the float UNet parameters are quantized once at slot
build into the W8A8 UNet, as the JAX zoo does. The JAX zoo's fused/stepwise
compile split and its bucket padding have no counterpart here: the port
runs one Python denoise loop at the batch it is given.

`inpainter()` returns LaMa's `inpaint(img01, mask01) -> img01` (reflect-
padded to a multiple of 8, fp32, cuDNN's TF32 off for the call);
`sd_inpainter()` the SD1.5 inpaint UNet's `inpaint(image_u8, mask01,
prompt, negative)` (the mask at latent size above 0.25, 50 steps, scale
7.5; W8A8 with `quant_diffusion`).

`ultraedit_fn()` returns SD3-UltraEdit's `edit(image_u8, instruction,
mask01, steps, s_txt, s_img, seed)`: lanczos resize -> SD3 VAE encode ->
`sd3_cond()` for the instruction and for "" -> the 3-way-CFG flow edit on
the MMDiT (the mask at latent size above 0.25) -> SD3 VAE decode -> lanczos
resize back; the MMDiT in W8A8 with `quant_diffusion`.

The caption-pair synthesizers generate both sides of a record from its
(input, output) captions on the SD1.5 text2img UNet (`sd_unet`, slot
"unet_sd", one resident copy for both) at batch 4 (two branches x CFG):
`masactrl_pair_fn()` returns `pair(src_caption, tgt_caption, seed)` (50
DDIM steps from one shared start latent, MasaCtrl's K/V swap); `p2p_pair()`
returns `run(ori_caption, tar_caption, keyword, seed)` (20 steps under an
AttentionStore, the keyword's accumulated cross-attention map thresholded
into a canvas-size mask). `flux_pair_fn()` returns `pair(caption_a,
caption_b, seed)` and `text2img_fn()` `t2i(prompt, seed)`: 4 Flux steps from
the seed's noise, conditioned on T5 (`flux_t5_len` tokens, 77 by default)
and CLIP-L's unprojected pooled output, decoded by the Flux VAE; the Flux in
W8A8 with `quant_diffusion`. Each draws its start noise from
`torch.Generator(seed)` unless given `noise=`.

The SDXL refine slots run `diffusion/sampling.py::sample_img2img` on the
refine UNet (`refine_unet`, slot "unet_refine"; W8A8 with
`quant_diffusion`) at CFG batch 2 with the SDXL conditioning of
`_xl_cond()` (CLIP-L's and CLIP-bigG's penultimate hidden states, bigG's
projected pooled output, time ids (s, s, 0, 0, s, s) at the canvas size)
and the SDXL VAE: `img2img_fn()` (implicit_change's stage 3),
`sdxl_inpaint_fn()` (stage 2: the mask at latent size above 0.25),
`canny_consistency_fn()` (stage 4: the canny ControlNet on the image's
edges, the IP-Adapter on a reference image) and `sdxl_material_fn()`
(material_transfer: the depth ControlNet, the IP-Adapter on an exemplar,
the latents outside the mask kept). Each draws its noise (and re-noise)
from `torch.Generator(seed)` unless given `noise=` (`renoise=`).
`canny_fn(image_u8)`, `depth_fn()` (Depth-Anything-V2), `hed_fn()` (HED
soft edges at the canvas size, resized bilinear back) and `seg_fn()`
(UperNet on Swin-T, the argmax rendered with the ADE palette, resized
"nearest" back) give the condition maps.

`composition_fn()` returns `run(plan, seed, steps=50, noise=None)`: the
canvas plan's regional cross-attention (`diffusion/regional.py`) on the
resident SD1.5 UNet (`_sd_core()`), 50 DDIM steps at CFG 7.5, every site
through the regional processor (plain sdpa, no hand attention kernel).
`anydoor()` returns `run(target_u8, mask, collage_u8, hf_map, ref_u8, steps=50,
cfg_scale=9.0, seed=0, noise=None)`: AnyDoor's ControlLDM, the SD2.1-class
UNet (`anydoor_unet`) with its ControlNet on the 4-channel hint (collage /
255 and HF map / 255 at 8x the latent size), conditioned on the DINOv2
tokens of the reference (`dino_cfg`, ViT-g at 224 px) through a fp32
projection, an all-zero unconditional context, 50 DDIM steps at CFG 9; the
SD VAE decode is resized lanczos back and pasted under the mask. The JAX
slot also VAE-encodes the target and reads only the encoding's shape; the
port skips that encode (the output does not depend on it). `dino_embed()`
is the L2-normed DINOv2 CLS embedding of an image. Start noise is drawn
from `torch.Generator(seed)` unless given `noise=`.

The scorer slots: `clip_towers()` returns `(clip_image(image_u8) -> (1, P),
clip_text(text) -> (1, P))`, both L2-normed (bilinear antialiased resize
to the tower's size, ImageNet mean and std, as the JAX zoo), and
`clip_image.batch(images)` one tower forward for a list; `aesthetic_fn()`
the LAION MLP over `clip_image`; `vqa_fn()` BLIP-2's yes/no answer on the
EVA tower's tokens; `vila_fn()` VILA-1.5's (vicuna-7B over CLIP ViT-L/336
tokens), the same contract; `ocr_fn()` GOT-OCR2's text (SAM ViT-B + Qwen2).
`install(tb, slot)` attaches one of them ("clip", "aesthetic", "vqa",
"vila" as `tb.vqa_yes_no`, "ocr" as `tb.ocr`), the SD inpainter ("sd_inpaint"), UltraEdit
("ultraedit", as `tb.extra["ultraedit"]`), the pair synthesizers, the
refine slots, "composition", "anydoor" and "dino" (as `tb.extra[...]`), or
"canny", "depth", "hed" or "seg" to a Toolbox, and `toolbox(slots=...)`
installs them beside `ground`, `inpaint` and `ip2p`. `install` takes
exactly the JAX zoo's slot names.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from anyedit_tpu_torch.core import trace
from anyedit_tpu_torch.core.config import CanvasConfig
from anyedit_tpu_torch.core.dist import Group, all_gather_objects, rank_rows
from anyedit_tpu_torch.diffusion import flux_sample, ip2p_edit, sample_inpaint, ultraedit_edit
from anyedit_tpu_torch.diffusion.processors import AttentionStore, mask_from_ca
from anyedit_tpu_torch.diffusion.regional import build_regional_conditioning, parse_canvas_plan
from anyedit_tpu_torch.diffusion.sampling import p2p_sample, sample_cfg, sample_img2img
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.filters.scorers import AestheticMLP
from anyedit_tpu_torch.grounding.maskgen import grounding_result, select_boxes
from anyedit_tpu_torch.grounding.text import (
    SimpleVocabTokenizer, WordPieceTokenizer, phrase_token_spans,
)
from anyedit_tpu_torch.models.bert import TINY_BERT
from anyedit_tpu_torch.models.blip2 import BLIP2_QFORMER, TINY_QFORMER, Blip2VQA, QFormerConfig, yes_no
from anyedit_tpu_torch.models.clip import (
    CLIP_BIGG_TEXT, CLIP_L_TEXT, CLIP_L_VISION, EVA_VIT_G, TINY_TEXT, TINY_VISION,
    CLIPTextConfig,
    CLIPTextEncoder, CLIPTextModel, CLIPVisionConfig, CLIPVisionEncoder,
)
from anyedit_tpu_torch.models.bpe import ENDOFTEXT, IM_END, Qwen2Tokenizer, got_prompt_ids
from anyedit_tpu_torch.models.clip_tokenizer import (
    ClipBPETokenizer, SimpleClipTokenizer, find_clip_merges,
)
from anyedit_tpu_torch.models.controlnet import ControlNet
from anyedit_tpu_torch.models.depth import (
    DEPTH_ANYTHING_L, TINY_DEPTH, DepthAnythingV2, DPTConfig, depth_to_u8,
)
from anyedit_tpu_torch.models.dinov2 import DINOV2_G, DINOV2_L, DinoV2, DinoV2Config
from anyedit_tpu_torch.models.flux import FLUX_SCHNELL, TINY_FLUX, Flux, FluxConfig
from anyedit_tpu_torch.models.gdino import GDINO_SWINB, TINY_GDINO, GDINOConfig, GroundingDINO
from anyedit_tpu_torch.models.hed import HED
from anyedit_tpu_torch.models.ip_adapter import (
    ImageProjection, IPAdapterWeights, cross_attn_sites, ip_adapter_processor,
)
from anyedit_tpu_torch.models.lama import LAMA, TINY_LAMA, LamaConfig, LamaGenerator, pad_to_modulo
from anyedit_tpu_torch.models.llama import TINY_LLAMA
from anyedit_tpu_torch.models.mmdit import SD3_ULTRAEDIT, TINY_MMDIT, MMDiT, MMDiTConfig
from anyedit_tpu_torch.models.ocr import (
    GOT_OCR, TINY_QWEN, GotOCR, OCRConfig, detokenize_ids, greedy_decode,
)
from anyedit_tpu_torch.models.sam import (
    SAM, SAM_PIXEL_MEAN, SAM_PIXEL_STD, SAM_VIT_H, TINY_SAM, SAMConfig,
)
from anyedit_tpu_torch.models.segmentation import (
    TINY_SEG, UPERNET_SWIN_T, SegConfig, UperNetSegmenter, render_segmentation,
)
from anyedit_tpu_torch.models.swin import TINY_SWIN
from anyedit_tpu_torch.models.sentencepiece import SentencePieceModel
from anyedit_tpu_torch.models.t5 import T5_XXL, TINY_T5, T5Config, T5Encoder
from anyedit_tpu_torch.models.unet_sd import (
    SD15_INPAINT_UNET, SD15_IP2P_UNET, SD15_UNET, SD21_ANYDOOR_UNET, SDXL_UNET, TINY_UNET,
    TINY_XL_UNET, UNet2DCondition, UNetConfig,
)
from anyedit_tpu_torch.models.vae import (
    FLUX_VAE, SD3_VAE, SD_VAE, SDXL_VAE, TINY_VAE, AutoencoderKL, VAEConfig,
)
from anyedit_tpu_torch.models.vila import VILA_1_5, VilaConfig, VilaVQA
from anyedit_tpu_torch.ops.canny import canny, rgb_to_gray
from anyedit_tpu_torch.ops.cuda_graph import Graphed
from anyedit_tpu_torch.ops.quant import quantize_state_dict
from anyedit_tpu_torch.ops.resize import (
    denormalize_to_u8, imagenet_normalize, normalize_to_unit, resize_image, to_u8,
)
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.train.distill import DistillConfig, lcm_edit
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.files import read_safetensors
from anyedit_tpu_torch.weights.init import seeded_init_


@dataclasses.dataclass
class ZooConfig:
    """The fields of the JAX `ZooConfig` that the grounding, editing,
    inpainting, pair-synthesis and scorer slots read. With no SentencePiece model, T5 ids
    (UltraEdit's T5-XXL, the VQA question) are the hash ids modulo
    `flux_text.vocab_size`, as in the JAX zoo."""

    canvas: CanvasConfig = CanvasConfig()
    gdino: GDINOConfig = GDINO_SWINB
    sam: SAMConfig = SAM_VIT_H
    box_threshold: float = 0.25
    lama: LamaConfig = LAMA
    ip2p_unet: UNetConfig = SD15_IP2P_UNET
    inpaint_unet: UNetConfig = SD15_INPAINT_UNET
    sd_unet: UNetConfig = SD15_UNET            # 4-channel text2img (MasaCtrl)
    refine_unet: UNetConfig = SDXL_UNET        # img2img / consistency / material
    vae: VAEConfig = SD_VAE
    sdxl_vae: VAEConfig = SDXL_VAE             # the refine slots' latent codec
    sd3_vae: VAEConfig = SD3_VAE               # UltraEdit's latent codec
    flux_vae: VAEConfig = FLUX_VAE             # Flux's latent codec
    text: CLIPTextConfig = CLIP_L_TEXT
    text_g: CLIPTextConfig = CLIP_BIGG_TEXT    # SD3's second CLIP tower
    vision: CLIPVisionConfig = CLIP_L_VISION   # clip_image tower
    flux_text: T5Config = T5_XXL               # SD3's and Flux's T5 text encoder
    mmdit: MMDiTConfig = SD3_ULTRAEDIT
    flux: FluxConfig = FLUX_SCHNELL
    # T5 tokens of the Flux samplers' context (ids zero-padded, no mask).
    # FluxPipeline gives schnell 256 (`max_sequence_length`); 77 is the JAX
    # zoo's cut, kept as the default for parity (ROADMAP queue 3). SD3 keeps 77.
    flux_t5_len: int = 77
    depth_cfg: DPTConfig = DEPTH_ANYTHING_L    # Depth-Anything-V2 (material_transfer)
    anydoor_unet: UNetConfig = SD21_ANYDOOR_UNET   # AnyDoor's ControlLDM (visual_reference)
    # AnyDoor's reference encoder and the DINO scorer: the JAX zoo takes
    # ViT-g at 224 px when a weights dir exists, else a 2-block ViT-L
    # (`tiny_zoo_config`'s); the port has no weights dir, so it is a field
    dino_cfg: DinoV2Config = dataclasses.replace(DINOV2_G, img_size=224)
    seg_cfg: SegConfig = UPERNET_SWIN_T         # visual_segment's segmenter
    eva: CLIPVisionConfig = EVA_VIT_G          # BLIP-2 vision tower
    qformer: QFormerConfig = BLIP2_QFORMER     # BLIP-2 Q-Former + LM
    ocr: OCRConfig = GOT_OCR                   # GOT-OCR2 (textual_change's gate)
    vila: VilaConfig = VILA_1_5                # VILA-1.5 (the alternative VQA judge)
    # W8A8 int8 fast mode for the IP2P UNet (ops/quant.py): the float
    # parameters are quantized per output channel at slot build. Opt-in;
    # bf16 is the parity default. `quant_diffusion` also covers the other
    # pure-sampling slots: of those the port has the SD inpainter,
    # UltraEdit's MMDiT, Flux and the SDXL refine UNet (its ControlNets and
    # IP-Adapter stay float). The attention-surgery slots (MasaCtrl, P2P)
    # stay bf16: their processors read the raw attention.
    quant_ip2p: bool = False
    quant_diffusion: bool = False
    # records per batch-3n UNet call of `ip2p().batch` (the chunk-mode
    # executor's batched edit stage)
    edit_batch_bucket: int = 4
    # > 0: the IP2P slot runs the distilled few-step consistency editor
    # (`train/distill.py::lcm_edit`, one UNet row a step) on the student
    # given as the "unet_ip2p" tree; the caller's steps and scales are the
    # teacher's knobs, folded into the student, and are ignored
    lcm_steps: int = 0


def tiny_zoo_config() -> ZooConfig:
    """The grounding, editing, inpainting and scorer fields of the JAX
    package's hermetic tiny config (`anyedit_tpu/cli.py::tiny_zoo_config`): tiny models, 64 px
    canvas, every box kept above a score of 0, the JAX zoo's 2-block
    DINOv2-L at 56 px for AnyDoor and the DINO scorer. Two differences:
    every tower is fp32 (the JAX config leaves the tiny Swin, BERT,
    Q-Former, T5, DINOv2, the segmenter and the VILA and GOT language
    models in bf16), and BERT's vocabulary is 30522, so that the hash tokenizer's ids
    index the table (at TINY_BERT's 128 they fall outside it, which
    `jnp.take` answers with NaN)."""
    f32 = dict(dtype=torch.float32)
    vae = dataclasses.replace(TINY_VAE, **f32)
    return ZooConfig(
        canvas=CanvasConfig(edit_size=64, grounding_size=64, sam_size=64,
                            latent_down=2),
        gdino=dataclasses.replace(
            TINY_GDINO, swin=dataclasses.replace(TINY_SWIN, **f32),
            bert=dataclasses.replace(TINY_BERT, vocab_size=30522, **f32), **f32),
        sam=dataclasses.replace(TINY_SAM, **f32),
        lama=TINY_LAMA,
        ip2p_unet=dataclasses.replace(TINY_UNET, in_channels=8, **f32),
        inpaint_unet=dataclasses.replace(TINY_UNET, in_channels=9, **f32),
        sd_unet=dataclasses.replace(TINY_UNET, **f32),
        # the SDXL context is CLIP-L (32) + CLIP-G (16) = 48 wide
        refine_unet=dataclasses.replace(TINY_XL_UNET, context_dim=48, **f32),
        vae=vae,
        sdxl_vae=vae,
        sd3_vae=vae,
        flux_vae=vae,
        text=dataclasses.replace(TINY_TEXT, vocab_size=30522, max_len=77, **f32),
        # CLIP-L (32) + CLIP-G (16) = 48: the pooled width; the context is cut to 32
        text_g=dataclasses.replace(TINY_TEXT, hidden=16, heads=2, vocab_size=30522,
                                   max_len=77, **f32),
        vision=dataclasses.replace(TINY_VISION, **f32),
        flux_text=dataclasses.replace(TINY_T5, vocab_size=30522, **f32),
        mmdit=dataclasses.replace(TINY_MMDIT, in_channels=9, out_channels=4, context_dim=32,
                                  pooled_dim=48, max_hw=16, **f32),
        flux=dataclasses.replace(TINY_FLUX, context_dim=32, pooled_dim=32, **f32),
        depth_cfg=dataclasses.replace(TINY_DEPTH, backbone=dataclasses.replace(
            TINY_DEPTH.backbone, **f32), **f32),
        anydoor_unet=dataclasses.replace(TINY_UNET, context_dim=64, **f32),
        dino_cfg=dataclasses.replace(DINOV2_L, img_size=56, depth=2, dim=64, heads=2, **f32),
        seg_cfg=dataclasses.replace(TINY_SEG, backbone=dataclasses.replace(
            TINY_SEG.backbone, **f32), **f32),
        eva=dataclasses.replace(TINY_VISION, **f32),
        qformer=dataclasses.replace(TINY_QFORMER, lm=dataclasses.replace(TINY_T5, **f32),
                                    **f32),
        ocr=OCRConfig(vision=dataclasses.replace(TINY_SAM, **f32),
                      lm=dataclasses.replace(TINY_QWEN, **f32), max_tokens=8, **f32),
        vila=VilaConfig(vision=dataclasses.replace(TINY_VISION, use_proj=False, **f32),
                        lm=dataclasses.replace(TINY_LLAMA, **f32), **f32),
        box_threshold=0.0)


def _tiny_clip_layout_eva(vcfg: CLIPVisionConfig) -> bool:
    """The JAX tiny config's quirk (`anyedit_tpu/cli.py:72`): its `eva` is
    TINY_VISION, a CLIP-layout tower (pre-LN, projection), whose parameters
    only the CLIP names fit."""
    return vcfg.pre_ln


def select_tokenizers(weights_dir: Optional[Path], clip_vocab_size: int,
                      allow_fallback: bool = False):
    """(WordPiece-or-hash, CLIP-BPE-or-hash) tokenizer pair for a weights
    dir, as the JAX zoo selects them: the hash tokenizers without a dir;
    with one, `vocab.txt` and the CLIP merges are required unless
    `allow_fallback`."""
    if weights_dir is None:
        return SimpleVocabTokenizer(), SimpleClipTokenizer(clip_vocab_size)
    weights_dir = Path(weights_dir)
    vocab = weights_dir / "vocab.txt"
    merges = find_clip_merges(weights_dir)
    if (not vocab.exists() or merges is None) and not allow_fallback:
        raise FileNotFoundError(
            f"weights_dir={weights_dir} is set but tokenizer assets "
            "are missing (need vocab.txt for grounding WordPiece and "
            "bpe_simple_vocab_16e6.txt.gz for CLIP BPE); converted "
            "checkpoints would silently receive hash-bucket token "
            "ids. Pass allow_fallback_tokenizers=True to override.")
    word = WordPieceTokenizer(vocab) if vocab.exists() else SimpleVocabTokenizer()
    clip = (ClipBPETokenizer(merges) if merges
            else SimpleClipTokenizer(clip_vocab_size))
    return word, clip


class ModelZoo:
    """Builds the slot's models lazily on `device`.

    device: the card ("cuda") unless the caller asks for another; building
    a model on "cuda" raises where CUDA is absent (no fallback to the CPU).
    params: optional Flax parameter trees (numpy leaves, as the JAX
    package's `load_params` returns them) under the JAX slot names
    "gdino", "sam", "lama", "unet_ip2p", "unet_inpaint", "unet_sd", "vae", "clip_text",
    "clip_vision", "clip_text_proj", "aesthetic", "eva_vit", "blip2", "mmdit_ultraedit",
    "sd3_vae", "clip_text_sd3", "clip_text_g", "t5", "flux", "flux_vae", "unet_refine",
    "sdxl_vae", "controlnet_canny", "controlnet_depth", "ip_proj", "ip_adapter",
    "depth", "hed", "seg", "unet_anydoor", "controlnet_anydoor", "dinov2_g",
    "anydoor_proj", "vila" and "ocr".
    weights_dir: optional; a slot loads the port module's state dict from
    `weights_dir/<slot>.safetensors` (under the JAX zoo's `_wf` names, as
    `python -m anyedit_tpu_torch convert` writes them; with `lcm_steps`,
    the IP2P UNet from `unet_ip2p_lcm.safetensors` when it exists), and
    the tokenizer assets (`vocab.txt`, the CLIP merges, `spiece.model`,
    and `got_tokenizer.json` or `qwen_vocab.json` + `qwen_merges.txt`),
    selected as the JAX zoo selects them (`select_tokenizers`; without it,
    the hash tokenizers). A dir holding a `*.msgpack` is refused: those are
    Flax trees, which the port does not read.
    A slot with neither a tree nor a file gets a seeded init (a
    ControlNet's zero convs and hint projection at zero, as in the JAX
    zoo), unless `require_weights`, which needs a `weights_dir` and makes a
    slot without its file raise FileNotFoundError. A slot given both as a
    tree and as a file is refused."""

    def __init__(self, cfg: ZooConfig | None = None, device: str | torch.device = "cuda",
                 seed: int = 0, params: Optional[Mapping[str, Any]] = None,
                 weights_dir: str | Path | None = None,
                 allow_fallback_tokenizers: bool = False, require_weights: bool = False):
        self.cfg = cfg or ZooConfig()
        self.device = torch.device(device)
        self.seed = seed
        self.params = dict(params or {})
        self.weights = Path(weights_dir) if weights_dir else None
        self.require_weights = require_weights
        if require_weights and self.weights is None:
            raise ValueError("require_weights=True needs a weights_dir")
        if self.weights is not None:
            packed = sorted(p.name for p in self.weights.glob("*.msgpack"))
            if packed:
                raise ValueError(
                    f"weights_dir={self.weights} holds {packed}: the port reads "
                    "<slot>.safetensors, not Flax trees; convert the official "
                    "checkpoints with `python -m anyedit_tpu_torch convert`")
        self._cache: dict[str, Any] = {}
        self._spiece: Any = False                 # not looked for yet
        self.tokenizer, self.clip_tokenizer = select_tokenizers(
            self.weights, self.cfg.text.vocab_size,
            allow_fallback=allow_fallback_tokenizers)

    def _get(self, name: str, build: Callable[[], Any]):
        if name not in self._cache:
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"ModelZoo: device {self.device} requested but "
                                   "CUDA is not available; pass device='cpu' to "
                                   "run on the CPU")
            self._cache[name] = build()
        return self._cache[name]

    def _wf(self, slot: str) -> Optional[Path]:
        """The slot's weight file in `weights_dir`, or None. With
        `require_weights`, a slot with no file raises (no seeded init)."""
        if self.weights is None:
            return None
        wf = self.weights / f"{slot}.safetensors"
        if wf.exists():
            return wf
        if self.require_weights and slot not in self.params:
            raise FileNotFoundError(
                f"required weights missing: {wf}; convert the checkpoint first "
                "(`python -m anyedit_tpu_torch convert`) or drop --require-weights")
        return None

    def _slot_state(self, slot: str, to_state_dict, wf: Optional[Path] = None):
        """The slot's state dict: bridged from its Flax tree in `params`,
        or read from its file (`wf`, else `_wf(slot)`); None: seed it."""
        wf = wf or self._wf(slot)
        if slot in self.params:
            if wf is not None:
                raise ValueError(f"slot {slot!r} is given both in params= and as {wf}")
            return to_state_dict(self.params[slot])
        return read_safetensors(wf) if wf is not None else None

    def _load(self, module: torch.nn.Module, slot: str, to_state_dict,
              wf: Optional[Path] = None):
        sd = self._slot_state(slot, to_state_dict, wf)
        if sd is None:
            seeded_init_(module, self.seed)
        else:
            module.load_state_dict(sd, strict=True)
        return module.eval().requires_grad_(False)

    # ---- tokenization ----------------------------------------------------
    def _ids(self, text: str, max_len: int, vocab_size: int | None = None) -> np.ndarray:
        """BERT-style hash ids (grounding, the VQA question), zero-padded."""
        enc = self.tokenizer.encode(text)
        ids_a = np.zeros((1, max_len), np.int64)
        n = min(max_len, len(enc.ids))
        ids_a[0, :n] = enc.ids[:n]
        if vocab_size is not None:
            ids_a %= vocab_size
        return ids_a

    def _sentencepiece(self) -> Optional[SentencePieceModel]:
        """`spiece.model` of the weights dir, read once, or None."""
        if self._spiece is False:
            f = self.weights / "spiece.model" if self.weights else None
            self._spiece = SentencePieceModel.from_file(f) if f and f.exists() else None
        return self._spiece

    def _t5_ids(self, text: str, max_len: int) -> np.ndarray:
        """T5 ids: SentencePiece's, eos-terminated and zero-padded, when
        `spiece.model` is in the weights dir; else the hash ids modulo
        `flux_text.vocab_size`, as in the JAX zoo."""
        sp = self._sentencepiece()
        if sp is None:
            return self._ids(text, max_len, self.cfg.flux_text.vocab_size)
        return np.asarray([sp.encode_padded(text, max_len)], np.int64)

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

    def _t5(self, max_len: int = 77):
        """text -> T5 hidden states (1, max_len, dim) fp32 (SD3's and Flux's
        long-text context): `max_len` ids, zero-padded, and no mask, as the
        JAX zoo's `_t5` at its 77 (SD3 keeps 77; Flux takes
        `ZooConfig.flux_t5_len`)."""
        t5 = self._get("t5", lambda: self._load(
            T5Encoder(self.cfg.flux_text, device=self.device), "t5", bridge.t5_state_dict))
        return lambda text: t5(torch.from_numpy(self._t5_ids(text, max_len)).to(self.device))

    def _vae_cfg(self, slot: str) -> VAEConfig:
        return {"vae": self.cfg.vae, "sdxl_vae": self.cfg.sdxl_vae,
                "sd3_vae": self.cfg.sd3_vae, "flux_vae": self.cfg.flux_vae}[slot]

    def _vae_named(self, slot: str) -> AutoencoderKL:
        """The latent codec of a diffusion slot: "vae" (SD1.5), "sdxl_vae",
        "sd3_vae" or "flux_vae"."""
        vcfg = self._vae_cfg(slot)
        return self._get(slot, lambda: self._load(
            AutoencoderKL(vcfg, device=self.device), slot,
            lambda t: bridge.vae_state_dict(t, len(vcfg.block_channels))))

    def _vae(self) -> AutoencoderKL:
        return self._vae_named("vae")

    def _gdino(self) -> GroundingDINO:
        return self._get("gdino", lambda: self._load(
            GroundingDINO(self.cfg.gdino, device=self.device), "gdino",
            bridge.gdino_state_dict))

    def _sam(self) -> SAM:
        return self._get("sam", lambda: self._load(
            SAM(self.cfg.sam, device=self.device), "sam", bridge.sam_state_dict))

    def _backbone(self, make: Callable, cfg, slot: str, to_state_dict, quant: bool,
                  wf: Optional[Path] = None):
        """The denoiser `make(cfg, device=...)` of a diffusion slot, bridged
        from `params`, read from its file (`wf`, else `weights_dir`'s) or
        seeded. With `quant`, the W8A8 module from the slot's float
        parameters: bridged from `params`, read from the file, or the seeded init
        drawn on the device in fp32 (the float values the JAX package
        quantizes), quantized once, here. The W8A8 module is built on the
        meta device and takes the quantized tensors as they are, so the
        peak is the fp32 module plus the int8 weights (Flux: about 57 GB,
        not 91)."""
        if not quant:
            return self._load(make(cfg, device=self.device), slot, to_state_dict, wf)
        float_sd = self._slot_state(slot, to_state_dict, wf)
        if float_sd is None:
            fcfg = dataclasses.replace(cfg, dtype=torch.float32)
            float_sd = seeded_init_(make(fcfg, device=self.device), self.seed).state_dict()
        module = make(dataclasses.replace(cfg, quant=True), device="meta")
        qsd = quantize_state_dict(module, float_sd)
        del float_sd
        module.load_state_dict({k: v.to(self.device) for k, v in qsd.items()}, strict=True,
                               assign=True)
        return module.eval().requires_grad_(False)

    def _unet(self, slot: str, ucfg: UNetConfig, quant: bool,
              wf: Optional[Path] = None) -> UNet2DCondition:
        return self._backbone(UNet2DCondition, ucfg, slot,
                              lambda t: bridge.unet_state_dict(t, len(ucfg.block_channels),
                                                               ucfg.use_linear_projection),
                              quant, wf)

    def _mmdit(self) -> MMDiT:
        """UltraEdit's MMDiT (slot "mmdit_ultraedit"); W8A8 with `quant_diffusion`."""
        c = self.cfg.mmdit
        return self._get("mmdit", lambda: self._backbone(
            MMDiT, c, "mmdit_ultraedit", lambda t: bridge.mmdit_state_dict(t, c.patch),
            self.cfg.quant_diffusion))

    def _flux(self) -> Flux:
        """Flux (slot "flux"); W8A8 with `quant_diffusion`."""
        return self._get("flux", lambda: self._backbone(
            Flux, self.cfg.flux, "flux", bridge.flux_state_dict, self.cfg.quant_diffusion))

    def _sd_core(self):
        """(4-channel SD1.5 unet, noise_schedule) of the pair synthesizers,
        slot "unet_sd", bf16 (their processors read the raw attention)."""
        c = self.cfg
        return self._get("sd_core", lambda: (
            self._unet("unet_sd", c.sd_unet, False), make_noise_schedule(device=self.device)))

    def _lcm_wf(self) -> Optional[Path]:
        """With `lcm_steps`, the distilled student's file
        `unet_ip2p_lcm.safetensors` when it exists (it takes the slot's
        place); under `require_weights` its absence raises, since the
        teacher's weights would run through the consistency sampler."""
        if self.cfg.lcm_steps <= 0 or self.weights is None or "unet_ip2p" in self.params:
            return None
        lwf = self.weights / "unet_ip2p_lcm.safetensors"
        if lwf.exists():
            return lwf
        if self.require_weights:
            raise FileNotFoundError(
                f"lcm_steps={self.cfg.lcm_steps} with require_weights needs the "
                f"distilled student {lwf}; distill it first or drop --lcm-steps")
        return None

    def _ip2p_core(self):
        """(unet, noise_schedule)."""
        c = self.cfg
        return self._get("ip2p_core", lambda: (
            self._unet("unet_ip2p", c.ip2p_unet, c.quant_ip2p or c.quant_diffusion,
                       self._lcm_wf()),
            make_noise_schedule(device=self.device)))

    def _inpaint_core(self):
        """(9-channel inpaint unet, noise_schedule); W8A8 with
        `quant_diffusion`, as the JAX zoo's `sd_inpainter`."""
        c = self.cfg
        return self._get("inpaint_core", lambda: (
            self._unet("unet_inpaint", c.inpaint_unet, c.quant_diffusion),
            make_noise_schedule(device=self.device)))

    def _lama(self) -> LamaGenerator:
        lcfg = self.cfg.lama
        return self._get("lama", lambda: self._load(
            LamaGenerator(lcfg, device=self.device), "lama",
            lambda t: bridge.lama_state_dict(t, lcfg.ratio_g)))

    # pixel <-> latent helpers (every diffusion slot; `vae` names its codec)
    def _to_latents(self, images, vae: str = "vae") -> torch.Tensor:
        """(B, h, w, C) scaled latents of a list of (H, W, 3) uint8 images:
        lanczos resize to the canvas, [-1, 1], one VAE encode in bf16."""
        size = self.cfg.canvas.edit_size
        with trace.span("vae_encode", "editor"):
            px = torch.stack([normalize_to_unit(resize_image(
                torch.as_tensor(im, device=self.device).float(), size, size, "lanczos"))
                for im in images])
            return self._vae_named(vae).encode(px.to(torch.bfloat16))[0] \
                * self._vae_cfg(vae).scaling_factor

    def _from_latents(self, lat: torch.Tensor, hws, vae: str = "vae") -> list[np.ndarray]:
        """One VAE decode of (B, h, w, C) latents -> B uint8 images, each
        lanczos-resized to its (H, W) of `hws`."""
        scaling = self._vae_cfg(vae).scaling_factor
        with trace.span("vae_decode", "editor"):
            imgs = self._vae_named(vae).decode((lat / scaling).to(torch.bfloat16))
            return [to_u8(resize_image(denormalize_to_u8(im).float(), h, w,
                                       "lanczos")).cpu().numpy()
                    for im, (h, w) in zip(imgs, hws)]

    def _latent_mask(self, mask01, threshold: float) -> torch.Tensor:
        """(h, w, 1) {0, 1} fp32: the (H, W) mask resized bilinear to the
        latent size and thresholded (> 0.5 for IP2P, > 0.25 for SD-inpaint)."""
        lh = self.cfg.canvas.edit_size // self.cfg.canvas.latent_down
        m = torch.as_tensor(mask01, device=self.device).float()[..., None]
        return (resize_image(m, lh, lh, "bilinear") > threshold).float()

    # ---- the slots -------------------------------------------------------
    def _pixels(self, image_u8, size: int) -> torch.Tensor:
        """(1, size, size, 3): bilinear antialiased resize, ImageNet mean and std."""
        img = torch.as_tensor(image_u8, device=self.device).float() / 255.0
        return imagenet_normalize(resize_image(img, size, size, "bilinear"))[None]

    def detector_inputs(self, image_u8, phrase: str):
        """(pixels (1, S, S, 3), ids (1, T), mask (1, T), span) for the
        detector: bilinear resize to the grounding bucket, ImageNet
        normalisation, the phrase as a caption ending in "." (ids on the
        zoo's device), and the phrase's token span, or (1, max(2, n - 1))
        when the phrase is not in the tokens."""
        c = self.cfg
        size, tlen = c.canvas.grounding_size, c.gdino.max_text_len
        pixels = self._pixels(image_u8, size)
        caption = phrase if phrase.endswith(".") else phrase + "."
        enc = self.tokenizer.encode(caption)
        n = min(len(enc.ids), tlen)
        ids = torch.zeros((1, tlen), dtype=torch.long)
        ids[0, :n] = torch.tensor(enc.ids[:n])
        span = phrase_token_spans(enc, caption, [phrase])[0]
        span = span if span[1] > span[0] else (1, max(2, n - 1))
        return (pixels, ids.to(self.device), (torch.arange(tlen)[None] < n).to(self.device),
                span)

    def sam_inputs(self, image_u8):
        """SAM's pixels (1, S, S, 3) at its own bucket (bilinear, SAM's mean
        and std) and the xyxy scale from image pixels into that space."""
        s = self.cfg.sam.img_size
        h, w = image_u8.shape[:2]
        img = torch.as_tensor(image_u8, device=self.device).float()
        mean = torch.tensor(SAM_PIXEL_MEAN, device=self.device)
        std = torch.tensor(SAM_PIXEL_STD, device=self.device)
        pixels = ((resize_image(img, s, s, "bilinear") - mean) / std)[None]
        return pixels, torch.tensor([s / w, s / h, s / w, s / h], device=self.device)

    def grounder(self):
        def build():
            c = self.cfg
            gd, sam = self._gdino(), self._sam()
            dev = self.device

            def finish(logits, boxes, span, hw, sam_embed, mode, count_k):
                """One record's tail: box selection, SAM decode of the kept
                boxes (`sam_embed()` -> (embedding (1, ...), xyxy scale),
                called only when a box is kept), the best mask of each,
                resized to (h, w), and the per-mode combination."""
                bx, sc, keep = select_boxes(logits, boxes, span, hw,
                                            box_threshold=c.box_threshold)
                if not bool(keep.any()):
                    return None
                emb, scale = sam_embed()
                masks, iou = sam.decode_boxes(emb, (bx * scale)[None])
                sel = masks[torch.arange(masks.shape[0], device=dev), iou.argmax(dim=-1)]
                sel = resize_image(sel[..., None], hw[0], hw[1], "bilinear")[..., 0]
                sel = torch.where(keep[:, None, None], sel, -1.0)
                return grounding_result(sel, bx, sc, keep, hw, mode, count_k)

            @torch.inference_mode()
            def ground(image_u8, phrase: str, mode: str = "merge",
                       count_k: int | None = None):
                """-> GroundingResult on the zoo's device, or None."""
                with trace.span("ground", "grounding"):
                    pixels, ids, mask, span = self.detector_inputs(image_u8, phrase)
                    logits, boxes = gd(pixels, ids, mask)

                    def sam_embed():
                        sam_px, scale = self.sam_inputs(image_u8)
                        return sam.encode(sam_px), scale
                    return finish(logits[0], boxes[0], span, image_u8.shape[:2], sam_embed,
                                  mode, count_k)

            @torch.inference_mode()
            def ground_batch(images, phrases, modes=None, count_ks=None):
                """`ground` over a list: ONE detector forward over the
                records' pixels and ids, ONE SAM encode over their SAM pixels,
                then each record's tail with its own mode and count_k. No
                padding: the batch is the list."""
                with trace.span("ground", "grounding"):
                    n = len(images)
                    if len(phrases) != n:
                        raise ValueError(f"{n} images, {len(phrases)} phrases")
                    modes = modes or ["merge"] * n
                    count_ks = count_ks or [None] * n
                    det = [self.detector_inputs(im, ph) for im, ph in zip(images, phrases)]
                    logits, boxes = gd(*(torch.cat([d[i] for d in det]) for i in range(3)))
                    sam_in = [self.sam_inputs(im) for im in images]
                    embs = sam.encode(torch.cat([px for px, _ in sam_in]))
                    return [finish(logits[i], boxes[i], det[i][3], images[i].shape[:2],
                                   lambda i=i: (embs[i:i + 1], sam_in[i][1]),
                                   modes[i], count_ks[i])
                            for i in range(n)]

            ground.batch = ground_batch
            return ground
        return self._get("ground", build)

    def _vision(self, slot: str, vcfg: CLIPVisionConfig) -> CLIPVisionEncoder:
        """The "clip_vision" tower, with CLIP names, or the "eva_vit" tower,
        with BLIP-2 names."""
        to_sd = {"clip_vision": bridge.clip_vision_state_dict,
                 "eva_vit": bridge.eva_vit_state_dict}[slot]
        if slot == "eva_vit" and _tiny_clip_layout_eva(vcfg):
            to_sd = bridge.clip_vision_state_dict
        return self._get(slot, lambda: self._load(
            CLIPVisionEncoder(vcfg, device=self.device), slot, to_sd))

    def _text_proj(self) -> CLIPTextModel:
        c = self.cfg
        return self._get("clip_text_proj", lambda: self._load(
            CLIPTextModel(c.text, proj_dim=c.vision.proj_dim, device=self.device),
            "clip_text_proj", bridge.clip_text_proj_state_dict))

    def _aesthetic_mlp(self) -> AestheticMLP:
        return self._get("aesthetic_mlp", lambda: self._load(
            AestheticMLP(self.cfg.vision.proj_dim, device=self.device), "aesthetic",
            bridge.aesthetic_state_dict))

    def _blip2(self) -> Blip2VQA:
        c = self.cfg
        return self._get("blip2", lambda: self._load(
            Blip2VQA(c.qformer, image_dim=c.eva.hidden, device=self.device), "blip2",
            bridge.blip2_state_dict))

    def clip_towers(self):
        """(clip_image(image_u8) -> (1, P), clip_text(text) -> (1, P)), both
        L2-normed fp32 on the device: the filter_tool/utils.py:15-40 pair.
        `clip_image.batch(images)` makes one tower forward for a list and
        returns one (1, P) embedding per image."""
        def build():
            c = self.cfg
            vis, tm = self._vision("clip_vision", c.vision), self._text_proj()

            @torch.inference_mode()
            def clip_image(image_u8):
                with trace.span("clip_image", "scorers"):
                    return vis(self._pixels(image_u8, c.vision.image_size))[1]

            @torch.inference_mode()
            def clip_image_batch(images):
                with trace.span("clip_image", "scorers"):
                    z = vis(torch.cat([self._pixels(im, c.vision.image_size)
                                       for im in images]))[1]
                    return [z[i:i + 1] for i in range(len(images))]

            @torch.inference_mode()
            def clip_text(text: str):
                with trace.span("clip_text", "scorers"):
                    ids = torch.from_numpy(self._clip_ids(text, c.text.max_len))
                    return tm(ids.to(self.device))
            clip_image.batch = clip_image_batch
            return clip_image, clip_text
        return self._get("clip_towers", build)

    def aesthetic_fn(self):
        """image_u8 -> float: the LAION aesthetic MLP over the CLIP image
        embedding (pre_filter.py:38-81, gate > 2)."""
        def build():
            clip_image, _ = self.clip_towers()
            mlp = self._aesthetic_mlp()

            @torch.inference_mode()
            def score(image_u8) -> float:
                with trace.span("aesthetic", "scorers"):
                    return float(mlp(clip_image(image_u8))[0])
            return score
        return self._get("aesthetic", build)

    def vqa_fn(self):
        """(image_u8, question) -> bool: BLIP-2's yes/no answer
        (filter_tool/utils.py:55-94). `ask.logits(image_u8, question)` gives
        the decoder's first-step logits (1, vocab) it compares. The question
        is 32 `_t5_ids` modulo the LM's vocabulary, masked where 0; 'yes' and
        'no' are the words' first SentencePiece ids with `spiece.model`, else
        the first id after CLS of their hash ids, as in the JAX zoo."""
        def build():
            c = self.cfg
            vis, vqa = self._vision("eva_vit", c.eva), self._blip2()
            vocab = c.qformer.lm.vocab_size
            if self._sentencepiece() is not None:
                yes_id, no_id = (int(self._t5_ids(w, 3)[0, 0]) for w in ("yes", "no"))
            else:
                yes_id = int(self._ids("yes", 3, vocab)[0, 1])   # [0, 0] is CLS
                no_id = int(self._ids("no", 3, vocab)[0, 1])

            @torch.inference_mode()
            def logits(image_u8, question: str) -> torch.Tensor:
                toks, _ = vis(self._pixels(image_u8, c.eva.image_size))
                ids = torch.from_numpy(self._t5_ids(question, 32) % vocab).to(self.device)
                return vqa(toks, ids, ids != 0)

            def ask(image_u8, question: str) -> bool:
                with trace.span("vqa", "scorers"):
                    return bool(yes_no(logits(image_u8, question), yes_id, no_id)[0])
            ask.logits = logits
            ask.yes_no_ids = (yes_id, no_id)
            return ask
        return self._get("vqa", build)

    def _vila(self) -> VilaVQA:
        return self._get("vila_model", lambda: self._load(
            VilaVQA(self.cfg.vila, device=self.device), "vila", bridge.vila_state_dict))

    def vila_fn(self):
        """(image_u8, question) -> bool: VILA's yes/no answer
        (pre_filter.py:98-106,308-345), the `vqa_fn` contract; installed by
        the "vila" slot as `tb.vqa_yes_no`. The image resized bilinear to
        the tower's size and ImageNet-normalized, the question as 32 hash
        ids modulo the LM's vocabulary, one prefill over [576 image tokens,
        32 ids]; 'yes' and 'no' are the first id after CLS of the words'
        hash ids. `ask.logits(image_u8, question)` gives the (1, vocab)
        logits it compares."""
        def build():
            vcfg = self.cfg.vila
            model = self._vila()
            size, vocab = vcfg.vision.image_size, vcfg.lm.vocab_size
            yes_id = int(self._ids("yes", 3, vocab)[0, 1])
            no_id = int(self._ids("no", 3, vocab)[0, 1])

            @torch.inference_mode()
            def logits(image_u8, question: str) -> torch.Tensor:
                ids = torch.from_numpy(self._ids(question, 32, vocab)).to(self.device)
                return model(self._pixels(image_u8, size), ids)

            def ask(image_u8, question: str) -> bool:
                return bool(yes_no(logits(image_u8, question), yes_id, no_id)[0])
            ask.logits = logits
            ask.yes_no_ids = (yes_id, no_id)
            return ask
        return self._get("vila", build)

    def _got(self) -> GotOCR:
        return self._get("ocr_model", lambda: self._load(
            GotOCR(self.cfg.ocr, device=self.device), "ocr", bridge.ocr_state_dict))

    def ocr_fn(self):
        """image_u8 -> recognized text (GOT-OCR2, filter_tool/utils.py:43-49):
        the image resized bilinear to the SAM tower's size, ImageNet-
        normalized, encoded once, then `greedy_decode` of at most
        `ocr.max_tokens` ids. With Qwen2 tokenizer assets in the weights dir
        (`models/bpe.py`), the GOT chat prompt around the image tokens and
        the real vocabulary, stopping at <|im_end|> / <|endoftext|>;
        without them, the JAX zoo's placeholder pieces "▁t<id>", which no
        quoted caption text matches, so the textual gate fails closed."""
        def build():
            c = self.cfg.ocr
            model = self._got()
            size = c.vision.img_size
            qtok = Qwen2Tokenizer.from_dir(self.weights) if self.weights else None
            if qtok is not None:
                prefix, suffix = got_prompt_ids(qtok)
                pre = torch.tensor([prefix], device=self.device)
                apply = lambda toks, ids: model.lm_logits_chat(toks, pre, ids)
            else:
                suffix, apply = None, model.lm_logits

            @torch.inference_mode()
            def read(image_u8) -> str:
                toks = model.encode_image(self._pixels(image_u8, size))
                if qtok is None:
                    out = greedy_decode(apply, toks, c.max_tokens)
                    return detokenize_ids(out[0], lambda i: f"▁t{i}")
                out = greedy_decode(apply, toks, c.max_tokens, prompt_ids=suffix,
                                    stop_ids=frozenset({IM_END, ENDOFTEXT}))
                cut = [int(t) for t in out[0][len(suffix):]]
                for stop in (IM_END, ENDOFTEXT):
                    if stop in cut:
                        cut = cut[:cut.index(stop)]
                return qtok.decode(cut).strip()
            return read
        return self._get("ocr", build)

    def install(self, tb: Toolbox, slot: str) -> None:
        """Build one named slot and attach it to the toolbox."""
        if slot == "sd_inpaint":
            tb.sd_inpaint = self.sd_inpainter()
        elif slot == "clip":
            tb.clip_image, tb.clip_text = self.clip_towers()
        elif slot == "aesthetic":
            tb.extra["aesthetic"] = self.aesthetic_fn()
        elif slot == "vqa":
            tb.vqa_yes_no = self.vqa_fn()
        elif slot == "vila":
            tb.vqa_yes_no = self.vila_fn()
        elif slot == "ocr":
            tb.ocr = self.ocr_fn()
        elif slot == "ultraedit":
            tb.extra["ultraedit"] = self.ultraedit_fn()
        elif slot == "masactrl":
            tb.extra["masactrl_pair"] = self.masactrl_pair_fn()
        elif slot == "p2p_pair":
            tb.extra["p2p_pair"] = self.p2p_pair()
        elif slot == "flux_pair":
            tb.extra["flux_pair"] = self.flux_pair_fn()
        elif slot == "text2img":
            tb.text2img = self.text2img_fn()
        elif slot in ("sdxl_img2img", "sdxl_inpaint", "canny_consistency", "sdxl_material"):
            tb.extra[slot] = {"sdxl_img2img": self.img2img_fn,
                              "sdxl_inpaint": self.sdxl_inpaint_fn,
                              "canny_consistency": self.canny_consistency_fn,
                              "sdxl_material": self.sdxl_material_fn}[slot]()
        elif slot == "canny":
            tb.canny = self.canny_fn
        elif slot == "depth":
            tb.depth = self.depth_fn()
        elif slot == "hed":
            tb.hed = self.hed_fn()
        elif slot == "seg":
            tb.seg = self.seg_fn()
        elif slot == "composition":
            tb.extra["composition"] = self.composition_fn()
        elif slot == "anydoor":
            tb.extra["anydoor"] = self.anydoor()
        elif slot == "dino":
            tb.extra["dino_embed"] = self.dino_embed()
        else:
            raise KeyError(f"unknown toolbox slot {slot!r} (the slots: 'sd_inpaint', "
                           "'clip', 'aesthetic', 'vqa', 'vila', 'ocr', 'ultraedit', "
                           "'masactrl', 'p2p_pair', 'flux_pair', 'text2img', 'sdxl_img2img', "
                           "'sdxl_inpaint', 'canny_consistency', 'sdxl_material', 'canny', "
                           "'depth', 'hed', 'seg', 'composition', 'anydoor', 'dino')")

    def toolbox(self, with_diffusion: bool = True, with_anydoor: bool = False,
                with_implicit: bool = False, slots: Sequence[str] = ()) -> Toolbox:
        """A Toolbox with `ground` and `inpaint` (LaMa), `ip2p` (with its
        `.batch`) only `with_diffusion` (the IP2P UNet, VAE and CLIP text
        tower are built for it), AnyDoor `with_anydoor`, the P2P pair
        `with_implicit`, and the named slots, as the JAX zoo builds it."""
        tb = Toolbox(ground=self.grounder(), inpaint=self.inpainter())
        if with_diffusion:
            tb.ip2p = self.ip2p()
        if with_anydoor:
            tb.extra["anydoor"] = self.anydoor()
        if with_implicit:
            tb.extra["p2p_pair"] = self.p2p_pair()
        for s in dict.fromkeys(slots):
            self.install(tb, s)
        return tb

    def ip2p(self):
        def build():
            c = self.cfg
            unet, ns = self._ip2p_core()
            self._vae()                     # built with the slot
            text = self._text_encoder()
            dev = self.device

            def run(lat, cond, mask, init, renoise, steps, s_txt, s_img):
                if c.lcm_steps > 0:
                    # one x0 composite at the end, as the JAX LCM branch
                    out = lcm_edit(unet, ns, lcm_cfg, lat, cond, c.lcm_steps,
                                   x_init=init, renoise=renoise)
                    return out if mask is None else mask * out + (1.0 - mask) * lat
                return ip2p_edit(unet, ns, lat, cond, text("").to(torch.bfloat16).expand_as(cond),
                                 num_steps=steps, guidance_scale=s_txt,
                                 image_guidance_scale=s_img, mask=mask,
                                 init_latents=init.to(dev), renoise=renoise)

            lcm_cfg = DistillConfig(unet=c.ip2p_unet)

            def draw_renoise(shape, gen):
                """The masked edit's re-noise draw, or in LCM mode the
                sampler's lcm_steps - 1 re-noise draws, stacked."""
                if c.lcm_steps > 0:
                    return torch.stack([torch.randn(shape, generator=gen, device=dev)
                                        for _ in range(c.lcm_steps - 1)])
                return torch.randn(shape, generator=gen, device=dev)

            @torch.inference_mode()
            def edit(image_u8, instruction: str, mask01=None, steps: int = 50,
                     s_txt: float = 8.0, s_img: float = 0.9, seed: int = 0,
                     init_latents: Optional[torch.Tensor] = None,
                     renoise: Optional[torch.Tensor] = None) -> np.ndarray:
                """Edit one (H, W, 3) uint8 image; returns (H, W, 3) uint8.

                The start latents and the masked edit's re-noise noise are
                drawn from `torch.Generator(seed)` unless given (NHWC,
                (1, size/down, size/down, latent channels)). With
                `lcm_steps`, `renoise` is the consistency sampler's
                lcm_steps - 1 re-noise draws, stacked on a leading axis."""
                with trace.span("ip2p", "editor"):
                    lat_in = self._to_latents([image_u8])
                    m = None if mask01 is None else self._latent_mask(mask01, 0.5)[None]
                    gen = torch.Generator(device=dev).manual_seed(seed)
                    if init_latents is None:
                        init_latents = torch.randn(lat_in.shape, generator=gen, device=dev)
                    if renoise is None:
                        renoise = draw_renoise(lat_in.shape, gen)
                    out = run(lat_in, text(instruction).to(torch.bfloat16), m, init_latents,
                              renoise.to(dev), steps, s_txt, s_img)
                    return self._from_latents(out, [image_u8.shape[:2]])[0]

            @torch.inference_mode()
            def edit_batch(images, instructions, masks=None, steps: int = 50,
                           s_txt: float = 8.0, s_img: float = 0.9, seeds=None,
                           init_latents: Optional[torch.Tensor] = None,
                           renoise: Optional[torch.Tensor] = None,
                           group: Optional[Group] = None) -> list[np.ndarray]:
                """`edit` over a list, in chunks of at most `edit_batch_bucket`
                records: one VAE encode, one batch-3n UNet call per step and
                one VAE decode per chunk. Record i's start latents are
                `init_latents[i]` or the first draw of `torch.Generator(
                seeds[i])` (default seeds 0..n-1), as `edit` draws them, so an
                unmasked record equals its `edit` up to batch-size numerics.
                With a mask anywhere in a chunk, unmasked records take an
                all-ones mask and the chunk one batch-wide re-noise draw
                (`renoise[chunk]`, or `torch.Generator(0)`'s first draw), as the
                JAX `ip2p_batch_fn` does; per-record re-noise parity is no
                contract there. With `lcm_steps`, each record draws its
                sampler's re-noise after its start latents from its own
                generator, as `edit` does (`renoise`: (lcm_steps - 1, n, ...)),
                so every record equals its `edit`, masked or not.

                With a `core.dist.Group` (the JAX `ip2p_batch_fn(mesh=...)`'s
                dp split), the chunk is rounded up to a multiple of dp and
                each rank edits its contiguous rows of each chunk: the
                chunk-wide mask decision and re-noise draw are the whole
                chunk's (the rank keeps its rows), so every record equals
                one process's at the rounded chunk. The uint8 outputs are
                gathered, and every rank returns the whole list in order."""
                with trace.span("ip2p", "editor"):
                    n = len(images)
                    if len(instructions) != n:
                        raise ValueError(f"{n} images, {len(instructions)} instructions")
                    masks = list(masks) if masks is not None else [None] * n
                    seeds = list(seeds) if seeds is not None else list(range(n))
                    dp, rank = (1, 0) if group is None else (group.size, group.rank)
                    # the JAX `bkt += (-bkt) % ndp`
                    bucket = c.edit_batch_bucket + (-c.edit_batch_bucket) % dp
                    out: list[tuple[int, np.ndarray]] = []
                    for s0 in range(0, n, bucket):
                        whole = slice(s0, min(s0 + bucket, n))
                        sub = rank_rows(whole.stop - s0, rank, dp)
                        part = slice(s0 + sub.start, s0 + sub.stop)
                        if part.start == part.stop:
                            continue            # no rows of this chunk on this rank
                        imgs = images[part]
                        lat = self._to_latents(imgs)
                        cond = torch.cat([text(t) for t in instructions[part]]).to(torch.bfloat16)
                        gens = [torch.Generator(device=dev).manual_seed(sd) for sd in seeds[part]]
                        one = (1,) + lat.shape[1:]
                        init = init_latents[part] if init_latents is not None else torch.cat([
                            torch.randn(one, device=dev, generator=g) for g in gens])
                        mask = ren = None
                        if c.lcm_steps > 0:
                            # each record's re-noise draws, as `edit` draws them
                            ren = renoise[:, part].to(dev) if renoise is not None else torch.cat(
                                [draw_renoise(one, g) for g in gens], dim=1)
                        if any(m is not None for m in masks[whole]):
                            ones = torch.ones(lat.shape[1:3] + (1,), device=dev)
                            mask = torch.stack([ones if m is None else self._latent_mask(m, 0.5)
                                                for m in masks[part]])
                            if c.lcm_steps == 0:
                                # the whole chunk's draw; this rank's rows of it
                                ren = renoise[part].to(dev) if renoise is not None else \
                                    torch.randn((whole.stop - s0,) + lat.shape[1:], device=dev,
                                                generator=torch.Generator(
                                                    device=dev).manual_seed(0))[sub]
                        lat = run(lat, cond, mask, init, ren, steps, s_txt, s_img)
                        out += enumerate(self._from_latents(lat, [im.shape[:2] for im in imgs]),
                                         start=part.start)
                    gathered = [x for got in all_gather_objects(out, group) for x in got]
                    return [img for _, img in sorted(gathered, key=lambda x: x[0])]

            edit.batch = edit_batch
            return edit
        return self._get("ip2p", build)

    def inpainter(self):
        """LaMa: `inpaint(img01 (H, W, 3), mask01 (H, W)) -> img01` as numpy
        fp32, reflect-padded to a multiple of 8 and cropped back. cuDNN runs
        the slot's fp32 convolutions in full fp32 (TF32 off for the call,
        restored after), the precision of the JAX CPU reference."""
        def build():
            lama = self._lama()
            dev = self.device

            @torch.inference_mode()
            def inpaint(img01, mask01) -> np.ndarray:
                x, (h, w) = pad_to_modulo(
                    torch.as_tensor(img01, dtype=torch.float32, device=dev)[None], 8)
                m, _ = pad_to_modulo(
                    torch.as_tensor(mask01, dtype=torch.float32, device=dev)[None, ..., None], 8)
                with _no_tf32_convs():
                    out = lama(x, m)
                return out[0, :h, :w].cpu().numpy()
            return inpaint
        return self._get("inpaint", build)

    def sd_inpainter(self):
        """`inpaint(image_u8, mask01 (H, W), prompt, negative="", steps=50,
        scale=7.5, seed=0) -> image_u8`: the SD1.5 9-channel inpaint UNet
        through `sample_inpaint`, the mask resized bilinear to latent size
        and kept above 0.25. Start latents and re-noise noise are drawn from
        `torch.Generator(seed)` (in that order) unless given."""
        def build():
            unet, ns = self._inpaint_core()
            self._vae()
            text = self._text_encoder()
            dev = self.device

            @torch.inference_mode()
            def inpaint(image_u8, mask01, prompt: str, negative: str = "", steps: int = 50,
                        scale: float = 7.5, seed: int = 0,
                        init_latents: Optional[torch.Tensor] = None,
                        renoise: Optional[torch.Tensor] = None) -> np.ndarray:
                lat = self._to_latents([image_u8])
                gen = torch.Generator(device=dev).manual_seed(seed)
                if init_latents is None:
                    init_latents = torch.randn(lat.shape, generator=gen, device=dev)
                if renoise is None:
                    renoise = torch.randn(lat.shape, generator=gen, device=dev)
                out = sample_inpaint(unet, ns, lat, self._latent_mask(mask01, 0.25)[None],
                                     text(prompt).to(torch.bfloat16),
                                     text(negative).to(torch.bfloat16), num_steps=steps,
                                     guidance_scale=scale, init_latents=init_latents.to(dev),
                                     renoise=renoise.to(dev))
                return self._from_latents(out, [image_u8.shape[:2]])[0]
            return inpaint
        return self._get("sd_inpaint", build)

    def sd3_cond(self):
        """text -> (context (1, 77 + 77, mmdit.context_dim) bf16, pooled
        (1, mmdit.pooled_dim) fp32): the SD3 conditioning of the JAX zoo's
        `ultraedit_fn` (diffusers pipeline_stable_diffusion_3 layout). The
        context is the penultimate hidden states (no final LN) of CLIP-L with
        projection and CLIP-bigG, concatenated, zero-padded or cut to the T5
        width, then T5's hidden states in the sequence; pooled is the two
        towers' projected pooled outputs, zero-padded or cut to `pooled_dim`."""
        def build():
            c = self.cfg
            d, pd = c.mmdit.context_dim, c.mmdit.pooled_dim
            t5 = self._t5()
            # SD3 ships both CLIP towers as CLIPTextModelWithProjection, so its
            # L tower is a slot of its own beside SD1.5's projection-free one
            clip_l = self._text_raw("clip_text_sd3",
                                    dataclasses.replace(c.text, text_proj=c.text.hidden))
            clip_g = self._text_raw("clip_text_g", c.text_g)

            def cond(text: str):
                _, pl, hl = clip_l(text)
                _, pg, hg = clip_g(text)
                clip_ctx = torch.cat([hl, hg], dim=-1)
                clip_ctx = F.pad(clip_ctx, (0, max(0, d - clip_ctx.shape[-1])))[..., :d]
                pooled = torch.cat([pl, pg], dim=-1)
                pooled = F.pad(pooled, (0, max(0, pd - pooled.shape[-1])))[:, :pd]
                return torch.cat([clip_ctx, t5(text)], dim=1).to(torch.bfloat16), pooled
            return cond
        return self._get("sd3_cond", build)

    def ultraedit_fn(self):
        """`edit(image_u8, instruction, mask01=None, steps=50, s_txt=8.0,
        s_img=1.5, seed=0, init_latents=None, renoise=None) -> image_u8`:
        SD3-UltraEdit's masked 3-way-CFG flow edit
        (attribute_pipeline_tool.py:85-155). The start latents and, for a
        masked edit, the re-noise noise are drawn from
        `torch.Generator(seed)` (in that order) unless given (NHWC,
        (1, size/down, size/down, sd3_vae.latent_channels))."""
        def build():
            mmdit = self._mmdit()
            self._vae_named("sd3_vae")
            cond = self.sd3_cond()
            dev = self.device

            @torch.inference_mode()
            def edit(image_u8, instruction: str, mask01=None, steps: int = 50,
                     s_txt: float = 8.0, s_img: float = 1.5, seed: int = 0,
                     init_latents: Optional[torch.Tensor] = None,
                     renoise: Optional[torch.Tensor] = None) -> np.ndarray:
                lat = self._to_latents([image_u8], "sd3_vae")
                m = None if mask01 is None else self._latent_mask(mask01, 0.25)[None]
                gen = torch.Generator(device=dev).manual_seed(seed)
                if init_latents is None:
                    init_latents = torch.randn(lat.shape, generator=gen, device=dev)
                if renoise is None and m is not None:
                    renoise = torch.randn(lat.shape, generator=gen, device=dev)
                cc, pc = cond(instruction)
                cu, pu = cond("")
                out = ultraedit_edit(mmdit, lat, cc, pc, cu, pu, num_steps=steps,
                                     guidance_scale=s_txt, image_guidance_scale=s_img,
                                     mask=m, init_latents=init_latents.to(dev),
                                     renoise=None if renoise is None else renoise.to(dev))
                return self._from_latents(out, [image_u8.shape[:2]], "sd3_vae")[0]
            return edit
        return self._get("ultraedit", build)

    # ---- caption-pair synthesis --------------------------------------------
    def _start_noise(self, shape, seed: int, noise: Optional[torch.Tensor]) -> torch.Tensor:
        """`noise` on the device, or the first N(0, 1) draw of
        `torch.Generator(seed)` there."""
        if noise is not None:
            return noise.to(self.device).float()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device)

    def _decode_u8(self, lat: torch.Tensor) -> np.ndarray:
        """One SD-VAE decode of (B, h, w, 4) latents -> (B, S, S, 3) uint8 at
        the canvas size (no resize, as the JAX zoo's pair slots)."""
        imgs = self._vae().decode((lat / self.cfg.vae.scaling_factor).to(torch.bfloat16))
        return denormalize_to_u8(imgs).cpu().numpy()

    def masactrl_pair_fn(self):
        """`pair(src_caption, tgt_caption, seed, steps=50, noise=None) ->
        (src_u8, tgt_u8)`: `consistent_synthesis` from one shared start
        latent (1, hw, hw, 4), the target reading the source's
        self-attention K/V from step 5 / site 12 on (action_change_tool.py:
        15-46); both latents decoded in one batch-2 VAE call."""
        def build():
            from anyedit_tpu_torch.edits.action_change import consistent_synthesis
            c = self.cfg
            unet, ns = self._sd_core()
            self._vae()
            text = self._text_encoder()
            hw = c.canvas.edit_size // c.canvas.latent_down

            def unet_apply(x, t, ctx, proc, extra):
                return unet(x, t, ctx, processor=proc, extra=extra)

            @torch.inference_mode()
            def pair(src_caption: str, tgt_caption: str, seed: int, steps: int = 50,
                     noise: Optional[torch.Tensor] = None):
                z0 = self._start_noise((1, hw, hw, c.sd_unet.in_channels), seed, noise)
                lat = consistent_synthesis(
                    unet_apply, ns, text(src_caption).to(torch.bfloat16),
                    text(tgt_caption).to(torch.bfloat16), text("").to(torch.bfloat16), z0,
                    num_steps=steps)
                u8 = self._decode_u8(lat)
                return u8[0], u8[1]
            return pair
        return self._get("masactrl_pair", build)

    def _keyword_token(self, caption: str, keyword: str) -> int:
        """The keyword's first CLIP token position in the caption (the first
        match of its ids without SOT / EOT), or 1."""
        cap_ids = self.clip_tokenizer.encode(caption)
        kw_ids = self.clip_tokenizer.encode(keyword)[1:-1]
        for i in range(1, len(cap_ids) - len(kw_ids)):
            if cap_ids[i:i + len(kw_ids)] == kw_ids:
                return i
        return 1

    def p2p_pair(self):
        """`run(ori_caption, tar_caption, keyword, seed, steps=20,
        cfg_scale=7.5, noise=None) -> (ori_u8, tar_u8, mask (S, S) bool)`:
        SD text2img of both captions from one shared start latent, one
        batch-4 UNet call a step under an AttentionStore (maps up to
        (hw / 2)^2 tokens); the conditional rows of the first largest map
        accumulate over the steps, and the keyword's column of the target
        row's mean, thresholded (`mask_from_ca`), resized "nearest" to the
        canvas, gives the mask (implicit_tool.py:76-127 stage 1). The UNet
        is `ip2p_unet` with 4 input channels under the "unet_sd" slot (the
        pair slots' one UNet where that is `sd_unet`)."""
        def build():
            c = self.cfg
            ucfg = dataclasses.replace(c.ip2p_unet, in_channels=4)
            unet, ns = self._sd_core() if ucfg == c.sd_unet else self._get(
                "p2p_core", lambda: (self._unet("unet_sd", ucfg, False),
                                     make_noise_schedule(device=self.device)))
            self._vae()
            text = self._text_encoder()
            size = c.canvas.edit_size
            hw = size // c.canvas.latent_down
            store = AttentionStore(max_hw=(hw // 2) ** 2)

            @torch.inference_mode()
            def run(ori_caption: str, tar_caption: str, keyword: str, seed: int,
                    steps: int = 20, cfg_scale: float = 7.5,
                    noise: Optional[torch.Tensor] = None):
                un, co, ct = (text(t).to(torch.bfloat16) for t in ("", ori_caption, tar_caption))
                ctx4 = torch.cat([un, un, co, ct], dim=0)
                lat, acc = p2p_sample(unet, ns, ctx4,
                                      self._start_noise((1, hw, hw, 4), seed, noise), store,
                                      num_steps=steps, guidance_scale=cfg_scale)
                u8 = self._decode_u8(lat)
                tok = self._keyword_token(tar_caption, keyword)
                ca_hw = int(np.sqrt(acc.shape[1]))
                mask = mask_from_ca(acc[1:2] / max(1, steps), min(tok, acc.shape[-1] - 1), ca_hw)
                full = resize_image(mask[0].float()[..., None], size, size, "nearest")[..., 0]
                return u8[0], u8[1], (full > 0.5).cpu().numpy()
            return run
        return self._get("p2p_pair", build)

    def _flux_sampler(self):
        """`sample(prompt, seed, steps=4, out_hw=None, noise=None) ->
        image_u8`: context = T5 at `flux_t5_len` tokens in bf16 (spans
        `t5`), pooled = CLIP-L's unprojected pooled output (FluxPipeline's
        CLIPTextModel pooler_output; span `flux_text`), 4 flow steps at
        shift 1.0, one Flux call a step at batch 1 (spans `flux`), the Flux
        VAE's decode, lanczos to `out_hw` (the canvas). On a CUDA device the
        Flux call is replayed from a CUDA graph (`ops/cuda_graph.py`): at
        batch 1 its launches take the host as long as the card takes to run
        them."""
        def build():
            c = self.cfg
            flux = Graphed(self._flux())
            self._vae_named("flux_vae")
            t5 = self._t5(c.flux_t5_len)
            clip = self._text_raw("clip_text", c.text)
            size = c.canvas.edit_size
            hw = size // c.canvas.latent_down

            @torch.inference_mode()
            def sample(prompt: str, seed: int, steps: int = 4, out_hw=None,
                       noise: Optional[torch.Tensor] = None) -> np.ndarray:
                with trace.span("t5", "editor"):
                    ctx = t5(prompt).to(torch.bfloat16)
                if ctx.shape[-1] != c.flux.context_dim:
                    raise ValueError("flux_text.dim must equal flux.context_dim")
                with trace.span("flux_text", "editor"):
                    _, pooled, _ = clip(prompt)
                z0 = self._start_noise((1, hw, hw, c.flux.in_channels), seed, noise)
                out = flux_sample(flux, z0, ctx, pooled, num_steps=steps)
                return self._from_latents(out, [out_hw or (size, size)], "flux_vae")[0]
            return sample
        return self._get("flux_sampler", build)

    def flux_pair_fn(self):
        """`pair(caption_a, caption_b, seed, steps=4, noise=None) -> (img_a,
        img_b)`: the SAME seed (the same start noise) for both captions
        (flux-schnell 4-step, textual_change_tool.py:24-41)."""
        sample = self._flux_sampler()

        def pair(caption_a: str, caption_b: str, seed: int, steps: int = 4,
                 noise: Optional[torch.Tensor] = None):
            with trace.span("flux_pair", "editor"):
                return (sample(caption_a, seed, steps, noise=noise),
                        sample(caption_b, seed, steps, noise=noise))
        return pair

    def text2img_fn(self):
        """`t2i(prompt, seed=0) -> image_u8`: one Flux image at the canvas
        size (local add's source regeneration, local_pipeline_tool.py:125-132)."""
        sample = self._flux_sampler()
        return lambda prompt, seed=0: sample(prompt, seed)

    # ---- SDXL refine stack (implicit_change stages 2-4, material_transfer) --
    def _text_xl(self):
        """text -> (context (1, L, L_hidden + G_hidden), pooled (1, G_proj)):
        the penultimate hidden states (no final LN) of CLIP-L and of
        OpenCLIP-bigG, concatenated, and bigG's projected pooled output."""
        raw_l = self._text_raw("clip_text", self.cfg.text)
        raw_g = self._text_raw("clip_text_g", self.cfg.text_g)

        def encode(text: str):
            _, _, hl = raw_l(text)
            _, pg, hg = raw_g(text)
            return torch.cat([hl, hg], dim=-1), pg
        return encode

    def _xl_cond(self, prompt: str, negative: str = ""):
        """(context2 (2, L, D) bf16, pooled2 (2, P), time_ids2 (2, 6)): the
        [cond, uncond] rows of the refine UNet. SDXL's time ids are (size,
        size, 0, 0, size, size) at the canvas size."""
        text_xl = self._text_xl()
        (hc, pc), (hu, pu) = text_xl(prompt), text_xl(negative)
        size = float(self.cfg.canvas.edit_size)
        tid = torch.tensor([[size, size, 0.0, 0.0, size, size]], device=self.device)
        return (torch.cat([hc, hu]).to(torch.bfloat16), torch.cat([pc, pu]),
                torch.cat([tid, tid]))

    def _refine_unet(self):
        """(refine UNet, noise_schedule), slot "unet_refine"; W8A8 with
        `quant_diffusion`, as in the JAX zoo. The refine slots feed it SDXL's
        micro-conditioning, so its config must take a pooled text and 6 time
        ids."""
        c = self.cfg
        if not c.refine_unet.addition_embed_dim or c.refine_unet.addition_time_dim != 6:
            raise ValueError("refine_unet needs SDXL micro-conditioning "
                             "(addition_embed_dim > 0, addition_time_dim 6)")
        return self._get("refine_unet", lambda: (
            self._unet("unet_refine", c.refine_unet, c.quant_diffusion),
            make_noise_schedule(device=self.device)))

    def _control_unet(self, slot: str) -> ControlNet:
        """A float ControlNet on the refine UNet config with a 3-channel
        hint, slot "controlnet_canny" or "controlnet_depth"."""
        ucfg = self.cfg.refine_unet
        return self._get(slot, lambda: self._load(
            ControlNet(ucfg, 3, device=self.device), slot,
            lambda t: bridge.controlnet_state_dict(t, len(ucfg.block_channels),
                                                   ucfg.use_linear_projection)))

    def _ip_modules(self) -> tuple[ImageProjection, IPAdapterWeights]:
        """The IP-Adapter on the refine UNet: the ImageProjection (4 tokens,
        slot "ip_proj") and every cross-attention site's K/V projection
        (slot "ip_adapter"), fp32."""
        def build():
            c = self.cfg
            names, dims = cross_attn_sites(c.refine_unet)
            ctx = c.refine_unet.context_dim
            proj = self._load(ImageProjection(c.vision.proj_dim, 4, ctx, device=self.device),
                              "ip_proj", bridge.ip_proj_state_dict)
            ipw = self._load(IPAdapterWeights(names, dims, ctx, device=self.device),
                             "ip_adapter", lambda t: bridge.ip_adapter_state_dict(t, names))
            return proj, ipw
        return self._get("ip_modules", build)

    def _ip_adapter(self):
        """`site_kv(image_u8, uncond=False) -> {site: (k, v)}`: the
        L2-normed CLIP-L image embedding (`clip_towers`, as the JAX zoo feeds
        it: ROADMAP queue 3) through `_ip_modules`; `uncond` zeroes the
        tokens."""
        def build():
            proj, ipw = self._ip_modules()
            clip_image, _ = self.clip_towers()

            def site_kv(image_u8, uncond: bool = False):
                tokens = proj(clip_image(image_u8))
                return ipw(torch.zeros_like(tokens) if uncond else tokens)
            return site_kv
        return self._get("ip_adapter", build)

    def _ip_processor(self, image_u8):
        """The IP-Adapter processor over `image_u8`'s [cond, uncond] K/V."""
        site_kv = self._ip_adapter()
        kv_c, kv_u = site_kv(image_u8), site_kv(image_u8, uncond=True)
        return ip_adapter_processor({n: (torch.cat([kc, kv_u[n][0]]), torch.cat([vc, kv_u[n][1]]))
                                     for n, (kc, vc) in kv_c.items()})

    def _refine_eps(self, unet, pooled2, tid2, cn=None, hint2=None, processor=None):
        """The refine loop's eps_fn over a batch-2 call: the UNet with the
        micro-conditioning, with a ControlNet's residuals on `hint2` and a
        processor where given."""
        def eps_fn(x, t, ctx):
            res = mid = None
            if cn is not None:
                res, mid = cn(x, t, ctx, hint2, pooled_text=pooled2, time_ids=tid2)
            return unet(x, t, ctx, processor=processor, controlnet_residuals=res,
                        controlnet_mid=mid, pooled_text=pooled2, time_ids=tid2)
        return eps_fn

    def _hint2(self, map_u8) -> torch.Tensor:
        """A (H, W) uint8 condition map -> the ControlNet hint (2, S, S, 3)
        at S = 8 x the latent size (the hint encoder's three stride-2 convs):
        bilinear, / 255, tiled to 3 channels and the CFG rows."""
        size = self.cfg.canvas.edit_size // self.cfg.canvas.latent_down * 8
        m = torch.as_tensor(np.asarray(map_u8), device=self.device).float()[..., None]
        return (resize_image(m, size, size, "bilinear") / 255.0)[None].expand(2, -1, -1, 3)

    def img2img_fn(self):
        """`img2img(image_u8, prompt, strength=0.5, seed=0, steps=30,
        scale=7.5, noise=None) -> image_u8`: SDEdit on the refine UNet
        (implicit_tool.py:129-148), `strength` rounded to 3 places; the
        noise drawn from `torch.Generator(seed)` unless given."""
        def build():
            unet, ns = self._refine_unet()
            self._vae_named("sdxl_vae")

            @torch.inference_mode()
            def img2img(image_u8, prompt: str, strength: float = 0.5, seed: int = 0,
                        steps: int = 30, scale: float = 7.5,
                        noise: Optional[torch.Tensor] = None) -> np.ndarray:
                lat = self._to_latents([image_u8], "sdxl_vae")
                ctx2, pooled2, tid2 = self._xl_cond(prompt)
                out = sample_img2img(self._refine_eps(unet, pooled2, tid2), ns, lat, ctx2[:1],
                                     ctx2[1:], num_steps=steps,
                                     strength=round(float(strength), 3), guidance_scale=scale,
                                     noise=self._start_noise(lat.shape, seed, noise))
                return self._from_latents(out, [image_u8.shape[:2]], "sdxl_vae")[0]
            return img2img
        return self._get("img2img", build)

    def _seeded_pair(self, shape, seed: int, noise, renoise):
        """(noise, renoise): given, or the first and second draws of
        `torch.Generator(seed)` on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        drawn = [torch.randn(shape, generator=gen, device=self.device) for _ in range(2)]
        return (drawn[0] if noise is None else noise.to(self.device).float(),
                drawn[1] if renoise is None else renoise.to(self.device).float())

    def sdxl_inpaint_fn(self):
        """`inpaint(image_u8, mask01, prompt, seed=0, steps=30, strength=0.98,
        scale=7.5, noise=None, renoise=None) -> image_u8`: implicit_change's
        stage 2 (implicit_tool.py:96-127), the refine UNet's masked img2img
        (the mask at latent size above 0.25): repaint inside the mask, the
        original re-noised outside it after every step."""
        def build():
            unet, ns = self._refine_unet()
            self._vae_named("sdxl_vae")

            @torch.inference_mode()
            def inpaint(image_u8, mask01, prompt: str, seed: int = 0, steps: int = 30,
                        strength: float = 0.98, scale: float = 7.5,
                        noise: Optional[torch.Tensor] = None,
                        renoise: Optional[torch.Tensor] = None) -> np.ndarray:
                lat = self._to_latents([image_u8], "sdxl_vae")
                noise, renoise = self._seeded_pair(lat.shape, seed, noise, renoise)
                ctx2, pooled2, tid2 = self._xl_cond(prompt)
                out = sample_img2img(self._refine_eps(unet, pooled2, tid2), ns, lat, ctx2[:1],
                                     ctx2[1:], num_steps=steps,
                                     strength=round(float(strength), 3), guidance_scale=scale,
                                     mask=self._latent_mask(mask01, 0.25)[None], noise=noise,
                                     renoise=renoise)
                return self._from_latents(out, [image_u8.shape[:2]], "sdxl_vae")[0]
            return inpaint
        return self._get("sdxl_inpaint", build)

    def canny_fn(self, image_u8) -> np.ndarray:
        """image_u8 -> (H, W) uint8 {0, 255} Canny edges, on the zoo's device."""
        img = torch.as_tensor(np.asarray(image_u8), device=self.device)
        return canny(rgb_to_gray(img)).cpu().numpy()

    def canny_consistency_fn(self):
        """`consistency(image_u8, prompt, seed=0, steps=30, strength=0.6,
        scale=7.5, ref_image=None, mask01=None, noise=None, renoise=None) ->
        image_u8`: implicit_change's stage 4 (implicit_tool.py:174-235),
        img2img on the refine UNet with the canny ControlNet on the image's
        edges and the IP-Adapter on `ref_image` (default the image itself);
        with `mask01`, masked as `sdxl_inpaint`."""
        def build():
            unet, ns = self._refine_unet()
            cn = self._control_unet("controlnet_canny")
            self._ip_adapter()
            self._vae_named("sdxl_vae")

            @torch.inference_mode()
            def consistency(image_u8, prompt: str, seed: int = 0, steps: int = 30,
                            strength: float = 0.6, scale: float = 7.5, ref_image=None,
                            mask01=None, noise: Optional[torch.Tensor] = None,
                            renoise: Optional[torch.Tensor] = None) -> np.ndarray:
                lat = self._to_latents([image_u8], "sdxl_vae")
                noise, renoise = self._seeded_pair(lat.shape, seed, noise, renoise)
                m = None if mask01 is None else self._latent_mask(mask01, 0.25)[None]
                ctx2, pooled2, tid2 = self._xl_cond(prompt)
                proc = self._ip_processor(image_u8 if ref_image is None else ref_image)
                eps = self._refine_eps(unet, pooled2, tid2, cn, self._hint2(
                    self.canny_fn(image_u8)), proc)
                out = sample_img2img(eps, ns, lat, ctx2[:1], ctx2[1:], num_steps=steps,
                                     strength=round(float(strength), 3), guidance_scale=scale,
                                     mask=m, noise=noise, renoise=renoise)
                return self._from_latents(out, [image_u8.shape[:2]], "sdxl_vae")[0]
            return consistency
        return self._get("canny_consistency", build)

    def sdxl_material_fn(self):
        """`material(init_u8, mask, depth_u8, exemplar_u8, seed=0, steps=30,
        strength=0.9, scale=7.5, noise=None) -> image_u8`: material_transfer
        (material_transfer_tool.py:190-198), img2img of the grey-masked
        init on the refine UNet with the depth ControlNet and the
        IP-Adapter on the exemplar, prompt "high quality, detailed material
        texture"; the latents outside the mask (at latent size above 0.25)
        stay the init's."""
        def build():
            unet, ns = self._refine_unet()
            cn = self._control_unet("controlnet_depth")
            self._ip_adapter()
            self._vae_named("sdxl_vae")

            @torch.inference_mode()
            def material(init_u8, mask, depth_u8, exemplar_u8, seed: int = 0, steps: int = 30,
                         strength: float = 0.9, scale: float = 7.5,
                         noise: Optional[torch.Tensor] = None) -> np.ndarray:
                lat = self._to_latents([init_u8], "sdxl_vae")
                m = self._latent_mask(mask, 0.25)[None]
                ctx2, pooled2, tid2 = self._xl_cond("high quality, detailed material texture")
                eps = self._refine_eps(unet, pooled2, tid2, cn, self._hint2(depth_u8),
                                       self._ip_processor(exemplar_u8))
                out = sample_img2img(eps, ns, lat, ctx2[:1], ctx2[1:], num_steps=steps,
                                     strength=round(float(strength), 3), guidance_scale=scale,
                                     noise=self._start_noise(lat.shape, seed, noise))
                return self._from_latents(m * out + (1.0 - m) * lat, [init_u8.shape[:2]],
                                          "sdxl_vae")[0]
            return material
        return self._get("sdxl_material", build)

    def _depth_model(self) -> DepthAnythingV2:
        return self._get("depth_model", lambda: self._load(
            DepthAnythingV2(self.cfg.depth_cfg, device=self.device), "depth",
            bridge.depth_state_dict))

    def depth_fn(self):
        """`depth(image_u8) -> (H, W) uint8`: Depth-Anything-V2 on the image
        resized bilinear to its input size (ImageNet mean and std), the
        relative depth min-max scaled to 0-255, resized bilinear back and
        truncated to uint8."""
        def build():
            model = self._depth_model()
            s = self.cfg.depth_cfg.backbone.img_size

            @torch.inference_mode()
            def depth(image_u8) -> np.ndarray:
                h, w = image_u8.shape[:2]
                d8 = depth_to_u8(model(self._pixels(image_u8, s)))[0]
                return to_u8(resize_image(d8[..., None].float(), h, w, "bilinear")[..., 0]
                             ).cpu().numpy()
            return depth
        return self._get("depth", build)

    # ---- visual conditions, composition, AnyDoor -------------------------------
    def hed_fn(self):
        """`hed(image_u8) -> (H, W) fp32` soft edges in [0, 1]: HED (fp32) on
        the image resized bilinear to the canvas, resized bilinear back."""
        def build():
            model = self._get("hed_model", lambda: self._load(
                HED(device=self.device), "hed", bridge.hed_state_dict))
            size = self.cfg.canvas.edit_size

            @torch.inference_mode()
            def hed(image_u8) -> np.ndarray:
                h, w = image_u8.shape[:2]
                img = torch.as_tensor(np.asarray(image_u8), device=self.device).float()
                e = model(resize_image(img, size, size, "bilinear")[None])[0]
                return resize_image(e[..., None], h, w, "bilinear")[..., 0].cpu().numpy()
            return hed
        return self._get("hed", build)

    def seg_fn(self):
        """`seg(image_u8) -> (H, W, 3) uint8`: the segmenter's class map at
        the canvas size (bilinear, ImageNet mean and std), rendered with the
        ADE palette and resized "nearest" back."""
        def build():
            c = self.cfg
            model = self._get("seg_model", lambda: self._load(
                UperNetSegmenter(c.seg_cfg, device=self.device), "seg", bridge.seg_state_dict))
            s = c.canvas.edit_size

            @torch.inference_mode()
            def seg(image_u8) -> np.ndarray:
                h, w = image_u8.shape[:2]
                rendered = render_segmentation(model(self._pixels(image_u8, s)))[0]
                return to_u8(resize_image(torch.as_tensor(rendered, device=self.device), h, w,
                                          "nearest")).cpu().numpy()
            return seg
        return self._get("seg", build)

    def composition_fn(self):
        """`run(plan_text, seed=0, steps=50, cfg_scale=7.5, noise=None) ->
        image_u8` at the canvas size: the plan's global prompt (or the whole
        text) and region prompts as one fused CLIP context, the regional
        bias prepared at the latent sizes hw, hw / 2 and hw / 4, the
        unconditional context `text("")` once a part, on the resident SD1.5
        UNet (composition_image_generation.py:40-62)."""
        def build():
            c = self.cfg
            unet, ns = self._sd_core()
            self._vae()
            text = self._text_encoder()
            size = c.canvas.edit_size
            hw = size // c.canvas.latent_down

            @torch.inference_mode()
            def run(plan_text: str, seed: int = 0, steps: int = 50, cfg_scale: float = 7.5,
                    noise: Optional[torch.Tensor] = None) -> np.ndarray:
                gp, regions = parse_canvas_plan(plan_text)
                ctx, proc = build_regional_conditioning(text, gp or plan_text, regions,
                                                        [hw, hw // 2, hw // 4])
                ctx2 = torch.cat([ctx, torch.cat([text("")] * (1 + len(regions)), dim=1)])
                lat = sample_cfg(lambda x, t, cx: unet(x, t, cx, processor=proc), ns,
                                 self._start_noise((1, hw, hw, c.sd_unet.in_channels), seed,
                                                   noise),
                                 ctx2.to(torch.bfloat16), num_steps=steps,
                                 guidance_scale=cfg_scale)
                return self._from_latents(lat, [(size, size)])[0]
            return run
        return self._get("composition", build)

    def _dino(self) -> DinoV2:
        """AnyDoor's reference tower and the DINO scorer's (slot "dinov2_g")."""
        return self._get("dinov2_g", lambda: self._load(
            DinoV2(self.cfg.dino_cfg, device=self.device), "dinov2_g",
            bridge.dinov2_state_dict))

    def _anydoor_core(self):
        """(SD2.1-class UNet, its ControlNet on a 4-channel hint, the fp32
        DINOv2-token projection to the UNet context, noise_schedule): slots
        "unet_anydoor", "controlnet_anydoor", "anydoor_proj", bf16 apart from
        the projection."""
        def build():
            c = self.cfg
            ucfg = c.anydoor_unet
            n = len(ucfg.block_channels)
            unet = self._unet("unet_anydoor", ucfg, False)
            cn = self._load(ControlNet(ucfg, 4, device=self.device), "controlnet_anydoor",
                            lambda t: bridge.controlnet_state_dict(t, n, False))
            proj = self._load(torch.nn.Linear(c.dino_cfg.dim, ucfg.context_dim,
                                              device=self.device),
                              "anydoor_proj", bridge.linear_state_dict)
            return unet, cn, proj, make_noise_schedule(device=self.device)
        return self._get("anydoor_core", build)

    def anydoor(self):
        """`run(target_u8, mask, collage_u8, hf_map, ref_u8, steps=50,
        cfg_scale=9.0, seed=0, noise=None) -> image_u8` (the target's size):
        AnyDoor's ControlLDM (cldm/cldm.py:307). Context: the reference's
        DINOv2 cls and patch tokens through the fp32 projection, beside an
        all-zero unconditional row. Hint: collage / 255 and hf_map / 255,
        each resized bilinear to 8x the latent size (4 channels; the mask is
        not in it). 50 DDIM steps at CFG 9, the ControlNet's residuals in
        every UNet call; the SD VAE decode resized lanczos to the target's
        size and pasted where `mask` is 1."""
        def build():
            c = self.cfg
            unet, cn, proj, ns = self._anydoor_core()
            dino = self._dino()
            self._vae()
            size = c.canvas.edit_size
            hw = size // c.canvas.latent_down
            hint_size = hw * 8

            def eps_fn(hint2):
                def eps(x, t, ctx):
                    res, mid = cn(x, t, ctx, hint2)
                    return unet(x, t, ctx, controlnet_residuals=res, controlnet_mid=mid)
                return eps

            def on_device(a) -> torch.Tensor:
                return torch.as_tensor(np.asarray(a), device=self.device).float()

            @torch.inference_mode()
            def run(target_u8, mask, collage_u8, hf_map, ref_u8, steps: int = 50,
                    cfg_scale: float = 9.0, seed: int = 0,
                    noise: Optional[torch.Tensor] = None) -> np.ndarray:
                out = dino(self._pixels(ref_u8, c.dino_cfg.img_size))
                ctx1 = proj(torch.cat([out["cls"][:, None], out["patch"]], dim=1))
                ctx2 = torch.cat([ctx1, torch.zeros_like(ctx1)]).to(torch.bfloat16)
                col = resize_image(on_device(collage_u8) / 255.0, hint_size, hint_size,
                                   "bilinear")
                hfm = resize_image(on_device(hf_map)[..., None], hint_size, hint_size, "bilinear")
                hint1 = torch.cat([col, hfm / 255.0], dim=-1)
                z0 = self._start_noise((1, hw, hw, c.vae.latent_channels), seed, noise)
                lat = sample_cfg(eps_fn(torch.stack([hint1, hint1])), ns, z0, ctx2,
                                 num_steps=steps, guidance_scale=cfg_scale)
                img = self._vae().decode((lat / c.vae.scaling_factor).to(torch.bfloat16))[0]
                h0, w0 = target_u8.shape[:2]
                full = resize_image(denormalize_to_u8(img).float(), h0, w0, "lanczos")
                m = on_device(mask)[..., None]
                return to_u8(full * m + on_device(target_u8) * (1 - m)).cpu().numpy()
            return run
        return self._get("anydoor", build)

    def dino_embed(self):
        """`embed(image_u8) -> (1, D)` fp32: the L2-normed DINOv2 CLS
        embedding (bilinear to the tower's size, ImageNet mean and std), the
        DINO subject-fidelity scorer."""
        def build():
            dino = self._dino()
            s = self.cfg.dino_cfg.img_size

            @torch.inference_mode()
            def embed(image_u8) -> np.ndarray:
                cls = dino(self._pixels(image_u8, s))["cls"]
                return (cls / torch.clamp(cls.norm(dim=-1, keepdim=True), min=1e-8)).cpu().numpy()
            return embed
        return self._get("dino_embed", build)


# edit_type -> the slots it needs beyond ground / inpaint / ip2p; `run` takes
# their union over the record stream, so only the models a run touches are
# built (the JAX zoo's table, key for key)
SLOTS_FOR_EDIT_TYPE: dict[str, tuple[str, ...]] = {
    "add": (), "remove": (), "counting": (),
    "replace": ("sd_inpaint",),
    "background_change": ("sd_inpaint",),
    "color_alter": (), "tone_transfer": (),
    "appearance_alter": ("ultraedit",),
    "material_alter": ("ultraedit",),
    "action_change": ("masactrl",),
    "resize": (), "movement": (), "relation": (), "outpainting": (),
    "textual_change": ("flux_pair",),
    "implicit_change": ("p2p_pair", "sdxl_inpaint", "sdxl_img2img",
                        "canny_consistency", "clip"),
    "style_change": (),
    "rotation_change": (),
    "composition": ("composition",),
    "visual_bbox": (), "visual_sketch": ("canny",),
    "visual_scribble": ("hed",), "visual_depth": ("depth",),
    "visual_segment": ("seg",),
    "visual_reference": ("anydoor",),
    "visual_material_transfer": ("sdxl_material", "depth"),
    "material_transfer": ("sdxl_material", "depth"),
}


@contextlib.contextmanager
def _no_tf32_convs():
    """cuDNN's fp32 convolutions in full fp32 inside the block (PyTorch's
    default runs them in TF32); the previous setting is restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
