"""Checkpoint manifest: where every registry checkpoint comes from, and the
one shell script that fetches and converts them all (counterpart of
`anyedit_tpu/weights/manifest.py`; `MANIFEST` and `ASSETS` are its copies).

The reference bootstraps its checkpoints with `huggingface-cli download` /
`wget` (setup.sh:20-118). `MANIFEST` re-keys that list by the convert
registry (`weights/bootstrap.py::REGISTRY`): for every slot, where the
source lives and which file or directory `convert --src` reads.
`emit_plan()` turns it into a script that

  1. downloads every source once (a networked host; an HF token only for
     the gated Llama-3 repo). A hub repo that feeds several slots with
     different `--include` filters is fetched once with all of them (the
     JAX plan keys on the repo alone and keeps only the first filter, so
     SD1.5's `vae/*` and SDXL's `text_encoder_2/*` never arrive);
  2. runs `python -m anyedit_tpu_torch convert --model <name> --src <path>
     --out <weights>/<name>.safetensors`, with `--verify` on every family
     `weights/verify.py` can run (it needs `transformers`);
  3. copies the tokenizer assets next to the weights, under the names the
     zoo reads (`runtime/zoo.py::select_tokenizers`).

Usage:
    python -m anyedit_tpu_torch convert --plan downloads/ > fetch_convert.sh
    bash fetch_convert.sh            # networked host
    python -m anyedit_tpu_torch run ... --weights weights/ --require-weights
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Source:
    """Where one convert-registry entry's torch checkpoint comes from."""
    hub: Optional[str] = None        # huggingface repo id
    include: Optional[str] = None    # subdir/file filter inside the repo
    url: Optional[str] = None        # direct wget (non-HF hosts)
    src: str = ""                    # path passed to `convert --src`,
    #                                  relative to the download root
    token: bool = False              # needs HF auth (gated repo)
    save_as: str = ""                # wget -O name (defaults from src)
    note: str = ""


# registry name → source. One download can feed several conversions
# (AnyDoor's single ckpt → 4 slots; BLIP-2's dir → eva_vit + blip2).
MANIFEST: dict[str, Source] = {
    # --- SD1.5 family (setup.sh:29-31,44-45) ---------------------------
    "unet_sd": Source(hub="runwayml/stable-diffusion-v1-5", include="unet/*",
                      src="stable-diffusion-v1-5/unet"),
    "vae": Source(hub="runwayml/stable-diffusion-v1-5", include="vae/*",
                  src="stable-diffusion-v1-5/vae"),
    "clip_text": Source(hub="openai/clip-vit-large-patch14",
                        src="clip-vit-large-patch14"),
    "unet_ip2p": Source(hub="timbrooks/instruct-pix2pix", include="unet/*",
                        src="instruct-pix2pix/unet"),
    "unet_inpaint": Source(hub="runwayml/stable-diffusion-inpainting",
                           include="unet/*",
                           src="stable-diffusion-inpainting/unet"),
    # --- SDXL (setup.sh:35-36) -----------------------------------------
    "unet_refine": Source(hub="stabilityai/stable-diffusion-xl-base-1.0",
                          include="unet/*",
                          src="stable-diffusion-xl-base-1.0/unet"),
    "clip_text_g": Source(hub="stabilityai/stable-diffusion-xl-base-1.0",
                          include="text_encoder_2/*",
                          src="stable-diffusion-xl-base-1.0/text_encoder_2"),
    # --- SD3 UltraEdit (setup.sh:50-51) --------------------------------
    "mmdit_ultraedit": Source(hub="BleachNick/SD3_UltraEdit_w_mask",
                              include="transformer/*",
                              src="SD3_UltraEdit_w_mask/transformer"),
    "clip_text_sd3": Source(hub="BleachNick/SD3_UltraEdit_w_mask",
                            include="text_encoder/*",
                            src="SD3_UltraEdit_w_mask/text_encoder"),
    "t5": Source(hub="BleachNick/SD3_UltraEdit_w_mask",
                 include="text_encoder_3/*",
                 src="SD3_UltraEdit_w_mask/text_encoder_3"),
    # --- Flux (setup.sh:53-54) ------------------------------------------
    "flux": Source(hub="black-forest-labs/FLUX.1-schnell",
                   include="transformer/*",
                   src="FLUX.1-schnell/transformer"),
    # --- grounding + masks (setup.sh:26,56-58) ---------------------------
    "sam": Source(
        url="https://dl.fbaipublicfiles.com/segment_anything/sam_vit_h_4b8939.pth",
        src="sam_vit_h_4b8939.pth"),
    "gdino": Source(hub="ShilongLiu/GroundingDINO",
                    include="groundingdino_swinb_cogcoor.pth",
                    src="GroundingDINO/groundingdino_swinb_cogcoor.pth"),
    "lama": Source(
        url="https://huggingface.co/smartywu/big-lama/resolve/main/big-lama.zip",
        src="big-lama/models/best.ckpt", save_as="big-lama.zip",
        note="unzip big-lama.zip after download"),
    # --- condition extractors (setup.sh:63-79) ---------------------------
    "hed": Source(hub="lllyasviel/Annotators", include="ControlNetHED.pth",
                  src="Annotators/ControlNetHED.pth"),
    "depth": Source(hub="depth-anything/Depth-Anything-V2-Large",
                    include="depth_anything_v2_vitl.pth",
                    src="Depth-Anything-V2-Large/depth_anything_v2_vitl.pth"),
    "seg": Source(hub="openmmlab/upernet-swin-tiny",
                  src="upernet-swin-tiny"),
    "dinov2": Source(hub="facebook/dinov2-large", src="dinov2-large"),
    # --- AnyDoor: ONE ckpt feeds four slots (setup.sh:66-70) -------------
    "unet_anydoor": Source(
        url=("https://huggingface.co/spaces/xichenhku/AnyDoor/resolve/"
             "main/epoch%3D1-step%3D8687.ckpt"),
        src="anydoor.ckpt"),
    "controlnet_anydoor": Source(src="anydoor.ckpt",
                                 note="same download as unet_anydoor"),
    "anydoor_proj": Source(src="anydoor.ckpt",
                           note="same download as unet_anydoor"),
    "vae_anydoor": Source(src="anydoor.ckpt",
                          note="same download as unet_anydoor"),
    "dinov2_g": Source(
        url=("https://dl.fbaipublicfiles.com/dinov2/dinov2_vitg14/"
             "dinov2_vitg14_pretrain.pth"),
        src="dinov2_vitg14_pretrain.pth"),
    # --- IP-Adapter (setup.sh:60-61): one .bin, two slots ----------------
    "ip_proj": Source(hub="h94/IP-Adapter",
                      include="sdxl_models/ip-adapter_sdxl.bin",
                      src="IP-Adapter/sdxl_models/ip-adapter_sdxl.bin"),
    "ip_adapter": Source(src="IP-Adapter/sdxl_models/ip-adapter_sdxl.bin",
                         note="same download as ip_proj"),
    # --- filter scorers (setup.sh:82-87, pre_filter.py:83) ---------------
    "clip_vision": Source(hub="openai/clip-vit-large-patch14",
                          src="clip-vit-large-patch14",
                          note="same download as clip_text"),
    "clip_text_proj": Source(hub="openai/clip-vit-base-patch32",
                             src="clip-vit-base-patch32",
                             note="directional-CLIP tower (utils.py:280)"),
    "aesthetic": Source(
        url=("https://github.com/christophschuhmann/"
             "improved-aesthetic-predictor/raw/main/"
             "sac%2Blogos%2Bava1-l14-linearMSE.pth"),
        src="sac+logos+ava1-l14-linearMSE.pth"),
    "eva_vit": Source(hub="Salesforce/blip2-flan-t5-xl",
                      src="blip2-flan-t5-xl"),
    "blip2": Source(src="blip2-flan-t5-xl",
                    note="same download as eva_vit"),
    "ocr": Source(hub="stepfun-ai/GOT-OCR-2.0-hf", src="GOT-OCR-2.0-hf"),
    "vila": Source(hub="llava-hf/llava-1.5-7b-hf", src="llava-1.5-7b-hf",
                   note="VQA pre-filter tower (reference: VILA-1.5)"),
    # --- L2 instruction LLM (setup.sh:90-91, gated) -----------------------
    "llama": Source(hub="meta-llama/Meta-Llama-3-8B-Instruct",
                    src="Meta-Llama-3-8B-Instruct", token=True),
}

# the tokenizer assets the zoo requires next to the weights
ASSETS: dict[str, Source] = {
    "bpe_simple_vocab_16e6.txt.gz": Source(
        url=("https://github.com/openai/CLIP/raw/main/clip/"
             "bpe_simple_vocab_16e6.txt.gz"),
        note="CLIP BPE merges (models/clip_tokenizer.py)"),
    "vocab.txt": Source(hub="bert-base-uncased", include="vocab.txt",
                        src="bert-base-uncased/vocab.txt",
                        note="BERT WordPiece vocab (GDINO text tower)"),
    "tokenizer.json": Source(hub="meta-llama/Meta-Llama-3-8B-Instruct",
                             include="tokenizer.json", token=True,
                             src="Meta-Llama-3-8B-Instruct/tokenizer.json",
                             note="Llama-3 tokenizer (L2 generation)"),
}


def emit_plan(downloads: str = "downloads", weights: str = "weights") -> str:
    """The shell script: fetch every source once (a hub repo with the union
    of its entries' `--include` filters, none when an entry takes the whole
    repo), convert every registry slot (`--verify` where `VERIFIERS` has
    its family), copy the tokenizer assets."""
    from anyedit_tpu_torch.weights.verify import VERIFIERS

    dl, w = shlex.quote(downloads), shlex.quote(weights)
    lines = [
        "#!/bin/sh",
        "# generated by `python -m anyedit_tpu_torch convert --plan`; run on a",
        "# networked host; reruns are incremental (hf and wget skip completed",
        "# downloads, convert overwrites).",
        "set -ex",
        f"mkdir -p {dl} {w}",
    ]
    hubs: dict[str, list] = {}          # hub -> [filters or None for all, token]
    fetches: list[tuple[str, str, Source]] = []
    for name, s in {**MANIFEST, **ASSETS}.items():
        if s.hub:
            if s.hub not in hubs:
                hubs[s.hub] = [[], False]
                fetches.append(("hub", name, s))
            h = hubs[s.hub]
            h[1] = h[1] or s.token
            if s.include is None:
                h[0] = None
            elif h[0] is not None and s.include not in h[0]:
                h[0].append(s.include)
        elif s.url and all(f[2].url != s.url for f in fetches):
            fetches.append(("url", name, s))
    for kind, name, s in fetches:
        if kind == "hub":
            filters, token = hubs[s.hub]
            tok = " --token \"$HF_TOKEN\"" if token else ""
            inc = (" --include " + " ".join(shlex.quote(f) for f in filters)) if filters else ""
            dest = shlex.quote(f"{downloads}/{s.hub.split('/')[-1]}")
            lines.append(f"huggingface-cli download {s.hub}{inc} --local-dir {dest}{tok}")
        else:
            fname = s.save_as or s.src.split("/")[0] or name
            out = shlex.quote(f"{downloads}/{fname}")
            lines.append(f"wget -c {shlex.quote(s.url)} -O {out}")
            if s.note.startswith("unzip"):
                lines.append(f"unzip -o {out} -d {dl}")
    lines.append("")
    for name, s in MANIFEST.items():
        verify = " --verify" if name in VERIFIERS else ""
        lines.append(
            f"python -m anyedit_tpu_torch convert --model {name} "
            f"--src {shlex.quote(f'{downloads}/{s.src}')} "
            f"--out {shlex.quote(f'{weights}/{name}.safetensors')}{verify}")
    lines.append("")
    for asset, s in ASSETS.items():
        src = f"{downloads}/{s.src}" if s.src else f"{downloads}/{asset}"
        lines.append(f"cp {shlex.quote(src)} {shlex.quote(f'{weights}/{asset}')}")
    lines.append(f"echo 'weights ready: run with --weights {weights} --require-weights'")
    return "\n".join(lines) + "\n"
