"""Checkpoint registry: official torch checkpoints -> the zoo's per-slot
weight files (the counterpart of `anyedit_tpu/weights/bootstrap.py`).

The port's modules carry the official diffusers / HF / original-repo key
names (`weights/bridge.py`), so for most slots the map from a checkpoint
to the module's state dict is the identity, or a prefix to cut. Each map
is a *plan*: for every key of the slot's module, the source keys it is
read from and how (`_KINDS`). The plans that do more than rename:

- AnyDoor's one ControlLDM checkpoint splits four ways, each in ldm
  naming (`model.diffusion_model.*`, `control_model.*`,
  `cond_stage_model.projector.*`, `first_stage_model.*`), mapped onto
  the diffusers names of the port's UNet, ControlNet and VAE; ldm's
  Linear proj_in / proj_out become the 1x1 convs of SD21_ANYDOOR_UNET,
  and the VAE's 1x1-conv attention becomes Linears.
- The HF-mirror layouts (SAM's `vision_encoder.*`, Depth-Anything's
  `backbone.*` / `neck.*`, GroundingDINO's `model.*`), DINOv2-L's HF
  layout and the UperNet segmenter's: split q / k / v fused into one
  qkv, and the UperNet head's BatchNorms folded into its convs.
- DINOv2-G's 37x37 positional grid resized bicubic to AnyDoor's 16x16.
- IP-Adapter's `.bin` groups (flattened by `files.load_checkpoint`):
  `image_proj.*` and `ip_adapter.*`. The port's module is keyed by the
  diffusers processor index in diffusers' own site order, so the group
  loads by name (the JAX converter's site order is ROADMAP queue 3).
- BLIP-2's EVA tower: a checkpoint that keeps `q_bias` and `v_bias`
  beside a bias-free `qkv` (the BLIP-2 ViT's own layout) gets the fused
  bias (q, 0, v); a fused `qkv.bias` is read as is.
- T5: the stacks' embedding is HF's `shared.weight`.

The Flax-side transforms of the JAX converters (LaMa's FourierUnit
permutation, the MMDiT / Flux (scale, shift) swap, Flux's concatenated
projections, SAM's stacked box corners) have no counterpart here: the
port's modules hold those tensors in the checkpoint's own layout.

`convert_checkpoint(name, src, out)` reads `src` (`files.load_checkpoint`),
applies the plan, checks the result against the slot's module at its
full configuration on the meta device with `load_state_dict(strict=True)`
and writes `out` as safetensors. Output names are the zoo's slot names,
so a converted weights dir loads into `ModelZoo(weights_dir=...)`.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Mapping

import torch

from anyedit_tpu_torch.weights.files import load_checkpoint, write_safetensors

# port key -> (kind, source keys); a plan is made by `plan(module keys,
# checkpoint keys, module)`
Plan = dict[str, tuple[str, tuple[str, ...]]]


def _bn_scale(g, v, eps: float = 1e-5):
    return g.float() / torch.sqrt(v.float() + eps)


def _bn_bias(g, b, m, v, cb=None):
    scale = _bn_scale(g, v)
    bias = b.float() - m.float() * scale
    return bias if cb is None else bias + cb.float() * scale


def _pos_grid(pe: torch.Tensor, shape) -> torch.Tensor:
    """A (1, 1 + g0², D) ViT positional table resized bicubic (Keys a =
    -0.5, antialiased, as `jax.image.resize`) to (1, 1 + g1², D)."""
    from anyedit_tpu_torch.ops.resize import resize_image
    pe = pe.float()
    n_src, n_ours = pe.shape[1] - 1, shape[1] - 1
    if n_src == n_ours:
        return pe
    g0, g1, d = int(n_src ** 0.5), int(n_ours ** 0.5), pe.shape[-1]
    grid = resize_image(pe[0, 1:].reshape(g0, g0, d), g1, g1, "bicubic")
    return torch.cat([pe[:, :1], grid.reshape(1, g1 * g1, d)], dim=1)


# kind -> (tensors, the module's tensor shape) -> tensor
_KINDS: dict[str, Callable] = {
    "id": lambda ts, shape: ts[0],
    "cat": lambda ts, shape: torch.cat(list(ts), dim=0),
    "conv11": lambda ts, shape: ts[0][:, :, None, None],     # Linear (O, I) as a 1x1 conv
    "lin11": lambda ts, shape: ts[0][:, :, 0, 0],            # a 1x1 conv as Linear (O, I)
    "qkv_bias": lambda ts, shape: torch.cat([ts[0], torch.zeros_like(ts[0]), ts[1]]),
    # (conv.weight, bn.weight, bn.running_var): the conv scaled per output channel
    "bn_w": lambda ts, shape: ts[0].float() * _bn_scale(ts[1], ts[2])[:, None, None, None],
    # (bn.weight, bn.bias, bn.running_mean, bn.running_var[, conv.bias])
    "bn_b": lambda ts, shape: _bn_bias(*ts),
    "pos_grid": lambda ts, shape: _pos_grid(ts[0], shape),
}


def apply_plan(plan: Plan, src: Mapping[str, torch.Tensor],
               shapes: Mapping[str, tuple]) -> dict[str, torch.Tensor]:
    """The module's state dict from `src` by `plan`; a missing source key
    raises KeyError naming it."""
    out = {}
    for key, (kind, names) in plan.items():
        missing = [n for n in names if n not in src]
        if missing:
            raise KeyError(f"{key}: the checkpoint has no {missing[0]!r}")
        out[key] = _KINDS[kind]([src[n] for n in names], shapes[key]).contiguous()
    return out


def official_state(plan: Plan, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of `apply_plan` for the renaming kinds: a state dict in
    the checkpoint's layout that the plan maps back onto `sd` (the tests'
    and the chip check's way to write seeded weights under official names).
    BatchNorm folding and the grid resize have no inverse and raise."""
    out: dict[str, torch.Tensor] = {}
    for key, (kind, names) in plan.items():
        w = sd[key]
        if kind == "id":
            parts = [w]
        elif kind == "cat":
            parts = list(torch.chunk(w, len(names), dim=0))
        elif kind == "conv11":
            parts = [w[:, :, 0, 0]]
        elif kind == "lin11":
            parts = [w[:, :, None, None]]
        elif kind == "qkv_bias":
            q, _, v = torch.chunk(w, 3)
            parts = [q, v]
        else:
            raise ValueError(f"{key}: a {kind!r} entry has no inverse")
        for n, p in zip(names, parts):
            out[n] = p.contiguous()
    return out


# ---- the plans ---------------------------------------------------------------

def _same(prefix: str = "", shared: Mapping[str, str] | None = None):
    """Every module key read under `prefix`; `shared` names keys read from
    elsewhere (T5's embedding from `shared.weight`)."""
    def plan(keys, src_keys, module=None) -> Plan:
        shared_ = shared or {}
        return {k: ("id", (shared_.get(k, prefix + k),)) for k in keys}
    return plan


def _first_present(*prefixes: str):
    """Every module key read under the first prefix whose keys the
    checkpoint holds (LaMa's `generator.`, the DDP `module.`)."""
    def plan(keys, src_keys, module=None) -> Plan:
        probe = keys[0]
        pre = next((p for p in prefixes if p + probe in src_keys), prefixes[0])
        return {k: ("id", (pre + k,)) for k in keys}
    return plan


_SWIN_BLOCK = {"norm1": "layernorm_before", "norm2": "layernorm_after",
               "attn.relative_position_bias_table": "attention.self.relative_position_bias_table",
               "attn.proj": "attention.output.dense", "mlp.fc1": "intermediate.dense",
               "mlp.fc2": "output.dense"}


def _swin_hf(rest: str, hf: str):
    """An official Swin key (below its prefix) read from HF Swin naming
    under `hf` (the counterpart of convert.py's `_swin_hf_leaf`)."""
    if m := re.match(r"patch_embed\.proj\.(\w+)$", rest):
        return "id", (f"{hf}.embeddings.patch_embeddings.projection.{m[1]}",)
    if m := re.match(r"patch_embed\.norm\.(\w+)$", rest):
        return "id", (f"{hf}.embeddings.norm.{m[1]}",)
    if m := re.match(r"norm(\d+)\.(\w+)$", rest):
        return "id", (f"{hf}.hidden_states_norms.stage{int(m[1]) + 1}.{m[2]}",)
    if m := re.match(r"layers\.(\d+)\.downsample\.(.+)$", rest):
        return "id", (f"{hf}.encoder.layers.{m[1]}.downsample.{m[2]}",)
    if m := re.match(r"layers\.(\d+)\.blocks\.(\d+)\.(.+)\.(\w+)$", rest):
        blk, sub, leaf = f"{hf}.encoder.layers.{m[1]}.blocks.{m[2]}", m[3], m[4]
        if sub == "attn" and leaf == "relative_position_bias_table":
            return "id", (f"{blk}.{_SWIN_BLOCK[f'attn.{leaf}']}",)
        if sub == "attn.qkv":
            return "cat", tuple(f"{blk}.attention.self.{n}.{leaf}"
                                for n in ("query", "key", "value"))
        return "id", (f"{blk}.{_SWIN_BLOCK[sub]}.{leaf}",)
    raise KeyError(f"unmapped Swin key {rest!r}")


_UPER_HEAD = {"psp_modules": "{}.1", "lateral_convs": "{}", "fpn_convs": "{}"}


def _seg(keys, src_keys, module=None) -> Plan:
    """UperNet on Swin from HF `UperNetForSemanticSegmentation`: the
    backbone's q / k / v fused, each ConvModule's BatchNorm folded into
    its conv (`convert.py::_bn_fold`, eps 1e-5), the classifier as is; the
    auxiliary FCN head is not read."""
    plan: Plan = {}
    for k in keys:
        if k.startswith("backbone."):
            plan[k] = _swin_hf(k[len("backbone."):], "backbone")
            continue
        m = re.match(r"decode_head\.(?:(\w+)\.(\d+)|(\w+))\.(weight|bias)$", k)
        group, idx, single, leaf = m[1], m[2], m[3], m[4]
        if single == "classifier":
            plan[k] = "id", (k,)
            continue
        base = (f"decode_head.{group}.{_UPER_HEAD[group].format(idx)}" if group
                else f"decode_head.{single}")
        conv, bn = f"{base}.conv", f"{base}.batch_norm"
        if leaf == "weight":
            plan[k] = "bn_w", (f"{conv}.weight", f"{bn}.weight", f"{bn}.running_var")
        else:
            cb = (f"{conv}.bias",) if f"{conv}.bias" in src_keys else ()
            plan[k] = "bn_b", (f"{bn}.weight", f"{bn}.bias", f"{bn}.running_mean",
                               f"{bn}.running_var") + cb
    return plan


def _dinov2_hf(keys, src_keys, module=None) -> Plan:
    """DINOv2 from HF `Dinov2Model` naming onto the port's torch-hub names
    (q / k / v fused into qkv; LayerScale `lambda1` as `gamma`)."""
    top = {"cls_token": "embeddings.cls_token", "pos_embed": "embeddings.position_embeddings"}
    plan: Plan = {}
    for k in keys:
        if k in top:
            plan[k] = "id", (top[k],)
        elif m := re.match(r"patch_embed\.proj\.(\w+)$", k):
            plan[k] = "id", (f"embeddings.patch_embeddings.projection.{m[1]}",)
        elif m := re.match(r"norm\.(\w+)$", k):
            plan[k] = "id", (f"layernorm.{m[1]}",)
        else:
            m = re.match(r"blocks\.(\d+)\.(.+)$", k)
            lb, rest = f"encoder.layer.{m[1]}", m[2]
            if mm := re.match(r"attn\.qkv\.(\w+)$", rest):
                plan[k] = "cat", tuple(f"{lb}.attention.attention.{n}.{mm[1]}"
                                       for n in ("query", "key", "value"))
            elif mm := re.match(r"attn\.proj\.(\w+)$", rest):
                plan[k] = "id", (f"{lb}.attention.output.dense.{mm[1]}",)
            elif mm := re.match(r"ls(\d)\.gamma$", rest):
                plan[k] = "id", (f"{lb}.layer_scale{mm[1]}.lambda1",)
            else:
                plan[k] = "id", (f"{lb}.{rest}",)
    return plan


def _dinov2_hub(keys, src_keys, module=None) -> Plan:
    """torch-hub DINOv2 (AnyDoor's conditioner): the port's own names; the
    positional grid resized to the module's (`convert_dinov2_hub`)."""
    return {k: ("pos_grid" if k == "pos_embed" else "id", (k,)) for k in keys}


_SAM_NECK = {"0": "conv1", "1": "layer_norm1", "2": "conv2", "3": "layer_norm2"}
_SAM_UPSCALE = {"0": "upscale_conv1", "1": "upscale_layer_norm", "3": "upscale_conv2"}
_SAM_HEAD = {"0": "proj_in", "1": "layers.0", "2": "proj_out"}


def _sam_hf_key(k: str) -> str:
    """An official SAM key under HF `SamModel` naming (the inverse of
    convert.py's `hf_sam_to_original`)."""
    k = re.sub(r"^image_encoder\.", "vision_encoder.", k)
    k = k.replace("patch_embed.proj.", "patch_embed.projection.")
    if m := re.match(r"vision_encoder\.blocks\.(\d+)\.(.*)$", k):
        rest = m[2].replace("norm1", "layer_norm1").replace("norm2", "layer_norm2")
        k = f"vision_encoder.layers.{m[1]}.{rest}"
    k = re.sub(r"neck\.(\d)\.", lambda m: f"neck.{_SAM_NECK[m[1]]}.", k)
    k = k.replace("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
                  "prompt_encoder.shared_embedding.positional_embedding")
    k = k.replace("prompt_encoder.point_embeddings.", "prompt_encoder.point_embed.")
    k = re.sub(r"(transformer\.layers\.\d+\.)norm(\d)", r"\1layer_norm\2", k)
    k = k.replace("transformer.norm_final_attn", "transformer.layer_norm_final_attn")
    k = re.sub(r"output_upscaling\.(\d)\.", lambda m: f"{_SAM_UPSCALE[m[1]]}.", k)
    return re.sub(r"((?:output_hypernetworks_mlps\.\d+|iou_prediction_head))\.layers\.(\d)\.",
                  lambda m: f"{m[1]}.{_SAM_HEAD[m[2]]}.", k)


def _sam(keys, src_keys, module=None) -> Plan:
    """SAM: the original segment-anything names, or the HF mirror
    (`vision_encoder.*`, facebook/sam-vit-huge)."""
    hf = any(k.startswith("vision_encoder.") for k in src_keys)
    plan = {k: ("id", (_sam_hf_key(k) if hf else k,)) for k in keys}
    pe, shared = ("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
                  "shared_image_embedding.positional_embedding")
    if hf and pe in plan and plan[pe][1][0] not in src_keys and shared in src_keys:
        # transformers ties the prompt encoder's Fourier matrix to the image
        # grid's and `save_pretrained` writes it once, under the latter name
        plan[pe] = ("id", (shared,))
    return plan


def _depth_hf_key(k: str):
    """An official Depth-Anything-V2 key under HF
    `DepthAnythingForDepthEstimation` naming (the inverse of convert.py's
    `hf_depth_to_official`; q / k / v split)."""
    b = "backbone.embeddings"
    top = {"pretrained.cls_token": f"{b}.cls_token",
           "pretrained.pos_embed": f"{b}.position_embeddings"}
    if k in top:
        return "id", (top[k],)
    if m := re.match(r"pretrained\.patch_embed\.proj\.(\w+)$", k):
        return "id", (f"{b}.patch_embeddings.projection.{m[1]}",)
    if m := re.match(r"pretrained\.norm\.(\w+)$", k):
        return "id", (f"backbone.layernorm.{m[1]}",)
    if m := re.match(r"pretrained\.blocks\.(\d+)\.(.+)$", k):
        lb, rest = f"backbone.encoder.layer.{m[1]}", m[2]
        if mm := re.match(r"attn\.qkv\.(\w+)$", rest):
            return "cat", tuple(f"{lb}.attention.attention.{n}.{mm[1]}"
                                for n in ("query", "key", "value"))
        rest = rest.replace("attn.proj", "attention.output.dense")
        rest = re.sub(r"ls(\d)\.gamma", r"layer_scale\1.lambda1", rest)
        return "id", (f"{lb}.{rest}",)
    h = "depth_head"
    if m := re.match(rf"{h}\.projects\.(\d+)\.(.+)$", k):
        return "id", (f"neck.reassemble_stage.layers.{m[1]}.projection.{m[2]}",)
    if m := re.match(rf"{h}\.resize_layers\.(\d+)\.(.+)$", k):
        return "id", (f"neck.reassemble_stage.layers.{m[1]}.resize.{m[2]}",)
    if m := re.match(rf"{h}\.scratch\.layer(\d)_rn\.(.+)$", k):
        return "id", (f"neck.convs.{int(m[1]) - 1}.{m[2]}",)
    if m := re.match(rf"{h}\.scratch\.refinenet(\d)\.(.+)$", k):
        rest = (m[2].replace("resConfUnit", "residual_layer").replace("conv1", "convolution1")
                .replace("conv2", "convolution2").replace("out_conv", "projection"))
        return "id", (f"neck.fusion_stage.layers.{4 - int(m[1])}.{rest}",)
    out = {"output_conv1": "head.conv1", "output_conv2.0": "head.conv2",
           "output_conv2.2": "head.conv3"}
    if m := re.match(rf"{h}\.scratch\.(output_conv1|output_conv2\.\d)\.(\w+)$", k):
        return "id", (f"{out[m[1]]}.{m[2]}",)
    raise KeyError(f"unmapped Depth-Anything key {k!r}")


def _depth(keys, src_keys, module=None) -> Plan:
    """Depth-Anything-V2: the official names, or the HF mirror (`backbone.*`)."""
    hf = any(k.startswith("backbone.") for k in src_keys)
    return {k: _depth_hf_key(k) if hf else ("id", (k,)) for k in keys}


_GDINO_FUSION = {"v_proj": "vision_proj", "l_proj": "text_proj",
                 "values_l_proj": "values_text_proj", "values_v_proj": "values_vision_proj",
                 "out_v_proj": "out_vision_proj", "out_l_proj": "out_text_proj",
                 "layer_norm_v": "layer_norm_vision", "layer_norm_l": "layer_norm_text",
                 "gamma_v": "vision_param", "gamma_l": "text_param"}
_GDINO_TEXT = {"norm1": "layer_norm_before", "norm2": "layer_norm_after",
               "linear1": "fc1", "linear2": "fc2", "self_attn.out_proj": "self_attn.out_proj"}
_GDINO_IMG = {"norm1": "self_attn_layer_norm", "norm2": "final_layer_norm",
              "linear1": "fc1", "linear2": "fc2"}
_GDINO_DEC = {"norm1": "encoder_attn_layer_norm", "norm2": "self_attn_layer_norm",
              "norm3": "final_layer_norm", "catext_norm": "encoder_attn_text_layer_norm",
              "linear1": "fc1", "linear2": "fc2", "self_attn.out_proj": "self_attn.out_proj",
              "ca_text.out_proj": "encoder_attn_text.out_proj"}
_GDINO_TOP = {"transformer.level_embed": "model.level_embed",
              "transformer.tgt_embed.weight": "model.query_position_embeddings.weight"}
_GDINO_PRE = [(r"feat_map\.", "model.text_projection."),
              (r"input_proj\.", "model.input_proj_vision."),
              (r"transformer\.enc_output\.", "model.enc_output."),
              (r"transformer\.enc_output_norm\.", "model.enc_output_norm."),
              (r"transformer\.enc_out_bbox_embed\.", "model.encoder_output_bbox_embed."),
              (r"transformer\.decoder\.ref_point_head\.", "model.decoder.reference_points_head."),
              (r"transformer\.decoder\.norm\.", "model.decoder.layer_norm."),
              (r"bbox_embed\.", "bbox_embed.")]


def _gdino_hf_key(k: str):
    """An official GroundingDINO key under HF `GroundingDinoForObjectDetection`
    naming (the counterpart of convert.py's `convert_gdino_hf`)."""
    if k in _GDINO_TOP:
        return "id", (_GDINO_TOP[k],)
    if k.startswith("bert."):
        return "id", ("model.text_backbone." + k[len("bert."):],)
    if k.startswith("backbone.0."):
        return _swin_hf(k[len("backbone.0."):], "model.backbone.conv_encoder.model")
    for pat, rep in _GDINO_PRE:
        if re.match(pat, k):
            return "id", (re.sub("^" + pat, rep, k),)

    def fused(base, leaf, hf):
        return "cat", tuple(f"{hf}.{n}.{leaf}" for n in ("query", "key", "value"))

    def sub(table, rest, hf):
        for ours, theirs in table.items():
            if rest.startswith(ours + "."):
                return "id", (f"{hf}.{theirs}{rest[len(ours):]}",)
        raise KeyError(f"unmapped GroundingDINO key {k!r}")

    if m := re.match(r"transformer\.encoder\.fusion_layers\.(\d+)\.(.+)$", k):
        fl, rest = f"model.encoder.layers.{m[1]}.fusion_layer", m[2]
        if rest in ("gamma_v", "gamma_l"):
            return "id", (f"{fl}.{_GDINO_FUSION[rest]}",)
        rest = rest.removeprefix("attn.")
        name, leaf = rest.rsplit(".", 1)
        pre = "" if name.startswith("layer_norm") else "attn."
        return "id", (f"{fl}.{pre}{_GDINO_FUSION[name]}.{leaf}",)
    if m := re.match(r"transformer\.encoder\.text_layers\.(\d+)\.(.+)$", k):
        tl, rest = f"model.encoder.layers.{m[1]}.text_enhancer_layer", m[2]
        if mm := re.match(r"self_attn\.in_proj_(weight|bias)$", rest):
            return fused(tl, mm[1], f"{tl}.self_attn")
        return sub(_GDINO_TEXT, rest, tl)
    if m := re.match(r"transformer\.encoder\.layers\.(\d+)\.(.+)$", k):
        dl, rest = f"model.encoder.layers.{m[1]}.deformable_layer", m[2]
        if rest.startswith("self_attn."):
            return "id", (f"{dl}.{rest}",)
        return sub(_GDINO_IMG, rest, dl)
    if m := re.match(r"transformer\.decoder\.layers\.(\d+)\.(.+)$", k):
        dl, rest = f"model.decoder.layers.{m[1]}", m[2]
        if mm := re.match(r"(self_attn|ca_text)\.in_proj_(weight|bias)$", rest):
            hf = "self_attn" if mm[1] == "self_attn" else "encoder_attn_text"
            return fused(dl, mm[2], f"{dl}.{hf}")
        if rest.startswith("cross_attn."):
            return "id", (f"{dl}.encoder_attn.{rest[len('cross_attn.'):]}",)
        return sub(_GDINO_DEC, rest, dl)
    raise KeyError(f"unmapped GroundingDINO key {k!r}")


def _gdino(keys, src_keys, module=None) -> Plan:
    """GroundingDINO: the official names (a DDP `module.` prefix cut, as
    `convert_gdino` does), or the HF mirror (`model.text_backbone.*`,
    IDEA-Research/grounding-dino-*)."""
    if any(k.startswith("model.text_backbone.") for k in src_keys):
        return {k: _gdino_hf_key(k) for k in keys}
    return _first_present("", "module.")(keys, src_keys)


_OCR_NECK = {"0": "conv1", "1": "layer_norm1", "2": "conv2", "3": "layer_norm2"}


def _ocr(keys, src_keys, module=None) -> Plan:
    """GOT-OCR2 from HF `GotOcr2ForConditionalGeneration`: the port keeps
    SAM's own names for its vision tower (`convert_got_ocr`'s `vis_leaf`
    reads HF's); the projector and the Qwen2 LM are HF's."""
    plan: Plan = {}
    vt = "model.vision_tower."
    for k in keys:
        src = k
        if k.startswith(vt):
            rest = k[len(vt):]
            rest = rest.replace("patch_embed.proj.", "patch_embed.projection.")
            rest = re.sub(r"^neck\.(\d)\.", lambda m: f"neck.{_OCR_NECK[m[1]]}.", rest)
            if m := re.match(r"blocks\.(\d+)\.(.+)$", rest):
                rest = f"layers.{m[1]}." + re.sub(r"^norm(\d)", r"layer_norm\1", m[2])
            src = vt + rest
        plan[k] = "id", (src,)
    return plan


def _eva(keys, src_keys, module=None) -> Plan:
    """BLIP-2's EVA tower (`vision_model.*`): a bias-free `qkv` with
    `q_bias` / `v_bias` makes the fused bias (q, 0, v); a fused `qkv.bias`
    (what `convert_eva_vit` reads) is read as is."""
    plan: Plan = {}
    for k in keys:
        if (m := re.match(r"(.+\.self_attn)\.qkv\.bias$", k)) and f"{m[1]}.q_bias" in src_keys:
            plan[k] = "qkv_bias", (f"{m[1]}.q_bias", f"{m[1]}.v_bias")
        else:
            plan[k] = "id", (k,)
    return plan


_LDM_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
            "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_LDM_TOP = {"conv_in": "input_blocks.0.0", "conv_out": "out.2", "conv_norm_out": "out.0",
            "time_embedding.linear_1": "time_embed.0", "time_embedding.linear_2": "time_embed.2"}


def _ldm_unet_key(k: str, ucfg, prefix: str):
    """A diffusers UNet key read from ldm `UNetModel` naming under `prefix`
    (convert.py's `_ldm_unet_key`); ldm's Linear proj_in / proj_out as the
    port's 1x1 convs."""
    lpb, n = ucfg.layers_per_block, len(ucfg.block_channels)
    for ours, theirs in _LDM_TOP.items():
        if k.startswith(ours + "."):
            return "id", (f"{prefix}{theirs}{k[len(ours):]}",)

    def res(base, rest):
        sub, leaf = rest.split(".")
        return "id", (f"{prefix}{base}.{_LDM_RES[sub]}.{leaf}",)

    def tf(base, rest):
        proj = re.match(r"proj_(in|out)\.weight$", rest) and not ucfg.use_linear_projection
        return ("conv11" if proj else "id"), (f"{prefix}{base}.{rest}",)

    if m := re.match(r"down_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.+)$", k):
        idx = 1 + int(m[1]) * (lpb + 1) + int(m[3])
        return res(f"input_blocks.{idx}.0", m[4]) if m[2] == "resnets" \
            else tf(f"input_blocks.{idx}.1", m[4])
    if m := re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(\w+)$", k):
        return "id", (f"{prefix}input_blocks.{1 + int(m[1]) * (lpb + 1) + lpb}.0.op.{m[2]}",)
    if m := re.match(r"mid_block\.resnets\.(\d+)\.(.+)$", k):
        return res(f"middle_block.{2 * int(m[1])}", m[2])
    if m := re.match(r"mid_block\.attentions\.0\.(.+)$", k):
        return tf("middle_block.1", m[1])
    if m := re.match(r"up_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.+)$", k):
        idx = int(m[1]) * (lpb + 1) + int(m[3])
        return res(f"output_blocks.{idx}.0", m[4]) if m[2] == "resnets" \
            else tf(f"output_blocks.{idx}.1", m[4])
    if m := re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(\w+)$", k):
        u = int(m[1])
        slot = 2 if ucfg.attn_levels[n - 1 - u] else 1
        return "id", (f"{prefix}output_blocks.{u * (lpb + 1) + lpb}.{slot}.conv.{m[2]}",)
    raise KeyError(f"unmapped UNet key {k!r}")


def _ldm_unet(keys, src_keys, module, prefix: str = "model.diffusion_model.") -> Plan:
    """AnyDoor's UNet (`model.diffusion_model.*`) onto the port's
    diffusers names, at the module's configuration."""
    return {k: _ldm_unet_key(k, module.cfg, prefix) for k in keys}


def _ldm_controlnet(keys, src_keys, module, prefix: str = "control_model.") -> Plan:
    """AnyDoor's cldm ControlNet onto diffusers ControlNetModel names: the
    hint encoder's convs at `input_hint_block.{0, 2, .., 12}` and `.14`,
    `zero_convs.{i}.0`, `middle_block_out.0`, the trunk as the UNet's."""
    def key(k):
        if m := re.match(r"controlnet_cond_embedding\.(conv_in|conv_out|blocks\.(\d+))\.(\w+)$", k):
            i = 0 if m[1] == "conv_in" else 14 if m[1] == "conv_out" else 2 * (int(m[2]) + 1)
            return "id", (f"{prefix}input_hint_block.{i}.{m[3]}",)
        if m := re.match(r"controlnet_down_blocks\.(\d+)\.(\w+)$", k):
            return "id", (f"{prefix}zero_convs.{m[1]}.0.{m[2]}",)
        if m := re.match(r"controlnet_mid_block\.(\w+)$", k):
            return "id", (f"{prefix}middle_block_out.0.{m[1]}",)
        return _ldm_unet_key(k, module.cfg, prefix)
    return {k: key(k) for k in keys}


_LDM_VAE_ATTN = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
                 "to_out.0": "proj_out"}


def _ldm_vae_key(k: str, n: int, prefix: str):
    """A diffusers AutoencoderKL key read from ldm naming (convert.py's
    `_ldm_vae_key`); the mid attention's 1x1 convs as Linears."""
    if re.match(r"(post_)?quant_conv\.", k):
        return "id", (prefix + k,)
    half, rest = k.split(".", 1)
    base = f"{prefix}{half}"
    if m := re.match(r"(conv_in|conv_out|conv_norm_out)\.(\w+)$", rest):
        return "id", (f"{base}.{'norm_out' if m[1] == 'conv_norm_out' else m[1]}.{m[2]}",)
    if m := re.match(r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)\.(\w+)$", rest):
        lvl = m[2] if m[1] == "down" else n - 1 - int(m[2])
        sub = "nin_shortcut" if m[4] == "conv_shortcut" else m[4]
        return "id", (f"{base}.{m[1]}.{lvl}.block.{m[3]}.{sub}.{m[5]}",)
    if m := re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(\w+)$", rest):
        return "id", (f"{base}.down.{m[1]}.downsample.conv.{m[2]}",)
    if m := re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(\w+)$", rest):
        return "id", (f"{base}.up.{n - 1 - int(m[1])}.upsample.conv.{m[2]}",)
    if m := re.match(r"mid_block\.resnets\.(\d+)\.(.+)$", rest):
        sub = m[2].replace("conv_shortcut", "nin_shortcut")
        return "id", (f"{base}.mid.block_{int(m[1]) + 1}.{sub}",)
    if m := re.match(r"mid_block\.attentions\.0\.(.+)\.(weight|bias)$", rest):
        kind = "lin11" if m[1] != "group_norm" and m[2] == "weight" else "id"
        return kind, (f"{base}.mid.attn_1.{_LDM_VAE_ATTN[m[1]]}.{m[2]}",)
    raise KeyError(f"unmapped VAE key {k!r}")


def _ldm_vae(keys, src_keys, module, prefix: str = "first_stage_model.") -> Plan:
    """AnyDoor's VAE (`first_stage_model.*`, ldm naming) onto diffusers names."""
    return {k: _ldm_vae_key(k, len(module.cfg.block_channels), prefix) for k in keys}


# ---- the slots' modules, at a ZooConfig's configurations ----------------------

def _m_unet(field: str):
    def build(c, device):
        from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
        return UNet2DCondition(getattr(c, field), device=device)
    return build


def _m_vae(c, device):
    from anyedit_tpu_torch.models.vae import AutoencoderKL
    return AutoencoderKL(c.vae, device=device)


def _m_text(field: str, with_proj: bool = False):
    def build(c, device):
        from anyedit_tpu_torch.models.clip import CLIPTextEncoder
        cfg = getattr(c, field)
        if with_proj:     # SD3's CLIP-L, as `ModelZoo.sd3_cond` builds it
            cfg = dataclasses.replace(cfg, text_proj=cfg.hidden)
        return CLIPTextEncoder(cfg, device=device)
    return build


def _m_text_proj(c, device):
    from anyedit_tpu_torch.models.clip import CLIPTextModel
    return CLIPTextModel(c.text, proj_dim=c.vision.proj_dim, device=device)


def _m_vision(field: str):
    def build(c, device):
        from anyedit_tpu_torch.models.clip import CLIPVisionEncoder
        return CLIPVisionEncoder(getattr(c, field), device=device)
    return build


def _m_t5(c, device):
    from anyedit_tpu_torch.models.t5 import T5Encoder
    return T5Encoder(c.flux_text, device=device)


def _m_llama(c, device):
    """The instruction generator's Llama-3-8B (no zoo slot; `generate`)."""
    from anyedit_tpu_torch.models.llama import LLAMA3_8B, Llama
    return Llama(LLAMA3_8B, device=device)


def _m_sam(c, device):
    from anyedit_tpu_torch.models.sam import SAM
    return SAM(c.sam, device=device)


def _m_gdino(c, device):
    from anyedit_tpu_torch.models.gdino import GroundingDINO
    return GroundingDINO(c.gdino, device=device)


def _m_lama(c, device):
    from anyedit_tpu_torch.models.lama import LamaGenerator
    return LamaGenerator(c.lama, device=device)


def _m_dinov2(c, device):
    """DINOv2-L (no zoo slot reads it; the JAX registry converts it)."""
    from anyedit_tpu_torch.models.dinov2 import DINOV2_L, DinoV2
    return DinoV2(DINOV2_L, device=device)


def _m_dinov2_g(c, device):
    from anyedit_tpu_torch.models.dinov2 import DinoV2
    return DinoV2(c.dino_cfg, device=device)


def _m_hed(c, device):
    from anyedit_tpu_torch.models.hed import HED
    return HED(device=device)


def _m_depth(c, device):
    from anyedit_tpu_torch.models.depth import DepthAnythingV2
    return DepthAnythingV2(c.depth_cfg, device=device)


def _m_aesthetic(c, device):
    from anyedit_tpu_torch.filters.scorers import AestheticMLP
    return AestheticMLP(c.vision.proj_dim, device=device)


def _m_seg(c, device):
    from anyedit_tpu_torch.models.segmentation import UperNetSegmenter
    return UperNetSegmenter(c.seg_cfg, device=device)


def _m_ocr(c, device):
    from anyedit_tpu_torch.models.ocr import GotOCR
    return GotOCR(c.ocr, device=device)


def _m_vila(c, device):
    from anyedit_tpu_torch.models.vila import VilaVQA
    return VilaVQA(c.vila, device=device)


def _m_controlnet_anydoor(c, device):
    from anyedit_tpu_torch.models.controlnet import ControlNet
    return ControlNet(c.anydoor_unet, 4, device=device)


def _m_anydoor_proj(c, device):
    return torch.nn.Linear(c.dino_cfg.dim, c.anydoor_unet.context_dim, device=device)


def _m_mmdit(c, device):
    from anyedit_tpu_torch.models.mmdit import MMDiT
    return MMDiT(c.mmdit, device=device)


def _m_flux(c, device):
    from anyedit_tpu_torch.models.flux import Flux
    return Flux(c.flux, device=device)


def _m_ip_proj(c, device):
    from anyedit_tpu_torch.models.ip_adapter import ImageProjection
    return ImageProjection(c.vision.proj_dim, 4, c.refine_unet.context_dim, device=device)


def _m_ip_adapter(c, device):
    from anyedit_tpu_torch.models.ip_adapter import IPAdapterWeights, cross_attn_sites
    names, dims = cross_attn_sites(c.refine_unet)
    return IPAdapterWeights(names, dims, c.refine_unet.context_dim, device=device)


def _m_blip2(c, device):
    from anyedit_tpu_torch.models.blip2 import Blip2VQA
    return Blip2VQA(c.qformer, image_dim=c.eva.hidden, device=device)


@dataclasses.dataclass(frozen=True)
class Entry:
    hint: str                   # where the official checkpoint comes from
    module: Callable            # module(zoo_cfg, device): the slot's module at a ZooConfig
    plan: Callable              # plan(module keys, checkpoint keys, module) -> Plan


_T5_SHARED = {"embed_tokens.weight": "shared.weight"}
_BLIP2_SHARED = {f"language_model.{s}.embed_tokens.weight": "language_model.shared.weight"
                 for s in ("encoder", "decoder")}


def _t5(keys, src_keys, module=None) -> Plan:
    """T5EncoderModel: the stack under `encoder.`, its embedding `shared.weight`."""
    return {k: ("id", (_T5_SHARED.get(k, "encoder." + k),)) for k in keys}


# output name (the zoo's slot name) -> Entry; the JAX REGISTRY's 33 names
REGISTRY: dict[str, Entry] = {
    "unet_sd": Entry("runwayml/stable-diffusion-v1-5 unet", _m_unet("sd_unet"), _same()),
    "unet_ip2p": Entry("timbrooks/instruct-pix2pix unet", _m_unet("ip2p_unet"), _same()),
    "unet_inpaint": Entry("runwayml/sd-inpainting unet", _m_unet("inpaint_unet"), _same()),
    "unet_refine": Entry("stabilityai/sdxl-base unet", _m_unet("refine_unet"), _same()),
    "vae": Entry("SD1.5 vae", _m_vae, _same()),
    "clip_text": Entry("openai/clip-vit-large-patch14 text", _m_text("text"), _same()),
    "clip_text_sd3": Entry("SD3 CLIP-L text w/ projection (text_encoder/)",
                           _m_text("text", with_proj=True), _same()),
    "clip_text_g": Entry("laion CLIP-bigG text (SDXL tower 2)", _m_text("text_g"), _same()),
    "t5": Entry("T5-XXL v1.1 encoder (Flux/SD3)", _m_t5, _t5),
    "llama": Entry("Llama-3-8B-Instruct", _m_llama, _same()),
    "clip_text_proj": Entry("CLIPTextModelWithProjection", _m_text_proj, _same()),
    "clip_vision": Entry("CLIPVisionModelWithProjection", _m_vision("vision"), _same()),
    "sam": Entry("sam_vit_h_4b8939.pth", _m_sam, _sam),
    "gdino": Entry("groundingdino_swinb_cogcoor.pth", _m_gdino, _gdino),
    "lama": Entry("big-lama best.ckpt (generator.*)", _m_lama,
                  _first_present("generator.", "")),
    "dinov2": Entry("facebook/dinov2-large (HF)", _m_dinov2, _dinov2_hf),
    "hed": Entry("lllyasviel ControlNetHED.pth", _m_hed, _same()),
    "depth": Entry("depth_anything_v2_vitl.pth", _m_depth, _depth),
    "aesthetic": Entry("sac+logos+ava1-l14-linearMSE.pth", _m_aesthetic, _same()),
    "seg": Entry("openmmlab/upernet-swin-tiny (HF, ADE20K)", _m_seg, _seg),
    "ocr": Entry("stepfun-ai/GOT-OCR-2.0-hf (full model)", _m_ocr, _ocr),
    "vila": Entry("llava-hf/llava-1.5-7b-hf (full model)", _m_vila, _same()),
    # AnyDoor: the four pieces of the one ControlLDM checkpoint
    # (epoch=1-step=8687.ckpt) + the hub DINOv2 ViT-g conditioner
    "unet_anydoor": Entry("anydoor ckpt (model.diffusion_model.*)", _m_unet("anydoor_unet"),
                          _ldm_unet),
    "controlnet_anydoor": Entry("anydoor ckpt (control_model.*)", _m_controlnet_anydoor,
                                _ldm_controlnet),
    "anydoor_proj": Entry("anydoor ckpt (cond_stage_model.projector.*)", _m_anydoor_proj,
                          _same("cond_stage_model.projector.")),
    "vae_anydoor": Entry("anydoor ckpt (first_stage_model.*)", _m_vae,
                         _ldm_vae),
    "dinov2_g": Entry("dinov2_vitg14_pretrain.pth (torch hub)", _m_dinov2_g, _dinov2_hub),
    "mmdit_ultraedit": Entry("BleachNick/SD3-UltraEdit-w-mask transformer", _m_mmdit, _same()),
    "flux": Entry("black-forest-labs/FLUX.1-schnell transformer", _m_flux, _same()),
    "ip_proj": Entry("h94/IP-Adapter sdxl .bin (image_proj group)", _m_ip_proj,
                     _same("image_proj.")),
    "ip_adapter": Entry("h94/IP-Adapter sdxl .bin (ip_adapter group)", _m_ip_adapter,
                        _same("ip_adapter.")),
    "eva_vit": Entry("Salesforce/blip2-flan-t5-xl (vision_model.*)", _m_vision("eva"), _eva),
    "blip2": Entry("Salesforce/blip2-flan-t5-xl (qformer + language_model)", _m_blip2,
                   _same(shared=_BLIP2_SHARED)),
}


def plan_for(name: str, module: torch.nn.Module, src_keys) -> Plan:
    """The registry entry's plan for `module`'s keys against a checkpoint's."""
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name].plan(list(module.state_dict()), set(src_keys), module)


def convert_state(name: str, src: Mapping[str, torch.Tensor],
                  module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """`src` mapped onto `module`'s state dict by the entry's plan, checked
    with `load_state_dict(strict=True)` (shapes included)."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = apply_plan(plan_for(name, module, src.keys()), src, shapes)
    module.load_state_dict(sd, strict=True, assign=True)    # names and shapes
    return sd


def convert_checkpoint(name: str, src_path: str | Path, out_path: str | Path) -> None:
    """Read an official checkpoint, map it onto the slot's module at the
    zoo's full configuration (built on the meta device) and write
    `out_path` (safetensors)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    src = load_checkpoint(src_path)
    from anyedit_tpu_torch.runtime.zoo import ZooConfig
    sd = convert_state(name, src, REGISTRY[name].module(ZooConfig(), "meta"))
    write_safetensors(out_path, sd)
