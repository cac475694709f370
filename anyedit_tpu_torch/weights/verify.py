"""`convert --verify`: conversion-time parity against the torch checkpoint
being converted (counterpart of `anyedit_tpu/weights/verify.py`).

`weights/bootstrap.py` checks that every key of the slot's module is read
from the checkpoint with the right shape; what that cannot catch is a
mis-mapping between tensors of one shape (a q / k swap). Given an HF model
directory as the source, this module builds the actual transformers module
from it (`from_pretrained`), derives the port's config from the
checkpoint's own `config.json`, maps the checkpoint's tensors onto the
port module with the slot's own plan (`bootstrap.convert_state`, what
`convert_checkpoint` applies), runs both in fp32 on the CPU on a fixed
input and returns the max abs deviation; `verify_conversion` raises above
the family's tolerance, so `convert --verify` writes nothing then.

The families are those of the JAX `VERIFIERS`, the transformers-backed
towers (the diffusers families have no runtime here). `transformers` is
needed, and the GPU machine has none: there `--verify` raises naming it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from anyedit_tpu_torch.weights.bootstrap import convert_state
from anyedit_tpu_torch.weights.files import load_checkpoint

F32 = torch.float32


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError("convert --verify needs the `transformers` package (it runs the "
                          "source's HF module), which this environment lacks; convert "
                          "without --verify, or verify where transformers is "
                          "installed") from e
    return transformers


def _require_dir(src: str | Path, name: str) -> Path:
    p = Path(src)
    if not p.is_dir() or not (p / "config.json").exists():
        raise ValueError(
            f"--verify for {name!r} needs an HF model directory (with config.json) as "
            f"--src so the torch reference can run; got {p}")
    return p


def _ported(name: str, module: torch.nn.Module, d: Path) -> torch.nn.Module:
    """`module` (on the CPU) loaded from the checkpoint files in `d` by the
    slot's plan."""
    convert_state(name, load_checkpoint(d), module)
    return module.eval()


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _verify_clip_text(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    d = _require_dir(src, name)
    hc = tf.AutoConfig.from_pretrained(d)
    if hc.model_type == "clip":        # a full CLIP config: its text part
        hc = hc.text_config
    # SDXL's second tower and SD3's ship as CLIPTextModelWithProjection:
    # the projected pooled output is checked too
    with_proj = "WithProjection" in (getattr(hc, "architectures", None) or [""])[0]
    cls = tf.CLIPTextModelWithProjection if with_proj else tf.CLIPTextModel
    hf = cls.from_pretrained(d).eval()
    hc = hf.config
    cfg = CLIPTextConfig(vocab_size=hc.vocab_size, hidden=hc.hidden_size,
                         layers=hc.num_hidden_layers, heads=hc.num_attention_heads,
                         max_len=hc.max_position_embeddings, activation=hc.hidden_act,
                         dtype=F32, text_proj=hc.projection_dim if with_proj else 0)
    ours = _ported(name, CLIPTextEncoder(cfg), d)
    ids = torch.tensor([[min(9, cfg.vocab_size - 1), 1, 2, cfg.vocab_size - 1]])
    with torch.no_grad():
        hidden, pooled, penult = ours(ids)
        out = hf(ids, output_hidden_states=True)
    err = max(_err(hidden, out.last_hidden_state), _err(penult, out.hidden_states[-2]))
    if with_proj:
        err = max(err, _err(pooled, out.text_embeds))
    return err


def _verify_clip_vision(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionEncoder
    d = _require_dir(src, name)
    hf = tf.CLIPVisionModelWithProjection.from_pretrained(d).eval()
    hc = hf.config
    cfg = CLIPVisionConfig(image_size=hc.image_size, patch=hc.patch_size,
                           hidden=hc.hidden_size, layers=hc.num_hidden_layers,
                           heads=hc.num_attention_heads, proj_dim=hc.projection_dim,
                           mlp_dim=hc.intermediate_size, activation=hc.hidden_act, dtype=F32)
    ours = _ported(name, CLIPVisionEncoder(cfg), d)
    px = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, hc.image_size, hc.image_size, 3)).astype(np.float32))
    with torch.no_grad():
        _, z = ours(px)
        want = hf(px.permute(0, 3, 1, 2)).image_embeds
    return _err(z, want / torch.linalg.vector_norm(want, dim=-1, keepdim=True))


def _verify_t5(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.t5 import T5Config, T5Encoder
    d = _require_dir(src, name)
    hf = tf.T5EncoderModel.from_pretrained(d).eval()
    hc = hf.config
    cfg = T5Config(vocab_size=hc.vocab_size, dim=hc.d_model, kv_dim=hc.d_kv,
                   heads=hc.num_heads, ffn_dim=hc.d_ff, enc_layers=hc.num_layers,
                   dec_layers=0, rel_buckets=hc.relative_attention_num_buckets,
                   rel_max_dist=hc.relative_attention_max_distance, dtype=F32)
    ours = _ported(name, T5Encoder(cfg), d)
    ids = torch.tensor([[5, 9, 1, 12, 3]])
    with torch.no_grad():
        return _err(ours(ids), hf(ids).last_hidden_state)


def _verify_dinov2(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.dinov2 import DinoV2, DinoV2Config
    d = _require_dir(src, name)
    hf = tf.Dinov2Model.from_pretrained(d).eval()
    hc = hf.config
    cfg = DinoV2Config(img_size=hc.image_size, patch=hc.patch_size, dim=hc.hidden_size,
                       depth=hc.num_hidden_layers, heads=hc.num_attention_heads,
                       layerscale_init=hc.layerscale_value, dtype=F32)
    ours = _ported(name, DinoV2(cfg), d)
    px = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, hc.image_size, hc.image_size, 3)).astype(np.float32))
    with torch.no_grad():
        out = ours(px)
        want = hf(px.permute(0, 3, 1, 2)).last_hidden_state
    return max(_err(out["cls"], want[:, 0]), _err(out["patch"], want[:, 1:]))


def _verify_sam(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.sam import SAM, SAMConfig
    d = _require_dir(src, name)
    hf = tf.SamModel.from_pretrained(d).eval()
    vc, mc = hf.config.vision_config, hf.config.mask_decoder_config
    cfg = SAMConfig(img_size=vc.image_size, patch=vc.patch_size, enc_dim=vc.hidden_size,
                    enc_depth=vc.num_hidden_layers, enc_heads=vc.num_attention_heads,
                    window=vc.window_size, global_attn_idx=tuple(vc.global_attn_indexes),
                    out_dim=vc.output_channels, dec_depth=mc.num_hidden_layers,
                    dec_heads=mc.num_attention_heads, dtype=F32)
    ours = _ported(name, SAM(cfg), d)
    s = vc.image_size
    px = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, s, s, 3)).astype(np.float32))
    boxes = torch.tensor([[[s * .1, s * .2, s * .7, s * .8]]])
    with torch.no_grad():
        masks, iou = ours(px, boxes)
        out = hf(pixel_values=px.permute(0, 3, 1, 2), input_boxes=boxes.double())
    return max(_err(masks[:, 1:4], out.pred_masks[0]), _err(iou[:, 1:4], out.iou_scores[0]))


def _verify_depth(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.depth import DepthAnythingV2, DPTConfig
    from anyedit_tpu_torch.models.dinov2 import DinoV2Config
    d = _require_dir(src, name)
    hf = tf.DepthAnythingForDepthEstimation.from_pretrained(d).eval()
    hc = hf.config
    bb = hc.backbone_config
    n = bb.num_hidden_layers
    take = tuple(i - 1 for i in (bb.out_indices if bb.out_indices else range(1, n + 1)))
    cfg = DPTConfig(
        backbone=DinoV2Config(img_size=bb.image_size, patch=bb.patch_size, dim=bb.hidden_size,
                              depth=n, heads=bb.num_attention_heads, dtype=F32),
        take_layers=take, out_channels=tuple(hc.neck_hidden_sizes),
        feat_dim=hc.fusion_hidden_size, dtype=F32)
    ours = _ported(name, DepthAnythingV2(cfg), d)
    px = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, bb.image_size, bb.image_size, 3)).astype(np.float32))
    with torch.no_grad():
        return _err(ours(px), hf(pixel_values=px.permute(0, 3, 1, 2)).predicted_depth)


def _verify_gdino(src: str, name: str) -> float:
    tf = _transformers()
    from anyedit_tpu_torch.models.bert import BertConfig
    from anyedit_tpu_torch.models.gdino import GDINOConfig, GroundingDINO
    from anyedit_tpu_torch.models.swin import SwinConfig
    d = _require_dir(src, name)
    hf = tf.GroundingDinoForObjectDetection.from_pretrained(d).eval()
    hc = hf.config
    sw, bt = hc.backbone_config, hc.text_config
    n_stages = len(sw.depths)
    cfg = GDINOConfig(
        swin=SwinConfig(embed_dim=sw.embed_dim, depths=tuple(sw.depths),
                        heads=tuple(sw.num_heads), window=sw.window_size, patch=sw.patch_size,
                        out_indices=tuple(range(n_stages))[-3:] if n_stages >= 3
                        else tuple(range(n_stages)), dtype=F32),
        bert=BertConfig(vocab_size=bt.vocab_size, hidden=bt.hidden_size,
                        layers=bt.num_hidden_layers, heads=bt.num_attention_heads,
                        max_len=bt.max_position_embeddings, type_vocab=bt.type_vocab_size,
                        dtype=F32),
        hidden=hc.d_model, heads=hc.encoder_attention_heads, enc_layers=hc.encoder_layers,
        dec_layers=hc.decoder_layers, num_queries=hc.num_queries,
        num_levels=hc.num_feature_levels, num_points=hc.encoder_n_points,
        max_text_len=hc.max_text_len, ffn_dim=hc.encoder_ffn_dim, dtype=F32)
    ours = _ported(name, GroundingDINO(cfg), d)
    size = 16 * sw.patch_size                  # small but stride-aligned
    px = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, size, size, 3)).astype(np.float32))
    ids = torch.tensor([[101, 5, 7, 1012, 102]])
    with torch.no_grad():
        logits, boxes = ours(px, ids, torch.ones_like(ids, dtype=torch.bool))
        out = hf(pixel_values=px.permute(0, 3, 1, 2), input_ids=ids,
                 attention_mask=torch.ones_like(ids))
    return max(_err(boxes, out.pred_boxes), _err(logits, out.logits[..., :ids.shape[1]]))


VERIFIERS: dict[str, Callable[..., float]] = {
    "clip_text": _verify_clip_text,
    "clip_text_sd3": _verify_clip_text,
    "clip_text_g": _verify_clip_text,
    "clip_vision": _verify_clip_vision,
    "t5": _verify_t5,
    "dinov2": _verify_dinov2,
    "sam": _verify_sam,
    "depth": _verify_depth,
    "gdino": _verify_gdino,
}

# atol per family at fp32 (the JAX module's)
TOLERANCE: dict[str, float] = {
    "sam": 5e-3, "depth": 5e-3, "gdino": 5e-3,
}
DEFAULT_TOL = 1e-3


def verify_conversion(name: str, src: str | Path) -> float:
    """Run the source's HF module against the port module converted from
    the same files. Returns the max abs deviation; raises if the family is
    unsupported or parity fails."""
    if name not in VERIFIERS:
        raise ValueError(
            f"--verify is not supported for {name!r} (no torch runtime for this family); "
            f"supported: {sorted(VERIFIERS)}. Conversion itself still checks every tensor "
            "is read with a matching shape.")
    err = VERIFIERS[name](str(src), name)
    tol = TOLERANCE.get(name, DEFAULT_TOL)
    if not np.isfinite(err) or err > tol:
        raise AssertionError(
            f"conversion parity FAILED for {name!r}: max abs err {err:.3e} > tol {tol:.0e}; "
            "refusing to write the .safetensors")
    return err
