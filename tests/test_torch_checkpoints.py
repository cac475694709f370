"""Checkpoint IO (`weights/files.py`) and the checkpoint registry
(`weights/bootstrap.py`) of the PyTorch port against the JAX package.

- The hand-written safetensors reader and writer against the
  `safetensors` package, for every dtype the port reads: exact, bf16
  included. Shard indexes, shard directories and torch `.bin` files
  (with a `state_dict` wrapper and IP-Adapter's nested groups).
- The registry, one case per JAX `REGISTRY` name (plus the HF-mirror
  layouts of SAM, Depth-Anything and GroundingDINO and BLIP-2's split
  EVA q / v biases), at tiny configurations: a seeded Flax tree, bridged
  into the port's state dict, written in the checkpoint's layout with the
  plan's inverse (`official_state`); the JAX converter turns that source
  into a Flax tree and the port's bridge carries it back; that equals the
  port plan's map of the same source, tensor for tensor, exactly. One
  exception: DINOv2-G's positional grid, resized bicubic by
  `jax.image.resize` and by the port's `resize_image` (float32, the two
  sum in different orders), within 1e-6 of its max-abs.
- The zoo's weights directory: `<slot>.safetensors` loads by name,
  `require_weights` raises for a missing slot and never seeds, the LCM
  student file, and a slot given both as a tree and as a file.
"""

import dataclasses
import json
import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu import cli as jcli
from anyedit_tpu.weights import bootstrap as jboot
from anyedit_tpu.weights import convert as C
from anyedit_tpu_torch.runtime import zoo as pzoo
from anyedit_tpu_torch.weights import bootstrap as B
from anyedit_tpu_torch.weights import bridge, files

torch.set_num_threads(1)
JZ = jcli.tiny_zoo_config()
PZ = pzoo.tiny_zoo_config()


# ---- files.py ----------------------------------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int32,
          torch.int64, torch.uint8, torch.bool]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn((3, 5 + i), generator=g) * 100
        out[f"t.{i}"] = x > 0 if dt == torch.bool else x.to(dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros((0, 4))
    return out


def _same(a: dict, b: dict):
    assert list(a) == list(b) or set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and tuple(a[k].shape) == tuple(b[k].shape), k
        assert torch.equal(a[k], b[k]), k


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    """Ours -> the package's reader, and the package's writer -> ours,
    every dtype, bit for bit."""
    from safetensors.torch import load_file, save_file
    ts = _tensors()
    files.write_safetensors(tmp_path / "ours.safetensors", ts)
    _same(load_file(str(tmp_path / "ours.safetensors")), ts)
    save_file(ts, str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
    _same(files.read_safetensors(tmp_path / "theirs.safetensors"), ts)
    bf = files.read_safetensors(tmp_path / "ours.safetensors")["t.2"]
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, ts["t.2"])


def test_shard_index_directory_and_torch_bins(tmp_path):
    """An HF `*.index.json`, a directory of shards (index or none), a
    `.bin` with a `state_dict` wrapper, and IP-Adapter's nested groups."""
    ts = _tensors(1)
    names = list(ts)
    a, b = dict((k, ts[k]) for k in names[:4]), dict((k, ts[k]) for k in names[4:])
    d = tmp_path / "sharded"
    files.write_safetensors(d / "model-00001-of-00002.safetensors", a)
    files.write_safetensors(d / "model-00002-of-00002.safetensors", b)
    _same(files.load_checkpoint(d), ts)
    (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {
        **{k: "model-00001-of-00002.safetensors" for k in a},
        **{k: "model-00002-of-00002.safetensors" for k in b}}}))
    _same(files.load_checkpoint(d / "model.safetensors.index.json"), ts)
    _same(files.load_checkpoint(d), ts)
    torch.save({"state_dict": a}, tmp_path / "w.ckpt")
    _same(files.load_checkpoint(tmp_path / "w.ckpt"), a)
    torch.save({"image_proj": {"proj.weight": ts["t.0"]}, "ip_adapter": {"1.to_k_ip.weight":
                                                                        ts["t.1"]}},
               tmp_path / "ip.bin")
    got = files.load_checkpoint(tmp_path / "ip.bin")
    assert set(got) == {"image_proj.proj.weight", "ip_adapter.1.to_k_ip.weight"}
    with pytest.raises(FileNotFoundError):
        files.load_checkpoint(tmp_path / "nothing_here")


# ---- the registry ------------------------------------------------------------

def rand_tree(module, args, seed, **kw):
    """Seeded float32 leaves for `module`'s parameter tree (norm scales
    near 1, the rest N(0, 1) scaled by 1/sqrt(fan-in) for kernels)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        n = rng.standard_normal(leaf.shape)
        name = path[-1].key
        if name == "kernel":
            n = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _z(*shape, dt=jnp.float32):
    return jnp.zeros(shape, dt)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=jnp.float32)


def _unet_case(field, sdxl=False):
    from anyedit_tpu.models.unet_sd import UNet2DCondition
    jc, pc = getattr(JZ, field), getattr(PZ, field)
    n = len(pc.block_channels)
    kw = dict(pooled_text=_z(1, jc.addition_embed_dim),
              time_ids=_z(1, jc.addition_time_dim)) if sdxl else {}
    tree = rand_tree(UNet2DCondition(jc), (_z(1, 8, 8, jc.in_channels), _z(1, dt=jnp.int32),
                                           _z(1, 77, jc.context_dim)), 1, **kw)
    conv = C.convert_unet_sdxl if sdxl else C.convert_unet_sd
    return dict(tree=tree, jax=lambda t, s: conv(t, s, n_levels=n),
                to_sd=lambda t: bridge.unet_state_dict(t, n, pc.use_linear_projection))


def _vae_case(ldm=False):
    from anyedit_tpu.models.vae import AutoencoderKL
    n = len(PZ.vae.block_channels)
    tree = rand_tree(AutoencoderKL(JZ.vae), (_z(1, 16, 16, 3),), 2)
    return dict(tree=tree, jax=(lambda t, s: C.convert_vae_ldm(t, s)) if ldm
                else (lambda t, s: C.convert_vae(t, s, n_levels=n)),
                to_sd=lambda t: bridge.vae_state_dict(t, n))


def _text_case(field, with_proj=False):
    from anyedit_tpu.models.clip import CLIPTextEncoder
    jc = getattr(JZ, field)
    if with_proj:
        jc = dataclasses.replace(jc, text_proj=jc.hidden)
    tree = rand_tree(CLIPTextEncoder(jc), (_z(1, 77, dt=jnp.int32),), 3)
    return dict(tree=tree, jax=C.convert_clip_text, to_sd=bridge.clip_text_state_dict)


def _text_proj_case():
    from anyedit_tpu.models.clip import CLIPTextModel
    tree = rand_tree(CLIPTextModel(JZ.text, proj_dim=JZ.vision.proj_dim),
                     (_z(1, 77, dt=jnp.int32),), 4)

    def key_fn(path):       # the JAX bootstrap's `_clip_text_proj` key_fn
        p = [q for q in path if q != "params"]
        if p[0] == "encoder":
            return C._clip_text_key(tuple(p[1:]))
        return "text_projection.weight", C.t_linear
    return dict(tree=tree, jax=lambda t, s: C._convert(t, key_fn, s),
                to_sd=bridge.clip_text_proj_state_dict)


def _vision_case(jc, seed, to_sd, conv):
    from anyedit_tpu.models.clip import CLIPVisionEncoder
    tree = rand_tree(CLIPVisionEncoder(jc), (_z(1, jc.image_size, jc.image_size, 3),), seed)
    return dict(tree=tree, jax=conv, to_sd=to_sd)


# BLIP-2's EVA layout (no pre-LN, no projection, a patch bias), tiny
JAX_EVA = dataclasses.replace(JZ.vision, pre_ln=False, use_proj=False, patch_bias=True,
                              activation="gelu")
PORT_EVA = dataclasses.replace(PZ.vision, pre_ln=False, use_proj=False, patch_bias=True,
                               activation="gelu")


def _eva_case(split_bias):
    case = _vision_case(JAX_EVA, 5, bridge.eva_vit_state_dict, C.convert_eva_vit)
    for name, blk in case["tree"].items():     # HF stores no k bias: the fused (q, 0, v)
        if name.startswith("block_"):
            blk["attn"]["to_k"]["bias"] = np.zeros_like(blk["attn"]["to_k"]["bias"])
    if split_bias:
        case["hint"] = {"vision_model.encoder.layers.0.self_attn.q_bias"}
        # JAX reads the fused bias only: hand it (q, 0, v)
        case["jax_src"] = _fuse_eva_bias
    case["cfg"] = dataclasses.replace(PZ, eva=PORT_EVA)
    return case


def _fuse_eva_bias(src):
    out = dict(src)
    for k in list(out):
        if k.endswith(".q_bias"):
            base = k[:-len(".q_bias")]
            q, v = out.pop(k), out.pop(base + ".v_bias")
            out[base + ".qkv.bias"] = np.concatenate([q, np.zeros_like(q), v])
    return out


def _t5_case():
    from anyedit_tpu.models.t5 import T5Encoder
    tree = rand_tree(T5Encoder(_f32(JZ.flux_text)), (_z(1, 77, dt=jnp.int32),), 6)
    return dict(tree=tree, jax=C.convert_t5_encoder,
                to_sd=lambda t: bridge.t5_state_dict(t))


def _llama_case():
    from anyedit_tpu.models.llama import TINY_LLAMA, Llama
    from anyedit_tpu_torch.models.llama import TINY_LLAMA as P_LLAMA
    from anyedit_tpu_torch.models.llama import Llama as PLlama
    tree = rand_tree(Llama(TINY_LLAMA), (_z(1, 8, dt=jnp.int32),), 7)
    return dict(tree=tree, jax=C.convert_llama, to_sd=bridge.llama_state_dict,
                module=lambda: PLlama(dataclasses.replace(P_LLAMA, dtype=torch.float32)))


def _sam_case(hf):
    from anyedit_tpu.models.sam import SAM

    def conv(t, src):       # the JAX bootstrap's `_sam` on a tiny tree
        src = dict(src)
        if any(k.startswith("vision_encoder.") for k in src):
            src = C.hf_sam_to_original(src)
        src["prompt_encoder.box_corner_embeddings"] = np.stack(
            [src["prompt_encoder.point_embeddings.2.weight"][0],
             src["prompt_encoder.point_embeddings.3.weight"][0]])
        return C.convert_sam(t, src)
    s = JZ.sam.img_size
    tree = rand_tree(SAM(_f32(JZ.sam)), (_z(1, s, s, 3), _z(1, 1, 4)), 8)
    return dict(tree=tree, jax=conv, to_sd=bridge.sam_state_dict,
                hint={"vision_encoder.x"} if hf else set())


def _gdino_merge(key):
    """convert.py's `_swin_key` reads stage I's merge from
    `layers.{I-1}.downsample` (ROADMAP queue 3); the official is `layers.I`."""
    m = re.match(r"(backbone\.0\.layers\.)(\d+)(\.downsample\..*)$", key)
    return f"{m[1]}{int(m[2]) - 1}{m[3]}" if m else key


# the JAX tiny config's BERT table has 128 rows (the port's 30522: ROADMAP queue 3)
GDINO_CFG = dataclasses.replace(PZ, gdino=dataclasses.replace(
    PZ.gdino, bert=dataclasses.replace(PZ.gdino.bert, vocab_size=JZ.gdino.bert.vocab_size)))


def _gdino_case(hf):
    from anyedit_tpu.models.gdino import GroundingDINO
    jc = JZ.gdino
    tree = rand_tree(GroundingDINO(jc), (_z(1, 64, 64, 3), _z(1, jc.max_text_len, dt=jnp.int32),
                                         jnp.ones((1, jc.max_text_len), bool)), 9)
    if hf:
        return dict(tree=tree, jax=C.convert_gdino_hf, to_sd=bridge.gdino_state_dict,
                    hint={"model.text_backbone.x"}, cfg=GDINO_CFG)
    return dict(tree=tree, to_sd=bridge.gdino_state_dict, cfg=GDINO_CFG,
                jax=lambda t, s: C.convert_gdino(
                    t, {_gdino_merge(k.removeprefix("module.")): v for k, v in s.items()}),
                prefix="module.")


def _lama_case():
    from anyedit_tpu.models.lama import LamaGenerator
    jc = JZ.lama
    tree = rand_tree(LamaGenerator(jc), (_z(1, 64, 64, 3), _z(1, 64, 64, 1)), 10)
    return dict(tree=tree, prefix="generator.",
                jax=lambda t, s: C.convert_lama(t, s, n_down=jc.n_downsample,
                                                n_blocks=jc.n_blocks),
                to_sd=lambda t: bridge.lama_state_dict(t, PZ.lama.ratio_g))


def _dino_case(hub):
    from anyedit_tpu.models import dinov2 as jd
    from anyedit_tpu_torch.models import dinov2 as td
    if hub:
        jc = dataclasses.replace(jd.DINOV2_G, img_size=56, depth=2, dim=64, heads=2)
        pc = dataclasses.replace(td.DINOV2_G, img_size=56, depth=2, dim=64, heads=2,
                                 dtype=torch.float32)
    else:
        jc, pc = jd.TINY_DINO, dataclasses.replace(td.TINY_DINO, dtype=torch.float32)
    tree = rand_tree(jd.DinoV2(jc), (_z(1, jc.img_size, jc.img_size, 3),), 11)
    return dict(tree=tree, jax=C.convert_dinov2_hub if hub else C.convert_dinov2,
                to_sd=bridge.dinov2_state_dict, module=lambda: td.DinoV2(pc),
                hint={"embeddings.cls_token"} if not hub else set())


def _hed_case():
    from anyedit_tpu.models.hed import HED
    tree = rand_tree(HED(), (_z(1, 32, 32, 3),), 12)
    return dict(tree=tree, jax=C.convert_hed, to_sd=bridge.hed_state_dict)


def _depth_case(hf):
    from anyedit_tpu.models.depth import DepthAnythingV2
    jc = JZ.depth_cfg
    s = jc.backbone.img_size

    def conv(t, src):
        if any(k.startswith("backbone.") for k in src):
            src = C.hf_depth_to_official(src, jc.backbone.depth)
        return C.convert_depth_anything(t, src)
    tree = rand_tree(DepthAnythingV2(jc), (_z(1, s, s, 3),), 13)
    return dict(tree=tree, jax=conv, to_sd=bridge.depth_state_dict,
                hint={"backbone.x"} if hf else set())


def _aesthetic_case():
    from anyedit_tpu.filters.scorers import AestheticMLP
    tree = rand_tree(AestheticMLP(), (_z(1, PZ.vision.proj_dim),), 14)
    return dict(tree=tree, jax=C.convert_aesthetic, to_sd=bridge.aesthetic_state_dict)


def _seg_case():
    from anyedit_tpu.models.segmentation import UperNetSegmenter
    tree = rand_tree(UperNetSegmenter(JZ.seg_cfg), (_z(1, 64, 64, 3),), 15)
    return dict(tree=tree, jax=C.convert_upernet_swin, to_sd=bridge.seg_state_dict,
                source=_seg_source)


def _seg_source(plan, sd):
    """The HF layout: the backbone through the plan's inverse; each folded
    head conv as a bias-free conv with a BatchNorm of seeded statistics."""
    rng = np.random.default_rng(16)
    src = B.official_state({k: v for k, v in plan.items() if v[0] not in ("bn_w", "bn_b")}, sd)
    for k, (kind, names) in plan.items():
        shape = sd[k].shape
        if kind == "bn_w":
            src[names[0]] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        elif kind == "bn_b":
            c = shape[0]
            g, b, m = (rng.standard_normal(c).astype(np.float32) for _ in range(3))
            v = rng.uniform(0.5, 2.0, c).astype(np.float32)
            for n, x in zip(names, (1 + 0.1 * g, b, m, v)):
                src[n] = torch.from_numpy(np.ascontiguousarray(x))
    return src


def _ocr_case():
    from anyedit_tpu.models.ocr import GotOCR
    jc = JZ.ocr
    s = jc.vision.img_size
    tree = rand_tree(GotOCR(jc), (_z(1, s, s, 3), _z(1, 8, dt=jnp.int32)), 17)
    return dict(tree=tree, jax=C.convert_got_ocr, to_sd=bridge.ocr_state_dict)


def _vila_case():
    from anyedit_tpu.models.vila import VilaVQA
    jc = JZ.vila
    s = jc.vision.image_size
    tree = rand_tree(VilaVQA(jc), (_z(1, s, s, 3), _z(1, 8, dt=jnp.int32)), 18)
    return dict(tree=tree, jax=C.convert_vila, to_sd=bridge.vila_state_dict)


def _anydoor_unet_case():
    from anyedit_tpu.models.unet_sd import UNet2DCondition
    jc, pc = JZ.anydoor_unet, PZ.anydoor_unet
    n = len(pc.block_channels)
    tree = rand_tree(UNet2DCondition(jc), (_z(1, 8, 8, jc.in_channels), _z(1, dt=jnp.int32),
                                           _z(1, 5, jc.context_dim)), 19)
    return dict(tree=tree, to_sd=lambda t: bridge.unet_state_dict(t, n, False),
                jax=lambda t, s: C.convert_ldm_unet(t, s, n_levels=n, lpb=pc.layers_per_block,
                                                    attn_levels=pc.attn_levels))


def _anydoor_controlnet_case():
    from anyedit_tpu.models.controlnet import ControlNet
    jc, pc = JZ.anydoor_unet, PZ.anydoor_unet
    n = len(pc.block_channels)
    tree = rand_tree(ControlNet(jc), (_z(1, 8, 8, jc.in_channels), _z(1, dt=jnp.int32),
                                      _z(1, 5, jc.context_dim), _z(1, 64, 64, 4)), 20)
    return dict(tree=tree, to_sd=lambda t: bridge.controlnet_state_dict(t, n, False),
                jax=lambda t, s: C.convert_controlnet_anydoor(
                    t, s, n_levels=n, lpb=pc.layers_per_block, attn_levels=pc.attn_levels))


class _Proj(nn.Module):
    dim: int

    @nn.compact
    def __call__(self, e):
        return nn.Dense(self.dim, dtype=jnp.float32)(e)


def _anydoor_proj_case():
    tree = rand_tree(_Proj(PZ.anydoor_unet.context_dim), (_z(1, 5, PZ.dino_cfg.dim),), 21)
    return dict(tree=tree, jax=C.convert_anydoor_projector, to_sd=bridge.linear_state_dict)


def _mmdit_case():
    from anyedit_tpu.models.mmdit import MMDiT
    jc = JZ.mmdit
    tree = rand_tree(MMDiT(jc), (_z(1, 8, 8, jc.in_channels), _z(1), _z(1, 5, jc.context_dim),
                                 _z(1, jc.pooled_dim)), 22)
    return dict(tree=tree, jax=C.convert_mmdit,
                to_sd=lambda t: bridge.mmdit_state_dict(t, PZ.mmdit.patch))


def _flux_case():
    from anyedit_tpu.models.flux import Flux
    jc = JZ.flux
    tree = rand_tree(Flux(jc), (_z(1, 8, 8, jc.in_channels), _z(1), _z(1, 5, jc.context_dim),
                                _z(1, jc.pooled_dim)), 23)
    return dict(tree=tree, jax=C.convert_flux, to_sd=bridge.flux_state_dict)


def _ip_proj_case():
    from anyedit_tpu.models.ip_adapter import ImageProjection
    ctx = JZ.refine_unet.context_dim
    tree = rand_tree(ImageProjection(num_tokens=4, context_dim=ctx), (_z(1, JZ.vision.proj_dim),),
                     24)
    return dict(tree=tree, jax=C.convert_image_projection, to_sd=bridge.ip_proj_state_dict)


def _ip_adapter_case():
    from anyedit_tpu.models.ip_adapter import IPAdapterWeights
    from anyedit_tpu.models.ip_adapter import cross_attn_sites as jsites
    from anyedit_tpu_torch.models.ip_adapter import cross_attn_sites as psites
    ctx = JZ.refine_unet.context_dim
    jnames, jdims = jsites(JZ.refine_unet)
    pnames, _ = psites(PZ.refine_unet)
    tree = rand_tree(IPAdapterWeights(jnames, jdims, ctx), (_z(1, 4, ctx),), 25)
    return dict(tree=tree, jax=lambda t, s: C.convert_ip_adapter_weights(t, s, jnames),
                to_sd=lambda t: bridge.ip_adapter_state_dict(t, pnames))


def _blip2_case():
    from anyedit_tpu.models.blip2 import Blip2VQA
    jc = JZ.qformer
    tree = rand_tree(Blip2VQA(jc), (_z(1, 5, jc.image_dim), _z(1, 8, dt=jnp.int32),
                                    jnp.ones((1, 8), bool)), 26)
    # the checkpoint ties both stacks' embedding to `shared`
    tree["decoder"]["emb"]["embedding"] = tree["encoder"]["emb"]["embedding"]
    return dict(tree=tree, jax=C.convert_blip2, to_sd=bridge.blip2_state_dict,
                cfg=dataclasses.replace(PZ, qformer=dataclasses.replace(
                    PZ.qformer, image_dim=jc.image_dim), eva=dataclasses.replace(
                        PZ.eva, hidden=jc.image_dim)))


CASES = {
    "unet_sd": lambda: _unet_case("sd_unet"),
    "unet_ip2p": lambda: _unet_case("ip2p_unet"),
    "unet_inpaint": lambda: _unet_case("inpaint_unet"),
    "unet_refine": lambda: _unet_case("refine_unet", sdxl=True),
    "vae": lambda: _vae_case(),
    "clip_text": lambda: _text_case("text"),
    "clip_text_sd3": lambda: _text_case("text", with_proj=True),
    "clip_text_g": lambda: _text_case("text_g"),
    "t5": _t5_case,
    "llama": _llama_case,
    "clip_text_proj": _text_proj_case,
    "clip_vision": lambda: _vision_case(JZ.vision, 27, bridge.clip_vision_state_dict,
                                        C.convert_clip_vision),
    "sam": lambda: _sam_case(False),
    "sam/hf": lambda: _sam_case(True),
    "gdino": lambda: _gdino_case(False),
    "gdino/hf": lambda: _gdino_case(True),
    "lama": _lama_case,
    "dinov2": lambda: _dino_case(False),
    "hed": _hed_case,
    "depth": lambda: _depth_case(False),
    "depth/hf": lambda: _depth_case(True),
    "aesthetic": _aesthetic_case,
    "seg": _seg_case,
    "ocr": _ocr_case,
    "vila": _vila_case,
    "unet_anydoor": _anydoor_unet_case,
    "controlnet_anydoor": _anydoor_controlnet_case,
    "anydoor_proj": _anydoor_proj_case,
    "vae_anydoor": lambda: _vae_case(ldm=True),
    "dinov2_g": lambda: _dino_case(True),
    "mmdit_ultraedit": _mmdit_case,
    "flux": _flux_case,
    "ip_proj": _ip_proj_case,
    "ip_adapter": _ip_adapter_case,
    "eva_vit": lambda: _eva_case(False),
    "eva_vit/hf": lambda: _eva_case(True),
    "blip2": _blip2_case,
}


def test_registry_names_equal_jax():
    assert sorted(B.REGISTRY) == sorted(jboot.REGISTRY)
    assert {c.split("/")[0] for c in CASES} == set(B.REGISTRY)


def _dinov2_g_source(plan, sd):
    """The hub's 37-wide grid, here 7 + 3 = 10 wide, resized to the module's 4."""
    src = B.official_state({k: v for k, v in plan.items() if v[0] != "pos_grid"}, sd)
    d = sd["pos_embed"].shape[-1]
    rng = np.random.default_rng(28)
    src["pos_embed"] = torch.from_numpy(rng.standard_normal((1, 1 + 10 * 10, d))
                                        .astype(np.float32))
    return src


@pytest.mark.parametrize("case", list(CASES))
def test_registry_map_matches_jax_converter(case):
    name = case.split("/")[0]
    c = CASES[case]()
    tree = c["tree"]
    sd = c["to_sd"](tree)
    module = c["module"]() if "module" in c else \
        B.REGISTRY[name].module(c.get("cfg", PZ), "cpu")
    assert set(module.state_dict()) == set(sd)
    plan = B.plan_for(name, module, c.get("hint", set(sd)))
    if case == "seg":
        src = _seg_source(plan, sd)
    elif case == "dinov2_g":
        src = _dinov2_g_source(plan, sd)
    else:
        src = B.official_state(plan, sd)
    src = {c.get("prefix", "") + k: v for k, v in src.items()}
    src_np = {k: v.numpy() for k, v in src.items()}
    back = c["jax"](tree, c.get("jax_src", lambda s: s)(src_np))
    ref = c["to_sd"](back)
    got = B.convert_state(name, src, module)
    assert set(got) == set(ref)
    for k in ref:
        r, g = ref[k].numpy(), got[k].float().numpy() if got[k].is_floating_point() \
            else got[k].numpy()
        if name == "dinov2_g" and k == "pos_embed":
            np.testing.assert_allclose(g, r, atol=1e-6 * np.abs(r).max(), rtol=0)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
        if case not in ("seg", "dinov2_g"):       # renames only: the seeded tensors back
            np.testing.assert_array_equal(g, sd[k].numpy(), err_msg=k)


def test_convert_refuses_a_source_that_does_not_load(tmp_path):
    """A missing key raises KeyError naming it; a wrong shape fails the
    strict load; neither writes the output."""
    c = _text_case("text")
    sd = c["to_sd"](c["tree"])
    module = B.REGISTRY["clip_text"].module(PZ, "cpu")
    src = B.official_state(B.plan_for("clip_text", module, ()), sd)
    gone = dict(src)
    gone.pop("text_model.final_layer_norm.weight")
    with pytest.raises(KeyError, match="final_layer_norm"):
        B.convert_state("clip_text", gone, module)
    bad = dict(src)
    bad["text_model.final_layer_norm.weight"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        B.convert_state("clip_text", bad, module)


# ---- the zoo's weights directory --------------------------------------------

def _aesthetic_sd(seed):
    m = pzoo.AestheticMLP(PZ.vision.proj_dim)
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in m.state_dict().items()}


def test_zoo_loads_slot_files_and_requires_them(tmp_path):
    """`aesthetic.safetensors` loads by name; without a weights dir,
    `require_weights` is refused; with one, a slot the build touches that
    has no file raises instead of being seeded; a slot given both as a
    tree and as a file is refused; a `*.msgpack` is refused."""
    sd = _aesthetic_sd(3)
    files.write_safetensors(tmp_path / "aesthetic.safetensors", sd)
    zoo = pzoo.ModelZoo(PZ, "cpu", weights_dir=tmp_path, allow_fallback_tokenizers=True,
                        require_weights=True)
    got = zoo._aesthetic_mlp().state_dict()
    for k in sd:
        assert torch.equal(got[k], sd[k])
    with pytest.raises(FileNotFoundError, match="clip_vision.safetensors"):
        zoo.clip_towers()
    with pytest.raises(ValueError, match="needs a weights_dir"):
        pzoo.ModelZoo(PZ, "cpu", require_weights=True)
    tree = {"params": {"fc0": {"kernel": np.zeros((PZ.vision.proj_dim, 1024), np.float32),
                               "bias": np.zeros(1024, np.float32)}}}
    both = pzoo.ModelZoo(PZ, "cpu", weights_dir=tmp_path, allow_fallback_tokenizers=True,
                         params={"aesthetic": tree})
    with pytest.raises(ValueError, match="both"):
        both._aesthetic_mlp()
    (tmp_path / "clip_vision.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="convert"):
        pzoo.ModelZoo(PZ, "cpu", weights_dir=tmp_path, allow_fallback_tokenizers=True)


def test_zoo_lcm_student_file(tmp_path):
    """With `lcm_steps`, `unet_ip2p_lcm.safetensors` takes the IP2P slot's
    place; under `require_weights` its absence raises."""
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    cfg = dataclasses.replace(PZ, lcm_steps=2)
    unet = UNet2DCondition(cfg.ip2p_unet)
    g = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in unet.state_dict().items()}
    files.write_safetensors(tmp_path / "unet_ip2p.safetensors",
                            {k: torch.zeros_like(v) for k, v in sd.items()})
    with pytest.raises(FileNotFoundError, match="unet_ip2p_lcm"):
        pzoo.ModelZoo(cfg, "cpu", weights_dir=tmp_path, allow_fallback_tokenizers=True,
                      require_weights=True)._ip2p_core()
    files.write_safetensors(tmp_path / "unet_ip2p_lcm.safetensors", sd)
    got, _ = pzoo.ModelZoo(cfg, "cpu", weights_dir=tmp_path, allow_fallback_tokenizers=True,
                           require_weights=True)._ip2p_core()
    for k in sd:
        assert torch.equal(got.state_dict()[k].float(), sd[k])
    teacher, _ = pzoo.ModelZoo(PZ, "cpu", weights_dir=tmp_path,
                               allow_fallback_tokenizers=True)._ip2p_core()
    assert all(float(v.abs().max()) == 0 for v in teacher.state_dict().values())


def test_convert_checkpoint_writes_the_slot_file(tmp_path):
    """`convert_checkpoint` at the full configuration (meta module) on the
    aesthetic MLP's official `.pth`: the slot file holds the same tensors."""
    full = pzoo.AestheticMLP(768)
    g = torch.Generator().manual_seed(7)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in full.state_dict().items()}
    torch.save(sd, tmp_path / "sac+logos+ava1-l14-linearMSE.pth")
    out = tmp_path / "w" / "aesthetic.safetensors"
    B.convert_checkpoint("aesthetic", tmp_path / "sac+logos+ava1-l14-linearMSE.pth", out)
    _same(files.read_safetensors(out), sd)
