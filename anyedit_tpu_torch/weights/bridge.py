"""Flax parameter trees -> the port's state dicts.

The JAX package's converters (`anyedit_tpu/weights/convert.py`) walk ITS
param tree and derive, for each leaf, the diffusers / HF key and the layout
transform (`t_conv`: OIHW -> HWIO, `t_linear`: (out, in) -> (in, out)). The
port's modules carry exactly those keys, so the bridge is that derivation
run backwards: same key for each leaf, inverse transform. A real diffusers
or HF checkpoint therefore loads into the port by name with no second
converter. The key derivations are copied here because the JAX package
cannot be imported without JAX.

Input trees are nested dicts of numpy arrays (what `load_params` returns);
output state dicts hold fp32 CPU tensors, which `load_state_dict` casts
into each parameter's dtype and device. The W8A8 leaves of a
`quantize_params` tree travel too: `kernel_q` stays int8 under the float
kernel's key (`.weight`, same layout transform), and `kernel_scale` keeps
its name (`.kernel_scale`). `unet_tree` carries a port state dict back
into a Flax tree of a given structure, so quant trees round-trip.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

# layout transforms, named by the forward converter's transform. _CONV also
# serves SAM's and LaMa's ConvTranspose (`t_convT`, and `_lama_key`'s
# transpose): (kH, kW, O, I) <-> torch (I, O, kH, kW) is the same
# permutation. _LEAD is `t_pos_embed` (and the no-mask embedding's
# reshape): the torch tensor has a leading axis of 1; _LEAD2 has two
# (BLIP-2's EVA class embedding, (1, 1, H)). _FU and _FU_VEC are
# `t_fu_pack` and `t_fu_vec`, LaMa's FourierUnit: torch interleaves (re, im)
# per channel (2c, 2c + 1), the JAX module puts every re before every im,
# so the 1x1 conv's I and O axes (and the BN vectors after it) are permuted.
_CONV, _LINEAR, _ID, _LEAD, _LEAD2 = "conv", "linear", "id", "lead", "lead2"
_FU, _FU_VEC = "fu_pack", "fu_vec"


def _fu_perm(c: int) -> np.ndarray:
    """JAX channel j <- torch channel perm[j]: evens (re), then odds (im)."""
    return np.concatenate([np.arange(0, c, 2), np.arange(1, c, 2)])


_INVERSE: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    _CONV: lambda w: np.transpose(w, (3, 2, 0, 1)),     # HWIO -> OIHW
    _LINEAR: lambda w: np.transpose(w),                  # (in, out) -> (out, in)
    _ID: lambda w: w,
    _LEAD: lambda w: w[None],
    _LEAD2: lambda w: w[None, None],
    _FU: lambda w: np.transpose(
        w[:, :, np.argsort(_fu_perm(w.shape[2]))][..., np.argsort(_fu_perm(w.shape[3]))],
        (3, 2, 0, 1)),
    _FU_VEC: lambda w: w[np.argsort(_fu_perm(w.shape[0]))],
}
_FORWARD: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    _CONV: lambda w: np.transpose(w, (2, 3, 1, 0)),     # OIHW -> HWIO
    _LINEAR: lambda w: np.transpose(w),
    _ID: lambda w: w,
    _LEAD: lambda w: w[0],
    _LEAD2: lambda w: w[0, 0],
    _FU: lambda w: (lambda h: h[:, :, _fu_perm(h.shape[2])][..., _fu_perm(h.shape[3])])(
        np.transpose(w, (2, 3, 1, 0))),
    _FU_VEC: lambda w: w[_fu_perm(w.shape[0])],
}


def _inverse(tf) -> Callable[[np.ndarray], np.ndarray]:
    """A transform named in `_INVERSE`, or an (inverse, forward) pair of a
    map's own (the MMDiT's patch and positional-grid layouts)."""
    return _INVERSE[tf] if isinstance(tf, str) else tf[0]


def _forward(tf) -> Callable[[np.ndarray], np.ndarray]:
    return _FORWARD[tf] if isinstance(tf, str) else tf[1]


def _keep_dtype(leaf) -> np.ndarray:
    """int8 leaves (W8A8 kernels) stay int8; everything else becomes fp32."""
    a = np.asarray(leaf)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bridge(tree: Mapping[str, Any], key_fn) -> dict[str, torch.Tensor]:
    """key_fn(path) -> (key, transform) or (key, transform, (i, n)). The
    3-tuple form marks the leaf as part i of n stacked along dim 0 of one
    torch tensor (the thirds of a fused `in_proj_weight` / `in_proj_bias`);
    a tuple of keys splits the leaf's dim 0 one part per key: one row each
    (SAM's stacked box corners), or the sizes given as the third element
    (LaMa's last downsample, `convl2l` then `convl2g`)."""
    out: dict[str, Any] = {}
    parts: dict[str, list] = {}
    for path, leaf in _leaves(tree):
        key, tf, *part = key_fn(path)
        w = _inverse(tf)(_keep_dtype(leaf))
        if part and isinstance(key, str):
            i, n = part[0]
            parts.setdefault(key, [None] * n)[i] = w
            continue
        sizes = part[0] if part else (1,) * len(key)
        items = [(key, w)] if isinstance(key, str) else \
            list(zip(key, np.split(w, np.cumsum(sizes)[:-1], axis=0)))
        for k, r in items:
            if k in out:
                raise KeyError(f"two Flax leaves map to {k!r}")
            out[k] = r
    for key, ws in parts.items():
        if key in out or any(w is None for w in ws):
            raise KeyError(f"the parts of {key!r} do not add up")
        out[key] = np.concatenate(ws, axis=0)
    return {k: torch.from_numpy(np.ascontiguousarray(w)) for k, w in out.items()}


def _to_tree(like: Mapping[str, Any], sd: Mapping[str, torch.Tensor], key_fn,
             prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    """The inverse of `_bridge`: a tree shaped like `like`, each leaf read
    from `sd` under the bridge's key, in the Flax layout and sd's dtype."""
    out: dict[str, Any] = {}
    for k, v in like.items():
        path = prefix + (k,)
        if isinstance(v, Mapping):
            out[k] = _to_tree(v, sd, key_fn, path)
            continue
        key, tf, *part = key_fn(path)
        if isinstance(key, str):
            w = sd[key].detach().cpu().numpy()
        else:
            w = np.concatenate([sd[kk].detach().cpu().numpy() for kk in key], axis=0)
        if part and isinstance(key, str):
            i, n = part[0]
            w = np.split(w, n, axis=0)[i]
        w = _forward(tf)(w)
        if w.shape != tuple(v.shape):
            raise KeyError(f"{key}: shape {w.shape} vs the tree's {tuple(v.shape)}")
        out[k] = np.ascontiguousarray(w)
    return out


def _kinds(leaf: str):
    suff = {"kernel": "weight", "kernel_q": "weight", "scale": "weight",
            "bias": "bias", "kernel_scale": "kernel_scale"}.get(leaf, leaf)
    kernel = leaf in ("kernel", "kernel_q")
    conv = lambda k: (f"{k}.{suff}", _CONV if kernel else _ID)
    lin = lambda k: (f"{k}.{suff}", _LINEAR if kernel else _ID)
    norm = lambda k: (f"{k}.{suff}", _ID)
    return conv, lin, norm


def _strip(path: tuple[str, ...]) -> list[str]:
    p = list(path)
    return p[1:] if p[0] == "params" else p


# ---- SD UNet (convert.py `_unet_key`) ---------------------------------------

# a JAX 1x1 conv kernel (1, 1, I, O) <-> a Linear weight (O, I): SDXL's
# proj_in / proj_out (convert.py `t_lin_as_conv11`)
_CONV11_LIN = (lambda w: np.transpose(w[0, 0]), lambda w: np.transpose(w)[None, None])


def _unet_key(path: tuple[str, ...], n_levels: int,
              linear_proj: bool = False) -> tuple[str, str]:
    p = _strip(path)
    name = p[0]
    conv, lin, norm = _kinds(p[-1])
    top = {"conv_in": conv("conv_in"), "conv_out": conv("conv_out"),
           "norm_out": norm("conv_norm_out"),
           "time_fc1": lin("time_embedding.linear_1"),
           "time_fc2": lin("time_embedding.linear_2"),
           "add_fc1": lin("add_embedding.linear_1"),
           "add_fc2": lin("add_embedding.linear_2")}
    if name in top:
        return top[name]

    def res_key(base, sub):
        return {"norm1": norm(f"{base}.norm1"), "conv1": conv(f"{base}.conv1"),
                "time_emb_proj": lin(f"{base}.time_emb_proj"),
                "norm2": norm(f"{base}.norm2"), "conv2": conv(f"{base}.conv2"),
                "skip": conv(f"{base}.conv_shortcut")}[sub]

    def tf_key(base):
        sub = p[1]
        if sub == "norm":
            return norm(f"{base}.norm")
        if sub in ("proj_in", "proj_out"):
            key, tf = conv(f"{base}.{sub}")
            return (key, _CONV11_LIN) if linear_proj and tf == _CONV else (key, tf)
        tb = f"{base}.transformer_blocks.{sub.split('_')[1]}"
        s2 = p[2]
        if s2 in ("norm1", "norm2", "norm3"):
            return norm(f"{tb}.{s2}")
        if s2 in ("attn1", "attn2"):
            return lin(f"{tb}.{s2}.to_out.0" if p[3] == "to_out"
                       else f"{tb}.{s2}.{p[3]}")
        if s2 == "ff":
            return lin(f"{tb}.ff.net.0.proj" if p[3] == "GEGLU_0"
                       else f"{tb}.ff.net.2")
        raise KeyError(path)

    up = lambda lvl: n_levels - 1 - int(lvl)   # our up_{lvl} <-> diffusers order
    if m := re.match(r"down_(\d+)_res_(\d+)$", name):
        return res_key(f"down_blocks.{m[1]}.resnets.{m[2]}", p[1])
    if m := re.match(r"down_(\d+)_tf_(\d+)$", name):
        return tf_key(f"down_blocks.{m[1]}.attentions.{m[2]}")
    if m := re.match(r"down_(\d+)_ds$", name):
        return conv(f"down_blocks.{m[1]}.downsamplers.0.conv")
    if m := re.match(r"mid_res_(\d+)$", name):
        return res_key(f"mid_block.resnets.{m[1]}", p[1])
    if name == "mid_tf":
        return tf_key("mid_block.attentions.0")
    if m := re.match(r"up_(\d+)_res_(\d+)$", name):
        return res_key(f"up_blocks.{up(m[1])}.resnets.{m[2]}", p[1])
    if m := re.match(r"up_(\d+)_tf_(\d+)$", name):
        return tf_key(f"up_blocks.{up(m[1])}.attentions.{m[2]}")
    if m := re.match(r"up_(\d+)_us$", name):
        return conv(f"up_blocks.{up(m[1])}.upsamplers.0.conv")
    raise KeyError(f"unmapped UNet param {'/'.join(path)}")


def unet_state_dict(tree: Mapping[str, Any], n_levels: int = 4, linear_proj: bool = False):
    """Flax `UNet2DCondition` params (float or W8A8) -> the port's
    `UNet2DCondition` state dict. `linear_proj`: proj_in / proj_out in the
    Linear layout (`UNetConfig.use_linear_projection`, SDXL), as
    `convert_unet_sdxl` reads them; SDXL's `add_fc1` / `add_fc2` map to
    `add_embedding.linear_1` / `linear_2`."""
    return _bridge(tree, lambda p: _unet_key(p, n_levels, linear_proj))


def unet_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any],
              n_levels: int = 4, linear_proj: bool = False) -> dict[str, Any]:
    """The port's UNet state dict -> a Flax tree of `like`'s structure
    (numpy leaves; int8 kernels stay int8)."""
    return _to_tree(like, sd, lambda p: _unet_key(p, n_levels, linear_proj))


# ---- ControlNet (diffusers ControlNetModel names) ---------------------------

def _controlnet_key(path: tuple[str, ...], n_levels: int, linear_proj: bool, mid: int):
    """The UNet's names for the shared trunk; the hint encoder's convs
    (`conv_0` .. `conv_6`, `proj`) as `controlnet_cond_embedding.conv_in`,
    `.blocks.{i - 1}` and `.conv_out`; `zero_{i}` as
    `controlnet_down_blocks.{i}`, the last (`zero_{mid}`) as
    `controlnet_mid_block`."""
    p = _strip(path)
    conv, _, _ = _kinds(p[-1])
    if p[0] == "hint_encoder":
        m = re.match(r"conv_(\d+)$", p[1])
        emb = "controlnet_cond_embedding"
        if m is None:
            return conv(f"{emb}.conv_out")
        i = int(m[1])
        return conv(f"{emb}.conv_in" if i == 0 else f"{emb}.blocks.{i - 1}")
    if m := re.match(r"zero_(\d+)$", p[0]):
        i = int(m[1])
        return conv("controlnet_mid_block" if i == mid else f"controlnet_down_blocks.{i}")
    return _unet_key(path, n_levels, linear_proj)


def _controlnet_fn(tree: Mapping[str, Any], n_levels: int, linear_proj: bool):
    mid = max(int(k.split("_")[1]) for k in tree.get("params", tree) if k.startswith("zero_"))
    return lambda p: _controlnet_key(p, n_levels, linear_proj, mid)


def controlnet_state_dict(tree: Mapping[str, Any], n_levels: int = 3,
                          linear_proj: bool = True):
    """Flax `ControlNet` params -> the port's `ControlNet` state dict
    (diffusers ControlNetModel keys; SDXL's Linear proj_in / proj_out)."""
    return _bridge(tree, _controlnet_fn(tree, n_levels, linear_proj))


def controlnet_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any],
                    n_levels: int = 3, linear_proj: bool = True) -> dict[str, Any]:
    """The port's ControlNet state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _controlnet_fn(like, n_levels, linear_proj))


# ---- IP-Adapter (convert.py `convert_image_projection`,
#      `convert_ip_adapter_weights`) --------------------------------------------

def _ip_proj_key(path: tuple[str, ...]):
    p = _strip(path)
    _, lin, norm = _kinds(p[-1])
    return {"proj": lin("proj"), "norm": norm("norm")}[p[0]]


def ip_proj_state_dict(tree: Mapping[str, Any]):
    """Flax `ImageProjection` params -> the port's `ImageProjection` state
    dict (the checkpoint's `image_proj` group: proj, norm)."""
    return _bridge(tree, _ip_proj_key)


def ip_proj_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _ip_proj_key)


def _ip_adapter_fn(site_names: tuple[str, ...]):
    """`{site}_k` / `{site}_v` (dots as "__") of the i-th site ->
    `{2 i + 1}.to_k_ip.weight` / `.to_v_ip.weight` (the checkpoint's
    `ip_adapter` group, keyed by the diffusers attention-processor index)."""
    order = {name.replace(".", "__"): i for i, name in enumerate(site_names)}

    def key(path):
        safe, kv = _strip(path)[0].rsplit("_", 1)
        return f"{2 * order[safe] + 1}.to_{kv}_ip.weight", _LINEAR
    return key


def ip_adapter_state_dict(tree: Mapping[str, Any], site_names: tuple[str, ...]):
    """Flax `IPAdapterWeights` params -> the port's `IPAdapterWeights` state dict."""
    return _bridge(tree, _ip_adapter_fn(site_names))


def ip_adapter_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any],
                    site_names: tuple[str, ...]) -> dict[str, Any]:
    return _to_tree(like, sd, _ip_adapter_fn(site_names))


# ---- DINOv2 (convert.py `_dinov2_hub_key`, `_da2_key`) ------------------------

_DINO_BLOCK = {"ln1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "ln2": "norm2",
               "fc1": "mlp.fc1", "fc2": "mlp.fc2", "w12": "mlp.w12", "w3": "mlp.w3"}


def _dino_key(p: list[str], b: str):
    """A DinoV2 leaf (path below the module) under the official names at
    prefix `b` (fused qkv, `ls{1,2}.gamma`, the ViT-g SwiGLU's w12 / w3)."""
    conv, lin, norm = _kinds(p[-1])
    name = p[0]
    top = {"patch_embed": lambda: conv(f"{b}patch_embed.proj"),
           "cls": lambda: (f"{b}cls_token", _LEAD2),
           "pos": lambda: (f"{b}pos_embed", _LEAD),
           "ln_final": lambda: norm(f"{b}norm")}
    if name in top:
        return top[name]()
    if m := re.match(r"block_(\d+)$", name):
        lb, sub = f"{b}blocks.{m[1]}", p[1]
        if sub in ("ls1", "ls2"):
            return f"{lb}.{sub}.gamma", _ID
        return (norm if sub.startswith("ln") else lin)(f"{lb}.{_DINO_BLOCK[sub]}")
    raise KeyError(f"unmapped DINOv2 param {'/'.join(p)}")


def dinov2_state_dict(tree: Mapping[str, Any]):
    """Flax `DinoV2` params -> the port's `DinoV2` state dict (the torch-hub
    names that `convert_dinov2_hub` reads)."""
    return _bridge(tree, lambda path: _dino_key(_strip(path), ""))


def dinov2_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, lambda path: _dino_key(_strip(path), ""))


# ---- Depth-Anything-V2 (convert.py `_da2_key`) ------------------------------

def _depth_key(path: tuple[str, ...]):
    """The official checkpoint's names: the DINOv2 backbone under
    `pretrained.`, the DPT head under `depth_head.`; its 4x / 2x transposed
    convs (JAX (kH, kW, O, I) <-> torch (I, O, kH, kW), `t_convT4`) take
    the conv permutation."""
    p = _strip(path)
    conv, lin, norm = _kinds(p[-1])
    if p[0] == "backbone":
        return _dino_key(p[1:], "pretrained.")
    if p[0] == "head":
        h, name = "depth_head", p[1]
        if m := re.match(r"proj_(\d)$", name):
            return conv(f"{h}.projects.{m[1]}")
        if m := re.match(r"resize_(\d)$", name):
            return conv(f"{h}.resize_layers.{m[1]}")
        if m := re.match(r"layer(\d)_rn$", name):
            return conv(f"{h}.scratch.layer{m[1]}_rn")
        if m := re.match(r"refinenet(\d)_(rcu1|rcu2|out)$", name):
            rb = f"{h}.scratch.refinenet{m[1]}"
            if m[2] == "out":
                return conv(f"{rb}.out_conv")
            return conv(f"{rb}.resConfUnit{m[2][-1]}.{p[2]}")
        out = {"out1": "output_conv1", "out2": "output_conv2.0", "out3": "output_conv2.2"}
        if name in out:
            return conv(f"{h}.scratch.{out[name]}")
    raise KeyError(f"unmapped DepthAnything param {'/'.join(path)}")


def depth_state_dict(tree: Mapping[str, Any]):
    """Flax `DepthAnythingV2` params -> the port's `DepthAnythingV2` state
    dict (the official Depth-Anything-V2 names that `convert_depth_anything`
    reads)."""
    return _bridge(tree, _depth_key)


def depth_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _depth_key)


# ---- HED (convert.py `_hed_key`) --------------------------------------------

def _hed_key(path: tuple[str, ...]):
    """ControlNetHED_Apache2's names: `norm` (1, 3, 1, 1), `b{s}_conv{i}` as
    `block{s + 1}.convs.{i}`, `b{s}_proj` as `block{s + 1}.projection`."""
    p = _strip(path)
    if p[0] == "norm":
        return "norm", (lambda w: w.reshape(1, 3, 1, 1), lambda w: w.reshape(3))
    conv, _, _ = _kinds(p[-1])
    if m := re.match(r"b(\d)_conv(\d)$", p[0]):
        return conv(f"block{int(m[1]) + 1}.convs.{m[2]}")
    if m := re.match(r"b(\d)_proj$", p[0]):
        return conv(f"block{int(m[1]) + 1}.projection")
    raise KeyError(f"unmapped HED param {'/'.join(path)}")


def hed_state_dict(tree: Mapping[str, Any]):
    """Flax `HED` params -> the port's `HED` state dict."""
    return _bridge(tree, _hed_key)


def hed_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _hed_key)


# ---- UperNet on Swin (convert.py `convert_upernet_swin`) ----------------------

_SEG_HEAD = {"ppm_out": "bottleneck", "fuse": "fpn_bottleneck", "cls": "classifier"}


def _seg_key(path: tuple[str, ...]):
    """The backbone's JAX Swin leaves under the port's Swin names
    (`_swin_key`, prefix `backbone.`: the tree's own layout, not
    GroundingDINO's checkpoint); the head's folded convs under HF
    UperNetHead's names (`ppm_{i}` as `psp_modules.{i}`, `lat_{i}` as
    `lateral_convs.{i}`, `fpn_{i}` as `fpn_convs.{i}`)."""
    p = _strip(path)
    if p[0] == "backbone":
        return _swin_key(p[1:], "backbone.")
    conv, _, _ = _kinds(p[-1])
    name = p[1]
    if m := re.match(r"(ppm|lat|fpn)_(\d+)$", name):
        sub = {"ppm": "psp_modules", "lat": "lateral_convs", "fpn": "fpn_convs"}[m[1]]
        return conv(f"decode_head.{sub}.{m[2]}")
    if name in _SEG_HEAD:
        return conv(f"decode_head.{_SEG_HEAD[name]}")
    raise KeyError(f"unmapped UperNet param {'/'.join(path)}")


def seg_state_dict(tree: Mapping[str, Any]):
    """Flax `UperNetSegmenter` params -> the port's `UperNetSegmenter` state dict."""
    return _bridge(tree, _seg_key)


def seg_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _seg_key)


# ---- AnyDoor's DINOv2 projector (convert.py `convert_anydoor_projector`) ------

def _linear_key(path: tuple[str, ...]):
    """A lone Dense (the JAX zoo's `_Proj`: {"Dense_0": {kernel, bias}}) as a
    bare nn.Linear."""
    return ("weight", _LINEAR) if path[-1] == "kernel" else ("bias", _ID)


def linear_state_dict(tree: Mapping[str, Any]):
    """Flax `_Proj` params -> an nn.Linear state dict (`weight`, `bias`)."""
    return _bridge(tree, _linear_key)


# ---- VAE (convert.py `_vae_key`) --------------------------------------------

def _vae_key(path: tuple[str, ...], n_levels: int) -> tuple[str, str]:
    p = _strip(path)
    tower, name = p[0], p[1]
    conv, lin, norm = _kinds(p[-1])
    if name in ("quant_conv", "post_quant_conv"):
        return conv(name)
    base = "encoder" if tower == "encoder" else "decoder"

    def res(block, sub):
        return {"norm1": norm(f"{block}.norm1"), "conv1": conv(f"{block}.conv1"),
                "norm2": norm(f"{block}.norm2"), "conv2": conv(f"{block}.conv2"),
                "skip": conv(f"{block}.conv_shortcut")}[sub]

    if name in ("conv_in", "conv_out"):
        return conv(f"{base}.{name}")
    if name == "norm_out":
        return norm(f"{base}.conv_norm_out")
    if m := re.match(r"down_(\d+)_res_(\d+)$", name):
        return res(f"{base}.down_blocks.{m[1]}.resnets.{m[2]}", p[2])
    if m := re.match(r"down_(\d+)_ds$", name):
        return conv(f"{base}.down_blocks.{m[1]}.downsamplers.0.conv")
    if m := re.match(r"up_(\d+)_res_(\d+)$", name):
        lvl = n_levels - 1 - int(m[1])
        return res(f"{base}.up_blocks.{lvl}.resnets.{m[2]}", p[2])
    if m := re.match(r"up_(\d+)_us$", name):
        lvl = n_levels - 1 - int(m[1])
        return conv(f"{base}.up_blocks.{lvl}.upsamplers.0.conv")
    if m := re.match(r"mid_res_(\d+)$", name):
        return res(f"{base}.mid_block.resnets.{m[1]}", p[2])
    if name == "mid_attn":
        att = f"{base}.mid_block.attentions.0"
        return {"norm": norm(f"{att}.group_norm"), "q": lin(f"{att}.to_q"),
                "k": lin(f"{att}.to_k"), "v": lin(f"{att}.to_v"),
                "proj_out": lin(f"{att}.to_out.0")}[p[2]]
    raise KeyError(f"unmapped VAE param {'/'.join(path)}")


def vae_state_dict(tree: Mapping[str, Any], n_levels: int = 4):
    """Flax `AutoencoderKL` params -> the port's `AutoencoderKL` state dict."""
    return _bridge(tree, lambda p: _vae_key(p, n_levels))


# ---- CLIP text (convert.py `_clip_text_key`) --------------------------------

def _clip_block_key(p: list[str], lb: str, fused_qkv: bool):
    """One `block_N` leaf of a CLIP text or vision tower; `fused_qkv` for
    the BLIP-2 vision layout (q, k, v as thirds of `self_attn.qkv`)."""
    leaf, sub = p[-1], p[1]
    _, lin, norm = _kinds(leaf)
    if sub in ("ln1", "ln2"):
        return norm(f"{lb}.layer_norm{sub[-1]}")
    if sub in ("fc1", "fc2"):
        return lin(f"{lb}.mlp.{sub}")
    if sub == "attn":
        if not fused_qkv:
            proj = {"to_q": "q_proj", "to_k": "k_proj", "to_v": "v_proj",
                    "to_out": "out_proj"}[p[2]]
            return lin(f"{lb}.self_attn.{proj}")
        if p[2] == "to_out":
            return lin(f"{lb}.self_attn.projection")
        key = f"{lb}.self_attn.qkv.{'weight' if leaf == 'kernel' else 'bias'}"
        return key, _LINEAR if leaf == "kernel" else _ID, (["to_q", "to_k", "to_v"].index(p[2]), 3)
    raise KeyError(f"unmapped vision-block param {'/'.join(p)}")


def _clip_text_key(path: tuple[str, ...]) -> tuple[str, str]:
    p = _strip(path)
    name, leaf = p[0], p[-1]
    base = "text_model"
    if name == "token_emb":
        return f"{base}.embeddings.token_embedding.weight", _ID
    if name == "pos_emb":
        return f"{base}.embeddings.position_embedding.weight", _ID
    if name == "ln_final":
        return _kinds(leaf)[2](f"{base}.final_layer_norm")
    if name == "text_proj":      # CLIPTextModelWithProjection's head, bias-free
        return "text_projection.weight", _LINEAR
    if m := re.match(r"block_(\d+)$", name):
        return _clip_block_key(p, f"{base}.encoder.layers.{m[1]}", False)
    raise KeyError(f"unmapped CLIP-text param {'/'.join(path)}")


def clip_text_state_dict(tree: Mapping[str, Any]):
    """Flax `CLIPTextEncoder` params (with `text_proj`: HF
    CLIPTextModelWithProjection keys) -> the port's `CLIPTextEncoder` state dict."""
    return _bridge(tree, _clip_text_key)


# ---- BERT (convert.py `_bert_key`) ------------------------------------------

def _bert_key(p: list[str], prefix: str) -> tuple[str, str]:
    name = p[0]
    emb = {"tok": "word_embeddings", "pos": "position_embeddings",
           "type": "token_type_embeddings"}
    if name in emb:
        return f"{prefix}embeddings.{emb[name]}.weight", _ID
    _, lin, norm = _kinds(p[-1])
    if name == "emb_ln":
        return norm(f"{prefix}embeddings.LayerNorm")
    if m := re.match(r"layer_(\d+)$", name):
        lb = f"{prefix}encoder.layer.{m[1]}"
        return {"q": lin(f"{lb}.attention.self.query"),
                "k": lin(f"{lb}.attention.self.key"),
                "v": lin(f"{lb}.attention.self.value"),
                "attn_out": lin(f"{lb}.attention.output.dense"),
                "ln1": norm(f"{lb}.attention.output.LayerNorm"),
                "fc1": lin(f"{lb}.intermediate.dense"),
                "fc2": lin(f"{lb}.output.dense"),
                "ln2": norm(f"{lb}.output.LayerNorm")}[p[1]]
    raise KeyError(f"unmapped BERT param {'/'.join(p)}")


# ---- Swin (convert.py `_swin_key`) ------------------------------------------

def _swin_key(p: list[str], prefix: str) -> tuple[str, str]:
    """The official Swin keys. One difference from convert.py's `_swin_key`:
    the patch merging after stage I is `layers.I.downsample` (the official
    layout), where convert.py names it `layers.{I-1}.downsample`."""
    name = p[0]
    conv, lin, norm = _kinds(p[-1])
    if name == "patch_embed":
        return conv(f"{prefix}patch_embed.proj")
    if name == "patch_ln":
        return norm(f"{prefix}patch_embed.norm")
    if m := re.match(r"stage(\d+)_block(\d+)$", name):
        lb = f"{prefix}layers.{m[1]}.blocks.{m[2]}"
        if p[1] == "rel_bias":
            return f"{lb}.attn.relative_position_bias_table", _ID
        return {"ln1": norm(f"{lb}.norm1"), "qkv": lin(f"{lb}.attn.qkv"),
                "proj": lin(f"{lb}.attn.proj"), "ln2": norm(f"{lb}.norm2"),
                "mlp1": lin(f"{lb}.mlp.fc1"), "mlp2": lin(f"{lb}.mlp.fc2")}[p[1]]
    if m := re.match(r"merge_(ln|fc)(\d+)$", name):
        down = f"{prefix}layers.{m[2]}.downsample"
        return norm(f"{down}.norm") if m[1] == "ln" else lin(f"{down}.reduction")
    if m := re.match(r"out_ln(\d+)$", name):
        return norm(f"{prefix}norm{m[1]}")
    raise KeyError(f"unmapped Swin param {'/'.join(p)}")


# ---- GroundingDINO (convert.py `_gdino_key`) --------------------------------

def _gdino_key(path: tuple[str, ...]):
    p = _strip(path)
    name, leaf = p[0], p[-1]
    if name == "bert":
        return _bert_key(p[1:], "bert.")
    if name == "swin":
        return _swin_key(p[1:], "backbone.0.")
    if name in ("level_embed", "tgt_embed"):
        return {"level_embed": "transformer.level_embed",
                "tgt_embed": "transformer.tgt_embed.weight"}[name], _ID
    conv, lin, norm = _kinds(leaf)

    def fused(base, idx):
        """One third of torch's fused in_proj_{weight,bias}."""
        tf = _LINEAR if leaf == "kernel" else _ID
        return f"{base}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}", tf, (idx, 3)

    def deform(base, sub):
        return lin(f"{base}." + {"value_proj": "value_proj",
                                 "sampling_offsets": "sampling_offsets",
                                 "attn_weights": "attention_weights",
                                 "out_proj": "output_proj"}[sub])

    def ffn(base, sub, ln):
        return {"fc1": lin(f"{base}.linear1"), "fc2": lin(f"{base}.linear2"),
                "ln": norm(f"{base}.{ln}")}[sub]

    top = {"feat_map": "feat_map", "mem_proj": "transformer.enc_output",
           "mem_ln": "transformer.enc_output_norm",
           "dec_norm": "transformer.decoder.norm"}
    if name in top:
        return (norm if "norm" in top[name] else lin)(top[name])
    if m := re.match(r"in_(proj|ln)_(\d+)$", name):
        return conv(f"input_proj.{m[2]}.0") if m[1] == "proj" else norm(f"input_proj.{m[2]}.1")
    if m := re.match(r"ref_point_fc(\d)$", name):
        return lin(f"transformer.decoder.ref_point_head.layers.{int(m[1]) - 1}")
    if m := re.match(r"(enc_box_head|dec_box_head_(\d+))$", name):
        base = "transformer.enc_out_bbox_embed" if m[2] is None else f"bbox_embed.{m[2]}"
        return lin(f"{base}.layers.{'fc1 fc2 fc3'.split().index(p[1])}")
    if m := re.match(r"enc_(\d+)$", name):
        tl = f"transformer.encoder.text_layers.{m[1]}"
        fl = f"transformer.encoder.fusion_layers.{m[1]}"
        vl = f"transformer.encoder.layers.{m[1]}"
        sub = p[1]
        if sub == "fusion":
            s2 = p[2]
            if s2 in ("gamma_i", "gamma_t"):
                return f"{fl}.gamma_{'v' if s2 == 'gamma_i' else 'l'}", _ID
            if s2 in ("ln_i", "ln_t"):
                return norm(f"{fl}.layer_norm_{'v' if s2 == 'ln_i' else 'l'}")
            return lin(f"{fl}.attn." + {"qi": "v_proj", "kt": "l_proj",
                                        "vt": "values_l_proj", "vi": "values_v_proj",
                                        "oi": "out_v_proj", "ot": "out_l_proj"}[s2])
        if sub in ("tq", "tk", "tv"):
            return fused(f"{tl}.self_attn", "qkv".index(sub[1]))
        if sub == "to":
            return lin(f"{tl}.self_attn.out_proj")
        if sub in ("txt_ln", "img_ln"):
            return norm(f"{tl if sub == 'txt_ln' else vl}.norm1")
        if sub in ("txt_ffn", "img_ffn"):
            return ffn(tl if sub == "txt_ffn" else vl, p[2], "norm2")
        if sub == "deform":
            return deform(f"{vl}.self_attn", p[2])
    if m := re.match(r"dec_(\d+)$", name):
        dl = f"transformer.decoder.layers.{m[1]}"
        sub = p[1]
        if sub in ("sq", "sk", "sv", "cq", "ck", "cv"):
            att = "self_attn" if sub[0] == "s" else "ca_text"
            return fused(f"{dl}.{att}", "qkv".index(sub[1]))
        if sub in ("so", "co"):
            return lin(f"{dl}.{'self_attn' if sub == 'so' else 'ca_text'}.out_proj")
        if sub in ("ln_sa", "ln_ta", "ln_da"):
            return norm(f"{dl}." + {"ln_sa": "norm2", "ln_ta": "catext_norm",
                                    "ln_da": "norm1"}[sub])
        if sub == "ffn":
            return ffn(dl, p[2], "norm3")
        if sub == "deform":
            return deform(f"{dl}.cross_attn", p[2])
    raise KeyError(f"unmapped GDINO param {'/'.join(path)}")


def gdino_state_dict(tree: Mapping[str, Any]):
    """Flax `GroundingDINO` params -> the port's `GroundingDINO` state dict
    (the official checkpoint's keys, "module." dropped)."""
    return _bridge(tree, _gdino_key)


def gdino_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    """The port's GroundingDINO state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _gdino_key)


# ---- SAM (convert.py `_sam_key`) --------------------------------------------

_SAM_ATTN = {"self": "self_attn", "t2i": "cross_attn_token_to_image",
             "i2t": "cross_attn_image_to_token"}
_SAM_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}


def _sam_key(path: tuple[str, ...]):
    p = _strip(path)
    tower, name, leaf = p[0], p[1], p[-1]
    if tower == "encoder":
        b = "image_encoder"
        if name == "pos_emb":
            return f"{b}.pos_embed", _LEAD
        conv, lin, norm = _kinds(leaf)
        if name == "patch_embed":
            return conv(f"{b}.patch_embed.proj")
        if m := re.match(r"block_(\d+)$", name):
            lb = f"{b}.blocks.{m[1]}"
            sub = p[2]
            if sub in ("rel_h", "rel_w"):
                return f"{lb}.attn.rel_pos_{sub[-1]}", _ID
            return {"ln1": norm(f"{lb}.norm1"), "ln2": norm(f"{lb}.norm2"),
                    "qkv": lin(f"{lb}.attn.qkv"), "proj": lin(f"{lb}.attn.proj"),
                    "mlp1": lin(f"{lb}.mlp.lin1"), "mlp2": lin(f"{lb}.mlp.lin2")}[sub]
        neck = {"neck1": conv(f"{b}.neck.0"), "neck_ln1": norm(f"{b}.neck.1"),
                "neck2": conv(f"{b}.neck.2"), "neck_ln2": norm(f"{b}.neck.3")}
        if name in neck:
            return neck[name]
    if tower == "prompt":
        b = "prompt_encoder"
        if name == "pe_gaussian":
            return f"{b}.pe_layer.positional_encoding_gaussian_matrix", _ID
        if name == "corner_emb":   # rows: top-left (2), bottom-right (3)
            return (f"{b}.point_embeddings.2.weight", f"{b}.point_embeddings.3.weight"), _ID
        if name == "no_mask_emb":
            return f"{b}.no_mask_embed.weight", _LEAD
    if tower == "decoder":
        b = "mask_decoder"
        if name in ("iou_token", "mask_tokens"):
            return f"{b}.{name}.weight", _ID
        conv, lin, norm = _kinds(leaf)
        if m := re.match(r"block_(\d+)$", name):
            lb = f"{b}.transformer.layers.{m[1]}"
            sub = p[2]
            if am := re.match(r"(self|t2i|i2t)_(q|k|v|o)$", sub):
                return lin(f"{lb}.{_SAM_ATTN[am[1]]}.{_SAM_PROJ[am[2]]}")
            if sub in ("ln1", "ln2", "ln3", "ln4"):
                return norm(f"{lb}.norm{sub[-1]}")
            return lin(f"{lb}.mlp.lin{sub[-1]}")           # mlp1, mlp2
        if fm := re.match(r"fin_(q|k|v|o)$", name):
            return lin(f"{b}.transformer.final_attn_token_to_image.{_SAM_PROJ[fm[1]]}")
        up = {"fin_ln": norm(f"{b}.transformer.norm_final_attn"),
              "up1": conv(f"{b}.output_upscaling.0"), "up_ln": norm(f"{b}.output_upscaling.1"),
              "up2": conv(f"{b}.output_upscaling.3")}
        if name in up:
            return up[name]
        if m := re.match(r"hyper_(\d+)_(\d+)$", name):
            return lin(f"{b}.output_hypernetworks_mlps.{m[1]}.layers.{m[2]}")
        if m := re.match(r"iou_(\d+)$", name):
            return lin(f"{b}.iou_prediction_head.layers.{m[1]}")
    raise KeyError(f"unmapped SAM param {'/'.join(path)}")


def sam_state_dict(tree: Mapping[str, Any]):
    """Flax `SAM` params -> the port's `SAM` state dict (the official
    segment-anything keys; the stacked box corners become
    `point_embeddings.2` / `.3`)."""
    return _bridge(tree, _sam_key)


def sam_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    """The port's SAM state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _sam_key)


# ---- CLIP vision (convert.py `_clip_vision_key`, `_eva_key`) ---------------

def _clip_vision_key(path: tuple[str, ...]):
    p = _strip(path)
    name = p[0]
    conv, lin, norm = _kinds(p[-1])
    base = "vision_model"
    top = {"cls": (f"{base}.embeddings.class_embedding", _ID),
           "pos_emb": (f"{base}.embeddings.position_embedding.weight", _ID)}
    if name in top:
        return top[name]
    if name == "patch_emb":
        return conv(f"{base}.embeddings.patch_embedding")
    if name == "pre_ln":
        return norm(f"{base}.pre_layrnorm")   # (sic) HF's spelling
    if name == "post_ln":
        return norm(f"{base}.post_layernorm")
    if name == "visual_proj":
        return lin("visual_projection")
    if m := re.match(r"block_(\d+)$", name):
        return _clip_block_key(p, f"{base}.encoder.layers.{m[1]}", False)
    raise KeyError(f"unmapped CLIP-vision param {'/'.join(path)}")


def _eva_key(path: tuple[str, ...]):
    p = _strip(path)
    name = p[0]
    conv, _, norm = _kinds(p[-1])
    base = "vision_model"
    if name == "cls":
        return f"{base}.embeddings.class_embedding", _LEAD2
    if name == "pos_emb":
        return f"{base}.embeddings.position_embedding", _LEAD
    if name == "patch_emb":
        return conv(f"{base}.embeddings.patch_embedding")
    if name == "post_ln":
        return norm(f"{base}.post_layernorm")
    if m := re.match(r"block_(\d+)$", name):
        return _clip_block_key(p, f"{base}.encoder.layers.{m[1]}", True)
    raise KeyError(f"unmapped EVA param {'/'.join(path)}")


def clip_vision_state_dict(tree: Mapping[str, Any]):
    """Flax `CLIPVisionEncoder` params of a CLIP tower (`pre_ln`) -> the
    port's `CLIPVisionEncoder` state dict (HF CLIPVisionModelWithProjection keys)."""
    return _bridge(tree, _clip_vision_key)


def clip_vision_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _clip_vision_key)


def eva_vit_state_dict(tree: Mapping[str, Any]):
    """Flax `CLIPVisionEncoder` params of the BLIP-2 layout (no `pre_ln`)
    -> the port's state dict (HF Blip2VisionModel keys, the q / k / v
    kernels and biases fused into `self_attn.qkv`)."""
    return _bridge(tree, _eva_key)


def eva_vit_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _eva_key)


# ---- CLIPTextModel (the `_clip_text_proj` bootstrap map) --------------------

def _clip_text_proj_key(path: tuple[str, ...]):
    p = _strip(path)
    if p[0] == "encoder":
        return _clip_text_key(tuple(p[1:]))
    if p[0] == "text_proj":
        return "text_projection.weight", _LINEAR
    raise KeyError(f"unmapped CLIPTextModel param {'/'.join(path)}")


def clip_text_proj_state_dict(tree: Mapping[str, Any]):
    """Flax `CLIPTextModel` params (tower + projection) -> the port's
    `CLIPTextModel` state dict (HF CLIPTextModelWithProjection keys)."""
    return _bridge(tree, _clip_text_proj_key)


def clip_text_proj_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _clip_text_proj_key)


# ---- LAION aesthetic MLP (convert.py `_aesthetic_key`) ----------------------

def _aesthetic_key(path: tuple[str, ...]):
    p = _strip(path)
    _, lin, _ = _kinds(p[-1])
    return lin(f"layers.{ {'fc0': 0, 'fc1': 2, 'fc2': 4, 'fc3': 6, 'out': 7}[p[0]] }")


def aesthetic_state_dict(tree: Mapping[str, Any]):
    """Flax `AestheticMLP` params -> the released predictor's Sequential keys."""
    return _bridge(tree, _aesthetic_key)


def aesthetic_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _aesthetic_key)


# ---- T5 and BLIP-2 (convert.py `_t5_key`, `_t5_dec_key`, `_qformer_key`,
# `convert_blip2`) ------------------------------------------------------------

def _t5_key(p: list[str], prefix: str, decoder: bool):
    """A T5Encoder / T5Decoder leaf -> the HF T5Stack key under `prefix`.
    The embedding is the stack's own `embed_tokens` (convert.py reads HF's
    `shared` for both stacks; `embed_tokens` is HF's tied alias of it, and
    the Flax trees hold two tables)."""
    name = p[0]
    _, lin, norm = _kinds(p[-1])
    if name == "emb":
        return f"{prefix}embed_tokens.weight", _ID
    if name == "ln_final":
        return norm(f"{prefix}final_layer_norm")
    if name == "lm_head":
        return lin(f"{prefix}lm_head")
    ffn = 2 if decoder else 1
    if m := re.match(r"(ln_a|ln_x|ln_f|attn|self|cross|ffn)_(\d+)$", name):
        kind, blk = m[1], f"{prefix}block.{m[2]}.layer"
        if kind in ("ln_a", "ln_x", "ln_f"):
            return norm(f"{blk}.{ {'ln_a': 0, 'ln_x': 1, 'ln_f': ffn}[kind] }.layer_norm")
        if kind in ("attn", "self"):
            if p[1] == "rel_bias":
                return f"{blk}.0.SelfAttention.relative_attention_bias.weight", _ID
            return lin(f"{blk}.0.SelfAttention.{p[1]}")
        if kind == "cross":
            return lin(f"{blk}.1.EncDecAttention.{p[1]}")
        return lin(f"{blk}.{ffn}.DenseReluDense.{ {'wi0': 'wi_0', 'wi1': 'wi_1', 'wo': 'wo'}[p[1]] }")
    raise KeyError(f"unmapped T5 param {'/'.join(p)}")


def t5_state_dict(tree: Mapping[str, Any], decoder: bool = False):
    """Flax `T5Encoder` (or `T5Decoder`) params -> the port's module's state dict."""
    return _bridge(tree, lambda path: _t5_key(_strip(path), "", decoder))


def _qformer_key(p: list[str]):
    name = p[0]
    _, lin, norm = _kinds(p[-1])
    if name == "queries":
        return "query_tokens", _LEAD
    if name == "ln_in":
        return norm("qformer.layernorm")
    if name == "lm_proj":
        return lin("language_projection")
    if m := re.match(r"block_(\d+)$", name):
        b = f"qformer.encoder.layer.{m[1]}"
        sub = p[1]
        if sub in ("ln_sa", "ln_ca", "ln_ff"):
            return norm({"ln_sa": f"{b}.attention.output.LayerNorm",
                         "ln_ca": f"{b}.crossattention.output.LayerNorm",
                         "ln_ff": f"{b}.output_query.LayerNorm"}[sub])
        if sub in ("fc1", "fc2"):
            return lin(f"{b}.{'intermediate_query' if sub == 'fc1' else 'output_query'}.dense")
        att = f"{b}.{'attention' if sub[0] == 's' else 'crossattention'}"
        if sub[1] == "o":
            return lin(f"{att}.output.dense")
        return lin(f"{att}.attention.{ {'q': 'query', 'k': 'key', 'v': 'value'}[sub[1]] }")
    raise KeyError(f"unmapped QFormer param {'/'.join(p)}")


def qformer_state_dict(tree: Mapping[str, Any]):
    """Flax `QFormer` params -> the port's `QFormer` state dict."""
    return _bridge(tree, lambda path: _qformer_key(_strip(path)))


def _blip2_key(path: tuple[str, ...]):
    p = _strip(path)
    if p[0] == "qformer":
        return _qformer_key(p[1:])
    if p[0] == "decoder" and p[1] == "lm_head":
        return "language_model.lm_head.weight", _LINEAR
    if p[0] in ("encoder", "decoder"):
        return _t5_key(p[1:], f"language_model.{p[0]}.", p[0] == "decoder")
    raise KeyError(f"unmapped Blip2VQA param {'/'.join(path)}")


def blip2_state_dict(tree: Mapping[str, Any]):
    """Flax `Blip2VQA` params (Q-Former, T5 encoder and decoder) -> the
    port's `Blip2VQA` state dict (HF Blip2ForConditionalGeneration keys)."""
    return _bridge(tree, _blip2_key)


def blip2_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _blip2_key)


# ---- LaMa (convert.py `_lama_key`, `convert_lama`) --------------------------

_BN = {"gamma": "weight", "beta": "bias", "mean": "running_mean", "var": "running_var"}


def _lama_key(path: tuple[str, ...], nd: int, nb: int, split: tuple[int, int]):
    """`split`: the (local, global) widths of the last downsample, which the
    JAX module runs as one conv and the checkpoint as `convl2l` and
    `convl2g`."""
    p = _strip(path)
    name, leaf = p[0], p[-1]
    kernel = leaf == "kernel"

    def conv(k):
        return f"{k}.{'weight' if kernel else 'bias'}", _CONV if kernel else _ID

    def bn(k):
        return f"{k}.{_BN[leaf]}", _ID

    if name in ("stem", "stem_bn"):
        return conv("model.1.ffc.convl2l") if name == "stem" else bn("model.1.bn_l")
    if m := re.match(r"down_(bn_)?(\d+)$", name):
        base, is_bn, last = f"model.{2 + int(m[2])}", m[1], int(m[2]) == nd - 1
        if not last:
            return bn(f"{base}.bn_l") if is_bn else conv(f"{base}.ffc.convl2l")
        if is_bn:
            return (bn(f"{base}.bn_l")[0], bn(f"{base}.bn_g")[0]), _ID, split
        keys = (conv(f"{base}.ffc.convl2l"), conv(f"{base}.ffc.convl2g"))
        return (keys[0][0], keys[1][0]), keys[0][1], split
    if m := re.match(r"block_(\d+)$", name):
        base = f"model.{2 + nd + int(m[1])}"
        sub = p[1]
        if sub in ("bn1_l", "bn1_g", "bn2_l", "bn2_g"):
            return bn(f"{base}.conv{sub[2]}.bn_{sub[-1]}")
        cb = f"{base}.conv{sub[-1]}.ffc"            # ffc1, ffc2
        if p[2] != "g2g":
            return conv(f"{cb}.conv{p[2]}")          # l2l, l2g, g2l
        st = f"{cb}.convg2g"
        s3 = p[3]
        if s3 == "fu_conv":
            return f"{st}.fu.conv_layer.{'weight' if kernel else 'bias'}", \
                _FU if kernel else _FU_VEC
        if s3 == "fu_bn":
            return bn(f"{st}.fu.bn")[0], _FU_VEC
        return {"down": lambda: conv(f"{st}.conv1.0"), "bn1": lambda: bn(f"{st}.conv1.1"),
                "up": lambda: conv(f"{st}.conv2")}[s3]()
    if m := re.match(r"up_(bn_)?(\d+)$", name):
        i = 3 + nd + nb + 3 * int(m[2])
        return bn(f"model.{i + 1}") if m[1] else conv(f"model.{i}")
    if name == "out":
        return conv(f"model.{4 + 4 * nd + nb}")
    raise KeyError(f"unmapped LaMa param {'/'.join(path)}")


def _lama_fn(tree: Mapping[str, Any], ratio_g: float):
    p = tree.get("params", tree)
    nd = sum(1 for k in p if re.match(r"down_\d+$", k))
    nb = sum(1 for k in p if re.match(r"block_\d+$", k))
    ch = int(np.asarray(p[f"down_{nd - 1}"]["bias"]).shape[0])
    g = int(ch * ratio_g)
    return lambda path: _lama_key(path, nd, nb, (ch - g, g))


def lama_state_dict(tree: Mapping[str, Any], ratio_g: float = 0.75):
    """Flax `LamaGenerator` params -> the port's `LamaGenerator` state dict
    (the saicinpainting generator's keys); `ratio_g` splits the last
    downsample into its local and global convs."""
    return _bridge(tree, _lama_fn(tree, ratio_g))


def lama_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any],
              ratio_g: float = 0.75) -> dict[str, Any]:
    """The port's LaMa state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _lama_fn(like, ratio_g))


# ---- MM-DiT (convert.py `_mmdit_key`, `convert_mmdit`) ----------------------

def _swap_halves(w: np.ndarray) -> np.ndarray:
    d = w.shape[0] // 2
    return np.concatenate([w[d:], w[:d]], axis=0)


# AdaLayerNormContinuous stores (scale || shift); the JAX package's Dense is
# shift first (`t_swap_halves_lin`, `t_swap_halves_bias`)
_SWAP_LIN = (lambda k: _swap_halves(np.transpose(k)), lambda w: np.transpose(_swap_halves(w)))
_SWAP_VEC = (_swap_halves, _swap_halves)
# the positional grid: (max, max, D) in the Flax tree, (1, max^2, D) in diffusers
_POS_GRID = (lambda w: w.reshape(1, -1, w.shape[-1]),
             lambda w: w[0].reshape(int(round(w.shape[1] ** 0.5)), -1, w.shape[-1]))


def _patch_conv(patch: int):
    """`t_patch_conv_as_dense` both ways: the Flax patch Dense ((p, p, C)
    flattened, D) <-> the PatchEmbed conv (D, C, p, p)."""
    def inverse(k):
        return np.transpose(k.reshape(patch, patch, -1, k.shape[-1]), (3, 2, 0, 1))

    def forward(w):
        return np.transpose(w, (2, 3, 1, 0)).reshape(-1, w.shape[0])
    return inverse, forward


_MMDIT_BLOCK = {"img_q": "attn.to_q", "img_k": "attn.to_k", "img_v": "attn.to_v",
                "txt_q": "attn.add_q_proj", "txt_k": "attn.add_k_proj",
                "txt_v": "attn.add_v_proj", "img_proj": "attn.to_out.0",
                "txt_proj": "attn.to_add_out", "img_fc1": "ff.net.0.proj",
                "img_fc2": "ff.net.2", "txt_fc1": "ff_context.net.0.proj",
                "txt_fc2": "ff_context.net.2", "img_qn": "attn.norm_q",
                "img_kn": "attn.norm_k", "txt_qn": "attn.norm_added_q",
                "txt_kn": "attn.norm_added_k"}


def _mmdit_key(path: tuple[str, ...], last_block: int, patch: int):
    p = _strip(path)
    name, leaf = p[0], p[-1]
    _, lin, _ = _kinds(leaf)
    kernel = leaf in ("kernel", "kernel_q")
    if name == "pos_emb":
        return "pos_embed.pos_embed", _POS_GRID
    if name == "patch_in":
        return ("pos_embed.proj.weight", _patch_conv(patch)) if kernel \
            else ("pos_embed.proj.bias", _ID)
    top = {"ctx_in": "context_embedder", "t_fc1": "time_text_embed.timestep_embedder.linear_1",
           "t_fc2": "time_text_embed.timestep_embedder.linear_2",
           "p_fc1": "time_text_embed.text_embedder.linear_1",
           "p_fc2": "time_text_embed.text_embedder.linear_2", "patch_out": "proj_out"}
    if name in top:
        return lin(top[name])

    def swapped(base):
        return (f"{base}.weight", _SWAP_LIN) if kernel else (f"{base}.bias", _SWAP_VEC)
    if name == "final_mod":
        return swapped("norm_out.linear")
    if m := re.match(r"block_(\d+)$", name):
        b, sub = f"transformer_blocks.{m[1]}", p[1]
        if sub == "img_mod":
            return lin(f"{b}.norm1.linear")
        if sub == "txt_mod":
            return swapped(f"{b}.norm1_context.linear") if int(m[1]) == last_block \
                else lin(f"{b}.norm1_context.linear")
        if sub.endswith(("_qn", "_kn")):
            return f"{b}.{_MMDIT_BLOCK[sub]}.weight", _ID
        if sub in _MMDIT_BLOCK:
            return lin(f"{b}.{_MMDIT_BLOCK[sub]}")
    raise KeyError(f"unmapped MMDiT param {'/'.join(path)}")


def _mmdit_fn(tree: Mapping[str, Any], patch: int):
    p = tree.get("params", tree)
    last = max(int(k.split("_")[1]) for k in p if k.startswith("block_"))
    return lambda path: _mmdit_key(path, last, patch)


def mmdit_state_dict(tree: Mapping[str, Any], patch: int = 2):
    """Flax `MMDiT` params (float or W8A8) -> the port's `MMDiT` state dict
    (diffusers SD3Transformer2DModel keys): the patch Dense as the PatchEmbed
    conv, the positional grid as (1, max^2, D), and the adaLN-Continuous
    modulations (`norm_out`, the last block's `norm1_context`) with their
    halves swapped into diffusers' (scale, shift) order."""
    return _bridge(tree, _mmdit_fn(tree, patch))


def mmdit_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any],
               patch: int = 2) -> dict[str, Any]:
    """The port's MMDiT state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _mmdit_fn(like, patch))


# ---- Flux (convert.py `_flux_key`, `convert_flux`) --------------------------

_FLUX_TOP = {"img_in": "x_embedder", "txt_in": "context_embedder",
             "t_fc1": "time_text_embed.timestep_embedder.linear_1",
             "t_fc2": "time_text_embed.timestep_embedder.linear_2",
             "g_fc1": "time_text_embed.guidance_embedder.linear_1",
             "g_fc2": "time_text_embed.guidance_embedder.linear_2",
             "p_fc1": "time_text_embed.text_embedder.linear_1",
             "p_fc2": "time_text_embed.text_embedder.linear_2",
             "final_out": "proj_out"}
_FLUX_DOUBLE = {"img_mod": "norm1.linear", "txt_mod": "norm1_context.linear",
                "img_o": "attn.to_out.0", "txt_o": "attn.to_add_out",
                "img_fc1": "ff.net.0.proj", "img_fc2": "ff.net.2",
                "txt_fc1": "ff_context.net.0.proj", "txt_fc2": "ff_context.net.2",
                "img_qn": "attn.norm_q", "img_kn": "attn.norm_k",
                "txt_qn": "attn.norm_added_q", "txt_kn": "attn.norm_added_k"}
_FLUX_SINGLE = {"mod": "norm.linear", "linear2": "proj_out",
                "qn": "attn.norm_q", "kn": "attn.norm_k"}


def _flux_key(path: tuple[str, ...], d: int):
    p = _strip(path)
    name, leaf = p[0], p[-1]
    if leaf == "g":                        # the per-head RMS norms
        leaf = "scale"
    _, lin, _ = _kinds(leaf)
    suff = lin("")[0][1:]

    def fused(base, names, sizes):
        return tuple(f"{base}.{n}.{suff}" for n in names), lin("")[1], sizes
    if name in _FLUX_TOP:
        return lin(_FLUX_TOP[name])
    if name == "final_mod":
        kernel = leaf in ("kernel", "kernel_q")
        return ("norm_out.linear.weight", _SWAP_LIN) if kernel \
            else ("norm_out.linear.bias", _SWAP_VEC)
    if m := re.match(r"double_(\d+)$", name):
        b, sub = f"transformer_blocks.{m[1]}", p[1]
        if sub == "img_qkv":
            return fused(f"{b}.attn", ("to_q", "to_k", "to_v"), (d, d, d))
        if sub == "txt_qkv":
            return fused(f"{b}.attn", ("add_q_proj", "add_k_proj", "add_v_proj"), (d, d, d))
        if sub in _FLUX_DOUBLE:
            return lin(f"{b}.{_FLUX_DOUBLE[sub]}")
    if m := re.match(r"single_(\d+)$", name):
        b, sub = f"single_transformer_blocks.{m[1]}", p[1]
        if sub == "linear1":
            return fused(b, ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"),
                         (d, d, d, 4 * d))
        if sub in _FLUX_SINGLE:
            return lin(f"{b}.{_FLUX_SINGLE[sub]}")
    raise KeyError(f"unmapped Flux param {'/'.join(path)}")


def _flux_fn(tree: Mapping[str, Any]):
    d = np.shape(tree.get("params", tree)["img_in"]["kernel"])[-1]
    return lambda path: _flux_key(path, d)


def flux_state_dict(tree: Mapping[str, Any]):
    """Flax `Flux` params (float or W8A8) -> the port's `Flux` state dict
    (diffusers FluxTransformer2DModel keys): each fused `*_qkv` split into
    to_q, to_k, to_v (add_*_proj for text), each single block's `linear1`
    into to_q, to_k, to_v and proj_mlp, and `final_mod` with its halves
    swapped into `norm_out`'s (scale, shift) order."""
    return _bridge(tree, _flux_fn(tree))


def flux_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    """The port's Flux state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _flux_fn(like))


# ---- Llama, VILA, GOT-OCR2 (convert.py `_llama_key`, `convert_vila`,
# `convert_got_ocr`) -------------------------------------------------------------

_LLAMA_LAYER = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
                "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                "w_down": "mlp.down_proj", "attn_norm": "input_layernorm",
                "mlp_norm": "post_attention_layernorm"}


def _llama_key(p: list[str], body: str):
    """A `Llama` leaf (float or W8A8) -> the HF key, the decoder body under
    `body` ("model." for LlamaForCausalLM, "model.language_model." inside
    VILA and GOT); the lm head is top-level `lm_head` in all three."""
    name = p[0]
    _, lin, norm = _kinds(p[-1])
    if name == "tok":
        return f"{body}embed_tokens.weight", _ID
    if name == "norm_f":
        return norm(f"{body}norm")
    if name == "lm_head":
        return lin("lm_head")
    if m := re.match(r"layer_(\d+)$", name):
        return lin(f"{body}layers.{m[1]}.{_LLAMA_LAYER[p[1]]}")
    raise KeyError(f"unmapped Llama param {'/'.join(p)}")


def _llama_fn(path: tuple[str, ...]):
    return _llama_key(_strip(path), "model.")


def llama_state_dict(tree: Mapping[str, Any]):
    """Flax `Llama` params (float or W8A8) -> the port's `Llama` state dict
    (HF LlamaForCausalLM keys)."""
    return _bridge(tree, _llama_fn)


def llama_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _llama_fn)


def _vila_key(path: tuple[str, ...]):
    p = _strip(path)
    if p[0] == "vision":
        key, tf = _clip_vision_key(tuple(p[1:]))
        return f"model.vision_tower.{key}", tf
    if p[0] == "projector":
        _, lin, _ = _kinds(p[-1])
        return lin(f"model.multi_modal_projector.linear_{p[1][-1]}")    # fc1, fc2
    if p[0] == "lm":
        return _llama_key(p[1:], "model.language_model.")
    raise KeyError(f"unmapped VILA param {'/'.join(path)}")


def vila_state_dict(tree: Mapping[str, Any]):
    """Flax `VilaVQA` params -> the port's `VilaVQA` state dict (HF
    LlavaForConditionalGeneration keys)."""
    return _bridge(tree, _vila_key)


def vila_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _vila_key)


def _ocr_key(path: tuple[str, ...]):
    p = _strip(path)
    proj = "model.multi_modal_projector"
    if p[0] == "vision":
        key, *rest = _sam_key(("encoder",) + tuple(p[1:]))
        return (f"model.vision_tower.{key[len('image_encoder.'):]}", *rest)
    if p[0] in ("up1", "up2"):
        conv, _, _ = _kinds(p[-1])
        return conv(f"{proj}.conv_upsampler{p[0][-1]}")
    if p[0] == "mm_proj":
        _, lin, _ = _kinds(p[-1])
        return lin(f"{proj}.multimodal_projector")
    if p[0] == "lm":
        return _llama_key(p[1:], "model.language_model.")
    raise KeyError(f"unmapped GOT-OCR2 param {'/'.join(path)}")


def ocr_state_dict(tree: Mapping[str, Any]):
    """Flax `GotOCR` params -> the port's `GotOCR` state dict: the SAM
    encoder under `model.vision_tower` with its own names, the projector
    and the Qwen2 LM under HF GotOcr2 names. The tree's lm head holds the
    checkpoint's tied embedding (convert.py copies it), so `lm_head.weight`
    and the embedding both come from the tree."""
    return _bridge(tree, _ocr_key)


def ocr_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    return _to_tree(like, sd, _ocr_key)


# ---- AnySD's task-routed adapter (`train/anysd.py::TaskMoEAdapter`) ----------

def _anysd_adapter_key(path: tuple[str, ...]):
    p = _strip(path)
    if len(p) == 1:                      # expert_w1, expert_w2, task_embs
        return p[0], _ID
    return {("out_ln", "scale"): ("out_ln.weight", _ID),
            ("out_ln", "bias"): ("out_ln.bias", _ID),
            ("task_proj", "kernel"): ("task_proj.weight", _LINEAR),
            ("task_proj", "bias"): ("task_proj.bias", _ID)}[tuple(p)]


def anysd_adapter_state_dict(tree: Mapping[str, Any]):
    """Flax `TaskMoEAdapter` params -> the port's adapter state dict."""
    return _bridge(tree, _anysd_adapter_key)


def anysd_adapter_tree(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict[str, Any]:
    """The port's adapter state dict -> a Flax tree of `like`'s structure."""
    return _to_tree(like, sd, _anysd_adapter_key)
