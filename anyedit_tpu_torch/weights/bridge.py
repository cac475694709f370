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
into each parameter's dtype and device.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

# layout transforms, named by the forward converter's transform
_CONV, _LINEAR, _ID = "conv", "linear", "id"
_INVERSE: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    _CONV: lambda w: np.transpose(w, (3, 2, 0, 1)),     # HWIO -> OIHW
    _LINEAR: lambda w: np.transpose(w),                  # (in, out) -> (out, in)
    _ID: lambda w: w,
}


def _leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bridge(tree: Mapping[str, Any], key_fn) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        key, tf = key_fn(path)
        if key in out:
            raise KeyError(f"two Flax leaves map to {key!r}")
        w = _INVERSE[tf](np.asarray(leaf, dtype=np.float32))
        out[key] = torch.from_numpy(np.ascontiguousarray(w))
    return out


def _kinds(leaf: str):
    suff = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    conv = lambda k: (f"{k}.{suff}", _CONV if leaf == "kernel" else _ID)
    lin = lambda k: (f"{k}.{suff}", _LINEAR if leaf == "kernel" else _ID)
    norm = lambda k: (f"{k}.{suff}", _ID)
    return conv, lin, norm


def _strip(path: tuple[str, ...]) -> list[str]:
    p = list(path)
    return p[1:] if p[0] == "params" else p


# ---- SD UNet (convert.py `_unet_key`) ---------------------------------------

def _unet_key(path: tuple[str, ...], n_levels: int) -> tuple[str, str]:
    p = _strip(path)
    name = p[0]
    conv, lin, norm = _kinds(p[-1])
    top = {"conv_in": conv("conv_in"), "conv_out": conv("conv_out"),
           "norm_out": norm("conv_norm_out"),
           "time_fc1": lin("time_embedding.linear_1"),
           "time_fc2": lin("time_embedding.linear_2")}
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
            return conv(f"{base}.{sub}")
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


def unet_state_dict(tree: Mapping[str, Any], n_levels: int = 4):
    """Flax `UNet2DCondition` params -> the port's `UNet2DCondition` state dict."""
    return _bridge(tree, lambda p: _unet_key(p, n_levels))


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

def _clip_text_key(path: tuple[str, ...]) -> tuple[str, str]:
    p = _strip(path)
    name, leaf = p[0], p[-1]
    base = "text_model"
    if name == "token_emb":
        return f"{base}.embeddings.token_embedding.weight", _ID
    if name == "pos_emb":
        return f"{base}.embeddings.position_embedding.weight", _ID
    _, lin, norm = _kinds(leaf)
    if name == "ln_final":
        return norm(f"{base}.final_layer_norm")
    if m := re.match(r"block_(\d+)$", name):
        lb = f"{base}.encoder.layers.{m[1]}"
        sub = p[1]
        if sub in ("ln1", "ln2"):
            return norm(f"{lb}.layer_norm{sub[-1]}")
        if sub == "attn":
            proj = {"to_q": "q_proj", "to_k": "k_proj", "to_v": "v_proj",
                    "to_out": "out_proj"}[p[2]]
            return lin(f"{lb}.self_attn.{proj}")
        if sub in ("fc1", "fc2"):
            return lin(f"{lb}.mlp.{sub}")
    raise KeyError(f"unmapped CLIP-text param {'/'.join(path)}")


def clip_text_state_dict(tree: Mapping[str, Any]):
    """Flax `CLIPTextEncoder` params -> the port's `CLIPTextEncoder` state dict."""
    return _bridge(tree, _clip_text_key)
