"""The scorers of the PyTorch port against the JAX package: the scorer
functions, the aesthetic MLP, the CLIP text model and both branches of the
CLIP vision tower (the CLIP tower, and BLIP-2's EVA layout), through the
weight bridge; then the zoo's `clip_towers()` and `aesthetic_fn()` against
the JAX zoo's on the same weights.

Tolerances: the scorer functions 1e-5 (fp32, different summation order);
the models and the zoo slots 1e-4 on fp32 outputs of unit scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.filters import scorers as jscorers
from anyedit_tpu.models import clip as jclip
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import (
    convert_aesthetic, convert_clip_vision, convert_eva_vit, save_params,
)
from anyedit_tpu_torch.filters import scorers
from anyedit_tpu_torch.models import clip as tclip
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, JAX_TEXT, PORT_TEXT, TF32, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_VISION = dataclasses.replace(jclip.TINY_VISION, **F32)
# the BLIP-2 layout at tiny size: no pre-LN, no projection, a patch-conv
# bias, an explicit MLP width and exact GELU
EVA_KW = dict(pre_ln=False, use_proj=False, patch_bias=True, mlp_dim=48, activation="gelu")
JAX_EVA = dataclasses.replace(JAX_VISION, **EVA_KW)
PORT_VISION = dataclasses.replace(tclip.TINY_VISION, **TF32)
PORT_EVA = dataclasses.replace(PORT_VISION, **EVA_KW)
IMG = np.random.default_rng(21).integers(0, 256, (48, 40, 3), np.uint8)


def vision_params(cfg, seed):
    return random_flax_params(jclip.CLIPVisionEncoder(cfg),
                              (jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),), seed)


def text_proj_params(seed=31):
    return random_flax_params(jclip.CLIPTextModel(JAX_TEXT, proj_dim=JAX_VISION.proj_dim),
                              (jnp.zeros((1, 77), jnp.int32),), seed)


def aesthetic_params(seed=32, dim=16):
    return random_flax_params(jscorers.AestheticMLP(), (jnp.zeros((1, dim)),), seed)


def _emb(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_scorer_functions_match():
    """clip_score, directional CLIP, cosine, L1, SSIM and the OCR match
    against the JAX functions at 1e-5."""
    rng = np.random.default_rng(5)
    a, b, c, d = (_emb(rng, 3, 16) for _ in range(4))
    pairs = [(scorers.clip_score(T(a), T(b)), jscorers.clip_score(a, b)),
             (scorers.directional_clip_score(T(a), T(b), T(c), T(d)),
              jscorers.directional_clip_score(a, b, c, d)),
             (scorers.directional_clip_score(T(a), T(a), T(c), T(d)),   # Δimage = 0
              jscorers.directional_clip_score(a, a, c, d)),
             (scorers.cosine_similarity(T(a * 3), T(b)), jscorers.cosine_similarity(a * 3, b))]
    x, y = (rng.random((2, 20, 18, 3)).astype(np.float32) for _ in range(2))
    u8 = rng.integers(0, 256, (2, 9, 7, 3), np.uint8)
    pairs += [(scorers.l1_distance(T(x), T(y)), jscorers.l1_distance(x, y)),
              (scorers.l1_distance(T(u8), T(u8[::-1].copy())), jscorers.l1_distance(u8, u8[::-1])),
              (scorers.ssim(T(x), T(y)), jscorers.ssim(x, y)),
              (scorers.ssim(T(x[0]), T(x[0] * 0.9 + 0.05)), jscorers.ssim(x[0], x[0] * 0.9 + 0.05))]
    for got, ref in pairs:
        assert tuple(got.shape) == tuple(np.shape(ref))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for s1, s2 in [("Hello, World!", "hello world"), ("abc", "abd"), ("", ""), ("!!", "??")]:
        assert scorers.ocr_text_match(s1, s2) == jscorers.ocr_text_match(s1, s2)


def test_aesthetic_mlp_matches():
    """The MLP through the bridge at 1e-4; its keys are the released
    Sequential's, which convert.py's `convert_aesthetic` reads back."""
    p = aesthetic_params()
    m = scorers.AestheticMLP(16)
    m.load_state_dict(bridge.aesthetic_state_dict(p), strict=True)
    x = _emb(np.random.default_rng(6), 4, 16)
    ref = np.asarray(jscorers.AestheticMLP().apply(p, x))
    np.testing.assert_allclose(m(T(x)).detach().numpy(), ref, atol=1e-4, rtol=0)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert_aesthetic(p, sd), p)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.aesthetic_tree(m.state_dict(), p), p)


def test_clip_text_model_matches():
    """CLIPTextModel (tower + projection, L2-normed) at 1e-4."""
    p = text_proj_params()
    m = tclip.CLIPTextModel(PORT_TEXT, proj_dim=16)
    m.load_state_dict(bridge.clip_text_proj_state_dict(p), strict=True)
    ids = np.random.default_rng(7).integers(1, 30522, (2, 77)).astype(np.int32)
    ref = np.asarray(jclip.CLIPTextModel(JAX_TEXT, proj_dim=16).apply(p, ids))
    np.testing.assert_allclose(m(T(ids).long()).detach().numpy(), ref, atol=1e-4, rtol=0)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.clip_text_proj_tree(m.state_dict(), p), p)


@pytest.mark.parametrize("branch", ["clip", "eva"])
def test_vision_encoder_matches(branch):
    """Both branches of CLIPVisionEncoder through the bridge: tokens and the
    second output (projected L2-normed embedding, or the post-LN class
    token) at 1e-4. The state dict carries the HF names that convert.py's
    `convert_clip_vision` / `convert_eva_vit` read, and reads back into the
    same tree."""
    jcfg, pcfg = (JAX_VISION, PORT_VISION) if branch == "clip" else (JAX_EVA, PORT_EVA)
    to_sd, to_tree, convert = {
        "clip": (bridge.clip_vision_state_dict, bridge.clip_vision_tree, convert_clip_vision),
        "eva": (bridge.eva_vit_state_dict, bridge.eva_vit_tree, convert_eva_vit)}[branch]
    p = vision_params(jcfg, 33)
    m = tclip.CLIPVisionEncoder(pcfg)
    m.load_state_dict(to_sd(p), strict=True)
    px = np.random.default_rng(8).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jclip.CLIPVisionEncoder(jcfg).apply(p, px)
    got = m(T(px))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-4, rtol=0)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert(p, sd), p)
    jax.tree_util.tree_map(np.testing.assert_array_equal, to_tree(m.state_dict(), p), p)


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """The JAX zoo reading the shared params as checkpoints, and the port's
    tiny zoo given them through the bridge."""
    params = {"clip_vision": vision_params(JAX_VISION, 34),
              "clip_text_proj": text_proj_params(35), "aesthetic": aesthetic_params(36)}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jzoo = JaxModelZoo(JaxZooConfig(canvas=cfg.canvas, text=JAX_TEXT, vision=JAX_VISION),
                       weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


@pytest.mark.parametrize("shape", [(48, 40, 3), (20, 64, 3)])
def test_clip_towers_match(zoo_pair, shape):
    """`clip_image` (resize, ImageNet normalisation, tower) and `clip_text`
    against the JAX zoo's at 1e-4, unit norm."""
    jzoo, zoo = zoo_pair
    img = np.random.default_rng(shape[1]).integers(0, 256, shape, np.uint8)
    (ji, jt), (ti, tt) = jzoo.clip_towers(), zoo.clip_towers()
    for got, ref in ((ti(img), ji(img)), (tt("a red square"), jt("a red square"))):
        assert tuple(got.shape) == (1, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(got.norm()), 1.0, atol=1e-5)


def test_aesthetic_fn_matches(zoo_pair):
    jzoo, zoo = zoo_pair
    assert abs(zoo.aesthetic_fn()(IMG) - jzoo.aesthetic_fn()(IMG)) <= 1e-4
