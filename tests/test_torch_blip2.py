"""BLIP-2 in the PyTorch port against the JAX package: T5's relative-position
buckets, the T5 encoder and decoder, the Q-Former, `Blip2VQA` through the
weight bridge, and the zoo's `vqa_fn()` against the JAX zoo's on the same
weights.

The JAX tiny Q-Former and T5 compute in bf16; both sides run them in fp32
here. Tolerances: buckets equal as integers; hidden states and logits
1e-4 (fp32, outputs of unit scale); the yes/no answers equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models import blip2 as jblip2
from anyedit_tpu.models import t5 as jt5
from anyedit_tpu.models.clip import CLIPVisionEncoder as JaxVision
from anyedit_tpu.ops.resize import imagenet_normalize, resize_image
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import convert_blip2, save_params
from anyedit_tpu_torch.models import blip2, t5
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, TF32, random_flax_params
from test_torch_scorers import JAX_VISION, vision_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_T5 = dataclasses.replace(jt5.TINY_T5, **F32)
JAX_QF = dataclasses.replace(jblip2.TINY_QFORMER, lm=JAX_T5, **F32)
PORT_T5 = dataclasses.replace(t5.TINY_T5, **TF32)
PORT_QF = dataclasses.replace(blip2.TINY_QFORMER, lm=PORT_T5, **TF32)
TOWER = 32   # the tiny tower's width, not TINY_QFORMER.image_dim (16)
RNG = np.random.default_rng(41)
IDS = RNG.integers(1, 64, (2, 9)).astype(np.int32)
IDS[1, 6:] = 0
MASK = IDS != 0
TOKENS = RNG.standard_normal((2, 17, TOWER)).astype(np.float32)


def _close(got, ref, atol=1e-4):
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_dist", [(32, 128), (8, 20)])
def test_rel_pos_bucket_matches(bidirectional, buckets, max_dist):
    """Integer-equal for every rel in [-300, 300]."""
    rel = np.arange(-300, 301, dtype=np.int32)[None]
    ref = np.asarray(jt5.rel_pos_bucket(jnp.asarray(rel), bidirectional, buckets, max_dist))
    got = t5.rel_pos_bucket(T(rel), bidirectional, buckets, max_dist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_buckets_cached_in_inference_mode_serve_autograd():
    """The bucket table is cached across calls: one first made under
    `torch.inference_mode` (as the zoo's `vqa_fn` runs) still serves a
    later forward that autograd tracks, with the same output."""
    attn = t5.T5Attention(PORT_T5, has_rel_bias=True)
    x = T(RNG.standard_normal((1, 11, PORT_T5.dim)).astype(np.float32))
    t5._buckets.cache_clear()
    with torch.inference_mode():
        ref, _ = attn(x)
    got, _ = attn(x)
    assert got.requires_grad
    np.testing.assert_array_equal(got.detach().numpy(), ref.numpy())


@pytest.fixture(scope="module")
def t5_params():
    enc = random_flax_params(jt5.T5Encoder(JAX_T5), (IDS, MASK), 42)
    dec = random_flax_params(jt5.T5Decoder(JAX_T5),
                             (IDS[:, :3], jnp.zeros((2, 9, 32)), MASK), 43)
    return enc, dec


def test_t5_encoder_matches(t5_params):
    p = t5_params[0]
    m = t5.T5Encoder(PORT_T5)
    m.load_state_dict(bridge.t5_state_dict(p), strict=True)
    _close(m(T(IDS).long(), T(MASK)), jt5.T5Encoder(JAX_T5).apply(p, IDS, MASK))


def test_t5_decoder_matches(t5_params):
    """Four decoder steps (causal self-attention, its unidirectional
    buckets) over masked encoder states: logits at 1e-4."""
    p = t5_params[1]
    m = t5.T5Decoder(PORT_T5)
    m.load_state_dict(bridge.t5_state_dict(p, decoder=True), strict=True)
    enc = RNG.standard_normal((2, 9, 32)).astype(np.float32)
    ids = IDS[:, :4]
    _close(m(T(ids).long(), T(enc), T(MASK)), jt5.T5Decoder(JAX_T5).apply(p, ids, enc, MASK))


def test_qformer_matches():
    """The Q-Former fed a tower 32 wide, not its config's image_dim of 16."""
    p = random_flax_params(jblip2.QFormer(JAX_QF), (TOKENS,), 44)
    m = blip2.QFormer(PORT_QF, image_dim=TOWER)
    m.load_state_dict(bridge.qformer_state_dict(p), strict=True)
    _close(m(T(TOKENS)), jblip2.QFormer(JAX_QF).apply(p, TOKENS))


def blip2_params(seed=45):
    return random_flax_params(jblip2.Blip2VQA(JAX_QF), (TOKENS, IDS, MASK), seed)


def test_blip2_vqa_matches():
    """First-step logits at 1e-4 and the same yes/no answers; the state dict
    reads back into the tree, and (with the two T5 embeddings tied, as in
    the checkpoint) convert.py's `convert_blip2` reads it too."""
    p = blip2_params()
    lm = p["params"]
    lm["decoder"]["emb"]["embedding"] = lm["encoder"]["emb"]["embedding"]
    m = blip2.Blip2VQA(PORT_QF, image_dim=TOWER)
    m.load_state_dict(bridge.blip2_state_dict(p), strict=True)
    ref = jblip2.Blip2VQA(JAX_QF).apply(p, TOKENS, IDS, MASK)
    got = m(T(TOKENS), T(IDS).long(), T(MASK))
    _close(got, ref)
    for yes, no in ((3, 5), (10, 2)):
        np.testing.assert_array_equal(blip2.yes_no(got, yes, no).numpy(),
                                      np.asarray(jblip2.yes_no(ref, yes, no)))
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    sd["language_model.shared.weight"] = sd["language_model.encoder.embed_tokens.weight"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert_blip2(p, sd), p)
    jax.tree_util.tree_map(np.testing.assert_array_equal, bridge.blip2_tree(m.state_dict(), p), p)


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    params = {"eva_vit": vision_params(JAX_VISION, 46), "blip2": blip2_params(47)}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, eva=JAX_VISION, qformer=JAX_QF,
                        flux_text=dataclasses.replace(JAX_T5, vocab_size=30522))
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params), params


QUESTIONS = ["Is the color of red square close to blue?",
             "Is the background of this image similar to a beach?", "yes or no"]


@pytest.mark.parametrize("question", QUESTIONS)
def test_vqa_fn_matches(zoo_pair, question):
    """The zoo's answer equals the JAX zoo's, and its first-step logits
    equal the JAX models' on the JAX zoo's inputs (the hash ids modulo
    30522 then 64, masked at 0) at 1e-4."""
    jzoo, zoo, params = zoo_pair
    img = np.random.default_rng(len(question)).integers(0, 256, (48, 40, 3), np.uint8)
    px = resize_image(jnp.asarray(img, jnp.float32) / 255.0, 32, 32, "bilinear")
    toks, _ = JaxVision(JAX_VISION).apply(params["eva_vit"], imagenet_normalize(px)[None])
    ids = jzoo._t5_ids(question, 32) % 64
    ref = jblip2.Blip2VQA(JAX_QF).apply(params["blip2"], toks, ids, ids != 0)
    ask = zoo.vqa_fn()
    _close(ask.logits(img, question), ref)
    yes, no = (int(jzoo._ids(w, 3, 64)[0, 1]) for w in ("yes", "no"))
    answer = bool(ref[0, yes] > ref[0, no])
    assert ask(img, question) == jzoo.vqa_fn()(img, question) == answer
