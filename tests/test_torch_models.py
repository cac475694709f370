"""Modules of the PyTorch port against the JAX package's, in fp32.

Parameters are seeded Flax trees carried across by the weight bridge;
inputs are drawn with numpy. Tolerances: layers, the text tower and the
schedulers 1e-4; the tiny UNet and VAE 1e-3 (deeper stacks; the port's
level-0 self-attention takes K1's max-free softmax where JAX on the CPU
takes its XLA softmax); tokenizers and the DDIM grid exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models import layers as jlayers
from anyedit_tpu.models.clip import CLIPTextEncoder
from anyedit_tpu.models.clip_tokenizer import ClipBPETokenizer, SimpleClipTokenizer
from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.models.vae import AutoencoderKL
from anyedit_tpu import schedulers as jsched
from anyedit_tpu.schedulers.common import spaced_timesteps as jspaced
from anyedit_tpu_torch import schedulers as tsched
from anyedit_tpu_torch.models import clip_tokenizer as ttok
from anyedit_tpu_torch.models import layers as tlayers
from anyedit_tpu_torch.models.clip import CLIPTextEncoder as TCLIPTextEncoder
from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet
from anyedit_tpu_torch.models.vae import AutoencoderKL as TVAE
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import (
    JAX_TEXT, JAX_UNET, JAX_VAE, PORT_TEXT, PORT_UNET, PORT_VAE,
    random_flax_params, text_params, unet_params, vae_params,
)

torch.set_num_threads(1)
T = torch.from_numpy


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out.detach()), np.asarray(ref),
                               atol=tol, rtol=tol)


def _dense(p):
    """A Flax Dense param dict -> an nn.Linear state dict."""
    sd = {"weight": T(np.asarray(p["kernel"]).T.copy())}
    if "bias" in p:
        sd["bias"] = T(np.asarray(p["bias"]))
    return sd


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


# ---- layers -------------------------------------------------------------

def test_multihead_attention_and_processor_slot():
    """Projections, the (b, l, H, d) -> (b, H, l, d) head split, and the
    processor slot: a custom processor sees the same q/k/v and meta."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 12)).astype(np.float32)
    jm = jlayers.MultiHeadAttention(2, 8, 16, "blk.cross", False, dtype=jnp.float32)
    params = random_flax_params(jm, (jnp.asarray(x), jnp.asarray(ctx)), 0)
    tm = tlayers.MultiHeadAttention(16, 2, 8, 16, "blk.cross", False, context_dim=12,
                                    dtype=torch.float32)
    p = params["params"]
    sd = {}
    for name in ("to_q", "to_k", "to_v"):
        sd.update(_prefixed(name, _dense(p[name])))
    sd.update(_prefixed("to_out.0", _dense(p["to_out"])))
    tm.load_state_dict(sd, strict=True)

    seen = {}

    def jproc(q, k, v, meta, extra):
        return jlayers.attention_op(q, k, v) * extra["s"]

    def tproc(q, k, v, meta, extra):
        seen["meta"], seen["shape"] = meta, tuple(q.shape)
        return tlayers.attention_op(q, k, v) * extra["s"]

    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx), jproc, {"s": 2.0})
    out = tm(T(x), T(ctx), tproc, {"s": 2.0})
    _close(out, ref, 1e-4)
    assert seen["shape"] == (2, 2, 10, 8)
    assert seen["meta"] == tlayers.AttnMeta("blk.cross", False, 2, 8)
    _close(tm(T(x), T(ctx)), jm.apply(params, jnp.asarray(x), jnp.asarray(ctx)), 1e-4)


def test_layernorm_feedforward_timestep_embedding():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 16)) * 4 + 7).astype(np.float32)
    ln = jlayers.LayerNorm(dtype=jnp.float32)
    lp = random_flax_params(ln, (jnp.asarray(x),), 1)
    tln = tlayers.LayerNorm(16, dtype=torch.float32)
    tln.load_state_dict({"weight": T(np.asarray(lp["params"]["scale"])),
                         "bias": T(np.asarray(lp["params"]["bias"]))})
    _close(tln(T(x)), ln.apply(lp, jnp.asarray(x)), 1e-4)

    ff = jlayers.FeedForward(dtype=jnp.float32)
    fp = random_flax_params(ff, (jnp.asarray(x),), 2)["params"]
    tff = tlayers.FeedForward(16, dtype=torch.float32)
    tff.load_state_dict({**_prefixed("net.0.proj", _dense(fp["GEGLU_0"]["Dense_0"])),
                         **_prefixed("net.2", _dense(fp["Dense_0"]))}, strict=True)
    _close(tff(T(x)), ff.apply({"params": fp}, jnp.asarray(x)), 1e-4)

    t = np.array([0, 1, 500, 999], np.int32)
    for dim in (32, 33):
        _close(tlayers.timestep_embedding(T(t), dim),
               jlayers.timestep_embedding(jnp.asarray(t), dim), 1e-4)


# ---- schedulers ---------------------------------------------------------

@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear",
                                           "squaredcos_cap_v2"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_noise_schedules_and_pred_x0_match(beta_schedule, prediction_type):
    jns = jsched.make_noise_schedule(beta_schedule=beta_schedule,
                                     prediction_type=prediction_type)
    tns = tsched.make_noise_schedule(beta_schedule=beta_schedule,
                                     prediction_type=prediction_type)
    _close(tns.alphas_cumprod, jns.alphas_cumprod, 1e-4)
    rng = np.random.default_rng(2)
    out, sample = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
                   for _ in range(2))
    t = np.array([10, 900], np.int32)
    for got, want in zip(tsched.pred_x0(tns, T(out), T(sample), T(t).long()),
                         jsched.pred_x0(jns, jnp.asarray(out), jnp.asarray(sample),
                                        jnp.asarray(t))):
        _close(got, want, 1e-4)


def test_schedulers_match():
    """Noise schedule, DDIM grid (identical), DDIM step and inversion, add_noise."""
    jns, tns = jsched.make_noise_schedule(), tsched.make_noise_schedule()
    for style in ("leading", "trailing"):
        np.testing.assert_array_equal(
            tsched.spaced_timesteps(1000, 50, style).numpy(),
            np.asarray(jspaced(1000, 50, style)))
    for steps in (3, 50, 100):
        jst, tst = jsched.ddim_init(jns, steps), tsched.ddim_init(tns, steps)
        np.testing.assert_array_equal(tst.timesteps.numpy(), np.asarray(jst.timesteps))
        _close(tst.alphas_cumprod_prev, jst.alphas_cumprod_prev, 1e-4)
    rng = np.random.default_rng(3)
    sample, eps, noise = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
                          for _ in range(3))
    for i in (0, 1, 2):
        _close(tsched.ddim_step(tns, tst, i, T(eps), T(sample)),
               jsched.ddim_step(jns, jst, i, jnp.asarray(eps), jnp.asarray(sample)),
               1e-4)
        _close(tsched.ddim_inversion_step(tns, tst, i, T(eps), T(sample)),
               jsched.ddim_inversion_step(jns, jst, i, jnp.asarray(eps),
                                          jnp.asarray(sample)), 1e-4)
    t = np.array([1, 999], np.int32)
    _close(tsched.add_noise(tns, T(sample), T(noise), T(t).long()),
           jsched.add_noise(jns, jnp.asarray(sample), jnp.asarray(noise),
                            jnp.asarray(t)), 1e-4)


# ---- text tower and tokenizers -----------------------------------------

def test_clip_text_tower_matches():
    """TINY_TEXT at the tiny zoo's vocab 30522 / max_len 77: hidden, pooled
    (at the first argmax id) and penult, 1e-4."""
    params = text_params()
    toks = SimpleClipTokenizer(30522).encode("make the sky purple")
    ids = np.full((1, 77), toks[-1], np.int32)    # EOT-padded, as the zoo does
    ids[0, :len(toks)] = toks
    ref = CLIPTextEncoder(JAX_TEXT).apply(params, jnp.asarray(ids))
    te = TCLIPTextEncoder(PORT_TEXT)
    te.load_state_dict(bridge.clip_text_state_dict(params), strict=True)
    out = te(T(ids).long())
    for o, r in zip(out, ref):
        _close(o, r, 1e-4)


def _merges_file(tmp_path):
    p = tmp_path / "clip_merges.txt"
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
              ("s", "k"), ("sk", "y</w>"), ("b", "l")]
    p.write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    return p


@pytest.mark.parametrize("text", ["hello sky", "Make the SKY blue!", "a.b 42 it's",
                                  "", "  héllo  wörld  "])
def test_tokenizers_give_identical_ids(tmp_path, text):
    bpe_j, bpe_t = (ClipBPETokenizer(_merges_file(tmp_path)),
                    ttok.ClipBPETokenizer(_merges_file(tmp_path)))
    assert bpe_t.encode(text) == bpe_j.encode(text)
    for vocab in (49408, 30522):
        assert ttok.SimpleClipTokenizer(vocab).encode(text) == \
            SimpleClipTokenizer(vocab).encode(text)


# ---- UNet and VAE -------------------------------------------------------

@pytest.mark.parametrize("controlnet", [False, True])
def test_tiny_unet_matches(controlnet):
    """TINY_UNET with 8 input channels at 32x32 latents (level-0
    self-attention has 1024 tokens: K1's route in the port): 1e-3. With
    ControlNet residuals on every skip and on the mid block, too."""
    params = unet_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 32, 32, 8)).astype(np.float32)
    t = np.array([981, 501, 1], np.int32)
    ctx = rng.standard_normal((3, 77, 32)).astype(np.float32)
    kw, tkw = {}, {}
    if controlnet:
        skips = [(32, 32, 32), (32, 32, 32), (16, 16, 32), (16, 16, 64)]
        res = [(0.1 * rng.standard_normal((3,) + s)).astype(np.float32) for s in skips]
        mid = (0.1 * rng.standard_normal((3, 16, 16, 64))).astype(np.float32)
        kw = dict(controlnet_residuals=[jnp.asarray(r) for r in res],
                  controlnet_mid=jnp.asarray(mid))
        tkw = dict(controlnet_residuals=[T(r) for r in res], controlnet_mid=T(mid))
    jit_apply = jax.jit(lambda p, x, t, c, kw: UNet2DCondition(JAX_UNET).apply(
        p, x, t, c, **kw))
    ref = jit_apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), kw)
    unet = TUNet(PORT_UNET)
    unet.load_state_dict(bridge.unet_state_dict(params, 2), strict=True)
    with torch.no_grad():
        out = unet(T(x), T(t).long(), T(ctx), **tkw)
    assert out.dtype == torch.float32 and out.shape == (3, 32, 32, 4)
    _close(out, ref, 1e-3)


def test_tiny_unet_through_flash_processor_matches():
    """TINY_UNET with a processor that calls `attention(use_flash=True)` at
    every site (K3's route; its plain version on the CPU), against the JAX
    UNet with the same processor in interpret mode (the Pallas kernel), at
    16x16 latents: 1e-4 in fp32, both sides' softmax being fp32."""
    from anyedit_tpu.ops.attention import attention as jax_attention
    params = unet_params()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16, 16, 8)).astype(np.float32)
    t = np.array([981, 501, 1], np.int32)
    ctx = rng.standard_normal((3, 77, 32)).astype(np.float32)

    def jproc(q, k, v, meta, extra):
        return jax_attention(q, k, v, use_flash=True, interpret=True)
    calls = []

    def tproc(q, k, v, meta, extra):
        calls.append(meta.name)
        return tlayers.attention_op(q, k, v, use_flash=True)
    ref = jax.jit(lambda p, x, t, c: UNet2DCondition(JAX_UNET).apply(
        p, x, t, c, jproc))(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    unet = TUNet(PORT_UNET)
    unet.load_state_dict(bridge.unet_state_dict(params, 2), strict=True)
    with torch.no_grad():
        out = unet(T(x), T(t).long(), T(ctx), processor=tproc)
    assert len(calls) == 2 * 4       # self + cross at down_0.tf_0, mid.tf, up_0.tf_0/1
    _close(out, ref, 1e-4)


def test_tiny_vae_encode_decode_match():
    """TINY_VAE encode (mean, clipped logvar) and decode: 1e-3."""
    params = vae_params()
    rng = np.random.default_rng(5)
    px = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    jvae = AutoencoderKL(JAX_VAE)
    mean, logvar = jax.jit(lambda p, x: jvae.apply(p, x, method=AutoencoderKL.encode))(
        params, jnp.asarray(px))
    dec = jax.jit(lambda p, z: jvae.apply(p, z, method=AutoencoderKL.decode))(
        params, jnp.asarray(z))
    vae = TVAE(PORT_VAE)
    vae.load_state_dict(bridge.vae_state_dict(params, 2), strict=True)
    with torch.no_grad():
        tmean, tlogvar = vae.encode(T(px))
        tdec = vae.decode(T(z))
    _close(tmean, mean, 1e-3)
    _close(tlogvar, logvar, 1e-3)
    _close(tdec, dec, 1e-3)
