"""SD3-UltraEdit in the PyTorch port against the JAX package: the flow
sampler, the MMDiT (float and W8A8), the CLIP text tower with projection
(CLIP-bigG's layout), `ultraedit_edit`, the weight bridge's MMDiT, projected
CLIP, T5-XXL-encoder and SD3-VAE slots, the zoo's `ultraedit_fn()`, and
`appearance_alter` / `material_alter` on their UltraEdit route.

Every MMDiT here has non-zero modulation weights: the JAX MMDiT initializes
each adaLN Dense at zero, so that with seeded init every gate is 0 and the
block stack drops out of the output, which would let a broken block pass.
`random_flax_params` draws those kernels like every other (N(0, 1/fan_in)),
and `mmdit_params` checks they are non-zero. Noise is JAX's own draws handed
to the port.

Tolerances: the flow schedule and steps 1e-6; the MMDiT's velocity in fp32
1e-4 (also with `qk_norm` and three blocks, so the last block's text path
sits between two full ones); `ultraedit_edit`'s latents 1e-4, masked and
not; CLIP with projection (pooled and penultimate) 1e-4; the zoo slot and
the pipelines' uint8 frames within 1 level (fp32 drift through guidance 8);
masks equal. W8A8: the int8 codes and scales of the port's quantization of
the bridged float tree equal the bridged JAX `quantize_params` tree's; the
port's W8A8 MMDiT is held to the JAX W8A8 MMDiT within the JAX package's
own int8 bound (cosine > 0.95, `tests/test_quant.py:139-162`).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.diffusion.ultraedit import ultraedit_edit as jax_ultraedit_edit
from anyedit_tpu.edits.registry import get_pipeline as jax_get_pipeline
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models import mmdit as jmmdit
from anyedit_tpu.models.clip import CLIPTextEncoder as JaxTextEncoder
from anyedit_tpu.models.t5 import T5Encoder as JaxT5Encoder
from anyedit_tpu.models.vae import AutoencoderKL as JaxVAE
from anyedit_tpu.ops.quant import quantize_params
from anyedit_tpu.ops.resize import denormalize_to_u8 as jax_denormalize
from anyedit_tpu.ops.resize import resize_image as jax_resize
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.schedulers import flow as jflow
from anyedit_tpu.weights.convert import (
    convert_clip_text, convert_mmdit, convert_t5_encoder, convert_vae, save_params,
)
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.diffusion import ultraedit_edit
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.models import mmdit
from anyedit_tpu_torch.models.clip import CLIPTextEncoder
from anyedit_tpu_torch.models.t5 import T5Encoder
from anyedit_tpu_torch.models.vae import AutoencoderKL
from anyedit_tpu_torch.ops import quant as tq
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.schedulers import flow
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.init import seeded_init_
from test_torch_blip2 import JAX_T5
from test_torch_bridge import F32, JAX_TEXT, JAX_VAE, TF32, random_flax_params
from test_torch_gdino import JAX_GDINO, gdino_params
from test_torch_sam import JAX_SAM, sam_params

torch.set_num_threads(1)
T = torch.from_numpy
# the module (the package's `ops/__init__` exports the function `attention`)
jattention = importlib.import_module("anyedit_tpu.ops.attention")
# the JAX tiny zoo's UltraEdit fields (`anyedit_tpu/cli.py:57-68`)
JAX_MMDIT = dataclasses.replace(jmmdit.TINY_MMDIT, in_channels=9, out_channels=4,
                                context_dim=32, pooled_dim=48, max_hw=16, **F32)
JAX_TEXT_G = dataclasses.replace(JAX_TEXT, hidden=16, heads=2)
JAX_TEXT_SD3 = dataclasses.replace(JAX_TEXT, text_proj=JAX_TEXT.hidden)
JAX_FLUX_TEXT = dataclasses.replace(JAX_T5, vocab_size=30522)
# CLIP-bigG's layout at tiny width: exact GELU, projected pooled output
JAX_BIGG = dataclasses.replace(JAX_TEXT, hidden=16, heads=2, activation="gelu", text_proj=24)
IMG = np.random.default_rng(71).integers(0, 256, (48, 40, 3), np.uint8)
EDIT_STEPS = 3
MODS = ("img_mod", "txt_mod", "final_mod")


def _close(got, ref, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _mmdit_inputs(cfg, batch=2, hw=8, lt=7, seed=30):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, hw, hw, cfg.in_channels)).astype(np.float32),
            rng.uniform(0, 1000, batch).astype(np.float32),
            rng.standard_normal((batch, lt, cfg.context_dim)).astype(np.float32),
            rng.standard_normal((batch, cfg.pooled_dim)).astype(np.float32))


def mmdit_params(cfg, seed, hw=8):
    """Seeded numpy params for the JAX MMDiT; every adaLN kernel non-zero."""
    tree = random_flax_params(jmmdit.MMDiT(cfg), _mmdit_inputs(cfg, 1, hw), seed)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if any(getattr(k, "key", None) in MODS for k in path) and path[-1].key == "kernel":
            assert np.abs(np.asarray(leaf)).mean() > 1e-3
            n += 1
    assert n == 2 * cfg.depth + 1
    return tree


def _port_mmdit(tree, cfg):
    m = mmdit.MMDiT(cfg)
    m.load_state_dict(bridge.mmdit_state_dict(tree), strict=True)
    return m.eval()


def _port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return dataclasses.replace(mmdit.MMDiTConfig(**{**fields, **TF32}), **kw)


# ---- the flow sampler ------------------------------------------------------

@pytest.mark.parametrize("steps,kw", [(50, {}), (4, {"shift": 1.0}), (28, {"shift": 3.0}),
                                      (4, {"use_dynamic_shifting": True,
                                           "mu": jflow.flux_mu(4096)})])
def test_flow_scheduler_matches(steps, kw):
    """Timesteps and sigmas, one Euler step at each index (fp32 and bf16
    samples, cast back) and `flow_add_noise`: 1e-6."""
    st, ref = flow.flow_init(steps, **kw), jflow.flow_init(steps, **kw)
    _close(st.timesteps, ref.timesteps, 1e-6 * 1000)
    _close(st.sigmas, ref.sigmas, 1e-6)
    assert flow.flux_mu(1024) == jflow.flux_mu(1024)
    rng = np.random.default_rng(31)
    x, v, n = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(3))
    for i in range(steps):
        _close(flow.flow_step(st, i, T(v), T(x)), jflow.flow_step(ref, i, v, x), 1e-6)
        _close(flow.flow_add_noise(st, i, T(x), T(n)), jflow.flow_add_noise(ref, i, x, n), 1e-6)
    got = flow.flow_step(st, 1, T(v), T(x).bfloat16())
    want = jflow.flow_step(ref, 1, jnp.asarray(v), jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 1e-6)


# ---- the MMDiT ---------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
def test_mmdit_matches(qk_norm):
    """TINY_MMDIT at three blocks (the last block's text path, with its
    swapped (scale, shift) modulation, between full ones) in fp32 on perturbed
    modulations: velocity within 1e-4."""
    jcfg = dataclasses.replace(jmmdit.TINY_MMDIT, depth=3, qk_norm=qk_norm, **F32)
    tree = mmdit_params(jcfg, 32)
    args = _mmdit_inputs(jcfg)
    ref = jmmdit.MMDiT(jcfg).apply(tree, *args)
    with torch.no_grad():
        got = _port_mmdit(tree, _port_cfg(jcfg))(*(T(a) for a in args))
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    _close(got, ref, 1e-4)


def test_mmdit_blocks_move_the_output():
    """Every block reaches the output once the modulations are live: a
    change to one FFN weight of the first block, or to the last block's
    context modulation, moves the velocity. On the seeded init, whose
    modulations are zero as in the JAX package, neither does."""
    jcfg = dataclasses.replace(jmmdit.TINY_MMDIT, depth=3, **F32)
    cfg = _port_cfg(jcfg)
    args = [T(a) for a in _mmdit_inputs(cfg)]
    seeded = seeded_init_(mmdit.MMDiT(cfg), 0)
    for blk in seeded.transformer_blocks:
        assert float(blk.norm1.linear.weight.detach().abs().max()) == 0.0
    for m, live in ((_port_mmdit(mmdit_params(jcfg, 33), cfg), True), (seeded, False)):
        with torch.no_grad():
            base = m(*args)
            for p in (m.transformer_blocks[0].ff.net[2].weight,
                      m.transformer_blocks[-1].norm1_context.linear.weight):
                p.add_(0.05)
                moved = float((m(*args) - base).abs().max())
                p.sub_(0.05)
                assert (moved > 1e-3) if live else (moved == 0.0), (live, moved)


def test_mmdit_param_names_are_diffusers():
    """The port's MMDiT carries SD3Transformer2DModel's names and shapes."""
    sd = mmdit.MMDiT(_port_cfg(dataclasses.replace(jmmdit.TINY_MMDIT, depth=2, **F32))).state_dict()
    want = {"pos_embed.proj.weight": (32, 4, 2, 2), "pos_embed.pos_embed": (1, 64, 32),
            "context_embedder.weight": (32, 16),
            "time_text_embed.timestep_embedder.linear_1.weight": (32, 256),
            "time_text_embed.text_embedder.linear_1.weight": (32, 8),
            "transformer_blocks.0.norm1.linear.weight": (192, 32),
            "transformer_blocks.0.norm1_context.linear.weight": (192, 32),
            "transformer_blocks.1.norm1_context.linear.weight": (64, 32),
            "transformer_blocks.0.attn.to_add_out.weight": (32, 32),
            "transformer_blocks.0.ff_context.net.0.proj.weight": (128, 32),
            "transformer_blocks.1.attn.add_q_proj.weight": (32, 32),
            "transformer_blocks.1.ff.net.2.weight": (32, 128),
            "norm_out.linear.weight": (64, 32), "proj_out.weight": (16, 32)}
    for k, shape in want.items():
        assert tuple(sd[k].shape) == shape, k
    assert not any(k.startswith("transformer_blocks.1.") and ("to_add_out" in k
                                                              or "ff_context" in k) for k in sd)


# ---- the bridge -------------------------------------------------------------

def _flat_equal(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert np.asarray(y).dtype == np.asarray(x).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


def _t5_hf(sd):
    """The port's T5Stack keys -> HF T5EncoderModel's (`shared`, `encoder.`)."""
    return {("shared.weight" if k == "embed_tokens.weight" else f"encoder.{k}"): v
            for k, v in sd.items()}


IDS77 = np.zeros((1, 77), np.int32)
ROUND_TRIPS = {
    "mmdit": (lambda: mmdit_params(dataclasses.replace(jmmdit.TINY_MMDIT, depth=3,
                                                       qk_norm=True, **F32), 34),
              bridge.mmdit_state_dict, convert_mmdit, lambda sd: sd,
              lambda: mmdit.MMDiT(_port_cfg(dataclasses.replace(
                  jmmdit.TINY_MMDIT, depth=3, qk_norm=True, **F32)))),
    "clip_text_proj": (lambda: random_flax_params(JaxTextEncoder(JAX_BIGG), (IDS77,), 35),
                       bridge.clip_text_state_dict, convert_clip_text, lambda sd: sd,
                       lambda: CLIPTextEncoder(_clip_cfg(JAX_BIGG))),
    "t5_encoder": (lambda: random_flax_params(JaxT5Encoder(JAX_FLUX_TEXT), (IDS77,), 36),
                   bridge.t5_state_dict, convert_t5_encoder, _t5_hf,
                   lambda: T5Encoder(_t5_cfg(JAX_FLUX_TEXT))),
    "sd3_vae": (lambda: random_flax_params(
        JaxVAE(dataclasses.replace(JAX_VAE, latent_channels=16)),
        (np.zeros((1, 64, 64, 3), np.float32),), 37),
        lambda t: bridge.vae_state_dict(t, 2), lambda t, sd: convert_vae(t, sd, n_levels=2),
        lambda sd: sd, lambda: AutoencoderKL(dataclasses.replace(
            tiny_zoo_config().sd3_vae, latent_channels=16))),
}


def _clip_cfg(jcfg):
    from anyedit_tpu_torch.models.clip import CLIPTextConfig
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return CLIPTextConfig(**{**fields, **TF32})


def _t5_cfg(jcfg):
    from anyedit_tpu_torch.models.t5 import T5Config
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return T5Config(**{**fields, **TF32})


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_bridge_round_trips(name):
    """The bridged state dict loads strictly into the port's module, and fed
    (under the checkpoint's keys) through the JAX package's converter gives
    the Flax tree back bit for bit."""
    make_tree, to_sd, convert, to_ckpt, make_module = ROUND_TRIPS[name]
    tree = make_tree()
    sd = to_sd(tree)
    make_module().load_state_dict(sd, strict=True)
    _flat_equal(tree, convert(tree, {k: v.numpy() for k, v in to_ckpt(sd).items()}))


def _quant_trees(seed=38):
    jcfg = dataclasses.replace(jmmdit.TINY_MMDIT, depth=3, **F32)
    qm = jmmdit.MMDiT(dataclasses.replace(jcfg, quant=True))
    shapes = jax.eval_shape(lambda: qm.init(jax.random.key(0), *_mmdit_inputs(jcfg, 1)))
    ftree = mmdit_params(jcfg, seed)
    return jcfg, ftree, {"params": quantize_params(shapes["params"], ftree["params"])}


def test_mmdit_tree_round_trips_float_and_w8a8():
    """`mmdit_tree` carries the port's state dict back into the Flax tree,
    float or W8A8 (int8 kernels still int8), bit for bit."""
    jcfg, ftree, qtree = _quant_trees()
    m = _port_mmdit(ftree, _port_cfg(jcfg))
    _flat_equal(ftree, bridge.mmdit_tree(m.state_dict(), ftree))
    qm = mmdit.MMDiT(_port_cfg(jcfg, quant=True))
    qm.load_state_dict(bridge.mmdit_state_dict(qtree), strict=True)
    _flat_equal(qtree, bridge.mmdit_tree(qm.state_dict(), qtree))


def test_w8a8_mmdit_matches_jax():
    """The port's quantization of the bridged float MMDiT gives exactly the
    bridged JAX `quantize_params` tree (codes, scales, float leaves); the
    W8A8 MMDiT tracks the JAX W8A8 MMDiT and its own float MMDiT within the
    JAX package's int8 bound (cosine > 0.95)."""
    jcfg, ftree, qtree = _quant_trees()
    qm = mmdit.MMDiT(_port_cfg(jcfg, quant=True))
    got = tq.quantize_state_dict(qm, bridge.mmdit_state_dict(ftree))
    want = bridge.mmdit_state_dict(qtree)
    assert set(got) == set(want) == set(qm.state_dict())
    n_int8 = 0
    for key, w in want.items():
        n_int8 += w.dtype == torch.int8
        np.testing.assert_array_equal(got[key].numpy(), w.to(got[key].dtype).numpy(),
                                      err_msg=key)
    assert n_int8 == 3 * 12 - 3          # the last block has no text proj / FFN
    qm.load_state_dict(got, strict=True)
    args = _mmdit_inputs(jcfg)
    ref = np.asarray(jmmdit.MMDiT(dataclasses.replace(jcfg, quant=True)).apply(qtree, *args))
    with torch.no_grad():
        out = qm(*(T(a) for a in args)).numpy()
        flt = _port_mmdit(ftree, _port_cfg(jcfg))(*(T(a) for a in args)).numpy()

    def cos(a, b):
        return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert np.isfinite(out).all()
    assert cos(out, ref) > 0.95 and cos(out, flt) > 0.95, (cos(out, ref), cos(out, flt))


# ---- CLIP with projection ------------------------------------------------------

def test_clip_text_with_projection_matches():
    """CLIP-bigG's layout (exact GELU, `text_proj`): hidden, projected pooled
    and penultimate outputs within 1e-4."""
    tree = random_flax_params(JaxTextEncoder(JAX_BIGG), (IDS77,), 39)
    ids = np.random.default_rng(40).integers(1, 30000, (2, 77)).astype(np.int32)
    ids[0, 9] = 30521                                   # EOT at the first argmax
    ref = JaxTextEncoder(JAX_BIGG).apply(tree, ids)
    m = CLIPTextEncoder(_clip_cfg(JAX_BIGG))
    m.load_state_dict(bridge.clip_text_state_dict(tree), strict=True)
    with torch.no_grad():
        got = m(T(ids).long())
    assert got[1].shape == (2, 24)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


# ---- ultraedit_edit --------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_ultraedit_edit_matches(masked):
    """Three steps of the 3-way-CFG flow edit on the tiny UltraEdit MMDiT,
    JAX's start and re-noise draws handed to the port: latents within 1e-4."""
    tree = mmdit_params(JAX_MMDIT, 41, hw=16)
    rng = np.random.default_rng(42)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    cc, cu = (rng.standard_normal((1, 20, 32)).astype(np.float32) for _ in range(2))
    pc, pu = (rng.standard_normal((1, 48)).astype(np.float32) for _ in range(2))
    mask = (rng.random((1, 16, 16, 1)) < 0.5).astype(np.float32) if masked else None
    key = jax.random.key(7)
    jm = jmmdit.MMDiT(JAX_MMDIT)
    ref = jax_ultraedit_edit(lambda x, t, c, p: jm.apply(tree, x, t, c, p), lat, cc, pc, cu,
                             pu, key, num_steps=EDIT_STEPS, mask=mask)
    init = T(np.array(jax.random.normal(key, lat.shape, jnp.float32)))
    ren = T(np.array(jax.random.normal(jax.random.fold_in(key, 1), lat.shape, jnp.float32)))
    m = _port_mmdit(tree, _port_cfg(JAX_MMDIT))
    with torch.no_grad():
        got = ultraedit_edit(m, T(lat), T(cc), T(pc), T(cu), T(pu), num_steps=EDIT_STEPS,
                             mask=None if mask is None else T(mask), init_latents=init,
                             renoise=ren)
    assert float(np.abs(np.asarray(ref) - lat).max()) > 0.1
    _close(got, ref, 1e-4)


def test_ultraedit_edit_takes_its_noise():
    """The edit draws no noise itself: a masked edit without `renoise`
    raises, and an unmasked one ignores it."""
    z = torch.zeros(1, 4, 4, 2)
    ctx, pooled = torch.zeros(1, 3, 8), torch.zeros(1, 8)

    def v_fn(x, t, c, p):
        return x[..., :2] * 0.0 + 1.0
    with pytest.raises(ValueError, match="renoise"):
        ultraedit_edit(v_fn, z, ctx, pooled, ctx, pooled, init_latents=z, num_steps=2,
                       mask=torch.ones(1, 4, 4, 1))
    a = ultraedit_edit(v_fn, z, ctx, pooled, ctx, pooled, init_latents=z + 1.0, num_steps=2)
    b = ultraedit_edit(v_fn, z, ctx, pooled, ctx, pooled, init_latents=z + 1.0, num_steps=2,
                       renoise=torch.randn(1, 4, 4, 2))
    assert torch.equal(a, b) and float((a - 1.0).abs().max()) > 0.1


# ---- the zoo slot and the pipelines ---------------------------------------------

@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """Both tiny zoos on the same params: the grounder and UltraEdit's
    MMDiT, SD3 VAE, CLIP-L with projection, CLIP-G and T5.

    The JAX zoo takes its TPU attention route, where the VAE's 1,024-token
    mid attention is K1's max-free softmax (logits clamped at a base-2 80,
    `anyedit_tpu/ops/attention.py:147-150`), here in fp32 without the
    kernel's bf16 roundings: the arithmetic of the port's K1 plain version
    for fp32 inputs, which the port runs on every device. On the CPU the
    JAX package takes XLA's exact softmax there instead, and the two part
    once a logit passes the clamp: the tiny SD3 VAE's decode of the edited
    latents reaches a base-2 logit of 140 (outputs 0.67 apart at a scale of
    6.4; 8e-6 apart with the port on the exact softmax). ROADMAP queue 3,
    known deviations."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_on_tpu", lambda: True)
        mp.setattr(jattention, "_self_attn_flash", _k1_fp32)
        yield _zoo_pair(tmp_path_factory)


def _k1_fp32(q, k, v, scale):
    f32 = jnp.float32
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(f32) * (scale * 1.4426950408889634),
                   k.astype(f32))
    p = jnp.exp2(jnp.minimum(s, 80.0))
    out = jnp.einsum("bhqk,bhkd->bhqd", p, v.astype(f32))
    return (out / jnp.maximum(p.sum(-1, keepdims=True), 1e-30)).astype(q.dtype)


def _zoo_pair(tmp_path_factory):
    ids = (IDS77,)
    params = {"gdino": gdino_params(), "sam": sam_params(),
              "mmdit_ultraedit": mmdit_params(JAX_MMDIT, 43, hw=32),
              "sd3_vae": random_flax_params(JaxVAE(JAX_VAE), (np.zeros((1, 64, 64, 3)),), 44),
              "clip_text_sd3": random_flax_params(JaxTextEncoder(JAX_TEXT_SD3), ids, 45),
              "clip_text_g": random_flax_params(JaxTextEncoder(JAX_TEXT_G), ids, 46),
              "t5": random_flax_params(JaxT5Encoder(JAX_FLUX_TEXT), ids, 47)}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, gdino=JAX_GDINO, sam=JAX_SAM, sd3_vae=JAX_VAE,
                        text=JAX_TEXT, text_g=JAX_TEXT_G, flux_text=JAX_FLUX_TEXT,
                        mmdit=JAX_MMDIT, box_threshold=0.0)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


def _jax_noise(seed=0):
    """The start latents and re-noise draws of the JAX `ultraedit_fn` at `seed`."""
    key = jax.random.key(seed)
    shape = (1, 32, 32, 4)
    return (T(np.array(jax.random.normal(key, shape, jnp.float32))),
            T(np.array(jax.random.normal(jax.random.fold_in(key, 1), shape, jnp.float32))))


def _diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def test_sd3_conditioning_matches(zoo_pair):
    """The zoo's SD3 conditioning: the tiny CLIP-L (32) and CLIP-G (16)
    penultimate states cut to the T5 width (32) and followed by T5's 77
    states, in bf16; pooled 32 + 16 = 48, fp32. Within one bf16 rounding."""
    jzoo, zoo = zoo_pair
    text = "make the jacket leather"
    ctx, pooled = zoo.sd3_cond()(text)
    assert ctx.dtype == torch.bfloat16 and tuple(ctx.shape) == (1, 154, 32)
    assert tuple(pooled.shape) == (1, 48)
    _, pl, hl = jzoo._text_raw("clip_text_sd3", JAX_TEXT_SD3)(text)
    _, pg, hg = jzoo._text_raw("clip_text_g", JAX_TEXT_G)(text)
    want = np.concatenate([np.concatenate([hl, hg], -1)[..., :32], np.asarray(jzoo._t5()(text))], 1)
    _close(ctx.float(), want, 2 ** -7 * float(np.abs(want).max()))
    _close(pooled, np.concatenate([pl, pg], -1), 1e-4)


def _decoded_latents(monkeypatch, jzoo, zoo):
    """Record the latents each zoo hands its SD3 VAE decode: {"jax": [...],
    "port": [...]}, numpy."""
    seen = {"jax": [], "port": []}
    jdec, pdec = jzoo._from_latents, zoo._from_latents

    def jax_from(lat, dec, scaling, out_hw):
        seen["jax"].append(np.asarray(lat))
        return jdec(lat, dec, scaling, out_hw)

    def port_from(lat, hws, vae="vae"):
        seen["port"].append(lat.numpy())
        return pdec(lat, hws, vae)
    monkeypatch.setattr(jzoo, "_from_latents", jax_from)
    monkeypatch.setattr(zoo, "_from_latents", port_from)
    return seen


def _jax_frame(jzoo, lat, hw):
    """The JAX zoo's `_from_latents` on `lat` with its float -> uint8
    conversion saturating, and where that conversion is defined. The lanczos
    resize overshoots [0, 255] and `astype(jnp.uint8)` of an out-of-range
    float is left to XLA, which gave 255 for -6.19 in one frame
    (`anyedit_tpu/runtime/zoo.py:487-492`; ROADMAP queue 3); the port's
    `to_u8` saturates."""
    _, dec = jzoo._vae_named("sd3_vae", jzoo.cfg.sd3_vae)
    u8 = jax_denormalize(dec((jnp.asarray(lat) / jzoo.cfg.sd3_vae.scaling_factor)
                             .astype(jnp.bfloat16))[0])
    f = np.asarray(jax_resize(u8.astype(jnp.float32), *hw, "lanczos"))
    return np.clip(f, 0, 255).astype(np.uint8), (f >= 0) & (f < 256)


def _same_edit(jzoo, zoo, seen, got, ref):
    """The final latents within 1e-4; the JAX frame equal to its decode of
    those latents wherever its uint8 conversion is defined; the port's
    frame within 1 level of that decode, saturated. Both zoos round the
    latents to bf16 before the decode (`zoo.py:488`), so the port's frame
    is also held through the JAX latents: a 1e-5 difference can flip a bf16
    rounding, which the random tiny VAE spreads over the frame."""
    (jl,), (pl,) = seen["jax"], seen["port"]
    assert float(np.abs(jl).max()) > 1.0
    _close(pl, jl, 1e-4)
    frame, defined = _jax_frame(jzoo, jl, ref.shape[:2])
    np.testing.assert_array_equal(np.asarray(ref)[defined], frame[defined])
    assert got.dtype == np.uint8 and got.shape == ref.shape == IMG.shape
    assert _diff(zoo._from_latents(T(jl.copy()), [ref.shape[:2]], "sd3_vae")[0], frame) <= 1


@pytest.mark.parametrize("masked", [False, True])
def test_ultraedit_fn_matches(zoo_pair, monkeypatch, masked):
    """`ultraedit_fn()` on both tiny zoos (3 steps, JAX's noise at seed 0):
    the final latents within 1e-4, the frames through the same latents
    within 1 level, and the masked edit keeping the source's latents
    outside the mask."""
    jzoo, zoo = zoo_pair
    seen = _decoded_latents(monkeypatch, jzoo, zoo)
    mask = np.zeros(IMG.shape[:2], np.float32)
    mask[10:34, 6:30] = 1.0
    m = mask if masked else None
    init, ren = _jax_noise()
    ref = jzoo.ultraedit_fn()(IMG, "make it leather", m, steps=EDIT_STEPS)
    got = zoo.ultraedit_fn()(IMG, "make it leather", m, steps=EDIT_STEPS, init_latents=init,
                             renoise=ren)
    _same_edit(jzoo, zoo, seen, got, ref)
    if masked:
        keep = zoo._latent_mask(mask, 0.25)[..., 0].numpy() == 0
        src = zoo._to_latents([IMG], "sd3_vae")[0].numpy()
        assert keep.any() and (~keep).any()
        _close(seen["port"][0][0][keep], src[keep], 1e-6)


def _recording(edit, calls, **noise):
    def call(image, instruction, mask01, steps, s_txt, s_img):
        out = np.asarray(edit(image, instruction, mask01, steps=EDIT_STEPS, s_txt=s_txt,
                              s_img=s_img, **noise))
        calls.append(((steps, s_txt, s_img), out))
        return out
    return call


@pytest.mark.parametrize("edit_type", ["appearance_alter", "material_alter"])
def test_appearance_alter_through_ultraedit_matches(zoo_pair, monkeypatch, edit_type):
    """`install(tb, "ultraedit")` on both zoos: the record goes to
    `tb.extra["ultraedit"]` with 50 steps, 8.0 / 1.5 (not to the IP2P
    editor, which raises here); the same outcome and masks; the edit's
    latents and frame as in `test_ultraedit_fn_matches`; and the port's
    record within 1 level of the JAX pipeline given the port's edit."""
    jzoo, zoo = zoo_pair
    seen = _decoded_latents(monkeypatch, jzoo, zoo)
    calls = {"jax": [], "port": []}

    def no_ip2p(*a, **k):
        raise AssertionError("the IP2P fallback ran")
    jtb = JaxToolbox(ground=jzoo.grounder(), ip2p=no_ip2p)
    tb = Toolbox(ground=zoo.grounder(), ip2p=no_ip2p)
    jzoo.install(jtb, "ultraedit")
    zoo.install(tb, "ultraedit")
    init, ren = _jax_noise()
    jtb.extra["ultraedit"] = _recording(jtb.extra["ultraedit"], calls["jax"])
    tb.extra["ultraedit"] = _recording(tb.extra["ultraedit"], calls["port"],
                                       init_latents=init, renoise=ren)
    obj = {"edit": "make the jacket leather", "edited object": "red square",
           "input": "a red square", "output": "a leather square", "edit_type": edit_type}
    ref = jax_get_pipeline(edit_type)(jtb, JaxRecord.from_json(obj), IMG,
                                      np.random.default_rng(0))
    got = get_pipeline(edit_type)(tb, InstructionRecord.from_json(obj), IMG,
                                  np.random.default_rng(0))
    assert got.success and (got.success, got.reason) == (ref.success, ref.reason)
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]] == [(50, 8.0, 1.5)]
    np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))
    _same_edit(jzoo, zoo, seen, calls["port"][0][1], calls["jax"][0][1])
    jtb.extra["ultraedit"] = lambda *a, **k: calls["port"][0][1]
    same = jax_get_pipeline(edit_type)(jtb, JaxRecord.from_json(obj), IMG,
                                       np.random.default_rng(0))
    assert _diff(got.edited, same.edited) <= 1


def test_t5_ids_and_vqa_ids_unchanged():
    """The T5 hash ids (UltraEdit's 77, the VQA question's 32) are the JAX
    zoo's at the tiny and the production vocabularies: the modulus is
    `flux_text.vocab_size` in both packages."""
    q = "Is the color of car close to red? zebra quixotic"
    for port_cfg, jax_cfg in ((tiny_zoo_config(), JaxZooConfig(flux_text=JAX_FLUX_TEXT)),
                              (None, JaxZooConfig())):
        zoo = ModelZoo(port_cfg, device="cpu")
        jzoo = JaxModelZoo(jax_cfg, allow_fallback_tokenizers=True)
        assert zoo.cfg.flux_text.vocab_size == jax_cfg.flux_text.vocab_size
        for n in (32, 77):
            np.testing.assert_array_equal(zoo._t5_ids(q, n), jzoo._t5_ids(q, n))


def test_zoo_slot_shapes_and_quant_flag():
    """The production config's UltraEdit fields are the JAX zoo's
    (SD3_ULTRAEDIT, CLIP-bigG, T5-XXL, the SD3 VAE); `quant_diffusion`
    makes the tiny zoo's MMDiT W8A8; `install` names the slot."""
    from anyedit_tpu_torch.runtime.zoo import ZooConfig
    port, ref = ZooConfig(), JaxZooConfig()
    for name in ("mmdit", "text_g", "flux_text", "sd3_vae"):
        a, b = getattr(port, name), getattr(ref, name)
        for f in dataclasses.fields(a):
            if f.name != "dtype":
                assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
    zoo = ModelZoo(dataclasses.replace(tiny_zoo_config(), quant_diffusion=True), device="cpu")
    m = zoo._mmdit()
    assert m.cfg.quant and m.transformer_blocks[0].attn.to_q.weight.dtype == torch.int8
    assert m.transformer_blocks[0].norm1.linear.weight.dtype == torch.float32
    tb = Toolbox()
    ModelZoo(tiny_zoo_config(), device="cpu").install(tb, "ultraedit")
    assert callable(tb.extra["ultraedit"])


@pytest.mark.parametrize("grounding_batch", [0, 4])
def test_executors_route_appearance_through_ultraedit(tmp_path, zoo_pair, grounding_batch):
    """appearance_alter and material_alter records through both packages'
    `FactoryExecutor`, per record and in chunks of 4, on the tiny zoos'
    grounders with the UltraEdit slot installed (a stub editor in it on
    both sides, as `test_torch_executor.py` does, so that the frames are
    the same): every edit goes to the slot at 50 steps, 8.0 / 1.5, none to
    the IP2P editor; equal ledger statuses, stages, reasons and scores."""
    import json

    from anyedit_tpu.runtime import executor as jexecutor
    from anyedit_tpu_torch.runtime import executor

    def stub(calls):
        def edit(image, instruction, mask01, steps, s_txt, s_img):
            calls.append((steps, s_txt, s_img))
            return np.where(np.asarray(mask01)[..., None] > 0, 255 - image, image)
        return edit

    def no_ip2p(*a, **k):
        raise AssertionError("the IP2P editor ran")
    lines, calls = {}, {}
    for kind, zoo, tb_cls, rec_cls, ex_mod in (
            ("jax", zoo_pair[0], JaxToolbox, JaxRecord, jexecutor),
            ("port", zoo_pair[1], Toolbox, InstructionRecord, executor)):
        tb = tb_cls(ground=zoo.grounder(), ip2p=no_ip2p)
        calls[kind] = []
        tb.extra["ultraedit"] = stub(calls[kind])
        records = [rec_cls.from_json({
            "edit": f"make the square leather {i}", "edited object": "red square",
            "input": "a red square", "output": "a leather square", "edit_type": et,
            "image_file": f"img_{i}.jpg"})
            for i, et in enumerate(["appearance_alter", "material_alter"] * 2)]
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(tb, ex_mod.ExecutorConfig(
            output_root=str(root), grounding_batch=grounding_batch, run_pre_filter=False))
        ex.run(records, lambda r: IMG)
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    assert calls["port"] == calls["jax"] == [(50, 8.0, 1.5)] * 4
    for a, b in zip(lines["port"], lines["jax"], strict=True):
        assert (a["key"], a["status"]) == (b["key"], b["status"])
        for k in ("stage", "reason"):
            assert a["payload"].get(k) == b["payload"].get(k), k
        sa, sb = a["payload"].get("scores", {}), b["payload"].get("scores", {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k] == pytest.approx(sb[k], abs=1e-6) if isinstance(sa[k], float) \
                else sa[k] == sb[k], k
    assert len(lines["port"]) == 4
