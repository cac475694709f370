"""The SDXL refine stack of the PyTorch port against the JAX package:
TINY_XL_UNET with its micro-conditioning (pooled text and time ids), with
and without ControlNet residuals; the ControlNet with its zero convs and
hint projection drawn live (zero at the seeded init: an exact no-op);
`cross_attn_sites` and `ip_adapter_processor`; `sample_img2img` with and
without a mask at strengths 0.5, 0.6 and 0.98, with JAX's `normal(key)` and
`normal(fold_in(key, 1))` handed in; `canny` and `rgb_to_gray`; and the
bridge slots `unet_refine`, `controlnet_*`, `ip_proj` and `ip_adapter`.

Tolerances: the UNet, the ControlNet and the processor in fp32 within
max-abs 1e-4; the sampler's latents within 1e-4; the Canny edge maps equal
on at least 99.9 % of the pixels (the gradient angle's bins and the
thresholds may flip on a float's last digit); the bridges exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.diffusion.sampling import sample_img2img as jax_img2img
from anyedit_tpu.models import ip_adapter as jip
from anyedit_tpu.models import unet_sd as junet
from anyedit_tpu.models.controlnet import ControlNet as JaxControlNet
from anyedit_tpu.models.layers import AttnMeta as JaxMeta
from anyedit_tpu.ops import canny as jcanny
from anyedit_tpu.schedulers import make_noise_schedule as jax_schedule
from anyedit_tpu.weights.convert import (
    convert_image_projection, convert_ip_adapter_weights, convert_unet_sdxl,
)
from anyedit_tpu_torch.diffusion.sampling import sample_img2img
from anyedit_tpu_torch.models import ip_adapter as ip
from anyedit_tpu_torch.models import unet_sd as tunet
from anyedit_tpu_torch.models.controlnet import ControlNet
from anyedit_tpu_torch.models.layers import AttnMeta
from anyedit_tpu_torch.ops.canny import canny, rgb_to_gray
from anyedit_tpu_torch.ops.quant import QuantTokenProj, quantize_kernel
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.init import seeded_init_
from test_torch_bridge import F32, TF32, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
# the tiny zoo's refine UNet: CLIP-L (32) + CLIP-G (16) = 48 context channels
JAX_XL = dataclasses.replace(junet.TINY_XL_UNET, context_dim=48, **F32)
PORT_XL = dataclasses.replace(tunet.TINY_XL_UNET, context_dim=48, **TF32)
HW, B, LT, NT = 16, 2, 7, 4      # latent side, batch, text tokens, image tokens
ATOL = 1e-4
EMB = 24                         # the image embedding's width


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)    # noqa: E731
    tid = np.array([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]] * B, np.float32)
    return (f(B, HW, HW, 4), np.array([500, 20], np.int32), f(B, LT, 48), f(B, 16), tid)


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def models():
    """JAX trees and the port's modules on them: the XL UNet, a ControlNet
    (every leaf drawn, so its zero convs are live), the IP-Adapter."""
    x, t, ctx, pooled, tid = _inputs()
    args = (x, t, ctx)
    hint = np.zeros((B, HW * 8, HW * 8, 3), np.float32)
    ju, jc = junet.UNet2DCondition(JAX_XL), JaxControlNet(JAX_XL)
    utree = random_flax_params(ju, args + (None, None, None, None, pooled, tid), 90)
    ctree = random_flax_params(jc, args + (hint, pooled, tid), 91)
    names, dims = jip.cross_attn_sites(JAX_XL)
    jproj = jip.ImageProjection(num_tokens=NT, context_dim=48)
    ptree = random_flax_params(jproj, (np.zeros((1, EMB), np.float32),), 92)
    jw = jip.IPAdapterWeights(names, dims, 48)
    wtree = random_flax_params(jw, (np.zeros((1, NT, 48), np.float32),), 93)
    unet = tunet.UNet2DCondition(PORT_XL)
    unet.load_state_dict(bridge.unet_state_dict(utree, 2, True))
    cn = ControlNet(PORT_XL, 3)
    cn.load_state_dict(bridge.controlnet_state_dict(ctree, 2, True))
    pnames, pdims = ip.cross_attn_sites(PORT_XL)
    proj = ip.ImageProjection(EMB, NT, 48)
    proj.load_state_dict(bridge.ip_proj_state_dict(ptree))
    ipw = ip.IPAdapterWeights(pnames, pdims, 48)
    ipw.load_state_dict(bridge.ip_adapter_state_dict(wtree, names))
    return dict(ju=ju, jc=jc, utree=utree, ctree=ctree, jproj=jproj, ptree=ptree, jw=jw,
                wtree=wtree, names=names, unet=unet.eval(), cn=cn.eval(), proj=proj,
                ipw=ipw)


def _hint(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (B, HW * 8, HW * 8, 3)).astype(np.float32)


# ---- the UNet and the ControlNet ----------------------------------------------------

@pytest.mark.parametrize("with_cn", [False, True])
def test_xl_unet_matches(models, with_cn):
    """TINY_XL_UNET's forward with pooled text and time ids (the time ids
    embedded at width 256 and projected with the pooled text into the time
    channel), without ControlNet residuals and with random ones (one per
    skip, and the mid residual), within 1e-4."""
    x, t, ctx, pooled, tid = _inputs(2)
    kw, tkw = {}, {}
    if with_cn:
        rng = np.random.default_rng(3)
        skips = [(B, HW, HW, 32)] * 2 + [(B, HW // 2, HW // 2, 32)] + [(B, HW // 2, HW // 2, 64)]
        res = [rng.standard_normal(s).astype(np.float32) for s in skips]
        mid = rng.standard_normal((B, HW // 2, HW // 2, 64)).astype(np.float32)
        kw = dict(controlnet_residuals=res, controlnet_mid=mid)
        tkw = dict(controlnet_residuals=[T(r) for r in res], controlnet_mid=T(mid))
    ref = models["ju"].apply(models["utree"], x, t, ctx, pooled_text=pooled, time_ids=tid, **kw)
    with torch.no_grad():
        got = models["unet"](T(x), T(t), T(ctx), pooled_text=T(pooled), time_ids=T(tid), **tkw)
    _close(got, ref)
    if with_cn:    # the residuals reach the output
        with torch.no_grad():
            plain = models["unet"](T(x), T(t), T(ctx), pooled_text=T(pooled), time_ids=T(tid))
        assert (plain - got).abs().max() > 1e-2


def test_xl_unet_needs_micro_conditioning(models):
    x, t, ctx, _, _ = _inputs()
    with pytest.raises(ValueError, match="pooled_text and time_ids"):
        models["unet"](T(x), T(t), T(ctx))


def test_controlnet_matches(models):
    """The ControlNet with live zero convs: every skip residual and the mid
    residual within 1e-4, in the UNet's push order and NHWC."""
    x, t, ctx, pooled, tid = _inputs(4)
    hint = _hint()
    res_j, mid_j = models["jc"].apply(models["ctree"], x, t, ctx, hint, pooled_text=pooled,
                                      time_ids=tid)
    with torch.no_grad():
        res, mid = models["cn"](T(x), T(t), T(ctx), T(hint), pooled_text=T(pooled),
                                time_ids=T(tid))
    assert len(res) == len(res_j) == 4
    for a, b in zip(res, res_j):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    _close(mid, mid_j)
    assert max(float(r.abs().max()) for r in res) > 1e-2       # live


def test_controlnet_seeded_init_is_a_noop():
    """At the seeded init the zero convs and the hint projection are zero, so
    every residual is exactly 0, as an untrained JAX ControlNet's."""
    cn = seeded_init_(ControlNet(PORT_XL, 3), 0).eval()
    x, t, ctx, pooled, tid = _inputs(5)
    with torch.no_grad():
        res, mid = cn(T(x), T(t), T(ctx), T(_hint()), pooled_text=T(pooled), time_ids=T(tid))
    assert all(float(r.abs().max()) == 0.0 for r in res) and float(mid.abs().max()) == 0.0
    assert not cn.controlnet_cond_embedding.conv_out.weight.detach().any()


def test_w8a8_token_proj_is_the_1x1_conv():
    """`QuantTokenProj` (SDXL's proj_in / proj_out in the Linear layout, W8A8)
    equals the JAX package's W8A8 1x1 conv: one activation scale a sample."""
    from anyedit_tpu.ops.quant import QuantConv as JaxQuantConv
    from anyedit_tpu.ops.quant import quantize_params
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 24)) / 4).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    jm = JaxQuantConv(24, (1, 1), 1, "VALID", dtype=jnp.float32)
    jtree = quantize_params(jax.eval_shape(lambda: jm.init(jax.random.key(0), x)),
                            {"params": {"kernel": w[None, None], "bias": b}})
    ref = jm.apply(jtree, x)
    m = QuantTokenProj(16, 24, dtype=torch.float32)
    jp = jtree["params"]
    m.load_state_dict({"weight": T(np.array(jp["kernel_q"])[0, 0].T.copy()),
                       "kernel_scale": T(np.array(jp["kernel_scale"])),
                       "bias": T(np.array(jp["bias"]))})
    q, _ = quantize_kernel(T(w.T.copy()))
    assert torch.equal(q, m.weight)
    got = m(T(x).reshape(2, 16, 16)).reshape(2, 4, 4, 24)
    _close(got, ref, 1e-5)


# ---- IP-Adapter ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SDXL_UNET", "TINY_XL_UNET", "SD15_UNET"])
def test_cross_attn_sites_match(name):
    """Site names and inner widths, in the JAX package's order (down, mid,
    up): SDXL's 70 sites, the tiny XL's, SD1.5's."""
    got = ip.cross_attn_sites(getattr(tunet, name))
    assert got == jip.cross_attn_sites(getattr(junet, name))
    if name == "SDXL_UNET":
        assert len(got[0]) == 70 and got[0][24] == "mid.tf.tb0.cross"


def test_ip_adapter_processor_matches(models):
    """The processor alone (a self site: text attention only; a cross site
    of the dict: plus the image attention at scale 0.6; a cross site not in
    it), then the XL UNet under it with the image K/V of ImageProjection and
    IPAdapterWeights, within 1e-4."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, 2, 9, 8)).astype(np.float32) for _ in range(3))
    kv = {"s.cross": tuple(rng.standard_normal((B, NT, 16)).astype(np.float32)
                           for _ in range(2))}
    jp = jip.ip_adapter_processor({n: tuple(jnp.asarray(a) for a in v_) for n, v_ in kv.items()},
                                  0.6)
    tp = ip.ip_adapter_processor({n: tuple(T(a) for a in v_) for n, v_ in kv.items()}, 0.6)
    for tag, is_self in (("s.self", True), ("s.cross", False), ("o.cross", False)):
        _close(tp(T(q), T(k), T(v), AttnMeta(tag, is_self, 2, 8)),
               jp(q, k, v, JaxMeta(tag, is_self, 2, 8), None))

    emb = rng.standard_normal((1, EMB)).astype(np.float32)
    tok_j = models["jproj"].apply(models["ptree"], emb)
    kv_j = models["jw"].apply(models["wtree"], jnp.concatenate([tok_j, 0 * tok_j]))
    with torch.no_grad():
        tok = models["proj"](T(emb))
        _close(tok, tok_j)
        kv_t = models["ipw"](torch.cat([tok, 0 * tok]))
    assert list(kv_t) == list(models["names"])
    x, t, ctx, pooled, tid = _inputs(8)
    ref = models["ju"].apply(models["utree"], x, t, ctx, processor=jip.ip_adapter_processor(kv_j),
                             pooled_text=pooled, time_ids=tid)
    with torch.no_grad():
        got = models["unet"](T(x), T(t), T(ctx), processor=ip.ip_adapter_processor(kv_t),
                             pooled_text=T(pooled), time_ids=T(tid))
    _close(got, ref)


# ---- sample_img2img --------------------------------------------------------------------

def _eps(mod, w):
    """A cheap deterministic eps_fn of (x, t, context), the same on both sides."""
    def eps(x, t, c):
        return mod.tanh(x * w + t[:, None, None, None] / 1000.0
                        + c.mean(axis=(1, 2))[:, None, None, None])
    return eps


@pytest.mark.parametrize("strength", [0.5, 0.6, 0.98])
@pytest.mark.parametrize("masked", [False, True])
def test_sample_img2img_matches(strength, masked):
    """30 steps: the start at i0 = 30 - round(30 * strength) (0.98 runs 29
    steps, Python's round of 29.4), the 2-way CFG in the order [cond,
    uncond], and with a mask the composite against the original re-noised
    to the next timestep (the clean original after the last step): the
    latents within 1e-4 of JAX's with its two noise draws handed in."""
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, 5, 6)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(1, 8, 8, 1)) > 0.5).astype(np.float32) if masked else None
    key = jax.random.key(13)
    ref = jax_img2img(_eps(jnp, 0.7), jax_schedule(), lat, cond, uncond, key, num_steps=30,
                      strength=strength, guidance_scale=7.5,
                      mask=None if mask is None else jnp.asarray(mask))
    noise = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    renoise = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), lat.shape, jnp.float32))
    calls = []

    def eps(x, t, c):
        calls.append(int(t[0]))
        return _eps(torch, 0.7)(x, t, c)
    got = sample_img2img(eps, make_noise_schedule(), T(lat), T(cond), T(uncond), num_steps=30,
                         strength=strength, guidance_scale=7.5,
                         mask=None if mask is None else T(mask), noise=T(noise),
                         renoise=T(renoise))
    _close(got, ref)
    assert len(calls) == {0.5: 15, 0.6: 18, 0.98: 29}[strength]


def test_sample_img2img_draws_no_noise():
    """The noise is an input, never drawn: a call without `noise` is refused,
    and so is a masked call without `renoise`."""
    lat, ctx = torch.zeros(1, 8, 8, 4), torch.zeros(1, 5, 6)
    args = (_eps(torch, 0.7), make_noise_schedule(), lat, ctx, ctx)
    with pytest.raises(TypeError, match="noise"):
        sample_img2img(*args, num_steps=4)
    with pytest.raises(ValueError, match="needs renoise"):
        sample_img2img(*args, num_steps=4, mask=torch.ones(1, 8, 8, 1), noise=lat)


# ---- canny --------------------------------------------------------------------------

def _scene(seed, hw=(72, 88)):
    """A seeded image with edges: smoothed noise, a dark and a bright
    rectangle, and a disc."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, hw + (3,)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, img)
    img[10:40, 15:50] = rng.integers(0, 60, 3)
    img[45:70, 40:80] = rng.integers(190, 256, 3)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    img[(yy - 30) ** 2 + (xx - 65) ** 2 < 12 ** 2] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canny_matches(seed):
    """`canny(rgb_to_gray(image))` on seeded images: the grey values within
    1e-4, the edge maps ({0, 255} uint8) equal on at least 99.9 % of the
    pixels, with edges present."""
    img = _scene(seed)
    gray_j = jcanny.rgb_to_gray(jnp.asarray(img))
    gray = rgb_to_gray(T(img))
    _close(gray, gray_j)
    ref = np.asarray(jcanny.canny(gray_j))
    got = canny(gray).numpy()
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert (ref == 255).mean() > 0.01
    assert (got != ref).mean() <= 1e-3, (got != ref).mean()


# ---- the bridge slots ----------------------------------------------------------------

def _same_tree(a, b):
    fa, fb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


def test_unet_refine_bridge_round_trips(models):
    """`unet_refine`: the port's state dict (diffusers names, proj_in /
    proj_out as (out, in) Linears, `add_embedding`) read back by the JAX
    package's `convert_unet_sdxl` and by `unet_tree` gives the tree back."""
    sd = bridge.unet_state_dict(models["utree"], 2, True)
    assert sd["down_blocks.1.attentions.0.proj_in.weight"].shape == (64, 64)
    assert "add_embedding.linear_1.weight" in sd
    _same_tree(convert_unet_sdxl(models["utree"], {k: v.numpy() for k, v in sd.items()},
                                 n_levels=2), models["utree"])
    _same_tree(bridge.unet_tree(sd, models["utree"], 2, True), models["utree"])


def test_controlnet_bridge_round_trips(models):
    """`controlnet_canny` / `controlnet_depth`: diffusers ControlNetModel
    names (the hint encoder as controlnet_cond_embedding.{conv_in, blocks.i,
    conv_out}, the zero convs as controlnet_down_blocks.i and
    controlnet_mid_block), the port module's keys exactly, and back."""
    sd = bridge.controlnet_state_dict(models["ctree"], 2, True)
    assert set(sd) == set(models["cn"].state_dict())
    for k in ("controlnet_cond_embedding.conv_in.weight",
              "controlnet_cond_embedding.blocks.5.weight",
              "controlnet_cond_embedding.conv_out.weight", "controlnet_down_blocks.3.weight",
              "controlnet_mid_block.weight", "add_embedding.linear_2.weight"):
        assert k in sd, k
    _same_tree(bridge.controlnet_tree(sd, models["ctree"], 2, True), models["ctree"])


def test_ip_adapter_bridges_round_trip(models):
    """`ip_proj` and `ip_adapter`: the checkpoint's `image_proj` and
    `ip_adapter` groups (`{2 i + 1}.to_k_ip.weight` for site i), read back
    by `convert_image_projection` / `convert_ip_adapter_weights`."""
    psd = {k: v.numpy() for k, v in bridge.ip_proj_state_dict(models["ptree"]).items()}
    _same_tree(convert_image_projection(models["ptree"], {"image_proj": psd}), models["ptree"])
    wsd = {k: v.numpy() for k, v in
           bridge.ip_adapter_state_dict(models["wtree"], models["names"]).items()}
    assert "1.to_k_ip.weight" in wsd and f"{2 * len(models['names']) - 1}.to_v_ip.weight" in wsd
    _same_tree(convert_ip_adapter_weights(models["wtree"], {"ip_adapter": wsd},
                                          models["names"]), models["wtree"])
    _same_tree(bridge.ip_adapter_tree(bridge.ip_adapter_state_dict(models["wtree"],
                                                                   models["names"]),
                                      models["wtree"], models["names"]), models["wtree"])
