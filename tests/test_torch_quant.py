"""The W8A8 int8 mode of the PyTorch port against the JAX package's
(`anyedit_tpu/ops/quant.py`, `UNetConfig.quant`, `ZooConfig.quant_ip2p`).

Inputs are drawn with numpy and handed to both sides. Quantization itself
(scales, int8 codes) must be bit-equal. Where a quantized layer's input is
computed by two frameworks, an fp32 rounding difference can move an
activation across a rounding boundary and flip one int8 code; each
tolerance below says how far such flips may carry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.ops import quant as jq
from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet
from anyedit_tpu_torch.ops import quant as tq
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import JAX_UNET, PORT_UNET, unet_params

torch.set_num_threads(1)
T = torch.from_numpy


def _jax_quant_tree(float_tree):
    """The JAX package's W8A8 tree for the tiny IP2P UNet (quantize_params)."""
    qunet = UNet2DCondition(dataclasses.replace(JAX_UNET, quant=True))
    shapes = jax.eval_shape(lambda: qunet.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, JAX_UNET.context_dim))))
    return {"params": jq.quantize_params(shapes["params"], float_tree["params"])}


@pytest.fixture(scope="module")
def trees():
    ftree = unet_params()
    return ftree, _jax_quant_tree(ftree)


def test_quantize_functions_bit_equal():
    """absmax_scale (whole tensor, per row, per sample), quantize_int8 and
    quantize_kernel (HWIO with out_dim=-1, and the port's OIHW) give the
    JAX functions' scales and codes exactly."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 6, 24)) * 3).astype(np.float32)
    for jax_axis, dim in ((None, None), (-1, -1), ((1, 2, 3), (1, 2, 3))):
        js = jq.absmax_scale(jnp.asarray(x), axis=jax_axis)
        ts = tq.absmax_scale(T(x), dim)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tq.quantize_int8(T(x), ts).numpy(),
                                      np.asarray(jq.quantize_int8(jnp.asarray(x), js)))
    w = (rng.standard_normal((3, 3, 24, 16)) * 0.05).astype(np.float32)   # HWIO
    jk, js = jq.quantize_kernel(jnp.asarray(w))
    for kq, ks in (tq.quantize_kernel(T(w), out_dim=-1),
                   (lambda a, b: (a.permute(2, 3, 1, 0), b))(
                       *tq.quantize_kernel(T(w.transpose(3, 2, 0, 1).copy())))):
        assert kq.dtype == torch.int8 and ks.dtype == torch.float32
        np.testing.assert_array_equal(kq.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ks.numpy(), np.asarray(js))


def test_quant_dense_and_conv_match_jax():
    """QuantDense and QuantConv (3x3 stride 1 and 2, 1x1) in fp32 on the
    same int8 weights and inputs: the activation codes are the same, so the
    only difference is fp32 order in the dequant epilogue; atol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 64)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(64) * 0.01).astype(np.float32)
    kq, ks = jq.quantize_kernel(jnp.asarray(w))
    ref = jq.QuantDense(64, dtype=jnp.float32).apply(
        {"params": {"kernel_q": kq, "kernel_scale": ks, "bias": jnp.asarray(b)}},
        jnp.asarray(x))
    dense = tq.QuantDense(96, 64, dtype=torch.float32)
    dense.load_state_dict({"weight": T(np.asarray(kq).T.copy()),
                           "kernel_scale": T(np.array(ks)), "bias": T(b)})
    np.testing.assert_allclose(dense(T(x)).numpy(), np.asarray(ref), atol=1e-5, rtol=0)

    xi = rng.standard_normal((2, 8, 8, 24)).astype(np.float32)         # NHWC
    for ksz, stride in ((3, 1), (3, 2), (1, 1)):
        w = (rng.standard_normal((ksz, ksz, 24, 16)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(16) * 0.01).astype(np.float32)
        kq, ks = jq.quantize_kernel(jnp.asarray(w))
        pad = ((ksz // 2,) * 2,) * 2
        ref = jq.QuantConv(16, (ksz, ksz), stride, pad, dtype=jnp.float32).apply(
            {"params": {"kernel_q": kq, "kernel_scale": ks, "bias": jnp.asarray(b)}},
            jnp.asarray(xi))
        conv = tq.QuantConv(24, 16, ksz, stride, ksz // 2, dtype=torch.float32)
        conv.load_state_dict({"weight": T(np.asarray(kq).transpose(3, 2, 0, 1).copy()),
                              "kernel_scale": T(np.array(ks)), "bias": T(b)})
        out = conv(T(xi.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_int8_contractions_are_exact():
    """The int32 contraction (float64 on the CPU) equals an int64 sum at
    full-range codes where fp32 would round (sums past 2^24)."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (20, 4096)).astype(np.int8)
    b = rng.integers(-127, 128, (4096, 16)).astype(np.int8)
    got = tq.int8_matmul(T(a), T(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    x = rng.integers(-127, 128, (2, 8, 5, 6)).astype(np.int8)
    w = rng.integers(-127, 128, (4, 8, 3, 3)).astype(np.int8)
    got = tq.int8_conv2d(T(x), T(w), stride=2, padding=1)
    want = torch.nn.functional.conv2d(T(x).double(), T(w).double(), stride=2, padding=1)
    np.testing.assert_array_equal(got.numpy(), want.permute(0, 2, 3, 1).numpy())


def test_quantize_state_dict_matches_bridged_quantize_params(trees):
    """quantize_state_dict of the bridged float UNet gives exactly the int8
    codes, scales and float leaves of the bridged JAX quantize_params tree."""
    ftree, qtree = trees
    qunet = TUNet(dataclasses.replace(PORT_UNET, quant=True))
    got = tq.quantize_state_dict(qunet, bridge.unet_state_dict(ftree, 2))
    want = bridge.unet_state_dict(qtree, 2)
    assert set(got) == set(want) == set(qunet.state_dict())
    n_int8 = 0
    for key, w in want.items():
        assert got[key].dtype == qunet.state_dict()[key].dtype, key
        if w.dtype == torch.int8:
            n_int8 += 1
        np.testing.assert_array_equal(got[key].numpy(), w.to(got[key].dtype).numpy(),
                                      err_msg=key)
    assert n_int8 == sum(k.endswith(".kernel_scale") for k in want) > 0


def test_quantize_state_dict_fails_loudly_on_mismatch(trees):
    """A wrong pairing raises KeyError (test_quant.py:263): a foreign dict,
    a missing key, or a wrong shape."""
    qunet = TUNet(dataclasses.replace(PORT_UNET, quant=True))
    with pytest.raises(KeyError):
        tq.quantize_state_dict(qunet, {"wrong": torch.zeros(1)})
    sd = bridge.unet_state_dict(trees[0], 2)
    key = "down_blocks.0.resnets.0.conv1.weight"
    with pytest.raises(KeyError):
        tq.quantize_state_dict(qunet, {k: v for k, v in sd.items() if k != key})
    with pytest.raises(KeyError):
        tq.quantize_state_dict(qunet, {**sd, key: sd[key][:, :-1]})


def test_quant_unet_matches_jax(trees):
    """TINY_UNET with quant=True against the JAX quant UNet on the same W8A8
    tree, fp32: relative L2 <= 0.1 and cosine >= 0.995. The port's GroupNorm
    differs from JAX's by 1e-6 (fp32 order), which flips one activation code
    of 98,304 at the first proj_in; attention spreads that flip over the
    image, and the measured distance at the output is 0.039 (cosine 0.9992).
    The int8-vs-float drift, for scale, is a cosine > 0.95 (test_quant.py:81),
    which the port's quant UNet must also meet against its float UNet."""
    ftree, qtree = trees
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 32, 32, 8)).astype(np.float32)
    t = np.array([981, 501, 1], np.int32)
    ctx = rng.standard_normal((3, 77, 32)).astype(np.float32)
    qcfg = dataclasses.replace(JAX_UNET, quant=True)
    ref = jax.jit(lambda p, x, t, c: UNet2DCondition(qcfg).apply(p, x, t, c))(
        qtree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = np.asarray(ref)
    qunet = TUNet(dataclasses.replace(PORT_UNET, quant=True))
    qunet.load_state_dict(bridge.unet_state_dict(qtree, 2), strict=True)
    funet = TUNet(PORT_UNET)
    funet.load_state_dict(bridge.unet_state_dict(ftree, 2), strict=True)
    with torch.no_grad():
        out = qunet(T(x), T(t).long(), T(ctx)).numpy()
        flt = funet(T(x), T(t).long(), T(ctx)).numpy()
    assert np.isfinite(out).all()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    cos_ref = float((out * ref).sum() / (np.linalg.norm(out) * np.linalg.norm(ref)))
    assert rel <= 0.1 and cos_ref >= 0.995, (rel, cos_ref)
    cos = float((out * flt).sum() / (np.linalg.norm(out) * np.linalg.norm(flt)))
    assert cos > 0.95, cos


def test_zoo_quant_ip2p_edit_matches_jax(trees, tmp_path):
    """`ZooConfig(quant_ip2p=True)` quantizes the float UNet at slot build
    in both zoos. The tiny edit (3 steps, JAX's noise draws injected) must
    agree with the JAX zoo's in uint8 within a mean |diff| < 16, the JAX
    package's own bound on int8 drift between two int8 runs
    (test_quant.py:236). Measured: mean 5.5, max 32 levels. A flipped
    activation code (see `test_quant_unet_matches_jax`) is amplified by the
    guidance (s_txt 8) over the steps; in fp32 the float slot
    agrees within 1 level (test_torch_slice.py)."""
    from anyedit_tpu.cli import tiny_zoo_config as jax_tiny
    from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
    from anyedit_tpu.weights.convert import save_params
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
    from test_torch_bridge import text_params, vae_params

    params = {"unet_ip2p": trees[0], "vae": vae_params(), "clip_text": text_params()}
    for name, tree in params.items():
        save_params(tree, tmp_path / f"{name}.msgpack")
    full = jax_tiny()
    jcfg = JaxZooConfig(canvas=full.canvas, ip2p_unet=full.ip2p_unet, vae=full.vae,
                        text=full.text, quant_ip2p=True)
    jzoo = JaxModelZoo(jcfg, weights_dir=tmp_path, allow_fallback_tokenizers=True)
    zoo = ModelZoo(dataclasses.replace(tiny_zoo_config(), quant_ip2p=True),
                   device="cpu", params=params)
    unet, _ = zoo._ip2p_core()
    assert unet.cfg.quant and unet.down_blocks[0].resnets[0].conv1.weight.dtype == torch.int8

    img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), np.uint8)
    ref = np.asarray(jzoo.ip2p()(img, "make it blue", None, steps=3, seed=0))
    key = jax.random.key(0)
    shape = (1, 32, 32, 4)
    init = T(np.array(jax.random.normal(key, shape, jnp.float32)))
    renoise = T(np.array(jax.random.normal(jax.random.fold_in(key, 1), shape,
                                           jnp.float32)))
    out = zoo.ip2p()(img, "make it blue", None, steps=3, init_latents=init,
                     renoise=renoise)
    assert out.shape == img.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() < 16, (diff.mean(), diff.max())
