"""The IP2P editor slice of the PyTorch port against the JAX package.

The same seeded Flax parameters go to both sides (the JAX zoo reads them as
msgpack checkpoints, the port through the weight bridge), and the noise is
JAX's own draws handed to the port. Tolerances: final latents of
`ip2p_edit` max-abs 1e-3; the zoo's uint8 output within 1 level on every
pixel.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.diffusion import ip2p as jip2p
from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.schedulers import make_noise_schedule as jax_schedule
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.diffusion import ip2p as tip2p
from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import (
    JAX_TEXT, JAX_UNET, JAX_VAE, PORT_UNET, text_params, unet_params, vae_params,
)

torch.set_num_threads(1)
T = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return {"unet_ip2p": unet_params(), "vae": vae_params(),
            "clip_text": text_params()}


def test_port_imports_no_jax():
    """Importing the port and every submodule loads neither jax, flax nor
    anyedit_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import anyedit_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'anyedit_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'anyedit_tpu_torch.runtime.zoo' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("masked", [False, True])
def test_ip2p_edit_matches(params, masked):
    """`ip2p_edit` with 3 DDIM steps on the tiny 8-channel UNet, JAX's start
    latents and re-noise draws handed to the port: max-abs 1e-3."""
    rng = np.random.default_rng(6)
    img_lat = (rng.standard_normal((1, 32, 32, 4)) * 0.5).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, 77, 32)).astype(np.float32)
                    for _ in range(2))
    mask = None
    if masked:
        mask = np.zeros((1, 32, 32, 1), np.float32)
        mask[:, 8:24, 4:20] = 1.0
    key = jax.random.key(3)
    init = np.array(jax.random.normal(key, img_lat.shape, jnp.float32))
    renoise = np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                         img_lat.shape, jnp.float32))
    unet = UNet2DCondition(JAX_UNET)
    p = params["unet_ip2p"]
    ref = jip2p.ip2p_edit(lambda x, t, c: unet.apply(p, x, t, c), jax_schedule(),
                          jnp.asarray(img_lat), jnp.asarray(cond),
                          jnp.asarray(uncond), key, num_steps=3,
                          mask=None if mask is None else jnp.asarray(mask),
                          init_latents=jnp.asarray(init))
    tunet = TUNet(PORT_UNET)
    tunet.load_state_dict(bridge.unet_state_dict(p, 2), strict=True)
    with torch.no_grad():
        out = tip2p.ip2p_edit(tunet, make_noise_schedule(), T(img_lat), T(cond),
                              T(uncond), num_steps=3,
                              mask=None if mask is None else T(mask),
                              init_latents=T(init), renoise=T(renoise))
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-3


def test_noise_diff_heatmap_and_edit_mask_match():
    """The heatmap's batching and noise level, and the IQR-normalised soft
    mask (percentiles with linear interpolation), on a closed-form eps_fn."""
    rng = np.random.default_rng(8)
    img_lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond, uncond = (rng.standard_normal((2, 5, 6)).astype(np.float32)
                    for _ in range(2))

    def eps(x, t, c, lib):
        w = lib.mean(c, axis=(1, 2)) if lib is jnp else c.mean(dim=(1, 2))
        return x[..., :4] * w[:, None, None, None] + x[..., 4:] * 0.3 \
            + t[:, None, None, None] * 1e-3

    key = jax.random.key(5)
    jnoise = np.array(jax.random.normal(key, img_lat.shape, jnp.float32))
    ref = jip2p.noise_diff_heatmap(lambda x, t, c: eps(x, t, c, jnp), jax_schedule(),
                                   jnp.asarray(img_lat), jnp.asarray(cond),
                                   jnp.asarray(uncond), key)
    out = tip2p.noise_diff_heatmap(lambda x, t, c: eps(x, t, c, torch),
                                   make_noise_schedule(), T(img_lat), T(cond),
                                   T(uncond), noise=T(jnoise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    heat = rng.random((2, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(tip2p.predict_edit_mask(T(heat)).numpy(),
                               np.asarray(jip2p.predict_edit_mask(jnp.asarray(heat))),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def zoo_pair(params, tmp_path_factory):
    """The JAX tiny zoo (reading the shared params as its checkpoints) and
    the port's tiny zoo (the same params through the bridge)."""
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    from anyedit_tpu.cli import tiny_zoo_config as jax_tiny
    full = jax_tiny()
    jcfg = JaxZooConfig(canvas=full.canvas, ip2p_unet=full.ip2p_unet,
                        vae=full.vae, text=full.text)
    assert (jcfg.ip2p_unet, jcfg.vae, jcfg.text) == (JAX_UNET, JAX_VAE, JAX_TEXT)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(tiny_zoo_config(), params=params)


def test_zoo_ip2p_slot_matches(zoo_pair):
    """`ModelZoo(tiny_zoo_config()).ip2p()` vs the JAX slot on a 48x40 uint8
    image, 3 steps, JAX's noise draws injected: uint8 output within 1 level
    on every pixel. (Masked compositing is held in `test_ip2p_edit_matches`;
    a masked zoo edit would cost the JAX side a second loop compile.)"""
    jzoo, zoo = zoo_pair
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    ref = jzoo.ip2p()(img, "make it blue", None, steps=3, seed=0)
    key = jax.random.key(0)
    shape = (1, 32, 32, 4)
    init = T(np.array(jax.random.normal(key, shape, jnp.float32)))
    renoise = T(np.array(jax.random.normal(jax.random.fold_in(key, 1), shape,
                                           jnp.float32)))
    out = zoo.ip2p()(img, "make it blue", None, steps=3, init_latents=init,
                     renoise=renoise)
    assert out.shape == img.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1, diff.max()
