"""The zoo's LCM branch in the PyTorch port against the JAX zoo's:
`ModelZoo(ZooConfig(lcm_steps=2)).ip2p()` on the tiny IP2P slot (its UNet
cut to one level: the JAX slot's compile is most of this file's time), the
same seeded trees on both sides (msgpacks for the JAX zoo, the bridge for
the port), JAX's draws handed to the port: uint8 within 1 level.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from anyedit_tpu.cli import tiny_zoo_config as jax_tiny
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_bridge import JAX_TEXT, JAX_VAE, text_params, vae_params
from test_torch_train import JAX_UNET1, PORT_UNET1, unet1_params

torch.set_num_threads(1)
T = torch.from_numpy


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """The JAX tiny IP2P slot with lcm_steps=2 (the trees as msgpacks) and
    the port's, on the same trees."""
    wdir = tmp_path_factory.mktemp("lcm_weights")
    params = {"unet_ip2p": unet1_params(), "vae": vae_params(), "clip_text": text_params()}
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    jzoo = JaxModelZoo(JaxZooConfig(canvas=jax_tiny().canvas, ip2p_unet=JAX_UNET1,
                                    vae=JAX_VAE, text=JAX_TEXT, lcm_steps=2),
                       weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(dataclasses.replace(tiny_zoo_config(), ip2p_unet=PORT_UNET1,
                                              lcm_steps=2), device="cpu", params=params)


@pytest.mark.parametrize("masked", [False, True])
def test_zoo_lcm_branch_matches(zoo_pair, masked):
    """`ModelZoo(ZooConfig(lcm_steps=2)).ip2p()` against the JAX zoo's LCM
    branch on a 48x40 image, JAX's draws (the sampler's key is key(seed))
    handed to the port: uint8 within 1 level; the port's UNet called once a
    step at one row; `.batch` equal to `edit`. The masked edit composites
    once at x0."""
    jzoo, zoo = zoo_pair
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    mask = None
    if masked:
        mask = np.zeros((48, 40), np.float32)
        mask[10:30, 5:25] = 1.0
    ref = jzoo.ip2p()(img, "make it blue", mask, steps=3, seed=0)
    k_init, k = jax.random.split(jax.random.key(0))
    shape = (1, 32, 32, 4)
    init = T(np.array(jax.random.normal(k_init, shape)))
    _, k2 = jax.random.split(k)
    renoise = T(np.array(jax.random.normal(k2, shape)))[None]
    unet = zoo._ip2p_core()[0]
    rows = []
    handle = unet.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[0]))
    out = zoo.ip2p()(img, "make it blue", mask, steps=3, init_latents=init, renoise=renoise)
    handle.remove()
    assert rows == [1, 1]
    diff = np.abs(out.astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert out.shape == img.shape and diff.max() <= 1, diff.max()
    batch = zoo.ip2p().batch([img], ["make it blue"], [mask], seeds=[0],
                             init_latents=init, renoise=renoise)
    np.testing.assert_array_equal(batch[0], out)
