"""`AnySDEditor.edit` of the PyTorch port against the JAX editor: the tiny
AnySD towers of both `train` commands (`_anysd_configs(True)`) on a
one-level cut of their UNet, seeded Flax trees on both sides through the
bridge, JAX's start latents `normal(key(seed))` handed to the port: uint8
within 1 level on every pixel.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from anyedit_tpu.cli import _anysd_configs as jax_configs
from anyedit_tpu.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from anyedit_tpu.models.clip_tokenizer import SimpleClipTokenizer
from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.models.vae import AutoencoderKL
from anyedit_tpu.train import anysd as janysd
from anyedit_tpu.train.frozen import FrozenEncoders as JaxFrozen
from anyedit_tpu.train.inference import AnySDEditor as JaxEditor
from anyedit_tpu_torch.cli import _anysd_configs
from anyedit_tpu_torch.train.anysd import AnySDTrainer
from anyedit_tpu_torch.train.frozen import load_frozen_encoders
from anyedit_tpu_torch.train.inference import AnySDEditor
from test_torch_bridge import random_flax_params

torch.set_num_threads(1)


def one_level(cfg):
    """The AnySD config on a one-level cut of its UNet (the JAX editor's
    compile is most of this file's time)."""
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, block_channels=cfg.unet.block_channels[:1], attn_levels=(True,)))


@functools.cache
def tiny_trees():
    """Seeded Flax trees of the tiny AnySD towers, UNet and adapter."""
    jcfg, text_cfg, vis_cfg, vae_cfg = jax_configs(True)
    jcfg = one_level(jcfg)
    return jcfg, {
        "vae": random_flax_params(AutoencoderKL(vae_cfg), (jnp.zeros((1, 32, 32, 3)),), 0),
        "clip_text": random_flax_params(CLIPTextEncoder(text_cfg),
                                        (jnp.zeros((1, 16), jnp.int32),), 1),
        "clip_vision": random_flax_params(CLIPVisionEncoder(vis_cfg),
                                          (jnp.zeros((1, 32, 32, 3)),), 2),
        "unet_ip2p": random_flax_params(UNet2DCondition(jcfg.unet),
                                        (jnp.zeros((1, 16, 16, 8)), jnp.zeros((1,), jnp.int32),
                                         jnp.zeros((1, 19, 32))), 3),
        "adapter": random_flax_params(janysd.TaskMoEAdapter(jcfg),
                                      (jnp.zeros((1, 16)), jnp.zeros((1,), jnp.int32)), 4)}


def test_editor_matches_jax():
    """`AnySDEditor.edit` (3 steps, 48x40 image, resolution 32) against the
    JAX editor on the same trees, JAX's start latents `normal(key(seed))`
    handed to the port: uint8 within 1 level on every pixel."""
    jcfg, trees = tiny_trees()
    _, text_cfg, vis_cfg, vae_cfg = jax_configs(True)
    frozen = JaxFrozen(AutoencoderKL(vae_cfg), trees["vae"], CLIPTextEncoder(text_cfg),
                       trees["clip_text"], CLIPVisionEncoder(vis_cfg), trees["clip_vision"],
                       SimpleClipTokenizer(text_cfg.vocab_size), trees["unet_ip2p"])
    jed = JaxEditor(jcfg, frozen, trees["unet_ip2p"], trees["adapter"], resolution=32)
    img = np.random.default_rng(5).integers(0, 256, (48, 40, 3), np.uint8)
    ref = jed.edit(img, "make it blue", "color_alter", steps=3, seed=2)

    cfg, text_c, vis_c, vae_c = _anysd_configs(True)
    cfg = one_level(cfg)
    tf = load_frozen_encoders(vae_c, text_c, vis_c, params=trees, device="cpu")
    unet, adapter, _ = AnySDTrainer(cfg, device="cpu").init(
        unet_tree=tf.unet_tree, adapter_tree=trees["adapter"])
    ed = AnySDEditor(cfg, tf, unet, adapter, resolution=32)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.key(2), (1, 16, 16, 4))))
    out = ed.edit(img, "make it blue", "color_alter", steps=3, noise=noise)
    assert out.shape == img.shape and out.dtype == np.uint8
    assert np.abs(out.astype(int) - np.asarray(ref).astype(int)).max() <= 1
