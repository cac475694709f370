"""Weight bridge of the PyTorch port: Flax trees -> the port's state dicts.

Also holds the seeded Flax parameter trees the other `test_torch_*` files
share: structure from `jax.eval_shape` of the JAX module's init (no init
compile), values drawn with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models.clip import CLIPTextEncoder, TINY_TEXT
from anyedit_tpu.models.unet_sd import TINY_UNET, UNet2DCondition
from anyedit_tpu.models.vae import TINY_VAE, AutoencoderKL
from anyedit_tpu.weights.convert import (
    convert_clip_text, convert_unet_sd, convert_vae,
)
from anyedit_tpu_torch.models import clip as tclip
from anyedit_tpu_torch.models import unet_sd as tunet
from anyedit_tpu_torch.models import vae as tvae
from anyedit_tpu_torch.weights import bridge

torch.set_num_threads(1)

F32 = dict(dtype=jnp.float32)
TF32 = dict(dtype=torch.float32)
# the tiny configs of the JAX package's `tiny_zoo_config` (IP2P slot)
JAX_UNET = dataclasses.replace(TINY_UNET, in_channels=8, **F32)
JAX_VAE = dataclasses.replace(TINY_VAE, **F32)
JAX_TEXT = dataclasses.replace(TINY_TEXT, vocab_size=30522, max_len=77, **F32)
PORT_UNET = dataclasses.replace(tunet.TINY_UNET, in_channels=8, **TF32)
PORT_VAE = dataclasses.replace(tvae.TINY_VAE, **TF32)
PORT_TEXT = dataclasses.replace(tclip.TINY_TEXT, vocab_size=30522, max_len=77,
                                **TF32)


def random_flax_params(module, args, seed):
    """A Flax param tree for `module` with seeded numpy values at init-like
    scales: kernels N(0, 1/fan_in), biases N(0, 0.1^2) (non-zero, so a
    mis-mapped bias shows), norm scales 1 + N(0, 0.1^2), embeddings
    N(0, 1/features), pos_emb N(0, 0.01^2)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "embedding":
            n = n / np.sqrt(leaf.shape[-1])
        elif name == "pos_emb":
            n = 0.01 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def unet_params(seed=0):
    return random_flax_params(
        UNet2DCondition(JAX_UNET),
        (jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,), jnp.int32),
         jnp.zeros((1, 77, JAX_UNET.context_dim))), seed)


def vae_params(seed=1):
    return random_flax_params(AutoencoderKL(JAX_VAE),
                              (jnp.zeros((1, 64, 64, 3)),), seed)


def text_params(seed=2):
    return random_flax_params(CLIPTextEncoder(JAX_TEXT),
                              (jnp.zeros((1, 77), jnp.int32),), seed)


CASES = {
    "unet": (unet_params, lambda t: bridge.unet_state_dict(t, 2),
             lambda: tunet.UNet2DCondition(PORT_UNET),
             lambda tree, sd: convert_unet_sd(tree, sd, n_levels=2)),
    "vae": (vae_params, lambda t: bridge.vae_state_dict(t, 2),
            lambda: tvae.AutoencoderKL(PORT_VAE),
            lambda tree, sd: convert_vae(tree, sd, n_levels=2)),
    "clip_text": (text_params, bridge.clip_text_state_dict,
                  lambda: tclip.CLIPTextEncoder(PORT_TEXT), convert_clip_text),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_round_trips_through_converter(name):
    """The bridged state dict, fed back through the JAX package's converter,
    gives the Flax tree back bit-exactly."""
    make_tree, to_sd, _, convert = CASES[name]
    tree = make_tree()
    sd = {k: v.numpy() for k, v in to_sd(tree).items()}
    back = convert(tree, sd)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_keys_are_the_port_modules_keys(name):
    """The bridge covers every parameter of the port's module, by name and
    shape (strict load), with no key left over."""
    make_tree, to_sd, make_module, _ = CASES[name]
    sd = to_sd(make_tree())
    module = make_module()
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    module.load_state_dict(sd, strict=True)


def _quant_tree():
    """The JAX package's W8A8 UNet tree (quantize_params of `unet_params`)."""
    from anyedit_tpu.ops.quant import quantize_params
    qunet = UNet2DCondition(dataclasses.replace(JAX_UNET, quant=True))
    shapes = jax.eval_shape(lambda: qunet.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, JAX_UNET.context_dim))))
    return {"params": quantize_params(shapes["params"], unet_params()["params"])}


def test_bridge_round_trips_quant_tree():
    """A JAX quantize_params tree -> the port's W8A8 state dict -> back
    (`unet_tree`): every leaf bit-exact, int8 kernels still int8; the state
    dict loads strictly into the port's quant UNet."""
    tree = _quant_tree()
    sd = bridge.unet_state_dict(tree, 2)
    assert sd["down_blocks.0.resnets.0.conv1.weight"].dtype == torch.int8
    assert sd["down_blocks.0.resnets.0.conv1.kernel_scale"].dtype == torch.float32
    qunet = tunet.UNet2DCondition(dataclasses.replace(PORT_UNET, quant=True))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in qunet.state_dict().items()}
    qunet.load_state_dict(sd, strict=True)
    back = bridge.unet_tree(qunet.state_dict(), tree, 2)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        assert np.asarray(b).dtype == np.asarray(a).dtype, p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


def test_bridge_layout_transforms():
    """Conv kernels go HWIO -> OIHW and Dense kernels (in, out) -> (out, in)."""
    tree = unet_params()["params"]
    sd = bridge.unet_state_dict({"params": tree}, 2)
    k = np.asarray(tree["conv_in"]["Conv_0"]["kernel"])          # (3, 3, 8, 32)
    np.testing.assert_array_equal(sd["conv_in.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = np.asarray(tree["time_fc1"]["kernel"])                     # (32, 128)
    np.testing.assert_array_equal(sd["time_embedding.linear_1.weight"].numpy(), d.T)


def test_seeded_init_matches_flax_initializer_scales():
    """The device-side seeded init draws the Flax initializers'
    distributions: lecun-normal kernels, zero biases, unit norm scales,
    normal(0.01) pos_emb."""
    from anyedit_tpu_torch.weights.init import seeded_init_
    te = seeded_init_(tclip.CLIPTextEncoder(dataclasses.replace(PORT_TEXT,
                                                                hidden=256)), 0)
    sd = te.state_dict()
    w = sd["text_model.encoder.layers.0.mlp.fc1.weight"]           # (1024, 256)
    std = (1 / 256) ** 0.5
    assert abs(float(w.std()) - std) < 0.02 * std     # 262k draws
    assert float(w.abs().max()) <= 2 * std / 0.87962566 + 1e-6
    assert float(sd["text_model.encoder.layers.0.mlp.fc1.bias"].abs().max()) == 0
    assert torch.all(sd["text_model.final_layer_norm.weight"] == 1)
    pos = sd["text_model.embeddings.position_embedding.weight"]
    assert abs(float(pos.std()) - 0.01) < 0.001
    again = seeded_init_(tclip.CLIPTextEncoder(dataclasses.replace(PORT_TEXT,
                                                                   hidden=256)), 0)
    torch.testing.assert_close(again.state_dict()[
        "text_model.encoder.layers.0.mlp.fc1.weight"], w, rtol=0, atol=0)
