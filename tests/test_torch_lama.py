"""LaMa in the PyTorch port against the JAX package, on seeded Flax
parameters bridged into the port (fp32, TINY_LAMA): the generator (also at
a block resolution of odd height and width, where `irfft2` needs `s=`),
`pad_to_modulo`, the `lama` bridge in both directions through the JAX
converter, and the zoo's `inpainter()` slot on odd image sizes.

Tolerances: the generator's output 2e-5 max-abs (a sigmoid in [0, 1] after
fp32 convs and FFTs summed in another order); the inpainter's output the
same; `pad_to_modulo` and the bridge round trips exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models import lama as jlama
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import convert_lama, save_params
from anyedit_tpu_torch.models import lama as tlama
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
CFG = jlama.TINY_LAMA


def lama_params(seed=61, cfg=CFG):
    """Seeded params with FrozenBN statistics a real checkpoint could hold:
    scale 1 + N(0, 0.1^2), shift and mean N(0, 0.1^2), var in [0.5, 1.5]."""
    p = random_flax_params(jlama.LamaGenerator(cfg),
                           (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 1))), seed)
    rng = np.random.default_rng(seed + 1)

    def fix(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(fix, p)


@pytest.fixture(scope="module")
def params():
    return lama_params()


def _inputs(h, w, seed=62):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    mask = np.zeros((1, h, w, 1), np.float32)
    mask[:, h // 4:3 * h // 4, w // 5:w // 2] = 1.0
    return img, mask


def _port(params):
    m = tlama.LamaGenerator(dataclasses.replace(tlama.TINY_LAMA))
    m.load_state_dict(bridge.lama_state_dict(params, CFG.ratio_g), strict=True)
    return m.eval()


@pytest.mark.parametrize("hw", [(32, 40), (44, 36)])
def test_generator_matches(params, hw):
    """(32, 40) runs the blocks at 8x10; (44, 36) at 11x9, odd both ways.
    Outside the mask the output is the input, exactly."""
    img, mask = _inputs(*hw)
    ref = np.asarray(jax.jit(jlama.LamaGenerator(CFG).apply)(params, img, mask))
    with torch.no_grad():
        got = _port(params)(T(img), T(mask)).numpy()
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    keep = mask[..., 0] == 0
    np.testing.assert_array_equal(got[keep], img[keep])
    assert np.abs(got[~keep] - img[~keep]).max() > 0.05      # the hole was filled


@pytest.mark.parametrize("shape", [(1, 37, 29, 3), (1, 16, 24, 1), (2, 9, 15, 3), (5, 3, 1)])
def test_pad_to_modulo_matches(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ref, ref_hw = jlama.pad_to_modulo(jnp.asarray(x), 8)
    got, hw = tlama.pad_to_modulo(T(x), 8)
    assert hw == ref_hw == shape[-3:-1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_lama_bridge_round_trips_through_converter(params):
    """The bridged state dict, as the saicinpainting generator's keys, read
    back by `convert_lama` is the Flax tree bit for bit; `lama_tree`
    inverts the bridge; every port parameter and buffer is covered."""
    sd = bridge.lama_state_dict(params, CFG.ratio_g)
    assert set(sd) == set(_port(params).state_dict())
    back = convert_lama(params["params"], {f"generator.{k}": v.numpy() for k, v in sd.items()},
                        n_down=CFG.n_downsample, n_blocks=CFG.n_blocks)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params["params"])
    tree = bridge.lama_tree(sd, params, CFG.ratio_g)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, params)


def test_inpainter_matches(params, tmp_path):
    """The zoo's `inpaint(img01, mask01)` on a 37x29 image (padded to 40x32
    and cropped back) against the JAX zoo's, the same params on both."""
    save_params(params, tmp_path / "lama.msgpack")
    jzoo = JaxModelZoo(JaxZooConfig(lama=CFG), weights_dir=tmp_path,
                       allow_fallback_tokenizers=True)
    zoo = ModelZoo(tiny_zoo_config(), device="cpu", params={"lama": params})
    img, mask = _inputs(37, 29, seed=63)
    ref = jzoo.inpainter()(img[0], mask[0, ..., 0])
    got = zoo.inpainter()(img[0], mask[0, ..., 0])
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (37, 29, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=0)
