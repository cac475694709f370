"""The attention processors of the caption-pair editors in the PyTorch port
against the JAX package: `_probs`, `masactrl_processor`, `AttentionStore`,
`mask_from_ca`, `alignment_matrix`, `p2p_replace_processor`, the "nearest"
resize, `consistent_synthesis` on TINY_UNET with the K/V swap active, and
the AttentionStore accumulation of the P2P pair sampler; and the order and
count of SD15_UNET's self-attention sites.

Tolerances: probabilities and processor outputs in fp32 within 1e-6;
`mask_from_ca`, `alignment_matrix` and the nearest resize exactly; the
tiny UNet's latents and accumulated maps within 1e-4 (fp32 through 3 DDIM
steps at guidance 7.5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.diffusion import processors as jproc
from anyedit_tpu.edits.action_change import consistent_synthesis as jax_consistent
from anyedit_tpu.models.layers import AttnMeta as JaxMeta
from anyedit_tpu.models.unet_sd import TINY_UNET as JAX_TINY_UNET
from anyedit_tpu.models.unet_sd import UNet2DCondition as JaxUNet
from anyedit_tpu.ops.resize import resize_image as jax_resize
from anyedit_tpu.schedulers import ddim_init as jddim_init
from anyedit_tpu.schedulers import ddim_step as jddim_step
from anyedit_tpu.schedulers import make_noise_schedule as jax_schedule
from anyedit_tpu_torch.diffusion import processors as proc
from anyedit_tpu_torch.diffusion.sampling import p2p_sample
from anyedit_tpu_torch.edits.action_change import MASA_LAYER, consistent_synthesis
from anyedit_tpu_torch.models import layers
from anyedit_tpu_torch.models.layers import AttnMeta
from anyedit_tpu_torch.models.unet_sd import SD15_UNET, TINY_UNET, UNet2DCondition
from anyedit_tpu_torch.ops.groupnorm import group_norm_plain
from anyedit_tpu_torch.ops.layernorm import layer_norm_plain
from anyedit_tpu_torch.ops.resize import resize_image
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, TF32, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_UNET4 = dataclasses.replace(JAX_TINY_UNET, **F32)
PORT_UNET4 = dataclasses.replace(TINY_UNET, **TF32)
HW = 16          # latent side of the UNet runs (the mid block at 8 x 8)
B, H, L, D = 4, 2, 12, 8
LT = 7           # text tokens of the cross-attention cases


def _close(got, ref, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _qkv(lk=L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, L, D)).astype(np.float32),
            rng.standard_normal((B, H, lk, D)).astype(np.float32),
            rng.standard_normal((B, H, lk, D)).astype(np.float32))


def _metas(is_self, name="down_0.tf_0.tb0"):
    tag = f"{name}.{'self' if is_self else 'cross'}"
    return AttnMeta(tag, is_self, H, D), JaxMeta(tag, is_self, H, D)


# ---- the nearest resize -------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((5, 7), (12, 9)), ((5, 7), (16, 28)), ((5, 7), (3, 4)),
                                     ((16, 16), (64, 64)), ((37, 23), (29, 61))])
def test_nearest_resize_matches_jax(src, dst):
    """`resize_image(..., "nearest")` gathers the rows and columns
    `jax.image.resize` does, upscaling and downscaling at integer and
    non-integer ratios: equal, antialias or not."""
    x = np.random.default_rng(1).standard_normal(src + (3,)).astype(np.float32)
    for aa in (True, False):
        ref = jax_resize(jnp.asarray(x), *dst, "nearest", antialias=aa)
        np.testing.assert_array_equal(resize_image(T(x), *dst, "nearest", antialias=aa).numpy(),
                                      np.asarray(ref))


# ---- the processors -------------------------------------------------------------

def test_probs_matches():
    q, k, _ = _qkv(LT)
    _close(proc._probs(T(q), T(k)), jproc._probs(q, k), 1e-6)
    _close(proc._probs(T(q), T(k), scale=0.2), jproc._probs(q, k, scale=0.2), 1e-6)


@pytest.mark.parametrize("step,layer", [(0, 0), (3, 1), (1, 2), (2, 5)])
def test_masactrl_processor_matches(step, layer):
    """Three self-attention sites and a cross-attention site in call order,
    the gate at step 2 / site 1: the output of every site (swapped or not)
    within 1e-6, and the site counters equal."""
    p, jp = proc.masactrl_processor(2, 1), jproc.masactrl_processor(2, 1)
    ex, jex = {"step": step}, {"step": step}
    for site in range(4):
        is_self = site != 2
        q, k, v = _qkv(L if is_self else LT, seed=10 * layer + site)
        m, jm = _metas(is_self)
        _close(p(T(q), T(k), T(v), m, ex), jp(q, k, v, jm, jex), 1e-6)
    assert ex["_sa"] == jex["_sa"] == 3


def test_masactrl_swaps_target_kv():
    """Active: each odd row attends to the even row before it (its output
    is the source row's keys and values under its own queries); even rows
    are unchanged. A custom `source_of` routes as given."""
    q, k, v = (T(a) for a in _qkv())
    m, _ = _metas(True)
    out = proc.masactrl_processor(0, 0)(q, k, v, m, {"step": 0})
    src = torch.tensor([0, 0, 2, 2])
    _close(out, proc.sdpa(q, k[src], v[src]).numpy(), 1e-7)
    _close(out[0::2], proc.sdpa(q, k, v)[0::2].numpy(), 1e-7)
    routed = proc.masactrl_processor(0, 0, source_of=np.array([3, 2, 1, 0]))(
        q, k, v, m, {"step": 0})
    _close(routed, proc.sdpa(q, k.flip(0), v.flip(0)).numpy(), 1e-7)


@pytest.mark.parametrize("watch_self", [False, True])
def test_attention_store_matches(watch_self):
    """The store's outputs and the head-mean maps it keeps (self maps only
    with `watch_self`; none above `max_hw`), in call order."""
    store, jstore = proc.AttentionStore(watch_self, max_hw=L), \
        jproc.AttentionStore(watch_self, max_hw=L)
    store.reset()
    jstore.reset()
    p, jp = store.processor(), jstore.processor()
    for name, is_self in (("down_0.tf_0.tb0", True), ("down_0.tf_0.tb0", False),
                          ("mid.tf.tb0", False)):
        q, k, v = _qkv(L if is_self else LT, seed=len(name) + is_self)
        m, jm = _metas(is_self, name)
        _close(p(T(q), T(k), T(v), m, None), jp(q, k, v, jm, None), 1e-6)
    got, ref = store.collect(), jstore.collect()
    assert list(got) == list(ref)
    assert len(got) == 2 + watch_self
    for name in got:
        _close(got[name], ref[name], 1e-6)
    small = proc.AttentionStore(max_hw=L - 1)
    q, k, v = (T(a) for a in _qkv(LT))
    small.processor()(q, k, v, _metas(False)[0], None)
    assert small.collect() == {}


def test_mask_from_ca_matches():
    acc = np.random.default_rng(3).random((2, 64, LT)).astype(np.float32)
    acc[1, :, 4] = 0.25                                    # a flat column: all False
    for tok, thr in ((1, 0.3), (4, 0.3), (6, 0.7)):
        got = proc.mask_from_ca(T(acc), tok, 8, thr)
        assert got.dtype == torch.bool and tuple(got.shape) == (2, 8, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jproc.mask_from_ca(acc, tok, 8, thr)))


@pytest.mark.parametrize("src,tgt", [
    ([49406, 320, 2368, 525, 7067, 49407], [49406, 320, 1929, 525, 7067, 49407]),
    (["a", "cat", "on", "grass"], ["a", "small", "cat", "on", "the", "grass", "today"]),
    ([1, 2, 3, 4, 5], [5, 4, 3]),
    ([], [1, 2])])
def test_alignment_matrix_matches(src, tgt):
    np.testing.assert_array_equal(proc.alignment_matrix(src, tgt),
                                  jproc.alignment_matrix(src, tgt))


@pytest.mark.parametrize("step", [0, 1, 3])
def test_p2p_replace_processor_matches(step):
    """Before `stop_step`, the target rows' cross-attention probabilities are
    the source rows' through the mapper; self-attention is plain sdpa."""
    mapper = proc.alignment_matrix(list(range(LT)), [0, 1, 9, 3, 4, 5, 6])
    p, jp = proc.p2p_replace_processor(mapper, 2), jproc.p2p_replace_processor(mapper, 2)
    for is_self in (True, False):
        q, k, v = _qkv(L if is_self else LT, seed=20 + step)
        m, jm = _metas(is_self)
        _close(p(T(q), T(k), T(v), m, {"step": step}), jp(q, k, v, jm, {"step": step}), 1e-6)


# ---- the UNet's sites ---------------------------------------------------------

def _site_order(unet, x, t, ctx):
    names = []

    def record(q, k, v, meta, extra):
        names.append(meta.name)
        return q
    unet(x, t, ctx, processor=record)
    return names


def test_sd15_unet_self_attention_sites(monkeypatch):
    """The full-width SD15_UNET, built on the meta device, reaches 16
    self-attention sites a call (down 6, mid 1, up 9: MASA_LAYER = 12 lets
    the swap act on the last 4, the last up site at 32 x 32 and the three at
    64 x 64), in the JAX package's order. The norms take their plain
    versions: K2 and K5 take no meta tensors."""
    monkeypatch.setattr(layers, "group_norm", group_norm_plain)
    monkeypatch.setattr(layers, "layer_norm", layer_norm_plain)
    unet = UNet2DCondition(SD15_UNET, device="meta")
    x = torch.empty((4, 64, 64, 4), device="meta")
    names = _site_order(unet, x, torch.empty((4,), device="meta"),
                        torch.empty((4, 77, 768), device="meta"))
    sites = [n for n in names if n.endswith(".self")]
    assert len(sites) == 16 and len(names) == 32
    assert sites[:7] == [f"down_{lvl}.tf_{i}.tb0.self" for lvl in range(3) for i in range(2)] \
        + ["mid.tf.tb0.self"]
    assert sites[MASA_LAYER:] == ["up_1.tf_2.tb0.self", "up_0.tf_0.tb0.self",
                                  "up_0.tf_1.tb0.self", "up_0.tf_2.tb0.self"]


def _unet_pair(seed=50):
    x = np.zeros((1, HW, HW, 4), np.float32)
    tree = random_flax_params(JaxUNet(JAX_UNET4), (x, np.zeros((1,), np.int32),
                                                   np.zeros((1, 77, 32), np.float32)), seed)
    unet = UNet2DCondition(PORT_UNET4)
    unet.load_state_dict(bridge.unet_state_dict(tree, 2), strict=True)
    return tree, unet.eval()


def test_tiny_unet_site_order_matches_jax():
    """The port's tiny UNet calls its attention sites in the JAX UNet's order."""
    tree, unet = _unet_pair()
    x, t, ctx = np.zeros((1, HW, HW, 4), np.float32), np.zeros((1,), np.int32), \
        np.zeros((1, 5, 32), np.float32)
    jnames = []

    def record(q, k, v, meta, extra):
        jnames.append(meta.name)
        return q
    jax.eval_shape(lambda: JaxUNet(JAX_UNET4).apply(tree, x, t, ctx, processor=record))
    with torch.no_grad():
        assert _site_order(unet, T(x), T(t), T(ctx)) == jnames


def _texts(seed=51, lt=9):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, lt, 32)).astype(np.float32) for _ in range(3)]


def test_consistent_synthesis_matches_with_the_swap_active():
    """Three steps of MasaCtrl sampling on TINY_UNET (4 self-attention
    sites) with the swap from step 1 and site 1, JAX's start latent handed
    to the port: latents within 1e-4. Without the swap (start_layer past
    the last site) the source row is the same and the target row moves."""
    tree, unet = _unet_pair()
    cs, ct, un = _texts()
    key = jax.random.key(3)
    jm = JaxUNet(JAX_UNET4)
    ref = jax_consistent(lambda x, t, c, p, e: jm.apply(tree, x, t, c, processor=p, extra=e),
                         jax_schedule(), cs, ct, un, key, latent_hw=HW, num_steps=3,
                         start_step=1, start_layer=1)
    z0 = T(np.array(jax.random.normal(key, (1, HW, HW, 4), jnp.float32)))
    ns = make_noise_schedule()

    def run(layer):
        with torch.no_grad():
            return consistent_synthesis(
                lambda x, t, c, p, e: unet(x, t, c, processor=p, extra=e), ns, T(cs), T(ct),
                T(un), z0, num_steps=3, start_step=1, start_layer=layer)
    got = run(1)
    assert tuple(got.shape) == (2, HW, HW, 4)
    _close(got, ref, 1e-4)
    off = run(99)
    _close(off[0], got[0].numpy(), 1e-5)
    assert float((off[1] - got[1]).abs().max()) > 1e-2


def test_p2p_accumulation_matches():
    """`p2p_sample` against the JAX zoo's P2P loop (the AttentionStore's
    first largest map, conditional rows, summed over 3 steps) on TINY_UNET:
    latents and accumulated maps within 1e-4; each map row sums to 1 per
    step."""
    tree, unet = _unet_pair(52)
    un, co, ct = _texts(53, lt=77)
    ctx4 = np.concatenate([un, un, co, ct])
    z0 = np.random.default_rng(54).standard_normal((1, HW, HW, 4)).astype(np.float32)
    max_hw = (HW // 2) ** 2
    jns, jstore, jm = jax_schedule(), jproc.AttentionStore(max_hw=max_hw), JaxUNet(JAX_UNET4)
    st = jddim_init(jns, 3)

    @jax.jit
    def step(lat, i):
        jstore.reset()
        eps4 = jm.apply(tree, jnp.concatenate([lat, lat]), jnp.full((4,), st.timesteps[i]),
                        ctx4, processor=jstore.processor())
        maps = jstore.collect()
        e_u, e_c = jnp.split(eps4, 2)
        return (jddim_step(jns, st, i, e_u + 7.5 * (e_c - e_u), lat),
                maps[max(maps, key=lambda n: maps[n].shape[1])][2:4])
    lat, acc = np.concatenate([z0, z0]), None
    for i in range(3):
        lat, best = step(lat, i)
        acc = best if acc is None else acc + best
    with torch.no_grad():
        got_lat, got_acc = p2p_sample(unet, make_noise_schedule(), T(ctx4), T(z0),
                                      proc.AttentionStore(max_hw=max_hw), num_steps=3)
    assert tuple(got_acc.shape) == (2, max_hw, 77)
    _close(got_acc, acc, 1e-4)
    _close(got_lat, lat, 1e-4)
    _close(got_acc.sum(-1), np.full((2, max_hw), 3.0), 1e-4)
