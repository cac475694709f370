"""The AnySD trainer of the PyTorch port against the JAX package, and the
training route of the kernel wrappers (K1 and K2 under grad, K3's refusal,
K4's recompute backward; K1's and K2's Functions against JAX's VJPs are in
`test_torch_train_grads.py`).

Seeded Flax trees go to both sides through the weight bridge; the loss's
draws (timesteps, noise, dropout uniform) are JAX's own, from the JAX
`loss_fn`'s `split(key, 3)`, handed to the port. Tolerances: the adapter's
tokens 1e-5; the loss relative 1e-5; the adapter gradients relative L2
1e-4; three optimizer steps, parameters within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.train import anysd as janysd
from anyedit_tpu_torch.ops import attention as tattn
from anyedit_tpu_torch.ops import groupnorm as tgn
from anyedit_tpu_torch.train import anysd as tanysd
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import JAX_UNET, PORT_UNET, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy

# TINY_ANYSD on a one-level cut of the tiny IP2P slot's fp32 8-channel UNet
# (a level with a transformer in the down, mid and up paths: the trainer's
# arithmetic at half the JAX side's compile time)
JAX_UNET1 = dataclasses.replace(JAX_UNET, block_channels=(32,), attn_levels=(True,))
PORT_UNET1 = dataclasses.replace(PORT_UNET, block_channels=(32,), attn_levels=(True,))
JCFG = dataclasses.replace(janysd.TINY_ANYSD, unet=JAX_UNET1)
PCFG = dataclasses.replace(tanysd.TINY_ANYSD, unet=PORT_UNET1)
B, HW, L = 4, 8, 7
STEPS = 3
# XLA's CPU backend optimizations off for the reference jits: each runs
# once, and its compile is most of this file's time
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def unet1_params(hw=8, seed=0):
    return random_flax_params(UNet2DCondition(JAX_UNET1),
                              (jnp.zeros((1, hw, hw, 8)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, L, 32))), seed)


def adapter_tree(cfg, seed=3):
    return random_flax_params(janysd.TaskMoEAdapter(cfg),
                              (jnp.zeros((1, cfg.image_embed_dim)),
                               jnp.zeros((1,), jnp.int32)), seed)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def setup():
    """Both trainers on the same UNet and adapter trees, a numpy batch, a
    key whose dropout uniform drops text in one sample and the image in
    another, and JAX's draws for it."""
    unet_p, ad_p = unet1_params(), adapter_tree(JCFG)
    rng = np.random.default_rng(0)
    batch = {"edited_latents": rng.standard_normal((B, HW, HW, 4)).astype(np.float32),
             "orig_latents": rng.standard_normal((B, HW, HW, 4)).astype(np.float32),
             "text_emb": rng.standard_normal((B, L, 32)).astype(np.float32),
             "image_embed": rng.standard_normal((B, 32)).astype(np.float32),
             "task_id": np.array([0, 1, 2, 3], np.int32)}
    for s in range(200):
        key = jax.random.key(s)
        k_t, k_n, k_drop = jax.random.split(key, 3)
        p = np.asarray(jax.random.uniform(k_drop, (B,)))
        if (p < 0.1).any() and ((p >= 0.05) & (p < 0.15)).any() and (p >= 0.15).any():
            break
    draws = {"t": np.array(jax.random.randint(k_t, (B,), 0, 1000)),
             "noise": np.array(jax.random.normal(k_n, (B, HW, HW, 4))), "p": p.copy()}
    jtr = janysd.AnySDTrainer(JCFG)
    ttr = tanysd.AnySDTrainer(PCFG, device="cpu")
    unet, adapter, opt = ttr.init(unet_tree=unet_p, adapter_tree=ad_p)

    def step(carry, _):
        """The JAX `train_step` written out, also returning its gradients."""
        params, opt_state = carry
        loss, grads = jax.value_and_grad(jtr.loss_fn)(params, unet_p, jb, key)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), (loss, grads)
    jb = jax.tree.map(jnp.asarray, batch)
    (params, _), (losses, grads) = jax.jit(lambda p: jax.lax.scan(
        step, (p, jtr.tx.init(p)), None, length=STEPS), compiler_options=FAST)(ad_p)
    return dict(unet_p=unet_p, ad_p=ad_p, batch=batch, draws=draws, ttr=ttr, unet=unet,
                adapter=adapter, opt=opt, jlosses=np.asarray(losses),
                jgrads=jax.tree.map(lambda g: np.asarray(g[0]), grads),
                jparams=jax.tree.map(np.asarray, params))


def tbatch(batch):
    return {k: T(v).long() if k == "task_id" else T(v) for k, v in batch.items()}


def tdraws(d):
    return {"t": T(d["t"]).long(), "noise": T(d["noise"]), "p": T(d["p"])}


def test_tables_match():
    from anyedit_tpu.core.schema import EDIT_TYPES
    assert tanysd.TASK_EMB_BOOKS == janysd.TASK_EMB_BOOKS
    assert tanysd.EXPERT_NAMES == janysd.EXPERT_NAMES
    for t in list(EDIT_TYPES) + ["material_transfer", "unknown"]:
        assert tanysd.expert_id(t) == janysd.expert_id(t)


@pytest.mark.parametrize("task_emb_dim", [32, 16], ids=["no_task_proj", "task_proj"])
def test_adapter_tokens_match(task_emb_dim):
    """(B, T + 1, Dc) tokens within 1e-5; `task_proj` exists only when
    task_emb_dim != Dc."""
    jcfg = dataclasses.replace(JCFG, task_emb_dim=task_emb_dim)
    tree = adapter_tree(jcfg, seed=4)
    adapter = tanysd.TaskMoEAdapter(dataclasses.replace(PCFG, task_emb_dim=task_emb_dim))
    adapter.load_state_dict(bridge.anysd_adapter_state_dict(tree), strict=True)
    assert (adapter.task_proj is None) == (task_emb_dim == 32)
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((5, 32)).astype(np.float32)
    task = np.array([3, 0, 2, 1, 3], np.int32)
    ref = janysd.TaskMoEAdapter(jcfg).apply(tree, jnp.asarray(emb), jnp.asarray(task))
    with torch.no_grad():
        out = adapter(T(emb), T(task))
    assert out.shape == (5, jcfg.num_image_tokens + 1, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_adapter_bridge_round_trips():
    """Flax tree -> state dict -> Flax tree, bit for bit (with task_proj)."""
    jcfg = dataclasses.replace(JCFG, task_emb_dim=16)
    tree = adapter_tree(jcfg, seed=5)
    back = bridge.anysd_adapter_tree(bridge.anysd_adapter_state_dict(tree), tree)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


def test_loss_matches(setup):
    """`loss_fn` on JAX's draws, with a text-dropped and an image-dropped
    sample: relative 1e-5."""
    s = setup
    ref = float(s["jlosses"][0])
    with torch.no_grad():
        out = float(s["ttr"].loss_fn(s["adapter"], s["unet"], tbatch(s["batch"]),
                                     tdraws(s["draws"])))
    assert abs(out - ref) <= 1e-5 * abs(ref), (out, ref)


def test_adapter_grads_match(setup):
    """The adapter's gradients against `jax.grad`: relative L2 1e-4 per
    leaf; none reaches the frozen UNet."""
    s = setup
    ref = bridge.anysd_adapter_state_dict(s["jgrads"])
    params = dict(s["adapter"].named_parameters())
    loss = s["ttr"].loss_fn(s["adapter"], s["unet"], tbatch(s["batch"]), tdraws(s["draws"]))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert sorted(params) == sorted(ref)
    for name, gr in zip(params, grads):
        assert rel(gr.numpy(), ref[name].numpy()) <= 1e-4, name
    assert not any(p.requires_grad for p in s["unet"].parameters())


def test_three_train_steps_match(setup):
    """Three `train_step`s (clip by global norm, AdamW at optax's defaults)
    on the same batch and draws: every adapter parameter within 1e-5 of
    the JAX step's, the UNet unchanged."""
    s = setup
    ttr = s["ttr"]
    unet, adapter, opt = ttr.init(unet_tree=s["unet_p"], adapter_tree=s["ad_p"])
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    for jloss in s["jlosses"]:
        adapter, opt, loss = ttr.train_step(adapter, opt, unet, tbatch(s["batch"]),
                                            tdraws(s["draws"]))
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = bridge.anysd_adapter_state_dict(s["jparams"])
    for name, p in adapter.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert opt["count"] == STEPS
    assert all(torch.equal(before[k], v) for k, v in unet.state_dict().items())


def test_draw_shapes(setup):
    g = torch.Generator().manual_seed(0)
    d = setup["ttr"].draw(g, {"edited_latents": torch.zeros(3, 4, 4, 4)})
    assert d["t"].shape == (3,) and int(d["t"].max()) < 1000 and int(d["t"].min()) >= 0
    assert d["noise"].shape == (3, 4, 4, 4) and d["p"].shape == (3,)
    assert float(d["p"].min()) >= 0.0 and float(d["p"].max()) < 1.0


def test_k1_k2_outputs_carry_grad_fn_only_under_grad():
    """Under grad K1's and K2's outputs have a grad_fn (the Functions);
    without grad, or with no input that requires it, `attention()` and
    `group_norm()` make the direct call they made before."""
    applied = []
    fns = (tattn._RecomputeAttnFn, tgn._GroupNormFn)
    for fn in fns:
        fn.apply = staticmethod(lambda *a, _o=fn.apply: applied.append(1) or _o(*a))
    try:
        check_routes(applied)
    finally:
        for fn in fns:
            del fn.apply            # the inherited `Function.apply` again


def check_routes(applied):
    q = torch.randn(1, 2, 1024, 8)
    x = torch.randn(2, 64, 4, 4)
    sc, bi = torch.ones(64), torch.zeros(64)
    with torch.no_grad():
        assert tattn.attention(q, q, q).grad_fn is None
        assert tgn.group_norm(x, sc, bi).grad_fn is None
    assert tattn.attention(q, q, q).grad_fn is None           # nothing requires grad
    assert tgn.group_norm(x, sc, bi).grad_fn is None
    assert applied == []
    qg = q.clone().requires_grad_()
    assert type(tattn.attention(qg, q, q).grad_fn).__name__ == "_RecomputeAttnFnBackward"
    assert type(tgn.group_norm(x, sc.clone().requires_grad_(), bi).grad_fn).__name__ \
        == "_GroupNormFnBackward"
    assert len(applied) == 2


def test_k3_raises_under_grad():
    """K3 has no VJP (as in JAX): `attention(use_flash=True)` raises under
    grad with an input that requires it, on every device; it serves under
    no_grad."""
    q = torch.randn(1, 2, 64, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no VJP"):
        tattn.attention(q, q, q, use_flash=True)
    with pytest.raises(RuntimeError, match="no VJP"):
        tattn.flash_attention(q[0], q[0], q[0], 0.3)
    with torch.no_grad():
        assert tattn.attention(q, q, q, use_flash=True).shape == q.shape


def test_k4_recompute_backward(monkeypatch):
    """`self_attn_int8` under grad at its default scale against `jax.vjp`
    of the JAX `_self_attn_int8` (its Pallas `flash_int8` in interpret
    mode) on the same q, k, v and cotangent: the int8 forward within
    max-abs 1e-3 and mean-abs 1e-5 (as `test_torch_ops.py` holds K4), dq,
    dk, dv within relative L2 1e-4 (the VJP recomputes through fp32 sdpa
    on the unquantized inputs). The port's gradient is also, exactly, the
    autograd of its own `sdpa`."""
    import functools
    import importlib
    import math

    jattn = importlib.import_module("anyedit_tpu.ops.attention")
    monkeypatch.setattr(jattn, "flash_int8", functools.partial(jattn.flash_int8,
                                                               interpret=True))
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.standard_normal((1, 2, 512, 16)).astype(np.float32)
                  for _ in range(4))
    ref_out, vjp = jax.vjp(lambda a, b, c: jattn._self_attn_int8(a, b, c, 1 / math.sqrt(16)),
                           *(jnp.asarray(t) for t in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    ins = [T(t).requires_grad_() for t in (q, k, v)]
    out = tattn.self_attn_int8(*ins)
    assert type(out.grad_fn).__name__ == "_RecomputeAttnFnBackward"
    with torch.no_grad():
        np.testing.assert_array_equal(out.numpy(), tattn.self_attn_int8(
            *(T(t) for t in (q, k, v))).numpy())
    err = np.abs(out.detach().numpy() - np.asarray(ref_out))
    assert err.max() <= 1e-3 and err.mean() <= 1e-5, (err.max(), err.mean())
    got = torch.autograd.grad(out, ins, T(g))
    for a, b in zip(got, ref):
        assert rel(a.numpy(), b) <= 1e-4
    own_ins = [T(t).requires_grad_() for t in (q, k, v)]
    own = torch.autograd.grad(tattn.sdpa(*own_ins), own_ins, T(g))
    for a, b in zip(got, own):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
