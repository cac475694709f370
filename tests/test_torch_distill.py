"""LCM distillation of the PyTorch port against the JAX package:
`boundary_scalings`, `LCMDistiller.loss_fn` and `distill_step` (fp32
masters, EMA) and `lcm_edit` (the zoo's LCM branch is held in
`test_torch_train_io.py`).

The tiny distiller runs in fp32 on both sides (the JAX TINY_DISTILL UNet is
bf16) on a one-level cut of its UNet (the JAX step's compile is most of
this file's time), from one seeded Flax tree; the draws are JAX's, from the keys the
JAX functions split, handed to the port. Tolerances: the loss relative
1e-5; two `distill_step`s, 99.9 % of the student's and the EMA's
parameters within 1e-5 and all within the steps' reach; `lcm_edit` max-abs 1e-4; the zoo's uint8 output within 1
level (the zoo). The bf16 scheme (bf16 module, fp32 masters) is held to its own
invariants: weights equal to the masters rounded, the EMA rule exact, the
teacher unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.schedulers import make_noise_schedule as jax_schedule
from anyedit_tpu.train import distill as jd
from anyedit_tpu_torch.schedulers import make_noise_schedule
from anyedit_tpu_torch.train import distill as td
from anyedit_tpu_torch.weights import bridge
from test_torch_train import FAST, JAX_UNET1, PORT_UNET1, unet1_params

torch.set_num_threads(1)
T = torch.from_numpy

JCFG = dataclasses.replace(jd.TINY_DISTILL, unet=JAX_UNET1)
PCFG = dataclasses.replace(td.TINY_DISTILL, unet=PORT_UNET1)
B, HW, L = 2, 8, 5


@pytest.fixture(scope="module")
def setup():
    teacher = unet1_params()
    rng = np.random.default_rng(0)
    batch = {"edited_latents": (0.3 * rng.standard_normal((B, HW, HW, 4))).astype(np.float32),
             "orig_latents": (0.3 * rng.standard_normal((B, HW, HW, 4))).astype(np.float32),
             "text_emb": rng.standard_normal((B, L, 32)).astype(np.float32),
             "uncond_emb": (0.1 * rng.standard_normal((B, L, 32))).astype(np.float32)}
    keys = [jax.random.key(11), jax.random.key(12)]
    draws = []
    for k in keys:
        k_i, k_n = jax.random.split(k)
        draws.append({"n": T(np.array(jax.random.randint(k_i, (B,), 0, 8 - 1))).long(),
                      "noise": T(np.array(jax.random.normal(k_n, (B, HW, HW, 4))))})
    jdist = jd.LCMDistiller(JCFG)
    js, je, jopt = jdist.init(teacher)
    step = jax.jit(jdist.distill_step, compiler_options=FAST)
    jsteps = []
    for k in keys:
        js, je, jopt, jloss = step(js, je, jopt, teacher, jb(batch), k)
        jsteps.append(float(jloss))
    return dict(teacher=teacher, batch=batch, draws=draws, jsteps=jsteps,
                jstudent=jax.tree.map(np.asarray, js), jema=jax.tree.map(np.asarray, je),
                tdist=td.LCMDistiller(PCFG, device="cpu"),
                sd=bridge.unet_state_dict(teacher, 1))


def tb(batch):
    return {k: T(v) for k, v in batch.items()}


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_boundary_scalings_match():
    t = np.array([0, 1, 21, 500, 999], np.int32)
    ref = jd.boundary_scalings(jd.TINY_DISTILL, jnp.asarray(t))
    got = td.boundary_scalings(td.TINY_DISTILL, T(t).long())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert float(got[0][0]) == 1.0 and float(got[1][0]) == 0.0


def test_trailing_grid_matches(setup):
    from anyedit_tpu.schedulers import ddim_init as jddim
    np.testing.assert_array_equal(setup["tdist"].st.timesteps.numpy(),
                                  np.asarray(jddim(jax_schedule(), 8, style="trailing").timesteps))


def test_loss_matches(setup):
    """`loss_fn` with the teacher as student and EMA target (the state
    after `init`; JAX's is the first `distill_step`'s loss): relative 1e-5;
    a gradient reaches the student only."""
    s = setup
    ref = s["jsteps"][0]
    teacher, student, ema, _ = s["tdist"].init(s["sd"])
    loss = s["tdist"].loss_fn(student.unet, ema.unet, teacher, tb(s["batch"]), s["draws"][0])
    assert abs(float(loss.detach()) - ref) <= 1e-5 * abs(ref), (float(loss.detach()), ref)
    loss.backward()
    assert all(p.grad is not None for p in student.unet.parameters())
    assert not any(p.requires_grad for p in (*teacher.parameters(), *ema.unet.parameters()))


def test_two_distill_steps_match(setup):
    """Two `distill_step`s (AdamW + clip on the masters, EMA 0.95): losses
    relative 1e-5 (the second at the updated student and EMA); 99.9 % of the
    masters' elements within 1e-5 of JAX's params (1 % of an lr-1e-3 step)
    and all within the two steps' reach, 2 lr each: Adam divides each
    element by its own gradient's magnitude, so an element whose gradient
    is near zero takes a sign from the fp32 summation order. The modules
    equal their masters, the teacher is unchanged."""
    s = setup
    teacher, student, ema, opt = s["tdist"].init(s["sd"])
    t0 = {k: v.clone() for k, v in teacher.state_dict().items()}
    for jloss, d in zip(s["jsteps"], s["draws"]):
        student, ema, opt, loss = s["tdist"].distill_step(student, ema, opt, teacher,
                                                          tb(s["batch"]), d)
        assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    reach = 2 * len(s["draws"]) * PCFG.learning_rate
    for rep, tree in ((student, s["jstudent"]), (ema, s["jema"])):
        ref = bridge.unet_state_dict(tree, 1)
        diff = np.concatenate([np.abs(m.numpy() - ref[name].numpy()).ravel()
                               for name, m in rep.masters.items()])
        assert np.mean(diff <= 1e-5) >= 0.999 and diff.max() <= reach, \
            (np.mean(diff <= 1e-5), diff.max())
        for name, p in rep.unet.named_parameters():
            assert torch.equal(p.detach(), rep.masters[name]), name
    assert all(torch.equal(t0[k], v) for k, v in teacher.state_dict().items())


def test_bf16_student_keeps_fp32_masters(setup):
    """The bf16 scheme: after a step the bf16 weights equal the fp32
    masters rounded, the masters moved by steps below bf16's resolution
    (lr 1e-5), the EMA is d e + (1 - d) s exactly, and the fp32 norm
    affines equal their masters."""
    s = setup
    cfg = dataclasses.replace(PCFG, unet=dataclasses.replace(PCFG.unet, dtype=torch.bfloat16),
                              learning_rate=1e-5)
    dist = td.LCMDistiller(cfg, device="cpu")
    teacher, student, ema, opt = dist.init(s["sd"])
    m0 = {k: v.clone() for k, v in student.masters.items()}
    e0 = {k: v.clone() for k, v in ema.masters.items()}
    w0 = {k: v.detach().clone() for k, v in student.unet.named_parameters()}
    student, ema, opt, loss = dist.distill_step(student, ema, opt, teacher, tb(s["batch"]),
                                                s["draws"][0])
    assert np.isfinite(float(loss))
    moved = unmoved_weight = 0
    for name, p in student.unet.named_parameters():
        m = student.masters[name]
        assert torch.equal(p.detach(), m.to(p.dtype)), name
        assert torch.equal(ema.masters[name], 0.95 * e0[name] + (1.0 - 0.95) * m), name
        if not torch.equal(m, m0[name]):
            moved += 1
            unmoved_weight += int(p.dtype == torch.bfloat16 and torch.equal(p.detach(), w0[name]))
        if p.dtype == torch.float32:
            assert torch.equal(p.detach(), m), name
    assert moved == len(m0)
    assert unmoved_weight > 0        # a bf16 module updated in place would not move there


def test_lcm_edit_matches(setup):
    """`lcm_edit` at 4 steps with JAX's start latents and re-noise draws
    (the splits of the JAX sampler's key): max-abs 1e-4."""
    from anyedit_tpu.models.unet_sd import UNet2DCondition
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet

    s = setup
    rng = np.random.default_rng(1)
    img = (0.3 * rng.standard_normal((1, HW, HW, 4))).astype(np.float32)
    ctx = rng.standard_normal((1, L, 32)).astype(np.float32)
    key = jax.random.key(5)
    unet = UNet2DCondition(JAX_UNET1)
    ref = jax.jit(lambda p, i, c: jd.lcm_edit(unet.apply, p, jax_schedule(), JCFG, i, c, key,
                                              num_steps=4),
                  compiler_options=FAST)(s["teacher"], jnp.asarray(img), jnp.asarray(ctx))
    k_init, k = jax.random.split(key)
    x_init = T(np.array(jax.random.normal(k_init, img.shape)))
    renoise = []
    for _ in range(3):
        k, k2 = jax.random.split(k)
        renoise.append(T(np.array(jax.random.normal(k2, img.shape))))
    tunet = TUNet(PCFG.unet)
    tunet.load_state_dict(s["sd"], strict=True)
    out = td.lcm_edit(tunet, make_noise_schedule(), PCFG, T(img), T(ctx), 4,
                      x_init=x_init, renoise=renoise)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-4
