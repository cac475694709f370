"""The DDPM, Euler-ancestral, DPM-Solver++(2M) and PLMS step functions of
the PyTorch port against the JAX package's, step for step, on the same
inputs and the same noise (JAX draws it from a key; the port takes it as
an argument). fp32 on both sides: each step within `ATOL` + `RTOL` of the
JAX value; the multistep samplers run 6 steps with their carried history
(the order fills from 1 to 4 in PLMS), each step fed the JAX sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anyedit_tpu.schedulers as js
import anyedit_tpu_torch.schedulers as ts
from anyedit_tpu.schedulers import dpm as jdpm
from anyedit_tpu.schedulers.euler import euler_scale_input as j_scale
from anyedit_tpu_torch.schedulers import dpm as tdpm
from anyedit_tpu_torch.schedulers.euler import euler_scale_input as t_scale

T = torch.from_numpy
ATOL, RTOL = 1e-5, 1e-5
SHAPE = (2, 8, 8, 4)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), b.double().numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def schedules():
    return js.make_noise_schedule(), ts.make_noise_schedule()


def draws(seed, n=3):
    """n (JAX array, torch tensor) pairs of the same N(0, 1) values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.standard_normal(SHAPE).astype(np.float32)
        out.append((jnp.asarray(a), T(a)))
    return out


def test_exports_match():
    assert ts.SCHEDULERS == js.SCHEDULERS
    for name in ("ddpm_step", "EulerState", "euler_ancestral_init", "euler_ancestral_step",
                 "velocity_target"):
        assert hasattr(ts, name), name


@pytest.mark.parametrize("t", [999, 500, 1, 0])
@pytest.mark.parametrize("clip", [True, False])
def test_ddpm_step_matches(schedules, t, clip):
    jns, tns = schedules
    (jx, tx), (jm, tm) = draws(t)[:2]
    key = jax.random.key(t)
    want = js.ddpm_step(jns, jnp.asarray(t), jm, jx, key, clip_x0=clip)
    noise = T(np.array(jax.random.normal(key, SHAPE, jnp.float32)))
    close(want, ts.ddpm_step(tns, t, tm, tx, noise, clip_x0=clip))


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_velocity_target_matches(schedules, pred):
    jns, tns = schedules
    (jx, tx), (jn, tn) = draws(3)[:2]
    t = np.array([500, 123])
    close(js.velocity_target(jns._replace(prediction_type=pred), jx, jn, jnp.asarray(t)),
          ts.velocity_target(tns._replace(prediction_type=pred), tx, tn, T(t)))


def test_euler_ancestral_matches(schedules):
    """The sigma grid, the input scaling and every step of a 6-step run,
    the last (sigma_next 0) without noise."""
    jns, tns = schedules
    jst, tst = js.euler_ancestral_init(jns, 6), ts.euler_ancestral_init(tns, 6)
    np.testing.assert_array_equal(np.asarray(jst.timesteps), tst.timesteps.numpy())
    close(jst.sigmas, tst.sigmas)
    (jx, tx), = draws(11, 1)
    for i in range(6):
        close(j_scale(jst, i, jx), t_scale(tst, i, tx))
        (jm, tm), = draws(100 + i, 1)
        key = jax.random.key(i)
        want = js.euler_ancestral_step(jns, jst, jnp.asarray(i), jm, jx, key)
        got = ts.euler_ancestral_step(tns, tst, i, tm, tx,
                                      T(np.array(jax.random.normal(key, SHAPE, jnp.float32))))
        close(want, got)
        jx, tx = want, T(np.array(want))


@pytest.mark.parametrize("name", ["dpm", "plms"])
def test_multistep_matches(schedules, name):
    """6 steps with the carried history: the state, each sample and carry."""
    jns, tns = schedules
    jst, tst = jdpm.dpm_init(jns, 6), tdpm.dpm_init(tns, 6)
    for a, b in zip(jst, tst):
        close(a, b)
    jstep, tstep = {"dpm": (jdpm.dpm_step, tdpm.dpm_step),
                    "plms": (jdpm.plms_step, tdpm.plms_step)}[name]
    jc = getattr(jdpm, f"{name}_carry_init")(SHAPE)
    tc = getattr(tdpm, f"{name}_carry_init")(SHAPE)
    (jx, tx), = draws(21, 1)
    for i in range(6):
        (jm, tm), = draws(200 + i, 1)
        want, jc = jstep(jns, jst, jnp.asarray(i), jm, jx, jc)
        got, tc = tstep(tns, tst, i, tm, tx, tc)
        close(want, got)
        for a, b in zip(jc, tc):
            close(a, b)
        jx, tx = want, T(np.array(want))
