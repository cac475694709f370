"""K1's and K2's autograd Functions in the PyTorch port against the JAX
package's VJPs: K2's against `jax.grad` through the Pallas `_gn_pallas` in
interpret mode, K1's through a one-level tiny UNet at 32x32 latents (level
0 has 1,024 tokens: K1's route in the port, XLA's sdpa in JAX on the CPU).
fp32 both sides; relative L2 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models.unet_sd import UNet2DCondition
from anyedit_tpu.ops import groupnorm as jgn
from anyedit_tpu_torch.models.unet_sd import UNet2DCondition as TUNet
from anyedit_tpu_torch.ops import attention as tattn
from anyedit_tpu_torch.ops import groupnorm as tgn
from anyedit_tpu_torch.weights import bridge
from test_torch_train import FAST, JAX_UNET1, PORT_UNET1, rel, unet1_params

torch.set_num_threads(1)
T = torch.from_numpy


@pytest.mark.parametrize("silu", [False, True])
def test_k2_function_matches_jax_vjp(silu):
    """K2's Function (`group_norm` under grad) against `jax.grad` through
    the Pallas `_gn_pallas` in interpret mode (its recompute VJP): dx,
    dscale, dbias relative L2 1e-4; NHWC on the JAX side, NCHW here."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(64)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)

    def f(x_, s_, b_):
        y = jgn._gn_pallas(x_, s_, b_, 32, 1e-5, silu, True)
        return jnp.sum(y * gy)
    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)), compiler_options=FAST)(
        jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
    ins = [T(x.transpose(0, 3, 1, 2).copy()).requires_grad_(), T(sc).requires_grad_(),
           T(bi).requires_grad_()]
    y = tgn.group_norm(*ins, 32, silu=silu)
    assert type(y.grad_fn).__name__ == "_GroupNormFnBackward"
    got = torch.autograd.grad(y, ins, T(gy.transpose(0, 3, 1, 2).copy()))
    assert rel(got[0].numpy().transpose(0, 2, 3, 1), ref[0]) <= 1e-4
    assert rel(got[1].numpy(), ref[1]) <= 1e-4 and rel(got[2].numpy(), ref[2]) <= 1e-4


def test_k1_function_matches_jax_through_unet(monkeypatch):
    """The one-level tiny UNet at 32x32 latents: level 0 has 1,024 tokens,
    so its 4 self-attention sites (down, mid, up twice) take K1's route in
    the port (the Function: the plain forward on the CPU, the recompute
    backward through `sdpa`) and the JAX UNet's XLA sdpa on the CPU.
    Gradients of <eps, g> with respect to the input latents, the context
    and the first site's q / k / v kernels against `jax.grad`: relative L2
    1e-4."""
    params = unet1_params(hw=32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    t = np.array([981, 21], np.int32)
    ctx = rng.standard_normal((2, 9, 32)).astype(np.float32)
    g = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    site = ("down_0_tf_0", "block_0", "attn1")

    def f(p, x_, c_):
        return jnp.sum(UNet2DCondition(JAX_UNET1).apply(p, x_, jnp.asarray(t), c_) * g)
    gp, gx, gc = jax.jit(jax.grad(f, argnums=(0, 1, 2)), compiler_options=FAST)(
        params, jnp.asarray(x), jnp.asarray(ctx))
    node = gp["params"]
    for k in site:
        node = node[k]

    calls = []
    k1 = tattn.flash_nomax
    monkeypatch.setattr(tattn, "flash_nomax", lambda *a: calls.append(a[0].shape) or k1(*a))
    unet = TUNet(PORT_UNET1)
    unet.load_state_dict(bridge.unet_state_dict(params, 1), strict=True)
    unet.requires_grad_(False)
    attn = unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    ws = [m.weight.requires_grad_() for m in (attn.to_q, attn.to_k, attn.to_v)]
    xs, cs = T(x).requires_grad_(), T(ctx).requires_grad_()
    out = unet(xs, T(t).long(), cs)
    got = torch.autograd.grad(out, [xs, cs] + ws, T(g))
    assert calls == [(8, 1024, 8)] * 4         # 2 samples x 4 heads
    assert rel(got[0].numpy(), gx) <= 1e-4 and rel(got[1].numpy(), gc) <= 1e-4
    for w, name in zip(got[2:], ("to_q", "to_k", "to_v")):
        assert rel(w.numpy().T, node[name]["kernel"]) <= 1e-4, name
