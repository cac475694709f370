"""Flux in the PyTorch port against the JAX package: RoPE, the forward on
TINY_FLUX with and without guidance, the W8A8 mode, `flux_sample` /
`flux_pair`, the weight bridge's `flux` slot in both directions, and
FLUX_SCHNELL's parameter count.

Every Flux here has non-zero modulation weights: the JAX Flux initializes
each modulation Dense at zero, so that with seeded init every gate is 0 and
the blocks drop out of the output, which would let a broken block pass.
`flux_params` draws those kernels like every other (N(0, 1/fan_in)) and the
per-head RMS norm gains as 1 + N(0, 0.1^2).

Tolerances: `rope_freqs` and `apply_rope` 1e-6 (fp32; bf16 within one
rounding); the velocity in fp32 1e-4; `flux_sample`'s latents 1e-4 after 4
steps. W8A8: the int8 codes and scales of the port's quantization of the
bridged float tree equal the bridged JAX `quantize_params` tree's; the
port's W8A8 Flux is held to the JAX W8A8 Flux and to its own float Flux
within the JAX package's int8 bound (cosine > 0.95,
`tests/test_quant.py:139-162`). The bridge round trips are bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.diffusion.ultraedit import flux_pair as jax_flux_pair
from anyedit_tpu.diffusion.ultraedit import flux_sample as jax_flux_sample
from anyedit_tpu.models import flux as jflux
from anyedit_tpu.ops.quant import quantize_params
from anyedit_tpu.weights.convert import convert_flux
from anyedit_tpu_torch.core import trace
from anyedit_tpu_torch.diffusion import flux_pair, flux_sample
from anyedit_tpu_torch.models import flux
from anyedit_tpu_torch.ops import quant as tq
from anyedit_tpu_torch.ops.cuda_graph import Graphed
from anyedit_tpu_torch.weights import bridge
from anyedit_tpu_torch.weights.init import seeded_init_
from test_torch_bridge import F32, TF32, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
JCFG = dataclasses.replace(jflux.TINY_FLUX, **F32)
MODS = ("img_mod", "txt_mod", "mod", "final_mod")
LT = 6           # text tokens


def _close(got, ref, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol, rtol=0)


def _port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return dataclasses.replace(flux.FluxConfig(**{**fields, **TF32}), **kw)


def _inputs(cfg, batch=2, hw=8, seed=60):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, hw, hw, cfg.in_channels)).astype(np.float32),
            rng.uniform(0, 1000, batch).astype(np.float32),
            rng.standard_normal((batch, LT, cfg.context_dim)).astype(np.float32),
            rng.standard_normal((batch, cfg.pooled_dim)).astype(np.float32))


def flux_params(cfg, seed):
    """Seeded numpy params for the JAX Flux: every modulation kernel
    non-zero, the RMS norm gains near 1."""
    guidance = (np.ones(1, np.float32),) if cfg.guidance_embed else ()
    tree = random_flax_params(jflux.Flux(cfg), _inputs(cfg, 1) + guidance, seed)
    rng = np.random.default_rng(seed + 1000)
    n = 0

    def fix(path, leaf):
        nonlocal n
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] == "g":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if keys[-1] == "kernel" and any(k in MODS for k in keys):
            assert np.abs(leaf).mean() > 1e-3
            n += 1
        return leaf
    tree = jax.tree_util.tree_map_with_path(fix, tree)
    assert n == 2 * cfg.double_depth + cfg.single_depth + 1
    return tree


def _port_flux(tree, cfg):
    m = flux.Flux(cfg)
    m.load_state_dict(bridge.flux_state_dict(tree), strict=True)
    return m.eval()


# ---- RoPE -------------------------------------------------------------------

def test_make_ids_and_rope_freqs_match():
    ids = flux.make_ids(3, 4, 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jflux.make_ids(3, 4, 5)))
    cos, sin = flux.rope_freqs(ids, (4, 6, 6))
    jcos, jsin = jflux.rope_freqs(jnp.asarray(ids.numpy()), (4, 6, 6))
    _close(cos, jcos, 1e-6)
    _close(sin, jsin, 1e-6)
    assert tuple(cos.shape) == (17, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(dtype):
    """Interleaved pairs rotated in fp32, cast back: fp32 within 1e-6, bf16
    within one bf16 rounding of the output."""
    ids = flux.make_ids(2, 3, 4)
    cos, sin = flux.rope_freqs(ids, (4, 6, 6))
    x = np.random.default_rng(61).standard_normal((2, 3, 10, 16)).astype(np.float32)
    tx = T(x).to(getattr(torch, dtype))
    got = flux.apply_rope(tx, cos, sin)
    assert got.dtype == tx.dtype
    ref = jflux.apply_rope(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(cos.numpy()),
                           jnp.asarray(sin.numpy()))
    _close(got, np.asarray(ref, np.float32), 1e-6 if dtype == "float32" else 2 ** -7 * 4)


# ---- the forward -------------------------------------------------------------

@pytest.mark.parametrize("guidance", [False, True])
def test_flux_matches(guidance):
    """TINY_FLUX (one double block, two single blocks) in fp32 on live
    modulations, with the guidance embedding (FLUX_DEV's layout) and
    without: velocity within 1e-4."""
    jcfg = dataclasses.replace(JCFG, guidance_embed=guidance)
    tree = flux_params(jcfg, 62 + guidance)
    args = _inputs(jcfg)
    g = np.array([3.5, 1.0], np.float32) if guidance else None
    ref = jax.jit(jflux.Flux(jcfg).apply)(tree, *args, g)
    with torch.no_grad():
        got = _port_flux(tree, _port_cfg(jcfg))(*(T(a) for a in args),
                                                None if g is None else T(g))
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    _close(got, ref, 1e-4)


def test_flux_blocks_move_the_output():
    """With live modulations a change to the double block's text FFN and
    to the last single block's MLP input moves the velocity; on the seeded
    init, whose modulations are zero as in the JAX package, neither does."""
    cfg = _port_cfg(JCFG)
    args = [T(a) for a in _inputs(JCFG)]
    seeded = seeded_init_(flux.Flux(cfg), 0)
    assert float(seeded.transformer_blocks[0].norm1.linear.weight.detach().abs().max()) == 0.0
    for m, live in ((_port_flux(flux_params(JCFG, 64), cfg), True), (seeded, False)):
        with torch.no_grad():
            base = m(*args)
            for p in (m.transformer_blocks[0].ff_context.net[2].weight,
                      m.single_transformer_blocks[-1].proj_mlp.weight):
                p.add_(0.05)
                moved = float((m(*args) - base).abs().max())
                p.sub_(0.05)
                assert (moved > 1e-3) if live else (moved == 0.0), (live, moved)


def test_flux_param_names_are_diffusers():
    """The port's Flux carries FluxTransformer2DModel's names and shapes,
    and the dtype split of the JAX package: block Linears and the patch,
    context and output projections in `dtype`, the modulations and the
    embeddings fp32."""
    cfg = _port_cfg(JCFG, dtype=torch.bfloat16, guidance_embed=True)
    sd = flux.Flux(cfg).state_dict()
    want = {"x_embedder.weight": ((32, 16), torch.bfloat16),
            "context_embedder.weight": ((32, 16), torch.bfloat16),
            "time_text_embed.timestep_embedder.linear_1.weight": ((32, 256), torch.float32),
            "time_text_embed.guidance_embedder.linear_2.weight": ((32, 32), torch.float32),
            "time_text_embed.text_embedder.linear_1.weight": ((32, 8), torch.float32),
            "transformer_blocks.0.norm1.linear.weight": ((192, 32), torch.float32),
            "transformer_blocks.0.norm1_context.linear.bias": ((192,), torch.float32),
            "transformer_blocks.0.attn.to_q.weight": ((32, 32), torch.bfloat16),
            "transformer_blocks.0.attn.add_v_proj.bias": ((32,), torch.bfloat16),
            "transformer_blocks.0.attn.norm_added_k.weight": ((16,), torch.float32),
            "transformer_blocks.0.attn.to_add_out.weight": ((32, 32), torch.bfloat16),
            "transformer_blocks.0.ff_context.net.0.proj.weight": ((128, 32), torch.bfloat16),
            "single_transformer_blocks.1.norm.linear.weight": ((96, 32), torch.float32),
            "single_transformer_blocks.1.proj_mlp.weight": ((128, 32), torch.bfloat16),
            "single_transformer_blocks.1.proj_out.weight": ((32, 160), torch.bfloat16),
            "single_transformer_blocks.1.attn.norm_k.weight": ((16,), torch.float32),
            "norm_out.linear.weight": ((64, 32), torch.float32),
            "proj_out.weight": ((16, 32), torch.bfloat16)}
    for k, (shape, dtype) in want.items():
        assert (tuple(sd[k].shape), sd[k].dtype) == (shape, dtype), k


def test_flux_schnell_param_count():
    """FLUX_SCHNELL on the meta device holds exactly the JAX Flux's
    parameter count (`tests/test_mmdit_flux.py`: about 11.9 B), 3.2 B of them
    the fp32 modulations and embeddings; in W8A8, every block Linear weight
    is int8 (8.6 B)."""
    shapes = jax.eval_shape(jflux.Flux(jflux.FLUX_SCHNELL).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 16, 16, 16), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.float32),
                            jax.ShapeDtypeStruct((1, 64, 4096), jnp.float32),
                            jax.ShapeDtypeStruct((1, 768), jnp.float32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    by_dtype = {}
    for p in flux.Flux(flux.FLUX_SCHNELL, device="meta").parameters():
        by_dtype[p.dtype] = by_dtype.get(p.dtype, 0) + p.numel()
    assert sum(by_dtype.values()) == n_jax and 11.8e9 < n_jax < 12.0e9, n_jax
    assert 3.1e9 < by_dtype[torch.float32] < 3.3e9, by_dtype
    q = flux.Flux(dataclasses.replace(flux.FLUX_SCHNELL, quant=True), device="meta")
    n_int8 = sum(b.numel() for b in q.buffers() if b.dtype == torch.int8)
    assert 8.5e9 < n_int8 < 8.7e9 and n_int8 + by_dtype[torch.float32] < n_jax


# ---- the attention route (K6) ---------------------------------------------------

@pytest.mark.parametrize("device_type,dtype,head_dim,k6", [
    ("cuda", torch.bfloat16, 128, True), ("cpu", torch.bfloat16, 128, False),
    ("cuda", torch.float32, 128, False), ("cuda", torch.bfloat16, 16, False),
    ("cpu", torch.float32, 16, False)])
def test_flux_attention_route(device_type, dtype, head_dim, k6):
    """Flux's joint attention takes K6 on CUDA bf16 at head dim 128 (the
    published width) and `sdpa` on the CPU, in fp32 and at TINY_FLUX's
    head dim 16: a function of those three alone."""
    assert flux.takes_k6(device_type, dtype, head_dim) is k6


def _count_calls(monkeypatch, names):
    """Wraps `flux.<name>` for each name so that its calls are counted."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _name=name, _real=getattr(flux, name), **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(flux, name, counted)
    return calls


@pytest.mark.parametrize("route_k6", [False, True])
def test_flux_blocks_take_the_routed_attention(monkeypatch, route_k6):
    """Each double and single block calls the attention its route names,
    once a call: `sdpa` on the CPU, `flash_sdpa` where the route is forced
    to K6 (its plain version on CPU tensors), with the same velocity in
    fp32 (1e-4, the file's velocity tolerance)."""
    m = _port_flux(flux_params(JCFG, 72), _port_cfg(JCFG))
    x, t, ctx, pooled = (T(a) for a in _inputs(JCFG, batch=1, seed=73))
    with torch.no_grad():
        ref = m(x, t, ctx, pooled)
    calls = _count_calls(monkeypatch, ("sdpa", "flash_sdpa"))
    if route_k6:
        monkeypatch.setattr(flux, "takes_k6", lambda *a: True)
    with torch.no_grad():
        got = m(x, t, ctx, pooled)
    n = JCFG.double_depth + JCFG.single_depth
    assert calls == ({"sdpa": 0, "flash_sdpa": n} if route_k6 else
                     {"sdpa": n, "flash_sdpa": 0})
    _close(got, ref.numpy(), 1e-4)


def _traced_k6(m, steps=2):
    """The `k6` attribute of each `flux` span of a traced `flux_sample`."""
    _, _, ctx, pooled = _inputs(JCFG, batch=1, seed=75)
    noise = torch.from_numpy(np.random.default_rng(76).standard_normal((1, 8, 8, 4))
                             .astype(np.float32))
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            flux_sample(m, noise, T(ctx), T(pooled), num_steps=steps)
    got = [r.attrs["k6"] for r in trace.records() if r.name == "flux"]
    trace.clear()
    return got


def test_flux_span_counts_k6_launches(monkeypatch):
    """The `flux` span's `k6`: the K6 launches of one call, as the model
    reports them (`Flux.k6_launches`, the route its config takes on its
    parameters' device). 57 = 19 + 38 for FLUX_SCHNELL on the card, its
    W8A8 build too (the attention stays bf16); 0 on the CPU, in fp32 and
    for TINY_FLUX. A traced `flux_sample` on the CPU records 0 a call, and
    one a block where the route is forced to K6, as many as the blocks call
    `flash_sdpa`."""
    s = flux.FLUX_SCHNELL
    assert flux.k6_per_call(s, "cuda") == 57 == s.double_depth + s.single_depth
    assert flux.k6_per_call(dataclasses.replace(s, quant=True), torch.device("cuda")) == 57
    assert flux.k6_per_call(s, "cpu") == 0
    assert flux.k6_per_call(dataclasses.replace(s, dtype=torch.float32), "cuda") == 0
    assert flux.k6_per_call(flux.TINY_FLUX, "cuda") == 0
    m = _port_flux(flux_params(JCFG, 74), _port_cfg(JCFG))
    assert m.k6_launches == 0 and flux.Flux(s, device="meta").k6_launches == 0
    assert _traced_k6(m) == [0, 0]
    calls = _count_calls(monkeypatch, ("flash_sdpa",))
    monkeypatch.setattr(flux, "takes_k6", lambda *a: True)
    n = JCFG.double_depth + JCFG.single_depth
    assert m.k6_launches == n
    assert _traced_k6(m) == [n, n] and calls["flash_sdpa"] == 2 * n


def test_flux_span_reads_k6_through_the_graph_wrapper(monkeypatch):
    """`flux_sample` reads `k6_launches` through `Graphed`, as the zoo's
    sampler calls it, and records 0 for a model that does not report it."""
    m = _port_flux(flux_params(JCFG, 77), _port_cfg(JCFG))
    monkeypatch.setattr(flux, "takes_k6", lambda *a: True)
    n = JCFG.double_depth + JCFG.single_depth
    assert _traced_k6(Graphed(m)) == [n, n]

    def plain(*a):
        return m(*a)
    plain.cfg = m.cfg
    assert _traced_k6(plain) == [0, 0]


# ---- W8A8 --------------------------------------------------------------------

def _quant_trees(seed=65):
    qm = jflux.Flux(dataclasses.replace(JCFG, quant=True))
    shapes = jax.eval_shape(lambda: qm.init(jax.random.key(0), *_inputs(JCFG, 1)))
    ftree = flux_params(JCFG, seed)
    return ftree, {"params": quantize_params(shapes["params"], ftree["params"])}


def test_w8a8_flux_matches_jax():
    """The port's quantization of the bridged float Flux gives exactly the
    bridged JAX `quantize_params` tree (codes, scales, float leaves); the
    W8A8 Flux tracks the JAX W8A8 Flux and its own float Flux (cosine >
    0.95). Modulations, embeddings and the head stay float."""
    ftree, qtree = _quant_trees()
    qm = flux.Flux(_port_cfg(JCFG, quant=True))
    got = tq.quantize_state_dict(qm, bridge.flux_state_dict(ftree))
    want = bridge.flux_state_dict(qtree)
    assert set(got) == set(want) == set(qm.state_dict())
    n_int8 = 0
    for key, w in want.items():
        n_int8 += w.dtype == torch.int8
        np.testing.assert_array_equal(got[key].numpy(), w.to(got[key].dtype).numpy(),
                                      err_msg=key)
    assert n_int8 == 12 + 2 * 5      # double: q k v o fc1 fc2 x 2 streams; single: 5
    assert not any(".norm" in k or "embed" in k or k.startswith("proj_out")
                   for k, w in got.items() if w.dtype == torch.int8)
    qm.load_state_dict(got, strict=True)
    args = _inputs(JCFG)
    ref = np.asarray(jax.jit(jflux.Flux(dataclasses.replace(JCFG, quant=True)).apply)(
        qtree, *args))
    with torch.no_grad():
        out = qm(*(T(a) for a in args)).numpy()
        flt = _port_flux(ftree, _port_cfg(JCFG))(*(T(a) for a in args)).numpy()

    def cos(a, b):
        return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert np.isfinite(out).all()
    assert cos(out, ref) > 0.95 and cos(out, flt) > 0.95, (cos(out, ref), cos(out, flt))


# ---- the bridge --------------------------------------------------------------

def _flat_equal(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert np.asarray(y).dtype == np.asarray(x).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


@pytest.mark.parametrize("guidance", [False, True])
def test_flux_bridge_round_trips(guidance):
    """The bridged state dict loads strictly into the port's Flux; fed
    (under diffusers' keys) through the JAX package's `convert_flux`, and
    through `flux_tree`, it gives the Flax tree back bit for bit."""
    jcfg = dataclasses.replace(JCFG, guidance_embed=guidance)
    tree = flux_params(jcfg, 66)
    sd = bridge.flux_state_dict(tree)
    flux.Flux(_port_cfg(jcfg)).load_state_dict(sd, strict=True)
    _flat_equal(tree, convert_flux(tree, {k: v.numpy() for k, v in sd.items()}))
    _flat_equal(tree, bridge.flux_tree(sd, tree))


def test_flux_tree_round_trips_w8a8():
    """W8A8 trees too: the split kernel_q and kernel_scale rows come back
    fused, int8 kernels still int8."""
    _, qtree = _quant_trees(67)
    qm = flux.Flux(_port_cfg(JCFG, quant=True))
    qm.load_state_dict(bridge.flux_state_dict(qtree), strict=True)
    _flat_equal(qtree, bridge.flux_tree(qm.state_dict(), qtree))


# ---- the sampler --------------------------------------------------------------

def test_flux_sample_matches():
    """Four flow steps at shift 1.0 on the tiny Flux, JAX's start noise
    handed to the port: latents within 1e-4; `flux_pair` gives both
    captions the same noise (the first sample equals `flux_sample`, and
    equal captions give equal samples)."""
    tree = flux_params(JCFG, 68)
    _, _, ctx, pooled = _inputs(JCFG, batch=2, seed=69)
    key = jax.random.key(5)
    jm = jflux.Flux(JCFG)

    def v_fn(x, t, c, p):
        return jm.apply(tree, x, t, c, p)
    ref_a, ref_b = jax.jit(jax_flux_pair, static_argnums=(0, 1, 6))(v_fn, (1, 8, 8, 4), ctx[:1], pooled[:1], ctx[1:], pooled[1:],
                                 seed=5)
    noise = T(np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32)))
    m = _port_flux(tree, _port_cfg(JCFG))
    with torch.no_grad():
        a, b = flux_pair(m, noise, T(ctx[:1]), T(pooled[:1]), T(ctx[1:]), T(pooled[1:]))
        one = flux_sample(m, noise, T(ctx[:1]), T(pooled[:1]))
        same = flux_pair(m, noise, T(ctx[:1]), T(pooled[:1]), T(ctx[:1]), T(pooled[:1]))
    assert float(np.abs(np.asarray(ref_a) - noise.numpy()).max()) > 0.1
    _close(a, ref_a, 1e-4)
    _close(b, ref_b, 1e-4)
    assert torch.equal(a, one) and torch.equal(*same)
    assert float((a - b).abs().max()) > 1e-3


def test_flux_sample_with_guidance_matches():
    """FLUX_DEV's layout: the guidance vector reaches the velocity call."""
    jcfg = dataclasses.replace(JCFG, guidance_embed=True)
    tree = flux_params(jcfg, 70)
    _, _, ctx, pooled = _inputs(jcfg, batch=1, seed=71)
    key, g = jax.random.key(6), np.array([3.5], np.float32)
    jm = jflux.Flux(jcfg)
    ref = jax.jit(lambda c, p, gg: jax_flux_sample(
        lambda x, t, c_, p_, g_: jm.apply(tree, x, t, c_, p_, g_), (1, 8, 8, 4), c, p, key,
        num_steps=3, guidance=gg))(ctx, pooled, g)
    noise = T(np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32)))
    with torch.no_grad():
        got = flux_sample(_port_flux(tree, _port_cfg(jcfg)), noise, T(ctx), T(pooled),
                          num_steps=3, guidance=T(g))
    _close(got, ref, 1e-4)
