"""The Llama decoder of the PyTorch port against the JAX package's
(`anyedit_tpu/models/llama.py`): RMSNorm, RoPE, the causal forward through
the weight bridge, prefill + decode against the full forward and against
JAX (logits and caches), the left-padded ragged prefill, greedy ids, the
W8A8 decoder, the padded int8 contraction, and the bridge round trip
through `convert_llama`.

Both sides run the tiny config in fp32 on the same Flax tree. Tolerances:
fp32 logits and caches 1e-4 (outputs of unit scale); greedy ids equal;
W8A8 int8 codes and scales bit-equal, logits within the drift an int8 code
flip can carry (stated at the test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.models import llama as jl
from anyedit_tpu.ops import quant as jq
from anyedit_tpu.weights.convert import convert_llama
from anyedit_tpu_torch.models import llama as tl
from anyedit_tpu_torch.ops import quant as tq
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, TF32, random_flax_params

torch.set_num_threads(1)
T = torch.from_numpy
JAX_CFG = dataclasses.replace(jl.TINY_LLAMA, **F32)
PORT_CFG = dataclasses.replace(tl.TINY_LLAMA, **TF32)
RNG = np.random.default_rng(50)
IDS = RNG.integers(1, 256, (2, 9)).astype(np.int32)


def unit_norms(tree):
    """RMSNorm weights 1 + N(0, 0.1^2) (random_flax_params draws every
    leaf it does not name around 0)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, w: w + 1.0 if p[-1].key == "weight" else w, tree)


def llama_params(cfg=JAX_CFG, seed=51):
    return unit_norms(random_flax_params(jl.Llama(cfg), (jnp.zeros((1, 4), jnp.int32),), seed))


def port_llama(tree, cfg=PORT_CFG):
    m = tl.Llama(cfg)
    m.load_state_dict(bridge.llama_state_dict(tree), strict=True)
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    tree = llama_params()
    return tree, port_llama(tree)


def _close(got, ref, atol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def test_rmsnorm_matches():
    x = RNG.standard_normal((3, 5, 32)).astype(np.float32) * 3
    w = (1 + 0.1 * RNG.standard_normal(32)).astype(np.float32)
    ref = jl.RMSNorm(1e-6).apply({"params": {"weight": w}}, x)
    norm = tl.RMSNorm(32, 1e-6)
    norm.weight.data = T(w)
    _close(norm(T(x)), ref, 1e-5)
    assert norm(T(x).to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches(theta):
    x = RNG.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = np.array([0, 1, 2, 5, 100, 1000, 4095], np.int32)
    ref = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tl.rope(T(x), T(pos), theta), ref, 1e-4)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_forward_matches(qkv_bias):
    """The full causal forward of the fp32 tiny Llama, through the bridge."""
    jcfg = dataclasses.replace(JAX_CFG, qkv_bias=qkv_bias)
    tree = llama_params(jcfg, 52 + qkv_bias)
    m = port_llama(tree, dataclasses.replace(PORT_CFG, qkv_bias=qkv_bias))
    ref = jl.Llama(jcfg).apply(tree, IDS)
    with torch.no_grad():
        _close(m(T(IDS).long()), ref)


def test_prefill_decode_matches(pair):
    """prefill on 6 tokens then decode steps 6..8: logits and caches equal
    JAX's, and the logits equal the full causal forward's at each position."""
    tree, m = pair
    jm = jl.Llama(JAX_CFG)
    full = jm.apply(tree, IDS)
    cache_len = 12
    emb = jm.apply(tree, IDS[:, :6], method=jl.Llama.embed)
    jlog, jcache = jm.apply(tree, emb, cache_len, method=jl.Llama.prefill)
    with torch.no_grad():
        tlog, tcache = m.prefill(m.embed(T(IDS[:, :6]).long()), cache_len)
        _close(tlog, jlog)
        _close(tlog, full[:, 5])
        for pos in (6, 7, 8):
            e = jm.apply(tree, IDS[:, pos:pos + 1], method=jl.Llama.embed)
            jlog, jcache = jm.apply(tree, e, jcache, pos, method=jl.Llama.decode_step)
            tlog, tcache = m.decode_step(m.embed(T(IDS[:, pos:pos + 1]).long()), tcache, pos)
            _close(tlog, jlog)
            _close(tlog, full[:, pos])
    assert len(tcache) == len(jcache) == JAX_CFG.layers
    for (tk, tv), (jk, jv) in zip(tcache, jcache):
        _close(tk, jk)
        _close(tv, jv)


def test_prefill_padded_matches(pair):
    """A left-padded ragged batch: prefill_padded's logits and caches, and
    one decode step with `start`, equal JAX's."""
    tree, m = pair
    jm = jl.Llama(JAX_CFG)
    lens = np.array([9, 4], np.int32)
    ids = IDS.copy()
    ids[1, :5] = 0
    emb = jm.apply(tree, ids, method=jl.Llama.embed)
    jlog, jcache = jm.apply(tree, emb, jnp.asarray(lens), 11, method=jl.Llama.prefill_padded)
    start = (9 - lens).astype(np.int32)
    tok = np.array([[7], [8]], np.int32)
    e = jm.apply(tree, tok, method=jl.Llama.embed)
    jlog2, _ = jm.apply(tree, e, jcache, 9, jnp.asarray(start), method=jl.Llama.decode_step)
    with torch.no_grad():
        tlog, tcache = m.prefill_padded(m.embed(T(ids).long()), T(lens), 11)
        _close(tlog, jlog)
        for (tk, tv), (jk, jv) in zip(tcache, jcache):
            # the pad slots of row 1 hold junk on both sides; compare the rest
            _close(tk[0], jk[0])
            _close(tk[1, :, 5:], jk[1, :, 5:])
            _close(tv[1, :, 5:], jv[1, :, 5:])
        tlog2, _ = m.decode_step(m.embed(T(tok).long()), tcache, 9, T(start))
        _close(tlog2, jlog2)


@pytest.mark.parametrize("eos", [None, "hit"])
def test_greedy_generate_ids_equal(pair, eos):
    """Greedy ids equal JAX's; with an eos id that the decode hits, every id
    after its first hit is the eos id on both sides."""
    tree, m = pair
    jm = jl.Llama(JAX_CFG)
    emb = jm.apply(tree, IDS, method=jl.Llama.embed)
    ref = jl.greedy_generate(jm, tree, emb, max_new=8)
    eos_id = None if eos is None else int(ref[0, 3])
    if eos_id is not None:
        ref = jl.greedy_generate(jm, tree, emb, max_new=8, eos_id=eos_id)
        assert (ref[0, 3:] == eos_id).all()
    got = tl.greedy_generate(m, m.embed(T(IDS).long()), max_new=8, eos_id=eos_id)
    np.testing.assert_array_equal(got, ref)


def test_greedy_generate_padded_ids_equal(pair):
    """Three prompts of 9, 4 and 1 tokens left-padded into one batch: ids
    equal JAX's padded decode and each row's unpadded decode."""
    tree, m = pair
    jm = jl.Llama(JAX_CFG)
    prompts = [IDS[0], IDS[1, :4], IDS[0, :1]]
    mat = np.zeros((3, 9), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for r, p in enumerate(prompts):
        mat[r, 9 - len(p):] = p
    emb = jm.apply(tree, mat, method=jl.Llama.embed)
    ref = jl.greedy_generate_padded(jm, tree, emb, jnp.asarray(lens), max_new=6)
    got = tl.greedy_generate_padded(m, m.embed(T(mat).long()), lens, max_new=6)
    np.testing.assert_array_equal(got, ref)
    for r, p in enumerate(prompts):
        one = tl.greedy_generate(m, m.embed(T(p[None]).long()), max_new=6)
        np.testing.assert_array_equal(one[0], got[r])


def _jax_quant_tree(tree):
    qm = jl.Llama(dataclasses.replace(JAX_CFG, quant=True))
    shapes = jax.eval_shape(lambda: qm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))
    return {"params": jq.quantize_params(shapes["params"], tree["params"])}


def test_w8a8_llama(pair):
    """The W8A8 tiny Llama: `quantize_llama`'s int8 codes and scales equal
    the bridged JAX `quantize_params` tree bit for bit; its logits on that
    tree stay within 0.05 of JAX's (relative L2; an fp32 rounding
    difference before a quantized layer can flip one activation code, and
    a flip moves a logit by about 1 %), and within cosine 0.95 of the float
    decoder's (the package's W8A8 drift bound)."""
    tree, m = pair
    qtree = _jax_quant_tree(tree)
    q = tl.quantize_llama(m)
    want = bridge.llama_state_dict(qtree)
    got = q.state_dict()
    assert set(got) == set(want)
    n_int8 = 0
    for key, w in want.items():
        if got[key].dtype == torch.int8:
            n_int8 += 1
        np.testing.assert_array_equal(got[key].numpy(), w.to(got[key].dtype).numpy(),
                                      err_msg=key)
    assert n_int8 == 7 * JAX_CFG.layers
    ref = np.asarray(jl.Llama(dataclasses.replace(JAX_CFG, quant=True)).apply(qtree, IDS))
    with torch.no_grad():
        out = q(T(IDS).long()).numpy()
        flt = m(T(IDS).long()).numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    cos = float((out * flt).sum() / (np.linalg.norm(out) * np.linalg.norm(flt)))
    assert rel <= 0.05 and cos > 0.95, (rel, cos)


@pytest.mark.parametrize("m", [1, 8, 16])
def test_int8_matmul_small_m(m):
    """At M <= 16 rows (a decode step, a short batch): `int8_matmul` (float64
    on the CPU) and the card's padded `torch._int_mm` route
    (`int_mm_padded`, run here on the CPU) equal an int64 contraction."""
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, 4096)).astype(np.int8)
    b = rng.integers(-127, 128, (4096, 24)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    for fn in (tq.int8_matmul, tq.int_mm_padded):
        got = fn(T(a), T(b))
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, 24)
        np.testing.assert_array_equal(got.numpy(), want)


def test_llama_bridge_round_trip(pair):
    """The port's state dict is HF-named: `convert_llama` reads it back into
    the JAX tree bit for bit, and `llama_tree` inverts the bridge."""
    tree, m = pair
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert_llama(tree, sd), tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.llama_tree(m.state_dict(), tree), tree)
