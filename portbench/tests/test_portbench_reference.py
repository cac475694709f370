"""The plain reference on small hand cases, its parameter names against the
program's modules, and its agreement with the program at the tiny presets
on the CPU (fp32 on both sides)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest
import torch

from portbench.harness import weights
from portbench.reference import edit, image, nets
from portbench.tests import tiny


def test_attention_with_one_key_returns_its_value():
    q, k = torch.randn(1, 2, 3, 4), torch.randn(1, 2, 1, 4)
    v = torch.randn(1, 2, 1, 4)
    assert torch.allclose(nets.attention(q, k, v), v.expand(1, 2, 3, 4))


def test_causal_attention_first_token_sees_itself_only():
    q, k, v = torch.randn(3, 1, 1, 5, 4).unbind(0)
    assert torch.allclose(nets.causal_attention(q, k, v)[..., 0, :], v[..., 0, :])


def test_ddim_leading_timesteps():
    ts, prev = edit.ddim_timesteps(100)
    assert ts[0] == 991 and ts[-1] == 1 and prev[-1] == -9 and len(ts) == 100
    assert edit.ddim_timesteps(4) == ([751, 501, 251, 1], [501, 251, 1, -249])


def test_clip_hash_ids_by_hand():
    # "ab": h = (97 * 131 + 98) % (49408 - 3) = 12805; id 12806
    assert edit.clip_hash_ids("Ab", 49408, 5) == [49406, 12806, 49407, 49407, 49407]
    assert edit.clip_hash_ids("ab ab ab ab", 49408, 4) == [49406, 12806, 12806, 49407]
    assert edit.clip_hash_ids("", 49408, 3) == [49406, 49407, 49407]


def test_resize_keeps_an_unchanged_axis_and_a_constant():
    x = torch.rand(5, 7, 3)
    assert torch.equal(image.resize(x, 5, 7), x)
    c = torch.full((6, 8, 3), 3.0)
    assert torch.allclose(image.resize(c, 4, 10), torch.full((4, 10, 3), 3.0))


def test_composite_by_hand():
    orig = torch.zeros(20, 20, 3, dtype=torch.uint8)
    ed = torch.full((20, 20, 3), 200, dtype=torch.uint8)
    none = torch.zeros(20, 20, dtype=torch.bool)
    assert torch.equal(image.composite(orig, ed, none), orig)
    full = torch.ones(20, 20, dtype=torch.bool)
    # the blend weight sums to 1 in fp32 within rounding, and the result
    # is truncated: 200 may come out as 199
    assert (image.composite(orig, ed, full).int() - 200).abs().max() <= 1
    one = none.clone()
    one[10, 10] = True
    w = image.feather(one)
    # a 5 x 5 block blurred: symmetric, largest at the centre, sum 25
    assert torch.allclose(w.sum(), torch.tensor(25.0), atol=1e-3)
    assert w[10, 10] == w.max() and torch.allclose(w, w.flip(0).flip(1).roll((1, 1), (0, 1)))


def test_png_round_trip_and_every_filter():
    a = np.random.default_rng(0).integers(0, 256, (4, 3, 3), dtype=np.uint8)
    assert np.array_equal(image.decode_png(image.encode_png(a)), a)
    # one row of each filter, encoded by hand
    rows, prev = [], np.zeros(9, np.int32)
    for f, r in zip((0, 1, 2, 3), a.reshape(4, 9).astype(np.int32)):
        left = np.concatenate([np.zeros(3, np.int32), r[:-3]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2}[f]
        rows.append(bytes([f]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    ihdr = struct.pack(">IIBBBBB", 3, 4, 8, 2, 0, 0, 0)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    assert np.array_equal(image.decode_png(png), a)


def _program_configs(cfg: dict):
    from portbench.drivers.factory import zoo_config
    zc = zoo_config(cfg)
    return zc.ip2p_unet, zc.vae, zc.text


@pytest.mark.parametrize("kind", ["unet", "vae", "clip_text"])
def test_reference_names_shapes_and_dtypes_are_the_programs(kind):
    """At the published widths, on the meta device."""
    import json
    from anyedit_tpu_torch.models.clip import CLIPTextEncoder
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    from anyedit_tpu_torch.models.vae import AutoencoderKL
    cfg = json.loads((tiny.BENCH / "configs/factory-sd15.json").read_text())
    ucfg, vaecfg, tcfg = _program_configs(cfg)
    prog = {"unet": lambda: UNet2DCondition(ucfg, device="meta"),
            "vae": lambda: AutoencoderKL(vaecfg, device="meta"),
            "clip_text": lambda: CLIPTextEncoder(tcfg, device="meta")}[kind]()
    ref = nets.build(kind, cfg[kind], torch.bfloat16, "meta")
    assert {n: (tuple(p.shape), p.dtype) for n, p in prog.named_parameters()} == \
        {n: (tuple(p.shape), p.dtype) for n, p in ref.named_parameters()}


def test_reference_against_the_program_at_tiny_widths():
    """The program's modules on the CPU (their plain paths, fp32) with the
    benchmark's weights against the reference's forward."""
    import json
    import tempfile
    from pathlib import Path
    from anyedit_tpu_torch.models.clip import CLIPTextEncoder
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    from anyedit_tpu_torch.models.vae import AutoencoderKL

    with tempfile.TemporaryDirectory() as d:
        cfg = json.loads((tiny.tiny_copy(Path(d)) / "configs/factory-sd15.json").read_text())
    ucfg, vaecfg, tcfg = _program_configs(cfg)
    cpu, f32 = torch.device("cpu"), torch.float32
    g = torch.Generator().manual_seed(0)

    def both(kind, prog, c, served=f32):
        weights.load_into(prog, weights.program_weights(kind, c, served, 5, cpu))
        return prog.eval(), weights.reference_module(kind, c, served, 5, cpu)
    p, r = both("unet", UNet2DCondition(ucfg), cfg["unet"])
    x, t = torch.randn(2, 8, 8, 8, generator=g), torch.tensor([3, 700])
    ctx = torch.randn(2, 5, 32, generator=g)
    assert torch.allclose(p(x, t, ctx), r(x, t, ctx), atol=1e-4, rtol=1e-4)
    p, r = both("vae", AutoencoderKL(vaecfg), cfg["vae"])
    px = torch.rand(1, 16, 16, 3, generator=g) * 2 - 1
    assert torch.allclose(p.encode(px)[0], r.encode(px)[0], atol=1e-4)
    z = torch.randn(1, 8, 8, 4, generator=g)
    assert torch.allclose(p.decode(z), r.decode(z), atol=1e-4)
    p, r = both("clip_text", CLIPTextEncoder(tcfg), cfg["clip_text"])
    ids = torch.tensor([edit.clip_hash_ids("a red car", 30522, 77)])
    assert torch.allclose(p(ids)[0], r(ids), atol=1e-4)
