"""The factory core of the PyTorch port against the JAX package: `host_rng`,
the run ledger, the pre- and post-filter tables and decisions, and the tiny
zoo config.

These are copies (the JAX modules cannot be imported without JAX), so the
tolerance is zero everywhere: equal draws, byte-identical ledgers, equal
tables and decisions.
"""

import dataclasses
import hashlib
import itertools
import zlib

import numpy as np
import pytest
import torch

from anyedit_tpu.cli import tiny_zoo_config as jax_tiny_zoo_config
from anyedit_tpu.core import ledger as jledger
from anyedit_tpu.core import rng as jrng
from anyedit_tpu.core.schema import EDIT_TYPES, InstructionRecord as JaxRecord
from anyedit_tpu.filters import post_filter as jpost
from anyedit_tpu.filters import pre_filter as jpre
from anyedit_tpu_torch.core import ledger, rng
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.filters import post_filter, pre_filter
from anyedit_tpu_torch.runtime.zoo import tiny_zoo_config

KEYS = [f"color_alter::img_{i}.jpg::make it {c}" for i in range(40)
        for c in ("red", "blue")] + ["", "ünïcode/key", "a" * 300]


def test_host_rng_matches():
    """The same uniforms, integers and choices for 83 record keys at 3 seeds."""
    for seed, key in itertools.product((0, 7, 2 ** 40), KEYS):
        a, b = jrng.host_rng(seed, key), rng.host_rng(seed, key)
        np.testing.assert_array_equal(a.uniform(size=4), b.uniform(size=4))
        np.testing.assert_array_equal(a.integers(0, 1000, 5), b.integers(0, 1000, 5))
        assert a.choice(["x", "y", "z"]) == b.choice(["x", "y", "z"])


def test_record_key_seeds_a_generator():
    """`record_key` is deterministic, differs across records and seeds, and
    seeds a torch.Generator; its low word is the JAX package's record hash."""
    seeds = {rng.record_key(s, k) for s in (0, 1) for k in KEYS}
    assert len(seeds) == 2 * len(KEYS)
    assert rng.record_key(3, "r") == rng.record_key(3, "r")
    for s in (0, 2 ** 31 - 1):
        g = torch.Generator().manual_seed(rng.record_key(s, KEYS[0]))
        assert torch.rand(2, generator=g).shape == (2,)
    assert rng.record_key(0, "r") == rng.record_key(2 ** 32, "r")
    for k in KEYS:   # the hash `anyedit_tpu/core/rng.py::record_key` folds in
        h = int.from_bytes(hashlib.sha256(k.encode()).digest()[:4], "little")
        assert rng.record_key(9, k) == (9 << 32) | h


def _records(n, cls):
    return [cls.from_json({"edit": f"make the car {c}", "edited object": "car",
                           "input": "a car", "output": f"a {c} car",
                           "edit_type": "color_alter", "image_file": f"img_{i}.jpg",
                           "new background": "a beach"})
            for i, c in zip(range(n), itertools.cycle(["red", "blue", "green"]))]


def _mark_all(led, recs):
    for i, r in enumerate(recs):
        status = ("success", "failure", "filtered")[i % 3]
        led.mark(r, status, {"i": i, "scores": {"clip": 0.25 * i}} if i % 2 else None)


def test_ledger_bytes_match(tmp_path):
    """The same marks give byte-identical JSONL and reference files."""
    jl = jledger.RunLedger(tmp_path / "j" / "ledger.jsonl")
    tl = ledger.RunLedger(tmp_path / "t" / "ledger.jsonl")
    _mark_all(jl, _records(7, JaxRecord))
    _mark_all(tl, _records(7, InstructionRecord))
    jl.close()
    tl.close()
    assert (tmp_path / "t" / "ledger.jsonl").read_bytes() == \
        (tmp_path / "j" / "ledger.jsonl").read_bytes()
    for end in (None, 5):
        jledger.RunLedger(jl.path).export_reference_files(tmp_path / "je", 0, end)
        ledger.RunLedger(tl.path).export_reference_files(tmp_path / "te", 0, end)
    names = sorted(p.name for p in (tmp_path / "je").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "te").iterdir()) and len(names) == 6
    for n in names:
        assert (tmp_path / "te" / n).read_bytes() == (tmp_path / "je" / n).read_bytes()


@pytest.mark.parametrize("torn", [False, True])
def test_ledger_resume_matches(tmp_path, torn):
    """Reopened ledgers (with a torn final line or not) agree on counts,
    statuses and the pending records of every shard."""
    paths = {}
    for name, mod, cls in (("j", jledger, JaxRecord), ("t", ledger, InstructionRecord)):
        led = mod.RunLedger(tmp_path / name / "ledger.jsonl")
        _mark_all(led, _records(5, cls))
        led.close()
        if torn:
            with open(led.path, "a") as f:
                f.write('{"key": "color_alter::img_9.jpg::x", "sta')
        paths[name] = led.path
    jl, tl = jledger.RunLedger(paths["j"]), ledger.RunLedger(paths["t"])
    assert tl.counts() == jl.counts() == {"success": 2, "failure": 2, "filtered": 1}
    jrecs, trecs = _records(9, JaxRecord), _records(9, InstructionRecord)
    assert [tl.status(r) for r in trecs] == [jl.status(r) for r in jrecs]
    for shard in (None, ledger.Shard(0, 2), ledger.Shard(1, 2), ledger.Shard(start=3, end=8)):
        jshard = None if shard is None else jledger.Shard(**dataclasses.asdict(shard))
        assert [i for i, _ in tl.pending(trecs, shard)] == \
            [i for i, _ in jl.pending(jrecs, jshard)]
    jl.close()
    tl.close()


def test_shard_slices_match():
    for n, count in itertools.product(range(0, 12), range(1, 5)):
        for index in range(count):
            assert ledger.Shard(index, count).slice(n) == jledger.Shard(index, count).slice(n)
    for start, end in itertools.product((None, 0, 2, 9), (None, 3, 20)):
        assert ledger.Shard(start=start, end=end).slice(7) == \
            jledger.Shard(start=start, end=end).slice(7)


def test_threshold_tables_match():
    assert pre_filter.PRE_THRESHOLDS == jpre.PRE_THRESHOLDS
    assert pre_filter.BASIC_COLORS == jpre.BASIC_COLORS
    assert pre_filter.HUMAN_WORDS == jpre.HUMAN_WORDS
    assert post_filter.POST_THRESHOLDS == jpost.POST_THRESHOLDS
    assert [f.name for f in dataclasses.fields(post_filter.Scores)] == \
        [f.name for f in dataclasses.fields(jpost.Scores)]
    assert [f.name for f in dataclasses.fields(pre_filter.PreScores)] == \
        [f.name for f in dataclasses.fields(jpre.PreScores)]


# score grids around every threshold, with None (not computed) in each
_VALS = (None, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.5, 0.85, 0.95, 2.0, 3.0)
_BOOLS = (None, False, True)


@pytest.mark.parametrize("edit_type", EDIT_TYPES + ("unknown_type",))
def test_filter_decisions_match(edit_type):
    """Both packages' pre- and post-filter decisions on a grid of scores,
    edited objects, colours, verbs and uniforms."""
    rs = np.random.default_rng(zlib.crc32(edit_type.encode()))

    def pick(values):
        return values[rs.integers(len(values))]
    for _ in range(400):
        kw = dict(width=pick([100, 300, 640]), height=pick([100, 480, 700]),
                  clip=pick(_VALS), aesthetic=pick(_VALS),
                  object_ratio=pick(_VALS), background_vqa_ok=pick(_BOOLS))
        args = dict(edited_object=pick(["", "car", "young man", "dog"]),
                    new_attr=pick(["", "red", "teal", "Blue"]),
                    verbs=pick([None, [], ["run"]]),
                    rng_uniform=pick([0.0, 0.15, 0.5, 0.79, 0.95]))
        assert pre_filter.pre_filter_decision(edit_type, pre_filter.PreScores(**kw), **args) \
            == jpre.pre_filter_decision(edit_type, jpre.PreScores(**kw), **args)
        sc = dict(clip=pick(_VALS), dir_clip=pick(_VALS), l1=pick(_VALS),
                  object_present=pick(_BOOLS), vqa_yes=pick(_BOOLS), ocr_match=pick(_BOOLS))
        assert post_filter.post_filter_decision(edit_type, post_filter.Scores(**sc)) \
            == jpost.post_filter_decision(edit_type, jpost.Scores(**sc))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _compare(port, ref, path):
    """Every field the two values share, recursively; a dtype must be fp32
    in the port (its one named difference beside BERT's vocabulary)."""
    if dataclasses.is_dataclass(port):
        shared = _fields(port).keys() & _fields(ref).keys()
        assert shared, path
        for name in sorted(shared):
            _compare(getattr(port, name), getattr(ref, name), f"{path}.{name}")
    elif isinstance(port, torch.dtype):
        assert port == torch.float32, path
    elif path == "cfg.gdino.bert.vocab_size":
        assert (port, ref) == (30522, 128)
    else:
        assert port == ref, (path, port, ref)


def test_tiny_zoo_config_matches_jax():
    """The port's tiny config against `anyedit_tpu/cli.py::tiny_zoo_config`
    on every field they share, `box_threshold` (0.0) included, UltraEdit's
    fields (`sd3_vae`, `text_g`, `flux_text`, whose vocabulary is the T5
    hash modulus, and `mmdit`), the SDXL refine stack's (`refine_unet`:
    TINY_XL_UNET at a context of 48, `sdxl_vae`, `depth_cfg`: TINY_DEPTH)
    and the two LM gates' (`ocr`: TINY_OCR, `vila`: TINY_VILA)."""
    port, ref = tiny_zoo_config(), jax_tiny_zoo_config()
    assert port.box_threshold == ref.box_threshold == 0.0
    assert port.flux_text.vocab_size == ref.flux_text.vocab_size == 30522
    assert port.refine_unet.context_dim == ref.refine_unet.context_dim == 48
    assert port.refine_unet.addition_embed_dim == ref.refine_unet.addition_embed_dim == 16
    assert port.depth_cfg.backbone.img_size == ref.depth_cfg.backbone.img_size == 28
    shared = _fields(port).keys() & _fields(ref).keys()
    assert {"canvas", "gdino", "sam", "ip2p_unet", "vae", "text", "vision", "eva",
            "qformer", "box_threshold", "sd3_vae", "text_g", "flux_text", "mmdit",
            "refine_unet", "sdxl_vae", "depth_cfg", "ocr", "vila"} <= shared
    for name in sorted(shared):
        _compare(getattr(port, name), getattr(ref, name), f"cfg.{name}")
