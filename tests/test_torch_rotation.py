"""rotation_change in the PyTorch port against the JAX package: the
quaternion helpers, `determine_rotation` over a grid of yaw, pitch and roll
angles, the COLMAP `images.bin` reader and writer across the two packages
in both directions (a file with 2-D points too, written byte by byte here),
the pipeline with a seeded frame loader, and one record through both
`FactoryExecutor`s. Pure numpy: the results are equal, not close.
"""

import json
import struct

import numpy as np
import pytest

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits import rotation as jrot
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import rotation
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.runtime import executor

REC = {"edit": "turn the chair", "edited object": "chair", "input": "a chair",
       "output": "a chair seen from the side"}
FRAMES = np.random.default_rng(7).integers(0, 256, (2, 24, 32, 3), np.uint8)


def _quat(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    h = np.radians(deg) / 2
    return np.concatenate([[np.cos(h)], np.sin(h) * axis])


def _grid():
    """(q1, q2) pairs: yaw-dominant and tilted axes at angles inside and
    outside 10-120 degrees, both signs, from two start poses."""
    starts = [np.array([1.0, 0.0, 0.0, 0.0]), _quat([0.3, 1.0, -0.2], 35.0)]
    axes = [[0, 1, 0], [0, -1, 0], [0.2, 1, 0.1], [1, 0, 0], [0.8, 0.6, 0], [0, 0.6, 0.8]]
    angles = [5, 10.5, 30, 90, 119.5, 125, 179, 200]
    return [(q1, rotation.quat_mul(_quat(ax, a), q1))
            for q1 in starts for ax in axes for a in angles]


def test_determine_rotation_grid():
    """Every pair of the grid: the same decision and axis / angle; both
    directions and the None of both gates occur."""
    seen = set()
    for q1, q2 in _grid():
        got, ref = rotation.determine_rotation(q1, q2), jrot.determine_rotation(q1, q2)
        assert got == ref
        seen.add(got)
        ax, ang = rotation.relative_rotation(q1, q2)
        jax_, jang = jrot.relative_rotation(q1, q2)
        np.testing.assert_array_equal(ax, jax_)
        assert ang == jang
    assert seen == {"left", "right", None}


def _images():
    return {i: rotation.ColmapImage(i, _quat([0.1 * i, 1, 0], 10.0 * i),
                                    np.array([0.5, -1.0, 2.0 + i]), 1 + i % 2, f"frame_{i:03d}.jpg")
            for i in (1, 2, 5)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_round_trip_across_packages(tmp_path, writer):
    """A file written by one package reads the same in both; the writers'
    bytes are equal."""
    ims = _images()
    path = tmp_path / "images.bin"
    if writer == "port":
        rotation.write_images_binary(path, ims)
    else:
        jrot.write_images_binary(path, {k: jrot.ColmapImage(v.image_id, v.qvec, v.tvec,
                                                            v.camera_id, v.name)
                                        for k, v in ims.items()})
    other = tmp_path / "other.bin"
    rotation.write_images_binary(other, ims)
    assert path.read_bytes() == other.read_bytes()
    for read in (rotation.read_images_binary, jrot.read_images_binary):
        got = read(path)
        assert sorted(got) == sorted(ims)
        for k, im in ims.items():
            assert (got[k].image_id, got[k].camera_id, got[k].name) == \
                (im.image_id, im.camera_id, im.name)
            np.testing.assert_array_equal(got[k].qvec, im.qvec)
            np.testing.assert_array_equal(got[k].tvec, im.tvec)


def test_colmap_reader_skips_points(tmp_path):
    """A COLMAP file with 2-D points (24 bytes each) reads the same in both."""
    path = tmp_path / "images.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 2))
        for i, n_pts in ((3, 4), (9, 0)):
            f.write(struct.pack("<idddddddi", i, *_quat([0, 1, 0], 20.0 * i), 1.0, 2.0, 3.0, 7))
            f.write(f"img{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", n_pts))
            f.write(struct.pack("<ddq", 1.5, 2.5, -1) * n_pts)
    got, ref = rotation.read_images_binary(path), jrot.read_images_binary(path)
    assert sorted(got) == sorted(ref) == [3, 9]
    for k in got:
        assert got[k].name == ref[k].name
        np.testing.assert_array_equal(got[k].qvec, ref[k].qvec)


def _loader(deg):
    return lambda rec: (FRAMES[0], FRAMES[1], _quat([0, 1, 0], 0.0), _quat([0, 1, 0], deg))


@pytest.mark.parametrize("deg", [30.0, -45.0, 5.0])
def test_rotation_change_matches(deg):
    """The pipeline with a loader of two frames and a yaw pair: the same
    outcome, reason and instruction (the verb from the same rng); a success
    writes frame b as the edit and frame a as the input."""
    jrec, rec = JaxRecord.from_json(dict(REC, edit_type="rotation_change")), \
        InstructionRecord.from_json(dict(REC, edit_type="rotation_change"))
    ref = jrot.rotation_change(JaxToolbox(extra={"load_rotation_pair": _loader(deg)}), jrec,
                               None, np.random.default_rng(3))
    got = get_pipeline("rotation_change")(Toolbox(extra={"load_rotation_pair": _loader(deg)}),
                                          rec, None, np.random.default_rng(3))
    assert (got.success, got.reason) == (ref.success, ref.reason)
    assert got.success == (abs(deg) >= 10)
    assert rec.edit == jrec.edit
    if got.success:
        np.testing.assert_array_equal(got.edited, FRAMES[1])
        np.testing.assert_array_equal(got.input_image, FRAMES[0])
        assert rec.edit.endswith("to the left" if deg > 0 else "to the right")


def test_rotation_change_without_frames():
    for tb, jtb in ((Toolbox(), JaxToolbox()),
                    (Toolbox(extra={"load_rotation_pair": lambda r: None}),
                     JaxToolbox(extra={"load_rotation_pair": lambda r: None}))):
        got = rotation.rotation_change(tb, InstructionRecord.from_json(REC), None, None)
        ref = jrot.rotation_change(jtb, JaxRecord.from_json(REC), None, None)
        assert (got.success, got.reason) == (ref.success, ref.reason) == (False, got.reason)


def test_executors_match(tmp_path, monkeypatch):
    """One rotation_change record through both `FactoryExecutor`s (no
    pre-filter, the post-filter forced open): success, equal records and
    both frames written."""
    lines = {}
    for kind, ex_mod, box, rec_cls in (
            ("jax", jexecutor, JaxToolbox(extra={"load_rotation_pair": _loader(40.0)}), JaxRecord),
            ("port", executor, Toolbox(extra={"load_rotation_pair": _loader(40.0)}),
             InstructionRecord)):
        monkeypatch.setattr(ex_mod, "post_filter_decision", lambda *a, **k: True)
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(box, ex_mod.ExecutorConfig(output_root=str(root),
                                                               run_pre_filter=False))
        ex.run([rec_cls.from_json(dict(REC, edit_type="rotation_change", id="r0"))],
               lambda r: FRAMES[0])
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    (a,), (b,) = lines["port"], lines["jax"]
    assert a["status"] == b["status"] == "success"
    assert a["record"] == b["record"]
    assert a["payload"].keys() == b["payload"].keys() >= {"edited_file", "input_file"}
