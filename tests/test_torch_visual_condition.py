"""The visual condition types in the PyTorch port against the JAX package:
HED, `adaptive_avg_pool` at ragged sizes, the UperNet segmenter on Swin
(logits and the rendered map), the bridge slots `hed` and `seg`, the zoo's
`hed_fn()` and `seg_fn()` against the JAX zoo's on the same params, and one
record of each of visual_bbox, visual_depth, visual_scribble,
visual_segment and visual_sketch through both packages' pipelines and both
`FactoryExecutor`s.

Tolerances, all in fp32: HED's edge map and `hed_fn` within max-abs 1e-4
(values in [0, 1]); the pooled maps within 1e-5; the segmenter's logits
within 1e-4; the rendered maps (argmax of the logits, the first of tied
maxima on both sides) equal on at least 99 % of the pixels (an argmax may
flip where two logits sit within float error of each other); the depth
channel within 1 uint8 level on at most 1 % of the pixels (`test_torch_depth`);
the HED scribble (edges > 0.5) equal on at least 99 % of the pixels; the
drawn boxes and the Canny sketch exactly; bridges exactly.
"""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits import visual as jvisual
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models import hed as jhed
from anyedit_tpu.models import segmentation as jseg
from anyedit_tpu.models import swin as jswin
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import visual
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.models import hed as thed
from anyedit_tpu_torch.models import segmentation as tseg
from anyedit_tpu_torch.models import swin as tswin
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_torch_bridge import F32, random_flax_params
from test_torch_depth import JAX_DEPTH, depth_tree  # noqa: F401  (fixture)

torch.set_num_threads(1)
T = torch.from_numpy
ATOL = 1e-4
JAX_SEG = dataclasses.replace(jseg.TINY_SEG, backbone=dataclasses.replace(
    jseg.TINY_SEG.backbone, **F32), **F32)
PORT_SEG = tiny_zoo_config().seg_cfg
IMG = np.random.default_rng(81).integers(0, 256, (48, 40, 3), np.uint8)
VC_TYPES = ("visual_bbox", "visual_depth", "visual_scribble", "visual_segment",
            "visual_sketch")
REC = {"edit": "make the car red", "edited object": "car", "input": "a car on a street",
       "output": "a red car on a street"}
BOXES = np.array([[4.0, 6.0, 30.0, 40.0], [0.0, 0.0, 10.0, 10.0], [20.0, 2.0, 39.5, 47.0]],
                 np.float32)
VALID = np.array([True, False, True])


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


# ---- HED ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def hed_tree():
    return random_flax_params(jhed.HED(), (np.zeros((1, 36, 28, 3), np.float32),), 90)


def test_hed_matches(hed_tree):
    """HED at 36 x 28 (the pools floor 9 -> 4 -> 2 and 7 -> 3 -> 1): the
    edge map within ATOL, and not constant."""
    px = np.random.default_rng(1).uniform(0, 255, (2, 36, 28, 3)).astype(np.float32)
    ref = jhed.HED().apply(hed_tree, px)
    m = thed.HED()
    m.load_state_dict(bridge.hed_state_dict(hed_tree))
    with torch.no_grad():
        got = m.eval()(T(px))
    _close(got, ref)
    assert float(np.asarray(ref).std()) > 1e-3


def test_hed_bridge_round_trips(hed_tree):
    """`hed`: the checkpoint's names (`norm` (1, 3, 1, 1), block{s}.convs.{i},
    block{s}.projection), the port module's keys exactly, and back."""
    sd = bridge.hed_state_dict(hed_tree)
    assert set(sd) == set(thed.HED().state_dict())
    assert sd["norm"].shape == (1, 3, 1, 1) and "block5.convs.2.weight" in sd
    _same_tree(bridge.hed_tree(sd, hed_tree), hed_tree)


# ---- the segmenter ------------------------------------------------------------

@pytest.mark.parametrize("hws", [(16, 16, 6), (7, 5, 3), (10, 13, 4), (9, 9, 2), (5, 8, 1)])
def test_adaptive_avg_pool_matches(hws):
    """torch's floor / ceil bins at ragged sizes, as the JAX function's."""
    h, w, s = hws
    x = np.random.default_rng(h * w + s).standard_normal((2, h, w, 5)).astype(np.float32)
    _close(tseg.adaptive_avg_pool(T(x), s), jseg.adaptive_avg_pool(jnp.asarray(x), s),
           atol=1e-5)


def test_swin_t_is_the_jax_config():
    assert dataclasses.asdict(tswin.SWIN_T) | {"dtype": None} == \
        dataclasses.asdict(jswin.SWIN_T) | {"dtype": None}
    seg = dataclasses.asdict(tseg.UPERNET_SWIN_T)
    ref = dataclasses.asdict(jseg.UPERNET_SWIN_T)
    for d in (seg, ref):
        d["dtype"] = d["backbone"]["dtype"] = None
    assert seg == ref


@pytest.fixture(scope="module")
def seg_tree():
    return random_flax_params(jseg.UperNetSegmenter(JAX_SEG),
                              (np.zeros((1, 40, 40, 3), np.float32),), 91)


@pytest.mark.parametrize("size", [40, 36])
def test_segmenter_matches(seg_tree, size):
    """The logits at 40 and 36 px (stride 8: 5 and 5 after padding), then
    the rendered maps."""
    px = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    ref = jseg.UperNetSegmenter(JAX_SEG).apply(seg_tree, px)
    m = tseg.UperNetSegmenter(PORT_SEG)
    m.load_state_dict(bridge.seg_state_dict(seg_tree))
    with torch.no_grad():
        got = m.eval()(T(px))
    _close(got, ref)
    agree = (tseg.render_segmentation(got) == jseg.render_segmentation(ref)).all(-1).mean()
    assert agree >= 0.99, agree
    assert len(np.unique(np.asarray(ref).argmax(-1))) > 1


def test_seg_bridge_round_trips(seg_tree):
    """`seg`: the backbone under the port's Swin names (`backbone.layers.I...`),
    the head under HF UperNetHead's, the module's keys exactly, and back."""
    sd = bridge.seg_state_dict(seg_tree)
    assert set(sd) == set(tseg.UperNetSegmenter(PORT_SEG).state_dict())
    for k in ("backbone.layers.0.downsample.reduction.weight", "decode_head.psp_modules.1.weight",
              "decode_head.fpn_bottleneck.bias", "decode_head.classifier.weight"):
        assert k in sd, k
    _same_tree(bridge.seg_tree(sd, seg_tree), seg_tree)


def test_palette_and_ties():
    """The ADE palette equals the JAX one; an exact tie renders the lower class."""
    np.testing.assert_array_equal(tseg.ade_palette(), jseg.ade_palette())
    logits = np.zeros((1, 2, 2, 4), np.float32)
    logits[0, 0, 0, [1, 3]] = 5.0
    np.testing.assert_array_equal(tseg.render_segmentation(T(logits)),
                                  jseg.render_segmentation(jnp.asarray(logits)))


# ---- the zoo slots and the pipelines ----------------------------------------------

@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory, hed_tree, seg_tree, depth_tree):  # noqa: F811
    params = {"hed": hed_tree, "seg": seg_tree, "depth": depth_tree}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, seg_cfg=JAX_SEG, depth_cfg=JAX_DEPTH)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params)


def test_hed_fn_matches(zoo_pair):
    jzoo, zoo = zoo_pair
    got, ref = zoo.hed_fn()(IMG), jzoo.hed_fn()(IMG)
    assert got.shape == IMG.shape[:2] and got.dtype == np.float32
    _close(got, ref)


def test_seg_fn_matches(zoo_pair):
    jzoo, zoo = zoo_pair
    got, ref = zoo.seg_fn()(IMG), np.asarray(jzoo.seg_fn()(IMG))
    assert got.shape == IMG.shape and got.dtype == np.uint8
    assert (got == ref).all(-1).mean() >= 0.99


def _ground(image, phrase, mode="merge", count_k=None):
    """A stub grounder: three boxes, one of them invalid."""
    return types.SimpleNamespace(boxes=BOXES, valid=VALID, mask=np.ones(image.shape[:2], bool))


def _toolboxes(zoo_pair):
    jzoo, zoo = zoo_pair
    jtb = JaxToolbox(ground=_ground, hed=jzoo.hed_fn(), seg=jzoo.seg_fn(),
                     depth=jzoo.depth_fn())
    tb = Toolbox(ground=_ground)
    for slot in ("hed", "seg", "depth"):
        zoo.install(tb, slot)
    return jtb, tb


def _record(kind, edit_type, i=0):
    obj = dict(REC, edit_type=edit_type, id=f"{edit_type}-{i}")
    return (JaxRecord if kind == "jax" else InstructionRecord).from_json(obj)


def _visual_close(edit_type, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == IMG.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    if edit_type == "visual_depth":
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
    elif edit_type in ("visual_scribble", "visual_segment"):
        assert (d == 0).all(-1).mean() >= 0.99
    else:
        assert d.max() == 0


@pytest.mark.parametrize("edit_type", VC_TYPES)
def test_visual_condition_matches(zoo_pair, edit_type):
    """The record through `get_pipeline` on both toolboxes: success, the
    edited frame IS the image, the condition channel within the type's
    tolerance, the same rewritten instruction (the verb drawn from the
    same rng)."""
    jtb, tb = _toolboxes(zoo_pair)
    jrec, rec = _record("jax", edit_type), _record("port", edit_type)
    ref = jvisual.visual_condition(jtb, jrec, IMG, np.random.default_rng(5))
    got = get_pipeline(edit_type)(tb, rec, IMG, np.random.default_rng(5))
    assert got.success and ref.success
    assert got.edited is IMG
    _visual_close(edit_type, got.visual_input, ref.visual_input)
    assert rec.edit == jrec.edit and rec.edit.endswith(": make the car red")


def test_visual_sketch_on_the_toolbox_canny(zoo_pair):
    """With `tb.canny` installed the sketch is the same Canny map."""
    _, zoo = zoo_pair
    tb = Toolbox()
    zoo.install(tb, "canny")
    a = visual.visual_condition(tb, _record("port", "visual_sketch"), IMG,
                                np.random.default_rng(0))
    b = visual.visual_condition(Toolbox(), _record("port", "visual_sketch"), IMG,
                                np.random.default_rng(0))
    np.testing.assert_array_equal(a.visual_input, b.visual_input)
    assert a.visual_input.any()


def test_draw_bbox_matches():
    """Out-of-range and fractional boxes clip and truncate as the JAX ones."""
    boxes = np.array([[-5.0, 3.7, 50.0, 20.2], [10.0, 10.0, 12.0, 11.0]], np.float32)
    np.testing.assert_array_equal(visual.draw_bbox(IMG, boxes, np.array([True, True])),
                                  jvisual.draw_bbox(IMG, boxes, np.array([True, True])))


@pytest.mark.parametrize("edit_type", VC_TYPES)
def test_visual_condition_without_its_slot(edit_type):
    """Without its slot (a grounder that finds nothing for visual_bbox) each
    type fails with the JAX package's reason, or both succeed (the sketch
    needs no slot)."""
    ref = jvisual.visual_condition(JaxToolbox(ground=lambda *a, **k: None),
                                   _record("jax", edit_type), IMG, np.random.default_rng(0))
    got = visual.visual_condition(Toolbox(ground=lambda *a, **k: None),
                                  _record("port", edit_type), IMG, np.random.default_rng(0))
    assert (got.success, got.reason) == (ref.success, ref.reason)
    assert got.success == (edit_type == "visual_sketch")


def test_executors_match(tmp_path, monkeypatch, zoo_pair):
    """One record of each condition type through the port's and the JAX
    package's `FactoryExecutor` (the stub grounder, no pre-filter, the
    post-filter's decision forced open): equal statuses, stages, reasons
    and rewritten instructions, each a success with its condition map
    written as the visual input."""
    lines = {}
    jtb, tb = _toolboxes(zoo_pair)
    for kind, ex_mod, box in (("jax", jexecutor, jtb), ("port", executor, tb)):
        monkeypatch.setattr(ex_mod, "post_filter_decision", lambda *a, **k: True)
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(box, ex_mod.ExecutorConfig(
            output_root=str(root), run_pre_filter=False))
        ex.run([_record(kind, et, i) for i, et in enumerate(VC_TYPES)], lambda r: IMG)
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    assert [x["status"] for x in lines["port"]] == ["success"] * len(VC_TYPES)
    for a, b in zip(lines["port"], lines["jax"], strict=True):
        assert (a["key"], a["status"]) == (b["key"], b["status"])
        for k in ("stage", "reason"):
            assert a["payload"].get(k) == b["payload"].get(k), k
        assert a["record"] == b["record"] and " the given [" in a["record"]["edit"]
        assert a["payload"]["visual_input_file"].endswith(".png")
