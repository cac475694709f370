"""The grounding stage's small modules in the PyTorch port against the JAX
package, on the same numpy inputs: NMS, deformable attention, morphology,
mask generation, the tokenizers, the record schema and the edit types.

Tolerances: keep masks, combined masks and token ids identical; boxes and
IoU 1e-6; `ms_deform_attn` max-abs 1e-5; morphology 1e-6; ratios 1e-6.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core import schema as jschema
from anyedit_tpu.edits import types as jtypes
from anyedit_tpu.grounding import maskgen as jmask
from anyedit_tpu.grounding import text as jtext
from anyedit_tpu.ops import deform_attn as jdeform
from anyedit_tpu.ops import morphology as jmorph
from anyedit_tpu.ops import nms as jnms
from anyedit_tpu.ops.resize import imagenet_normalize as jimagenet_normalize
from anyedit_tpu_torch.core import schema as tschema
from anyedit_tpu_torch.edits import types as ttypes
from anyedit_tpu_torch.grounding import maskgen as tmask
from anyedit_tpu_torch.grounding import text as ttext
from anyedit_tpu_torch.ops import deform_attn as tdeform
from anyedit_tpu_torch.ops import morphology as tmorph
from anyedit_tpu_torch.ops import nms as tnms
from anyedit_tpu_torch.ops.resize import imagenet_normalize

torch.set_num_threads(1)
T = torch.from_numpy


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(size * 0.05, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---- NMS -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "below_threshold"])
def test_nms_matches(case):
    """The keep mask equals the JAX one bit for bit: tied scores (the lower
    index wins, as jnp.argmax picks it), boxes at or below the score
    threshold never kept. box_iou within 1e-6."""
    rng = np.random.default_rng({"random": 0, "ties": 1, "below_threshold": 2}[case])
    n = 24
    boxes = _boxes(rng, n)
    if case == "ties":
        boxes[1::2] = boxes[0::2] + rng.uniform(-2, 2, (n // 2, 4)).astype(np.float32)
        scores = rng.choice([0.3, 0.5, 0.9], n).astype(np.float32)
        thr = -np.inf
    else:
        scores = rng.uniform(0, 1, n).astype(np.float32)
        thr = 0.5 if case == "below_threshold" else -np.inf
        if case == "below_threshold":
            scores[:4] = 0.5                 # exactly at the threshold: dropped
    ref = np.asarray(jax.jit(jnms.nms_fixed, static_argnums=(2, 3))(
        jnp.asarray(boxes), jnp.asarray(scores), 0.4, thr))
    got = tnms.nms_fixed(T(boxes), T(scores), 0.4, thr).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < n
    np.testing.assert_allclose(tnms.box_iou(T(boxes), T(boxes)).numpy(),
                               np.asarray(jnms.box_iou(jnp.asarray(boxes), jnp.asarray(boxes))),
                               atol=1e-6)


# ---- deformable attention --------------------------------------------------

SHAPES = ((6, 8), (3, 4))


def _deform_inputs(rng, b=1, q=7, h=1, d=2, k=2, lo=0.05, hi=0.95):
    s = sum(hh * ww for hh, ww in SHAPES)
    value = rng.standard_normal((b, s, h, d)).astype(np.float32)
    locs = rng.uniform(lo, hi, (b, q, h, len(SHAPES), k, 2)).astype(np.float32)
    w = rng.standard_normal((b, q, h, len(SHAPES) * k))
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return value, locs, w.reshape(b, q, h, len(SHAPES), k).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "out_of_bounds", "straddles_border"])
def test_ms_deform_attn_matches(case):
    """`ms_deform_attn` and `ms_deform_attn_ref` against both JAX functions,
    max-abs 1e-5: random points inside, points far outside (all zero), and
    points straddling the border (corners outside read zero)."""
    rng = np.random.default_rng(3)
    lo, hi = {"random": (0.05, 0.95), "out_of_bounds": (3.0, 5.0),
              "straddles_border": (-0.15, 1.15)}[case]
    value, locs, w = _deform_inputs(rng, lo=lo, hi=hi)
    jargs = (jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(w))
    targs = (T(value), SHAPES, T(locs), T(w))
    got = tdeform.ms_deform_attn(*targs).numpy()
    got_ref = tdeform.ms_deform_attn_ref(*targs).numpy()
    for fn in (jdeform.ms_deform_attn, jdeform.ms_deform_attn_ref):
        ref = np.asarray(jax.jit(fn, static_argnums=1)(*jargs))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got_ref, ref, atol=1e-5, rtol=0)
    if case == "out_of_bounds":
        assert np.abs(got).max() == 0.0


def test_ms_deform_attn_exact_pixel_centre():
    """Sampling exactly at a pixel centre returns that pixel's value (x is
    the width axis, y the height axis)."""
    hh, ww = 4, 5
    value = np.arange(hh * ww * 2, dtype=np.float32).reshape(1, hh * ww, 1, 2)
    locs = np.array([(2 + 0.5) / ww, (1 + 0.5) / hh], np.float32).reshape(1, 1, 1, 1, 1, 2)
    w = np.ones((1, 1, 1, 1, 1), np.float32)
    got = tdeform.ms_deform_attn(T(value), ((hh, ww),), T(locs), T(w)).numpy()
    ref = np.asarray(jax.jit(jdeform.ms_deform_attn, static_argnums=1)(
        jnp.asarray(value), ((hh, ww),), jnp.asarray(locs), jnp.asarray(w)))
    np.testing.assert_allclose(got[0, 0], value[0, 1 * ww + 2, 0], atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ---- morphology ------------------------------------------------------------

@pytest.mark.parametrize("kernel_size,dtype", [(5, np.float32), (3, np.bool_),
                                               (4, np.float32), (5, np.int32)])
def test_dilate_matches(kernel_size, dtype):
    """`dilate` equals the JAX one exactly, border and even sizes included."""
    rng = np.random.default_rng(4)
    m = (rng.uniform(size=(2, 19, 23)) > 0.93).astype(dtype)
    ref = np.asarray(jmorph.dilate(jnp.asarray(m), kernel_size))
    got = tmorph.dilate(T(m), kernel_size).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sigma", [2.0, 1.3])
def test_gaussian_blur_matches(sigma):
    """The radius int(3 sigma + 0.5), the reflect padding and the separable
    taps of the JAX blur, within 1e-6."""
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(3, 17, 21)).astype(np.float32)
    ref = np.asarray(jmorph.gaussian_blur(jnp.asarray(img), sigma))
    got = tmorph.gaussian_blur(T(img), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tmorph.gaussian_kernel1d(sigma, 6).numpy(),
                               np.asarray(jmorph.gaussian_kernel1d(sigma, 6)), atol=1e-7)


def test_imagenet_normalize_matches():
    x = np.random.default_rng(6).uniform(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(imagenet_normalize(T(x)).numpy(),
                               np.asarray(jimagenet_normalize(jnp.asarray(x))), atol=1e-6)


# ---- mask generation -------------------------------------------------------

def _detections(rng, q=40, t=8):
    logits = rng.normal(-2.0, 3.0, (q, t)).astype(np.float32)
    logits[:6, 2] = 40.0             # sigmoid saturates to 1.0: six tied scores
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (q, 2)),
                            rng.uniform(0.05, 0.3, (q, 2))], 1).astype(np.float32)
    return logits, boxes


@pytest.mark.parametrize("span", [(2, 4), (0, 0)])
def test_select_boxes_matches(span):
    """Scores from the phrase span (or every token), the top 32 in
    `jax.lax.top_k` order (six saturated scores tie: the lower query
    first), NMS: boxes within 1e-4 px, scores and keep identical."""
    logits, boxes = _detections(np.random.default_rng(7))
    ref = jax.jit(jmask.select_boxes, static_argnums=(2, 3, 4))(
        jnp.asarray(logits), jnp.asarray(boxes), span, (48, 40), 0.25)
    got = tmask.select_boxes(T(logits), T(boxes), span, (48, 40), box_threshold=0.25)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2].sum() > 0


def test_top_k_breaks_ties_to_the_lower_index():
    x = T(np.array([0.5, 1.0, 0.5, 1.0, 0.2], np.float32))
    values, idx = tmask.top_k(x, 4)
    assert idx.tolist() == [1, 3, 0, 2] and values.tolist() == [1.0, 1.0, 0.5, 0.5]


@pytest.mark.parametrize("mode,count_k", [("max", None), ("merge", None),
                                          ("count", 2), ("count", None)])
def test_grounding_result_matches(mode, count_k):
    """combine_masks (all three modes), boxes_to_mask bit-equal; the union
    area ratio within 1e-6; tied scores in 'count' order as the JAX stable
    argsort does."""
    rng = np.random.default_rng(8)
    n, h, w = tmask.MAX_BOXES, 24, 20
    masks = rng.standard_normal((n, h, w)).astype(np.float32)
    boxes = _boxes(rng, n, 20.0)
    scores = rng.choice([0.2, 0.6, 0.6, 0.9], n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.5
    fields = ("mask", "bbox_mask", "masks", "valid", "union_ratio")
    ref = dict(zip(fields, jax.jit(lambda *a: tuple(
        getattr(jmask.grounding_result(*a, (h, w), mode, count_k), f) for f in fields))(
        jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))))
    got = tmask.grounding_result(T(masks), T(boxes), T(scores), T(valid), (h, w),
                                 mode, count_k)
    for name in fields[:4]:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(ref[name]),
                                      err_msg=name)
    assert abs(float(got.union_ratio) - float(ref["union_ratio"])) <= 1e-6
    assert int(got.count) == int(np.asarray(ref["valid"]).sum())


def test_union_area_ratio_no_valid_box():
    boxes = T(np.zeros((3, 4), np.float32))
    valid = T(np.zeros(3, bool))
    assert float(tmask.union_area_ratio(boxes, valid, (10, 10))) == 0.0


# ---- text, schema, types ---------------------------------------------------

CAPTIONS = ["a small airplane sits on the concrete.", "red square.",
            "the Dog's ball, 2 cats & a hat"]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_tokenizers_and_spans_match(caption, tmp_path):
    """The hash tokenizer, WordPiece on a small vocab file, and the phrase
    spans (a phrase that is not found maps to (0, 0)) are identical."""
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "small", "air",
                                "##plane", "the", "dog", "'", "s", ",", "cat", "##s",
                                ".", "red", "squ", "##are", "2", "&", "hat"]))
    phrases = ["airplane", "small airplane", "red square", "cats", "dog", "zebra"]
    for jtok, ttok in ((jtext.SimpleVocabTokenizer(), ttext.SimpleVocabTokenizer()),
                       (jtext.WordPieceTokenizer(vocab), ttext.WordPieceTokenizer(vocab))):
        je, te = jtok.encode(caption), ttok.encode(caption)
        assert dataclasses.asdict(te) == dataclasses.asdict(je)
        assert ttext.phrase_token_spans(te, caption, phrases) == \
            jtext.phrase_token_spans(je, caption, phrases)


def test_schema_round_trip_matches(tmp_path):
    """InstructionRecord from/to JSON and the JSONL / JSON-array files are
    byte-identical to the JAX package's."""
    objs = [{"edit": "change the airplane to green", "edited object": "airplane",
             "input": "a small airplane", "output": "a green small airplane",
             "edit_type": "color_alter", "visual_input": "None",
             "image_file": "a.jpg", "edited_file": "b.png", "extra_key": [1, 2]},
            {"edit": "remove two cups", "edit_type": "counting", "remove_number": 2,
             "edited object": "cup", "input": "", "output": ""}]
    for suffix in (".jsonl", ".json"):
        jpath, tpath = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
        jschema.write_records(jpath, [jschema.InstructionRecord.from_json(o) for o in objs])
        tschema.write_records(tpath, [tschema.InstructionRecord.from_json(o) for o in objs])
        assert tpath.read_bytes() == jpath.read_bytes()
        back = tschema.read_records(jpath)
        assert [json.dumps(r.to_json()) for r in back] == \
            [json.dumps(r.to_json()) for r in jschema.read_records(jpath)]
        assert [r.key() for r in back] == [r.key() for r in jschema.read_records(jpath)]


def test_edit_types_match():
    for jcls, tcls in ((jtypes.EditOutcome, ttypes.EditOutcome),
                       (jtypes.Toolbox, ttypes.Toolbox)):
        assert [f.name for f in dataclasses.fields(tcls)] == \
            [f.name for f in dataclasses.fields(jcls)]
