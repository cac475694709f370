"""The geometry and outpainting edits of the PyTorch port (`resize`,
`movement`, `relation`, `outpainting`) against the JAX package's pipelines.

The helpers first: `paste_object` at scales 0.7, 1.0 and 1.3 and clipped at
the canvas edge (the image within 1 uint8 level, since the fp32 resize of
the two packages may truncate to the other side of an integer, the pasted
mask equal), `select_crop` and `check_occlusion` (equal). Then the four
types through `get_pipeline` on both tiny zoos (grounder and LaMa on the
same seeded weights), with the record's numpy generator at the same seed on
both sides: once with the zoos' own random grounders, and once with each
zoo's grounding answered on the test image by synthetic detections built
with each package's own `grounding_result` (the real grounding still runs),
so that the erase-and-paste path runs: success, reason and the synthesized
`rec.edit` equal, masks equal, outpainting's input crop equal byte for
byte, the edited frame within 1 level (LaMa's fp32 output, 2e-5 apart, is
truncated to uint8). The occlusion fault of the JAX `resize_movement`
(ROADMAP queue 3) has its own test. Last, the four types go through both
executors, per record and in chunk mode: equal statuses and scores.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits import geometry as jgeometry
from anyedit_tpu.edits import outpainting as joutpainting
from anyedit_tpu.edits.registry import get_pipeline as jax_get_pipeline
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.grounding import maskgen as jmaskgen
from anyedit_tpu.models.lama import TINY_LAMA as JAX_LAMA
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits import geometry, outpainting
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.grounding import maskgen
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_gdino import JAX_GDINO, gdino_params
from test_torch_lama import lama_params
from test_torch_sam import JAX_SAM, sam_params

torch.set_num_threads(1)
H, W = 64, 96
GRASS, RED, BLUE = (40, 160, 40), (220, 30, 30), (30, 40, 220)
RED_BOX, BLUE_BOX = (28, 16, 60, 44), (68, 8, 88, 26)     # xyxy; red: 14.6 % of the frame
TYPES = ("resize", "movement", "relation", "outpainting")
PORT, JAX = "port", "jax"


def scene() -> np.ndarray:
    img = np.empty((H, W, 3), np.uint8)
    img[:] = GRASS
    noise = np.random.default_rng(90).integers(0, 24, (H, W, 3), np.uint8)
    img += noise
    for (x1, y1, x2, y2), col in ((RED_BOX, RED), (BLUE_BOX, BLUE)):
        img[y1:y2, x1:x2] = col
        img[y1:y2, x1:x2] += noise[y1:y2, x1:x2]
    return img


IMG = scene()


def _record(kind, edit_type, i=0):
    cls = InstructionRecord if kind == PORT else JaxRecord
    return cls.from_json({"edit": "do it", "edited object": "red square",
                          "new object": "blue square", "input": "a red square on grass",
                          "output": "a scene", "edit_type": edit_type,
                          "image_file": f"{edit_type}_{i}.jpg"})


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """Both tiny zoos on the same grounder and LaMa params, every box kept."""
    params = {"gdino": gdino_params(), "sam": sam_params(), "lama": lama_params()}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, gdino=JAX_GDINO, sam=JAX_SAM, lama=JAX_LAMA,
                        box_threshold=0.0)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return {JAX: jzoo, PORT: ModelZoo(cfg, device="cpu", params=params)}


def _detections(kind, boxes, mode, extra_rows=()):
    """A GroundingResult of the package `kind` from `boxes` (valid, the
    first scoring highest) and `extra_rows` ((box, mask box) pairs kept as
    unkept candidate rows whose masks are NOT blanked), at H x W."""
    n = jmaskgen.MAX_BOXES
    masks = -np.ones((n, H, W), np.float32)
    bx = np.zeros((n, 4), np.float32)
    sc = np.zeros((n,), np.float32)
    valid = np.zeros((n,), bool)
    rows = [(b, b, True) for b in boxes] + [(b, m, False) for b, m in extra_rows]
    for i, (box, mbox, ok) in enumerate(rows):
        x1, y1, x2, y2 = mbox
        masks[i, y1:y2, x1:x2] = 1.0
        bx[i] = box
        sc[i] = 0.9 - 0.1 * i
        valid[i] = ok
    if kind == JAX:
        return jmaskgen.grounding_result(jnp.asarray(masks), jnp.asarray(bx), jnp.asarray(sc),
                                         jnp.asarray(valid), (H, W), mode)
    return maskgen.grounding_result(torch.from_numpy(masks), torch.from_numpy(bx),
                                    torch.from_numpy(sc), torch.from_numpy(valid), (H, W), mode)


def _synthetic_grounder(kind, real):
    """The zoo's grounder; on IMG its answer is replaced by the synthetic
    detection of the phrase's square ("red" / "blue"), both squares for
    any other phrase (outpainting's)."""
    def ground(image, phrase, mode="merge", count_k=None):
        g = real(image, phrase, mode=mode, count_k=count_k)
        if image is not IMG:
            return g
        boxes = [RED_BOX] if "red" in phrase else [BLUE_BOX] if "blue" in phrase \
            else [RED_BOX, BLUE_BOX]
        return _detections(kind, boxes, mode)
    return ground


def _toolbox(zoo_pair, kind, synthetic):
    zoo = zoo_pair[kind]
    ground = zoo.grounder()
    if synthetic:
        ground = _synthetic_grounder(kind, ground)
    return (Toolbox if kind == PORT else JaxToolbox)(ground=ground, inpaint=zoo.inpainter())


def _u8_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _same_outcome(out, ref, rec, jrec):
    assert (out.success, out.reason, rec.edit) == (ref.success, ref.reason, jrec.edit)
    for field in ("mask", "input_image"):
        a, b = getattr(out, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
    assert (out.edited is None) == (ref.edited is None)
    if out.edited is not None:
        assert out.edited.dtype == np.uint8 and out.edited.shape == ref.edited.shape
        assert _u8_diff(out.edited, ref.edited) <= 1
    assert out.scores == ref.scores


# ---- the helpers ------------------------------------------------------------

PASTES = {"scale_0.7": ((48, 30), 0.7), "scale_1.0": ((20, 50), 1.0),
          "scale_1.3": ((40, 32), 1.3), "clipped": ((90, 60), 1.3)}


@pytest.mark.parametrize("case", sorted(PASTES))
def test_paste_object_matches(case):
    """The pasted image within 1 level, the pasted mask equal, on an
    irregular object mask; `clipped` pastes across the bottom-right edge."""
    dst, scale = PASTES[case]
    rng = np.random.default_rng(91)
    obj = np.zeros((H, W), bool)
    obj[18:45, 25:52] = True
    obj[18:24, 25:31] = False
    obj |= rng.random((H, W)) < 0.02
    bg = rng.integers(0, 256, (H, W, 3), np.uint8)
    out, mask = geometry.paste_object(bg, IMG, obj, dst, scale)
    ref, ref_mask = jgeometry.paste_object(bg, IMG, obj, dst, scale)
    np.testing.assert_array_equal(mask, ref_mask)
    assert out.dtype == np.uint8 and _u8_diff(out, ref) <= 1
    assert mask.any() and (case != "clipped" or mask[-1].any())


def test_select_crop_and_occlusion_match():
    """`select_crop` over random boxes (some valid, inside and across the
    area and margin limits) and `check_occlusion` over random masks give
    the JAX answers."""
    rng = np.random.default_rng(92)
    hits = 0
    for _ in range(200):
        boxes = rng.uniform(-10, 110, (6, 4)).astype(np.float32)
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 70, (6, 2))
        valid = rng.random(6) < 0.7
        got = outpainting.select_crop(boxes, valid, (H, W))
        assert got == joutpainting.select_crop(boxes, valid, (H, W))
        hits += got is not None
    assert 10 < hits < 190
    for _ in range(50):
        obj = rng.random((H, W)) < 0.3
        others = rng.random((3, H, W)) < rng.uniform(0.0, 0.2)
        assert geometry.check_occlusion(obj, others) == jgeometry.check_occlusion(obj, others)
    assert geometry.check_occlusion(obj, others[:0]) is False


# ---- the pipelines on the tiny zoos ------------------------------------------

@pytest.mark.parametrize("grounder", ["zoo", "synthetic"])
@pytest.mark.parametrize("edit_type", TYPES)
def test_pipeline_matches_jax(zoo_pair, edit_type, grounder):
    synthetic = grounder == "synthetic"
    jtb, tb = (_toolbox(zoo_pair, k, synthetic) for k in (JAX, PORT))
    rec, jrec = _record(PORT, edit_type), _record(JAX, edit_type)
    for seed in (0, 1):
        out = get_pipeline(edit_type)(tb, rec, IMG, np.random.default_rng(seed))
        ref = jax_get_pipeline(edit_type)(jtb, jrec, IMG, np.random.default_rng(seed))
        _same_outcome(out, ref, rec, jrec)
    if synthetic:
        assert out.success, out.reason
        if edit_type == "outpainting":
            x1, y1, x2, y2 = RED_BOX        # the first box fitting the limits
            ex, ey = (x2 - x1) // 10, (y2 - y1) // 10
            np.testing.assert_array_equal(out.input_image, IMG[y1 - ey:y2 + ey, x1 - ex:x2 + ex])
            assert out.edited is IMG


def test_movement_pastes_the_object_bytes(zoo_pair):
    """A movement pastes the source object's pixels unchanged (scale 1): the
    red square, shifted by the drawn dx, holds IMG's bytes."""
    tb = _toolbox(zoo_pair, PORT, True)
    out = get_pipeline("movement")(tb, _record(PORT, "movement"), IMG,
                                   np.random.default_rng(3))
    assert out.success
    draws = np.random.default_rng(3)
    delta = int(draws.integers(50, 121))
    dx = -delta if draws.choice(["left", "right"]) == "left" else delta
    x1, y1, x2, y2 = RED_BOX
    half = (x2 - x1) // 2
    nx1 = int(np.clip((x1 + x2) // 2 + dx, half, W - half)) - half
    assert nx1 != x1
    np.testing.assert_array_equal(out.edited[y1:y2, nx1:nx1 + x2 - x1], IMG[y1:y2, x1:x2])


def test_suppressed_duplicate_occludes_only_jax(zoo_pair):
    """The JAX `resize_movement` reads `g.masks[1:]`, every candidate row,
    for its occlusion check. A result whose unkept row (an NMS-suppressed
    duplicate) still carries a mask over the object makes the JAX pipeline
    call the record occluded; the port reads the valid detections other
    than the selected one and moves it. (The zoos' grounders blank unkept
    rows, so on their results the two agree.)"""
    def ground(kind):
        dup = ((RED_BOX[0] + 1, RED_BOX[1], RED_BOX[2] + 1, RED_BOX[3]), RED_BOX)
        return lambda image, phrase, mode="merge", count_k=None: _detections(
            kind, [RED_BOX], mode, extra_rows=[dup])
    jtb = JaxToolbox(ground=ground(JAX), inpaint=zoo_pair[JAX].inpainter())
    tb = Toolbox(ground=ground(PORT), inpaint=zoo_pair[PORT].inpainter())
    ref = jax_get_pipeline("movement")(jtb, _record(JAX, "movement"), IMG,
                                       np.random.default_rng(0))
    out = get_pipeline("movement")(tb, _record(PORT, "movement"), IMG, np.random.default_rng(0))
    assert (ref.success, ref.reason) == (False, "object occluded")
    assert out.success, out.reason


# ---- both executors ----------------------------------------------------------

def _batched(kind, ground):
    """`ground` with the `.batch` the chunk executors look for."""
    def batch(images, phrases, modes=None, count_ks=None):
        modes = modes or ["merge"] * len(images)
        count_ks = count_ks or [None] * len(images)
        return [ground(im, ph, mode=m, count_k=k)
                for im, ph, m, k in zip(images, phrases, modes, count_ks)]
    ground.batch = batch
    return ground


@pytest.mark.parametrize("grounding_batch", [0, 4])
def test_executors_match(tmp_path, zoo_pair, grounding_batch):
    """Two records of each type through the port's and the JAX package's
    `FactoryExecutor` (synthetic detections on the zoo grounders, LaMa
    real, no scorer slots), per record and in chunks of 4: equal ledger
    statuses, stages, reasons and scores."""
    lines = {}
    for kind, ex_mod in ((JAX, jexecutor), (PORT, executor)):
        zoo = zoo_pair[kind]
        ground = _batched(kind, _synthetic_grounder(kind, zoo.grounder()))
        tb = (Toolbox if kind == PORT else JaxToolbox)(ground=ground, inpaint=zoo.inpainter())
        records = [_record(kind, et, i) for i in range(2) for et in TYPES]
        root = tmp_path / kind
        ex = ex_mod.FactoryExecutor(tb, ex_mod.ExecutorConfig(
            output_root=str(root), grounding_batch=grounding_batch, run_pre_filter=False))
        ex.run(records, lambda r: IMG)
        lines[kind] = [json.loads(x) for x in (root / "ledger.jsonl").read_text().splitlines()]
    assert len(lines[PORT]) == 2 * len(TYPES)
    for a, b in zip(lines[PORT], lines[JAX], strict=True):
        assert (a["key"], a["status"]) == (b["key"], b["status"])
        for k in ("stage", "reason"):
            assert a["payload"].get(k) == b["payload"].get(k), k
        sa, sb = a["payload"].get("scores", {}), b["payload"].get("scores", {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k] == pytest.approx(sb[k], abs=1e-6) if isinstance(sa[k], float) \
                else sa[k] == sb[k], k
    assert sum(x["status"] == "success" for x in lines[PORT]) >= len(TYPES)
