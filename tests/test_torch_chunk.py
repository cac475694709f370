"""Chunk mode of the PyTorch port's `FactoryExecutor` and the batched zoo
slots it drives (`ground.batch`, `clip_image.batch`, `ip2p.batch`),
against the JAX package's chunk executor and zoo, and against the port's
own per-record mode.

On stub toolboxes in the style of `tests/test_torch_executor.py` (each
package gets its own types: numpy masks for JAX, tensors for the port; the
stubs also inpaint, SD-inpaint and answer VQA) a chunked run over every
ported edit type writes the JAX chunk executor's ledger byte for byte (with
the CLIP stubs on, the CLIP-derived scores within 1e-6: JAX sums them in
numpy, the port in torch), and the port's per-record run's outcomes. A
batch call that raises gives the same outcomes and the JAX package's stderr
line. On the tiny zoos, `ip2p.batch` is held to the JAX `ip2p_batch_fn`
(JAX's noise handed in) and to the port's per-record `ip2p` within 1 uint8
level; `clip_image.batch` to the JAX tower per record within 1e-5;
`ground.batch` to the JAX `ground.batch` per record (boxes 1e-3 px, scores
1e-5, masks on >= 99.9 % of the pixels), as `test_torch_color_alter.py`
holds `ground`.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.filters.pre_filter import PreScores
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_bridge import JAX_TEXT, JAX_UNET, JAX_VAE, text_params, unet_params, vae_params
from test_torch_gdino import JAX_GDINO, gdino_params
from test_torch_lama import lama_params
from test_torch_sam import JAX_SAM, sam_params
from test_torch_scorers import JAX_VISION, text_proj_params, vision_params

torch.set_num_threads(1)
T = torch.from_numpy
H, W = 48, 40
GRASS = np.array([40, 160, 40], np.uint8)
RED = np.array([220, 30, 30], np.uint8)
BLUE = np.array([30, 30, 220], np.uint8)
PORT, JAX = "port", "jax"
PKG = {PORT: (InstructionRecord, Toolbox, executor),
       JAX: (JaxRecord, JaxToolbox, jexecutor)}
TYPES = ["color_alter", "tone_transfer", "style_change", "remove", "counting", "add",
         "replace", "background_change", "appearance_alter", "material_alter"]


def scene(red: bool = True) -> np.ndarray:
    img = np.tile(GRASS, (H, W, 1))
    if red:
        img[12:28, 10:26] = RED
    return img


def _records(kind, types=TYPES):
    """One record of each type; then a color_alter whose image has no red
    square (its pipeline fails) and one whose load raises."""
    rec_cls = PKG[kind][0]
    objs = [{"edit": f"edit {i}: make it blue", "edited object": "red square",
             "new object": "blue ball", "remove_number": 1, "input": "a red square on grass",
             "output": "grass", "edit_type": et, "image_file": f"img_{i}.jpg"}
            for i, et in enumerate(types)]
    n = len(objs)
    objs += [dict(objs[0], edit="no object", image_file=f"img_{n}.jpg"),
             dict(objs[0], edit="broken file", image_file=f"img_{n + 1}.jpg")]
    return [rec_cls.from_json(o) for o in objs]


def _loader(rec):
    """A fresh array for every record (the chunk caches key on identity)."""
    if rec.edit == "broken file":
        raise OSError(f"cannot read {rec.image_file}")
    return scene(red=rec.edit != "no object")


@dataclasses.dataclass
class Ground:
    mask: object
    masks: object
    boxes: np.ndarray
    valid: np.ndarray
    bbox_mask: object
    union_ratio: float


def chunk_toolbox(kind, calls=None, scorers=False, raising=()):
    """ground: the red (or, for a "blue" phrase, the blue) pixels, None
    where there are none; inpaint: grass over the mask; sd_inpaint: blue
    for a "blue" prompt, dark grass otherwise; ip2p: the negative image
    (inside the mask for a masked call); vqa: yes to colour questions. Each
    has a `.batch` where the zoo's has one, and `calls` logs every call.
    With `scorers`, CLIP towers of mean colours. A stage named in `raising`
    ("ground_batch", "clip_batch", "edit_batch") raises."""
    tensor = T if kind == PORT else np.asarray
    log = calls if calls is not None else []

    def boom(stage):
        if stage in raising:
            raise RuntimeError("CUDA out of memory")

    def ground(image, phrase, mode="merge", count_k=None):
        log.append(("ground", id(image), phrase, mode))
        if "blue" in phrase:
            mask = (image[..., 2] > 180) & (image[..., 0] < 100)
        elif "red" in phrase:
            mask = (image[..., 0] > 180) & (image[..., 2] < 100)
        else:
            mask = np.zeros(image.shape[:2], bool)
        if not mask.any():
            return None
        ys, xs = np.nonzero(mask)
        box = np.array([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]], np.float32)
        bbox = np.zeros_like(mask)
        bbox[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = True
        return Ground(tensor(mask), tensor(mask[None]), box, np.array([True]), tensor(bbox),
                      float(mask.mean()))

    def ground_batch(images, phrases, modes=None, count_ks=None, **kw):
        boom("ground_batch")
        log.append(("ground_batch", len(images)))
        n = len(images)
        return [ground(i, p, m, k) for i, p, m, k in zip(
            images, phrases, modes or ["merge"] * n, count_ks or [None] * n)]

    def inpaint(img01, mask01):
        out = np.array(img01, np.float32)
        out[np.asarray(mask01) > 0.5] = GRASS / 255.0
        return out

    def sd_inpaint(image, mask01, prompt, negative="", **kw):
        out = image.copy()
        fill = BLUE if "blue" in prompt else (GRASS * 0.7).astype(np.uint8)
        out[np.asarray(mask01) > 0.5] = fill
        return out

    def ip2p(image, instruction, mask01, steps=50, s_txt=8.0, s_img=0.9, **kw):
        log.append(("ip2p", instruction, mask01 is not None, steps, s_txt, s_img))
        if mask01 is None:
            return 255 - image
        return np.where(np.asarray(mask01)[..., None] > 0.5, 255 - image, image)

    def ip2p_batch(images, instructions, masks=None, steps=50, s_txt=8.0, s_img=0.9,
                   seeds=None, **kw):
        boom("edit_batch")
        log.append(("ip2p_batch", tuple(instructions), steps, s_txt, s_img, tuple(seeds)))
        return [255 - im for im in images]

    ground.batch, ip2p.batch = ground_batch, ip2p_batch
    tb = PKG[kind][1](ground=ground, inpaint=inpaint, sd_inpaint=sd_inpaint, ip2p=ip2p)
    tb.vqa_yes_no = lambda img, q: "color" in q
    if scorers:
        def unit(v):
            v = np.asarray(v, np.float32)[None]
            return tensor(v / np.linalg.norm(v))

        def clip_image(img):
            return unit(img.reshape(-1, 3).mean(0) + 1.0)

        def clip_batch(images, **kw):
            boom("clip_batch")
            log.append(("clip_batch", len(images)))
            return [clip_image(i) for i in images]
        clip_image.batch = clip_batch
        tb.clip_image = clip_image
        tb.clip_text = lambda text: unit([3.0, 4.0, 2.0 + len(text) % 3])
    return tb


def _run(kind, root, tb, records=None, **cfg):
    ex_mod = PKG[kind][2]
    ex = ex_mod.FactoryExecutor(tb, ex_mod.ExecutorConfig(output_root=str(root), **cfg))
    report = ex.run(records or _records(kind), _loader)
    return ex, report


def _ledger(root):
    return (root / "ledger.jsonl").read_text()


def _same_ledger(port: str, ref: str, atol: float):
    """Byte for byte, but for float scores within `atol`."""
    if atol == 0.0:
        assert port == ref
        return
    for a, b in zip(port.splitlines(), ref.splitlines(), strict=True):
        la, lb = json.loads(a), json.loads(b)
        sa, sb = la["payload"].pop("scores", {}), lb["payload"].pop("scores", {})
        assert la == lb
        assert sa.keys() == sb.keys()
        for k in sa:
            if isinstance(sa[k], float):
                assert abs(sa[k] - sb[k]) <= atol, k
            else:
                assert sa[k] == sb[k], k


def _chunk_vs_jax(tmp_path, scorers=False, raising=(), **cfg):
    """The chunked run of both packages in the same directory (the ledger
    holds the PNG paths), the JAX one first; returns (port ledger, JAX
    ledger, port report, port calls, JAX calls)."""
    root = tmp_path / "out"
    calls = {PORT: [], JAX: []}
    ledgers, reports = {}, {}
    for kind in (JAX, PORT):
        shutil.rmtree(root, ignore_errors=True)
        tb = chunk_toolbox(kind, calls[kind], scorers=scorers, raising=raising)
        _, reports[kind] = _run(kind, root, tb, grounding_batch=4, **cfg)
        ledgers[kind] = _ledger(root)
    return ledgers[PORT], ledgers[JAX], reports[PORT], calls[PORT], calls[JAX]


@pytest.mark.parametrize("scorers", [False, True])
def test_chunk_ledger_matches_jax_and_per_record(tmp_path, scorers):
    """Every ported edit type, a record without its object and a failed
    load, in chunks of 4: the JAX chunk executor's ledger; the report has
    the three batch stages; and the port's per-record run gives the same
    statuses, payload keys (a failed load's traceback aside) and PNGs."""
    port, ref, report, _, _ = _chunk_vs_jax(tmp_path, scorers)
    _same_ledger(port, ref, 1e-6 if scorers else 0.0)
    stages = {"ground_batch", "edit_batch"} | ({"clip_batch"} if scorers else set())
    assert stages <= set(report["stages"])
    chunk = [json.loads(x) for x in port.splitlines()]
    assert len(chunk) == len(TYPES) + 2 and report["counts"]["success"] >= 5
    # the failed load is marked when its chunk starts, before the others
    by_file = {x["record"]["image_file"]: x for x in chunk}
    assert chunk[len(TYPES) - 2]["payload"] == \
        by_file["img_11.jpg"]["payload"] == {"error": "OSError: cannot read img_11.jpg"}
    assert by_file["img_10.jpg"]["payload"] == {"reason": "object not found"}

    _run(PORT, tmp_path / "one", chunk_toolbox(PORT, scorers=scorers))
    one = {x["key"]: x for x in map(json.loads, _ledger(tmp_path / "one").splitlines())}
    for line in chunk:
        other = one[line["key"]]
        assert (other["status"], other["payload"].get("stage")) == \
            (line["status"], line["payload"].get("stage")), line["key"]
        assert sorted(set(other["payload"]) - {"trace"}) == sorted(line["payload"])
        for key in ("edited_file", "input_file", "mask_file"):
            if key in line["payload"]:
                with open(line["payload"][key], "rb") as a, open(other["payload"][key], "rb") as b:
                    assert a.read() == b.read(), (line["key"], key)


# calls of each batch stage in one run: every chunk grounds and scores in
# one batch; only the first chunk has unmasked edits, in two knob groups
@pytest.mark.parametrize("stage,n_calls", [("ground_batch", 3), ("clip_batch", 3),
                                           ("edit_batch", 2)])
def test_batch_call_raising_falls_back(tmp_path, capfd, stage, n_calls):
    """A batch call that raises leaves its cache cold: the records run per
    record with the working run's outcomes, both packages print the same
    stderr line for each failed call, and their ledgers agree."""
    want, _, _, _, _ = _chunk_vs_jax(tmp_path / "ok", scorers=True)
    capfd.readouterr()
    port, ref, report, calls, _ = _chunk_vs_jax(tmp_path, scorers=True, raising=(stage,))
    err = capfd.readouterr().err
    line = f"# {stage} fell back to per-record (RuntimeError: CUDA out of memory)"
    assert err.count(line) == 2 * n_calls            # both packages
    _same_ledger(port, ref, 1e-6)

    def outcomes(text):
        return [(x["key"], x["status"], x["payload"].get("stage"), x["payload"].get("reason"))
                for x in map(json.loads, text.splitlines())]
    assert outcomes(port) == outcomes(want)
    if stage == "edit_batch":                        # the survivors edited one by one
        assert any(c[0] == "ip2p" and not c[2] for c in calls)


def test_edits_batched_and_served_from_the_cache(tmp_path):
    """The unmasked edits of color_alter, tone_transfer and style_change go
    through one batch call per (steps, s_txt, s_img) and chunk, with the
    pipelines' own knobs and seed 0; no live per-record unmasked edit is
    made; appearance and material edits stay live and masked. The JAX
    executor makes the same batch calls."""
    _, _, _, calls, jcalls = _chunk_vs_jax(tmp_path)
    batches = [c for c in calls if c[0] == "ip2p_batch"]
    assert batches == [c for c in jcalls if c[0] == "ip2p_batch"]
    assert batches == [("ip2p_batch", ("edit 0: make it blue", "edit 1: make it blue"),
                        100, 8.0, 0.9, (0, 0)),
                       ("ip2p_batch", ("edit 2: make it blue",), 50, 7.5, 1.2, (0,))]
    live = [c for c in calls if c[0] == "ip2p"]
    assert live == [("ip2p", "edit 8: make it blue", True, 50, 8.0, 1.5),
                    ("ip2p", "edit 9: make it blue", True, 50, 8.0, 1.5)]


def test_steps_override_reaches_the_batch(tmp_path):
    """`ip2p_steps_override` sets the batched edits' steps and the cache
    keys, so the pipelines' calls still hit."""
    _, _, _, calls, jcalls = _chunk_vs_jax(tmp_path, ip2p_steps_override=7)
    batches = [c for c in calls if c[0] == "ip2p_batch"]
    assert batches == [c for c in jcalls if c[0] == "ip2p_batch"]
    assert {c[2] for c in batches} == {7}
    assert all(c[2] for c in calls if c[0] == "ip2p")      # only masked calls live


def test_batch_edits_off(tmp_path):
    """`batch_edits=False` keeps the batched grounding and CLIP but edits
    every record live, in both packages, with the same ledger."""
    port, ref, report, calls, jcalls = _chunk_vs_jax(tmp_path, scorers=True,
                                                     batch_edits=False)
    _same_ledger(port, ref, 1e-6)
    assert {"ground_batch", "clip_batch"} <= set(report["stages"])
    assert "edit_batch" not in report["stages"]
    assert not [c for c in calls + jcalls if c[0] == "ip2p_batch"]
    assert [c for c in calls if c[0] == "ip2p"] == [c for c in jcalls if c[0] == "ip2p"]


def test_first_ground_table_is_the_served_types():
    """Every `_FIRST_GROUND` type has a pipeline in the registry, and each
    served type has the JAX table's entry, or none where JAX has none (the
    edits that ground nothing first)."""
    from anyedit_tpu_torch.edits.registry import EDIT_PIPELINES

    assert set(executor._FIRST_GROUND) <= set(EDIT_PIPELINES)
    for et in EDIT_PIPELINES:
        assert executor._FIRST_GROUND.get(et) == jexecutor._FIRST_GROUND.get(et), et
    assert set(EDIT_PIPELINES) - set(executor._FIRST_GROUND) == {
        "tone_transfer", "style_change", "action_change", "implicit_change", "textual_change",
        "visual_depth", "visual_scribble", "visual_segment", "visual_sketch", "composition",
        "rotation_change"}


def test_failed_memo_grounding_gets_no_batched_edit(tmp_path):
    """With `batch_grounding` off the pre-gate grounds each record through
    the memo. A record whose grounding found nothing gets no batched edit in
    the port (it reads the memo, identity-guarded); the JAX executor reads
    only the batched cache and edits it for nothing. Ledgers are equal."""
    port, ref, report, calls, jcalls = _chunk_vs_jax(tmp_path, batch_grounding=False)
    _same_ledger(port, ref, 0.0)
    assert "ground_batch" not in report["stages"]
    edited = [ins for c in calls if c[0] == "ip2p_batch" for ins in c[1]]
    jedited = [ins for c in jcalls if c[0] == "ip2p_batch" for ins in c[1]]
    assert "no object" not in edited and "no object" in jedited
    assert sorted(edited + ["no object"]) == sorted(jedited)


def test_shared_toolbox_second_executor(tmp_path):
    """A second chunk executor over the same toolbox grounds and edits anew
    (no cache or memo of the first one serves it), stays one wrapping layer
    deep, and gives the same ledger."""
    calls = []
    tb = chunk_toolbox(PORT, calls)
    ex1, _ = _run(PORT, tmp_path / "a", tb, grounding_batch=4)
    first = list(calls)
    ex2, _ = _run(PORT, tmp_path / "b", tb, grounding_batch=4)
    assert [c[0] for c in calls[len(first):]] == [c[0] for c in first]
    assert not hasattr(ex2.tb.ground._real, "_real")
    assert not hasattr(ex2.tb.ip2p._real, "_real")
    assert _ledger(tmp_path / "a").replace("/a/", "/b/") == _ledger(tmp_path / "b")


def test_chunk_loads_ahead_and_contains_a_failed_load(tmp_path):
    """The loader thread reads every image once, a failed load fails only
    its record (the rest of its chunk runs), and a chunk of 1 is per-record
    mode's ledger."""
    loads = []

    def loader(rec):
        loads.append(rec.key())
        return _loader(rec)
    recs = _records(PORT)
    ex = executor.FactoryExecutor(chunk_toolbox(PORT), executor.ExecutorConfig(
        output_root=str(tmp_path / "c"), grounding_batch=5))
    report = ex.run(recs, loader)
    assert sorted(loads) == sorted(r.key() for r in recs)
    assert sum(report["counts"].values()) == len(recs) and report["counts"]["failure"] >= 2
    _run(PORT, tmp_path / "one", chunk_toolbox(PORT), grounding_batch=1)
    _run(PORT, tmp_path / "per", chunk_toolbox(PORT))
    strip = [{k: v for k, v in json.loads(x).items() if k != "payload"}
             for x in _ledger(tmp_path / "per").splitlines()]
    assert strip == [{k: v for k, v in json.loads(x).items() if k != "payload"}
                     for x in _ledger(tmp_path / "one").splitlines()]


# ---- the batched zoo slots on the tiny zoos -------------------------------

@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    params = {"gdino": gdino_params(), "sam": sam_params(), "unet_ip2p": unet_params(),
              "vae": vae_params(), "clip_text": text_params(), "lama": lama_params(),
              "clip_vision": vision_params(JAX_VISION, 51),
              "clip_text_proj": text_proj_params(52)}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, gdino=JAX_GDINO, sam=JAX_SAM, ip2p_unet=JAX_UNET,
                        vae=JAX_VAE, text=JAX_TEXT, vision=JAX_VISION, box_threshold=0.0)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(cfg, device="cpu", params=params), params


IMAGES = [np.random.default_rng(80 + i).integers(0, 256, hw + (3,), np.uint8)
          for i, hw in enumerate([(48, 40), (40, 56), (64, 64)])]
INSTRUCTIONS = ["make it blue", "turn it into winter", "make it a painting"]
EDIT_STEPS = 3


def _u8_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


@pytest.mark.parametrize("masked", [False, True])
def test_ip2p_batch_matches_jax(zoo_pair, masked):
    """Three records through JAX's `ip2p_batch_fn` (bucket 4: one padded
    chunk) and the port's `ip2p().batch`, JAX's per-seed start latents and
    its batch-wide re-noise draw handed in; with masks on two of the three."""
    jzoo, zoo, _ = zoo_pair
    seeds = [0, 5, 9]
    masks = None
    if masked:
        m = np.zeros((40, 56), np.float32)
        m[8:30, 10:40] = 1.0
        masks = [None, m, np.ones((64, 64), np.float32)]
    ref = jzoo.ip2p_batch_fn(bucket=4)(IMAGES, INSTRUCTIONS, masks=masks, steps=EDIT_STEPS,
                                       seeds=seeds)
    init = torch.stack([T(np.array(jax.random.normal(jax.random.key(s), (1, 32, 32, 4),
                                                     jnp.float32)[0])) for s in seeds])
    renoise = T(np.array(jax.random.normal(jax.random.fold_in(jax.random.key(0), 1),
                                           (4, 32, 32, 4), jnp.float32)))[:3]
    got = zoo.ip2p().batch(IMAGES, INSTRUCTIONS, masks=masks, steps=EDIT_STEPS, seeds=seeds,
                           init_latents=init, renoise=renoise)
    for a, b, im in zip(got, ref, IMAGES):
        assert a.dtype == np.uint8 and a.shape == im.shape
        assert _u8_diff(a, b) <= 1


def test_ip2p_batch_matches_per_record(zoo_pair):
    """The port's `ip2p().batch` in chunks of 2 (3 records: two chunks)
    against its per-record `ip2p()` at the same seeds (its own draws)."""
    _, zoo, params = zoo_pair
    small = ModelZoo(dataclasses.replace(tiny_zoo_config(), edit_batch_bucket=2), device="cpu",
                     params=params)
    edit = small.ip2p()
    got = edit.batch(IMAGES, INSTRUCTIONS, steps=EDIT_STEPS, seeds=[3, 4, 5])
    for a, im, ins, s in zip(got, IMAGES, INSTRUCTIONS, [3, 4, 5]):
        assert _u8_diff(a, edit(im, ins, None, steps=EDIT_STEPS, seed=s)) <= 1


def test_clip_image_batch_matches(zoo_pair):
    """One tower forward for three images of different sizes: each (1, P)
    embedding within 1e-5 of the JAX tower's per-record one (and of the
    port's per-record call)."""
    jzoo, zoo, _ = zoo_pair
    jclip, _ = jzoo.clip_towers()
    clip_image, _ = zoo.clip_towers()
    got = clip_image.batch(IMAGES)
    assert len(got) == 3
    for z, im in zip(got, IMAGES):
        assert tuple(z.shape) == (1, JAX_VISION.proj_dim)
        np.testing.assert_allclose(z.numpy(), np.asarray(jclip(im)), atol=1e-5, rtol=0)
        np.testing.assert_allclose(z.numpy(), clip_image(im).numpy(), atol=1e-5, rtol=0)


def test_ground_batch_matches(zoo_pair):
    """Four records of mixed modes (merge, count with k 2, max, and a phrase
    with no word, whose span falls back to the caption): JAX's
    `ground.batch` (bucket 4) against the port's, record by record."""
    jzoo, zoo, _ = zoo_pair
    images = IMAGES + [IMAGES[0].copy()]
    phrases = ["red square", "car", "tree", "***"]
    modes, count_ks = ["merge", "count", "max", "merge"], [None, 2, None, None]
    ref = jzoo.grounder().batch(images, phrases, modes=modes, count_ks=count_ks, bucket=4)
    got = zoo.grounder().batch(images, phrases, modes=modes, count_ks=count_ks)
    for g, r, im in zip(got, ref, images):
        assert g is not None and r is not None
        np.testing.assert_allclose(g.boxes.numpy(), np.asarray(r.boxes), atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.scores.numpy(), np.asarray(r.scores), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(r.valid))
        assert g.mask.shape == im.shape[:2]
        assert (g.mask.numpy() == np.asarray(r.mask)).mean() >= 0.999
        assert abs(float(g.union_ratio) - float(r.union_ratio)) <= 1e-5


def test_ground_batch_none_where_nothing_is_kept(zoo_pair):
    """A record with no kept box gives None, as `ground` does."""
    _, zoo, params = zoo_pair
    strict = ModelZoo(dataclasses.replace(tiny_zoo_config(), box_threshold=1.0), device="cpu",
                      params=params)
    assert strict.grounder().batch(IMAGES[:2], ["red square", "car"]) == [None, None]


def test_tiny_zoo_chunk_matches_per_record(tmp_path, zoo_pair):
    """color_alter, remove, style_change and appearance_alter records through
    the port's tiny zoo (every slot real; 2 edit steps; the pre-gate on the
    image size, since random CLIP weights fail its threshold), in one chunk
    and per record: the same statuses, stages and reasons, edited frames
    within 1 level (the UNet runs at batch 3 x 2 against 3 x 1)."""
    _, zoo, _ = zoo_pair
    types = ["color_alter", "remove", "style_change", "appearance_alter"]
    lines = {}
    for label, gb in (("chunk", 4), ("one", 0)):
        tb = zoo.toolbox(slots=("clip",))
        ex = executor.FactoryExecutor(tb, executor.ExecutorConfig(
            output_root=str(tmp_path / label), grounding_batch=gb, ip2p_steps_override=2,
            run_post_filter=False),
            pre_scorer=lambda r, i: PreScores(width=i.shape[1], height=i.shape[0]))
        ex.run(_records(PORT, types)[:4], lambda r: IMAGES[0].copy())
        if gb:
            assert {"ground_batch", "clip_batch", "edit_batch"} <= set(ex.timer.report())
        lines[label] = [json.loads(x) for x in _ledger(tmp_path / label).splitlines()]
    compared = 0
    for a, b in zip(lines["chunk"], lines["one"], strict=True):
        assert (a["status"], a["payload"].get("stage"), a["payload"].get("reason")) == \
            (b["status"], b["payload"].get("stage"), b["payload"].get("reason"))
        if "edited_file" in a["payload"]:
            compared += 1
            assert _u8_diff(_png(a["payload"]["edited_file"]),
                            _png(b["payload"]["edited_file"])) <= 1
    assert compared >= 3          # color_alter, style_change, appearance_alter


def _png(path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))
