"""The per-record `FactoryExecutor` of the PyTorch port against the JAX
package's on the same `color_alter` / `tone_transfer` records.

On stub toolboxes (in the style of `tests/test_executor.py`; each package
gets its own types: numpy masks for JAX, tensors for the port) the two
executors give equal ledger statuses and payload keys, equal scores, equal
PNG pixels and equal live grounding calls. On both tiny zoos, with the
grounder and every scorer slot real and the same stub editor (the IP2P
noise differs between the packages), they give equal statuses and scores
within 1e-4. The PNG writer round-trips through PIL.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from anyedit_tpu.core.schema import InstructionRecord as JaxRecord
from anyedit_tpu.edits.types import EditOutcome as JaxOutcome, Toolbox as JaxToolbox
from anyedit_tpu.filters.pre_filter import PreScores as JaxPreScores
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import save_params
from anyedit_tpu_torch.core.ledger import Shard
from anyedit_tpu_torch.core.png import encode_png, write_png
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox
from anyedit_tpu_torch.filters.pre_filter import PreScores
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from test_torch_blip2 import JAX_QF, JAX_T5, blip2_params
from test_torch_bridge import JAX_TEXT
from test_torch_gdino import JAX_GDINO, gdino_params
from test_torch_sam import JAX_SAM, sam_params
from test_torch_scorers import JAX_VISION, aesthetic_params, text_proj_params, vision_params

torch.set_num_threads(1)
H, W = 48, 40
GRASS = np.array([40, 160, 40], np.uint8)
RED = np.array([220, 30, 30], np.uint8)
PORT, JAX = "port", "jax"
PKG = {PORT: (InstructionRecord, Toolbox, executor, PreScores),
       JAX: (JaxRecord, JaxToolbox, jexecutor, JaxPreScores)}


def scene(red: bool = True) -> np.ndarray:
    img = np.tile(GRASS, (H, W, 1))
    if red:
        img[12:28, 10:26] = RED
    return img


def _records(kind, n=6):
    rec_cls = PKG[kind][0]
    out = []
    for i in range(n):
        et = "tone_transfer" if i % 3 == 2 else "color_alter"
        out.append(rec_cls.from_json({
            "edit": f"make the square blue {i}", "edited object": "red square",
            "input": "a red square on grass", "output": "a blue square on grass",
            "edit_type": et, "image_file": f"img_{i}.jpg"}))
    return out


def _loader(rec):
    return scene(red=rec.image_file != "img_1.jpg")   # img_1: no object -> failure


@dataclasses.dataclass
class FakeGround:
    mask: object
    boxes: np.ndarray
    valid: np.ndarray
    union_ratio: float


def stub_toolbox(kind, calls=None, scorers=False):
    """ground: the red pixels (None where there are none); ip2p: the
    negative image. With `scorers`, CLIP towers of mean colours and hashed
    words, a VQA that answers on the question's length, and an OCR."""
    tensor = torch.from_numpy if kind == PORT else np.asarray

    def ground(image, phrase, mode="merge", count_k=None):
        if calls is not None:
            calls.append((id(image), phrase, mode))
        mask = (image[..., 0] > 180) & (image[..., 2] < 100) if "red" in phrase \
            else np.zeros(image.shape[:2], bool)
        if not mask.any():
            return None
        ys, xs = np.nonzero(mask)
        box = np.array([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]], np.float32)
        return FakeGround(tensor(mask), box, np.array([True]), float(mask.mean()))

    def ip2p(image, instruction, mask01, steps=50, s_txt=8.0, s_img=0.9, **kw):
        if calls is not None:
            calls.append(("ip2p", steps, s_txt, s_img))
        return 255 - image

    tb = PKG[kind][1](ground=ground, ip2p=ip2p)
    if scorers:
        def unit(v):
            v = np.asarray(v, np.float32)[None]
            return tensor(v / np.linalg.norm(v))
        tb.clip_image = lambda img: unit(np.concatenate([img.reshape(-1, 3).mean(0), [7.0]]))
        tb.clip_text = lambda text: unit([len(w) for w in (text + " a b c d").split()][:4])
        tb.vqa_yes_no = lambda img, q: len(q) % 2 == 0
        tb.ocr = lambda img: "Hello"
        tb.extra["aesthetic"] = lambda img: 5.0
    return tb


def _run(kind, tmp_path, tb=None, records=None, shard=None, pre_scorer=None, **cfg):
    ex_mod = PKG[kind][2]
    ex = ex_mod.FactoryExecutor(tb or stub_toolbox(kind),
                                ex_mod.ExecutorConfig(output_root=str(tmp_path / kind), **cfg),
                                pre_scorer=pre_scorer)
    report = ex.run(records or _records(kind), _loader, shard=shard)
    return ex, report


def _lines(tmp_path, kind):
    return [json.loads(x) for x in (tmp_path / kind / "ledger.jsonl").read_text().splitlines()]


def _same_ledgers(tmp_path, atol=0.0):
    port, ref = _lines(tmp_path, PORT), _lines(tmp_path, JAX)
    assert [(x["key"], x["status"], sorted(x["payload"])) for x in port] == \
        [(x["key"], x["status"], sorted(x["payload"])) for x in ref]
    for a, b in zip(port, ref):
        assert a["record"] == b["record"]
        assert a["payload"].get("stage") == b["payload"].get("stage")
        sa, sb = a["payload"].get("scores", {}), b["payload"].get("scores", {})
        assert sa.keys() == sb.keys()
        for k in sa:
            if isinstance(sa[k], float):
                assert abs(sa[k] - sb[k]) <= atol, (k, sa[k], sb[k])
            else:
                assert sa[k] == sb[k], k
    return port


@pytest.mark.parametrize("post", [True, False])
def test_end_to_end_matches(tmp_path, post):
    """Six records: color_alter filtered by the post-filter (or a success
    without it), one failure (no object), tone_transfer successes; equal
    statuses, payload keys, scores, stage names and PNG pixels."""
    _, rp = _run(PORT, tmp_path, run_post_filter=post)
    _, rj = _run(JAX, tmp_path, run_post_filter=post)
    lines = _same_ledgers(tmp_path)
    assert rp["counts"] == rj["counts"]
    assert rp["counts"]["failure"] == 1 and rp["counts"]["success"] >= 2
    assert {k: v["count"] for k, v in rp["stages"].items()} == \
        {k: v["count"] for k, v in rj["stages"].items()}
    for line in lines:
        for key in ("edited_file", "mask_file"):
            if key in line["payload"]:
                port = np.asarray(Image.open(line["payload"][key]))
                ref = np.asarray(Image.open(line["payload"][key].replace("/port/", "/jax/")))
                np.testing.assert_array_equal(port, ref)


def test_resume_and_shard_match(tmp_path):
    """Shard 0 of 2, then a resume over all: the same counts and only the
    remaining records run."""
    reports = {}
    for kind in (PORT, JAX):
        shard_cls = Shard if kind == PORT else jexecutor.Shard
        _run(kind, tmp_path, shard=shard_cls(index=0, count=2))
        reports[kind] = _run(kind, tmp_path)[1]
    assert reports[PORT]["counts"] == reports[JAX]["counts"]
    assert sum(reports[PORT]["counts"].values()) == 6
    assert reports[PORT]["stages"]["load"]["count"] == reports[JAX]["stages"]["load"]["count"] == 3
    _same_ledgers(tmp_path)


def test_contained_crash_matches(tmp_path):
    """A grounder that raises fails every record (the pre-scorer grounds
    each one), with the error kept in the payload."""
    for kind in (PORT, JAX):
        tb = stub_toolbox(kind)

        def boom(image, phrase, **kw):
            raise RuntimeError("boom")
        tb.ground = boom
        assert _run(kind, tmp_path, tb=tb)[1]["counts"]["failure"] == 6
    assert all(x["payload"]["error"] == "RuntimeError: boom" for x in _same_ledgers(tmp_path))


def test_pre_gate_matches(tmp_path):
    """A pre-scorer with aspect ratio > 2 filters every record at "pre"."""
    for kind in (PORT, JAX):
        pre = PKG[kind][3]
        _, report = _run(kind, tmp_path, pre_scorer=lambda rec, img: pre(width=2000, height=300))
        assert report["counts"]["filtered"] == 6
    assert {x["payload"]["stage"] for x in _same_ledgers(tmp_path)} == {"pre"}


def test_grounding_memo_matches(tmp_path):
    """With the pre-filter on, each color_alter record runs one live
    grounding (the pre-scorer's object ratio and the pipeline's mask) in
    both executors; a second executor over the same toolbox grounds anew,
    and wrapping stays one layer deep."""
    live = {}
    for kind in (PORT, JAX):
        live[kind] = []
        tb = stub_toolbox(kind, calls=live[kind])
        _run(kind, tmp_path, tb=tb, run_post_filter=False)
        n = sum(1 for c in live[kind] if c[0] != "ip2p")
        assert n == 6, live[kind]    # 4 color_alter records + 2 tone pre-scores
        ex2, _ = _run(kind, tmp_path / "again", tb=tb, run_post_filter=False)
        assert sum(1 for c in live[kind] if c[0] != "ip2p") == 12
        assert not hasattr(ex2.tb.ground._real, "_real")
    _same_ledgers(tmp_path)


def test_ip2p_steps_override_matches(tmp_path):
    """The pipelines ask for 100 steps at 8.0 / 0.9; the override runs 7."""
    calls = {}
    for kind in (PORT, JAX):
        calls[kind] = []
        _run(kind, tmp_path, tb=stub_toolbox(kind, calls=calls[kind]), ip2p_steps_override=7)
    edits = [c for c in calls[PORT] if c[0] == "ip2p"]
    assert edits == [c for c in calls[JAX] if c[0] == "ip2p"]
    assert edits and set(edits) == {("ip2p", 7, 8.0, 0.9)}


# (edit type, the outcome's mask, the object still in the edited image)
POST_CASES = [("color_alter", False, False), ("tone_transfer", False, False),
              ("add", False, True), ("remove", True, True), ("remove", True, False),
              ("counting", False, False), ("replace", False, False),
              ("background_change", False, False), ("textual_change", False, False)]


@pytest.mark.parametrize("edit_type,with_mask,kept", POST_CASES)
def test_default_scorers_match(edit_type, with_mask, kept):
    """Both packages' default pre- and post-scorers on the same outcome of
    each edit type, with stub CLIP, VQA, OCR and aesthetic slots: equal
    scores (1e-6; directional CLIP runs in jnp and in torch)."""
    scores = {}
    img = scene()
    edited = img.copy() if kept else 255 - img
    for kind in (PORT, JAX):
        rec_cls, _, ex_mod, _ = PKG[kind]
        rec = rec_cls.from_json({"edit": "make it blue", "edited object": "red square",
                                 "new object": "red ball", "input": 'a sign "OPEN"',
                                 "output": 'a sign "Hello"', "edit_type": edit_type,
                                 "new background": "a beach"})
        ex = ex_mod.FactoryExecutor(stub_toolbox(kind, scorers=True), ex_mod.ExecutorConfig())
        mask = (img[..., 0] > 180) if with_mask else None
        outcome = (EditOutcome if kind == PORT else JaxOutcome)(
            True, edited=edited, input_image=img, mask=mask)
        scores[kind] = (dataclasses.asdict(ex.pre_scorer(rec, img)),
                        dataclasses.asdict(ex.post_scorer(rec, img, outcome)))
    # the port keeps JSON types (the JAX remove rule leaves a numpy bool)
    json.dumps(scores[PORT])
    for port, ref in zip(scores[PORT], scores[JAX]):
        assert port.keys() == ref.keys()
        for k in port:
            if isinstance(ref[k], float):
                assert abs(port[k] - ref[k]) <= 1e-6, k
            else:
                assert port[k] == ref[k], k


@pytest.mark.parametrize("shape", [(5, 7), (6, 3, 3), (4, 9, 4), (1, 1, 3)])
def test_png_round_trips(tmp_path, shape):
    """Grayscale, RGB and RGBA through PIL's decoder, byte for byte."""
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    write_png(tmp_path / "a.png", a)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), a)
    with pytest.raises(TypeError):
        encode_png(a.astype(np.float32))


def test_profile_trace_written(tmp_path):
    """`profile_trace_dir` writes a torch.profiler trace of the run."""
    _, report = _run(PORT, tmp_path, records=_records(PORT, 2),
                     profile_trace_dir=str(tmp_path / "trace"))
    assert sum(report["counts"].values()) == 2
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]


@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    """Both tiny zoos on the same params: the grounder and every scorer."""
    params = {"gdino": gdino_params(), "sam": sam_params(),
              "clip_vision": vision_params(JAX_VISION, 51), "clip_text_proj": text_proj_params(52),
              "aesthetic": aesthetic_params(53), "eva_vit": vision_params(JAX_VISION, 54),
              "blip2": blip2_params(55)}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    cfg = tiny_zoo_config()
    jcfg = JaxZooConfig(canvas=cfg.canvas, gdino=JAX_GDINO, sam=JAX_SAM,
                        text=JAX_TEXT,
                        vision=JAX_VISION, eva=JAX_VISION, qformer=JAX_QF,
                        flux_text=dataclasses.replace(JAX_T5, vocab_size=30522),
                        box_threshold=0.0)
    jzoo = JaxModelZoo(jcfg, weights_dir=wdir, allow_fallback_tokenizers=True)
    zoo = ModelZoo(cfg, device="cpu", params=params)
    slots = ("clip", "aesthetic", "vqa")
    jtb = JaxToolbox(ground=jzoo.grounder())
    for s in slots:
        jzoo.install(jtb, s)
    ptb = zoo.toolbox(slots=slots)
    return {PORT: ptb, JAX: jtb}


@pytest.mark.parametrize("pre", [True, False])
def test_tiny_zoos_match(tmp_path, zoo_pair, pre):
    """Both tiny zoos with the grounder, CLIP, aesthetic and VQA slots (the
    stub editor on both): equal statuses and scores within 1e-4, with the
    pre-filter on (the pre-scores held too) and off."""
    pres = {}
    for kind in (PORT, JAX):
        tb = zoo_pair[kind]
        tb.ip2p = stub_toolbox(kind).ip2p
        ex, _ = _run(kind, tmp_path, tb=tb, records=_records(kind, 3), run_pre_filter=pre)
        img = scene()
        pres[kind] = dataclasses.asdict(ex._default_pre_scorer(_records(kind, 1)[0], img))
    lines = _same_ledgers(tmp_path, atol=1e-4)
    # random weights: the pre-gate filters every record on CLIP; without
    # it every record reaches the post-filter, whose scores were compared
    assert len(lines) == 3 and all(
        x["payload"].get("stage") == ("pre" if pre else "post") for x in lines)
    for k, v in pres[JAX].items():
        if isinstance(v, float):
            assert abs(pres[PORT][k] - v) <= 1e-4, k
        else:
            assert pres[PORT][k] == v, k
