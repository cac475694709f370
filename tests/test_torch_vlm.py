"""The two LM gates of the PyTorch port against the JAX package's: VILA
(`models/vila.py`, the zoo's `vila_fn()`, slot "vila") and GOT-OCR2
(`models/ocr.py`, `ocr_fn()`, slot "ocr"), through the weight bridge and
the JAX converters, on both tiny zoos and through both executors; and the
port's `install` against the JAX zoo's slot names.

Both sides run the tiny towers in fp32 on the same Flax trees (the JAX
tiny config keeps the two language models in bf16; both sides run them in
fp32 here). Tolerances: logits and image tokens 1e-4 (outputs of unit
scale); yes/no answers, greedy ids, OCR text and ledger bytes equal.
"""

import dataclasses
import inspect
import json
import re
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyedit_tpu.edits.registry import get_pipeline as jax_get_pipeline
from anyedit_tpu.edits.types import Toolbox as JaxToolbox
from anyedit_tpu.models import clip as jclip
from anyedit_tpu.models import ocr as jocr
from anyedit_tpu.models import vila as jvila
from anyedit_tpu.models.blip2 import yes_no as jax_yes_no
from anyedit_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from anyedit_tpu.ops.resize import imagenet_normalize, resize_image
from anyedit_tpu.runtime import executor as jexecutor
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo, ZooConfig as JaxZooConfig
from anyedit_tpu.weights.convert import convert_got_ocr, convert_vila, save_params
from anyedit_tpu_torch.edits.registry import get_pipeline
from anyedit_tpu_torch.edits.types import Toolbox
from anyedit_tpu_torch.models import ocr, vila
from anyedit_tpu_torch.models.blip2 import yes_no
from anyedit_tpu_torch.models.llama import LlamaConfig
from anyedit_tpu_torch.runtime import executor
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.weights import bridge
from test_bpe import _mini_assets
from test_torch_bridge import F32, TF32, random_flax_params
from test_torch_executor import JAX, PORT, _loader, _records, stub_toolbox
from test_torch_llama import JAX_CFG as JAX_LLAMA, unit_norms
from test_torch_sam import JAX_SAM

torch.set_num_threads(1)
T = torch.from_numpy
TINY = tiny_zoo_config()
JAX_VILA = jvila.VilaConfig(vision=dataclasses.replace(jclip.TINY_VISION, use_proj=False, **F32),
                            lm=JAX_LLAMA, **F32)
JAX_OCR = jocr.OCRConfig(vision=JAX_SAM, lm=dataclasses.replace(jocr.TINY_QWEN, **F32),
                         max_tokens=8, **F32)
# a Qwen2-vocabulary LM, so that the GOT special ids of the chat prompt exist
CHAT_LM = dict(vocab_size=151860, dim=16, layers=1, heads=2, kv_heads=1, ffn_dim=32,
               rope_theta=1e4, norm_eps=1e-6, qkv_bias=True)
JAX_CHAT_OCR = dataclasses.replace(JAX_OCR, lm=JaxLlamaConfig(**CHAT_LM, **F32), max_tokens=4)
PORT_CHAT_OCR = dataclasses.replace(TINY.ocr, lm=LlamaConfig(**CHAT_LM, **TF32), max_tokens=4)
RNG = np.random.default_rng(70)
IDS = RNG.integers(1, 256, (2, 7)).astype(np.int32)
PX_VILA = RNG.standard_normal((2, 32, 32, 3)).astype(np.float32)
PX_OCR = RNG.standard_normal((2, 64, 64, 3)).astype(np.float32)
QUESTIONS = ["Is the color of red square close to blue?", "Is this a photo of a cat?"]


def vila_params(seed=71):
    return unit_norms(random_flax_params(
        jvila.VilaVQA(JAX_VILA), (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8), jnp.int32)),
        seed))


def ocr_params(cfg=JAX_OCR, seed=72):
    return unit_norms(random_flax_params(
        jocr.GotOCR(cfg), (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8), jnp.int32)), seed))


def _close(got, ref, atol=1e-4):
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def vila_pair():
    tree = vila_params()
    m = vila.VilaVQA(TINY.vila)
    m.load_state_dict(bridge.vila_state_dict(tree), strict=True)
    return tree, m.eval()


@pytest.fixture(scope="module")
def ocr_pair():
    tree = ocr_params()
    m = ocr.GotOCR(TINY.ocr)
    m.load_state_dict(bridge.ocr_state_dict(tree), strict=True)
    return tree, m.eval()


def test_vila_matches(vila_pair):
    """VilaVQA (23-layer-style tower cut, CLS dropped, fp32 exact-GELU
    projector, one prefill): next-token logits at 1e-4, yes/no equal."""
    tree, m = vila_pair
    ref = jvila.VilaVQA(JAX_VILA).apply(tree, PX_VILA, IDS)
    with torch.no_grad():
        got = m(T(PX_VILA), T(IDS).long())
    _close(got, ref)
    for yes, no in ((3, 5), (10, 2)):
        np.testing.assert_array_equal(yes_no(got, yes, no).numpy(),
                                      np.asarray(jax_yes_no(ref, yes, no)))


def test_got_ocr_matches(ocr_pair):
    """GotOCR: encode_image, lm_logits, lm_logits_chat and the full forward
    at 1e-4."""
    tree, m = ocr_pair
    jm = jocr.GotOCR(JAX_OCR)
    toks = jm.apply(tree, PX_OCR, method=jocr.GotOCR.encode_image)
    pre = IDS[:, :3]
    with torch.no_grad():
        got_toks = m.encode_image(T(PX_OCR))
        _close(got_toks, toks)
        t = T(np.array(toks))
        _close(m.lm_logits(t, T(IDS).long()), jm.apply(tree, toks, IDS,
                                                       method=jocr.GotOCR.lm_logits))
        _close(m.lm_logits_chat(t, T(pre).long(), T(IDS).long()),
               jm.apply(tree, toks, pre, IDS, method=jocr.GotOCR.lm_logits_chat))
        _close(m(T(PX_OCR), T(IDS).long()), jm.apply(tree, PX_OCR, IDS))


@pytest.mark.parametrize("prompt", ["default", "suffix"])
def test_greedy_decode_ids_equal(ocr_pair, prompt):
    """greedy_decode (the full forward re-run per token): ids equal JAX's,
    from the default [0] seed and from a 3-id prompt with stop ids that the
    decode hits (the loop ends early on both sides)."""
    tree, m = ocr_pair
    jm = jocr.GotOCR(JAX_OCR)
    toks = jm.apply(tree, PX_OCR, method=jocr.GotOCR.encode_image)
    japply = jax.jit(lambda it, ids: jm.apply(tree, it, ids, method=jocr.GotOCR.lm_logits))
    kw = {} if prompt == "default" else {"prompt_ids": [5, 9, 11]}
    ref = jocr.greedy_decode(japply, toks, 8, **kw)
    if prompt == "suffix":
        kw["stop_ids"] = frozenset({int(ref[0, 5]), int(ref[1, 6])})
        ref = jocr.greedy_decode(japply, toks, 8, **kw)
    got = ocr.greedy_decode(m.lm_logits, T(np.array(toks)), 8, **kw)
    np.testing.assert_array_equal(got, ref)
    assert ocr.detokenize_ids(got[0], lambda i: f"▁t{i}", eos_id=int(got[0, 4])) == \
        jocr.detokenize_ids(ref[0], lambda i: f"▁t{i}", eos_id=int(got[0, 4]))


def test_vila_bridge_round_trip(vila_pair):
    """The port's VILA state dict is HF llava-named: `convert_vila` reads it
    back into the JAX tree bit for bit, and `vila_tree` inverts the bridge."""
    tree, m = vila_pair
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert_vila(tree, sd), tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, bridge.vila_tree(m.state_dict(), tree),
                           tree)


_GOT_VISION = [(r"patch_embed\.proj\.", "patch_embed.projection."),
               (r"blocks\.(\d+)\.norm(\d)\.", r"layers.\1.layer_norm\2."),
               (r"blocks\.", "layers."),
               (r"neck\.0\.", "neck.conv1."), (r"neck\.1\.", "neck.layer_norm1."),
               (r"neck\.2\.", "neck.conv2."), (r"neck\.3\.", "neck.layer_norm2.")]


def test_ocr_bridge_round_trip(ocr_pair):
    """A seeded HF GotOcr2-named state dict (the port's, its vision keys
    renamed to GOT's, the lm head a separate tensor beside the embedding as
    the tied checkpoint carries it) through `convert_got_ocr` gives the JAX
    tree bit for bit, and `ocr_tree` inverts the bridge."""
    tree, m = ocr_pair
    hf = {}
    for k, v in m.state_dict().items():
        if k.startswith("model.vision_tower."):
            for pat, rep in _GOT_VISION:
                k = re.sub(pat, rep, k)
        hf[k] = v.numpy()
    assert "lm_head.weight" in hf and "model.language_model.embed_tokens.weight" in hf
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert_got_ocr(tree, hf),
                           tree["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, bridge.ocr_tree(m.state_dict(), tree),
                           tree)


# ---- the zoo slots ----------------------------------------------------------------

@pytest.fixture(scope="module")
def zoo_pair(tmp_path_factory):
    params = {"vila": vila_params(73), "ocr": ocr_params(seed=74)}
    wdir = tmp_path_factory.mktemp("weights")
    for name, tree in params.items():
        save_params(tree, wdir / f"{name}.msgpack")
    jzoo = JaxModelZoo(JaxZooConfig(canvas=TINY.canvas, vila=JAX_VILA, ocr=JAX_OCR),
                       weights_dir=wdir, allow_fallback_tokenizers=True)
    return jzoo, ModelZoo(TINY, device="cpu", params=params)


IMAGES = [np.random.default_rng(s).integers(0, 256, (48, 40, 3), np.uint8) for s in (1, 2)]


@pytest.mark.parametrize("question", QUESTIONS)
def test_vila_fn_matches(zoo_pair, question):
    """The zoo's VILA answer equals the JAX zoo's on two images; its logits
    equal the JAX model's on the JAX zoo's inputs (bilinear resize, ImageNet
    normalization, 32 hash ids modulo the vocabulary) at 1e-4."""
    jzoo, zoo = zoo_pair
    ask, jask = zoo.vila_fn(), jzoo.vila_fn()
    for img in IMAGES:
        px = resize_image(jnp.asarray(img, jnp.float32) / 255.0, 32, 32, "bilinear")
        ref = jvila.VilaVQA(JAX_VILA).apply(zoo.params["vila"], imagenet_normalize(px)[None],
                                            jzoo._ids(question, 32, 256))
        _close(ask.logits(img, question), ref)
        assert ask(img, question) == jask(img, question)
    assert ask.yes_no_ids == tuple(int(jzoo._ids(w, 3, 256)[0, 1]) for w in ("yes", "no"))


def test_ocr_fn_placeholder_matches(zoo_pair):
    """Without Qwen2 assets: the placeholder pieces, equal text."""
    jzoo, zoo = zoo_pair
    read, jread = zoo.ocr_fn(), jzoo.ocr_fn()
    for img in IMAGES:
        text = read(img)
        assert text == jread(img) and text.startswith("t")


def test_ocr_fn_chat_matches(tmp_path):
    """With Qwen2 assets in the weights dir (the port's holding only them):
    the GOT chat prompt, the real vocabulary, equal text."""
    tree = ocr_params(JAX_CHAT_OCR, 75)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        _mini_assets(d)
    save_params(tree, jdir / "ocr.msgpack")
    jzoo = JaxModelZoo(JaxZooConfig(ocr=JAX_CHAT_OCR), weights_dir=jdir,
                       allow_fallback_tokenizers=True)
    zoo = ModelZoo(dataclasses.replace(TINY, ocr=PORT_CHAT_OCR), device="cpu",
                   params={"ocr": tree}, weights_dir=pdir, allow_fallback_tokenizers=True)
    read, jread = zoo.ocr_fn(), jzoo.ocr_fn()
    for img in IMAGES:
        assert read(img) == jread(img)


def _string_literals(fn) -> set:
    return set(re.findall(r'"(\w+)"', inspect.getsource(fn)))


def test_install_accepts_the_jax_slot_names():
    """Every name written in either zoo's `install`: the port's install
    accepts it exactly where the JAX zoo's does (both called on a stand-in
    zoo, so no slot is built), and raises KeyError elsewhere."""
    names = _string_literals(ModelZoo.install) | _string_literals(JaxModelZoo.install) | {"x"}

    def accepts(install, tb_cls, name):
        zoo = mock.MagicMock()
        zoo.clip_towers.return_value = (None, None)
        try:
            install(zoo, tb_cls(), name)
            return True
        except KeyError:
            return False
    port = {n for n in names if accepts(ModelZoo.install, Toolbox, n)}
    ref = {n for n in names if accepts(JaxModelZoo.install, JaxToolbox, n)}
    assert port == ref and {"vila", "ocr"} <= port and len(port) == 22


def test_executors_match_with_vila(tmp_path, zoo_pair):
    """One color_alter record through the JAX and the port executor (the
    stub grounder and editor, no pre-filter) with "vila" installed as the
    VQA judge: the ledgers are byte-equal, and the post-filter's vqa_yes
    is VILA's answer."""
    jzoo, zoo = zoo_pair
    root = tmp_path / "out"
    ledgers = {}
    for kind, ex_mod, z in ((JAX, jexecutor, jzoo), (PORT, executor, zoo)):
        tb = stub_toolbox(kind)
        z.install(tb, "vila")
        ex = ex_mod.FactoryExecutor(tb, ex_mod.ExecutorConfig(output_root=str(root),
                                                              run_pre_filter=False))
        ex.run(_records(kind, 1), _loader)
        ledgers[kind] = (root / "ledger.jsonl").read_bytes()
        if kind == JAX:
            shutil.rmtree(root)
    assert ledgers[PORT] == ledgers[JAX]
    line = json.loads(ledgers[PORT])
    rec = _records(PORT, 1)[0]
    edited = get_pipeline("color_alter")(tb, rec, _loader(rec), None).edited
    want = zoo.vila_fn()(edited, "Is the color of red square close to blue?")
    assert line["payload"]["scores"]["vqa_yes"] is want


def test_textual_change_ocr_gate_matches(zoo_pair):
    """textual_change with `tb.ocr` from each tiny zoo (a stub pair of frames
    in place of Flux): the placeholder reader matches no quoted string, so
    both pipelines fail closed with the same reason after the same reads."""
    jzoo, zoo = zoo_pair
    frames = (IMAGES[0], IMAGES[1])
    rec = {"edit": "change the sign to CLOSED", "input": 'a shop sign that says "OPEN"',
           "output": 'a shop sign that says "CLOSED"', "edit_type": "textual_change"}
    outs = {}
    for kind, tb_cls, get, z in ((JAX, JaxToolbox, jax_get_pipeline, jzoo),
                                 (PORT, Toolbox, get_pipeline, zoo)):
        reads = []
        read = z.ocr_fn()
        tb = tb_cls(extra={"flux_pair": lambda a, b, seed: frames})
        tb.ocr = lambda img: reads.append(read(img)) or reads[-1]
        rec_cls = _records(kind, 1)[0].__class__
        out = get("textual_change")(tb, rec_cls.from_json(rec), None, np.random.default_rng(0))
        outs[kind] = (out.success, out.reason, reads)
    assert outs[PORT] == outs[JAX]
    assert outs[PORT][:2] == (False, "OCR text mismatch") and len(outs[PORT][2]) == 1
