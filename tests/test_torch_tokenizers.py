"""The tokenizers of the PyTorch port against the JAX package's:
SentencePiece (`models/sentencepiece.py`) on models written with
`serialize_model`, the Qwen2 byte-level BPE (`models/bpe.py`) on mini
assets, and the zoo's tokenizer selection from a weights dir
(`select_tokenizers`, `_t5_ids` with and without `spiece.model`, the
refusal of a dir that holds weights).

Ids and strings must be equal, no tolerance.
"""

import json

import numpy as np
import pytest

from anyedit_tpu.models import bpe as jbpe
from anyedit_tpu.models import sentencepiece as jsp
from anyedit_tpu.runtime.zoo import ModelZoo as JaxModelZoo
from anyedit_tpu.runtime.zoo import select_tokenizers as jax_select_tokenizers
from anyedit_tpu_torch.models import bpe, sentencepiece as sp
from anyedit_tpu_torch.runtime.zoo import ModelZoo, select_tokenizers
from test_bpe import TEXTS, _mini_assets

BASE = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
BASE_T = [3, 3, 2]   # control, control, unknown
BYTES = [(f"<0x{b:02X}>", -10.0) for b in range(256)]
MODELS = {
    "viterbi": (BASE + [("▁hello", -1.0), ("▁hel", -2.0), ("lo", -2.0), ("▁world", -1.5),
                        ("▁", -3.0), ("▁ab", -5.0), ("c", -1.0), ("▁a", -1.0), ("bc", -1.0),
                        ("▁cat", -1.0), ("▁fi", -1.0), ("n", -1.5)], BASE_T + [1] * 12),
    "bytes": (BASE + BYTES + [("▁a", -1.0), ("▁cat", -2.0), ("é", -1.0)],
              BASE_T + [6] * 256 + [1] * 3),
    "unk_later": ([("<pad>", 0.0), ("</s>", 0.0), ("▁x", -1.0), ("<unk>", 0.0)], [3, 3, 1, 2]),
}
SP_TEXTS = ["hello world", "abc", "xq", "aé café", "a\ncat", "a\t cat", "a  cat", "ﬁn",
            "  hello   world  ", "", "日本 a"]


def _models(tmp_path, name):
    pieces, types = MODELS[name]
    data = sp.serialize_model([p for p, _ in pieces], [s for _, s in pieces], types)
    assert data == jsp.serialize_model([p for p, _ in pieces], [s for _, s in pieces], types)
    f = tmp_path / "spiece.model"
    f.write_bytes(data)
    return sp.SentencePieceModel.from_file(f), jsp.SentencePieceModel.from_file(f)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sentencepiece_matches(tmp_path, name):
    """Viterbi splits, unk and byte fallback, NFKC and whitespace folding,
    with and without eos, and `encode_padded` (padded and cut): the same
    ids; the unk id read from the piece types."""
    got, ref = _models(tmp_path, name)
    assert (got.pieces, got.scores, got.unk_id) == (ref.pieces, ref.scores, ref.unk_id)
    for text in SP_TEXTS:
        for eos in (True, False):
            assert got.encode(text, add_eos=eos) == ref.encode(text, add_eos=eos), text
        for n in (1, 4, 12):
            assert got.encode_padded(text, n) == ref.encode_padded(text, n), (text, n)


@pytest.mark.parametrize("text", TEXTS)
def test_qwen2_bpe_matches(tmp_path, text):
    """encode, decode and encode_chat (text with the GOT special ids) on the
    mini vocab / merges pair."""
    _mini_assets(tmp_path)
    got, ref = bpe.Qwen2Tokenizer.from_dir(tmp_path), jbpe.Qwen2Tokenizer.from_dir(tmp_path)
    ids = got.encode(text)
    assert ids == ref.encode(text)
    assert got.decode(ids) == ref.decode(ids)
    seg = [bpe.IM_START, text, bpe.IMG_PAD, "the", bpe.IM_END]
    assert got.encode_chat(seg) == ref.encode_chat(seg)
    assert got.decode(got.encode_chat(seg)) == ref.decode(ref.encode_chat(seg))


def test_qwen2_bundle_and_prompt_match(tmp_path):
    """`got_tokenizer.json` (vocab, merges and added tokens in one file) and
    the GOT chat prompt ids around the image tokens; no assets -> None."""
    assert bpe.Qwen2Tokenizer.from_dir(tmp_path) is None
    vocab, merges = _mini_assets(tmp_path)
    assert bpe.got_prompt_ids(bpe.Qwen2Tokenizer.from_dir(tmp_path)) == \
        jbpe.got_prompt_ids(jbpe.Qwen2Tokenizer.from_dir(tmp_path))
    bundle = {"model": {"vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
              "added_tokens": [{"content": "<|endoftext|>", "id": bpe.ENDOFTEXT},
                               {"content": "<imgpad>", "id": bpe.IMG_PAD}]}
    (tmp_path / "got_tokenizer.json").write_text(json.dumps(bundle))
    got, ref = bpe.Qwen2Tokenizer.from_dir(tmp_path), jbpe.Qwen2Tokenizer.from_dir(tmp_path)
    assert got.added == ref.added
    assert bpe.got_prompt_ids(got) == jbpe.got_prompt_ids(ref)
    for text in TEXTS:
        assert got.encode(text) == ref.encode(text)
    assert (bpe.ENDOFTEXT, bpe.IM_START, bpe.IM_END, bpe.IMG_START, bpe.IMG_END,
            bpe.IMG_PAD) == (jbpe.ENDOFTEXT, jbpe.IM_START, jbpe.IM_END, jbpe.IMG_START,
                             jbpe.IMG_END, jbpe.IMG_PAD)


def _assets(d, vocab=True, merges=True):
    d.mkdir(parents=True, exist_ok=True)
    if vocab:
        words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "car", "##s", "on", "the"]
        (d / "vocab.txt").write_text("\n".join(words))
    if merges:
        (d / "clip_merges.txt").write_text("#version: 0.2\nr e\nre d</w>\nc a\nca r</w>\n")
    return d


@pytest.mark.parametrize("assets", ["none", "both", "vocab_only", "missing"])
def test_select_tokenizers_matches(tmp_path, assets):
    """No dir: the hash tokenizers; vocab.txt and the CLIP merges: WordPiece
    and CLIP BPE; a dir without them raises unless the fallback is allowed.
    Encodings equal JAX's either way."""
    d = None if assets == "none" else _assets(
        tmp_path / assets, vocab=assets in ("both", "vocab_only"), merges=assets == "both")
    if assets in ("vocab_only", "missing"):
        for fn in (select_tokenizers, jax_select_tokenizers):
            with pytest.raises(FileNotFoundError):
                fn(d, 49408)
    got = select_tokenizers(d, 49408, allow_fallback=True)
    ref = jax_select_tokenizers(d, 49408, allow_fallback=True)
    assert [type(t).__name__ for t in got] == [type(t).__name__ for t in ref]
    for text in ("a red car", "The cars on the road.", "zebra"):
        assert got[0].encode(text).ids == ref[0].encode(text).ids
        assert got[1].encode(text) == ref[1].encode(text)


@pytest.mark.parametrize("spiece", [False, True])
def test_t5_ids_match(tmp_path, spiece):
    """`_t5_ids`: SentencePiece ids (eos, zero-padded) with `spiece.model`
    in the weights dir, the hash ids modulo T5's vocabulary without."""
    d = _assets(tmp_path / "w")
    if spiece:
        _models(d, "bytes")
    zoo = ModelZoo(device="cpu", weights_dir=d)
    jzoo = JaxModelZoo(weights_dir=d)
    for text in ("a cat", "aé  cat\n", "Is the color of car close to red?"):
        got, ref = zoo._t5_ids(text, 8), jzoo._t5_ids(text, 8)
        np.testing.assert_array_equal(got, ref)
    assert (zoo._sentencepiece() is None) == (not spiece)


def test_weights_dir_with_weights_is_refused(tmp_path):
    """The port reads only tokenizer assets from weights_dir: a dir that
    holds a converted checkpoint is refused, so that no slot the JAX zoo
    would load is seeded here."""
    d = _assets(tmp_path / "w")
    (d / "ocr.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="ocr.msgpack"):
        ModelZoo(device="cpu", weights_dir=d)
    with pytest.raises(FileNotFoundError):
        ModelZoo(device="cpu", weights_dir=_assets(tmp_path / "v", vocab=False))
    ModelZoo(device="cpu", weights_dir=_assets(tmp_path / "v2", vocab=False),
             allow_fallback_tokenizers=True)
