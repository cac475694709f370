"""Qwen2-family byte-level BPE tokenizer (GOT-OCR2's text side).

A copy of `anyedit_tpu/models/bpe.py`, kept here because the JAX package's
`models/__init__` imports Flax.

The reference's textual gate calls `model.chat(tokenizer, ...)` on
stepfun-ai/GOT-OCR2_0 (filter_tool/utils.py:43-49), whose tokenizer is the
Qwen2 GPT-2-style byte-level BPE (no `</w>` word-end marker, unlike CLIP's)
plus added special tokens. Rebuilt here so the converted GOT checkpoint
receives real ids and its greedy output detokenizes to comparable text.

Assets (place next to the converted `ocr.msgpack` in weights_dir):
  * `qwen_vocab.json` + `qwen_merges.txt` — the HF `vocab.json`/`merges.txt`
    pair, renamed to avoid clashing with other towers' assets; or
  * `got_tokenizer.json` — the HF fast-tokenizer bundle (vocab + merges +
    added special tokens in one file).

Special ids (Qwen2 layout, confirmed against HF GotOcr2Config):
  <|endoftext|> 151643 · <|im_start|> 151644 · <|im_end|> 151645 ·
  <img> 151857 · </img> 151858 · <imgpad> 151859 (= image_token_index).
"""

from __future__ import annotations

import json
from pathlib import Path

from anyedit_tpu_torch.models.clip_tokenizer import _bytes_to_unicode

ENDOFTEXT = 151643
IM_START = 151644
IM_END = 151645
IMG_START = 151857
IMG_END = 151858
IMG_PAD = 151859

# HF Qwen2Tokenizer PRETOKENIZE_REGEX, verbatim (needs the `regex` module
# for \p{L}/\p{N} classes; it is imported in the constructor, since a
# machine without tokenizer assets need not have it)
_PRETOK = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
           r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


class Qwen2Tokenizer:
    """encode(text) -> ids (no specials added); decode(ids) -> text."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 added: dict[str, int] | None = None):
        import regex
        self._re = regex.compile(_PRETOK)
        self.encoder = dict(vocab)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.added = dict(added or {})
        for t, i in self.added.items():
            self.decoder[i] = t
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self._cache: dict[str, list[str]] = {}

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dir(cls, d: str | Path) -> "Qwen2Tokenizer | None":
        """Load from weights_dir; None when no assets ship (hermetic run)."""
        d = Path(d)
        tj = d / "got_tokenizer.json"
        if tj.exists():
            blob = json.loads(tj.read_text(encoding="utf-8"))
            model = blob["model"]
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                      for m in model["merges"]]
            added = {t["content"]: t["id"] for t in blob.get("added_tokens", [])}
            return cls(model["vocab"], merges, added)
        vj, mt = d / "qwen_vocab.json", d / "qwen_merges.txt"
        if vj.exists() and mt.exists():
            vocab = json.loads(vj.read_text(encoding="utf-8"))
            lines = mt.read_text(encoding="utf-8").split("\n")
            merges = [tuple(ln.split()) for ln in lines
                      if ln and not ln.startswith("#version") and len(ln.split()) == 2]
            # Qwen2's specials sit above the BPE vocab; GOT's image tokens too
            added = {"<|endoftext|>": ENDOFTEXT, "<|im_start|>": IM_START,
                     "<|im_end|>": IM_END, "<img>": IMG_START,
                     "</img>": IMG_END, "<imgpad>": IMG_PAD}
            return cls(vocab, merges, added)
        return None

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        pieces = list(word)
        self._cache[token] = pieces
        return pieces

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in self._re.findall(text):
            tok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            for p in self._bpe(tok):
                # byte-level BPE closes over its merge table: every piece a
                # merge produces must be in the vocab. A miss means the
                # vocab/merges pair is corrupt or mismatched — fail loudly
                # rather than silently dropping characters from the prompt.
                if p not in self.encoder:
                    raise ValueError(
                        f"BPE piece {p!r} missing from vocab — "
                        "qwen_vocab.json / qwen_merges.txt mismatch")
                ids.append(self.encoder[p])
        return ids

    def encode_chat(self, segments: list[str | int]) -> list[int]:
        """Mixed text segments and literal special-token ids → ids."""
        ids: list[int] = []
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
            else:
                ids.extend(self.encode(seg))
        return ids

    def decode(self, ids) -> str:
        buf: list[str] = []
        for i in ids:
            tok = self.decoder.get(int(i))
            if tok is None or int(i) in self.added.values() \
                    or tok in self.added:
                continue
            buf.append(tok)
        joined = "".join(buf)
        return bytes(self.byte_dec.get(ch, ord("?")) for ch in joined).decode(
            "utf-8", errors="replace")


def got_prompt_ids(tok: Qwen2Tokenizer) -> tuple[list[int], list[int]]:
    """(prefix_ids, suffix_ids) around the 256 image tokens for the GOT
    plain-OCR chat prompt — byte-exact to HF GotOcr2Processor.__call__
    (message_start/system_query/img tokens/' OCR: '/assistant turn)."""
    system = ("system\nYou should follow the instructions carefully and "
              "explain your answers in detail.")
    prefix = tok.encode_chat(
        [IM_START, system, IM_END, IM_START, "user\n", IMG_START])
    suffix = tok.encode_chat(
        [IMG_END, "\n OCR: ", IM_END, IM_START, "assistant\n"])
    return prefix, suffix
