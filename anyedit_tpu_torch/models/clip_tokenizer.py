"""CLIP BPE tokenizer (the SD/CLIP text towers' real vocabulary).

A framework-free copy of `anyedit_tpu/models/clip_tokenizer.py`: that
package's `models/__init__` imports Flax, so the port carries its own.
Two implementations share one surface (`encode(text) -> list[int]`, ids
include SOT/EOT):

  * `ClipBPETokenizer(merges_path)` — the standard byte-pair-encoding over
    the OpenAI `bpe_simple_vocab_16e6.txt(.gz)` merges list (vocab 49408,
    sot 49406, eot 49407).
  * `SimpleClipTokenizer` — deterministic hash fallback for hermetic runs.
    Word ids land in [1, 49405] so EOT (49407) stays the argmax token —
    CLIPTextEncoder pools at argmax(ids) per the CLIP convention.
"""

from __future__ import annotations

import gzip
import re
from functools import lru_cache
from pathlib import Path

CLIP_VOCAB = 49408
SOT = 49406
EOT = 49407

_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+",
    re.IGNORECASE)


@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """Reversible byte ↔ printable-unicode map (GPT-2/CLIP convention)."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def find_clip_merges(weights_dir) -> Path | None:
    """The CLIP BPE merges asset in a weights dir (the openai vocab gz or a
    plain merges dump), or None."""
    weights_dir = Path(weights_dir)
    return next((p for p in (weights_dir / "bpe_simple_vocab_16e6.txt.gz",
                             weights_dir / "clip_merges.txt.gz",
                             weights_dir / "clip_merges.txt")
                 if p.exists()), None)


class ClipBPETokenizer:
    def __init__(self, merges_path: str | Path):
        p = Path(merges_path)
        raw = gzip.open(p, "rt", encoding="utf-8").read() \
            if p.suffix == ".gz" else p.read_text(encoding="utf-8")
        lines = raw.split("\n")
        # standard file: header line, then 48894 merges used by CLIP
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]
                  if len(m.split()) == 2]
        self.byte_enc = _bytes_to_unicode()
        vocab = list(self.byte_enc.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {w: i for i, w in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.strip().lower())
        ids = [self.encoder["<|startoftext|>"]]
        for tok in _WORD_RE.findall(text):
            tok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(tok).split(" ")
                       if p in self.encoder)
        ids.append(self.encoder["<|endoftext|>"])
        return ids


class SimpleClipTokenizer:
    """Hash-bucket fallback with CLIP's id layout (hermetic runs only)."""

    def __init__(self, vocab_size: int = CLIP_VOCAB):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        ids = [SOT % self.vocab_size]
        for w in re.findall(r"[a-z0-9]+", text.lower()):
            h = 0
            for ch in w:
                h = (h * 131 + ord(ch)) % (self.vocab_size - 3)
            ids.append(1 + h)
        ids.append(EOT % self.vocab_size)
        return ids
