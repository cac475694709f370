"""Host-side text plumbing for the grounding stage.

A copy of `anyedit_tpu/grounding/text.py`, kept here because the JAX
package's `grounding/__init__` imports its JAX mask code.

The reference tokenizes captions with the HF BERT tokenizer and recovers
phrases from predicted token posmaps (`get_phrases_from_posmap`,
get_grounding_output tool.py:116-147). This module keeps that surface
tokenizer-agnostic:

  * `Tokenizer` protocol: encode(text) → (ids, offsets). Real WordPiece
    vocab files plug in via `WordPieceTokenizer` when weights are present;
    `SimpleVocabTokenizer` is the deterministic offline fallback.
  * `phrase_token_spans`: maps each candidate phrase to its token span in
    the caption, so box→phrase assignment is a span-max over logits.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path


@dataclasses.dataclass
class Encoded:
    ids: list[int]
    tokens: list[str]        # per-id surface form (sub-words keep ## prefix)
    word_index: list[int]    # per-id index of the source word (-1 = special)


class SimpleVocabTokenizer:
    """Deterministic hash-bucket word tokenizer (offline fallback).

    Not a linguistic tokenizer — it exists so the whole grounding stack runs
    hermetically (tests, benchmarks, dry runs). Same word → same id.
    """

    def __init__(self, vocab_size: int = 30522, cls_id: int = 101,
                 sep_id: int = 102, reserved: int = 999):
        self.vocab_size = vocab_size
        self.cls_id = cls_id
        self.sep_id = sep_id
        self.reserved = reserved

    def _word_id(self, w: str) -> int:
        h = 0
        for ch in w:
            h = (h * 131 + ord(ch)) % (self.vocab_size - self.reserved)
        return h + self.reserved

    def encode(self, text: str) -> Encoded:
        words = re.findall(r"[a-z0-9]+", text.lower())
        ids = [self.cls_id]
        tokens = ["[CLS]"]
        widx = [-1]
        for i, w in enumerate(words):
            ids.append(self._word_id(w))
            tokens.append(w)
            widx.append(i)
        ids.append(self.sep_id)
        tokens.append("[SEP]")
        widx.append(-1)
        return Encoded(ids, tokens, widx)


class WordPieceTokenizer:
    """Real BERT WordPiece when a vocab.txt is available on disk."""

    def __init__(self, vocab_path: str | Path):
        self.vocab = {w: i for i, w in
                      enumerate(Path(vocab_path).read_text().splitlines())}
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)
        self.unk_id = self.vocab.get("[UNK]", 100)

    def _wordpiece(self, word: str) -> list[str]:
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str) -> Encoded:
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        ids, tokens, widx = [self.cls_id], ["[CLS]"], [-1]
        for i, w in enumerate(words):
            for p in self._wordpiece(w):
                ids.append(self.vocab.get(p, self.unk_id))
                tokens.append(p)
                widx.append(i)
        ids.append(self.sep_id)
        tokens.append("[SEP]")
        widx.append(-1)
        return Encoded(ids, tokens, widx)


def phrase_token_spans(enc: Encoded, caption: str,
                       phrases: list[str]) -> list[tuple[int, int]]:
    """Token [start, end) span of each phrase inside the tokenized caption.

    Multi-word phrases map to the covering span of their words; phrases not
    found map to (0, 0).
    """
    words = re.findall(r"[a-z0-9]+", caption.lower())
    spans = []
    for phrase in phrases:
        pw = re.findall(r"[a-z0-9]+", phrase.lower())
        found = (0, 0)
        for i in range(len(words) - len(pw) + 1):
            if words[i:i + len(pw)] == pw:
                tok_pos = [j for j, wi in enumerate(enc.word_index)
                           if i <= wi < i + len(pw)]
                if tok_pos:
                    found = (min(tok_pos), max(tok_pos) + 1)
                break
        spans.append(found)
    return spans
