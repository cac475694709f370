"""Pure-Python SentencePiece unigram tokenizer (no `sentencepiece` dep).

A copy of `anyedit_tpu/models/sentencepiece.py`, kept here because the JAX
package's `models/__init__` imports Flax.

The reference tokenizes T5 (Flux/SD3 text context, textual_change_tool.py /
attribute_tool.py:159 `_get_t5_prompt_embeds`) via HF T5TokenizerFast backed
by `spiece.model`. That file is a serialized `sentencepiece.ModelProto`;
this module parses the protobuf wire format directly and runs Viterbi
unigram segmentation — byte-compatible ids for the common case without the
native sentencepiece wheel (absent in this environment).

Scope: unigram models with standard T5 conventions — whitespace → "▁",
a leading "▁", byte-fallback pieces ("<0xNN>") when present, unk fallback
otherwise. BPE-mode .model files are not supported (T5/Flux/SD3 all ship
unigram models).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

_SPACE = "▁"  # ▁


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:              # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:            # 64-bit
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:            # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:            # 32-bit
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


@dataclasses.dataclass
class SentencePieceModel:
    pieces: list[str]
    scores: list[float]
    unk_id: int = 2                     # T5 convention: pad=0 eos=1 unk=2
    eos_id: int = 1

    @classmethod
    def from_file(cls, path: str | Path) -> "SentencePieceModel":
        import struct
        buf = Path(path).read_bytes()
        pieces, scores = [], []
        unk_id = None
        for field, wire, val in _iter_fields(buf):
            if field != 1 or wire != 2:    # repeated SentencePiece pieces=1
                continue
            piece, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            if ptype == 2 and unk_id is None:   # UNKNOWN
                unk_id = len(pieces)
            pieces.append(piece)
            scores.append(score)
        m = cls(pieces, scores)
        if unk_id is not None:
            m.unk_id = unk_id
        return m

    def __post_init__(self):
        self._index = {p: i for i, p in enumerate(self.pieces)}
        self._max_len = max((len(p) for p in self.pieces), default=1)
        self._byte_fallback = "<0x00>" in self._index

    def piece_to_id(self, piece: str) -> int:
        return self._index.get(piece, self.unk_id)

    def encode(self, text: str, add_eos: bool = True) -> list[int]:
        """Viterbi unigram segmentation of SentencePiece-normalized text.

        Normalization follows T5's `nmt_nfkc` + remove_extra_whitespaces:
        NFKC, then collapse any whitespace run (tabs/newlines included) to
        one space — otherwise ids diverge from HF T5TokenizerFast for
        prompts containing newlines, double spaces, or unicode punctuation.
        """
        import re
        import unicodedata
        text = unicodedata.normalize("NFKC", text)
        text = re.sub(r"\s+", " ", text)
        s = _SPACE + text.strip().replace(" ", _SPACE)
        n = len(s)
        # best[i] = (score, backpointer, piece_id) for prefix s[:i]
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores, default=0.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            matched = False
            for j in range(i + 1, min(n, i + self._max_len) + 1):
                pid = self._index.get(s[i:j])
                if pid is None:
                    continue
                matched = True
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, pid)
            # unknown character: byte fallback or single-char unk
            if not matched or best[i + 1] <= NEG / 2:
                sc = best[i] + unk_penalty
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, -1)
        ids: list[int] = []
        i = n
        while i > 0:
            prev, pid = back[i]
            if pid >= 0:
                ids.append(pid)
            else:
                ch = s[prev:i]
                if self._byte_fallback:
                    ids.extend(self._index[f"<0x{b:02X}>"]
                               for b in reversed(ch.encode("utf-8")))
                else:
                    ids.append(self.unk_id)
            i = prev
        ids.reverse()
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def encode_padded(self, text: str, max_len: int,
                      pad_id: int = 0) -> list[int]:
        ids = self.encode(text)[:max_len]
        return ids + [pad_id] * (max_len - len(ids))


def serialize_model(pieces: list[str], scores: list[float],
                    types: list[int] | None = None) -> bytes:
    """Build a minimal ModelProto (for tests / synthetic vocabularies)."""
    import struct

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    buf = b""
    types = types or [1] * len(pieces)
    for p, sc, tp in zip(pieces, scores, types):
        pb = p.encode("utf-8")
        msg = (varint((1 << 3) | 2) + varint(len(pb)) + pb +
               varint((2 << 3) | 5) + struct.pack("<f", sc) +
               varint((3 << 3) | 0) + varint(tp))
        buf += varint((1 << 3) | 2) + varint(len(msg)) + msg
    return buf
