"""Implicit (EditWorld-style) instruction generation — multi-turn.

A copy of `anyedit_tpu/instructions/implicit_gen.py`, kept here because the
JAX package's `instructions/__init__` imports its generator, which reaches
the JAX Llama.

Port of the reference's `implicit/instruction_gen.py:12-60+` chat loop and
`deal_text2json.py` post-processor: a world-knowledge LLM conversation
produces (before caption, event instruction, after caption) triples where
the edit is a real-world PROCESS (candle blown out, ice melting), not a
direct visual command. Backend-agnostic like the rest of the L2 layer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.instructions.generator import LLMFn

_SEED_TOPICS = (
    "melting and freezing", "burning and extinguishing", "growth and decay",
    "weather changing", "filling and emptying", "breaking and repairing",
    "day turning to night", "aging of objects",
)

_TURN1 = (
    "Think of a real-world process about {topic}. Describe a scene BEFORE "
    "the process happens, in one short image caption.\n"
    "Answer as:\nbefore: <caption>"
)
_TURN2 = (
    "{before}\nNow state the event that happens, phrased as an instruction "
    "for an image editor that understands the world (do not mention colors "
    "or pixels, describe the event).\nAnswer as:\nevent: <instruction>"
)
_TURN3 = (
    "before: {before}\nevent: {event}\nDescribe the scene AFTER this event, "
    "in one short image caption.\nAnswer as:\nafter: <caption>"
)


def _extract(tag: str, text: str) -> str | None:
    m = re.search(rf"{tag}:\s*(.+)", text)
    return m.group(1).strip() if m else None


@dataclasses.dataclass
class ImplicitGenerator:
    """Three-turn conversation per sample; each turn re-feeds the previous
    answers (the reference's process_text_multi_turn loop)."""

    llm: LLMFn

    def generate(self, n: int, topics: Sequence[str] = _SEED_TOPICS
                 ) -> list[InstructionRecord]:
        records = []
        for i in range(n):
            topic = topics[i % len(topics)]
            before_raw = self.llm([_TURN1.format(topic=topic)])[0]
            before = _extract("before", before_raw)
            if not before:
                continue
            event_raw = self.llm([_TURN2.format(before=before)])[0]
            event = _extract("event", event_raw)
            if not event:
                continue
            after_raw = self.llm([_TURN3.format(before=before, event=event)])[0]
            after = _extract("after", after_raw)
            if not after or after == before:
                continue
            records.append(InstructionRecord(
                edit=event, input=before, output=after,
                edit_type="implicit_change"))
        return records


def parse_implicit_dump(text: str) -> list[InstructionRecord]:
    """`deal_text2json` equivalent: recover records from a raw multi-turn
    transcript dump (before/event/after triples in order)."""
    befores = re.findall(r"before:\s*(.+)", text)
    events = re.findall(r"event:\s*(.+)", text)
    afters = re.findall(r"after:\s*(.+)", text)
    out = []
    for b, e, a in zip(befores, events, afters):
        b, e, a = b.strip(), e.strip(), a.strip()
        if b and e and a and a != b:
            out.append(InstructionRecord(edit=e, input=b, output=a,
                                         edit_type="implicit_change"))
    return out
