"""Instruction generation harness + rule-based generators (counterpart of
`anyedit_tpu/instructions/generator.py`: everything but `LlamaBackend` is a
copy; `LlamaBackend` drives the port's Llama).

Mirror of the reference L2 layer (edit_instruction/instruction_gen.py:76-174
batch loop with self-check; other_instruction_gen.py rule generators),
backend-agnostic: any `llm(prompts: list[str]) -> list[str]` plugs in —
the port's Llama (`LlamaBackend`), or the deterministic
`TemplateBackend` used for hermetic tests and dry runs.
"""

from __future__ import annotations

import dataclasses
import random
import re
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.grounding.tags import generate_tags
from anyedit_tpu_torch.instructions.prompts import eval_prompt, few_shot_prompt
from anyedit_tpu_torch.models.llama import greedy_generate, greedy_generate_padded

LLMFn = Callable[[list[str]], list[str]]

NUMBER_WORDS = {2: "two", 3: "three", 4: "four", 5: "five", 6: "six"}


class TemplateBackend:
    """Deterministic offline stand-in LLM: answers the few-shot format by
    template substitution; answers eval prompts with 'yes'."""

    def __call__(self, prompts: list[str]) -> list[str]:
        outs = []
        for p in prompts:
            if p.rstrip().endswith("Answer yes or no."):
                outs.append("yes")
                continue
            m = re.findall(r"caption: (.+)", p)
            caption = m[-1] if m else "a scene"
            tags = generate_tags(caption)
            obj = tags["nouns"][0] if tags["nouns"] else "object"
            if p.lstrip().startswith("Lay out a canvas"):
                outs.append(f"global: {caption}\n"
                            f"region: 0.1,0.2,0.6,0.9 | a {obj}\n"
                            f"region: 0.6,0.0,1.0,0.5 | background detail")
                continue
            outs.append(f"instruction: remove the {obj}\nobject: {obj}\n"
                        f"output: {caption.replace(obj, '').strip()}")
        return outs


def parse_generation(text: str) -> dict[str, str] | None:
    m = re.search(r"instruction:\s*(.+)", text)
    o = re.search(r"object:\s*(.+)", text)
    out = re.search(r"output:\s*(.+)", text)
    if not (m and out):
        return None
    obj = o.group(1).strip() if o else "none"
    return {"edit": m.group(1).strip(),
            "edited_object": None if obj.lower() == "none" else obj,
            "output": out.group(1).strip()}


@dataclasses.dataclass
class InstructionGenerator:
    llm: LLMFn
    seed: int = 0
    self_check: bool = True
    # few-shot budget lever: the reference shuffles 5 shots into every
    # prompt (prompt_generation_tool.py:195-265 get_content_instruction);
    # 2 shots land in a ~256-token bucket instead of ~1024 under a real
    # BPE — a 3-4× prefill-FLOP cut per caption when quality allows
    n_shots: int = 5

    def generate(self, edit_type: str, captions: Sequence[str],
                 batch_size: int = 16) -> list[InstructionRecord]:
        rng = random.Random(self.seed)
        if edit_type == "composition":
            recs: list[InstructionRecord] = []
            for i in range(0, len(captions), batch_size):
                batch = captions[i:i + batch_size]
                plans = generate_canvas_plans(batch, self.llm, rng)
                recs.extend(InstructionRecord(
                    edit=f"compose: {c}", input=c, output=c,
                    edit_type="composition", extras={"canvas_plan": p})
                    for c, p in zip(batch, plans))
            return recs
        records: list[InstructionRecord] = []
        for i in range(0, len(captions), batch_size):
            batch = captions[i:i + batch_size]
            prompts = [few_shot_prompt(edit_type, c, rng,
                                       n_shots=self.n_shots) for c in batch]
            raw = self.llm(prompts)
            parsed = [(c, parse_generation(r)) for c, r in zip(batch, raw)]
            parsed = [(c, p) for c, p in parsed if p is not None]
            if self.self_check and parsed:
                checks = self.llm([eval_prompt(edit_type, c, p["edit"],
                                               p["output"])
                                   for c, p in parsed])
                parsed = [cp for cp, ans in zip(parsed, checks)
                          if ans.strip().lower().startswith("yes")]
            for caption, p in parsed:
                records.append(InstructionRecord(
                    edit=p["edit"], input=caption, output=p["output"],
                    edit_type=edit_type, edited_object=p["edited_object"]))
        return records

def generate_canvas_plans(captions: Sequence[str], llm: LLMFn,
                          rng: random.Random) -> list[str]:
    """Captions → Omost-style canvas plan texts in the
    `diffusion/regional.py::parse_canvas_plan` line format
    (composition_image_generation.py:40-62 — the reference drives
    Omost-llama-3-8b; here the harness LLM answers few-shot prompts, one
    batched call per caption chunk, and an invalid answer falls back to a
    deterministic single-subject plan)."""
    from anyedit_tpu_torch.diffusion.regional import parse_canvas_plan
    from anyedit_tpu_torch.instructions.prompts import canvas_plan_prompt

    raws = llm([canvas_plan_prompt(c, rng) for c in captions])
    plans: list[str] = []
    for caption, raw in zip(captions, raws):
        g, regions = parse_canvas_plan(raw)
        if g and regions:
            plans.append(raw)
            continue
        tags = generate_tags(caption)
        obj = tags["nouns"][0] if tags["nouns"] else "subject"
        plans.append(f"global: {caption}\n"
                     f"region: 0.2,0.2,0.8,0.9 | a {obj}")
    return plans


def generate_canvas_plan(caption: str, llm: LLMFn,
                         rng: random.Random) -> str:
    """Single-caption convenience wrapper over `generate_canvas_plans`."""
    return generate_canvas_plans([caption], llm, rng)[0]


# ---- rule-based generators (other_instruction_gen.py:55-312) -------------

def rule_based_counting(caption: str, obj: str, count: int,
                        rng: random.Random) -> InstructionRecord:
    remove_n = rng.randint(1, max(1, count - 1))
    left = count - remove_n
    word = NUMBER_WORDS.get(remove_n, str(remove_n))
    left_word = NUMBER_WORDS.get(left, str(left)) if left > 1 else "one"
    return InstructionRecord(
        edit=f"remove {word} of the {obj}s", input=caption,
        output=f"{left_word} {obj}{'s' if left > 1 else ''}",
        edit_type="counting", edited_object=obj,
        remove_number=remove_n)


def rule_based_resize_movement(caption: str, obj: str, kind: str,
                               rng: random.Random) -> InstructionRecord:
    assert kind in ("resize", "movement")
    if kind == "resize":
        word = rng.choice(["bigger", "smaller"])
        edit = f"make the {obj} {word}"
    else:
        word = rng.choice(["left", "right"])
        edit = f"move the {obj} to the {word}"
    return InstructionRecord(edit=edit, input=caption, output=caption,
                             edit_type=kind, edited_object=obj)


def rule_based_relation(caption: str, obj_a: str, obj_b: str) -> InstructionRecord:
    return InstructionRecord(
        edit=f"swap the positions of the {obj_a} and the {obj_b}",
        input=caption, output=caption, edit_type="relation",
        edited_object=obj_a, new_object=obj_b)


def rule_based_visual_reference(caption: str, obj: str, ref_object: str,
                                visual_path: str) -> InstructionRecord:
    return InstructionRecord(
        edit=f"replace the {obj} with the object in the reference image",
        input=caption, output=caption.replace(obj, ref_object),
        edit_type="visual_reference", edited_object=obj,
        ref_object=ref_object, visual_input=visual_path)


class LlamaBackend:
    """LLMFn over the port's Llama decoder (the reference's
    Llama-3-8B-Instruct, concept/utils.py:176-184). Greedy decode; prompts
    are templated by the caller (prompts.py). Real language needs a real
    tokenizer and weights; the tiny config exercises the plumbing."""

    def __init__(self, model, tokenize, detokenize, max_new: int = 96,
                 eos_id: int | None = None, batch_size: int = 0, pad_id: int = 0):
        """model: a `models.llama.CausalLM` on its device; tokenize(str) ->
        list[int]; detokenize(list[int]) -> str. batch_size > 0 enables the
        bucketed batched decode: prompts grouped by 128-token length bucket
        (at least 128), each group left-padded (left-truncated to the
        bucket) into batches of exactly `batch_size` rows, the surplus rows
        repeating the group's first prompt and dropped after."""
        self.model = model
        self.tokenize = tokenize
        self.detokenize = detokenize
        self.max_new = max_new
        self.eos_id = eos_id
        self.batch_size = batch_size
        self.pad_id = pad_id

    def _ids(self, ids) -> torch.Tensor:
        dev = next(self.model.parameters()).device
        return torch.as_tensor(ids, dtype=torch.int64, device=dev)

    @torch.inference_mode()
    def __call__(self, prompts: list[str]) -> list[str]:
        if self.batch_size > 0:
            return self._call_batched(prompts)
        outs = []
        for prompt in prompts:   # ragged lengths: one prompt at a time
            emb = self.model.embed(self._ids([self.tokenize(prompt)]))
            toks = greedy_generate(self.model, emb, max_new=self.max_new,
                                   eos_id=self.eos_id)
            outs.append(self.detokenize([int(t) for t in toks[0]]))
        return outs

    def _call_batched(self, prompts: list[str]) -> list[str]:
        tok = [self.tokenize(p) for p in prompts]
        bucket = lambda n: max(128, -(-n // 128) * 128)
        by_bucket: dict[int, list[int]] = {}
        for i, ids in enumerate(tok):
            by_bucket.setdefault(bucket(len(ids)), []).append(i)

        outs: list[str] = [""] * len(prompts)
        bs = self.batch_size
        for blen, idxs in sorted(by_bucket.items()):
            for c0 in range(0, len(idxs), bs):
                chunk = idxs[c0:c0 + bs]
                rows = chunk + [chunk[0]] * (bs - len(chunk))
                ids = np.full((bs, blen), self.pad_id, np.int64)
                lens = np.zeros((bs,), np.int32)
                for r, i in enumerate(rows):
                    t = tok[i][-blen:]           # left-truncate to bucket
                    ids[r, blen - len(t):] = t
                    lens[r] = len(t)
                emb = self.model.embed(self._ids(ids))
                gen = greedy_generate_padded(self.model, emb, lens,
                                             max_new=self.max_new, eos_id=self.eos_id)
                for r, i in enumerate(chunk):
                    outs[i] = self.detokenize([int(t) for t in gen[r]])
        return outs
