"""The instruction-generation layer of the PyTorch port against the JAX
package's (`anyedit_tpu/grounding/tags.py`, `anyedit_tpu/instructions/*`):
the caption tagger, every prompt builder, `InstructionGenerator` over the
template backend (records written byte-equal by both schema writers), the
rule-based generators, canvas plans, captions, concept curation, the
implicit generator, and `LlamaBackend` in loop and batched modes over the
tiny Llama.

Everything here is host code or greedy ids: strings, records and written
bytes must be equal, no tolerance.
"""

import random

import numpy as np
import pytest
import torch

from anyedit_tpu.grounding import tags as jtags
from anyedit_tpu.instructions import captions as jcaptions
from anyedit_tpu.instructions import concepts as jconcepts
from anyedit_tpu.instructions import generator as jgen
from anyedit_tpu.instructions import implicit_gen as jimplicit
from anyedit_tpu.instructions import prompts as jprompts
from anyedit_tpu.core.schema import write_records as jax_write_records
from anyedit_tpu.models.llama import Llama as JaxLlama
from anyedit_tpu_torch.core.schema import write_records
from anyedit_tpu_torch.grounding import tags
from anyedit_tpu_torch.instructions import captions, concepts, generator, implicit_gen, prompts
from test_torch_llama import JAX_CFG, llama_params, port_llama

torch.set_num_threads(1)
CAPTIONS = [
    "a dog sitting on a wooden bench in a quiet park",
    "Two children are playing with a red ball near the lake",
    "an old clock hanging above the fireplace, covered in dust",
    "A cyclist rides past a tall giraffe at the train station",
    "a bowl of fresh fruit on the kitchen table beside a glass vase",
    "the shiny metal robot carries heavy boxes into the warehouse",
    "Paris at night with the Eiffel Tower glowing",
    "",
]
LLM_TYPES = sorted(jprompts.FEW_SHOT_BANK)


def _recs_json(recs):
    return [r.to_json() for r in recs]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_tags_match(caption):
    """generate_tags and noun_phrases (the rule-based branch: spaCy is absent
    on both sides) equal JAX's."""
    assert tags._NLP is None and jtags._NLP is None
    assert tags.generate_tags(caption) == jtags.generate_tags(caption)
    assert tags.noun_phrases(caption) == jtags.noun_phrases(caption)


def test_prompt_tables_equal():
    assert prompts.FEW_SHOT_BANK == jprompts.FEW_SHOT_BANK
    assert prompts._TYPE_DESCRIPTION == jprompts._TYPE_DESCRIPTION
    assert prompts.CANVAS_PLAN_EXAMPLES == jprompts.CANVAS_PLAN_EXAMPLES


@pytest.mark.parametrize("edit_type", LLM_TYPES)
def test_prompt_builders_match(edit_type):
    """system, few-shot (2 and 5 shots, two seeds), eval and canvas-plan
    prompts: string for string."""
    assert prompts.system_prompt(edit_type) == jprompts.system_prompt(edit_type)
    for seed in (0, 7):
        for n in (2, 5):
            got = prompts.few_shot_prompt(edit_type, CAPTIONS[seed % 3], random.Random(seed), n)
            assert got == jprompts.few_shot_prompt(edit_type, CAPTIONS[seed % 3],
                                                   random.Random(seed), n)
    assert prompts.eval_prompt(edit_type, CAPTIONS[0], "make it red", "a red dog") == \
        jprompts.eval_prompt(edit_type, CAPTIONS[0], "make it red", "a red dog")
    assert prompts.canvas_plan_prompt(CAPTIONS[1], random.Random(3)) == \
        jprompts.canvas_plan_prompt(CAPTIONS[1], random.Random(3))


@pytest.mark.parametrize("text", [
    "instruction: add a cat\nobject: cat\noutput: a cat on a bench",
    "instruction: make it night\nobject: none\noutput: a park at night",
    "output: only an output", "junk", "instruction:  x \noutput:  y "])
def test_parse_generation_matches(text):
    assert generator.parse_generation(text) == jgen.parse_generation(text)


@pytest.mark.parametrize("edit_type", LLM_TYPES + ["composition"])
@pytest.mark.parametrize("seed", [0, 5])
def test_generator_template_records_byte_equal(tmp_path, edit_type, seed):
    """InstructionGenerator over TemplateBackend (self-check on, 5 shots,
    batches of 3): the same records, and both packages' schema writers write
    the same bytes (JSON and JSONL)."""
    caps = [c for c in CAPTIONS if c][:5]
    got = generator.InstructionGenerator(generator.TemplateBackend(), seed=seed).generate(
        edit_type, caps, batch_size=3)
    ref = jgen.InstructionGenerator(jgen.TemplateBackend(), seed=seed).generate(
        edit_type, caps, batch_size=3)
    assert got and _recs_json(got) == _recs_json(ref)
    for suffix in (".json", ".jsonl"):
        write_records(tmp_path / f"port{suffix}", got)
        jax_write_records(tmp_path / f"jax{suffix}", ref)
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()


def test_generator_self_check_and_shots_match():
    """A backend that rejects every other self-check and answers some
    prompts unparseably, with 2 shots: the same records."""
    def make(tb_cls):
        tb = tb_cls()

        def llm(ps):
            outs = tb(ps)
            return [("no" if i % 2 else o) if o == "yes" else ("junk" if i % 3 == 2 else o)
                    for i, o in enumerate(outs)]
        return llm
    caps = [c for c in CAPTIONS if c]
    got = generator.InstructionGenerator(make(generator.TemplateBackend), seed=2,
                                         n_shots=2).generate("remove", caps, batch_size=4)
    ref = jgen.InstructionGenerator(make(jgen.TemplateBackend), seed=2,
                                    n_shots=2).generate("remove", caps, batch_size=4)
    assert 0 < len(got) < len(caps) and _recs_json(got) == _recs_json(ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_based_generators_match(seed):
    obj = "dog"
    for count in (2, 3, 6):
        assert generator.rule_based_counting(CAPTIONS[0], obj, count, random.Random(seed)) \
            .to_json() == jgen.rule_based_counting(CAPTIONS[0], obj, count,
                                                   random.Random(seed)).to_json()
    for kind in ("resize", "movement"):
        assert generator.rule_based_resize_movement(CAPTIONS[0], obj, kind,
                                                    random.Random(seed)).to_json() == \
            jgen.rule_based_resize_movement(CAPTIONS[0], obj, kind,
                                            random.Random(seed)).to_json()
    assert generator.rule_based_relation(CAPTIONS[1], "ball", "lake").to_json() == \
        jgen.rule_based_relation(CAPTIONS[1], "ball", "lake").to_json()
    assert generator.rule_based_visual_reference(CAPTIONS[0], obj, "cat", "ref.jpg") \
        .to_json() == jgen.rule_based_visual_reference(CAPTIONS[0], obj, "cat",
                                                       "ref.jpg").to_json()


def test_canvas_plans_match():
    """Plans from the template backend and, where an answer does not parse,
    the single-subject fallback: equal, through the port's parse_canvas_plan."""
    caps = [c for c in CAPTIONS if c]
    got = generator.generate_canvas_plans(caps, generator.TemplateBackend(), random.Random(4))
    assert got == jgen.generate_canvas_plans(caps, jgen.TemplateBackend(), random.Random(4))
    junk = lambda ps: ["global: only\n" if i % 2 else "nothing" for i in range(len(ps))]
    got = generator.generate_canvas_plans(caps, junk, random.Random(4))
    assert got == jgen.generate_canvas_plans(caps, junk, random.Random(4))
    assert generator.generate_canvas_plan(caps[0], junk, random.Random(1)) == \
        jgen.generate_canvas_plan(caps[0], junk, random.Random(1))


@pytest.mark.parametrize("mode", ["c2cap", "cb2cap", "cc2cap", "llm"])
def test_captions_match(mode):
    kw = {"c2cap": {}, "cb2cap": {"background": "a beach"},
          "cc2cap": {"concept2": "kite"}, "llm": {"background": "snow"}}[mode]
    llm = (lambda ps: [f"  caption for {ps[0][:20]} "]) if mode == "llm" else None
    for seed in (0, 3):
        assert captions.caption_from_concept("teapot", llm=llm, seed=seed, **kw) == \
            jcaptions.caption_from_concept("teapot", llm=llm, seed=seed, **kw)


def test_concepts_match(tmp_path):
    """Embedding and head-noun dedup, the LLM filter, the pool builder, noun
    filtering, pool structure and the local-corpus harvest."""
    pool = ["bird", "winter wren bird", "teapot", "tea pot", "Car", "red car", "dog", ""]
    rng = np.random.default_rng(0)
    table = {c: rng.standard_normal(8) for c in pool}
    table["tea pot"] = table["teapot"] + 0.01
    embed = lambda c: table[c]
    llm = lambda ps: ["yes" if "t" in p.split("concept: ")[1][:4] else "no" for p in ps]
    for fn, args in ((concepts.dedup_by_embedding, (pool[:-1], embed)),
                     (concepts.llm_concept_filter, (pool, llm)),
                     (concepts.dedup_by_head_noun, (pool,)),
                     (concepts.build_concept_pool, (pool, embed, llm)),
                     (concepts.filter_nouns, (CAPTIONS,)),
                     (concepts.init_concept_pool, (pool, {"dog": ["Beach", "beach", "park"]}))):
        assert fn(*args) == getattr(jconcepts, fn.__name__)(*args), fn.__name__
    a = {"dog": {"b": ["park"], "c": ""}}
    b = {"dog": {"b": ["beach"], "c": "a dog"}, "cat": {"b": [], "c": ""}}
    assert concepts.merge_concept_pools(a, b) == jconcepts.merge_concept_pools(a, b)
    (tmp_path / "c.txt").write_text("\n".join(CAPTIONS * 3))
    (tmp_path / "c.jsonl").write_text("\n".join(f'{{"caption": "{c}"}}' for c in CAPTIONS))
    files = [str(tmp_path / "c.txt"), str(tmp_path / "c.jsonl")]
    assert concepts.harvest_concepts(files, min_count=2) == \
        jconcepts.harvest_concepts(files, min_count=2)


def test_implicit_generator_matches():
    """The three-turn generator over a scripted LLM (one topic answers junk
    at turn 2) and the transcript parser: the same records."""
    def script(ps):
        p = ps[0]
        if p.startswith("Think of"):
            return [f"before: a scene of {p.split('about ')[1].split('.')[0]}"]
        if "Now state the event" in p:
            return ["junk" if "weather" in p else "event: the process happens"]
        return [f"after: {p.splitlines()[0][8:]} afterwards"]
    got = implicit_gen.ImplicitGenerator(script).generate(8)
    ref = jimplicit.ImplicitGenerator(script).generate(8)
    assert len(got) == 7 and _recs_json(got) == _recs_json(ref)
    dump = "before: ice\nevent: melts\nafter: water\nbefore: a\nevent: b\nafter: a\n"
    assert _recs_json(implicit_gen.parse_implicit_dump(dump)) == \
        _recs_json(jimplicit.parse_implicit_dump(dump))


# ---- LlamaBackend over the tiny Llama ------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    tree = llama_params(seed=60)
    return tree, port_llama(tree)


PROMPTS = ["short", "a much longer prompt " * 8, "mid size prompt here", "x",
           "another medium-length prompt for the second row"]


def _detok(ids):
    return " ".join(str(i) for i in ids)


def _tokenize(s):
    return [1 + (ord(c) % 250) for c in s]


@pytest.mark.parametrize("batch_size", [0, 2])
def test_llama_backend_matches(llama_pair, batch_size):
    """LlamaBackend in loop mode (batch_size 0) and batched mode (batches of
    2 across the 128- and 256-token buckets, a short last batch): output
    strings equal the JAX backend's; the two modes agree with each other."""
    tree, m = llama_pair
    jm = JaxLlama(JAX_CFG)
    got = generator.LlamaBackend(m, _tokenize, _detok, max_new=4, eos_id=7,
                                 batch_size=batch_size)(PROMPTS)
    ref = jgen.LlamaBackend(jm, tree, _tokenize, _detok, max_new=4, eos_id=7,
                            batch_size=batch_size)(PROMPTS)
    assert got == ref and all(got)
    if batch_size:
        assert got == generator.LlamaBackend(m, _tokenize, _detok, max_new=4, eos_id=7)(PROMPTS)
