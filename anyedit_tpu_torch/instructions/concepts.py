"""Concept-pool curation — the reference's concept pipeline
(diverse_Instruction_generation/concept/: fliter_concept.py CLIP-similarity
dedup, gpt_fliter_concept_pool.py LLM goodness filter,
select_class_name.py head-noun dedup). The web scraper itself is an
offline-excluded data source; everything downstream of a raw concept list
is here.

A copy of `anyedit_tpu/instructions/concepts.py`, kept here because the JAX
package's `instructions/__init__` imports its generator, which reaches the
JAX Llama.

Stages (compose via `build_concept_pool`):
  1. embedding dedup — CLIP-embed every concept, drop the later member of
     any pair above a cosine threshold (fliter_concept.py stages 1-3),
  2. LLM goodness filter — yes/no judgment that the concept is a common,
     visually depictable, non-proper noun (gpt_fliter_concept_pool.py),
  3. head-noun dedup — drop multi-word concepts whose head (last) word is
     itself in the pool (select_class_name.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

LLMFn = Callable[[list[str]], list[str]]

CONCEPT_FILTER_PROMPT = (
    "Decide whether the following concept is a good subject for image "
    "editing data. A good concept is a common noun (not a proper noun, "
    "brand, or species name), has a clear meaning, and names a tangible, "
    "visually depictable object. Answer only yes or no.\n"
    "concept: {concept}\nAnswer yes or no.")


def dedup_by_embedding(concepts: Sequence[str],
                       embed_fn: Callable[[str], np.ndarray],
                       threshold: float = 0.92) -> list[str]:
    """Keep the earlier concept of any pair whose CLIP text embeddings
    exceed `threshold` cosine similarity."""
    if not concepts:
        return []
    embs = np.stack([np.asarray(embed_fn(c)).reshape(-1) for c in concepts])
    embs = embs / np.maximum(np.linalg.norm(embs, axis=-1, keepdims=True),
                             1e-8)
    sim = embs @ embs.T
    keep: list[str] = []
    dropped = np.zeros(len(concepts), bool)
    for i, c in enumerate(concepts):
        if dropped[i]:
            continue
        keep.append(c)
        dropped |= sim[i] > threshold
        dropped[i] = True   # processed
    return keep


def llm_concept_filter(concepts: Sequence[str], llm: LLMFn,
                       batch_size: int = 16) -> list[str]:
    kept: list[str] = []
    for i in range(0, len(concepts), batch_size):
        batch = list(concepts[i:i + batch_size])
        answers = llm([CONCEPT_FILTER_PROMPT.format(concept=c)
                       for c in batch])
        kept.extend(c for c, a in zip(batch, answers)
                    if a.strip().lower().startswith("yes"))
    return kept


def dedup_by_head_noun(concepts: Sequence[str]) -> list[str]:
    """Drop 'winter wren bird' when 'bird' is itself in the pool
    (select_class_name.py semantics)."""
    pool = set(concepts)
    out = []
    for c in concepts:
        words = c.split(" ")
        if len(words) > 1 and words[-1] in pool:
            continue
        out.append(c)
    return out


def build_concept_pool(concepts: Sequence[str],
                       embed_fn: Optional[Callable] = None,
                       llm: Optional[LLMFn] = None,
                       sim_threshold: float = 0.92) -> list[str]:
    pool = list(dict.fromkeys(c.strip() for c in concepts if c.strip()))
    if embed_fn is not None:
        pool = dedup_by_embedding(pool, embed_fn, sim_threshold)
    if llm is not None:
        pool = llm_concept_filter(pool, llm)
    return dedup_by_head_noun(pool)


# ---- raw-text → concept candidates (fliter_noun.py semantics) -----------

_PLURAL_RULES = (("ies", "y"), ("ches", "ch"), ("shes", "sh"), ("sses", "ss"),
                 ("xes", "x"), ("zes", "z"), ("ves", "f"), ("s", ""))


def _lemmatize(word: str) -> str:
    """Rule-based singularization (the reference uses WordNetLemmatizer;
    spacy/nltk are not in this environment — these rules cover the regular
    English plural classes the concept pool actually contains)."""
    if len(word) <= 3 or not word.endswith("s") or word.endswith("ss"):
        return word
    for suf, rep in _PLURAL_RULES:
        if word.endswith(suf) and len(word) > len(suf) + 1:
            return word[:-len(suf)] + rep
    return word


def filter_nouns(texts: Sequence[str],
                 vocab: Optional[set[str]] = None) -> list[str]:
    """Extract lowercase, lemmatized, non-proper-noun concept candidates
    from raw caption text (concept/fliter_noun.py:30-48: spacy NOUN/PROPN
    minus PERSON entities, NLTK english-vocab check, WordNet lemma).

    Environment-adapted: the noun pass reuses `grounding.tags.generate_tags`
    (spaCy NOUN when installed, stop-word + suffix heuristics otherwise),
    proper nouns are dropped by the capitalized-mid-sentence heuristic, and
    the english check runs against the caller's `vocab` set (e.g. a
    wordlist file) when provided."""
    import re
    from anyedit_tpu_torch.grounding.tags import generate_tags
    # corpus pass: which tokens ever appear uncapitalized? A capitalized
    # token with no lowercase occurrence anywhere is treated as PROPN —
    # covers sentence-initial names the mid-sentence rule can't see.
    lowercase_seen: set[str] = set()
    tokenized = []
    for text in texts:
        toks = re.findall(r"[A-Za-z][A-Za-z-]*", text)
        tokenized.append(toks)
        lowercase_seen.update(t for t in toks if t[0].islower())
    out: list[str] = []
    seen: set[str] = set()
    for text, tokens in zip(texts, tokenized):
        nouns = {w.lower() for w in generate_tags(text)["nouns"]}
        for i, tok in enumerate(tokens):
            if tok[0].isupper() and (i > 0 or tok.lower()
                                     not in lowercase_seen):
                continue                      # capitalized ≈ PROPN
            if tok.lower() not in nouns:
                continue                      # stop words / verbs / adjs
            w = _lemmatize(tok.lower())
            if len(w) < 3 or w in seen:
                continue
            if vocab is not None and w not in vocab:
                continue
            seen.add(w)
            out.append(w)
    return out


# ---- concept pool structure (init_background.py / combine_json.py) ------

def init_concept_pool(concepts: Sequence[str],
                      backgrounds: Optional[dict] = None) -> dict:
    """{concept: {'b': [deduped lowercase backgrounds], 'c': ''}} — the
    pool record the instruction generators draw from
    (concept/init_background.py:15-43: backgrounds lowercased, set-deduped,
    only attached to concepts present in the pool)."""
    pool = {c: {"b": [], "c": ""} for c in dict.fromkeys(concepts)}
    for concept, bgs in (backgrounds or {}).items():
        if concept in pool:
            pool[concept]["b"] = sorted({b.lower() for b in bgs})
    return pool


def merge_concept_pools(*pools: dict) -> dict:
    """Union pool shards (concept/combine_json.py semantics): backgrounds
    set-union per concept; a non-empty caption 'c' wins over empty."""
    out: dict = {}
    for pool in pools:
        for concept, rec in pool.items():
            dst = out.setdefault(concept, {"b": [], "c": ""})
            dst["b"] = sorted(set(dst["b"]) | set(rec.get("b", ())))
            if not dst["c"] and rec.get("c"):
                dst["c"] = rec["c"]
    return out


# ---- offline acquisition (replaces concept/scraper/) ---------------------

def harvest_concepts(caption_files: Sequence[str],
                     min_count: int = 3,
                     max_concepts: int = 5000) -> list[str]:
    """Acquire a raw concept candidate list from LOCAL caption corpora —
    the offline acquisition layer in place of the reference's
    `concept/scraper/scraper.py` (which is a selenium page-visitor over a
    pre-existing concept_pool.json, not a data collector; this path is a
    strict functional superset: corpus → candidates → `build_concept_pool`
    curation). Accepts .txt (one caption per line), .json (list of
    strings or of dicts with a 'caption'/'text' field), or .jsonl.

    Candidates are lemmatized nouns ranked by corpus frequency;
    `min_count` drops hapax noise, `max_concepts` caps the pool.
    """
    import json as _json
    from collections import Counter
    from pathlib import Path

    def _captions(path: Path):
        text = path.read_text(errors="replace")
        if path.suffix == ".jsonl":
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                row = _json.loads(line)
                yield row if isinstance(row, str) else \
                    row.get("caption") or row.get("text") or \
                    row.get("input") or ""
        elif path.suffix == ".json":
            data = _json.loads(text)
            for row in data if isinstance(data, list) else data.values():
                yield row if isinstance(row, str) else \
                    row.get("caption") or row.get("text") or ""
        else:
            yield from text.splitlines()

    from anyedit_tpu_torch.grounding.tags import generate_tags
    counts: Counter = Counter()
    for f in caption_files:
        for cap in _captions(Path(f)):
            if not cap:
                continue
            for noun in generate_tags(cap)["nouns"]:
                w = _lemmatize(noun.lower())
                if len(w) >= 3:
                    counts[w] += 1
    ranked = [w for w, n in counts.most_common() if n >= min_count]
    return ranked[:max_concepts]
