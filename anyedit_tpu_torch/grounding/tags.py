"""Caption tagging: nouns / adjectives / verbs from an instruction caption.

A copy of `anyedit_tpu/grounding/tags.py`, kept here because the JAX
package's `grounding/__init__` imports its JAX mask code.

Port of `generate_tags` (tool.py:67-89), which uses spaCy POS tagging.
spaCy is optional here (absent in the hermetic image); the fallback is a
compact rule-based tagger: closed-class stop words are excluded, suffix
heuristics classify the rest. Accuracy is sufficient for phrase-candidate
generation (the detector's phrase-span scoring does the real filtering).
"""

from __future__ import annotations

import re

try:  # pragma: no cover - exercised only where spaCy exists
    import spacy
    _NLP = spacy.load("en_core_web_sm")
except Exception:  # ModuleNotFoundError or missing model
    _NLP = None

_STOP = frozenset("""
a an the this that these those my your his her its our their of in on at by
for with about against between into through during before after above below
to from up down out off over under again further then once here there when
where why how all any both each few more most other some such no nor not only
own same so than too very s t can will just don should now and or but if
because as until while is are was were be been being have has had having do
does did doing would could ought im youre hes shes its were theyre ive youve
weve theyve isnt arent wasnt werent hasnt havent hadnt doesnt dont didnt me
him them who whom which it he she they we you i near beside behind beneath
around across along amid among onto upon within without toward towards past
""".split())

_ADJ_SUFFIX = ("ous", "ful", "ish", "ive", "less", "able", "ible", "al", "ic",
               "ian", "ary")
_COMMON_ADJ = frozenset("""
red blue green yellow black white brown gray grey orange purple pink golden
big small large little long short tall high low old new young wooden metal
plastic glass bright dark shiny dirty clean wet dry hot cold open closed
empty full round square flat sharp soft hard heavy light fast slow
""".split())
_VERB_SUFFIX = ("ing", "ed")
_COMMON_VERB = frozenset("""
sit sits stand stands walk walks run runs fly flies jump jumps eat eats
drink drinks hold holds ride rides play plays look looks watch watches wear
wears carry carries swim swims sleep sleeps lie lies lay lays drive drives
park parks graze grazes rest rests chase chases throw throws catch catches
pull pulls push pushes climb climbs
""".split())


def generate_tags(raw_text: str) -> dict[str, list[str]]:
    """→ {'nouns': [...], 'adj': [...], 'verb': [...]} like the reference."""
    if _NLP is not None:  # pragma: no cover
        tags = {"nouns": [], "adj": [], "verb": []}
        for tok in _NLP(raw_text):
            if tok.pos_ == "NOUN":
                tags["nouns"].append(tok.text)
            elif tok.pos_ == "ADJ":
                tags["adj"].append(tok.text)
            elif tok.pos_ == "VERB":
                tags["verb"].append(tok.text)
        return tags

    tags = {"nouns": [], "adj": [], "verb": []}
    words = re.findall(r"[a-zA-Z]+", raw_text.lower())
    for i, w in enumerate(words):
        if w in _STOP or len(w) < 2:
            continue
        if w in _COMMON_ADJ or (w.endswith(_ADJ_SUFFIX) and len(w) > 4):
            tags["adj"].append(w)
        elif w in _COMMON_VERB or (w.endswith(_VERB_SUFFIX) and len(w) > 4
                                   and i > 0):
            tags["verb"].append(w)
        else:
            tags["nouns"].append(w)
    return tags


def noun_phrases(caption: str) -> list[str]:
    """adjacent adj+noun pairs plus bare nouns — candidate grounding phrases."""
    t = generate_tags(caption)
    words = re.findall(r"[a-zA-Z]+", caption.lower())
    phrases = list(t["nouns"])
    for i in range(len(words) - 1):
        if words[i] in t["adj"] and words[i + 1] in t["nouns"]:
            phrases.append(f"{words[i]} {words[i + 1]}")
    return phrases
