"""Concept-to-caption synthesis (reference concept/captions_generator.py,
modes c2cap / cb2cap / cc2cap, :19-60): turn scraped concept words (+
optional background or second concept) into natural captions via the LLM,
or via deterministic templates offline.

A copy of `anyedit_tpu/instructions/captions.py`, kept here because the JAX
package's `instructions/__init__` imports its generator, which reaches the
JAX Llama."""

from __future__ import annotations

import random
from typing import Optional

from anyedit_tpu_torch.instructions.generator import LLMFn

_TEMPLATES_C2CAP = (
    "a photo of a {c}",
    "a {c} in a natural setting",
    "a close-up of a {c}",
)
_TEMPLATES_CB2CAP = (
    "a {c} in front of {b}",
    "a {c} with {b} in the background",
)
_TEMPLATES_CC2CAP = (
    "a {c} next to a {c2}",
    "a {c} and a {c2} together in one scene",
)


def caption_from_concept(concept: str, background: Optional[str] = None,
                         concept2: Optional[str] = None,
                         llm: Optional[LLMFn] = None,
                         seed: int = 0) -> str:
    """Modes: c2cap (concept only), cb2cap (+background), cc2cap (2 concepts)."""
    if llm is not None:
        if concept2:
            q = (f"Write one short photo caption featuring both a {concept} "
                 f"and a {concept2}.")
        elif background:
            q = (f"Write one short photo caption of a {concept} with "
                 f"{background} as the background.")
        else:
            q = f"Write one short photo caption of a {concept}."
        return llm([q])[0].strip()
    rng = random.Random(f"{seed}:{concept}:{background}:{concept2}")
    if concept2:
        return rng.choice(_TEMPLATES_CC2CAP).format(c=concept, c2=concept2)
    if background:
        return rng.choice(_TEMPLATES_CB2CAP).format(c=concept, b=background)
    return rng.choice(_TEMPLATES_C2CAP).format(c=concept)
