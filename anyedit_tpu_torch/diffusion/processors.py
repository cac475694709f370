"""Attention processors for the caption-pair editors: MasaCtrl and
Prompt-to-Prompt (counterpart of `anyedit_tpu/diffusion/processors.py`).

The UNet's attention sites call a processor `(q, k, v, meta, extra)` with
q, k, v in (B, H, L, D) (`models/layers.py`), so each editor is a closure
passed per call:

  * `masactrl_processor` (MutualSelfAttentionControl): from step S and
    self-attention site L on, each target row attends to its source row's
    keys and values, so identity and layout stay while the action changes;
  * `AttentionStore`: keeps the head mean of each cross-attention
    probability map of one UNet call; `mask_from_ca` turns the maps
    accumulated for a keyword into a binary mask;
  * `p2p_replace_processor` (AttentionReplace): while step < stop_step, the
    target rows' cross-attention probabilities are the source rows' routed
    through a token alignment matrix (`alignment_matrix`).

The JAX package counts the sites while tracing and reads the step as a
traced scalar; here the UNet runs eagerly, the site counter `extra["_sa"]`
counts self-attention sites in call order (down, mid, up) within one UNet
call, and `extra["step"]` is the loop index. Every site takes the plain
`sdpa` (the counterpart of `sdpa_xla`), or, where a processor reads or
rewrites the probabilities, the same fp32 softmax written out (`_probs`);
none takes a hand kernel, as in the JAX package.
"""

from __future__ import annotations

import difflib
import math
from typing import Callable, Optional

import numpy as np
import torch

from anyedit_tpu_torch.models.layers import AttnMeta
from anyedit_tpu_torch.ops.attention import sdpa


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float | None = None,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 softmax(q k^T * scale + bias), (B, H, Lq, Lk)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    return torch.softmax(logits, dim=-1)


def _apply(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """The probabilities in v's dtype times v, in the query's dtype (as sdpa)."""
    return torch.matmul(p.to(v.dtype), v).to(dtype)


def _pair_rows(b: int, pair_of: Optional[np.ndarray]) -> torch.Tensor:
    """Row b reads row src[b]: [source, target] pairs by default, every odd
    row from the even row before it."""
    if pair_of is not None:
        return torch.as_tensor(np.asarray(pair_of), dtype=torch.long)
    src = np.arange(b)
    src[1::2] = src[0::2][: len(src[1::2])]
    return torch.from_numpy(src)


# ---- MasaCtrl ------------------------------------------------------------

def masactrl_processor(start_step: int, start_layer: int,
                       source_of: Optional[np.ndarray] = None) -> Callable:
    """Mutual self-attention control. `source_of[b]` is the row whose keys
    and values row b reads once active (default: the [source, target] pair
    layout). `extra` carries {"step": loop index}; `extra["_sa"]` numbers
    the self-attention sites of one UNet call (pass a fresh dict a call)."""

    def proc(q, k, v, meta: AttnMeta, extra):
        if not meta.is_self:
            return sdpa(q, k, v)
        idx = extra.setdefault("_sa", 0)
        extra["_sa"] = idx + 1
        if idx < start_layer or extra["step"] < start_step:
            return sdpa(q, k, v)
        src = _pair_rows(q.shape[0], source_of).to(q.device)
        return sdpa(q, k[src], v[src])

    return proc


# ---- Prompt-to-Prompt ----------------------------------------------------

class AttentionStore:
    """Keeps the cross-attention maps of one UNet call, head-averaged:

        store.reset()
        eps = unet(x, t, ctx, processor=store.processor())
        maps = store.collect()   # {site name: (B, L_img, L_txt)}, call order

    Only the (B, L, T) means are kept; each site's probabilities are freed
    when the site returns."""

    def __init__(self, watch_self: bool = False, max_hw: int = 32 * 32):
        self.watch_self = watch_self
        self.max_hw = max_hw
        self._maps: dict[str, torch.Tensor] = {}

    def reset(self):
        self._maps = {}

    def processor(self):
        def proc(q, k, v, meta: AttnMeta, extra):
            p = _probs(q, k)
            if (self.watch_self or not meta.is_self) and q.shape[2] <= self.max_hw:
                self._maps[meta.name] = p.mean(dim=1)
            return _apply(p, v, q.dtype)
        return proc

    def collect(self) -> dict[str, torch.Tensor]:
        return dict(self._maps)


def mask_from_ca(accumulated: torch.Tensor, token_idx: int, hw: int,
                 threshold: float = 0.3) -> torch.Tensor:
    """Boolean (B, hw, hw) mask from an accumulated cross-attention map
    (B, hw^2, T): the keyword's column, normalised to [0, 1], above
    `threshold`."""
    m = accumulated[:, :, token_idx]
    m = m - m.min(dim=-1, keepdim=True).values
    m = m / torch.clamp(m.max(dim=-1, keepdim=True).values, min=1e-8)
    return (m > threshold).reshape(-1, hw, hw)


def alignment_matrix(src_tokens: list, tgt_tokens: list) -> np.ndarray:
    """(T_tgt, T_src) mapper: each target position <- its aligned source
    position (longest-common-subsequence blocks); an unmatched target
    token keeps its own column where the source has one."""
    m = np.zeros((len(tgt_tokens), len(src_tokens)), np.float32)
    sm = difflib.SequenceMatcher(a=src_tokens, b=tgt_tokens, autojunk=False)
    mapped = set()
    for block in sm.get_matching_blocks():
        for off in range(block.size):
            m[block.b + off, block.a + off] = 1.0
            mapped.add(block.b + off)
    for i in range(len(tgt_tokens)):
        if i not in mapped and i < len(src_tokens):
            m[i, i] = 1.0
    return m


def p2p_replace_processor(mapper: np.ndarray, stop_step: int,
                          pair_of: Optional[np.ndarray] = None) -> Callable:
    """AttentionReplace: while `extra["step"] < stop_step`, each target
    (odd) row's cross-attention probabilities are its source row's, routed
    through `mapper` (T_tgt, T_src); self-attention is untouched."""
    mp = torch.from_numpy(np.asarray(mapper, np.float32))

    def proc(q, k, v, meta: AttnMeta, extra):
        if meta.is_self:
            return sdpa(q, k, v)
        p = _probs(q, k)
        if extra["step"] < stop_step:
            b = q.shape[0]
            p_mapped = torch.einsum("bhqs,ts->bhqt", p[_pair_rows(b, pair_of).to(p.device)],
                                    mp.to(p.device))
            is_target = torch.from_numpy(np.arange(b) % 2 == 1).to(p.device)
            p = torch.where(is_target[:, None, None, None], p_mapped, p)
        return _apply(p, v, q.dtype)

    return proc
