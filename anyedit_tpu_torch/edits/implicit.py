"""implicit_change and style_change (counterpart of
`anyedit_tpu/edits/implicit.py`).

implicit_change is the EditWorld chain (implicit_tool.py:76-235): best of
`n_candidates` caption pairs, each
  1. generated by Prompt-to-Prompt with an AttentionStore
     (`tb.extra["p2p_pair"]`), whose keyword mask localizes the change,
  2. regenerated inside the mask by `tb.extra["sdxl_inpaint"]`,
  3. refined by `tb.extra["sdxl_img2img"]`,
  4. passed through `tb.extra["canny_consistency"]`,
and scored by CLIP(target caption) plus 0.5 SSIM(ori, tar). Both stage-2
inpaints start from the stage-1 `ori` (seeds `seed` and `seed + 1`); stage
3 refines the target at strength 0.5 and stage 4 takes the new `ori` as its
IP-Adapter image and the keyword mask. Stages 2-4 are the zoo's
`install(tb, "sdxl_inpaint" | "sdxl_img2img" | "canny_consistency")`,
read from `tb.extra` as in the JAX package and skipped where absent.

style_change is one unmasked IP2P edit of the whole frame (the reference
defers this type to an external app).
"""

from __future__ import annotations

import numpy as np
import torch

from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.edits.types import EditOutcome, Toolbox, to_numpy
from anyedit_tpu_torch.filters.scorers import ssim

STEPS, S_TXT, S_IMG = 50, 7.5, 1.2


def implicit_change(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                    rng: np.random.Generator, n_candidates: int = 3) -> EditOutcome:
    """Needs `tb.extra["p2p_pair"](ori_caption, tar_caption, keyword, seed)
    -> (ori_img, tar_img, keyword_mask)`; takes `sdxl_inpaint(image, mask01,
    prompt, seed)`, `sdxl_img2img(image, prompt, strength, seed)` and
    `canny_consistency(image, prompt, seed, ref_image=, mask01=)` from
    `tb.extra` where present; `image` is unused."""
    p2p_pair = tb.extra.get("p2p_pair")
    inpaint = tb.extra.get("sdxl_inpaint")
    img2img = tb.extra.get("sdxl_img2img")
    consistency = tb.extra.get("canny_consistency")
    if p2p_pair is None:
        return EditOutcome(False, reason="p2p stack unavailable")
    keyword = rec.edited_object or (rec.output.split() or ["scene"])[0]

    best = None
    best_score = -np.inf
    for cand in range(n_candidates):
        seed = int(rng.integers(0, 2 ** 31)) + cand
        ori, tar, mask = p2p_pair(rec.input, rec.output, keyword, seed)
        if inpaint is not None and mask is not None:
            # both sides regenerated from the stage-1 ori image inside the mask
            ori_s1 = ori
            ori = np.asarray(inpaint(ori_s1, mask, rec.input, seed))
            tar = np.asarray(inpaint(ori_s1, mask, rec.output, seed + 1))
        if img2img is not None:
            tar = np.asarray(img2img(tar, rec.output, 0.5, seed))
        if consistency is not None:
            tar = np.asarray(consistency(tar, rec.output, seed, ref_image=ori, mask01=mask))
        score = 0.0
        if tb.clip_image is not None and tb.clip_text is not None:
            ie = to_numpy(tb.clip_image(tar))
            te = to_numpy(tb.clip_text(rec.output))
            score += float((ie * te).sum(-1).squeeze())
        score += 0.5 * float(ssim(torch.as_tensor(np.asarray(ori), dtype=torch.float32) / 255.0,
                                  torch.as_tensor(np.asarray(tar), dtype=torch.float32) / 255.0))
        if score > best_score:
            best_score = score
            best = (ori, tar, mask)
    if best is None:
        return EditOutcome(False, reason="no candidate generated")
    ori, tar, mask = best
    return EditOutcome(True, edited=np.asarray(tar), input_image=np.asarray(ori),
                       mask=None if mask is None else np.asarray(mask),
                       scores={"best": float(best_score)})


def style_change(tb: Toolbox, rec: InstructionRecord, image: np.ndarray,
                 rng: np.random.Generator) -> EditOutcome:
    """One unmasked IP2P edit of the whole frame."""
    edited = np.asarray(tb.ip2p(image, rec.edit, None, steps=STEPS, s_txt=S_TXT, s_img=S_IMG))
    return EditOutcome(True, edited=edited)
