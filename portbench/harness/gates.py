"""Traffic shaping of the factory cells, frozen from the program's
`chip_smoke.py` at commit c19ba6c (`gates_open`, `ground_as_real_weights`).

With random weights the semantic scores fail every filter threshold, so both
filter decisions are forced open while the scorers still run. The grounder
runs in full; on a source image its answer is the record's own box and mask
(the image's second quarter, as the frozen helper falls back to), so that
the mask the composite uses is the benchmark's input; on any other image
(an edited image re-grounded by a post-filter check) it answers None, as
real weights would find the object gone. Unlike the helper, the answer on a
source image is the benchmark's box even where the random detector keeps
one of its own: the reference composites through the same mask."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def gates_open(executor_module):
    """Both filter decisions of `executor_module` forced to True."""
    saved = executor_module.pre_filter_decision, executor_module.post_filter_decision
    executor_module.pre_filter_decision = executor_module.post_filter_decision = \
        lambda *a, **k: True
    try:
        yield
    finally:
        executor_module.pre_filter_decision, executor_module.post_filter_decision = saved


def quarter_box(h: int, w: int):
    """(y0, y1, x0, x1) of the record's object: the image's second quarter."""
    return h // 4, h // 2, w // 4, w // 2


class SourceImages:
    """The images the loader handed out, by identity (kept alive so that an
    id is never reused while it counts as a source)."""

    def __init__(self):
        self.by_id: dict[int, object] = {}

    def loader(self, load_image):
        def load(rec):
            img = load_image(rec)
            self.by_id[id(img)] = img
            return img
        return load

    def clear(self):
        self.by_id.clear()


def ground_answers(ground, sources: SourceImages, grounding_result, max_boxes: int, device):
    """`ground` (with its `.batch`) answering with the record's box on a
    source image and None elsewhere, after running in full."""
    def box_answer(h, w):
        y0, y1, x0, x1 = quarter_box(h, w)
        m = torch.full((max_boxes, h, w), -1.0, device=device)
        m[0, y0:y1, x0:x1] = 1.0
        boxes = torch.zeros((max_boxes, 4), device=device)
        boxes[0] = torch.tensor([x0, y0, x1, y1], dtype=torch.float32)
        scores = torch.zeros((max_boxes,), device=device)
        scores[0] = 0.9
        valid = torch.zeros((max_boxes,), dtype=torch.bool, device=device)
        valid[0] = True
        return grounding_result(m, boxes, scores, valid, (h, w), "merge", None)

    def answer(image):
        return box_answer(*image.shape[:2]) if id(image) in sources.by_id else None

    def g(image, phrase, mode="merge", count_k=None):
        ground(image, phrase, mode=mode, count_k=count_k)
        return answer(image)

    def g_batch(images, phrases, modes=None, count_ks=None):
        ground.batch(images, phrases, modes=modes, count_ks=count_ks)
        return [answer(im) for im in images]
    g.batch = g_batch
    return g
