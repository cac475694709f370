"""The one traffic generator: records and images made from `--seed` and a
traffic file's parameters (`traffic/<name>.json`). Every seed gets the same
sizes and the same amount of work, in another order and with other pixels.

Images are smooth: a two-colour gradient with a filled rectangle and an
ellipse at seeded places, so that they compress as photographs do and no
model input is white noise.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from portbench.reference.image import encode_png


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, sum(map(ord, tag))])


def image(r: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One (h, w, 3) uint8 image."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a, b = r.integers(0, 256, 3), r.integers(0, 256, 3)
    t = (yy / h * r.uniform(0.2, 1.0) + xx / w * r.uniform(0.2, 1.0))[..., None] / 2.0
    img = a * (1.0 - t) + b * t
    y0, x0 = int(r.integers(0, h // 2)), int(r.integers(0, w // 2))
    img[y0:y0 + int(r.integers(h // 8, h // 2)), x0:x0 + int(r.integers(w // 8, w // 2))] = \
        r.integers(0, 256, 3)
    cy, cx = r.uniform(0, h), r.uniform(0, w)
    ry, rx = r.uniform(h / 10, h / 4), r.uniform(w / 10, w / 4)
    img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] = r.integers(0, 256, 3)
    noise = r.normal(0.0, 3.0, (h, w, 3))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def write_pool(root: Path, seed: int, tag: str, sizes, n: int) -> list[Path]:
    """n images, cycling through `sizes` ([h, w] pairs), written as PNGs."""
    root.mkdir(parents=True, exist_ok=True)
    r = rng(seed, tag)
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        p = root / f"{tag}_{i:04d}.png"
        p.write_bytes(encode_png(image(r, h, w)))
        out.append(p)
    return out


def factory_records(params: dict, seed: int, image_root: Path) -> list[dict]:
    """The factory traffic: `n_records` records of `edit_type`, each with an
    image file of its own (a hard link into a pool of `n_images` seeded
    images at `image_sizes`), an instruction of the type's template with a
    seeded object and colour. Returns JSON-ready record dicts."""
    pool = write_pool(image_root / "pool", seed, "img", params["image_sizes"], params["n_images"])
    r = rng(seed, "records")
    objs, cols = params["objects"], params["colors"]
    out = []
    for j in range(params["n_records"]):
        obj, col = objs[int(r.integers(len(objs)))], cols[int(r.integers(len(cols)))]
        name = f"r{j:05d}.png"
        os.link(pool[j % len(pool)], image_root / name)
        out.append({"edit": params["edit_template"].format(object=obj, color=col),
                    "input": f"a photo of a {obj}", "output": f"a photo of a {col} {obj}",
                    "edit_type": params["edit_type"], "edited_object": obj,
                    "image_file": name})
    return out
