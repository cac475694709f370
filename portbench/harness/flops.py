"""Model FLOPs of the timed work, counted at the configuration's published
shapes from the reference modules run on the meta device under
`torch.utils.flop_counter.FlopCounterMode` (matrix products and
convolutions, 2 FLOPs a multiply-add; elementwise work is not counted).
No weights and no device are involved, and nothing of the program: the
count depends only on the configuration and the shapes."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.cache
def _cached(key: str) -> int:
    kind, cfg, args = json.loads(key)
    return _COUNTERS[kind](cfg, *args)


def _meta(kind, cfg):
    return nets.frozen(nets.build(kind, cfg, torch.float32, "meta"))


def _unet_rows(cfg, rows, h, w, ctx_len):
    u = _meta("unet", cfg)
    x = torch.empty(rows, h, w, cfg["in_channels"], device="meta")
    t = torch.zeros(rows, dtype=torch.long, device="meta")
    ctx = torch.empty(rows, ctx_len, cfg["context_dim"], device="meta")
    return _count(lambda: u(x, t, ctx))


def _vae(cfg, rows, size, part):
    v = _meta("vae", cfg)
    down = 2 ** (len(cfg["block_channels"]) - 1)
    if part == "encode":
        x = torch.empty(rows, size, size, cfg["in_channels"], device="meta")
        return _count(lambda: v.encode(x))
    z = torch.empty(rows, size // down, size // down, cfg["latent_channels"], device="meta")
    return _count(lambda: v.decode(z))


def _text(cfg, rows):
    m = _meta("clip_text", cfg)
    ids = torch.zeros(rows, cfg["max_len"], dtype=torch.long, device="meta")
    return _count(lambda: m(ids))


_COUNTERS = {"unet": _unet_rows, "vae": _vae, "clip_text": _text}


def count(kind: str, cfg: dict, *args) -> int:
    return _cached(json.dumps([kind, cfg, list(args)], sort_keys=True))


def ip2p_edit_flops(cfg: dict, records: int, steps: int) -> int:
    """One batched IP2P edit of `records` images: 3 UNet rows a record a
    step at the canvas's latent size, one VAE encode and decode a record,
    the CLIP text tower on each instruction and on the empty prompt."""
    size = cfg["canvas"]["edit_size"]
    lat = size // cfg["canvas"]["latent_down"]
    return (steps * count("unet", cfg["unet"], 3 * records, lat, lat, cfg["clip_text"]["max_len"])
            + count("vae", cfg["vae"], records, size, "encode")
            + count("vae", cfg["vae"], records, size, "decode")
            + count("clip_text", cfg["clip_text"], records + 1))
