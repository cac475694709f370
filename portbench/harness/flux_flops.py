"""Model FLOPs of the textual_change pair, counted as `flops.py` counts the
editor's (the reference modules on the meta device under
`FlopCounterMode`: matrix products and convolutions at 2 FLOPs a
multiply-add): the Flux transformer and the T5 encoder here, the VAE
decoder and the CLIP text tower through `flops.count`."""

from __future__ import annotations

import functools
import json

import torch

from portbench.harness import flops
from portbench.reference import flux as rflux
from portbench.reference import nets


def _meta(kind, cfg):
    return nets.frozen(rflux.build(kind, cfg, torch.float32, "meta"))


@functools.cache
def _flux_call(key: str) -> int:
    cfg, lat, txt = json.loads(key)
    m = _meta("flux", cfg)
    x = torch.empty(1, lat, lat, cfg["in_channels"], device="meta")
    t = torch.zeros(1, device="meta")
    ctx = torch.empty(1, txt, cfg["context_dim"], device="meta")
    pooled = torch.empty(1, cfg["pooled_dim"], device="meta")
    return flops._count(lambda: m(x, t, ctx, pooled))


@functools.cache
def _t5(key: str) -> int:
    cfg, n = json.loads(key)
    m = _meta("t5", cfg)
    ids = torch.zeros(1, n, dtype=torch.long, device="meta")
    return flops._count(lambda: m(ids))


def flux_call_flops(cfg: dict, t5_len: int) -> int:
    """One Flux call at batch 1: the canvas's latents and `t5_len` text tokens."""
    lat = cfg["canvas"]["edit_size"] // cfg["canvas"]["latent_down"]
    return _flux_call(json.dumps([cfg["flux"], lat, t5_len], sort_keys=True))


def pair_flops(cfg: dict, t5_len: int) -> int:
    """One textual_change pair: each of the two captions through T5 and the
    CLIP text tower, `steps` Flux calls from the shared start latents, one
    VAE decode at the canvas size."""
    steps = cfg["scheduler"]["steps"]
    return 2 * (steps * flux_call_flops(cfg, t5_len)
                + _t5(json.dumps([cfg["t5"], t5_len], sort_keys=True))
                + flops.count("clip_text", cfg["clip_text"], 1)
                + flops.count("vae", cfg["flux_vae"], 1, cfg["canvas"]["edit_size"], "decode"))
