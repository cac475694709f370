"""A copy of the benchmark with the cells' configurations cut to the port's
tiny presets, for CPU tests: the same drivers, traffic generator,
reference and metric files, at widths a test run can hold. The factory's
edits run 2 DDIM steps here (`ip2p_steps_override`), the cells 100."""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]

TINY_UNET = {"in_channels": 8, "out_channels": 4, "block_channels": [32, 64],
             "layers_per_block": 1, "attn_levels": [True, False], "transformer_depth": 1,
             "num_heads": 0, "num_head_channels": 8, "context_dim": 32, "time_embed_mult": 4,
             "num_groups": 8}
TINY_VAE = {"in_channels": 3, "latent_channels": 4, "block_channels": [16, 32],
            "layers_per_block": 1, "num_groups": 8, "scaling_factor": 0.5}


def tiny_copy(dst: Path) -> Path:
    """The benchmark copied to dst/portbench with tiny configurations;
    returns the copy's root."""
    root = dst / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def edit(rel, **kv):
        p = root / rel
        d = json.loads(p.read_text())
        d.update(kv)
        p.write_text(json.dumps(d))
        return d
    from anyedit_tpu_torch.runtime.zoo import tiny_zoo_config
    from portbench.drivers.factory import widths
    tz = tiny_zoo_config()
    f = edit("configs/factory-sd15.json", zoo_base="tiny", dtype="float32",
             towers={k: widths(getattr(tz, k), torch.float32) for k in
                     json.loads((BENCH / "configs/factory-sd15.json").read_text())["towers"]},
             box_threshold=0.0, unet=TINY_UNET, vae=TINY_VAE,
             clip_text={"vocab_size": 30522, "hidden": 32, "layers": 2, "heads": 2,
                        "max_len": 77},
             canvas={"edit_size": 64, "grounding_size": 64, "sam_size": 64, "latent_down": 2})
    edit("configs/factory-sd15.json", color_alter={**f["color_alter"], "steps": 2})
    edit("traffic/color_alter.json", n_records=64, n_images=4,
         image_sizes=[[48, 64], [64, 48]], ip2p_steps_override=2)
    return root


def drive(root: Path, cell_name: str, seed: int, seconds: float = 0.001):
    """One run of a cell of the copy at `root` on the CPU, without the
    check for a card: set-up, the window (trace off), release, the check.
    Returns (window result, readings, the numbers compared)."""
    from portbench.harness import checks, registry
    from portbench.run import Context

    cell = registry.load_cell(root, cell_name)
    with tempfile.TemporaryDirectory() as work:
        ctx = Context(cell.config, cell.traffic, seed, torch.device("cpu"), Path(work),
                      cell.limits)
        st = cell.driver.setup(ctx)
        res = cell.driver.window(st, seconds, False)
        cell.driver.release(st)
        readings = cell.driver.check(st)
    return res, readings, checks.numbers(readings, cell.limits)
