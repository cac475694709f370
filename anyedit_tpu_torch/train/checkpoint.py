"""Training checkpoint and resume (counterpart of
`anyedit_tpu/train/checkpoint.py`, which wraps Orbax's CheckpointManager).

Same API and the same decisions as that manager with its options there
(`max_to_keep=keep`, `save_interval_steps`): a step is saved when it is
past the latest saved step and either a multiple of the interval or the
first save of the directory; the `keep` latest steps stay, older ones are
deleted. Each step is a directory named by the step, holding one
`torch.save` file, written under a temporary name and renamed into place,
so a reader never sees half a checkpoint. Saves are synchronous: `wait` and
`close` have nothing to wait for. `all_steps()` stands for the JAX
`mgr.all_steps()`.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Mapping

import torch

_FILE = "state.pt"


def _state(x) -> Any:
    """A module's state dict, or a (nested) mapping, on the CPU."""
    if isinstance(x, torch.nn.Module):
        x = x.state_dict()
    if isinstance(x, Mapping):
        return {k: _state(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return x


class TrainCheckpointer:
    def __init__(self, directory: str | Path, keep: int = 3,
                 save_interval_steps: int = 500):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep, self.interval = keep, save_interval_steps

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / _FILE).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self.interval == 0 or not steps

    def save(self, step: int, adapter_params: Any, opt_state: Any,
             extra: dict | None = None) -> bool:
        """Returns True if a checkpoint was actually written this step."""
        if not self.should_save(step):
            return False
        payload = {"adapter": _state(adapter_params), "opt": _state(opt_state)}
        if extra:
            payload["extra"] = _state(extra)
        tmp = Path(tempfile.mkdtemp(prefix=f".{step}.", dir=self.dir))
        torch.save(payload, tmp / _FILE)
        os.replace(tmp, self.dir / str(step))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / str(old))
        return True

    def restore_latest(self, map_location: Any = "cpu") -> tuple[int | None, Any, Any]:
        """(step, adapter_params, opt_state); (None, None, None) if empty.
        Tensors come back on `map_location`."""
        step = self.latest_step()
        if step is None:
            return None, None, None
        payload = torch.load(self.dir / str(step) / _FILE, map_location=map_location,
                             weights_only=True)
        return step, payload["adapter"], payload["opt"]

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
