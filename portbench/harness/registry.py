"""Finding the benchmark's parts by name, under the benchmark's root:

  workloads/<cell>.json   {"config", "traffic", "driver", "chips", "why", "limits"}
  configs/<config>.json   the configuration as it is run
  traffic/<traffic>.json  the traffic's parameters
  drivers/<driver>.py     setup / window / release / check
  metrics/<metric>.py     NAME, UNIT, LAYER, MOVES, WORKLOADS, read(reading)

A later change adds a cell, a configuration, a traffic mix or a per-layer
metric by adding such a file (and its entry in BENCHMARK.json); no file
that is there needs an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    driver: object
    chips: int
    why: str
    limits: dict


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise KeyError(f"no {what} file {path}")
    return json.loads(path.read_text())


def load_cell(root: Path, name: str) -> Cell:
    w = _json(root / "workloads" / f"{name}.json", f"workload {name!r}")
    return Cell(name, w["config"], w["traffic"],
                _json(root / "configs" / f"{w['config']}.json", "configuration"),
                _json(root / "traffic" / f"{w['traffic']}.json", "traffic"),
                _load_module(root / "drivers" / f"{w['driver']}.py",
                             f"portbench_driver_{w['driver']}"),
                int(w["chips"]), w["why"], dict(w.get("limits", {})))


def metrics_for(root: Path, cell: str) -> list:
    """The per-layer metric modules that list `cell`, in name order."""
    out = []
    for i, p in enumerate(sorted((root / "metrics").glob("*.py"))):
        m = _load_module(p, f"portbench_metric_{i}")
        if cell in m.WORKLOADS:
            out.append(m)
    return out


def all_metrics(root: Path) -> list:
    return [_load_module(p, f"portbench_metric_{i}")
            for i, p in enumerate(sorted((root / "metrics").glob("*.py")))]
