"""The PyTorch twins of the two LCM quality tools, run on the CPU with their
step counts shrunk to a few (`--device cpu`): each prints one JSON line
with the JAX tool's keys (read from the JAX tool's source: running it
would train its models under XLA), finite numbers, and the distillation
steps asked for. At these step counts the numbers say nothing about
quality; a card run at the tools' own counts does (PERF.md).
"""

import ast
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_keys(name) -> tuple[set, set]:
    """The keys of the JSON object the JAX tool prints (a `**tables` splat
    stands for the keys of its `editors` dict), and the keys of one table."""
    tree = ast.parse((REPO / "tools" / f"{name}.py").read_text())

    def assigned(var):
        return next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", "") == var)
    out = next(n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "attr", "") == "dumps")
    if isinstance(out, ast.Name):                   # json.dumps(out)
        out = assigned(out.id)
    keys = {k.value for k in out.keys if k is not None}
    table = set()
    if None in out.keys:
        keys |= {k.value for k in assigned("editors").keys}
        table = next({k.value for k in n.value.keys} for n in ast.walk(tree)
                     if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
                     and getattr(n.targets[0].value, "id", "") == "tables")
    return keys, table


def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, (int, float)):
        yield obj


@pytest.mark.parametrize("name,shrink", [
    ("distill_quality", {"TEACHER_STEPS": 3}),
    ("lcm_quality_gate", {"VAE_STEPS": 2, "TEACHER_STEPS": 2}),
])
def test_tool_twin_prints_the_jax_keys(name, shrink, monkeypatch, capsys):
    mod = _load(f"{name}_torch")
    for k, v in shrink.items():
        monkeypatch.setattr(mod, k, v)
    assert mod.main(["2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys, table = _jax_keys(name)
    assert set(out) == keys
    for k in keys - {"metric", "note", "distill_steps"}:
        if isinstance(out[k], dict):
            assert set(out[k]) == table, k
    assert out["distill_steps"] == 2
    assert all(math.isfinite(x) for x in _numbers(out))


def test_tool_twins_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for name in ("distill_quality_torch", "lcm_quality_gate_torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _load(name).main(["1"])
