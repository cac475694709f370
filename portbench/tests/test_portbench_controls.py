"""The control and the faults against the cell's limits, on the CPU at the
tiny presets. The control must come out not correct: the factory with the
program's W8A8 IP2P path switched on. Each fault the cell can have is
planted under the timed path, the rest of the run is driven as the
benchmark drives it, and `correct` must come out false; a fault planted in
one row of the batched edit's bucket is caught whichever row it is in.
Sound runs at this size pass the same limits. (On the chip the control runs
at the cell's own size through `portbench/calibrate.py`; PERF.md lists
those readings.)"""

from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_copy(tmp_path_factory.mktemp("bench"))


def correct(nums) -> bool:
    return bool(nums) and all(n.ok for n in nums)


def test_sound_runs_pass(root):
    _, readings, nums = tiny.drive(root, "factory.color_alter", 2147483651)
    assert correct(nums), readings


def test_factory_control_w8a8_fails(root, monkeypatch):
    from portbench.harness import registry
    cell = registry.load_cell(root, "factory.color_alter")
    real = cell.driver.setup
    monkeypatch.setattr(cell.driver, "setup", lambda ctx: real(ctx, quant=True))
    monkeypatch.setattr(registry, "load_cell", lambda r, n: cell)
    _, readings, nums = tiny.drive(root, "factory.color_alter", 14)
    assert not correct(nums), readings


def _factory_fault(root, monkeypatch, seed, fault):
    import anyedit_tpu_torch.runtime.zoo as zoo_mod
    real = zoo_mod.ip2p_edit

    def broken(eps_fn, ns, image_latents, cond, uncond, **kw):
        return fault(real, eps_fn, ns, image_latents, cond, uncond, **kw)
    monkeypatch.setattr(zoo_mod, "ip2p_edit", broken)
    _, readings, nums = tiny.drive(root, "factory.color_alter", seed)
    return readings, nums


def test_factory_fault_state_unchanged_fails(root, monkeypatch):
    """The edit returns the image's own latents: no step moved them."""
    readings, nums = _factory_fault(
        root, monkeypatch, 15, lambda real, e, ns, lat, c, u, **kw: lat)
    assert not correct(nums), readings


def test_factory_fault_half_batch_fails(root, monkeypatch):
    """The batched edit computes the first half of its records and hands
    their latents to the second half too."""
    def half(real, e, ns, lat, c, u, **kw):
        n = max(1, lat.shape[0] // 2)
        kw = {k: (v[:n] if torch.is_tensor(v) and v.shape[:1] == lat.shape[:1] else v)
              for k, v in kw.items()}
        out = real(e, ns, lat[:n], c[:n], u[:n], **kw)
        return torch.cat([out, out])[:lat.shape[0]]
    readings, nums = _factory_fault(root, monkeypatch, 16, half)
    assert not correct(nums), readings


def test_factory_fault_answer_altered_fails(root, monkeypatch):
    """The pair is altered where it is produced: the composite shifts the
    edited region by 16 levels."""
    from anyedit_tpu_torch.edits import global_
    real = global_.crop_composite

    def altered(original, edited, mask, feather_sigma=2.0):
        out = real(original, edited, mask, feather_sigma).astype("int16")
        m = mask.cpu().numpy() if torch.is_tensor(mask) else mask
        out[m.astype(bool)] += 16
        return out.clip(0, 255).astype("uint8")
    monkeypatch.setattr(global_, "crop_composite", altered)
    _, readings, nums = tiny.drive(root, "factory.color_alter", 17)
    assert not correct(nums), readings


@pytest.mark.parametrize("row", [0, 3])
def test_factory_fault_in_one_row_of_the_bucket_fails(root, monkeypatch, row):
    """The batched edit returns one row of each bucket unedited: the check
    samples every row, so it is caught whichever row it is."""
    def one_row(real, e, ns, lat, c, u, **kw):
        out = real(e, ns, lat, c, u, **kw).clone()
        if out.shape[0] > row:
            out[row] = lat[row]
        return out
    readings, nums = _factory_fault(root, monkeypatch, 19 + row, one_row)
    assert not correct(nums), readings
