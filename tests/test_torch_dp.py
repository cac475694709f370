"""Data parallelism in the PyTorch port (`core/dist.py`, the counterpart of
the JAX mesh's `dp` axis): the AnySD step, the distillation step, the
batched IP2P edit and the `train` command on 2 gloo ranks, spawned on the
CPU, against one port process and against the JAX step on a `dp=2` mesh.

The module imports torch and the port only, so that the spawned ranks stay
light; JAX is imported inside the fixtures that build the references. The
inputs are made from seeds with numpy (the loss's draws are JAX's, from the
keys its steps split, as `test_torch_train.py` and `test_torch_distill.py`
hand them) and reach the ranks through `tmp_path`; the ranks meet at a
`file://` rendezvous there, and the `train` command's ranks at `env://` on a
free port.

Tolerances. AnySD (batch 4, 2 rows a rank, lr 1e-4): the loss relative 1e-5
of one process and of JAX; the adapter within 1e-5 abs of both, 10 % of one
step: the two ranks' mean gradient differs from one process's in fp32
summation order only, and Adam scales each element by its own gradient, so
only an element whose gradient sits within rounding of zero can take a
different step, and that step is itself near zero. Distillation (batch 2,
lr 1e-3): the loss relative 1e-5 of JAX's; the masters as
`test_torch_distill.py` holds them, 99.9 % of the elements within 1e-5 and
all within the steps' reach (2 lr a step). Across the ranks: the adapter
and the student's and the EMA's masters bit for bit. The edit: each record
within 1 uint8 level of one process.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from anyedit_tpu_torch import cli
from anyedit_tpu_torch.core import dist
from anyedit_tpu_torch.core.png import write_png
from anyedit_tpu_torch.core.schema import InstructionRecord
from anyedit_tpu_torch.models import unet_sd as tunet
from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
from anyedit_tpu_torch.train import anysd as tanysd
from anyedit_tpu_torch.train import distill as td
from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer

torch.set_num_threads(1)
T = torch.from_numpy
WORLD = 2
# the one-level fp32 cut of the tiny IP2P UNet that `test_torch_train.py`
# trains through; the distiller's without its transformer (the gradient
# reaches every weight through the convolutions, and the JAX step compiles
# in half the time)
PORT_UNET1 = dataclasses.replace(tunet.TINY_UNET, in_channels=8, dtype=torch.float32,
                                 block_channels=(32,), attn_levels=(True,))
ANYSD_CFG = dataclasses.replace(tanysd.TINY_ANYSD, unet=PORT_UNET1)
DISTILL_CFG = dataclasses.replace(td.TINY_DISTILL,
                                  unet=dataclasses.replace(PORT_UNET1, attn_levels=(False,)))
B_ANYSD, B_DISTILL, HW, L = 4, 2, 8, 7
ANYSD_KEYS, DISTILL_KEYS = (21, 22), (11, 12)
EDIT_SEEDS, EDIT_STEPS = [5, 6, 7], 2
RANK_TIMEOUT_S = 240


def spawn(fn, *args):
    """Start fn(rank, *args) in WORLD spawned processes; `join(ctx)` waits."""
    return mp.start_processes(fn, args=args, nprocs=WORLD, join=False, start_method="spawn")


def join(ctx):
    """Wait for the ranks; a rank's exception fails the test with its
    traceback."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {RANK_TIMEOUT_S} s")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the library's steps, shared by the ranks and one process --------------

def anysd_steps(inp, group):
    """Two AnySD train steps on this rank's rows of the batch and of JAX's
    draws -> (losses, adapter parameters)."""
    tr = tanysd.AnySDTrainer(ANYSD_CFG, device="cpu")
    unet, adapter, _ = tr.init(unet_state=inp["unet_sd"])
    adapter.load_state_dict(inp["adapter_sd"], strict=True)
    opt = tr.init_opt(adapter)
    rows = slice(None) if group is None else dist.rank_rows(B_ANYSD, group.rank, group.size)
    batch = {k: v[rows] for k, v in inp["anysd_batch"].items()}
    losses = []
    for draws in inp["anysd_draws"]:
        adapter, opt, loss = tr.train_step(adapter, opt, unet, batch,
                                           {k: v[rows] for k, v in draws.items()}, group=group)
        losses.append(float(loss))
    return losses, {k: p.detach().clone() for k, p in adapter.named_parameters()}


def distill_steps(inp, group):
    """Two distillation steps on this rank's rows -> (losses, the student's
    masters, the EMA's masters)."""
    d = td.LCMDistiller(DISTILL_CFG, device="cpu")
    teacher, student, ema, opt = d.init(inp["teacher_sd"])
    rows = slice(None) if group is None else dist.rank_rows(B_DISTILL, group.rank, group.size)
    batch = {k: v[rows] for k, v in inp["distill_batch"].items()}
    losses = []
    for draws in inp["distill_draws"]:
        student, ema, opt, loss = d.distill_step(student, ema, opt, teacher, batch,
                                                 {k: v[rows] for k, v in draws.items()},
                                                 group=group)
        losses.append(float(loss))
    return losses, student.masters, ema.masters


def edit_inputs():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (40, 40, 3), np.uint8) for _ in range(3)]
    m = np.zeros((40, 40), np.float32)
    m[10:30, 10:30] = 1.0
    return imgs, ["make it red", "make it blue", "add snow"], [None, m, None]


def batch_edit(bucket: int, group):
    """3 records, the second masked, through `ip2p().batch` on the tiny zoo
    with `edit_batch_bucket=bucket`."""
    zoo = ModelZoo(dataclasses.replace(tiny_zoo_config(), edit_batch_bucket=bucket),
                   device="cpu", seed=0)
    imgs, instrs, masks = edit_inputs()
    return zoo.ip2p().batch(imgs, instrs, masks, steps=EDIT_STEPS, seeds=EDIT_SEEDS,
                            group=group)


def _rank(rank, d, ports):
    """One rank: the library's steps and the edit over a `file://` group,
    then the `train` command (`_cli_runs`)."""
    torch.set_num_threads(1)
    d = Path(d)
    inp = torch.load(d / "inputs.pt", weights_only=False)
    group = dist.init_group(rank, WORLD, f"file://{d / 'rendezvous'}", "cpu")
    try:
        out = {"anysd": anysd_steps(inp, group), "distill": distill_steps(inp, group),
               # bucket 1 is rounded up to 2 rows a chunk, one a rank
               "edits": batch_edit(1, group)}
    finally:
        dist.destroy(group)
    torch.save(out, d / f"rank{rank}.pt")
    _cli_runs(rank, d, ports)


# ---- references ---------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Seeded Flax trees for the one-level UNets and the adapter, numpy
    batches and JAX's draws for each step, handed to 2 spawned ranks (and a
    ledger for the `train` command); while they run, JAX's AnySD and
    distillation steps jitted with the batch sharded over a `MeshSpec(dp=2)`
    mesh, and the same work in this process without a group (the edit's
    bucket at the ranks' rounded 2, the command's two runs)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anyedit_tpu.core.mesh import MeshSpec, make_mesh
    from anyedit_tpu.models.unet_sd import UNet2DCondition
    from anyedit_tpu.train import anysd as janysd
    from anyedit_tpu.train import distill as jd
    from anyedit_tpu_torch.weights import bridge
    from test_torch_bridge import random_flax_params
    from test_torch_train import FAST, JAX_UNET1, adapter_tree, unet1_params

    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    unet_p = unet1_params()
    junet0 = dataclasses.replace(JAX_UNET1, attn_levels=(False,))
    teacher_p = random_flax_params(UNet2DCondition(junet0), (
        jnp.zeros((1, HW, HW, 8)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, L, 32))), 1)
    jcfg = dataclasses.replace(janysd.TINY_ANYSD, unet=JAX_UNET1)
    ad_p = adapter_tree(jcfg)
    ab = {"edited_latents": normal(B_ANYSD, HW, HW, 4), "orig_latents": normal(B_ANYSD, HW, HW, 4),
          "text_emb": normal(B_ANYSD, L, 32), "image_embed": normal(B_ANYSD, 32),
          "task_id": np.array([0, 1, 2, 3], np.int32)}
    a_draws = []
    for s in ANYSD_KEYS:
        k_t, k_n, k_drop = jax.random.split(jax.random.key(s), 3)
        a_draws.append({"t": T(np.array(jax.random.randint(k_t, (B_ANYSD,), 0, 1000))).long(),
                        "noise": T(np.array(jax.random.normal(k_n, (B_ANYSD, HW, HW, 4)))),
                        "p": T(np.array(jax.random.uniform(k_drop, (B_ANYSD,))))})
    db = {"edited_latents": normal(B_DISTILL, HW, HW, 4, scale=0.3),
          "orig_latents": normal(B_DISTILL, HW, HW, 4, scale=0.3),
          "text_emb": normal(B_DISTILL, L, 32), "uncond_emb": normal(B_DISTILL, L, 32, scale=0.1)}
    d_draws = []
    for s in DISTILL_KEYS:
        k_i, k_n = jax.random.split(jax.random.key(s))
        d_draws.append({"n": T(np.array(jax.random.randint(k_i, (B_DISTILL,), 0, 8 - 1))).long(),
                        "noise": T(np.array(jax.random.normal(k_n, (B_DISTILL, HW, HW, 4))))})
    d = tmp_path_factory.mktemp("dp")
    inp = {"unet_sd": bridge.unet_state_dict(unet_p, 1),
           "adapter_sd": bridge.anysd_adapter_state_dict(ad_p),
           "anysd_batch": {k: T(v).long() if k == "task_id" else T(v) for k, v in ab.items()},
           "anysd_draws": a_draws, "teacher_sd": bridge.unet_state_dict(teacher_p, 1),
           "distill_batch": {k: T(v) for k, v in db.items()}, "distill_draws": d_draws}
    torch.save(inp, d / "inputs.pt")
    write_ledger(d)
    ctx = spawn(_rank, str(d), [free_port(), free_port()])

    shard = NamedSharding(make_mesh(MeshSpec(dp=2), devices=jax.devices()[:2]), P("dp"))
    jtr = janysd.AnySDTrainer(jcfg)
    step = jax.jit(jtr.train_step, compiler_options=FAST)
    params, opt = ad_p, jtr.tx.init(ad_p)
    jb = {k: jax.device_put(jnp.asarray(v), shard) for k, v in ab.items()}
    a_losses = []
    for s in ANYSD_KEYS:
        params, opt, loss = step(params, opt, unet_p, jb, jax.random.key(s))
        a_losses.append(float(loss))
    jdist = jd.LCMDistiller(dataclasses.replace(jd.TINY_DISTILL, unet=junet0))
    js, je, jopt = jdist.init(teacher_p)
    dstep = jax.jit(jdist.distill_step, compiler_options=FAST)
    jdb = {k: jax.device_put(jnp.asarray(v), shard) for k, v in db.items()}
    d_losses = []
    for s in DISTILL_KEYS:
        js, je, jopt, loss = dstep(js, je, jopt, teacher_p, jdb, jax.random.key(s))
        d_losses.append(float(loss))

    one = {"anysd": anysd_steps(inp, None), "distill": distill_steps(inp, None),
           "edits": batch_edit(2, None), "cli": []}
    for argv in (train_argv(d / "ledger.jsonl", d / "solo", 2),
                 train_argv(d / "ledger.jsonl", d / "solo", 4) + ["--resume"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        one["cli"].append(buf.getvalue())
    join(ctx)
    tree = functools.partial(jax.tree.map, np.asarray)
    return dict(dir=d, one=one, ranks=[torch.load(d / f"rank{r}.pt", weights_only=False)
                                       for r in range(WORLD)],
                cli=[json.loads((d / f"cli{r}.json").read_text()) for r in range(WORLD)],
                jax_anysd=(a_losses, bridge.anysd_adapter_state_dict(tree(params))),
                jax_distill=(d_losses, bridge.unet_state_dict(tree(js), 1),
                             bridge.unet_state_dict(tree(je), 1)))


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


# ---- core/dist.py ----------------------------------------------------------

@pytest.mark.parametrize("batch,world,dp", [(16, 1, 1), (16, 2, 2), (16, 8, 8), (4, 4, 4),
                                            (6, 3, 3), (6, 4, None), (3, 2, None),
                                            (1, 2, None), (16, 6, None)])
def test_dp_size(batch, world, dp):
    """dp is gcd(batch, world), the JAX rule, only where that is the world;
    a world that does not divide the batch is refused, naming the batch
    sizes it divides."""
    if dp is not None:
        assert dist.check_batch(batch, world) is None
    else:
        with pytest.raises(ValueError, match=f"{world}, {2 * world}, {3 * world}"):
            dist.check_batch(batch, world)


@pytest.mark.parametrize("batch,dp,want", [
    (8, 2, [(0, 4), (4, 8)]), (16, 4, [(0, 4), (4, 8), (8, 12), (12, 16)]),
    (4, 1, [(0, 4)]), (3, 2, [(0, 2), (2, 3)]), (1, 2, [(0, 1), (1, 1)]),
    (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)])])
def test_rank_rows(batch, dp, want):
    """Contiguous rows in rank order that cover the batch once; ceil(batch
    / dp) a rank, the last ranks short (a chunk's tail)."""
    got = [dist.rank_rows(batch, r, dp) for r in range(dp)]
    assert [(s.start, s.stop) for s in got] == want


@contextlib.contextmanager
def torchrun_env(monkeypatch, world: int):
    """torchrun's variables for rank 0 of `world` on a free port; the
    group `from_env` builds there is destroyed on the way out."""
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    group = dist.from_env("cpu")
    try:
        yield group
    finally:
        dist.destroy(group)


def test_torchrun_world_of_one_is_a_group(monkeypatch):
    """Under torchrun a world of 1 still joins a group (gloo for the CPU),
    so one rank runs the same collectives as many."""
    with torchrun_env(monkeypatch, 1) as group:
        assert group == dist.Group(0, 1, torch.device("cpu"), "gloo")
        assert torch.distributed.is_initialized() and dist.is_main(group)
        assert dist.all_gather_objects(3, group) == [3]
        dist.barrier(group)
    assert not torch.distributed.is_initialized()


def test_average_one_rank_is_exact(monkeypatch):
    """`average` over one rank returns the gradients cast to fp32, in their
    shapes, and the loss, bit for bit: a sum over one rank and a division
    by 1."""
    rng = np.random.default_rng(4)
    grads = [T(rng.standard_normal((3, 5)).astype(np.float32)),
             T(rng.standard_normal(7).astype(np.float32)).bfloat16(),
             T(rng.standard_normal((2, 1, 4)).astype(np.float32))]
    loss = torch.tensor(0.3125)
    with torchrun_env(monkeypatch, 1) as group:
        got, mean = dist.average(grads, loss, group)
    assert all(a.dtype == torch.float32 and torch.equal(a, b.float())
               for a, b in zip(got, grads))
    assert mean.dtype == torch.float32 and mean.shape == () and float(mean) == 0.3125


def test_no_group_without_torchrun(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.from_env("cpu") is None and dist.env_world() == 1
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.from_env("cpu") is None
    assert dist.is_main(None) and dist.all_gather_objects(3, None) == [3]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("which", ["anysd", "distill"])
def test_draw_takes_rank_rows(which):
    """With a group, `draw` makes the whole batch's draws from the step's
    generator and keeps the rank's rows: the rows one process draws."""
    if which == "anysd":
        tr, shape = tanysd.AnySDTrainer(ANYSD_CFG, device="cpu"), (4, 8, 8, 4)
    else:
        tr, shape = td.LCMDistiller(DISTILL_CFG, device="cpu"), (4, 8, 8, 4)
    whole = tr.draw(torch.Generator().manual_seed(7), {"edited_latents": torch.zeros(shape)})
    for r in range(2):
        g = dist.Group(r, 2, torch.device("cpu"), "gloo")
        got = tr.draw(torch.Generator().manual_seed(7),
                      {"edited_latents": torch.zeros((2,) + shape[1:])}, g)
        assert sorted(got) == sorted(whole)
        for k in got:
            assert torch.equal(got[k], whole[k][2 * r:2 * r + 2]), k


# ---- the library on 2 ranks --------------------------------------------------

def test_anysd_step_two_ranks_match_one_process(run):
    losses, params = run["one"]["anysd"]
    for r in run["ranks"]:
        got_losses, got = r["anysd"]
        assert all(rel(a, b) <= 1e-5 for a, b in zip(got_losses, losses)), (got_losses, losses)
        for k, p in params.items():
            np.testing.assert_allclose(got[k].numpy(), p.numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_anysd_step_two_ranks_match_jax_dp_mesh(run):
    jlosses, jparams = run["jax_anysd"]
    got_losses, got = run["ranks"][0]["anysd"]
    assert all(rel(a, b) <= 1e-5 for a, b in zip(got_losses, jlosses)), (got_losses, jlosses)
    assert sorted(got) == sorted(jparams)
    for k, p in jparams.items():
        np.testing.assert_allclose(got[k].numpy(), p.numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_anysd_adapter_equal_across_ranks(run):
    (l0, p0), (l1, p1) = (r["anysd"] for r in run["ranks"])
    assert l0 == l1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def _within_reach(got, ref, steps):
    reach = 2 * steps * DISTILL_CFG.learning_rate
    diff = np.concatenate([np.abs(got[k].numpy() - ref[k].numpy()).ravel() for k in ref])
    assert np.mean(diff <= 1e-5) >= 0.999 and diff.max() <= reach, \
        (np.mean(diff <= 1e-5), diff.max())


def test_distill_two_ranks_masters_equal_across_ranks(run):
    (l0, s0, e0), (l1, s1, e1) = (r["distill"] for r in run["ranks"])
    assert l0 == l1
    assert all(torch.equal(s0[k], s1[k]) and torch.equal(e0[k], e1[k]) for k in s0)


def test_distill_two_ranks_match_one_process(run):
    losses, student, ema = run["one"]["distill"]
    got_losses, got_s, got_e = run["ranks"][0]["distill"]
    assert all(rel(a, b) <= 1e-5 for a, b in zip(got_losses, losses)), (got_losses, losses)
    _within_reach(got_s, student, len(losses))
    _within_reach(got_e, ema, len(losses))


def test_distill_two_ranks_match_jax_dp_mesh(run):
    jlosses, jstudent, jema = run["jax_distill"]
    got_losses, got_s, got_e = run["ranks"][0]["distill"]
    assert all(rel(a, b) <= 1e-5 for a, b in zip(got_losses, jlosses)), (got_losses, jlosses)
    _within_reach(got_s, jstudent, len(jlosses))
    _within_reach(got_e, jema, len(jlosses))


def test_ip2p_batch_split_matches_one_process(run):
    """3 records, the second masked, over 2 ranks at `edit_batch_bucket` 1,
    which the split rounds up to chunks of 2 ([0, 1] then [2], where rank 1
    has no rows and still joins the gather): every rank returns all 3, in
    order, each within 1 uint8 level of one process at chunks of 2 (the
    masked chunk's re-noise is the whole chunk's draw, so the masked record
    takes its second row)."""
    want, ranks = run["one"]["edits"], run["ranks"]
    for r in ranks:
        assert len(r["edits"]) == 3
        for got, ref in zip(r["edits"], want):
            assert got.shape == ref.shape == (40, 40, 3) and got.dtype == np.uint8
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert all(np.array_equal(a, b) for a, b in zip(ranks[0]["edits"], ranks[1]["edits"]))


# ---- the `train` command under 2 ranks ---------------------------------------

def write_ledger(root: Path) -> None:
    """4 success rows over 2 edit types, 32x32 PNGs written by the port."""
    rng = np.random.default_rng(1)
    rows = []
    for i in range(4):
        a, b = root / f"in_{i}.png", root / f"ed_{i}.png"
        write_png(a, rng.integers(0, 255, (32, 32, 3), np.uint8))
        write_png(b, rng.integers(0, 255, (32, 32, 3), np.uint8))
        rec = InstructionRecord(edit=f"edit {i}", input="a", output="b",
                                edit_type=("color_alter", "remove")[i % 2],
                                image_file=str(a)).to_json()
        rows.append({"key": f"k{i}", "status": "success", "record": rec,
                     "payload": {"edited_file": str(b), "input_file": str(a)}})
    (root / "ledger.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")


def train_argv(ledger, ckpt, steps):
    return ["train", "--ledger", str(ledger), "--steps", str(steps), "--batch-size", "2",
            "--resolution", "32", "--tiny", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "1", "--log-every", "1", "--val-count", "1",
            "--val-steps", "1", "--device", "cpu"]


def _cli_runs(rank, d, ports):
    """`cli.main(["train", ...])` as `torchrun` would start rank `rank`: 2
    steps, then `--resume` to 4 (each its own group, on its own port). The
    checkpoint saves and train steps are counted and stdout kept."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1")
    real_save, real_step = TrainCheckpointer.save, tanysd.AnySDTrainer.train_step
    log = {"saves": [], "steps": 0}

    def save(self, step, *args, **kwargs):
        written = real_save(self, step, *args, **kwargs)
        if written:
            log["saves"].append(step)
        return written

    def train_step(self, *args, **kwargs):
        log["steps"] += 1
        return real_step(self, *args, **kwargs)
    TrainCheckpointer.save, tanysd.AnySDTrainer.train_step = save, train_step
    runs = []
    for port, argv in zip(ports, (train_argv(d / "ledger.jsonl", d / "ckpt", 2),
                                  train_argv(d / "ledger.jsonl", d / "ckpt", 4) + ["--resume"])):
        os.environ["MASTER_PORT"] = str(port)
        log.update(saves=[], steps=0)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        runs.append({"rc": rc, "out": buf.getvalue(), **log})
    (d / f"cli{rank}.json").write_text(json.dumps(runs))


def step_losses(out: str) -> list:
    return [json.loads(x)["loss"] for x in out.splitlines() if x.startswith('{"step"')]


def test_train_cli_two_ranks(run):
    """`train --tiny --device cpu` at batch 2 under 2 ranks (gloo, one row
    a rank): only rank 0 writes checkpoints and grids and prints; the
    printed losses, all-reduced, equal one process's within 1e-5 relative;
    `--resume` reads step 2 and both ranks run steps 3 and 4."""
    d, ranks = run["dir"], run["cli"]
    for got, ref, saves in zip(ranks[0], run["one"]["cli"], ([1, 2], [3, 4])):
        assert got["rc"] == 0 and got["steps"] == 2 and got["saves"] == saves
        losses, want = step_losses(got["out"]), step_losses(ref)
        assert len(losses) == len(want) == 2
        assert all(rel(a, b) <= 1e-5 for a, b in zip(losses, want)), (losses, want)
        assert json.loads(got["out"].strip().splitlines()[-1])["final_step"] == \
            json.loads(ref.strip().splitlines()[-1])["final_step"]
    assert "resumed from step 2" in ranks[0][1]["out"]
    assert ranks[1] == [{"rc": 0, "out": "", "saves": [], "steps": 2}] * 2
    assert TrainCheckpointer(d / "ckpt").all_steps() == [2, 3, 4]
    assert sorted(p.name for p in (d / "ckpt" / "val").iterdir()) == \
        sorted(p.name for p in (d / "solo" / "val").iterdir())


def test_distill_cli_refuses_a_world(monkeypatch, tmp_path):
    """`distill` stays one process, as the JAX command: under WORLD_SIZE 2
    it raises before it builds anything."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="one process"):
        cli.main(["distill", "--ledger", str(tmp_path / "none.jsonl"), "--tiny",
                  "--device", "cpu"])


def test_train_cli_refuses_a_world_that_does_not_divide_the_batch(tmp_path, monkeypatch):
    """A world of 2 at batch 3: the JAX package would hand the surplus to
    tp / ep; the port refuses, before it joins a group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    argv = train_argv(tmp_path / "ledger.jsonl", tmp_path / "ck", 1)
    argv[argv.index("--batch-size") + 1] = "3"
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        cli.main(argv)
