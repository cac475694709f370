"""Data parallelism over `torch.distributed`: the port's counterpart of the
`dp` axis of `anyedit_tpu/core/mesh.py`.

The JAX package shards a batch over the mesh's `dp` axis and lets XLA insert
the collectives. Here each rank is one process on one device with a whole
copy of the models: it takes a contiguous slice of each batch's rows, and
the trainers average their gradients over the ranks by all-reduce before
the optimizer. Only `dp` is ported. The mesh's `tp` and `ep` axes are layout
annotations that do not change the numbers, and every model here fits one
card.

A group comes from `torchrun`'s environment (`from_env`), a world of 1
included, or from an explicit rendezvous (`init_group`). Without that
environment there is no group (None): the one-process path. The backend is NCCL with one rank per
card (`cuda:{LOCAL_RANK}`), or gloo for CPU tensors; `init_group` also takes
gloo for CUDA tensors, which lets several ranks share one card. Importing
this module reads no environment and starts no group.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the data-parallel group: its rank, the
    group's size (dp), the device its tensors live on and the backend."""
    rank: int
    size: int
    device: torch.device
    backend: str


def init_group(rank: int, world: int, init_method: str, device,
               backend: Optional[str] = None) -> Group:
    """Join the default process group at `init_method` (`env://`,
    `tcp://host:port` or `file://path`). The backend is NCCL for a CUDA
    device and gloo for the CPU unless given. NCCL needs CUDA and binds
    this process to `device` before the group starts."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs CUDA, and torch.cuda.is_available() is "
                               "False; pass --device cpu to train over gloo on the CPU")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return Group(rank, world, device, backend)


def env_world() -> int:
    """WORLD_SIZE from `torchrun`'s environment; 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def from_env(device="cuda") -> Optional[Group]:
    """The group `torchrun` describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT), a world of 1 included, or None without
    RANK. A CUDA device becomes `cuda:{LOCAL_RANK}` under NCCL; "cpu" gives
    gloo."""
    if "RANK" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return init_group(rank, env_world(), "env://", device)


def destroy(group: Optional[Group]) -> None:
    if group is not None:
        dist.destroy_process_group()


def check_batch(batch: int, world: int) -> None:
    """Refuse a global batch that `world` ranks do not divide. The JAX rule
    is dp = gcd(batch, world), with the devices beyond dp given to `tp` /
    `ep`, which the port does not have: here dp is the world."""
    if batch % world:
        raise ValueError(
            f"a batch of {batch} does not split over {world} ranks (dp = gcd = "
            f"{math.gcd(batch, world)}; the JAX package would give the other devices to tp / "
            f"ep, which the port does not have): use a batch size that {world} divides "
            f"({world}, {2 * world}, {3 * world}, ...)")


def rank_rows(batch: int, rank: int, dp: int) -> slice:
    """Rank `rank`'s contiguous rows of a batch: ceil(batch / dp) a rank in
    rank order, so the last ranks take fewer rows, or none, where dp does
    not divide the batch."""
    per = -(-batch // dp)
    return slice(min(rank * per, batch), min((rank + 1) * per, batch))


def batch_rows(batch: dict, group: Optional[Group]) -> dict:
    """This rank's rows (`rank_rows`) of each array in `batch` (torch or
    numpy, batch first); the whole batch without a group."""
    if group is None:
        return batch
    rows = rank_rows(len(next(iter(batch.values()))), group.rank, group.size)
    return {k: v[rows] for k, v in batch.items()}


def average(grads: Sequence[torch.Tensor], loss: torch.Tensor,
            group: Group) -> tuple[list, torch.Tensor]:
    """A train step's gradients and loss, averaged over the group in fp32
    -> (grads, loss). One all-reduce sums them, packed into one fp32 buffer
    in the order given (the same on every rank), and a division by dp
    follows, so every rank receives the same bits. The gradients returned
    are views of that buffer."""
    sizes = [g.numel() for g in grads]
    flat = torch.empty(sum(sizes) + 1, dtype=torch.float32, device=loss.device)
    for part, g in zip(flat.split(sizes + [1]), list(grads) + [loss]):
        part.copy_(g.flatten())
    dist.all_reduce(flat)
    flat.div_(group.size)
    *out, mean = flat.split(sizes + [1])
    return [o.view(g.shape) for o, g in zip(out, grads)], mean[0]


def is_main(group: Optional[Group]) -> bool:
    """True on rank 0, and in one process without a group."""
    return group is None or group.rank == 0


def barrier(group: Optional[Group]) -> None:
    if group is None:
        return
    if group.backend == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


def all_gather_objects(obj: Any, group: Optional[Group]) -> list:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    if group is None:
        return [obj]
    out = [None] * group.size
    dist.all_gather_object(out, obj)
    return out
