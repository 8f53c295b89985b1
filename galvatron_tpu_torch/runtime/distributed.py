"""Process bootstrap: one process per GPU under ``torchrun``.

Port of ``galvatron_tpu/runtime/distributed.py::initialize_distributed``.
The reference bootstraps ``jax.distributed`` (one process per TPU host);
the port runs one process per device and reads the environment ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``):

    torchrun --nproc_per_node 4 -m galvatron_tpu_torch.cli train ...

- on ``cuda`` the default group is ``nccl`` and the process takes the GPU
  ``cuda:LOCAL_RANK``; on ``cpu`` it is ``gloo``;
- without a torchrun environment it is a one-rank group on a local store, so
  a world of one runs the same code (its collectives run through one-rank
  groups);
- `process_group` tears the group down in a ``finally``.

The reference's ``hybrid_mesh_shapes`` and ``dcn_granule_count`` place mesh
axes on TPU interconnects (ICI within a slice, DCN across hosts) and have no
counterpart here: the port's ranks are laid out row-major
(`parallel.mesh.build_mesh`), one host, NVLink between all GPUs.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, Optional

import torch
import torch.distributed as dist

_TORCHRUN_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# subgroups of the live default group, by (default group, backend, ranks):
# every model built in one process reuses them (an NCCL group holds a
# communicator and its buffers); emptied when the default group goes
_SUBGROUPS: dict = {}


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_KEYS)


def ensure_initialized(device, timeout_s: float = 600.0) -> bool:
    """Initialize the default process group for `device` unless one exists.
    Returns True when this call created it. With a torchrun environment the
    group spans ``WORLD_SIZE`` ranks (env:// rendezvous); without one it is
    a world of one on an in-process store."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    backend = backend_for(device)
    if launched_by_torchrun():
        dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    return True


def subgroup(ranks, backend: str):
    """``new_group(ranks, backend)``, made once per default group. Like
    ``new_group`` it is collective: every rank calls it for every group,
    in one order (``parallel.mesh.RankMesh.create_groups``)."""
    key = (id(dist.group.WORLD), backend, tuple(ranks))
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(list(ranks), backend=backend)
    return _SUBGROUPS[key]


def local_device(name: str) -> torch.device:
    """``cuda`` -> ``cuda:LOCAL_RANK`` (set as the current device), raising
    when no GPU is visible or the local rank has none; ``cpu`` -> the CPU.
    Never falls back from one to the other."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is visible (torch.cuda.is_available() "
                "is False); pass --device cpu to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
        if local >= torch.cuda.device_count():
            raise RuntimeError("LOCAL_RANK %d but only %d CUDA devices are visible"
                               % (local, torch.cuda.device_count()))
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError("unknown device %r (cuda or cpu)" % name)


_ABANDONED = [False]


def abandon_group() -> None:
    """Mark the default group as wedged: a collective of it never
    completed, so no later collective may run, its teardown included
    (`process_group` leaves it to the process's exit)."""
    _ABANDONED[0] = True


@contextlib.contextmanager
def process_group(device_name: str) -> Iterator[torch.device]:
    """Resolve the device, initialize the default group for it (unless the
    caller already has one) and yield the device; the group this call
    created is destroyed on the way out, whatever happens inside, unless
    it was abandoned (`abandon_group`)."""
    device = local_device(device_name)
    created = ensure_initialized(device)
    try:
        yield device
    finally:
        if created and dist.is_initialized() and not _ABANDONED[0]:
            _SUBGROUPS.clear()
            dist.destroy_process_group()


_REGROUPS = [0]  # re-rendezvous count: the prefix of each new group's store keys


def regroup(survivors, timeout_s: float = 600.0) -> Optional[int]:
    """Replace the default group by one over `survivors` (ranks of the
    current world), rendezvousing afresh on the run's store: the live
    migration off a quarantined or lost rank. Collective over the current
    world: every rank calls it after it has handed its shards over. Returns
    this process's rank in the new world, or None on a departing rank,
    whose group is destroyed (it exits after this). The subgroup cache is
    emptied: the new world's models create their own. A world that keeps
    every rank is left as it is. Under ``torchrun`` the store is the
    agent's, so any rank may depart; a group whose store rank 0 serves
    itself needs rank 0 among the survivors."""
    old_rank, world = rank(), world_size()
    survivors = sorted(int(r) for r in survivors)
    if survivors == list(range(world)):
        return old_rank
    if not survivors or any(not 0 <= r < world for r in survivors):
        raise ValueError("survivors %s are not ranks of a world of %d" % (survivors, world))
    store = dist.distributed_c10d._get_default_store()
    backend = dist.get_backend()
    _REGROUPS[0] += 1
    dist.barrier()
    _SUBGROUPS.clear()
    dist.destroy_process_group()
    if old_rank not in survivors:
        return None
    new_rank = survivors.index(old_rank)
    dist.init_process_group(backend, store=dist.PrefixStore("regroup%d/" % _REGROUPS[0], store),
                            rank=new_rank, world_size=len(survivors),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return new_rank


def agree_max(values, device):
    """The elementwise max of `values` (floats) over every rank: one
    all-reduce, so every rank takes the same branch (a train step
    boundary's flags, a serve scheduler iteration's clock and costs).
    Every rank must call it; a world of one skips the collective."""
    if world_size() == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
