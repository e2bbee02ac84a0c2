"""Meshes of the distributed engine.

Counterpart of ``repro/launch/mesh.py``.  Functions, not module constants,
so importing this module touches no device and no process group.

* :func:`make_local_mesh`: ``data x model`` ranks as threads of this
  process on one device (``comm.LocalMesh``), the counterpart of the
  reference's host-device mesh; ``model`` is the iteration axis, as the
  reference's tests use it.  This is how P shards run on one card.
* :func:`process_mesh`: this process's rank of a ``torchrun`` job (or any
  initialized ``torch.distributed`` world), laid out ``iters x data``.
* :func:`make_production_mesh`: the reference's 256- and 512-chip meshes as
  abstract meshes on ``meta``, for the dry-run.

NCCL cannot put two ranks of one communicator on one GPU, so on one card
``P > 1`` runs as a ``LocalMesh`` and NCCL only at world size 1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..comm.abstract import AbstractMesh
from ..comm.group import LocalMesh, ProcessGroupComm, ProcessMesh, SoloGroup

__all__ = ["make_local_mesh", "process_mesh", "init_process_group", "make_production_mesh"]


def make_local_mesh(data: int = 1, model: int = 1, *, device=None,
                    timeout: Optional[float] = None, turns: bool = False):
    """``data`` graph shards by ``model`` iteration slices (the LM's data and
    model axes), one thread a rank, all on ``device`` (``cuda`` unless the
    caller asks for the CPU); ``turns``: one rank runs host code at a time
    (``LocalMesh``; the LM's many small ops run faster so)."""
    kw = {} if timeout is None else {"timeout": timeout}
    return LocalMesh(data, model, device=device, turns=turns, **kw)


def init_process_group(device=None) -> torch.device:
    """Join the ``torchrun`` job this process was started in (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the
    environment) if it has not joined yet: NCCL on ``cuda``, gloo on the
    CPU.  Returns this rank's device (card ``LOCAL_RANK`` on ``cuda``)."""
    import torch.distributed as dist

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def process_mesh(data: Optional[int] = None, iters: int = 1, *, device=None) -> ProcessMesh:
    """The mesh of an initialized ``torch.distributed`` world of
    ``data * iters`` ranks: world rank ``i * data + p`` holds shard ``p`` of
    iteration slice ``i``.  Every rank must call this, in the same order
    (it creates the data and iteration subgroups).  ``device`` is this
    rank's (default: its current card, or the CPU under gloo)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    data = world // iters if data is None else data
    if data * iters != world:
        raise ValueError(f"a {data} x {iters} mesh needs {data * iters} ranks; the world has {world}")
    i, p = divmod(rank, data)

    def subgroups(members):
        """``dist.new_group`` for every group of ``members`` (all ranks
        create all groups); this rank's, or None where it is the world."""
        mine = None
        for ranks in members:
            if len(ranks) == world:
                return None
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    data_group = SoloGroup() if data == 1 else ProcessGroupComm(
        subgroups([list(range(j * data, (j + 1) * data)) for j in range(iters)]))
    iter_group = SoloGroup() if iters == 1 else ProcessGroupComm(
        subgroups([list(range(q, world, data)) for q in range(data)]))
    if device is None:
        backend = dist.get_backend()
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    return ProcessMesh(data_group, iter_group, torch.device(device))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh (``repro/launch/mesh.py:15-19``) as
    an abstract mesh on ``meta``, which only the dry-run runs: 16 x 16
    ``(data, model)``, 256 chips, or 2 x 16 x 16 ``(pod, data, model)``, 512.
    ``model`` (with ``pod``) is the iteration axis, as the reference's
    counting cells use it; the graph shards over ``data``."""
    if multi_pod:
        return AbstractMesh(16, 32, axes=(("pod", 2), ("data", 16), ("model", 16)))
    return AbstractMesh(16, 16, axes=(("data", 16), ("model", 16)))
