"""Meshes of the distributed engine.

Counterpart of ``repro/launch/mesh.py``.  Functions, not module constants,
so importing this module touches no device and no process group.

* :func:`make_local_mesh`: ``[pods x] data x model`` ranks as threads of
  this process on one device (``comm.LocalMesh``), the counterpart of the
  reference's host-device mesh; ``model`` is the iteration axis, as the
  reference's tests use it.  This is how P shards run on one card.
* :func:`process_mesh`: this process's rank of a ``torchrun`` job (or any
  initialized ``torch.distributed`` world), laid out ``pods x iters x data``.
* :data:`PRODUCTION_AXES`: the reference's 256- and 512-chip meshes, in one
  place; :func:`make_production_mesh` is either as an abstract mesh on
  ``meta`` (the counting dry-run's view, the pods folded into the
  iteration axis; ``.lm_view()`` the LM dry-run's), and
  :func:`production_mesh` builds it for ``launch/train.py
  --production-mesh``: ``torchrun`` ranks, or thread ranks on one device.

NCCL cannot put two ranks of one communicator on one GPU, so on one card
``P > 1`` runs as a ``LocalMesh`` and NCCL only at world size 1.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..comm.abstract import AbstractMesh
from ..comm.group import LocalMesh, ProcessGroupComm, ProcessMesh, SoloGroup

__all__ = ["PRODUCTION_AXES", "make_local_mesh", "process_mesh", "init_process_group",
           "make_production_mesh", "production_mesh"]

#: the reference's production meshes (``repro/launch/mesh.py:15-19``), by
#: ``multi_pod``: ``(axis, size)`` major first; every reader takes the shapes
#: from here
PRODUCTION_AXES = {
    False: (("data", 16), ("model", 16)),
    True: (("pod", 2), ("data", 16), ("model", 16)),
}


def make_local_mesh(data: int = 1, model: int = 1, *, pods: int = 1, device=None,
                    timeout: Optional[float] = None, turns: bool = False):
    """``data`` graph shards by ``model`` iteration slices (the LM's data and
    model axes), ``pods`` times over (the LM's pod axis), one thread a rank,
    all on ``device`` (``cuda`` unless the caller asks for the CPU);
    ``turns``: one rank runs host code at a time (``LocalMesh``; the LM's
    many small ops run faster so)."""
    kw = {} if timeout is None else {"timeout": timeout}
    return LocalMesh(data, model, pods=pods, device=device, turns=turns, **kw)


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


def process_mesh(data: Optional[int] = None, iters: int = 1, *, pods: int = 1,
                 device=None) -> ProcessMesh:
    """The mesh of an initialized ``torch.distributed`` world of ``pods *
    data * iters`` ranks: world rank ``(o * iters + i) * data + p`` holds
    shard ``p`` of iteration slice ``i`` of pod ``o``.  Every rank must call
    this, in the same order (it creates the data, iteration and pod
    subgroups).  ``device`` is this rank's (default: its current card, or
    the CPU under gloo)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    data = world // (iters * pods) if data is None else data
    if pods * data * iters != world:
        shape = f"{pods} x {data} x {iters}" if pods > 1 else f"{data} x {iters}"
        raise ValueError(f"a {shape} mesh needs {pods * data * iters} ranks; the world has "
                         f"{world}")

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

    slab = iters * data  # the ranks of one pod
    data_group = SoloGroup() if data == 1 else ProcessGroupComm(
        subgroups([list(range(j * data, (j + 1) * data)) for j in range(pods * iters)]))
    iter_group = SoloGroup() if iters == 1 else ProcessGroupComm(
        subgroups([list(range(k * slab + q, (k + 1) * slab, data))
                   for k in range(pods) for q in range(data)]))
    pod_group = SoloGroup() if pods == 1 else ProcessGroupComm(
        subgroups([list(range(r, world, slab)) for r in range(slab)]))
    if device is None:
        backend = dist.get_backend()
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    return ProcessMesh(data_group, iter_group, torch.device(device), pod_group)


def _production_shape(multi_pod: bool):
    """``(pods, data, model)`` of a production mesh."""
    sizes = dict(PRODUCTION_AXES[bool(multi_pod)])
    return sizes.get("pod", 1), sizes["data"], sizes["model"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh (:data:`PRODUCTION_AXES`) as an
    abstract mesh on ``meta``, which only the dry-run runs: 16 x 16
    ``(data, model)``, 256 chips, or 2 x 16 x 16 ``(pod, data, model)``, 512.
    ``model`` (with ``pod``) is the iteration axis, as the reference's
    counting cells use it (``iter_axis=("pod", "model")``); the graph shards
    over ``data``.  ``.lm_view()`` is the LM's view: the pods a group of
    their own."""
    pods, data, model = _production_shape(multi_pod)
    return AbstractMesh(data, pods * model, axes=PRODUCTION_AXES[bool(multi_pod)])


def production_mesh(*, multi_pod: bool = False, distributed: bool = False, device=None):
    """The production mesh ``launch/train.py --production-mesh [--multi-pod]``
    trains on: with ``distributed``, this process's rank of the ``torchrun``
    job (which must have the mesh's 256 or 512 ranks: anything else raises
    before joining it), else a ``LocalMesh`` of that shape on ``device``,
    its ranks taking turns, as the reference builds its production mesh
    over the local devices."""
    pods, data, model = _production_shape(multi_pod)
    if not distributed:
        return make_local_mesh(data, model, pods=pods, device=device, turns=True)
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_available() and dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    sizes = {mp: math.prod(n for _, n in PRODUCTION_AXES[mp]) for mp in (False, True)}
    if world != sizes[bool(multi_pod)]:
        raise ValueError(f"the production meshes take {sizes[False]} ranks ({sizes[True]} with "
                         f"--multi-pod); the torchrun world has {world}")
    dev = init_process_group(device)
    return process_mesh(data, model, pods=pods, device=dev)
