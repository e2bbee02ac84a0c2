"""An abstract rank: the :class:`~.group.Group` interface on ``meta`` tensors.

The dry-run (:mod:`repro_torch.launch.dryrun`) runs one rank's program of a
mesh that does not exist, at paper scale, on ``meta`` tensors: nothing is
allocated and no device is touched.  :class:`AbstractGroup` answers every
collective with a ``meta`` tensor of the shape the rank would receive (one
allocation of the received size, as both real transports make) and
records the bytes the rank would move by collective kind, under the ring
model the reference's dry-run applies to the collectives of its compiled
program (``repro/launch/dryrun.py:80-90``), where there is no HLO to parse
here:

* ``all-to-all``: the result's bytes x (n - 1) / n (the chunks for the
  other ranks);
* ``collective-permute`` (a ``shift``): the bytes sent, none for a shift by
  a multiple of n;
* ``all-reduce``: 2 x the bytes x (n - 1) / n;
* ``all-gather``: the result's bytes x (n - 1) / n.

A group of one rank moves nothing and counts no collective.
:class:`AbstractMesh` is a ``[pods x] data x iters`` mesh seen from one of its ranks:
:meth:`AbstractMesh.run` runs the rank function once, on that rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .group import Group, RankContext, Work, _check_chunks, _run_as

__all__ = ["COLLECTIVE_KINDS", "CollectiveBytes", "AbstractGroup", "AbstractMesh"]

#: the reference's collective kinds, in its record's order
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


class CollectiveBytes:
    """Per-rank bytes moved and collectives issued, by kind."""

    def __init__(self):
        self.bytes: Dict[str, float] = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        self.ops: Dict[str, int] = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes[kind] += nbytes
        self.ops[kind] += 1

    def as_dict(self) -> dict:
        """The reference's record layout: bytes by kind, then ``ops``."""
        return dict(self.bytes, ops=dict(self.ops))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class AbstractGroup(Group):
    """Rank ``rank`` of a group of ``size`` ranks that exists only as shapes.

    Every collective returns a fresh ``meta`` tensor of the received shape
    and adds the bytes this rank moves to ``ledger``."""

    def __init__(self, size: int, rank: int = 0, ledger: Optional[CollectiveBytes] = None,
                 on_wait: Optional[Callable[[], None]] = None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.size = int(size)
        self.rank = int(rank)
        self.ledger = CollectiveBytes() if ledger is None else ledger
        self._on_wait = on_wait

    def _waits(self) -> None:
        """Where a real rank of a group of more than one would wait for its
        peers: ``on_wait``'s hook (the dry-run reads the live bytes there)."""
        if self.size > 1 and self._on_wait is not None:
            self._on_wait()

    def _moved(self, kind: str, nbytes: float) -> None:
        self._waits()
        if self.size > 1:
            self.ledger.add(kind, nbytes)

    def all_to_all(self, chunks):
        _check_chunks(chunks, self.size)
        self._moved("all-to-all", _nbytes(chunks) * (self.size - 1) / self.size)
        return torch.empty_like(chunks, device="meta")

    def shift_start(self, x, s):
        if s % self.size:
            self._moved("collective-permute", _nbytes(x))
        out = torch.empty_like(x, device="meta")
        return Work(lambda: out)

    def all_reduce_sum(self, x):
        self._moved("all-reduce", 2 * _nbytes(x) * (self.size - 1) / self.size)
        return torch.empty_like(x, device="meta")

    def all_gather(self, x):
        self._moved("all-gather", _nbytes(x) * self.size * (self.size - 1) / self.size)
        return torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device="meta")

    def barrier(self):
        self._waits()


class AbstractMesh:
    """A ``pods x data x iters`` mesh seen from data rank ``rank`` of its
    first iteration slice of its first pod, on ``meta``.  ``axes`` names the
    mesh's axes and sizes for reports (default ``data`` and ``model``, the
    iteration axis as the reference names it, after ``pod`` where there are
    pods); their product is the mesh's size.  A view whose axes hold a
    ``pod`` axis that ``pods`` leaves out has it folded into the iteration
    axis, as the counting engine runs the reference's multi-pod mesh;
    :meth:`lm_view` is the same mesh with the pods apart, as the LM runs it.
    :attr:`collectives` holds the last :meth:`run`'s bytes by kind, every
    group's (the pod group's too).  :attr:`on_wait`, where set, is called
    wherever the rank would wait for a peer (each collective and barrier of
    a group of more than one)."""

    def __init__(self, data: int = 1, iters: int = 1, *, pods: int = 1, device="meta",
                 rank: int = 0, axes: Optional[Sequence[Tuple[str, int]]] = None):
        if data < 1 or iters < 1 or pods < 1:
            raise ValueError(f"a mesh needs data >= 1, iters >= 1 and pods >= 1; got {data} x "
                             f"{iters} ({pods} pods)")
        self.device = torch.device(device)
        if self.device.type != "meta":
            raise ValueError(f"an abstract mesh runs on the meta device, not {self.device}")
        if not 0 <= rank < data:
            raise ValueError(f"data rank {rank} of a {data} x {iters} mesh")
        self.data_size = int(data)
        self.iter_size = int(iters)
        self.pod_size = int(pods)
        self.rank = int(rank)
        if axes is None:
            axes = (("pod", self.pod_size),) * (self.pod_size > 1) + (
                ("data", self.data_size), ("model", self.iter_size))
        axes = tuple(axes)
        prod = 1
        for _, n in axes:
            prod *= int(n)
        if prod != self.size:
            raise ValueError(f"axes {axes} do not make a mesh of {self.size} ranks")
        self.axis_names = tuple(name for name, _ in axes)
        self.shape = tuple(int(n) for _, n in axes)
        self.collectives = CollectiveBytes()
        self.on_wait: Optional[Callable[[], None]] = None

    @property
    def size(self) -> int:
        return self.pod_size * self.data_size * self.iter_size

    def __repr__(self) -> str:
        dims = " x ".join(f"{n} {a}" for a, n in zip(self.axis_names, self.shape))
        return f"AbstractMesh({dims}, rank={self.rank})"

    def lm_view(self) -> "AbstractMesh":
        """This mesh with its ``pod`` axis as a group of its own (the LM's
        view: data-parallel pods, weights whole across them); itself where
        the pods are apart already or there is no pod axis."""
        sizes = dict(zip(self.axis_names, self.shape))
        pods = sizes.get("pod", 1)
        if pods == self.pod_size:
            return self
        view = AbstractMesh(self.data_size, self.iter_size // pods, pods=pods,
                            device=self.device, rank=self.rank,
                            axes=tuple(zip(self.axis_names, self.shape)))
        view.on_wait = self.on_wait
        return view

    def run(self, fn: Callable[[RankContext], Any]) -> List[Any]:
        """``fn(ctx)`` on this mesh's one rank; its result as a one-element list."""
        self.collectives = ledger = CollectiveBytes()
        hook = self.on_wait
        ctx = RankContext(AbstractGroup(self.data_size, self.rank, ledger, hook),
                          AbstractGroup(self.iter_size, 0, ledger, hook), self.device,
                          AbstractGroup(self.pod_size, 0, ledger, hook))
        return [_run_as(ctx, fn)]
