"""Per-rank collectives of the distributed engine: one ``Group`` interface, two transports.

The reference runs one program under ``shard_map`` and calls axis
collectives (``all_to_all``, ``ppermute``, ``psum``, ``all_gather``,
``axis_index``).  The port writes the engine once, per rank, against
:class:`Group`:

* ``rank`` and ``size``;
* ``all_to_all(chunks [P, ...])``: ``out[q]`` is the chunk rank ``q`` sent
  to this rank;
* ``shift(x, s)``: send ``x`` to rank ``p + s`` and return the value rank
  ``p - s`` sent (``ppermute`` by ``s``), split into ``shift_start`` (posts
  the transfer, returns a :class:`Work`) and ``Work.wait()``, so a
  transfer can run under compute;
* ``all_reduce_sum``, ``all_gather`` (``[P, ...]``) and ``barrier``.

Transports:

* :class:`ProcessGroupComm`: a ``torch.distributed`` group, one rank a
  process (NCCL for CUDA tensors, gloo for CPU tensors):
  ``all_to_all_single`` on the uniform chunks, ``batch_isend_irecv`` for
  the shifts.  Neither backend takes int16 (gloo raises ``Invalid scalar
  type``, NCCL has no 16-bit integer type), so the narrow wire's int16 and
  int8 payloads travel as a bitcast ``uint8`` view of their last axis and
  are viewed back on receipt: bytes, never a cast.
* :class:`LocalMesh`: ``pods x data x iters`` ranks as threads of one
  process, all on one device, the counterpart of the reference's host-device mesh
  (``repro/launch/mesh.py:22``).  Its collectives exchange tensors through
  shared slots: the "wire" is a copy on the device (a shift clones what it
  sends; ``all_to_all`` and ``all_gather`` stack what they receive), so a
  received buffer is an allocation of its own, as it would be across
  cards, but no bytes cross a link.  All ranks launch onto the device's
  default stream, so a tensor posted before a rank meets another at a
  slot is complete, in stream order, before the other rank's reads.  The
  ``shift_start`` / ``wait`` split is kept, though nothing overlaps on one
  stream.  A rank that raises aborts every wait of the mesh, and a wait
  that outlasts the mesh's ``timeout`` raises: :meth:`LocalMesh.run`
  re-raises the first error on the caller and never hangs.

Every rank of a group must call the same collectives in the same order
(the SPMD contract of the reference's ``shard_map``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import torch

__all__ = [
    "Work",
    "Group",
    "SoloGroup",
    "LocalGroup",
    "LocalMesh",
    "ProcessGroupComm",
    "ProcessMesh",
    "RankContext",
    "MeshAborted",
    "current_rank",
]

#: seconds a LocalMesh rank waits at a slot or barrier before the mesh fails
DEFAULT_TIMEOUT_S = 600.0


class MeshAborted(RuntimeError):
    """A LocalMesh wait ended because another rank failed or timed out."""


class Work:
    """A posted transfer; :meth:`wait` returns what it received."""

    def __init__(self, wait_fn: Callable[[], torch.Tensor]):
        self._wait_fn = wait_fn
        self._out: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            self._out = self._wait_fn()
            self._wait_fn = None
        return self._out


class Group:
    """The collectives of one rank in a group of ``size`` ranks."""

    rank: int
    size: int

    def all_to_all(self, chunks: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def shift_start(self, x: torch.Tensor, s: int) -> Work:
        raise NotImplementedError

    def shift(self, x: torch.Tensor, s: int) -> torch.Tensor:
        return self.shift_start(x, s).wait()

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError


class SoloGroup(Group):
    """A group of one rank: every collective is local."""

    rank = 0
    size = 1

    def all_to_all(self, chunks):
        _check_chunks(chunks, 1)
        return chunks.clone()

    def shift_start(self, x, s):
        out = x.clone()
        return Work(lambda: out)

    def all_reduce_sum(self, x):
        return x.clone()

    def all_gather(self, x):
        return x[None].clone()

    def barrier(self):
        pass


def _check_chunks(chunks: torch.Tensor, size: int) -> None:
    if chunks.dim() < 1 or chunks.shape[0] != size:
        raise ValueError(f"all_to_all takes [P={size}, ...] chunks; got {tuple(chunks.shape)}")


# ---------------------------------------------------------------------------
# threads of one process
# ---------------------------------------------------------------------------


class _Hub:
    """What the threads of one group share: a mailbox keyed by (sequence
    number, destination, source), one condition a destination rank (so a
    post wakes only the rank it is for), and the mesh's abort state."""

    def __init__(self, size: int, mesh: "LocalMesh"):
        self.size = size
        self.mesh = mesh
        self.box: Dict[tuple, Any] = {}
        self.ready = [threading.Condition(mesh._lock) for _ in range(size)]
        mesh._conds.extend(self.ready)

    def post(self, key: tuple, value) -> None:
        with self.mesh._lock:
            self.box[key] = value
            self.ready[key[1]].notify()

    def take(self, key: tuple):
        mesh = self.mesh
        if mesh.turns:
            with mesh._lock:
                if key in self.box:
                    return self.box.pop(key)
            with mesh._yielded():  # a rank waiting for a peer lets the others run
                return self._wait(key)
        return self._wait(key)

    def _wait(self, key: tuple):
        mesh = self.mesh
        with mesh._lock:
            self.ready[key[1]].wait_for(lambda: key in self.box or mesh._failed is not None,
                                        timeout=mesh.timeout)
            if key in self.box:
                return self.box.pop(key)
            if mesh._failed is None:
                err = TimeoutError(f"a LocalMesh rank waited more than {mesh.timeout}s for a peer")
                mesh._fail(err)
                raise err
            raise MeshAborted(f"the mesh was aborted: {mesh._failed!r}")


class LocalGroup(Group):
    """One thread's view of a group of a :class:`LocalMesh`.

    Each collective takes the rank's next sequence number; every rank
    posts what it sends under (sequence, destination, source) and takes
    what it receives under its own rank, so the ranks of a group meet at
    each collective without a global barrier (``barrier`` aside)."""

    def __init__(self, hub: _Hub, rank: int):
        self._hub = hub
        self.rank = rank
        self.size = hub.size
        self._seq = 0

    def _next(self) -> int:
        self._seq += 1
        return self._seq

    def _exchange(self, outgoing: List[Any]) -> List[Any]:
        """Send ``outgoing[q]`` to rank ``q``; return what each rank sent here."""
        seq = self._next()
        for q, v in enumerate(outgoing):
            self._hub.post((seq, q, self.rank), v)
        return [self._hub.take((seq, self.rank, q)) for q in range(self.size)]

    def all_to_all(self, chunks):
        _check_chunks(chunks, self.size)
        got = self._exchange(list(chunks.unbind(0)))
        out = torch.stack(got)  # the wire: one copy into the received buffer
        # drop the peers' views before meeting, so that once past the barrier
        # no rank keeps another's chunks alive (a rank's `del` of what it
        # sent then frees it, as the dry-run's one-rank model assumes)
        del got
        # peers stacked the views this rank posted; meet once more so that
        # no rank writes into its chunks while a peer may still read them
        self.barrier()
        return out

    def shift_start(self, x, s):
        seq = self._next()
        p = self.rank
        # the wire: a copy of what is sent, so the sender may reuse ``x``
        self._hub.post((seq, (p + s) % self.size, p), x.clone())
        src = (p - s) % self.size
        return Work(lambda: self._hub.take((seq, p, src)))

    def all_reduce_sum(self, x):
        got = self._exchange([x] * self.size)
        out = got[0].clone()
        for y in got[1:]:  # rank order: every rank gets the same bits
            out += y
        got = y = None  # as all_to_all: no peer's input outlives the barrier
        self.barrier()
        return out

    def all_gather(self, x):
        got = self._exchange([x] * self.size)
        out = torch.stack(got)
        del got  # as all_to_all: no peer's input outlives the barrier
        self.barrier()
        return out

    def barrier(self):
        self._exchange([None] * self.size)


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank function sees: its data-axis group (the graph shards;
    the LM's batch and FSDP axis), its iteration-axis group (independent
    colorings; the LM's model axis, :attr:`model`), its device, and its pod
    group (the LM's second data-parallel axis, over which the weights are
    whole: a :class:`SoloGroup` where the mesh has no pod axis)."""

    data: Group
    iters: Group
    device: torch.device
    pod: Group = dataclasses.field(default_factory=SoloGroup)

    @property
    def model(self) -> Group:
        """The LM's tensor- and expert-parallel axis: the iteration axis, as
        the reference's ``make_local_mesh(data, model)`` names it."""
        return self.iters


_CURRENT = threading.local()


def current_rank() -> RankContext:
    """The :class:`RankContext` of the rank function running on this thread
    (inside ``LocalMesh.run`` / ``ProcessMesh.run``); raises outside one."""
    ctx = getattr(_CURRENT, "ctx", None)
    if ctx is None:
        raise RuntimeError("not inside a mesh's rank function (call it from mesh.run)")
    return ctx


def _run_as(ctx: RankContext, fn: Callable[[RankContext], Any]):
    """``fn(ctx)`` with ``ctx`` as this thread's :func:`current_rank`."""
    before = getattr(_CURRENT, "ctx", None)
    _CURRENT.ctx = ctx
    try:
        return fn(ctx)
    finally:
        _CURRENT.ctx = before


class LocalMesh:
    """``pods x data x iters`` ranks as threads of this process on one device.

    Rank ``(o, i, p)`` holds graph shard ``p`` of iteration slice ``i`` of
    pod ``o``; its data group is the ``data`` ranks of slice ``i`` of its
    pod, its iteration group the ``iters`` ranks of shard ``p`` of its pod,
    its pod group the ``pods`` ranks ``(*, i, p)``.  :meth:`run` runs a
    rank function on every rank and returns their results in rank order
    (``o``, then ``i``, major).  Any rank's exception aborts the others'
    waits and is re-raised here; a wait longer than ``timeout`` seconds
    fails the mesh the same way.  The pod axis is the LM's (the
    reference's multi-pod mesh); the counting engine refuses it.

    With ``turns`` one rank at a time runs host code: a rank holds the
    mesh's turn until it waits for a peer.  Every torch op releases and
    retakes the interpreter lock, so ranks that all launch many small ops
    otherwise hand the lock over at each op; taking turns hands it over at
    each wait.  The device work is the same (one stream either way).
    """

    def __init__(self, data: int = 1, iters: int = 1, *, pods: int = 1, device=None,
                 timeout: float = DEFAULT_TIMEOUT_S, turns: bool = False):
        from ..device import resolve_device

        if data < 1 or iters < 1 or pods < 1:
            raise ValueError(f"a mesh needs data >= 1, iters >= 1 and pods >= 1; got {data} x "
                             f"{iters} ({pods} pods)")
        self.data_size = int(data)
        self.iter_size = int(iters)
        self.pod_size = int(pods)
        self.device = resolve_device(device)
        self.timeout = float(timeout)
        self.turns = bool(turns)
        self._lock = threading.RLock()
        self._turn = threading.Lock()
        self._holding = threading.local()
        self._conds: List[threading.Condition] = []
        self._failed: Optional[BaseException] = None

    @property
    def size(self) -> int:
        return self.pod_size * self.data_size * self.iter_size

    def __repr__(self) -> str:
        pods = f"pods={self.pod_size}, " if self.pod_size > 1 else ""
        return (f"LocalMesh({pods}data={self.data_size}, iters={self.iter_size}, "
                f"device={self.device})")

    def _fail(self, err: BaseException) -> None:
        with self._lock:
            if self._failed is None:
                self._failed = err
            for cond in self._conds:
                cond.notify_all()

    @contextlib.contextmanager
    def _turn_held(self):
        """With ``turns``, hold the mesh's one turn to run host code."""
        if not self.turns:
            yield
            return
        self._turn.acquire()
        self._holding.on = True
        try:
            yield
        finally:
            self._holding.on = False
            self._turn.release()

    @contextlib.contextmanager
    def _yielded(self):
        """Give the turn up while this rank waits for a peer; take it back."""
        if not getattr(self._holding, "on", False):
            yield
            return
        self._holding.on = False
        self._turn.release()
        try:
            yield
        finally:
            self._turn.acquire()
            self._holding.on = True

    def _group(self, hub: Optional[_Hub], rank: int) -> Group:
        return SoloGroup() if hub is None else LocalGroup(hub, rank)

    def run(self, fn: Callable[[RankContext], Any]) -> List[Any]:
        """``fn(ctx)`` on every rank, one thread each; the results in rank order."""
        O, P, I = self.pod_size, self.data_size, self.iter_size
        self._failed = None
        self._conds = []
        data_hubs = [[_Hub(P, self) if P > 1 else None for _ in range(I)] for _ in range(O)]
        iter_hubs = [[_Hub(I, self) if I > 1 else None for _ in range(P)] for _ in range(O)]
        pod_hubs = [[_Hub(O, self) if O > 1 else None for _ in range(P)] for _ in range(I)]
        results: List[Any] = [None] * (O * P * I)

        def body(o: int, i: int, p: int) -> None:
            ctx = RankContext(self._group(data_hubs[o][i], p), self._group(iter_hubs[o][p], i),
                              self.device, self._group(pod_hubs[i][p], o))
            try:
                with self._turn_held():
                    results[(o * I + i) * P + p] = _run_as(ctx, fn)
            except BaseException as e:  # every failure fails the mesh
                self._fail(e)

        if O * P * I == 1:
            body(0, 0, 0)
        else:
            name = "LocalMesh rank " + ("({}, {}, {})" if O > 1 else "({1}, {2})")
            threads = [threading.Thread(target=body, args=(o, i, p), daemon=True,
                                        name=name.format(o, i, p))
                       for o in range(O) for i in range(I) for p in range(P)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if self._failed is not None:
            raise self._failed  # the first failure; the others only saw the abort
        return results


# ---------------------------------------------------------------------------
# torch.distributed
# ---------------------------------------------------------------------------


#: dtypes a process group carries as a bitcast byte view (see the module docstring)
_BYTE_VIEWED = (torch.int16, torch.int8)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) as the tensor the backend is handed."""
    return x.view(torch.uint8) if x.dtype in _BYTE_VIEWED else x


class ProcessGroupComm(Group):
    """A ``torch.distributed`` group, this process one rank of it.

    NCCL for CUDA tensors, gloo for CPU tensors (the group's backend must
    take the tensors it is given).  ``group=None`` is the world."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _peer(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def all_to_all(self, chunks):
        _check_chunks(chunks, self.size)
        chunks = chunks.contiguous()
        out = torch.empty_like(chunks)
        self._dist.all_to_all_single(_as_bytes(out), _as_bytes(chunks), group=self.group)
        return out

    def shift_start(self, x, s):
        s %= self.size
        if s == 0:  # to itself: no transfer
            out = x.clone()
            return Work(lambda: out)
        dist = self._dist
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, _as_bytes(x), self._peer((self.rank + s) % self.size),
                          self.group),
               dist.P2POp(dist.irecv, _as_bytes(buf), self._peer((self.rank - s) % self.size),
                          self.group)]
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()
            return buf

        return Work(wait)

    def all_reduce_sum(self, x):
        out = x.clone()
        self._dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x):
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(outs, x, group=self.group)
        return torch.stack(outs)

    def barrier(self):
        self._dist.barrier(group=self.group)


class ProcessMesh:
    """This process's rank of a ``torch.distributed`` job laid out as
    ``pods x iters x data`` (world rank ``(o * iters + i) * data + p``);
    see ``launch.mesh.process_mesh``.  :meth:`run` runs the rank function
    here and returns its result as a one-element list."""

    def __init__(self, data_group: Group, iter_group: Group, device: torch.device,
                 pod_group: Optional[Group] = None):
        self.data = data_group
        self.iters = iter_group
        self.pod = SoloGroup() if pod_group is None else pod_group
        self.data_size = data_group.size
        self.iter_size = iter_group.size
        self.pod_size = self.pod.size
        self.device = device

    @property
    def size(self) -> int:
        return self.pod_size * self.data_size * self.iter_size

    def __repr__(self) -> str:
        pods = f"pods={self.pod_size}, " if self.pod_size > 1 else ""
        rank = ((self.pod.rank,) if self.pod_size > 1 else ()) + (self.iters.rank, self.data.rank)
        return (f"ProcessMesh({pods}data={self.data_size}, iters={self.iter_size}, "
                f"rank={rank}, device={self.device})")

    def run(self, fn: Callable[[RankContext], Any]) -> List[Any]:
        return [_run_as(RankContext(self.data, self.iters, self.device, self.pod), fn)]


Mesh = Union[LocalMesh, ProcessMesh]
