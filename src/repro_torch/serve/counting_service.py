"""Counting-as-a-service: a resident multi-tenant subgraph-count engine.

The port's counterpart of ``repro/serve/counting_service.py``, with its
names, scheduling and contract; keys are the port's threefry keys
(:mod:`..core.prng`), and every pass runs the port's family program on the
service's device (``cuda`` unless the plan options say ``device="cpu"``).

The paper amortizes one expensive counting pass across a massive graph;
this module amortizes *across a request stream*: a :class:`CountingService`
loads a graph once, keeps compiled family plans in a signature-keyed LRU
cache (extending the cross-template interning of DESIGN.md §14 to
cross-*request* reuse), admits queries from named tenants through bounded
queues with deficit-round-robin fairness, and coalesces compatible pending
requests into shared-coloring family passes — one backend dispatch serves
every request that wants the same coloring stream.

Solo-equivalence contract
-------------------------
Every request's numbers are **bit-identical** to a stand-alone
``Counter.estimate`` / ``estimate_many`` call with the same
``(key, batch, n_colors=k, n_iter, delta, target_rsd)``.  Three properties
make that hold by construction rather than by coincidence:

* the per-call key stream is prefix-stable
  (:func:`~repro_torch.core.estimator.call_key` — ``fold_in(key, i)``), so call
  ``i``'s coloring never depends on any request's total budget;
* a compiled family's per-template sample columns depend only on the rooted
  sub-template's isomorphism class and the shared color budget ``k``
  (the §14 shared-``k`` contract), never on which *other* templates rode in
  the same pass — so coalescing mates cannot perturb each other;
* per-request stopping and aggregation reuse the estimator's own
  helpers (:func:`~repro_torch.core.estimator.relative_se`,
  :func:`~repro_torch.core.estimator.aggregate_single`) applied to the request's
  own banked samples, including during a mid-stream join: a late request
  backfills the pass history call by call, checking the stop rule before
  each consumed call, exactly as the solo loop would have.

Scheduling and the thread model (DESIGN.md §20)
-----------------------------------------------
The deterministic core is unchanged from §17: :meth:`CountingService.step`
performs one admission round plus one pass advance, chosen by deficit
round-robin over tenants, and ``run_until_idle`` drives the loop to
quiescence — single-stepped, reproducible, what the solo-equivalence and
coalescing tests check.

Production shape is layered *on top* of that core, never instead of it:
``start()`` runs the same ``step()`` on a background **driver thread**
(``stop()`` / ``join_idle()`` manage it), every public surface —
``submit``, ``Ticket`` reads, ``cancel``, ``stats`` — is safe to call from
any thread (one service ``RLock``; the lock is *released* around each
backend dispatch so submits and cancellations stay responsive while a pass
call runs), requests carry **deadlines** (``deadline_s``/``timeout_s``)
and support **cancellation** (``ticket.cancel()``), both of which detach
the request from its coalesced pass at a call boundary and leave a
terminal ``cancelled``/``deadline_exceeded`` status plus a partial,
solo-resumable :class:`~repro_torch.core.estimator.EstimatorState`.  Admission
is **backpressured** per tenant and globally (:class:`QueueFullError`
carries the tenant, depth/limit, and a retry-after hint; ``shed_oldest``
optionally evicts the oldest queued request instead of rejecting the new
one), and every pass call routes through a §16 :class:`Supervisor`, so a
faulted batch — raise, hang, NaN — quarantines or retries without killing
the co-riding requests or the driver thread.

Host and device (the port): the scheduler's state holds numpy only — the
pass history, the memo and tickets never hold a tensor — and each pass
call makes one host copy, the family sampler's ``.cpu()``.  The device is
resolved once, in the constructor, and every dispatch runs under it, so
the driver thread, the supervisor's worker thread and a client stepping
the service all launch onto the plan's device.  An evicted plan is
unreachable: its cache entry, its ``Counter`` family state and the
sampler closures that hold its tables go together.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import contextlib

import numpy as np
import torch

from ..api import Counter, CountResult, MultiCountResult
from ..core import prng
from ..core.estimator import (
    EstimatorState,
    aggregate_single,
    call_key,
    median_of_means,
    niter_bound,
    num_groups_for,
    relative_se,
    run_signature,
)
from ..core.graphs import Graph
from ..core.supervisor import (
    QuarantinedBatch,
    RetryPolicy,
    Supervisor,
    key_fingerprint,
)
from ..core.templates import (
    Tree,
    family_signature,
    path_tree,
    rooted_signature,
    template_program,
    template as resolve_template,
)
from ..device import resolve_device
from ..testing import faults

__all__ = [
    "ServiceConfig",
    "CountingService",
    "ServiceClient",
    "Ticket",
    "PlanCache",
    "ProgressUpdate",
    "QueueFullError",
    "UnsatisfiableRequestError",
    "CANCELLED",
    "DEADLINE_EXCEEDED",
    "SHED",
    "TERMINAL_STATUSES",
]

#: Ticket lifecycle: ``queued -> active -> <terminal>``.  ``done`` and
#: ``failed`` are §17's terminals; §20 adds the three control-plane ones.
CANCELLED = "cancelled"
DEADLINE_EXCEEDED = "deadline_exceeded"
SHED = "shed"
TERMINAL_STATUSES = frozenset({"done", "failed", CANCELLED, DEADLINE_EXCEEDED, SHED})


class QueueFullError(RuntimeError):
    """The service's bounded admission queue rejected a submit.

    Carries the backpressure signal the caller needs to react sensibly:
    which ``tenant`` hit which ``scope`` (``"tenant"`` or ``"service"``),
    the observed ``depth`` against the configured ``limit``, and a
    ``retry_after_s`` hint derived from the measured per-pass-call latency
    (how long the queue needs to drain one slot at the current service
    rate — a hint, not a promise).
    """

    def __init__(self, *, tenant: str, depth: int, limit: int,
                 retry_after_s: float, scope: str = "service"):
        self.tenant = tenant
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s
        self.scope = scope
        super().__init__(
            f"{scope} queue is full for tenant {tenant!r}: depth {depth} >= "
            f"limit {limit}; retry after ~{retry_after_s:.3g}s, or enable "
            f"ServiceConfig.shed_oldest to evict the oldest queued request"
        )

    def __repr__(self) -> str:
        return (f"QueueFullError(tenant={self.tenant!r}, scope={self.scope!r}, "
                f"depth={self.depth}, limit={self.limit}, "
                f"retry_after_s={self.retry_after_s:.3g})")


class UnsatisfiableRequestError(ValueError):
    """The request cannot be satisfied within the service's iteration budget.

    Raised at submit time — never discovered after hours of silent
    over-sampling — when an ``eps``-derived worst-case budget
    (:func:`~repro_torch.core.estimator.niter_bound`, exponential in the template
    size) or an explicit ``n_iter`` exceeds ``ServiceConfig.max_iters``.
    Carries the ``tenant``, the offending ``parameter`` name and ``value``,
    and the ``limit`` it overran.
    """

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 parameter: Optional[str] = None, value: Any = None,
                 limit: Optional[int] = None):
        super().__init__(message)
        self.tenant = tenant
        self.parameter = parameter
        self.value = value
        self.limit = limit

    def __repr__(self) -> str:
        return (f"UnsatisfiableRequestError(tenant={self.tenant!r}, "
                f"parameter={self.parameter!r}, value={self.value!r}, "
                f"limit={self.limit!r})")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Resident-service knobs.  All of these are part of service identity.

    ``batch`` is part of each request's *stream* identity (a backend call
    draws its colorings from ``(key, batch, n, k)``), so the solo-equivalent
    call must pass the same batch.  ``n_colors`` is pinned on the service,
    not per request: a fixed shared color budget is what lets any two
    requests share a coloring stream and what keeps a request's estimates
    independent of its coalescing mates.
    """

    batch: int = 8  # colorings per backend call (stream identity)
    max_iters: int = 100_000  # per-request iteration budget ceiling
    max_pending: int = 64  # bounded queue: queued + active requests
    max_active: int = 8  # requests concurrently attached to passes
    quantum: float = 1.0  # DRR deficit replenished per tenant visit
    plan_cache_capacity: int = 8  # LRU entries (compiled family plans)
    #: LRU entries of finished *results*: a re-submitted identical request
    #: (same family, key, batch, and budget — the full stream identity, so
    #: the answer is deterministic) returns the cached CountResult at
    #: submit time instead of recomputing its samples; 0 disables
    result_cache_capacity: int = 16
    seed: int = 0  # default request key = prng.key(seed)
    max_retries: Optional[int] = None  # pass-call retries (None = 0: no retry)
    #: bounded per-tenant queue (queued + active); None = only the global
    #: ``max_pending`` bound applies
    max_pending_per_tenant: Optional[int] = None
    #: under overload, evict the oldest *queued* request (terminal status
    #: ``"shed"``) instead of raising QueueFullError at the new submitter
    shed_oldest: bool = False
    #: per-pass-call supervisor timeout (§16 worker-thread hang detection);
    #: None disables — a genuinely hung backend then wedges its pass
    timeout_s: Optional[float] = None
    backoff_s: float = 0.05  # first-retry backoff of the pass supervisor
    poll_s: float = 0.02  # driver-thread idle poll (wake latency ceiling)


@dataclasses.dataclass(frozen=True)
class ProgressUpdate:
    """One streamed increment of a request's running estimate."""

    niter: int  # iterations banked so far
    estimates: Tuple[float, ...]  # per-template median-of-means so far
    rse: float  # worst-template relative standard error
    target_met: bool


class PlanCache:
    """Signature-keyed LRU over compiled family plans.

    Keys are :func:`~repro_torch.core.templates.family_signature` values — order-
    insensitive, label-insensitive — so a request hits whenever *any*
    earlier request compiled the same family, regardless of template order,
    vertex labeling, or tenant.  ``get`` returns the cached entry or builds
    one via the supplied builder; eviction notifies ``on_evict`` so the
    owner can drop its own per-family state too.
    """

    def __init__(self, capacity: int, on_evict=None):
        self.capacity = max(1, int(capacity))
        self._entries: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
        self._on_evict = on_evict
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, sig: tuple) -> bool:
        return sig in self._entries

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def get(self, sig: tuple, build) -> dict:
        entry = self._entries.get(sig)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(sig)
            return entry
        self.misses += 1
        entry = build()
        self._entries[sig] = entry
        while len(self._entries) > self.capacity:
            _, evicted = self._entries.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(evicted)
        return entry


@dataclasses.dataclass
class _Request:
    """Internal per-request state (the public view is :class:`Ticket`)."""

    ticket: "Ticket"
    tenant: str
    trees: Tuple[Tree, ...]  # as submitted (deduplicated by signature)
    sigs: Tuple[tuple, ...]  # rooted signature per tree
    n_iter: int
    delta: float
    eps: Optional[float]
    target_rsd: Optional[float]
    key: prng.Key
    key_fp: Tuple[int, ...]
    batch: int
    samples: np.ndarray  # [done, T_req] banked per-call estimates
    deadline: Optional[float] = None  # absolute, on the service clock
    quarantined: Tuple[QuarantinedBatch, ...] = ()
    cursor: int = 0  # backend calls consumed (absolute call index)
    satisfied: bool = False  # target_rsd hit (checked before each call)

    @property
    def n_calls(self) -> int:
        return -(-self.n_iter // self.batch)

    @property
    def is_multi(self) -> bool:
        return len(self.trees) > 1


class Ticket:
    """Handle on one submitted request: status, streamed progress, result.

    Thread-safe: every field the service mutates is written under the
    ticket lock and terminal transitions set an event, so any thread can
    ``wait(timeout=)`` for completion (requires a driver — ``svc.start()``
    — or another thread stepping the service), poll ``status``/``done``,
    or read the streamed ``updates`` while the driver runs.

    ``updates`` grows by one :class:`ProgressUpdate` per consumed backend
    call — the streaming surface; ``result()`` raises until the request is
    done.  ``state()`` exports a solo-compatible
    :class:`~repro_torch.core.estimator.EstimatorState` at any time — including
    after ``cancel()`` or a deadline expiry, which is what lets a
    ``--resume`` run pick the abandoned work back up bit-exactly — and
    ``checkpoint(dir)`` persists it where the stand-alone estimator's
    ``resume=DIR`` looks.
    """

    def __init__(self, ticket_id: int, tenant: str, templates: Tuple[str, ...]):
        self.id = ticket_id
        self.tenant = tenant
        self.templates = templates
        # queued | active | done | failed | cancelled | deadline_exceeded | shed
        self.status = "queued"
        self.updates: List[ProgressUpdate] = []
        self.error: Optional[str] = None
        self.submitted_at = time.perf_counter()
        self.finished_at: Optional[float] = None
        self._result = None
        self._request: Optional[_Request] = None
        self._service: Optional["CountingService"] = None
        self._lock = threading.Lock()
        self._done_evt = threading.Event()

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def progress(self) -> Optional[ProgressUpdate]:
        return self.updates[-1] if self.updates else None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the ticket reaches a terminal status; True if it did."""
        return self._done_evt.wait(timeout)

    def cancel(self) -> bool:
        """Cancel this request; True if the cancellation took effect.

        Cooperative and call-granular: a backend call already in flight
        completes (its samples are simply not consumed for this request),
        then the request detaches from its coalesced pass — co-riding
        requests are untouched.  The ticket lands in the terminal
        ``cancelled`` status with its partial progress still exported by
        ``state()``.  Returns False when the ticket was already terminal.
        """
        svc, req = self._service, self._request
        if svc is None or req is None:
            return False
        with svc._lock:
            if self.done:
                return False
            svc._terminate(req, CANCELLED, "cancelled by caller")
            return True

    def result(self):
        """The final estimate (CountResult / MultiCountResult shaped)."""
        if self.status == "failed":
            raise RuntimeError(f"request failed: {self.error}")
        if self.status in (CANCELLED, DEADLINE_EXCEEDED, SHED):
            raise RuntimeError(
                f"request is {self.status}"
                + (f" ({self.error})" if self.error else "")
                + "; partial progress is available via state()"
            )
        if self._result is None:
            raise RuntimeError(f"request is {self.status}; drive the "
                               f"service (step/run_until_idle) first")
        return self._result

    def state(self) -> EstimatorState:
        """Solo-compatible estimator state of the banked progress."""
        if self._request is None or self._service is None:
            raise RuntimeError("request has no banked state yet")
        return self._service._export_state(self._request)

    def checkpoint(self, directory: str) -> EstimatorState:
        """Persist ``state()`` where ``--resume DIR`` finds it.

        Writes one atomic, sha256-manifested checkpoint step (the §16
        format) at the request's call cursor, so a cancelled or
        deadline-expired ticket's partial work finishes under the
        stand-alone estimator: ``Counter.estimate(..., resume=DIR)`` with
        the solo-equivalent arguments is bit-identical to a never-submitted
        solo run.
        """
        from ..train.checkpoint import CheckpointManager

        st = self.state()
        mgr = CheckpointManager(directory)
        mgr.save(st.cursor, {"estimator": st.to_arrays()})
        return st

    def _finish(self, status: str, error: Optional[str] = None) -> None:
        with self._lock:
            if self.status in TERMINAL_STATUSES:
                return
            self.status = status
            if error is not None:
                self.error = error
            self.finished_at = time.perf_counter()
        self._done_evt.set()

    def __repr__(self) -> str:
        return (f"Ticket(#{self.id} {self.tenant}: "
                f"{','.join(self.templates)} [{self.status}])")


class _Pass:
    """One shared coloring stream: requests coalesced on (key, batch).

    ``history[i]`` banks call ``i``'s per-template columns by rooted
    signature (plus any quarantine record), which is what lets a late
    request join mid-stream: templates already riding the pass backfill
    for free; missing templates recompute their own columns at the same
    per-call keys (prefix-stable, so the values are the solo values).

    ``inflight`` marks a backend call dispatched with the service lock
    released (§20); the scheduler skips in-flight passes, and requests
    that join or leave meanwhile are reconciled at the call boundary.
    """

    def __init__(self, key: prng.Key, key_fp: Tuple[int, ...], batch: int):
        self.key = key
        self.key_fp = key_fp
        self.batch = batch
        self.requests: List[_Request] = []
        self.cursor = 0  # next call index
        self.history: List[dict] = []  # per call: {"cols": {sig: [b]}, "quarantine": ...}
        self.inflight = False

    def active(self) -> List[_Request]:
        return [r for r in self.requests
                if not r.satisfied and not r.ticket.done and r.cursor < r.n_calls]


class ServiceClient:
    """A tenant-bound view of a :class:`CountingService`.

    The convenience surface for callers that do not care about the
    scheduling loop: ``submit`` tags requests with the tenant name;
    ``count`` submits and drives the service until the request completes.
    """

    def __init__(self, service: "CountingService", tenant: str):
        self.service = service
        self.tenant = tenant

    def submit(self, templates, **kw) -> Ticket:
        return self.service.submit(self.tenant, templates, **kw)

    def count(self, templates, **kw):
        ticket = self.submit(templates, **kw)
        self.service.run_until(ticket)
        return ticket.result()


class CountingService:
    """A resident multi-tenant query engine over one loaded graph.

    Parameters
    ----------
    graph:
        The resident graph (loaded once; every request counts against it).
    n_colors:
        The service-wide shared color budget ``k``.  Fixed at construction:
        all passes, all plans, and all solo-equivalent calls use this
        ``k``, which is what makes coloring streams shareable and request
        results independent of coalescing.  Requests with templates larger
        than ``k`` are rejected.
    backend / plan_opts:
        Forwarded to the ``Counter`` facade — the service runs unmodified
        on the single-device and the distributed backend.
    config:
        :class:`ServiceConfig` (queue bounds, fairness, cache capacity,
        supervision, driver cadence).
    clock / sleep:
        Injectable time seams (default ``time.monotonic`` / ``time.sleep``)
        shared by request deadlines and the pass supervisor's
        backoff/timeout, so deadline- and retry-path tests run on a
        virtual clock instead of the wall.
    """

    def __init__(
        self,
        graph: Graph,
        *,
        n_colors: int,
        backend: str = "auto",
        plan_opts: Optional[Mapping[str, Any]] = None,
        config: Optional[ServiceConfig] = None,
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        self.graph = graph
        self.k = int(n_colors)
        self.config = config or ServiceConfig()
        opts = dict(plan_opts or {})
        opts["n_colors"] = self.k
        # resolved here, once: an index-less "cuda" reads the calling
        # thread's current device, and the driver thread must not resolve
        # it again
        mesh = opts.get("mesh")
        opts["device"] = mesh.device if mesh is not None else resolve_device(opts.get("device"))
        #: where every pass runs
        self.device = opts["device"]
        # the facade needs a representative template; the service only ever
        # builds family plans, so any tree within the budget works
        self._counter = Counter.from_graph(
            graph, path_tree(min(2, self.k) if self.k >= 2 else 1),
            backend=backend, **opts,
        )
        self.backend = self._counter.backend
        if self.backend == "distributed":
            self._counter._dist_ctx()  # the mesh too is built here, not in the driver
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep  # injectable: tests retry without waiting
        # every pass call is supervised (§16 taxonomy at the service level):
        # max_retries=None still means "no retries", but a faulted batch
        # quarantines instead of unwinding the scheduler/driver
        self._policy = RetryPolicy(
            max_retries=self.config.max_retries or 0,
            backoff_s=self.config.backoff_s,
            timeout_s=self.config.timeout_s,
        )

        def _evict(entry):
            self._counter._families.pop(entry["trees"], None)

        self.plan_cache = PlanCache(self.config.plan_cache_capacity, _evict)
        # finished-result memo: stream-identity key -> result snapshot (LRU)
        self._result_cache: "collections.OrderedDict[tuple, dict]" = (
            collections.OrderedDict()
        )
        self._rep: Dict[tuple, Tree] = {}  # rooted sig -> representative Tree
        self._passes: Dict[tuple, _Pass] = {}  # (key_fp) -> pass
        self._tenants: Dict[str, dict] = {}
        self._tenant_order: List[str] = []
        self._admit_ptr = 0
        self._drr_ptr = 0
        self._next_id = 1
        self.completed: List[Ticket] = []
        self._stats = collections.Counter()
        # ---- §20 concurrency plumbing
        self._lock = threading.RLock()
        self._driver: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._idle_evt = threading.Event()
        self.driver_errors: List[str] = []
        self._call_ewma_s: Optional[float] = None  # measured per-pass-call latency

    # ------------------------------------------------------------ admission
    def client(self, tenant: str) -> ServiceClient:
        return ServiceClient(self, tenant)

    def set_weight(self, tenant: str, weight: float) -> None:
        """DRR weight: a tenant's deficit grows by ``quantum * weight``."""
        with self._lock:
            self._tenant(tenant)["weight"] = float(weight)

    def _tenant(self, name: str) -> dict:
        st = self._tenants.get(name)
        if st is None:
            st = self._tenants[name] = {
                "queue": collections.deque(), "active": [],
                "deficit": 0.0, "weight": 1.0, "charged": 0,
            }
            self._tenant_order.append(name)
        return st

    def _pending(self) -> int:
        return sum(len(t["queue"]) + len(t["active"]) for t in self._tenants.values())

    def _retry_after(self, depth: int) -> float:
        """Backpressure hint: time to drain one queue slot at the measured
        service rate (EWMA of pass-call latency; a coarse prior pre-first-
        call)."""
        return (self._call_ewma_s if self._call_ewma_s is not None else 0.05) * max(1, depth)

    def submit(
        self,
        tenant: str,
        templates,
        *,
        n_iter: Optional[int] = None,
        eps: Optional[float] = None,
        delta: float = 0.1,
        target_rsd: Optional[float] = None,
        key: Optional[prng.Key] = None,
        deadline_s: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> Ticket:
        """Admit one query ``(templates, eps/n_iter, delta, target_rsd)``.

        Validation happens here, synchronously: an oversized template, an
        unsatisfiable ``eps``, or a full queue raise immediately — the
        queue only ever holds servable work.  ``key`` defaults to the
        service seed; requests sharing a key (the default) share one
        coloring stream and coalesce into one family pass.

        ``timeout_s`` (relative to now) / ``deadline_s`` (absolute, on the
        service clock) bound the request's lifetime: past the deadline it
        detaches from its pass at the next call boundary with terminal
        status ``deadline_exceeded`` and its partial state intact.  A
        deadline already expired at submit wins over everything — even a
        result-memo hit.
        """
        if isinstance(templates, (str, Tree)):
            templates = (templates,)
        trees_raw = tuple(resolve_template(t) if isinstance(t, str) else t for t in templates)
        if not trees_raw:
            raise ValueError("submit needs at least one template")
        for t in trees_raw:
            if t.n > self.k:
                raise ValueError(
                    f"template {t.name or t.n} has {t.n} vertices; the "
                    f"service color budget is k={self.k}"
                )
        # deduplicate by rooted signature (isomorphic duplicates share a
        # column; the ticket reports the deduplicated family)
        with self._lock:
            sigs, trees = [], []
            for t in trees_raw:
                s = rooted_signature(t)
                if s not in sigs:
                    sigs.append(s)
                    trees.append(t)
                    self._rep.setdefault(s, t)
            trees, sigs = tuple(trees), tuple(sigs)

            if n_iter is None and eps is not None:
                bound_k = trees[0].n if len(trees) == 1 else self.k
                n_iter = niter_bound(bound_k, eps, delta)
                if n_iter > self.config.max_iters:
                    raise UnsatisfiableRequestError(
                        f"tenant {tenant!r}: eps={eps} (delta={delta}) needs "
                        f"{n_iter} iterations (niter_bound at k={bound_k}); "
                        f"the service budget is "
                        f"max_iters={self.config.max_iters}.  Relax eps, raise "
                        f"the budget, or pass target_rsd for empirical stopping.",
                        tenant=tenant, parameter="eps", value=eps,
                        limit=self.config.max_iters,
                    )
            if n_iter is None:
                if target_rsd is None:
                    raise ValueError("pass n_iter, eps, or target_rsd")
                n_iter = self.config.max_iters
            if n_iter > self.config.max_iters:
                raise UnsatisfiableRequestError(
                    f"tenant {tenant!r}: n_iter={n_iter} exceeds the service "
                    f"budget max_iters={self.config.max_iters}",
                    tenant=tenant, parameter="n_iter", value=int(n_iter),
                    limit=self.config.max_iters,
                )
            if key is None:
                key = prng.key(self.config.seed)
            deadline = deadline_s
            if timeout_s is not None:
                rel = self._clock() + timeout_s
                deadline = rel if deadline is None else min(deadline, rel)
            names = tuple(t.name or f"tree{i}" for i, t in enumerate(trees))
            ticket = Ticket(self._next_id, tenant, names)
            self._next_id += 1
            req = _Request(
                ticket=ticket,
                tenant=tenant,
                trees=trees,
                sigs=sigs,
                n_iter=int(n_iter),
                delta=float(delta),
                eps=eps,
                target_rsd=target_rsd,
                key=key,
                key_fp=key_fingerprint(key),
                batch=self.config.batch,
                samples=np.zeros((0, len(trees)), np.float64),
                deadline=deadline,
            )
            ticket._request = req
            ticket._service = self
            self._stats["submitted"] += 1
            # a dead-on-arrival deadline beats even a memoized answer: the
            # caller asked for "by then or not at all", and "not at all"
            # must be reported honestly
            if req.deadline is not None and self._clock() >= req.deadline:
                self._terminate(req, DEADLINE_EXCEEDED, "deadline already expired at submit")
                return ticket
            if self._memo_hit(req):
                return ticket
            self._admission_check(tenant)
            self._tenant(tenant)["queue"].append(req)
        self._notify_work()
        return ticket

    def _admission_check(self, tenant: str) -> None:
        """Enforce the per-tenant and global queue bounds (lock held).

        Under ``shed_oldest``, overload evicts the oldest *queued* request
        (terminal status ``shed``) instead of rejecting the submitter;
        when nothing is shed-able (everything pending is active) the
        QueueFullError still raises.
        """
        cfg = self.config
        st = self._tenant(tenant)
        limit_t = cfg.max_pending_per_tenant
        if limit_t is not None:
            depth_t = len(st["queue"]) + len(st["active"])
            if depth_t >= limit_t and not (cfg.shed_oldest and self._shed_oldest(tenant)):
                raise QueueFullError(
                    tenant=tenant,
                    depth=depth_t,
                    limit=limit_t,
                    retry_after_s=self._retry_after(depth_t),
                    scope="tenant",
                )
        depth = self._pending()
        if depth >= cfg.max_pending and not (cfg.shed_oldest and self._shed_oldest()):
            raise QueueFullError(
                tenant=tenant,
                depth=depth,
                limit=cfg.max_pending,
                retry_after_s=self._retry_after(depth),
                scope="service",
            )

    def _shed_oldest(self, tenant: Optional[str] = None) -> bool:
        """Evict the oldest queued request (scoped to ``tenant`` if given)."""
        heads = [st["queue"][0]
                 for name, st in self._tenants.items()
                 if st["queue"] and (tenant is None or name == tenant)]
        if not heads:
            return False  # everything pending is active: nothing shed-able
        victim = min(heads, key=lambda r: r.ticket.id)
        self._terminate(victim, SHED,
                        "shed by the overload policy (shed_oldest) to admit newer work")
        return True

    def _notify_work(self) -> None:
        self._idle_evt.clear()
        self._wake.set()

    # ----------------------------------------------------------- result memo
    @staticmethod
    def _memo_key(req: _Request) -> tuple:
        # the full stream identity: same family (in submission order — the
        # result's template columns follow it), same coloring stream
        # (key, batch), same budget / stopping rule.  Anything less and the
        # cached answer would differ from a recomputation.
        return (req.sigs, req.key_fp, req.batch, req.n_iter, req.delta,
                req.eps, req.target_rsd)

    def _memo_hit(self, req: _Request) -> bool:
        """Serve ``req`` from the finished-result memo; True on a hit."""
        if self.config.result_cache_capacity < 1:
            return False
        snap = self._result_cache.get(self._memo_key(req))
        if snap is None:
            self._stats["result_misses"] += 1
            return False
        self._result_cache.move_to_end(self._memo_key(req))
        self._stats["result_hits"] += 1
        t = req.ticket
        # restore the request's sampling state too, so ticket.state()
        # exports the same solo-compatible EstimatorState a recomputation
        # would have produced
        req.samples = snap["samples"].copy()
        req.cursor = snap["cursor"]
        req.satisfied = snap["satisfied"]
        t._result = snap["result"]
        t._finish("done")
        self.completed.append(t)
        return True

    def _memo_store(self, req: _Request) -> None:
        # a degraded (quarantined) answer is never memoized; neither is a
        # cancelled/expired request's partial state (its _result is None
        # and it never reaches here — guarded for belt and braces)
        if (self.config.result_cache_capacity < 1 or req.quarantined
                or req.ticket.status != "done"):
            return
        self._result_cache[self._memo_key(req)] = {
            "result": req.ticket._result,
            "samples": req.samples.copy(),
            "cursor": req.cursor,
            "satisfied": req.satisfied,
        }
        while len(self._result_cache) > self.config.result_cache_capacity:
            self._result_cache.popitem(last=False)
            self._stats["result_evictions"] += 1

    # ---------------------------------------------------------- plan cache
    def _entry_for(self, sigs: Sequence[tuple]) -> dict:
        """Compiled family plan + sample_fn for a signature set (cached)."""
        canon = tuple(sorted(set(sigs)))
        trees = tuple(self._rep[s] for s in canon)
        fam_sig = family_signature(trees, n_colors=self.k)

        def build():
            st = self._counter._family(trees)
            return {
                "trees": trees,
                "sample_fn": st["sample_fn"],
                "columns": {s: i for i, s in enumerate(canon)},
                "sigs": canon,
            }

        return self.plan_cache.get(fam_sig, build)

    # ------------------------------------------------------------- sampling
    def _fault_sites(self, fn):
        """Wrap a family sample_fn with the §20 service fault sites.

        ``service.slow_pass`` stalls the dispatch (the supervisor's
        per-batch timeout fires, transient); ``service.pass_poison``
        corrupts the payload with NaN (§16 hard fault, quarantined without
        retry).  Inactive sites cost one ``is None`` check.

        The dispatch runs under the service's device, whichever thread
        makes it (the caller's, or the supervisor's worker under a
        timeout).
        """
        cuda = self.device.type == "cuda"

        def wrapped(key, batch):
            spec = faults.fire("service.slow_pass")
            if spec is not None:
                t = self.config.timeout_s
                self._sleep(spec.payload if spec.payload is not None else (4.0 * t if t else 0.25))
            with torch.cuda.device(self.device) if cuda else contextlib.nullcontext():
                out = np.asarray(fn(key, batch), np.float64)
            spec = faults.fire("service.pass_poison")
            if spec is not None:
                out = out.copy()
                out.reshape(-1)[0] = np.nan
            return out

        return wrapped

    def _call(self, entry: dict, key: prng.Key, batch: int, call_index: int):
        """One supervised backend dispatch over ``entry``'s family.

        Every pass call routes through a §16 :class:`Supervisor`: a raise,
        hang, or corrupt payload quarantines this one batch (or retries it
        at the SAME key, so a retried success is bit-identical) instead of
        unwinding the scheduler and every co-riding request.

        Returns ``(cols_by_sig, quarantine_record_or_None)``.
        """
        sup = Supervisor(self._fault_sites(entry["sample_fn"]), self._policy,
                         sleep=self._sleep, clock=self._clock)
        out = sup(key, batch, call_index=call_index)
        if isinstance(out, QuarantinedBatch):
            self._stats["quarantined"] += 1
            return {}, out
        out = np.asarray(out, np.float64)
        if out.ndim != 2:
            raise ValueError(f"family sample_fn must return [batch, T]; got {out.shape}")
        cols = {s: out[:, entry["columns"][s]] for s in entry["sigs"]}
        return cols, None

    def _consume(self, req: _Request, cols: Dict[tuple, np.ndarray],
                 quarantine: Optional[QuarantinedBatch]) -> None:
        """Bank one call's outcome into a request and stream an update."""
        if quarantine is not None:
            req.quarantined = req.quarantined + (quarantine,)
        else:
            chunk = np.stack([cols[s] for s in req.sigs], axis=1)
            req.samples = (chunk.copy() if req.samples.shape[0] == 0
                           else np.concatenate([req.samples, chunk], axis=0))
        req.cursor += 1
        done = int(req.samples.shape[0])
        if done:
            rse = relative_se(req.samples)
            ests = tuple(
                float(np.atleast_1d(median_of_means(
                    req.samples[:, i][: req.n_iter],
                    num_groups_for(req.delta, min(done, req.n_iter)),
                ))[0])
                for i in range(req.samples.shape[1])
            )
            req.ticket.updates.append(ProgressUpdate(
                niter=min(done, req.n_iter), estimates=ests, rse=rse,
                target_met=(req.target_rsd is not None
                            and rse <= req.target_rsd),
            ))

    def _stop_now(self, req: _Request) -> bool:
        """The solo loop's pre-call early-stop predicate, verbatim."""
        return req.target_rsd is not None and relative_se(req.samples) <= req.target_rsd

    # ------------------------------------------------------------ lifecycle
    def _expire_if_due(self, req: _Request) -> bool:
        """Terminate a past-deadline request; True when it left the flow
        (expired now, or already terminal — e.g. cancelled concurrently)."""
        if req.ticket.done:
            return True
        if req.deadline is not None and self._clock() >= req.deadline:
            self._terminate(req, DEADLINE_EXCEEDED,
                            f"deadline exceeded after {req.cursor} of "
                            f"{req.n_calls} calls")
            return True
        return False

    def _terminate(self, req: _Request, status: str, error: Optional[str] = None) -> None:
        """Move a request to a terminal control-plane status (cancelled /
        deadline_exceeded / shed): detach it from its queue, active slot,
        and coalesced pass — co-riders and the pass history are untouched,
        the mid-stream *leave* mirroring §17's mid-stream join — and keep
        its banked partial state for ``ticket.state()`` export."""
        t = req.ticket
        if t.done:
            return
        st = self._tenants.get(req.tenant)
        if st is not None:
            if req in st["queue"]:
                st["queue"].remove(req)
            if req in st["active"]:
                st["active"].remove(req)
        pa = self._passes.get(req.key_fp)
        if pa is not None and req in pa.requests:
            pa.requests.remove(req)
            if not pa.requests:
                self._maybe_drop_pass(pa)
        t._finish(status, error)
        self._stats[status] += 1
        self.completed.append(t)

    def _catch_up(self, req: _Request, pa: _Pass) -> bool:
        """Advance ``req`` through the pass's banked history — the
        mid-stream-join backfill (also run when a request joined while a
        call was in flight).  Applies the solo stop rule and the deadline
        check before each consumed call.  Returns True when the request
        reached a terminal state (and must not ride the pass further)."""
        own_entry = None
        while req.cursor < min(pa.cursor, req.n_calls):
            if self._expire_if_due(req):
                return True
            if self._stop_now(req):
                req.satisfied = True
                break
            i = req.cursor
            slot = pa.history[i]
            if slot["quarantine"] is not None:
                self._consume(req, {}, slot["quarantine"])
                continue
            have = slot["cols"]
            if all(s in have for s in req.sigs):
                self._stats["history_rides"] += 1
                self._consume(req, have, None)
                continue
            # recompute this call for the request's own family only —
            # prefix-stable keys make the values the solo values
            if own_entry is None:
                own_entry = self._entry_for(req.sigs)
            cols, q = self._call(own_entry, call_key(pa.key, i), pa.batch, call_index=i)
            self._stats["backfill_calls"] += 1
            have.update(cols)  # future joiners ride free
            self._consume(req, cols, q)
        if req.ticket.done:
            return True
        return self._finalize_if_done(req)

    def _attach(self, req: _Request) -> None:
        """Admit a request: join (or open) its key's pass, backfilling the
        pass history call by call with the solo stop rule applied before
        each consumed call — the mid-stream-join consistency contract."""
        req.ticket.status = "active"
        pa = self._passes.get(req.key_fp)
        if pa is None:
            pa = self._passes[req.key_fp] = _Pass(req.key, req.key_fp, req.batch)
        if self._catch_up(req, pa):
            if not pa.requests and not pa.active():
                self._maybe_drop_pass(pa)
            return
        pa.requests.append(req)

    def _maybe_drop_pass(self, pa: _Pass) -> None:
        if not pa.requests and not pa.inflight:
            self._passes.pop(pa.key_fp, None)

    def _finalize_if_done(self, req: _Request) -> bool:
        if req.satisfied or req.cursor >= req.n_calls:
            self._finalize(req)
            return True
        return False

    def _finalize(self, req: _Request) -> None:
        t = req.ticket
        if req.samples.reshape(-1)[: req.n_iter].shape[0] == 0:
            t._finish("failed",
                      f"all {len(req.quarantined)} batches were quarantined: "
                      + "; ".join(str(q) for q in req.quarantined))
            self._stats["failed"] += 1
            self.completed.append(t)
            self._remove_active(req)
            return
        elapsed = time.perf_counter() - t.submitted_at
        if not req.is_multi:
            mom, mean, rsd, used, ests = aggregate_single(req.samples, req.n_iter, req.delta)
            t._result = CountResult(
                estimate=mom,
                mean=mean,
                relative_sd=rsd,
                niter=used,
                samples=ests,
                backend=self.backend,
                template=t.templates[0],
                graph=self.graph.name,
                delta=req.delta,
                eps=req.eps,
                elapsed_s=elapsed,
                quarantined=req.quarantined,
            )
        else:
            ests = req.samples[: req.n_iter]
            used = int(ests.shape[0])
            mom = np.atleast_1d(median_of_means(ests, num_groups_for(req.delta, used)))
            means = ests.mean(axis=0)
            with np.errstate(divide="ignore", invalid="ignore"):
                rsds = np.where(means != 0, ests.std(axis=0) / np.abs(means), np.inf)
            entry = self._entry_for(req.sigs)  # cache hit: already compiled
            plan = self._counter._families[entry["trees"]]["plan"]
            dag = plan.dag if self.backend == "single" else plan.program
            t._result = MultiCountResult(
                templates=t.templates,
                estimates=mom,
                means=means,
                relative_sds=rsds,
                samples=ests,
                niter=used,
                backend=self.backend,
                graph=self.graph.name,
                k=self.k,
                unique_tables=len(dag.nodes),
                chain_tables=sum(len(template_program(tr).nodes) for tr in plan.templates),
                delta=req.delta,
                eps=req.eps,
                elapsed_s=elapsed,
                quarantined=req.quarantined,
            )
        t._finish("done")
        self._stats["completed"] += 1
        self.completed.append(t)
        self._memo_store(req)
        self._remove_active(req)

    def _remove_active(self, req: _Request) -> None:
        st = self._tenants.get(req.tenant)
        if st is not None and req in st["active"]:
            st["active"].remove(req)

    # ------------------------------------------------------------ the loop
    def _expire_sweep(self) -> None:
        """Expire past-deadline requests wherever they sit (queued work
        never touches a pass, so this is its only deadline checkpoint)."""
        for st in list(self._tenants.values()):
            for r in list(st["queue"]) + list(st["active"]):
                self._expire_if_due(r)

    def _admit_round(self) -> int:
        """Round-robin admission into free active slots."""
        n_active = sum(len(t["active"]) for t in self._tenants.values())
        admitted = 0
        order = self._tenant_order
        if not order:
            return 0
        visits = 0
        while n_active + admitted < self.config.max_active:
            if visits >= len(order):
                break
            name = order[self._admit_ptr % len(order)]
            self._admit_ptr += 1
            st = self._tenants[name]
            if not st["queue"]:
                visits += 1
                continue
            visits = 0
            req = st["queue"].popleft()
            st["active"].append(req)
            self._attach(req)  # may finalize (and deregister) immediately
            admitted += 1
        return admitted

    def _runnable(self, st: dict) -> List[_Request]:
        out = []
        for r in st["active"]:
            if r.ticket.done or r.satisfied or r.cursor >= r.n_calls:
                continue
            pa = self._passes.get(r.key_fp)
            if pa is not None and pa.inflight:
                continue  # a concurrent stepper owns this pass right now
            out.append(r)
        return out

    def step(self) -> bool:
        """One scheduling decision: admit, then advance one pass by one
        call on behalf of the deficit-round-robin-selected tenant.

        Deficit round-robin proper: each replenish round credits every
        *runnable* tenant ``quantum * weight``, and a tenant is served
        (one backend call each visit) for as long as its deficit lasts —
        a weight-3 tenant gets three calls per round to a weight-1
        tenant's one.  Idle tenants forfeit their deficit (the classic
        rule: credit never accumulates across idle periods).

        Thread-safe (the service lock is held except across the backend
        dispatch itself); the driver thread runs exactly this method.
        Returns ``False`` when the service is idle (nothing queued or
        active) — the ``run_until_idle`` termination condition.
        """
        with self._lock:
            spec = faults.fire("service.step_crash")
            if spec is not None:
                raise faults.InjectedFault("injected service step crash")
            self._expire_sweep()
            self._admit_round()
            order = self._tenant_order
            while order:
                for _ in range(len(order)):
                    name = order[self._drr_ptr % len(order)]
                    st = self._tenants[name]
                    runnable = self._runnable(st)
                    if runnable and st["deficit"] >= 1.0:
                        st["deficit"] -= 1.0
                        st["charged"] += 1
                        self._advance_pass(self._passes.get(runnable[0].key_fp))
                        self._drr_ptr += 1
                        return True
                    self._drr_ptr += 1
                # no tenant is both runnable and funded: replenish one round
                rates = []
                for name in order:
                    st = self._tenants[name]
                    if self._runnable(st):
                        inc = self.config.quantum * st["weight"]
                        st["deficit"] += inc
                        rates.append(inc)
                    else:
                        st["deficit"] = 0.0
                if not rates:
                    # nothing active; not idle while queued work remains
                    # (admission picks it up next step)
                    return self._pending() > 0
                if max(rates) <= 0:
                    raise RuntimeError(
                        "deadlock: every runnable tenant has a non-positive "
                        "DRR weight/quantum"
                    )
            return self._pending() > 0

    def _advance_pass(self, pa: _Pass) -> None:
        """One live backend call; every active request in the pass rides.

        The service lock is RELEASED across the dispatch itself (the §20
        responsiveness contract: submits, cancellations, and stats reads
        never wait on a backend call), so membership is reconciled at the
        call boundary: requests that joined while the call was in flight
        catch up through the banked history, requests that cancelled or
        expired mid-call simply do not consume it.
        """
        for r in list(pa.requests):
            if r.ticket.done or self._expire_if_due(r):
                if r in pa.requests:
                    pa.requests.remove(r)
                continue
            if r.cursor < pa.cursor:  # joined while a call was in flight
                if self._catch_up(r, pa):
                    pa.requests.remove(r)
                    continue
            if not r.satisfied and self._stop_now(r):
                r.satisfied = True
            if r.satisfied or r.cursor >= r.n_calls:
                self._finalize_if_done(r)
                pa.requests.remove(r)
        active = pa.active()
        if not active:
            self._maybe_drop_pass(pa)
            return
        union = tuple(sorted(set(s for r in active for s in r.sigs)))
        entry = self._entry_for(union)
        i = pa.cursor
        pa.inflight = True
        t0 = self._clock()
        self._lock.release()
        try:
            cols, q = self._call(entry, call_key(pa.key, i), pa.batch, call_index=i)
        finally:
            self._lock.acquire()
            pa.inflight = False
        dt = self._clock() - t0
        self._call_ewma_s = dt if self._call_ewma_s is None else 0.8 * self._call_ewma_s + 0.2 * dt
        pa.history.append({"cols": dict(cols), "quarantine": q})
        pa.cursor += 1
        self._stats["pass_calls"] += 1
        # only riders still attached at cursor i consume: a request
        # cancelled or expired while the call ran already detached
        riders = [r for r in active
                  if r in pa.requests and not r.ticket.done and r.cursor == i]
        self._stats["request_calls"] += len(riders)
        for r in riders:
            self._consume(r, cols, q)
            if self._stop_now(r):
                r.satisfied = True
            if r.satisfied or r.cursor >= r.n_calls:
                if self._finalize_if_done(r):
                    pa.requests.remove(r)
                continue
            self._expire_if_due(r)  # detaches via _terminate when due
        if not pa.requests:
            self._maybe_drop_pass(pa)

    def run_until_idle(self, max_steps: int = 1_000_000) -> List[Ticket]:
        """Drive the loop to quiescence; returns tickets completed so far.

        With a driver thread running this does not step (two schedulers
        would interleave nondeterministically) — it waits for the driver
        to drain instead.
        """
        if self.running:
            self.join_idle()
            return self.completed
        for _ in range(max_steps):
            if not self.step():
                break
        return self.completed

    def run_until(self, ticket: Ticket, max_steps: int = 1_000_000) -> Ticket:
        if self.running:
            ticket.wait()
            return ticket
        for _ in range(max_steps):
            if ticket.done or not self.step():
                break
        return ticket

    # ------------------------------------------------------- driver thread
    @property
    def running(self) -> bool:
        th = self._driver
        return th is not None and th.is_alive()

    def start(self) -> "CountingService":
        """Run the scheduling loop on a background driver thread.

        The thread drives the SAME deterministic ``step()`` the synchronous
        path uses; it parks on an event when idle (woken by ``submit``)
        and isolates scheduler faults: an exception out of ``step()`` is
        recorded in ``driver_errors`` / ``stats()['driver']`` and the
        loop continues — one poisoned scheduling round never kills the
        service (exercised by the ``service.step_crash`` fault site).
        """
        with self._lock:
            if self.running:
                return self
            self._stop_evt.clear()
            self._idle_evt.clear()
            self._driver = threading.Thread(
                target=self._drive, name="counting-service-driver", daemon=True
            )
            self._driver.start()
        return self

    def stop(self, join: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the driver thread (in-flight backend call completes first)."""
        self._stop_evt.set()
        self._wake.set()
        th = self._driver
        if join and th is not None and th is not threading.current_thread():
            th.join(timeout)

    def join_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the service is idle (no queued or active request);
        True on idle, False on timeout.  Without a driver this drains
        synchronously."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if not self.running:
                for _ in range(1_000_000):
                    if not self.step():
                        break
                return True
            if self._idle_evt.is_set():
                with self._lock:
                    if self._pending() == 0:
                        return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._idle_evt.wait(self.config.poll_s)

    def _drive(self) -> None:
        while not self._stop_evt.is_set():
            try:
                busy = self.step()
            except Exception as e:  # fault isolation: the driver never dies
                with self._lock:
                    self.driver_errors.append(f"{type(e).__name__}: {e}")
                    self._stats["driver_errors"] += 1
                busy = True
            if busy:
                self._idle_evt.clear()
                continue
            self._idle_evt.set()
            self._wake.wait(self.config.poll_s)
            self._wake.clear()
        self._idle_evt.set()

    # ------------------------------------------------------------ plumbing
    def _export_state(self, req: _Request) -> EstimatorState:
        """A solo-compatible EstimatorState for the request's progress.

        The signature matches what ``Counter.estimate`` (single template,
        ``n_colors=k``) / ``estimate_many`` computes for the same workload,
        so the exported state resumes under the stand-alone estimator —
        including the partial state of a cancelled or deadline-expired
        ticket, whose terminal status rides along as provenance."""
        with self._lock:
            g = self.graph
            if req.is_multi:
                names = ",".join(req.ticket.templates)
                what = f"family={names}|k={self.k}"
                extra = (f"{g.name}|V={g.n}|E={g.num_edges}|{what}|{self.backend}")
            else:
                extra = (f"{g.name}|V={g.n}|E={g.num_edges}|"
                         f"{req.ticket.templates[0]}|{self.backend}|k={self.k}")
            samples = req.samples if req.is_multi else req.samples.reshape(-1)
            return EstimatorState(
                signature=run_signature(req.n_iter, req.batch, req.delta, req.key, extra=extra),
                n_iter=req.n_iter,
                batch=req.batch,
                delta=req.delta,
                cursor=req.cursor,
                samples=samples.copy(),
                quarantined=req.quarantined,
                status=req.ticket.status,
            )

    def stats(self) -> dict:
        """Service counters: cache behavior, coalescing, fairness, volume,
        and the §20 control plane (backpressure depths, shed/cancel/expiry
        counts, driver health)."""
        with self._lock:
            s = dict(self._stats)
            pass_calls = s.get("pass_calls", 0)
            s["coalescing_factor"] = s.get("request_calls", 0) / pass_calls if pass_calls else 0.0
            s["cache"] = {
                "hits": self.plan_cache.hits,
                "misses": self.plan_cache.misses,
                "evictions": self.plan_cache.evictions,
                "hit_rate": self.plan_cache.hit_rate,
                "entries": len(self.plan_cache),
            }
            r_hits = s.get("result_hits", 0)
            r_total = r_hits + s.get("result_misses", 0)
            s["results"] = {
                "hits": r_hits,
                "misses": s.get("result_misses", 0),
                "evictions": s.get("result_evictions", 0),
                "hit_rate": r_hits / r_total if r_total else 0.0,
                "entries": len(self._result_cache),
            }
            limit_t = self.config.max_pending_per_tenant
            s["tenants"] = {}
            for name, st in self._tenants.items():
                depth = len(st["queue"]) + len(st["active"])
                limit = limit_t if limit_t is not None else self.config.max_pending
                s["tenants"][name] = {
                    "charged": st["charged"], "queued": len(st["queue"]),
                    "active": len(st["active"]), "weight": st["weight"],
                    # backpressure signals: how full this tenant's admission
                    # budget is and how long one slot takes to drain
                    "depth": depth, "limit": limit,
                    "saturation": depth / limit if limit else 0.0,
                    "retry_after_s": self._retry_after(depth),
                }
            s["driver"] = {
                "running": self.running,
                "errors": len(self.driver_errors),
            }
            return s
