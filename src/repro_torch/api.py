"""Counting API of the port: one ``Counter`` facade over two backends.

Counterpart of ``repro/api.py``:

>>> from repro_torch.api import Counter
>>> from repro_torch.core import prng
>>> counter = Counter.from_graph(g, "u5-2", backend="single")  # device="cuda"
>>> result = counter.estimate(n_iter=500, delta=0.1, key=prng.key(0))
>>> result.estimate, result.relative_sd

Backends:

``single``
    The in-core engine (:mod:`.core.count_engine`) on one device: ``cuda``
    unless the plan options say ``device="cpu"``; a missing card raises.
``distributed``
    The exchange engine (:mod:`.core.distributed`): vertex-sharded tables
    on a mesh (``mesh=``: a ``comm.LocalMesh`` of ``num_shards`` thread
    ranks on the device by default, or ``launch.mesh.process_mesh()``
    under an initialized ``torch.distributed`` world), the four exchange
    modes (``mode``, ``group_factor``, ``adaptive``), colorings drawn
    from the iteration keys whatever the shard count.
``auto``
    ``distributed`` when ``mesh=`` has more than one data rank, else
    ``single``.

Both are adapted to the estimator's protocol, ``sample_fn(key, batch) ->
float64 [batch]``, and every aggregate comes from :mod:`.core.estimator`,
so a result of the port can be held against the reference's for the same
key sample for sample.  :meth:`Counter.estimate_many` counts a template
family in one shared-DAG pass per batch of colorings (the family protocol,
``sample_fn(key, batch) -> float64 [batch, T]``).  ``compact=True`` runs
an active-frontier compacted plan (DESIGN.md §15) on either backend, which
re-runs a batch on its dense twin when a capacity overflows; on the
distributed backend it compacts the exchange too, and ``wire_dtype``
(``"int16"``, ``"int8"``) narrows the wire (§18), re-running a saturated
batch one rung wider.  Under a ``torch.distributed`` world every rank runs
the same estimator loop on replicated counts, and only rank 0 writes
checkpoints.  :meth:`Counter.serve` starts a resident multi-tenant
counting service (:mod:`.serve`) on the Counter's graph, and
:meth:`Counter.sample_stream` streams per-coloring estimate batches.

Plan construction is lazy: building a ``Counter`` is cheap; the first
counting call builds and caches the plan.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Union

import numpy as np

from .core import prng
from .core.count_engine import (
    build_counting_plan,
    build_multi_counting_plan,
    colorful_map_count,
    colorful_map_count_checked,
    colorful_map_count_many,
    colorful_map_count_many_checked,
    multi_sample_fn,
    plan_sample_fn,
)
from .core.estimator import EstimatorState, estimate_counts, estimate_counts_many, niter_bound
from .core.graphs import Graph
from .core.supervisor import RetryPolicy
from .core.templates import Template, Tree, template_program, template as resolve_template
from .kernels.ops import ROW_BLOCK
from .train.checkpoint import CheckpointManager

__all__ = [
    "CountRequest",
    "CountResult",
    "MultiCountResult",
    "Counter",
    "run",
    # serving layer (lazy re-exports; see module __getattr__)
    "CountingService",
    "ServiceClient",
    "ServiceConfig",
    "Ticket",
]

#: plan_opts the single backend passes to ``build_counting_plan``
#: (``n_colors`` widens the color budget past the template size: the
#: shared-k contract of family counting, see ``estimate_many``;
#: ``compact``/``density_threshold``/``capacity_factor``/``probes`` drive
#: active-frontier compaction, DESIGN.md §15)
_SINGLE_OPTS = frozenset({"root", "spmm_kind", "fuse", "n_colors", "device", "compact",
                          "density_threshold", "capacity_factor", "probes"})
#: plan_opts the distributed backend reads: the plan's
#: (:data:`_DIST_PLAN_OPTS`), the mesh's (``mesh``, ``num_shards``,
#: ``device``) and the count function's (:data:`_DIST_FN_OPTS`)
_DIST_PLAN_OPTS = frozenset({"root", "n_colors", "compact", "density_threshold",
                             "capacity_factor", "probes"})
_DIST_FN_OPTS = frozenset({"mode", "group_factor", "fuse", "wire_dtype", "adaptive"})
_DIST_OPTS = _DIST_PLAN_OPTS | _DIST_FN_OPTS | {"mesh", "num_shards", "device"}
#: the reference's options that have no effect on the port: accepted, so
#: that one config row feeds either backend, and dropped (``impl``: there is
#: one route a device; ``bucket_tile``: the port keeps bucket CSRs, not
#: tiles; ``data_axis``/``iter_axis``: a mesh's axes are fixed);
#: ``block_size`` must be 128
_OTHER_OPTS = frozenset({"block_size", "bucket_tile", "impl", "data_axis", "iter_axis"})
#: what :meth:`Counter.with_options` may swap (the reference's set)
_WITH_OPTS = frozenset({"mode", "group_factor", "impl", "fuse", "iter_axis", "bucket_tile",
                        "wire_dtype", "adaptive"})


@dataclasses.dataclass(frozen=True)
class CountRequest:
    """A fully specified counting job: what to count, where, how hard.

    ``plan_opts`` may carry options of either backend (a config row
    resolves to one request); the facade keeps the subset its backend
    understands and rejects keys neither knows.
    """

    graph: Graph
    template: Union[str, Tree, Template]
    backend: str = "auto"
    n_iter: Optional[int] = None
    eps: Optional[float] = None
    delta: float = 0.1
    batch: Optional[int] = None
    plan_opts: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    #: robustness spec (DESIGN.md §16): bounded retry of transient sample
    #: faults, checkpoint cadence (iterations; needs a checkpoint dir at run
    #: time), and optional early stop at a target relative standard error
    max_retries: Optional[int] = None
    checkpoint_every: int = 0
    target_rsd: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class CountResult:
    """Estimate plus the provenance needed to read it."""

    estimate: float  # median-of-means copy estimate (the paper's output)
    mean: float  # plain mean estimate
    relative_sd: float  # empirical RSD of per-iteration estimates
    niter: int
    samples: np.ndarray  # per-iteration copy estimates
    backend: str
    template: str
    graph: str
    delta: float
    eps: Optional[float]
    elapsed_s: float
    #: batches the supervisor gave up on (QuarantinedBatch records); their
    #: iterations are excluded from the aggregates above
    quarantined: tuple = ()
    #: iterations restored from a checkpoint before this call ran
    resumed_from: int = 0

    def __str__(self) -> str:
        extra = ""
        if self.resumed_from:
            extra += f", resumed at {self.resumed_from}"
        if self.quarantined:
            extra += f", {len(self.quarantined)} batch(es) quarantined"
        return (
            f"CountResult({self.template} in {self.graph or 'graph'}: "
            f"{self.estimate:.6g} via {self.backend}, "
            f"RSD {self.relative_sd:.2f}, {self.niter} colorings, "
            f"{self.elapsed_s:.2f}s{extra})"
        )


@dataclasses.dataclass(frozen=True)
class MultiCountResult:
    """One family run: per-template estimates from shared colorings.

    Array fields are indexed ``[template]`` (``samples`` is ``[niter,
    template]``); ``result[i]`` is template ``i``'s view as a
    :class:`CountResult`.  ``unique_tables``/``chain_tables`` record the
    reuse the compiled DAG achieved: unique tables computed per coloring
    against the sum of the per-template programs' nodes.
    """

    templates: tuple  # template names
    estimates: np.ndarray  # [T] median-of-means copy estimates
    means: np.ndarray  # [T]
    relative_sds: np.ndarray  # [T]
    samples: np.ndarray  # [niter, T] per-iteration copy estimates
    niter: int
    backend: str
    graph: str
    k: int  # shared color budget
    unique_tables: int  # nodes in the deduplicated DAG
    chain_tables: int  # sum of per-template program nodes
    delta: float
    eps: Optional[float]
    elapsed_s: float
    quarantined: tuple = ()  # excluded batches (shared by all templates)
    resumed_from: int = 0  # iterations restored from checkpoint

    def __len__(self) -> int:
        return len(self.templates)

    def __getitem__(self, i: int) -> CountResult:
        return CountResult(
            estimate=float(self.estimates[i]),
            mean=float(self.means[i]),
            relative_sd=float(self.relative_sds[i]),
            niter=self.niter,
            samples=self.samples[:, i],
            backend=self.backend,
            template=self.templates[i],
            graph=self.graph,
            delta=self.delta,
            eps=self.eps,
            elapsed_s=self.elapsed_s,
            quarantined=self.quarantined,
            resumed_from=self.resumed_from,
        )

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __str__(self) -> str:
        per = ", ".join(f"{t}={e:.6g}" for t, e in zip(self.templates, self.estimates))
        return (
            f"MultiCountResult({per} in {self.graph or 'graph'} via "
            f"{self.backend}, k={self.k}, {self.unique_tables}/"
            f"{self.chain_tables} unique tables, {self.niter} colorings, "
            f"{self.elapsed_s:.2f}s)"
        )


def _retry_policy(retry: Optional[RetryPolicy], max_retries: Optional[int]) -> Optional[RetryPolicy]:
    if retry is not None:
        return retry
    if max_retries is not None:
        return RetryPolicy(max_retries=max_retries)
    return None


def _resolve_checkpointing(checkpoint, resume):
    """Normalize the (checkpoint, resume) knobs into (manager, state).

    ``checkpoint`` is a directory path or a ready :class:`CheckpointManager`;
    ``resume`` is a bool (use the checkpoint's latest readable state) or a
    directory path (which doubles as the checkpoint destination, the
    ``--resume DIR`` contract).
    """
    if isinstance(resume, (str, os.PathLike)):
        checkpoint = checkpoint if checkpoint is not None else resume
        resume = True
    mgr = None
    if checkpoint is not None:
        mgr = checkpoint if isinstance(checkpoint, CheckpointManager) \
            else CheckpointManager(str(checkpoint))
    state = None
    if resume:
        if mgr is None:
            raise ValueError(
                "resume requires a checkpoint directory (checkpoint=DIR or "
                "resume=DIR) or a CheckpointManager"
            )
        latest = mgr.load_latest()
        if latest is not None:
            state = EstimatorState.from_arrays(latest[1]["estimator"])
    return mgr, state


def _resolve_backend(backend: str, plan_opts: Mapping[str, Any]) -> str:
    if backend == "auto":
        mesh = plan_opts.get("mesh")
        return "distributed" if mesh is not None and mesh.data_size > 1 else "single"
    if backend not in ("single", "distributed"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


class _ReadOnlyCheckpoint:
    """A checkpoint manager that restores but never writes: every rank of a
    ``torch.distributed`` world resumes from the same directory, and rank
    0 alone writes it."""

    def __init__(self, mgr: CheckpointManager):
        self._mgr = mgr

    def load_latest(self, *args, **kwargs):
        return self._mgr.load_latest(*args, **kwargs)

    def save(self, *args, **kwargs):
        return None


def _writes_checkpoints() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class Counter:
    """Facade: one object that counts a template in a graph.

    Construct with :meth:`from_graph` (or :meth:`from_request`); then

    * :meth:`estimate` — the (eps, delta) estimator (Algorithm 1);
    * :meth:`estimate_many` — a whole template family in one pass over the
      shared sub-template DAG per coloring;
    * :meth:`count_one` — one coloring iteration from a key;
    * :meth:`count_coloring` — exact colorful map count for a FIXED
      coloring (oracle testing); :meth:`count_coloring_many` its family
      analogue;
    * :attr:`sample_fn` — the raw backend protocol, for warm-up and for
      composing with other aggregators; :meth:`sample_stream` — its
      endless keyed stream;
    * :meth:`serve` — a resident multi-tenant counting service on the
      graph.
    """

    def __init__(self, graph: Graph, tree: Union[Tree, Template], backend: str,
                 plan_opts: Dict[str, Any]):
        self.graph = graph
        self.tree = tree
        self.backend = backend
        self.plan_opts = plan_opts
        self._plan = None
        self._sample_fn = None
        self._coloring_state: Dict[str, Any] = {}  # distributed: fixed-coloring count fn
        self._mesh = None
        self._plan_kw: Dict[str, Any] = {}
        self._fn_kw: Dict[str, Any] = {}
        self._families: Dict[tuple, Dict[str, Any]] = {}

    # ------------------------------------------------------------- builders
    @classmethod
    def from_graph(
        cls,
        graph: Graph,
        template: Union[str, Tree, Template],
        *,
        backend: str = "auto",
        **plan_opts: Any,
    ) -> "Counter":
        """Build a counter for ``template`` (a registered name, a Tree or a
        treewidth-2 Template) over ``graph``.

        ``plan_opts`` may mix options of both backends; keys the resolved
        backend does not read are dropped, keys unknown to both raise.
        ``device`` (default ``cuda``) picks where the plan (and a default
        mesh) lives.  Block patches are the kernel's 128x128 tile, so the
        reference's ``block_size`` takes no other value.
        """
        unknown = set(plan_opts) - (_SINGLE_OPTS | _DIST_OPTS | _OTHER_OPTS)
        if unknown:
            raise TypeError(f"unknown plan_opts: {sorted(unknown)}")
        tree = resolve_template(template) if isinstance(template, str) else template
        resolved = _resolve_backend(backend, plan_opts)
        if plan_opts.get("block_size", ROW_BLOCK) != ROW_BLOCK:
            raise ValueError(f"block patches are {ROW_BLOCK}x{ROW_BLOCK}; "
                             f"got block_size={plan_opts['block_size']}")
        keep = _SINGLE_OPTS if resolved == "single" else _DIST_OPTS
        opts = {k: v for k, v in plan_opts.items() if k in keep}
        return cls(graph, tree, resolved, opts)

    @classmethod
    def from_request(cls, request: CountRequest) -> "Counter":
        return cls.from_graph(request.graph, request.template, backend=request.backend,
                              **dict(request.plan_opts))

    def with_options(self, **overrides: Any) -> "Counter":
        """A new Counter sharing this one's plan and mesh, with other
        execution options (distributed backend only): ``mode``,
        ``group_factor``, ``fuse``, ``adaptive``, ``wire_dtype``, so that
        comparing the four exchange modes or the wires costs one plan
        build; the count function is built anew.  The
        reference's ``impl``, ``iter_axis`` and ``bucket_tile`` are taken
        and have no effect (the port has one route a device, a mesh's own
        axes and bucket CSRs, not tiles)."""
        if self.backend != "distributed":
            raise ValueError(f"with_options is for the distributed backend; this Counter uses "
                             f"the {self.backend!r} backend")
        bad = set(overrides) - _WITH_OPTS
        if bad:
            raise TypeError(f"with_options on the distributed backend only swaps "
                            f"{sorted(_WITH_OPTS)}; got {sorted(bad)}")
        plan = self.plan  # built here once, shared
        fn_over = {k: v for k, v in overrides.items() if k in _DIST_FN_OPTS}
        clone = Counter(self.graph, self.tree, self.backend, {**self.plan_opts, **fn_over})
        clone._plan, clone._mesh, clone._plan_kw = plan, self._mesh, self._plan_kw
        clone._fn_kw = {**self._fn_kw, **fn_over}
        return clone

    # ------------------------------------------------------------- plumbing
    @property
    def k(self) -> int:
        return self.tree.n

    def _dist_ctx(self) -> None:
        """Resolve the mesh and split the options, once: shared by the
        single-template plan and the family plans."""
        if self._mesh is not None:
            return
        from .comm import LocalMesh
        from .launch.mesh import process_mesh

        opts = dict(self.plan_opts)
        mesh = opts.pop("mesh", None)
        num_shards = opts.pop("num_shards", None)
        device = opts.pop("device", None)
        if mesh is None:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
                mesh = process_mesh(device=device)
            else:
                mesh = LocalMesh(num_shards or 1, device=device)
        elif num_shards and mesh.data_size != num_shards:
            raise ValueError(f"num_shards={num_shards} does not match the mesh's "
                             f"{mesh.data_size} data ranks")
        self._plan_kw = {k: v for k, v in opts.items() if k in _DIST_PLAN_OPTS}
        self._fn_kw = {k: v for k, v in opts.items() if k in _DIST_FN_OPTS}
        self._mesh = mesh

    @property
    def mesh(self):
        """The distributed backend's mesh (resolved on first use)."""
        self._dist_ctx()
        return self._mesh

    @property
    def plan(self):
        """The lazily built plan: a :class:`~.core.count_engine.CountingPlan`
        or, distributed, a :class:`~.core.distributed.DistributedPlan`."""
        if self._plan is None:
            if self.backend == "single":
                self._plan = build_counting_plan(self.graph, self.tree, **self.plan_opts)
            else:
                from .core.distributed import build_distributed_plan

                self._dist_ctx()
                self._plan = build_distributed_plan(self.graph, self.tree, self._mesh.data_size,
                                                    device=self._mesh.device, **self._plan_kw)
        return self._plan

    @property
    def sample_fn(self):
        """The backend protocol: ``sample_fn(key, batch) -> float64 [batch]``.

        Calling it once before timing a run builds and loads the kernels
        outside the measurement.
        """
        if self._sample_fn is None:
            if self.backend == "single":
                self._sample_fn = plan_sample_fn(self.plan)
            else:
                from .core.distributed import keyed_sample_fn

                self._sample_fn = keyed_sample_fn(self.plan, self._mesh, **self._fn_kw)
        return self._sample_fn

    def _checkpoint(self, checkpoint, resume):
        mgr, state = _resolve_checkpointing(checkpoint, resume)
        if mgr is not None and not _writes_checkpoints():
            mgr = _ReadOnlyCheckpoint(mgr)
        return mgr, state

    def _distributed_coloring(self, st: Dict[str, Any], plan, coloring: np.ndarray):
        """A fixed coloring through the distributed count function, laid out
        by shard and repeated over the mesh's iteration ranks."""
        from .core.distributed import make_count_fn, shard_coloring

        if st.get("coloring_fn") is None:
            st["coloring_fn"] = make_count_fn(plan, self._mesh, **self._fn_kw)
        cols = np.broadcast_to(shard_coloring(plan, coloring)[None],
                               (self._mesh.iter_size, plan.num_shards, plan.n_loc_pad))
        return st["coloring_fn"](cols)[0]

    @property
    def scale(self) -> float:
        """``k^t (k-t)! / k! / |Aut|``: maps colorful map counts to copy estimates."""
        return self.plan.scale

    def _signature_extra(self, *, family=None, k: Optional[int] = None) -> str:
        """Workload identity for checkpoint/resume safety (the reference's
        string, so the two packages sign the same run alike).  A widened
        color budget (``n_colors``) changes the coloring stream and is part
        of the identity."""
        what = f"family={','.join(family)}|k={k}" if family else self.tree.name
        extra = (f"{self.graph.name}|V={self.graph.n}|"
                 f"E={self.graph.num_edges}|{what}|{self.backend}")
        n_colors = self.plan_opts.get("n_colors")
        if not family and n_colors is not None:
            extra += f"|k={n_colors}"
        return extra

    # ------------------------------------------------------------- counting
    def estimate(
        self,
        n_iter: Optional[int] = None,
        *,
        eps: Optional[float] = None,
        delta: float = 0.1,
        key: Optional[prng.Key] = None,
        batch: Optional[int] = None,
        progress: bool = False,
        target_rsd: Optional[float] = None,
        checkpoint=None,
        checkpoint_every: int = 0,
        resume: Union[bool, str] = False,
        retry: Optional[RetryPolicy] = None,
        max_retries: Optional[int] = None,
    ) -> CountResult:
        """(eps, delta)-estimate of the copy count (Algorithm 1).

        ``n_iter`` defaults to ``niter_bound(k, eps, delta)`` when ``eps``
        is given; ``key`` defaults to ``prng.key(0)``; ``batch`` colorings
        run per backend call (default ``min(8, n_iter)``).

        Robustness (DESIGN.md §16): ``checkpoint=DIR`` with
        ``checkpoint_every=N`` persists the estimator state every N
        iterations; ``resume=True`` (or ``resume=DIR``) continues a killed
        run from the latest readable checkpoint and returns the result an
        uninterrupted run gives, bit for bit.  ``max_retries``/``retry``
        supervise the backend: transient faults retry with the same key,
        corrupt payloads (NaN/Inf/negative) hard-fault, persistently
        failing batches are quarantined and reported on the result.
        """
        if n_iter is None:
            if eps is None:
                raise ValueError("pass n_iter or eps (to derive the bound)")
            n_iter = niter_bound(self.k, eps, delta)
        if key is None:
            key = prng.key(0)
        b = batch or min(8, n_iter)
        sample = self.sample_fn  # builds the plan
        mgr, state = self._checkpoint(checkpoint, resume)
        t0 = time.perf_counter()
        est = estimate_counts(
            sample,
            n_iter,
            key,
            delta=delta,
            batch=b,
            progress=progress,
            retry=_retry_policy(retry, max_retries),
            checkpoint=mgr,
            checkpoint_every=checkpoint_every,
            resume=state,
            target_rsd=target_rsd,
            signature_extra=self._signature_extra(),
        )
        return CountResult(
            estimate=est.estimate,
            mean=est.mean,
            relative_sd=est.relative_sd,
            niter=est.niter,
            samples=est.samples,
            backend=self.backend,
            template=self.tree.name,
            graph=self.graph.name,
            delta=delta,
            eps=eps,
            elapsed_s=time.perf_counter() - t0,
            quarantined=est.quarantined,
            resumed_from=est.resumed_from,
        )

    def count_one(self, key: prng.Key) -> float:
        """One coloring iteration: an unbiased copy estimate from ``key``."""
        return float(self.sample_fn(key, 1)[0])

    def count_coloring(self, coloring: np.ndarray) -> float:
        """Exact colorful map count for a FIXED coloring ``[n]``; multiply
        by :attr:`scale` for the per-iteration copy estimate.  A compacted
        plan runs its compact program and, on overflow, the dense one."""
        coloring = np.asarray(coloring, np.int32).reshape(-1)
        if coloring.shape[0] != self.graph.n:
            raise ValueError(f"coloring has {coloring.shape[0]} entries, "
                             f"graph has {self.graph.n} vertices")
        if self.backend == "distributed":
            return float(self._distributed_coloring(self._coloring_state, self.plan, coloring))
        maps, ok = colorful_map_count_checked(self.plan, coloring)
        if not bool(ok):  # a capacity overflowed: the dense program
            maps = colorful_map_count(self.plan, coloring)
        return float(maps)

    # ------------------------------------------------------- family counting
    def _family(self, templates) -> Dict[str, Any]:
        """Build (and cache) the shared-DAG plan of a template family: one
        table-program pass per batch of colorings counts every member."""
        trees = tuple(resolve_template(t) if isinstance(t, str) else t for t in templates)
        if not trees:
            raise ValueError("estimate_many needs at least one template")
        st = self._families.get(trees)
        if st is None:
            if self.backend == "single":
                keep = {k: v for k, v in self.plan_opts.items() if k != "root"}
                plan = build_multi_counting_plan(self.graph, trees, **keep)
                sample_fn = multi_sample_fn(plan)
            else:
                from .core.distributed import build_distributed_plan, keyed_sample_fn

                self._dist_ctx()
                keep = {k: v for k, v in self._plan_kw.items() if k != "root"}
                plan = build_distributed_plan(self.graph, trees, self._mesh.data_size,
                                              device=self._mesh.device, **keep)
                sample_fn = keyed_sample_fn(plan, self._mesh, **self._fn_kw)
            st = self._families[trees] = {"plan": plan, "sample_fn": sample_fn}
        return st

    def estimate_many(
        self,
        templates,
        n_iter: Optional[int] = None,
        *,
        eps: Optional[float] = None,
        delta: float = 0.1,
        key: Optional[prng.Key] = None,
        batch: Optional[int] = None,
        progress: bool = False,
        target_rsd: Optional[float] = None,
        checkpoint=None,
        checkpoint_every: int = 0,
        resume: Union[bool, str] = False,
        retry: Optional[RetryPolicy] = None,
        max_retries: Optional[int] = None,
    ) -> MultiCountResult:
        """(eps, delta)-estimates for a whole template family in one pass.

        Every batch of colorings runs the family's deduplicated DAG once:
        sub-template tables shared across templates are computed a single
        time and every template root reads its own entry.  All templates
        share one coloring of ``k = max template size`` colors (or
        ``n_colors``), and each gets its own scale ``k^t (k-t)!/k!/|Aut|``.
        With the same ``key``, :meth:`estimate` on a Counter built with
        ``n_colors=k`` sees the identical colorings, so the two agree sample
        for sample.  The robustness keywords behave as on :meth:`estimate`;
        the checkpoint banks the ``[iter, T]`` sample matrix, and
        ``target_rsd`` gates on the worst template.
        """
        st = self._family(templates)
        plan = st["plan"]
        if n_iter is None:
            if eps is None:
                raise ValueError("pass n_iter or eps (to derive the bound)")
            n_iter = niter_bound(plan.k, eps, delta)
        if key is None:
            key = prng.key(0)
        b = batch or min(8, n_iter)
        chain_tables = sum(len(template_program(t).nodes) for t in plan.templates)
        names = tuple(t.name or f"tree{i}" for i, t in enumerate(plan.templates))
        dag = plan.dag if self.backend == "single" else plan.program
        mgr, state = self._checkpoint(checkpoint, resume)
        t0 = time.perf_counter()
        est = estimate_counts_many(
            st["sample_fn"],
            n_iter,
            key,
            delta=delta,
            batch=b,
            progress=progress,
            retry=_retry_policy(retry, max_retries),
            checkpoint=mgr,
            checkpoint_every=checkpoint_every,
            resume=state,
            target_rsd=target_rsd,
            signature_extra=self._signature_extra(family=names, k=plan.k),
        )
        return MultiCountResult(
            templates=names,
            estimates=est.estimates,
            means=est.means,
            relative_sds=est.relative_sds,
            samples=est.samples,
            niter=est.niter,
            backend=self.backend,
            graph=self.graph.name,
            k=plan.k,
            unique_tables=len(dag.nodes),
            chain_tables=chain_tables,
            delta=delta,
            eps=eps,
            elapsed_s=time.perf_counter() - t0,
            quarantined=est.quarantined,
            resumed_from=est.resumed_from,
        )

    def count_coloring_many(self, templates, coloring: np.ndarray) -> np.ndarray:
        """Exact per-template colorful map counts for a FIXED coloring ``[n]``
        drawn from the family's shared ``k`` colors: float64
        ``[num_templates]``; multiply by the family plan's ``scales`` for
        copy estimates."""
        st = self._family(templates)
        plan = st["plan"]
        coloring = np.asarray(coloring, np.int32).reshape(-1)
        if coloring.shape[0] != self.graph.n:
            raise ValueError(f"coloring has {coloring.shape[0]} entries, "
                             f"graph has {self.graph.n} vertices")
        if self.backend == "distributed":
            return self._distributed_coloring(st, plan, coloring).numpy()
        maps, ok = colorful_map_count_many_checked(plan, coloring)
        if not bool(ok):  # a capacity overflowed: the dense program
            maps = colorful_map_count_many(plan, coloring)
        return maps.cpu().numpy()

    def sample_stream(self, key: Optional[prng.Key] = None, *,
                      batch: int = 8) -> Iterator[np.ndarray]:
        """Endless stream of per-coloring estimate batches (float64 [batch]).

        For incremental/serving use: consume until the caller's own
        convergence criterion is met, feed a live dashboard, etc.  The key
        is split per step, so the stream is reproducible from ``key``
        (default ``prng.key(0)``).
        """
        if key is None:
            key = prng.key(0)
        while True:
            key, sub = prng.split(key)
            yield self.sample_fn(sub, batch)

    # ---------------------------------------------------------------- serving
    def serve(self, *, n_colors: Optional[int] = None, config=None,
              start: bool = False, **config_kw):
        """A resident :class:`~.serve.CountingService` on this graph.

        The service loads the graph once and serves a multi-tenant request
        stream: plan-cache reuse across requests, coalesced coloring
        passes, per-tenant fair scheduling (DESIGN.md §17), and the §20
        hardening — driver thread, deadlines/cancellation, backpressure,
        supervised passes.  It runs with a fixed shared color budget —
        ``n_colors`` defaults to this Counter's own
        (``plan_opts['n_colors']`` or the template size), and every
        request's results are bit-identical to a solo
        ``Counter.estimate``/``estimate_many`` at that budget, on this
        Counter's backend and device.

        ``start=True`` launches the background driver thread before
        returning; any extra keyword (``max_pending=...``,
        ``shed_oldest=True``, ``timeout_s=...``) builds the
        :class:`~.serve.ServiceConfig` in place of ``config``.
        """
        from .serve import CountingService, ServiceConfig

        if config_kw:
            if config is not None:
                raise ValueError("pass config= or ServiceConfig kwargs, not both")
            config = ServiceConfig(**config_kw)
        k = n_colors or self.plan_opts.get("n_colors") or self.k
        opts = {key: v for key, v in self.plan_opts.items() if key != "n_colors"}
        svc = CountingService(
            self.graph,
            n_colors=k,
            backend=self.backend,
            plan_opts=opts,
            config=config,
        )
        return svc.start() if start else svc


def __getattr__(name):
    # lazy serving re-exports: .serve imports this module at module scope,
    # so the reverse edge must resolve at attribute time
    if name in ("CountingService", "ServiceClient", "ServiceConfig", "Ticket",
                "QueueFullError", "UnsatisfiableRequestError"):
        from . import serve as _serve

        return getattr(_serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def run(
    request: CountRequest,
    *,
    key: Optional[prng.Key] = None,
    progress: bool = False,
    checkpoint=None,
    resume: Union[bool, str] = False,
) -> CountResult:
    """One-shot: resolve a :class:`CountRequest` and run its estimate.

    The request's robustness spec (``max_retries``, ``checkpoint_every``,
    ``target_rsd``) applies; ``checkpoint``/``resume`` name where the state
    lives, since a directory is a property of the invocation, not of the
    workload.
    """
    counter = Counter.from_request(request)
    return counter.estimate(
        request.n_iter,
        eps=request.eps,
        delta=request.delta,
        key=key,
        batch=request.batch,
        progress=progress,
        max_retries=request.max_retries,
        target_rsd=request.target_rsd,
        checkpoint=checkpoint,
        checkpoint_every=request.checkpoint_every,
        resume=resume,
    )
