"""Single-device color-coding DP engine, on the card or the CPU.

Counterpart of ``repro/core/count_engine.py``.  Per coloring iteration
(Algorithm 1 of the paper):

1. sample a random coloring ``col(v) in {0..k-1}``;
2. leaf tables = one-hot of the coloring, ``[n_pad, B, k]``;
3. for each internal partition node (topological order):
   ``M = spmm(A, C_right)`` then ``C_node = color_combine(C_left, M)``, or
   with ``fuse=True`` one ``fused_count`` call that never holds the whole
   ``M``;
4. colorful map count = ``sum_{v, S} C_root[v, b, S]``.

Batched colorings are a written-out dimension of every table (the
reference ``vmap``s the DP instead): ``count_fn(plan, batch=B)`` runs each
node as one launch over all ``B`` colorings.  Colorings come from a
threefry key (:mod:`.prng`), drawn on the plan's device bit for bit as the
reference's ``jax.random.randint(key, (B, n_pad), 0, k)``, so the same key
gives the same colorings, and the same counts, in both packages.

Multi-template counting: :func:`build_multi_counting_plan` compiles a
template family into one deduplicated :class:`~.templates.TemplateDag`
(DESIGN.md §14) and :func:`colorful_map_count_many` runs it as one table
program per batch of colorings: every canonically unique sub-template table
is computed once and each template's root reads its own entry.
Treewidth-2 templates (cycles, diamond, bowtie, house) compile to bag
programs (DESIGN.md §19) whose tables carry the pinned apex's host vertex
as one more axis; they run through the same SpMM and combine kernels (bag
nodes never take the fused kernel), with the pinned leaves, the collapse
and the apex-color filter in plain tensor ops (:func:`_bag_fns`).

Active-frontier compaction (DESIGN.md §15): ``compact=True`` probes each
node's density at plan build (:mod:`.frontier`) and compacts the sparse
ones.  The compact program is speculative: it returns per-coloring
no-overflow flags beside the counts, and :func:`count_fn` re-runs the
whole batch on the plan's dense twin, on the same device, when a flag is
false.  Where the flags hold, the compact counts equal the dense ones bit
for bit.

The DP uses ``d = 1`` in the recurrence and divides the final count by
``|Aut(T)|`` once (DESIGN.md §1), so a fixed coloring's count is exactly
testable against the brute-force oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..testing import faults
from . import prng
from .colorsets import excluded_color_mask
from .frontier import (
    DEFAULT_CAPACITY_FACTOR,
    DEFAULT_DENSITY_THRESHOLD,
    CompactionSpec,
    make_frontier_fn,
    single_device_compaction,
)
from .graphs import Graph, edge_list
from .table_program import (
    BagFns,
    build_node_tables,
    leaf_table,
    local_node_fn,
    root_count,
    run_table_program,
)
from .templates import (
    Template,
    TemplateDag,
    Tree,
    automorphism_count,
    compile_templates,
    program_has_bags,
    template_program,
)

__all__ = [
    "CountingPlan",
    "MultiCountingPlan",
    "build_counting_plan",
    "build_multi_counting_plan",
    "colorful_map_count",
    "colorful_map_count_checked",
    "colorful_map_count_many",
    "colorful_map_count_many_checked",
    "draw_colorings",
    "count_fn",
    "count_fn_many",
    "plan_sample_fn",
    "multi_sample_fn",
    "copy_scale",
]

def copy_scale(k: int, t: int, aut: int) -> float:
    """Per-iteration estimator scale for a size-``t`` template counted with
    ``k`` colors: ``k^t (k-t)! / k! / |Aut|`` — the inverse probability that
    the t image vertices of a copy draw pairwise-distinct colors, divided by
    the rooted-map over-count."""
    return (k ** t) * math.factorial(k - t) / math.factorial(k) / aut


@dataclasses.dataclass(frozen=True)
class CountingPlan:
    """Everything one coloring's DP needs, resident on ``device``."""

    tree: Union[Tree, Template]
    chain: object  # the template's PartitionChain or BagProgram
    k: int  # color budget (the template's size unless n_colors widened it)
    n: int
    n_pad: int
    aut: int
    spmm_plan: ops.SpmmPlan
    combine: Dict[int, ops.CombineTables]  # internal node index -> tables
    widths: Dict[int, int]  # node index -> table width
    device: torch.device
    #: route each tree node through the fused SpMM->combine kernel
    fuse: bool = False
    #: active-frontier compaction spec (None = dense; DESIGN.md §15)
    compaction: Optional[CompactionSpec] = None
    #: dense host adjacency ``[n_pad, n]`` float32 for pinned bag leaves
    #: (treewidth-2 templates only; None for tree programs)
    pin_adj: Optional[torch.Tensor] = None

    @property
    def scale(self) -> float:
        """Maps the colorful map count to the copy estimate."""
        return copy_scale(self.k, self.tree.n, self.aut)


@dataclasses.dataclass(frozen=True)
class MultiCountingPlan:
    """One-pass family counting: the shared graph plan and the deduplicated
    template DAG's split tables, resident on ``device``."""

    templates: Tuple[Union[Tree, Template], ...]
    dag: TemplateDag
    k: int  # shared color budget (the largest template unless widened)
    n: int
    n_pad: int
    auts: Tuple[int, ...]
    spmm_plan: ops.SpmmPlan
    combine: Dict[int, ops.CombineTables]
    widths: Dict[int, int]
    device: torch.device
    fuse: bool = False
    compaction: Optional[CompactionSpec] = None
    pin_adj: Optional[torch.Tensor] = None

    @property
    def num_templates(self) -> int:
        return len(self.templates)

    @property
    def scales(self) -> Tuple[float, ...]:
        """Per-template copy-estimate scales (all against the shared k)."""
        return tuple(copy_scale(self.k, t.n, a) for t, a in zip(self.templates, self.auts))


def _build_pin_adj(g: Graph, n_pad: int, device: torch.device) -> torch.Tensor:
    """Dense ``[n_pad, n]`` float32 host adjacency for pinned bag leaves.

    Pad rows stay zero, so a pinned leaf's pad rows are zero without extra
    masking."""
    rows, cols = edge_list(g)
    a = torch.zeros((n_pad, g.n), dtype=torch.float32, device=device)
    a[torch.from_numpy(np.asarray(rows, np.int64)).to(device),
      torch.from_numpy(np.asarray(cols, np.int64)).to(device)] = 1.0
    return a


def _graph_plan(g: Graph, program, spmm_kind: str, k: int, dev: torch.device, compact: dict):
    """The SpMM plan, split tables, widths, (for bag programs) pinned
    adjacency and compaction spec of ``program`` on ``g``."""
    has_bags = program_has_bags(program)
    rows, cols = edge_list(g)
    spmm_plan = ops.build_spmm_plan(rows, cols, g.n, kind=spmm_kind, device=dev)
    combine, widths = build_node_tables(program, k, device=dev,
                                        x_dim=g.n if has_bags else None)
    pin_adj = _build_pin_adj(g, spmm_plan.n_pad, dev) if has_bags else None
    compaction = _maybe_compaction(g, program, combine, k, spmm_plan, **compact)
    return spmm_plan, combine, widths, pin_adj, compaction


def _maybe_compaction(g, program, combine, k, spmm_plan, compact, density_threshold,
                      capacity_factor, probes):
    """The probed spec of a compacted plan (the reference's
    ``count_engine.py:192``).  A bag program runs dense: the probe models
    tree combines only (DESIGN.md §19).  A block plan gets no table caps:
    the compact-source indirection needs the CSR walk."""
    if not compact or program_has_bags(program):
        return None
    return single_device_compaction(
        g, program, combine, k,
        n_pad=spmm_plan.n_pad,
        threshold=density_threshold,
        capacity_factor=capacity_factor,
        probes=probes,
        has_edge_slabs=spmm_plan.kind == "edges",
    )


def build_counting_plan(
    g: Graph,
    tree: Union[Tree, Template],
    *,
    root: int = 0,
    spmm_kind: str = "edges",
    fuse: bool = False,
    n_colors: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    compact: bool = False,
    density_threshold: float = DEFAULT_DENSITY_THRESHOLD,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    probes: int = 2,
) -> CountingPlan:
    """Plan a template on graph ``g``: the adjacency and split tables go to
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the plain
    versions).  ``spmm_kind`` is ``"edges"``, ``"blocks"`` or ``"auto"``
    (``ops.build_spmm_plan``); ``fuse`` takes effect on the tree nodes of
    edge plans.  ``n_colors`` widens the color budget past the template
    size (a single template counted as a family member with shared ``k``).

    ``compact=True`` probes each node's density on ``probes`` colorings at
    build time, on the plan's device, and compacts every node at or below
    ``density_threshold`` with ``capacity_factor`` headroom (DESIGN.md
    §15; :func:`count_fn` falls back to the dense twin on overflow).

    ``tree`` may be a :class:`Tree` or a :class:`Template`: tree-shaped
    templates take the :func:`partition_tree` path bit-identically,
    non-trees compile to an apex-pinned bag program (DESIGN.md §19).
    """
    dev = resolve_device(device)
    if isinstance(tree, Template) and tree.is_tree:
        tree = tree.as_tree()
    chain = template_program(tree, root=root)
    k = n_colors if n_colors is not None else tree.n
    if k < tree.n:
        raise ValueError(f"n_colors={k} is smaller than the template ({tree.n})")
    spmm_plan, combine, widths, pin_adj, compaction = _graph_plan(
        g, chain, spmm_kind, k, dev, dict(compact=compact, density_threshold=density_threshold,
                                          capacity_factor=capacity_factor, probes=probes))
    return CountingPlan(
        tree=tree,
        chain=chain,
        k=k,
        n=g.n,
        n_pad=spmm_plan.n_pad,
        aut=automorphism_count(tree),
        spmm_plan=spmm_plan,
        combine=combine,
        widths=widths,
        device=dev,
        fuse=fuse,
        pin_adj=pin_adj,
        compaction=compaction,
    )


def build_multi_counting_plan(
    g: Graph,
    templates: Sequence,
    *,
    roots: Optional[Sequence[int]] = None,
    spmm_kind: str = "edges",
    fuse: bool = False,
    n_colors: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    compact: bool = False,
    density_threshold: float = DEFAULT_DENSITY_THRESHOLD,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    probes: int = 2,
) -> MultiCountingPlan:
    """One plan for a whole template family: compile the set into a shared
    :class:`~.templates.TemplateDag` and build each unique node's split
    tables once (options as :func:`build_counting_plan`)."""
    dev = resolve_device(device)
    dag = compile_templates(templates, n_colors=n_colors, roots=roots)
    spmm_plan, combine, widths, pin_adj, compaction = _graph_plan(
        g, dag, spmm_kind, dag.k, dev, dict(compact=compact, density_threshold=density_threshold,
                                            capacity_factor=capacity_factor, probes=probes))
    return MultiCountingPlan(
        templates=dag.templates,
        dag=dag,
        k=dag.k,
        n=g.n,
        n_pad=spmm_plan.n_pad,
        auts=tuple(automorphism_count(t) for t in dag.templates),
        spmm_plan=spmm_plan,
        combine=combine,
        widths=widths,
        device=dev,
        fuse=fuse,
        pin_adj=pin_adj,
        compaction=compaction,
    )


def _bag_node_fn(plan, program, base_fn):
    """Wrap the in-core neighbor-sum strategy for ``bag_combine`` nodes.

    A bag table ``[rows, B, x * W]`` is, row-major, ``x`` contiguous blocks
    of width ``W`` per (vertex, coloring) row, so the whole-graph SpMM
    applies unchanged (it is width-agnostic), and the color convolution
    runs on the ``[rows, B * x, W]`` view.  Fusion is bypassed per bag node
    (the fused kernel contracts over vertex rows and cannot align the
    ``(v, x)`` pair axis); tree nodes of a mixed program keep their fused
    path.
    """
    x_dim = plan.n

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        if program.nodes[i].kind != "bag_combine":
            return base_fn(i, tbl, c_left, c_right, f_left, f_right)
        rows, b = c_left.shape[:2]
        m = ops.spmm(plan.spmm_plan, c_right)
        out = ops.color_combine(c_left.view(rows, b * x_dim, -1), m.view(rows, b * x_dim, -1),
                                tbl)
        return out.view(rows, b, x_dim * tbl.s)

    return node_fn


def _bag_fns(plan, program, colorings: torch.Tensor, leaf: torch.Tensor) -> BagFns:
    """In-core strategy for the bag-only node kinds (DESIGN.md §19), over
    the batch: each coloring ``b`` filters the apex axis by its own colors
    ``col_b(x)``."""
    n_pad, b, k = leaf.shape
    x_dim = plan.n
    col_x = colorings[:, :x_dim].long()  # [B, x]: the x axis is the real host vertices

    def leaf_fn(i, nd):
        if nd.pin:
            t = leaf[:, :, None, :] * plan.pin_adj[:, None, :, None]
        else:
            t = leaf[:, :, None, :].expand(n_pad, b, x_dim, k)
        return t.reshape(n_pad, b, x_dim * k)

    def collapse_fn(i, child):
        w = child.shape[2] // x_dim
        r = child.view(n_pad, b * x_dim * w).sum(dim=0).view(b, x_dim, w)  # pad v-rows are zero
        filt = torch.from_numpy(excluded_color_mask(plan.k, program.nodes[i].size)).to(r.device)
        # keep only the color sets that exclude the apex color col_b(x)
        return (r * filt[col_x]).transpose(0, 1).contiguous()

    def join_fn(i, tbl, left, right):
        return ops.color_combine(left, right, tbl)

    return BagFns(leaf_fn, collapse_fn, join_fn)


def _program_counts(plan, program, colorings: torch.Tensor, *, checked: bool = False):
    """Run ``program`` on ``[B, n_pad]`` colorings; one float64 ``[B]`` of
    colorful map counts per program root.

    ``checked=True`` runs the plan's compaction spec and also returns
    ``ok [B]``, the AND of every no-overflow flag per coloring: where it is
    false a static capacity overflowed and the batch must be recomputed on
    the dense program (see :func:`count_fn`).
    """
    leaf = leaf_table(colorings, plan.k, plan.n)
    spec = plan.compaction if checked else None
    if spec is not None and spec.enabled:
        flags: list = []
        node_fn = local_node_fn(plan.spmm_plan, fuse=plan.fuse, compaction=spec,
                                sentinel_row=plan.n, flags=flags)
        roots = run_table_program(program, plan.combine, leaf, plan.n, node_fn,
                                  root_fn=root_count,
                                  frontier_fn=make_frontier_fn(spec.table_caps, plan.n, flags))
        ok = torch.ones(colorings.shape[0], dtype=torch.bool, device=colorings.device)
        for f in flags:
            ok &= f
        return roots, ok
    node_fn = local_node_fn(plan.spmm_plan, fuse=plan.fuse)
    bag = None
    if program_has_bags(program):
        bag = _bag_fns(plan, program, colorings, leaf)
        node_fn = _bag_node_fn(plan, program, node_fn)
    roots = run_table_program(program, plan.combine, leaf, plan.n, node_fn,
                              root_fn=root_count, bag=bag)
    if not checked:
        return roots
    return roots, torch.ones(colorings.shape[0], dtype=torch.bool, device=colorings.device)


def _as_colorings(plan, coloring) -> torch.Tensor:
    c = torch.as_tensor(np.asarray(coloring) if not torch.is_tensor(coloring) else coloring)
    c = c.to(device=plan.device, dtype=torch.int32)
    if c.shape[-1] == plan.n:  # real vertices only: pad the sentinel/pad rows
        c = torch.nn.functional.pad(c, (0, plan.n_pad - plan.n))
    if c.shape[-1] != plan.n_pad:
        raise ValueError(f"coloring has {c.shape[-1]} entries; want n={plan.n} or n_pad={plan.n_pad}")
    return c


def colorful_map_count(plan: CountingPlan, coloring) -> torch.Tensor:
    """Number of colorful rooted embedding maps for fixed colorings.

    ``coloring``: int ``[n]`` or ``[n_pad]`` (numpy or tensor) for one
    coloring, returning a float64 scalar tensor; ``[B, n]`` or
    ``[B, n_pad]`` for a batch, returning ``[B]``.  Entries past ``plan.n``
    are ignored.  Runs on the plan's device, always the dense program (a
    compacted plan's is :func:`colorful_map_count_checked`).
    """
    c = _as_colorings(plan, coloring)
    single = c.dim() == 1
    (maps,) = _program_counts(plan, plan.chain, c[None] if single else c)
    return maps[0] if single else maps


def colorful_map_count_checked(plan: CountingPlan, coloring) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compact program's counts and no-overflow flags ``(maps, ok)``,
    shaped as :func:`colorful_map_count`'s result (a bool scalar or ``[B]``).
    Where ``ok`` holds, ``maps`` equals the dense program's bit for bit;
    elsewhere it is not to be trusted.  A plan without an enabled spec runs
    dense and reports ``ok``."""
    c = _as_colorings(plan, coloring)
    single = c.dim() == 1
    (maps,), ok = _program_counts(plan, plan.chain, c[None] if single else c, checked=True)
    return (maps[0], ok[0]) if single else (maps, ok)


def colorful_map_count_many(plan: MultiCountingPlan, coloring) -> torch.Tensor:
    """Per-template colorful map counts for fixed colorings, in one pass over
    the deduplicated DAG: float64 ``[num_templates]`` for one coloring
    (``[n]`` or ``[n_pad]``), ``[B, num_templates]`` for a batch."""
    c = _as_colorings(plan, coloring)
    single = c.dim() == 1
    maps = torch.stack(_program_counts(plan, plan.dag, c[None] if single else c), dim=1)
    return maps[0] if single else maps


def colorful_map_count_many_checked(plan: MultiCountingPlan,
                                    coloring) -> Tuple[torch.Tensor, torch.Tensor]:
    """Family analogue of :func:`colorful_map_count_checked`: ``maps``
    ``[num_templates]`` or ``[B, num_templates]`` and ``ok`` per coloring."""
    c = _as_colorings(plan, coloring)
    single = c.dim() == 1
    roots, ok = _program_counts(plan, plan.dag, c[None] if single else c, checked=True)
    maps = torch.stack(roots, dim=1)
    return (maps[0], ok[0]) if single else (maps, ok)


def draw_colorings(plan, batch: int, key: prng.Key) -> torch.Tensor:
    """``[batch, n_pad]`` int32 colorings uniform in ``{0..k-1}`` on the plan's
    device: the reference's ``jax.random.randint(key, (batch, n_pad), 0, k,
    dtype=int32)`` (``count_engine.py:547``), bit for bit.  A family plan
    draws with its shared ``k``, so a family run and a per-template run
    with ``n_colors=k`` see identical colorings for one key."""
    return prng.randint(key, (batch, plan.n_pad), 0, plan.k, device=plan.device)


def _compacted(plan) -> bool:
    return plan.compaction is not None and plan.compaction.enabled


def _checked_fallback(compact_fn, make_dense):
    """The host-side overflow fallback around a compact counter (the
    reference's ``count_engine.py:492``).

    ``compact_fn(key)`` returns ``(maps, estimates, ok)``; the host reads
    ``ok`` once per call, and where any coloring overflowed the whole batch
    runs again on the lazily built dense twin, on the same device (the
    same key draws the same colorings).  The returned counter's
    ``fallbacks`` counts those re-runs.
    """
    state: Dict[str, Callable] = {}

    def f(key: prng.Key):
        maps, est, ok = compact_fn(key)
        # the fault site forces an overflow storm, so tests drive the dense
        # twin (and its interplay with resume) without a lucky coloring
        forced = faults.fire("compaction.overflow") is not None
        if not forced and bool(ok.all()):
            return maps, est
        f.fallbacks += 1
        dense = state.get("dense")
        if dense is None:
            dense = state["dense"] = make_dense()
        return dense(key)

    f.fallbacks = 0
    return f


def count_fn(
    plan: CountingPlan, batch: Optional[int] = None
) -> Callable[[prng.Key], Tuple[torch.Tensor, torch.Tensor]]:
    """Per-call counter ``f(key) -> (maps[B], estimates[B])``, float64 on the
    plan's device.

    Each call draws ``batch`` independent colorings from ``key`` and runs
    the DP once over all of them: every internal node is one launch with
    the batch as a table dimension.  ``batch=None`` is the reference's
    scalar contract: ``f(key) -> (maps, estimate)``, 0-d, for the one
    coloring ``key`` draws (the first of ``batch=1``'s).  A compacted plan
    runs the compact program and re-runs the batch on its dense twin when a
    capacity overflows (DESIGN.md §15), with the same contract.
    """
    n, first = _batch_of(batch)

    if not _compacted(plan):
        def f(key: prng.Key):
            maps = colorful_map_count(plan, draw_colorings(plan, n, key))[first]
            return maps, maps * plan.scale

        return f

    def fc(key: prng.Key):
        maps, ok = colorful_map_count_checked(plan, draw_colorings(plan, n, key))
        return maps[first], maps[first] * plan.scale, ok

    dense = dataclasses.replace(plan, compaction=None)
    return _checked_fallback(fc, lambda: count_fn(dense, batch))


def count_fn_many(
    plan: MultiCountingPlan, batch: Optional[int] = None
) -> Callable[[prng.Key], Tuple[torch.Tensor, torch.Tensor]]:
    """Family counter ``f(key) -> (maps[B, R], estimates[B, R])``, float64 on
    the plan's device: the colorings :func:`count_fn` draws from ``key``
    with ``n_colors=plan.k``, one DAG pass over all ``B`` of them;
    ``batch=None`` gives ``[R]`` for one coloring, as :func:`count_fn`'s.  A
    compacted plan falls back to its dense twin on overflow, as
    :func:`count_fn`'s does."""
    n, first = _batch_of(batch)
    scales = torch.tensor(plan.scales, dtype=torch.float64, device=plan.device)

    if not _compacted(plan):
        def f(key: prng.Key):
            maps = colorful_map_count_many(plan, draw_colorings(plan, n, key))[first]
            return maps, maps * scales

        return f

    def fc(key: prng.Key):
        maps, ok = colorful_map_count_many_checked(plan, draw_colorings(plan, n, key))
        return maps[first], maps[first] * scales, ok

    dense = dataclasses.replace(plan, compaction=None)
    return _checked_fallback(fc, lambda: count_fn_many(dense, batch))


def _batch_of(batch: Optional[int]):
    """The colorings a call draws, and the index that keeps them: all of a
    batch, or the first alone (0-d) for the scalar contract."""
    if batch is None:
        return 1, 0
    if batch < 1:
        raise ValueError(f"batch must be >= 1 or None, got {batch}")
    return batch, slice(None)


def _cached_sampler(make_fn):
    fns: Dict[int, Callable] = {}

    def sample(key: prng.Key, batch: int) -> np.ndarray:
        f = fns.get(batch)
        if f is None:
            f = fns[batch] = make_fn(batch)
        _, est = f(key)
        return est.cpu().numpy().astype(np.float64)

    return sample


def plan_sample_fn(plan: CountingPlan):
    """Adapt a plan to the estimator's backend protocol: ``sample_fn(key,
    batch) -> float64 [batch]`` copy estimates for ``batch`` colorings
    drawn from ``key`` (the reference's protocol, ``count_engine.py:600``)."""
    sample = _cached_sampler(lambda b: count_fn(plan, b))
    return lambda key, batch: sample(key, batch).reshape(-1)


def multi_sample_fn(plan: MultiCountingPlan):
    """The family variant of the protocol: ``sample_fn(key, batch) ->
    float64 [batch, num_templates]`` per-coloring copy estimates, consumed
    by :func:`~.estimator.estimate_counts_many`."""
    sample = _cached_sampler(lambda b: count_fn_many(plan, b))
    return lambda key, batch: sample(key, batch).reshape(batch, plan.num_templates)
