"""Active-frontier compaction: sparsity-aware DP tables (DESIGN.md §15).

Counterpart of the single-device part of ``repro/core/frontier.py``.  For
deep sub-templates most rows of a node table ``C_i [n_pad, B, W]`` are
exactly zero: a (vertex, coloring) row is active only if a colorful
embedding of ``T_i`` roots at the vertex under that coloring.  The dense
engine pays for every row; a compacted plan skips the inactive ones.

* :func:`probe_activity`: an exact boolean DP (counts are nonnegative, so
  zero/nonzero propagates without cancellation) measuring each internal
  node's active rows on a few probe colorings at plan-build time.  It runs
  on the device of the split tables through the port's own kernels, all
  probes as one batch: on 0/1 tables a neighbor sum is positive iff some
  neighbor's entry is, and a combine iff some split's pair of entries is,
  so ``spmm(t) > 0`` and ``color_combine(l, m) > 0`` are the reference's
  boolean ORs exactly (the sums are nonnegative integers).
* :class:`CompactionSpec`: the static per-coloring capacities derived
  from the probe, ``pad(ceil(max_active * capacity_factor) + 1)``, for every
  node whose measured density is at or below ``threshold``.
* runtime (:func:`make_frontier_fn`, :func:`compact_combine`): the
  reference ``vmap``s the DP over colorings, so each coloring has its own
  frontier, compact tables and no-overflow flag.  The port holds a batch as
  a table axis and keeps the per-coloring flags (``ok [B]``: coloring b's
  active count is at most ``cap - 1``), so its flags equal the reference's
  vmapped ones.  A combine contracts the active (vertex, coloring) rows of
  the whole batch gathered into one ``[B (cap - 1) + 1, ...]`` buffer; a
  compact source holds the union of the batch's active vertex rows (the
  SpMM gathers a vertex's whole ``B W`` row), ``B (cap - 1)`` of them and a
  last zero slot.  Slots come from cumulative sums on the device and each
  row is written to a target of its own, so the DP makes no host sync and
  no two writes meet; the caller reads the flags once per call, and rows
  past a capacity are dropped, never written out of bounds.

Everything here is exact: compaction never changes a bit of the counts.
Inactive rows contribute exact zeros in the dense program, and the compact
program never multiplies or gathers them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .graphs import edge_list, relabel_random, rmat

__all__ = [
    "DEFAULT_DENSITY_THRESHOLD",
    "DEFAULT_CAPACITY_FACTOR",
    "MIN_COMBINE_ELEMENTS",
    "MIN_TABLE_WIDTH",
    "Frontier",
    "CompactionSpec",
    "NodeActivity",
    "capacity_for",
    "model_density",
    "probe_activity",
    "single_device_compaction",
    "sampled_density",
    "make_frontier_fn",
    "inverse_map",
    "combine_rows",
    "compact_combine",
]

#: compact a node once its measured active-row fraction is at or below this
DEFAULT_DENSITY_THRESHOLD = 0.25
#: headroom over the probed maximum before a static capacity overflows into
#: the dense fallback
DEFAULT_CAPACITY_FACTOR = 1.5
#: combine compaction engages only where a row's combine work (``S * J``
#: multiply-adds) clears this floor: narrow nodes lose to the gather and
#: scatter even when sparse (the reference's constant)
MIN_COMBINE_ELEMENTS = 256
#: the same for the compact-source indirection: it pays only on a wide
#: right table
MIN_TABLE_WIDTH = 64


class Frontier(NamedTuple):
    """Active rows of one node table ``[rows, B, W]``, computed once when the
    table is produced and freed with it.

    ``mask`` marks the active (vertex, coloring) rows.  ``idx`` lists the
    source rows of the compact table ``[B (cap - 1) + 1, B, W]``: the union
    of the batch's active vertices in ascending order, then the sentinel
    row (a zero row) in every slot left, the last slot always.  ``inv``
    maps a vertex row to its slot, inactive rows to the last (zero) slot.
    Both are ``None`` where the compact table would not be shorter than
    the dense one.  The per-coloring no-overflow flags go to the program's
    flag list (:func:`make_frontier_fn`): where one is false the union may
    have lost rows and the batch's counts are discarded.
    """

    mask: torch.Tensor  # [rows, B] bool
    idx: Optional[torch.Tensor]  # [B (cap - 1) + 1] int64
    inv: Optional[torch.Tensor]  # [rows] int32


@dataclasses.dataclass(frozen=True)
class CompactionSpec:
    """Static compaction plan of one table program.

    All capacities are per coloring, sized from the probe; a node absent
    from a ``*_caps`` mapping runs dense.  ``density`` and
    ``gather_density`` keep the probe's measurements for reports.  The
    reference's exchange and shard capacities come with the compacted
    exchange of the distributed engine (ROADMAP queue 1 item 7).
    """

    threshold: float
    capacity_factor: float
    #: node -> measured table density (max over probes; internal nodes)
    density: Mapping[int, float]
    #: node -> measured combine-gather density (active left and active M)
    gather_density: Mapping[int, float]
    #: node -> frontier capacity (active rows of its table; +1 zero slot)
    table_caps: Mapping[int, int]
    #: node -> combine-gather capacity (rows the combine contracts)
    combine_caps: Mapping[int, int]
    probes: int = 0

    @property
    def enabled(self) -> bool:
        return bool(self.table_caps or self.combine_caps)


def capacity_for(
    max_active: int, capacity_factor: float, limit: int, multiple: int = 128
) -> Optional[int]:
    """Static capacity for a measured active count: ``ceil(max * factor)``
    plus one reserved zero slot, padded to ``multiple``.  ``None`` when the
    padded capacity reaches ``limit`` (compaction would not shrink it)."""
    want = int(math.ceil(max_active * capacity_factor)) + 1
    want = max(want, 2)
    cap = ((want + multiple - 1) // multiple) * multiple
    return cap if cap < limit else None


def model_density(t: int, k: int, avg_degree: float) -> float:
    """Analytic stand-in for the probe at shape-only scale: the Markov bound
    ``P(C_i[v] != 0) <= d^(t-1) * falling(k, t) / k^t`` on the active-row
    fraction of a size-``t`` sub-template table."""
    if t <= 1:
        return 1.0
    emb = float(avg_degree) ** (t - 1)
    p = 1.0
    for i in range(t):
        p *= (k - i) / k
    return float(min(1.0, emb * p))


class NodeActivity(NamedTuple):
    """One internal node's activity on every probe coloring."""

    table: torch.Tensor  # [probes, n] bool: active rows of the node's table
    gather: torch.Tensor  # [probes, n] bool: active(left) & active(M)


def _active(table: torch.Tensor) -> torch.Tensor:
    """``[rows, B, W]`` nonnegative counts -> ``[rows, B]`` bool: any nonzero."""
    return table.amax(dim=-1) > 0


def probe_activity(
    graph, program, combine, k: int, *, probes: int = 2, seed: int = 0
) -> Dict[int, NodeActivity]:
    """Activity masks of every internal node on ``probes`` probe colorings.

    The colorings are the reference's, ``np.random.default_rng(seed)
    .integers(0, k, n)`` once per probe (``frontier.py:192-194``), and the
    masks equal its boolean DP's.  The DP runs as one batch of the probe
    colorings on the device of ``combine``'s split tables, over 0/1 tables:
    each neighbor sum and each combine is clamped to 1, so every sum stays a
    small nonnegative integer and is positive exactly where the boolean OR
    holds.  The program's own executor walks the nodes.
    """
    from .table_program import leaf_table, run_table_program

    if not combine or probes < 1:
        return {}
    dev = next(iter(combine.values())).pairs.device
    n = graph.n
    rng = np.random.default_rng(seed)
    colorings = np.stack([rng.integers(0, k, n) for _ in range(probes)])
    sp = ops.build_spmm_plan(*edge_list(graph), n, kind="edges", device=dev)
    padded = np.zeros((probes, sp.n_pad), np.int64)
    padded[:, :n] = colorings
    leaf = leaf_table(torch.from_numpy(padded).to(dev), k, n)
    out: Dict[int, NodeActivity] = {}

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        m = ops.spmm(sp, c_right).clamp_(max=1.0)
        t = ops.color_combine(c_left, m, tbl).clamp_(max=1.0)
        out[i] = NodeActivity(table=_active(t[:n]).t(),
                              gather=(_active(c_left[:n]) & _active(m[:n])).t())
        return t

    run_table_program(program, combine, leaf, n, node_fn, root_fn=lambda t: None)
    return out


def _child_roles(program) -> Tuple[set, set]:
    """(right-child node ids, left-child node ids) over internal parents."""
    rights, lefts = set(), set()
    for nd in program.nodes:
        if not nd.is_leaf:
            rights.add(nd.right)
            lefts.add(nd.left)
    return rights, lefts


def _max_counts(acts: Dict[int, NodeActivity]) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Per node, the most active table rows and gather rows over the probes,
    read from the device in one copy."""
    if not acts:
        return {}, {}
    nodes = sorted(acts)
    counts = torch.stack([torch.stack([acts[i].table.sum(1).max(), acts[i].gather.sum(1).max()])
                          for i in nodes]).cpu().tolist()
    return ({i: int(c[0]) for i, c in zip(nodes, counts)},
            {i: int(c[1]) for i, c in zip(nodes, counts)})


def single_device_compaction(
    graph,
    program,
    combine,
    k: int,
    *,
    n_pad: int,
    threshold: float,
    capacity_factor: float,
    probes: int = 2,
    seed: int = 0,
    has_edge_slabs: bool = True,
) -> CompactionSpec:
    """Probe densities and size the in-core capacities (the reference's
    rules, ``frontier.py:243``).

    ``table_caps`` engage for internal nodes read as a right child, at a
    density at or below ``threshold`` and a width of ``MIN_TABLE_WIDTH`` or
    more: their compact form feeds the SpMM and fused kernels through the
    row-index indirection, which needs the CSR walk, so a block plan passes
    ``has_edge_slabs=False`` and gets none.  ``combine_caps`` engage where
    the measured gather density (active left rows with an active neighbor
    sum) is at or below the threshold and ``S * J`` reaches
    ``MIN_COMBINE_ELEMENTS``.
    """
    n = graph.n
    rights, _ = _child_roles(program)
    if not has_edge_slabs:
        rights = set()
    max_act, max_gath = _max_counts(probe_activity(graph, program, combine, k, probes=probes,
                                                   seed=seed))
    density = {i: c / max(n, 1) for i, c in max_act.items()}
    gather_density = {i: c / max(n, 1) for i, c in max_gath.items()}
    table_caps = {}
    combine_caps = {}
    for i in max_act:
        if i in rights and density[i] <= threshold and combine[i].s >= MIN_TABLE_WIDTH:
            cap = capacity_for(max_act[i], capacity_factor, n_pad)
            if cap is not None:
                table_caps[i] = cap
        if (gather_density[i] <= threshold
                and combine[i].s * combine[i].j >= MIN_COMBINE_ELEMENTS):
            cap = capacity_for(max_gath[i], capacity_factor, n_pad)
            if cap is not None:
                combine_caps[i] = cap
    return CompactionSpec(
        threshold=threshold,
        capacity_factor=capacity_factor,
        density=density,
        gather_density=gather_density,
        table_caps=table_caps,
        combine_caps=combine_caps,
        probes=probes,
    )


def sampled_density(
    num_vertices: int,
    avg_degree: float,
    program,
    combine,
    k: int,
    *,
    sample_vertices: int = 2048,
    probes: int = 2,
    seed: int = 0,
) -> Dict[int, float]:
    """Per-node table densities from the exact probe on a sampled
    same-degree R-MAT graph (skew 3), for shape-only sizing where the
    Markov bound of :func:`model_density` saturates.  Runs where
    ``combine``'s split tables live."""
    n_s = int(min(max(sample_vertices, 64), max(num_vertices, 64)))
    m_s = max(n_s // 2, int(round(n_s * avg_degree / 2.0)))
    g_s = relabel_random(rmat(n_s, m_s, skew=3, seed=seed), seed=seed + 1)
    acts = probe_activity(g_s, program, combine, k, probes=probes, seed=seed)
    max_act, _ = _max_counts(acts)
    return {i: c / max(n_s, 1) for i, c in max_act.items()}


def inverse_map(keep: torch.Tensor, zero_slot: int) -> torch.Tensor:
    """Row -> compact slot, ``int32 [rows]``: the kept rows (``keep``, 1-D
    bool) in ascending order take slots 0, 1, ..., every other row
    ``zero_slot``, which must name an all-zero row of the compact table
    (the reference's ``inverse_map``, ``frontier.py:547``, from the mask
    instead of the index list, so that no two writes meet)."""
    return torch.where(keep, torch.cumsum(keep, 0) - 1, zero_slot).to(torch.int32)


def _first(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``mask`` (1-D bool) with its set entries past the first ``size``
    cleared: what fits ``size`` slots (all of it unless a flag is false)."""
    return mask & (torch.cumsum(mask, 0) <= size)


def _positions(keep: torch.Tensor, fill: int, size: int) -> torch.Tensor:
    """``int64 [size]``: the indices where ``keep`` (1-D bool, at most
    ``size`` set) holds, in ascending order, then ``fill`` in the slots
    left.  Stream compaction by a cumulative sum and one scatter in which
    every entry has a target of its own (the kept ones their slots, the
    others the slots past ``size`` in order), so no host sync and no two
    writes meet."""
    n = keep.numel()
    cum = torch.cumsum(keep, 0)
    every = torch.arange(n, dtype=torch.int64, device=keep.device)
    target = torch.where(keep, cum - 1, size + every - cum)
    buf = torch.full((size + n,), fill, dtype=torch.int64, device=keep.device)
    return buf.scatter_(0, target, every)[:size]


def make_frontier_fn(
    table_caps: Mapping[int, int], sentinel_row: int, flags: List[torch.Tensor]
) -> Callable[[int, torch.Tensor], Optional[Frontier]]:
    """Frontier hook for :func:`~.table_program.run_table_program`: a node
    in ``table_caps`` gets its :class:`Frontier` (appending its per-coloring
    flags to ``flags``), any other node ``None`` (dense).

    ``sentinel_row`` names a zero row of every table (row ``n``).  The
    union of the batch's active vertices fits ``B (cap - 1)`` slots whenever
    every flag holds; rows past that are dropped (their batch falls back).
    """

    def frontier_fn(i: int, table: torch.Tensor) -> Optional[Frontier]:
        cap = table_caps.get(i)
        if cap is None:
            return None
        mask = _active(table)
        flags.append(mask.sum(dim=0) <= cap - 1)
        rows, b = mask.shape
        size = b * (cap - 1)
        if size + 1 >= rows:  # the union's table would be no shorter
            return Frontier(mask, None, None)
        keep = _first(mask.any(dim=1), size)
        # the last slot is never kept: it holds the sentinel's zero row
        return Frontier(mask, _positions(keep, sentinel_row, size + 1), inverse_map(keep, size))

    return frontier_fn


def combine_rows(act: torch.Tensor, cap: int, sentinel_row: int) -> torch.Tensor:
    """``int64 [B (cap - 1) + 1]``: the flat (vertex, coloring) rows of
    ``act`` (``[rows, B]`` bool) that :func:`compact_combine` contracts, the
    first ``B (cap - 1)`` active ones in ascending order, then the sentinel
    row's flat index in the slots left, the last always."""
    b = act.shape[1]
    size = b * (cap - 1)
    return _positions(_first(act.reshape(-1), size), sentinel_row * b, size + 1)


def compact_combine(
    c_left: torch.Tensor,  # [rows, B, A]
    m: torch.Tensor,  # [rows, B, W] neighbor sum
    tables,  # ops.CombineTables
    cap: int,
    sentinel_row: int,
    flags: List[torch.Tensor],
    left_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The combine over active rows only, laid back out as ``[rows, B, S]``.

    An output row is zero wherever its ``left`` row or its ``M`` row is all
    zero, so contracting just the (vertex, coloring) rows where both are
    active gives the same table bit for bit.  The active rows of all ``B``
    colorings are gathered into one ``[B (cap - 1) + 1, 1, ·]`` buffer
    (unused slots and the last hold the sentinel row, whose output is zero)
    and go through ``color_combine`` in one launch; each output row is then
    read from its slot, or from the last.  Appends the per-coloring
    no-overflow flags (at most ``cap - 1`` active rows) to ``flags``; where
    one is false the rows past the buffer are dropped and the batch's
    result is discarded.
    """
    act = (left_mask if left_mask is not None else _active(c_left)) & _active(m)
    flags.append(act.sum(dim=0) <= cap - 1)
    rows, b = act.shape
    size = b * (cap - 1)
    keep = _first(act.reshape(-1), size)
    idx = _positions(keep, sentinel_row * b, size + 1)
    lc = c_left.view(rows * b, -1).index_select(0, idx)
    mc = m.view(rows * b, -1).index_select(0, idx)
    outc = ops.color_combine(lc.view(size + 1, 1, -1), mc.view(size + 1, 1, -1), tables)
    # every row not contracted reads the last slot, the sentinel's zero output
    out = outc.view(size + 1, -1).index_select(0, inverse_map(keep, size))
    return out.view(rows, b, tables.s)
