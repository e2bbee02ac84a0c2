"""Active-frontier compaction: sparsity-aware DP tables (DESIGN.md §15).

Counterpart of the single-device part of ``repro/core/frontier.py``.  For
deep sub-templates most rows of a node table ``C_i [n_pad, B, W]`` are
exactly zero: a (vertex, coloring) row is active only if a colorful
embedding of ``T_i`` roots at the vertex under that coloring.  The dense
engine pays for every row; a compacted plan skips the inactive ones.

* :func:`probe_activity`: an exact boolean DP (counts are nonnegative, so
  zero/nonzero propagates without cancellation) measuring each internal
  node's active rows on a few probe colorings at plan-build time; the
  reference's generator, one dict of ``[n]`` numpy masks per probe.  The
  DP runs on the device of the split tables through the port's own
  kernels, all probes as one batch (``_probe_activity_batched``, which the
  planners read): on 0/1 tables a neighbor sum is positive iff some
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

The distributed engine's compacted exchange (:func:`distributed_compaction`,
:func:`chunk_slots`, :func:`node_exchange_bytes`) ships each coloring's
active rows of a request chunk, or of a relayed shard, as a slab of its own
(``cap`` rows beside their slots, the coloring axis inside: ``[cap, B, W +
1]``), as the reference's ``vmap`` over colorings does: the bytes of a
batch are B times the reference's per-coloring slab, whatever rows the
colorings share.  A shape-only plan (the dry-run's) sizes the same
capacities without a graph (:func:`abstract_compaction`).

Everything here is exact: compaction never changes a bit of the counts.
Inactive rows contribute exact zeros in the dense program, and the compact
program never multiplies or gathers them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..comm.compress import mask_column_count, wire_itemsize
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
    "distributed_compaction",
    "sampled_density",
    "abstract_compaction",
    "node_exchange_bytes",
    "make_frontier_fn",
    "inverse_map",
    "combine_rows",
    "compact_combine",
    "row_cumsum",
    "chunk_slots",
    "encode_slots",
    "decode_slots",
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
    ``gather_density`` keep the probe's measurements for reports.  A
    single-device plan fills ``table_caps`` and ``combine_caps``; a
    distributed one ``exchange_caps``, ``shard_caps`` and ``combine_caps``.
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
    #: node -> per-peer compacted-chunk capacity (distributed alltoall, pipeline)
    exchange_caps: Mapping[int, int] = dataclasses.field(default_factory=dict)
    #: node -> compacted relay capacity of a whole shard (distributed ring)
    shard_caps: Mapping[int, int] = dataclasses.field(default_factory=dict)
    probes: int = 0

    @property
    def enabled(self) -> bool:
        return bool(self.table_caps or self.combine_caps or self.exchange_caps
                    or self.shard_caps)


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
    """One internal node's activity on one probe coloring (the reference's)."""

    table: np.ndarray  # [n] bool: active rows of the node's table
    gather: Optional[np.ndarray]  # [n] bool: active(left) & active(M)


class _Activity(NamedTuple):
    """One internal node's activity on every probe coloring, on the device."""

    table: torch.Tensor  # [probes, n] bool
    gather: torch.Tensor  # [probes, n] bool


def _active(table: torch.Tensor) -> torch.Tensor:
    """``[rows, B, W]`` nonnegative counts -> ``[rows, B]`` bool: any nonzero."""
    return table.amax(dim=-1) > 0


def probe_activity(
    graph, program, combine, k: int, *, probes: int = 2, seed: int = 0
) -> Iterator[Dict[int, NodeActivity]]:
    """Yield per-probe-coloring activity masks for every internal node.

    The reference's generator: one ``{node: NodeActivity}`` per probe
    coloring, in the reference's order, each mask an ``[n]`` numpy bool
    array equal to its boolean DP's.  The DP itself runs once, all probes
    as one batch on the device of the split tables
    (:func:`_probe_activity_batched`, which the compaction planners read
    directly); its masks come to the host in one copy at the first yield.
    """
    acts = _probe_activity_batched(graph, program, combine, k, probes=probes, seed=seed)
    host = {i: (a.table.cpu().numpy(), a.gather.cpu().numpy()) for i, a in acts.items()}
    for p in range(probes):
        yield {i: NodeActivity(table=t[p], gather=g[p]) for i, (t, g) in host.items()}


def _probe_activity_batched(
    graph, program, combine, k: int, *, probes: int = 2, seed: int = 0
) -> Dict[int, _Activity]:
    """Activity masks ``[probes, n]`` of every internal node on ``probes``
    probe colorings, on the device of ``combine``'s split tables.

    The colorings are the reference's, ``np.random.default_rng(seed)
    .integers(0, k, n)`` once per probe (``frontier.py:192-194``), and the
    masks equal its boolean DP's.  The DP runs as one batch of the probe
    colorings over 0/1 tables: each neighbor sum and each combine is
    clamped to 1, so every sum stays a small nonnegative integer and is
    positive exactly where the boolean OR holds.  The program's own executor
    walks the nodes.
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
    out: Dict[int, _Activity] = {}

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        m = ops.spmm(sp, c_right).clamp_(max=1.0)
        t = ops.color_combine(c_left, m, tbl).clamp_(max=1.0)
        out[i] = _Activity(table=_active(t[:n]).t(),
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


def _max_counts(acts: Dict[int, _Activity]) -> Tuple[Dict[int, int], Dict[int, int]]:
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
    max_act, max_gath = _max_counts(_probe_activity_batched(graph, program, combine, k,
                                                            probes=probes, seed=seed))
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


def distributed_compaction(
    graph,
    program,
    combine,
    k: int,
    *,
    num_shards: int,
    shard_size: int,
    n_loc_pad: int,
    r_pad: int,
    send_idx: np.ndarray,
    threshold: float,
    capacity_factor: float,
    probes: int = 2,
    seed: int = 0,
) -> CompactionSpec:
    """Probe densities and size the distributed capacities (the reference's
    rules, ``frontier.py:300``).

    ``exchange_caps`` bound the per-peer compacted chunk: the active rows
    among each (src, dst) request list ``send_idx``, measured per pair, so
    a hub-heavy list is sized by its own activity.  ``shard_caps`` bound the
    compacted whole-shard relay of the ring mode, ``combine_caps`` the
    per-shard combine gather.  Exchange and shard capacities are multiples
    of 8 and engage for right children at or below ``threshold`` at any
    width; ``table_caps`` stays empty.  The probe runs where ``combine``'s
    split tables live and its maxima come to the host in one copy.
    """
    n = graph.n
    Pn, ss = num_shards, shard_size
    rights, _ = _child_roles(program)
    acts = _probe_activity_batched(graph, program, combine, k, probes=probes, seed=seed)
    if not acts:
        return CompactionSpec(threshold, capacity_factor, {}, {}, {}, {}, probes=probes)
    dev = next(iter(acts.values())).table.device
    sidx = torch.from_numpy(send_idx.astype(np.int64)).to(dev)
    glob = (sidx + (torch.arange(Pn, device=dev) * ss)[:, None, None]).clamp(max=Pn * ss)
    valid = sidx != ss

    def padded(mask: torch.Tensor) -> torch.Tensor:
        """``[probes, n]`` -> ``[probes, P ss + 1]``, the last column false."""
        return torch.nn.functional.pad(mask, (0, Pn * ss + 1 - n))

    nodes = sorted(acts)
    stats = []
    for i in nodes:
        table = padded(acts[i].table)
        gath = padded(acts[i].gather)[:, : Pn * ss]
        chunk = ((table[:, glob] & valid).sum(dim=-1).max() if i in rights
                 else torch.zeros((), dtype=torch.int64, device=dev))
        stats.append(torch.stack([table.sum(dim=1).max(),
                                  table[:, : Pn * ss].view(-1, Pn, ss).sum(dim=2).max(),
                                  gath.view(-1, Pn, ss).sum(dim=2).max(), chunk]))
    got = dict(zip(nodes, torch.stack(stats).cpu().tolist()))
    density = {i: c[0] / max(n, 1) for i, c in got.items()}
    gather_density = {i: c[2] / max(ss, 1) for i, c in got.items()}
    exchange_caps = {}
    shard_caps = {}
    combine_caps = {}
    for i, (_, max_shard, max_gath, max_chunk) in got.items():
        # the reference's rule: wire capacities are gated by density alone
        if i in rights and density[i] <= threshold:
            cap = capacity_for(max_chunk, capacity_factor, r_pad, multiple=8)
            if cap is not None:
                exchange_caps[i] = cap
            cap = capacity_for(max_shard, capacity_factor, n_loc_pad, multiple=8)
            if cap is not None:
                shard_caps[i] = cap
        if (gather_density[i] <= threshold
                and combine[i].s * combine[i].j >= MIN_COMBINE_ELEMENTS):
            cap = capacity_for(max_gath, capacity_factor, n_loc_pad)
            if cap is not None:
                combine_caps[i] = cap
    return CompactionSpec(
        threshold=threshold,
        capacity_factor=capacity_factor,
        density=density,
        gather_density=gather_density,
        table_caps={},
        combine_caps=combine_caps,
        exchange_caps=exchange_caps,
        shard_caps=shard_caps,
        probes=probes,
    )


def node_exchange_bytes(plan, i: int, mode: str, wire_dtype: str = "float32") -> Tuple[int, int]:
    """``(dense, compact)`` bytes a rank ships for node ``i``'s exchange, per
    coloring, under ``mode`` at ``wire_dtype``: the reference's formula
    (``frontier.py:481``) on the port's true widths.

    Dense: ``P - 1`` peers times a chunk's rows (``r_pad`` requested rows,
    or the ``n_loc_pad`` rows of a relayed shard on ``ring``) times the
    right child's width.  Compact, where the node's right child has a
    capacity: ``cap`` rows of the width plus the slot carrier, one float32
    column on the wide wire or the bit-packed mask columns of a narrow one.
    A batch of B colorings ships B times each (a slab a coloring).  ``plan``
    is a :class:`~.distributed.DistributedPlan`."""
    nd = plan.program.nodes[i]
    w = plan.widths[nd.right]
    spec = plan.compaction
    if mode == "ring":
        rows = plan.n_loc_pad
        cap = spec.shard_caps.get(nd.right) if spec is not None else None
    else:
        rows = plan.r_pad
        cap = spec.exchange_caps.get(nd.right) if spec is not None else None
    ebytes = wire_itemsize(wire_dtype)
    dense = (plan.num_shards - 1) * rows * w * ebytes
    if not cap:
        return dense, dense
    extra = 1 if wire_dtype == "float32" else mask_column_count(rows, cap, wire_dtype)
    return dense, (plan.num_shards - 1) * cap * (w + extra) * ebytes


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
    acts = _probe_activity_batched(g_s, program, combine, k, probes=probes, seed=seed)
    max_act, _ = _max_counts(acts)
    return {i: c / max(n_s, 1) for i, c in max_act.items()}


def abstract_compaction(
    num_vertices: int,
    avg_degree: float,
    program,
    k: int,
    *,
    r_pad: int,
    n_loc_pad: int,
    threshold: float,
    capacity_factor: float,
    combine=None,
    sample_vertices: int = 2048,
    probes: int = 2,
    seed: int = 0,
) -> CompactionSpec:
    """The shape-only plan's spec (the reference's ``frontier.py:416``):
    nothing of the graph exists.  With ``combine`` (host split tables) the
    densities are :func:`sampled_density`'s, the exact probe on a sampled
    same-degree graph; without, :func:`model_density`'s Markov bound.  A
    node at or below ``threshold`` takes the exchange and ring capacities
    (right children; multiples of 8) and the combine capacity that its
    density gives on ``r_pad`` and ``n_loc_pad`` rows."""
    rights, _ = _child_roles(program)
    if combine is not None:
        density = sampled_density(num_vertices, avg_degree, program, combine, k,
                                  sample_vertices=sample_vertices, probes=probes, seed=seed)
    else:
        density = {i: model_density(nd.size, k, avg_degree)
                   for i, nd in enumerate(program.nodes) if not nd.is_leaf}
    exchange_caps = {}
    shard_caps = {}
    combine_caps = {}
    for i, rho in density.items():
        if rho > threshold:
            continue
        cap = capacity_for(int(rho * r_pad), capacity_factor, r_pad, multiple=8)
        if i in rights and cap is not None:
            exchange_caps[i] = cap
        cap = capacity_for(int(rho * n_loc_pad), capacity_factor, n_loc_pad, multiple=8)
        if i in rights and cap is not None:
            shard_caps[i] = cap
        cap = capacity_for(int(rho * n_loc_pad), capacity_factor, n_loc_pad)
        if cap is not None:
            combine_caps[i] = cap
    return CompactionSpec(
        threshold=threshold,
        capacity_factor=capacity_factor,
        density=density,
        gather_density=dict(density),
        table_caps={},
        combine_caps=combine_caps,
        exchange_caps=exchange_caps,
        shard_caps=shard_caps,
    )


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


def make_frontier_fn(
    table_caps: Mapping[int, int], sentinel_row: int, flags: List[torch.Tensor],
    mask_only: frozenset = frozenset(),
) -> Callable[[int, torch.Tensor], Optional[Frontier]]:
    """Frontier hook for :func:`~.table_program.run_table_program`: a node
    in ``table_caps`` gets its :class:`Frontier` (appending its per-coloring
    flags to ``flags``), a node in ``mask_only`` just its activity mask
    (the distributed exchange and combine read no more), any other node
    ``None`` (dense).

    ``sentinel_row`` names a zero row of every table (row ``n``).  The
    union of the batch's active vertices fits ``B (cap - 1)`` slots whenever
    every flag holds; rows past that are dropped (their batch falls back).
    """

    def frontier_fn(i: int, table: torch.Tensor) -> Optional[Frontier]:
        cap = table_caps.get(i)
        if cap is None:
            return Frontier(_active(table), None, None) if i in mask_only else None
        mask = _active(table)
        flags.append(mask.sum(dim=0) <= cap - 1)
        rows, b = mask.shape
        size = b * (cap - 1)
        if size + 1 >= rows:  # the union's table would be no shorter
            return Frontier(mask, None, None)
        keep = _first(mask.any(dim=1), size)
        # the last slot is never kept: it holds the sentinel's zero row
        return Frontier(mask, chunk_slots(keep, size + 1, sentinel_row), inverse_map(keep, size))

    return frontier_fn


def combine_rows(act: torch.Tensor, cap: int, sentinel_row: int) -> torch.Tensor:
    """``int64 [B (cap - 1) + 1]``: the flat (vertex, coloring) rows of
    ``act`` (``[rows, B]`` bool) that :func:`compact_combine` contracts, the
    first ``B (cap - 1)`` active ones in ascending order, then the sentinel
    row's flat index in the slots left, the last always."""
    b = act.shape[1]
    size = b * (cap - 1)
    return chunk_slots(_first(act.reshape(-1), size), size + 1, sentinel_row * b)


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
    idx = chunk_slots(keep, size + 1, sentinel_row * b)
    lc = c_left.view(rows * b, -1).index_select(0, idx)
    mc = m.view(rows * b, -1).index_select(0, idx)
    outc = ops.color_combine(lc.view(size + 1, 1, -1), mc.view(size + 1, 1, -1), tables)
    # every row not contracted reads the last slot, the sentinel's zero output
    out = outc.view(size + 1, -1).index_select(0, inverse_map(keep, size))
    return out.view(rows, b, tables.s)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``int64`` inclusive cumulative sums of ``x`` (``[..., L]`` bool or
    integer) along its last axis, as one scan of the flattened tensor less
    each row's start.  A scan along a long last axis of few rows runs one
    block a row on the card (1.7 ms for two rows of 2^20); the flat scan
    is one device-wide pass."""
    flat = torch.cumsum(x.reshape(-1), 0).view(x.shape)
    return flat - (flat[..., :1] - x[..., :1].to(flat.dtype))


def chunk_slots(act: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """``int64 [..., cap]``: for each row of ``act`` (``[..., L]`` bool) the
    indices of its first ``cap`` set entries in ascending order, then
    ``fill`` in the slots left, which must name a zero row (the reference's
    ``vmap``'d capacity-padded ``nonzero``).  Stream compaction by a
    cumulative sum and one scatter in which every entry has a target of its
    own (the kept ones their slots, the others the slots past ``cap`` in
    order), so no host sync and no two writes meet."""
    L = act.shape[-1]
    keep = act & (row_cumsum(act) <= cap)
    kcum = row_cumsum(keep)
    every = torch.arange(L, dtype=torch.int64, device=act.device).expand(act.shape)
    target = torch.where(keep, kcum - 1, cap + every - kcum)
    buf = torch.full(act.shape[:-1] + (cap + L,), fill, dtype=torch.int64, device=act.device)
    return buf.scatter_(-1, target, every)[..., :cap]


def encode_slots(slots: torch.Tensor) -> torch.Tensor:
    """Slot indices -> a float32 carrier (a bitcast of their int32), so a
    compacted payload travels as one tensor.  Every slot below 2^23 is a
    subnormal float: the carrier is copied, never widened, added into or
    multiplied (flush-to-zero arithmetic would zero it)."""
    return slots.to(torch.int32).view(torch.float32)


def decode_slots(col: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`encode_slots`: int64 slots."""
    return col.contiguous().view(torch.int32).to(torch.int64)
