"""Distributed color coding, written per rank: the paper's Algorithms 2/3.

Counterpart of ``repro/core/distributed.py``.  The graph is cut into P
contiguous vertex shards (combine with :func:`.graphs.relabel_random` for
the paper's random partition); count tables ``[n_loc_pad, B, W]`` are
sharded alongside, one shard a rank of the mesh's data axis.  The DP is
the shared table program (:mod:`.table_program`); this module gives it the
exchange neighbor sum.  A node's neighbor sum needs rows of the right
child held by other shards, and four modes bring them:

``alltoall`` (the paper's Naive)
    Per-peer request chunks ``[P, r_pad, B, W]`` (the rows each peer asked
    for, the §3.3 request lists) in one ``all_to_all``; all P received
    chunks exist before the compute (peak memory O(P R B), Eq. 7).  The
    buffer is consumed by one launch of the edge kernel (or the fused
    kernel) over the shard's CSR whose columns index the concatenated
    ``[P r_pad, B, W]`` buffer (``ops.spmm_rect``, ``ops.fused_count_rect``).
``pipeline`` (Algorithm 3)
    The same chunks in W = ceil((P - 1) / g) grouped shift steps
    (``comm.grouped_exchange``); step w + 1's transfer is posted before
    step w's chunks are consumed (peak memory O(g R B), Eq. 12).
``adaptive``
    Each node picks one of the others by the Hockney model
    (``comm.choose_mode_full``) at build time, as the reference does at
    trace time.
``ring``
    Whole table shards relayed by shift-by-one hops
    (``comm.ring_allgather_overlap``), each consumed while the next flies.

Consume, per received chunk: one kernel launch over that bucket's CSR
(``ops.BucketCsrs``: request slots for ``pipeline``, shard rows for
``ring``) added into the accumulator.  The reference loops over 128-edge
tiles; a launch per bucket does the same work without a host loop, and
the fused form computes the combine per vertex, not per edge.  With
``fuse=True`` the incremental modes add each chunk's fused count into the
output table (the combine is linear in ``M``), so ``M`` never exists; the
price is P combines a node where the unfused path runs one.  Sums across
chunks follow the arrival order: on tables whose sums stay below 2^24 the
counts equal the single-device engine's bit for bit, past it within
float32 rounding.

Colorings: :func:`shard_coloring` lays a global coloring out by shard for
fixed-coloring calls; the keyed contract (``keyed=True``,
:func:`keyed_sample_fn`) draws each iteration's coloring as
:func:`global_coloring` of its key, a function of ``(key, n, k)`` alone,
so the counts do not depend on the shard count (resume a run on another
mesh, ROADMAP elasticity).  Each rank draws the whole coloring and keeps
its rows, as the reference does.

Iterations: a mesh of ``data x iters`` ranks splits a batch of colorings
into ``iters`` slices; each data group counts its slice as one batched
table program, and the counts are all-gathered over the iteration axis.
Root counts are float64 partials all-reduced over the data axis; the roots
of bag programs' collapses and joins are already replicated (their
collapse all-reduces the ``[x, W]`` sums), so they take weight 0 there.

Families (one shared-DAG pass per coloring) and treewidth-2 bag programs
run as on one device: a bag table ``[n_loc_pad, B, x W]`` crosses the wire
like any table; its combine runs on ``[rows, B x, W]`` views and never
fused.  Shape-only plans at paper scale (:func:`abstract_plan`) hold
``meta`` tensors, and the dry-run runs one rank's program on them
(``make_count_fn(..., return_raw=True)``, :mod:`repro_torch.launch.dryrun`).

**Compacted exchange (DESIGN.md §15).**  ``compact=True`` probes each
node table's density at plan build (:func:`.frontier.distributed_compaction`)
and, for every exchanged table at or below the threshold, ships only its
active rows: per peer a ``[cap, B, W + 1]`` slab on alltoall and pipeline
(each coloring's active rows of the request chunk, then the zero sentinel
slot, beside a bitcast slot column), and the shard's ``[cap, B, W + 1]`` on
ring.  A coloring has a slab of its own, as under the reference's
``vmap``.  The receiver writes the rows into a zeroed dense chunk, every
row to a target of its own, so each chunk's consume is the dense launch
over its bucket CSR, and the unfused combine contracts only active rows
(:func:`.frontier.compact_combine`).

**Narrow wire (§18).**  With ``wire_dtype="int16"`` or ``"int8"`` every
payload ships at integer width (``comm.narrow_cast``; widened before the
launch); a compacted slab then carries its activity bitmap bit-packed in
columns of the wire dtype in place of the slot column, and the receiver
re-derives the slots with the sender's own capacity-padded nonzero.

Both are speculative: a capacity that overflows or a slab that saturates
makes a per-coloring flag false; the flags are all-reduced over the data
ranks with the counts and gathered over the iteration ranks, so every rank
reads the same decision once per call, and any false flag re-runs the whole
batch one rung up the ladder int8 -> int16 -> float32 with the same
compaction -> the dense float32 twin (each built once and kept).  Where the
flags hold, the counts equal the dense float32 exchange's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..comm import (
    V5E_ICI,
    WIRE_DTYPES,
    WIRE_ESCALATION,
    HockneyModel,
    calibrate,
    choose_mode_full,
    grouped_exchange,
    mask_columns,
    mask_from_columns,
    narrow_cast,
    ring_allgather_overlap,
    widen,
)
from ..device import resolve_device
from ..kernels import ops
from ..testing import faults
from . import prng
from .colorsets import excluded_color_mask
from .count_engine import copy_scale
from .frontier import (
    DEFAULT_CAPACITY_FACTOR,
    DEFAULT_DENSITY_THRESHOLD,
    CompactionSpec,
    abstract_compaction,
    chunk_slots,
    compact_combine,
    decode_slots,
    distributed_compaction,
    encode_slots,
    make_frontier_fn,
    node_exchange_bytes,
    row_cumsum,
)
from .graphs import Graph, edge_list
from .table_program import BagFns, build_node_tables, leaf_table, root_count, run_table_program
from .templates import (
    Template,
    TemplateDag,
    Tree,
    automorphism_count,
    bag_program,
    compile_templates,
    partition_tree,
    program_has_bags,
)

__all__ = [
    "MODES",
    "DistributedPlan",
    "ShardArrays",
    "build_distributed_plan",
    "abstract_plan",
    "make_count_fn",
    "keyed_sample_fn",
    "plan_route_report",
    "node_exchange_bytes",
    "shard_coloring",
    "global_coloring",
]

MODES = ("alltoall", "pipeline", "adaptive", "ring")


@dataclasses.dataclass(frozen=True)
class ShardArrays:
    """One shard's plan arrays on one device.

    ``a2a``: CSR over the shard's ``n_loc_pad`` rows, columns into the
    ``[P r_pad]`` received buffer (``q r_pad + slot``).  ``buckets``: one
    CSR per source shard ``q``, ``indices[0]`` the request slot in ``q``'s
    chunk (pipeline), ``indices[1]`` the row in ``q``'s shard (ring).
    ``send_idx`` int64 ``[P, r_pad]``: the rows this shard sends to each
    peer (pad slots point at the zero sentinel row).  ``pin_adj``
    ``[n_loc_pad, n]``: the shard's rows of the dense adjacency, for
    pinned bag leaves (bag programs only)."""

    a2a: ops.RectCsr
    buckets: ops.BucketCsrs
    send_idx: torch.Tensor
    pin_adj: Optional[torch.Tensor] = None

    def to(self, device) -> "ShardArrays":
        return ShardArrays(self.a2a.to(device), self.buckets.to(device),
                           self.send_idx.to(device),
                           None if self.pin_adj is None else self.pin_adj.to(device))


@dataclasses.dataclass(frozen=True)
class DistributedPlan:
    """A sharded plan: the reference's ``DistributedPlan`` (same
    ``shard_size``, ``n_loc_pad``, ``r_pad``, ``send_idx`` and
    ``bucket_counts``) with CSRs where it keeps slabs and tiles.  The split
    tables live on ``device``; the shards' arrays on the host until a count
    function moves the ones its ranks read (:meth:`shard_arrays`)."""

    templates: Tuple[Tree, ...]
    program: object  # PartitionChain, BagProgram or TemplateDag
    k: int
    n: int
    num_shards: int
    shard_size: int  # vertices a shard (the last may be ragged)
    n_loc_pad: int  # padded local rows; row ``shard_size`` is the zero sentinel
    r_pad: int  # padded request-list length (slot r_pad - 1 always the zero row)
    #: a shape-only plan's (:func:`abstract_plan`): the reference's tile
    #: size, tiles a shard and alltoall slabs a row block, which size its
    #: CSRs; None on a plan of a graph
    bucket_tile: Optional[int]
    num_tiles: Optional[int]
    slabs_per_block: Optional[int]
    auts: Tuple[int, ...]
    combine: Dict[int, ops.CombineTables]
    widths: Dict[int, int]  # true widths, per coloring (and per apex vertex x on bag nodes)
    #: [P, P, r_pad] int32: send_idx[q, p] = rows q sends to p (a meta
    #: tensor of that shape in a shape-only plan)
    send_idx: np.ndarray
    bucket_counts: np.ndarray  # [P, P] edges of bucket (dst shard, src shard)
    shards: Tuple[ShardArrays, ...]  # on the host (on meta in a shape-only plan)
    device: torch.device
    #: active-frontier compaction spec (None = dense; DESIGN.md §15)
    compaction: Optional[CompactionSpec] = None
    _on_device: Dict[tuple, ShardArrays] = dataclasses.field(default_factory=dict, repr=False,
                                                             compare=False)

    @property
    def tree(self) -> Tree:
        return self.templates[0]

    @property
    def aut(self) -> int:
        return self.auts[0]

    @property
    def num_templates(self) -> int:
        return len(self.templates)

    @property
    def is_multi(self) -> bool:
        """Family plans return per-template count vectors."""
        return isinstance(self.program, TemplateDag)

    @property
    def has_bags(self) -> bool:
        return program_has_bags(self.program)

    @property
    def scale(self) -> float:
        return copy_scale(self.k, self.templates[0].n, self.auts[0])

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(copy_scale(self.k, t.n, a) for t, a in zip(self.templates, self.auts))

    def shard_arrays(self, p: int, device) -> ShardArrays:
        """Shard ``p``'s arrays on ``device``, moved once and kept."""
        key = (p, str(device))
        got = self._on_device.get(key)
        if got is None:
            got = self._on_device[key] = self.shards[p].to(device)
        return got

    def to(self, device) -> "DistributedPlan":
        """This plan with its split tables on ``device`` (the shards' arrays
        move there on first use, as ever).  On ``meta`` it is a real plan's
        shapes, which the dry-run runs (:mod:`repro_torch.launch.dryrun`)."""
        dev = torch.device(device)
        return dataclasses.replace(self, combine={i: t.to(dev) for i, t in self.combine.items()},
                                   device=dev, _on_device={})


def _resolve_program(tree, root: int, n_colors: Optional[int]):
    """One template -> its partition chain or bag program; a family -> the
    shared DAG.  Returns ``(program, templates, k)``."""
    if isinstance(tree, Template) and tree.is_tree:
        tree = tree.as_tree()
    if isinstance(tree, Tree):
        k = n_colors if n_colors is not None else tree.n
        if k < tree.n:
            raise ValueError(f"n_colors={k} is smaller than the template ({tree.n})")
        return partition_tree(tree, root=root), (tree,), k
    if isinstance(tree, Template):
        prog = bag_program(tree, n_colors=n_colors)
        return prog, (tree,), prog.k
    dag = compile_templates(tree, n_colors=n_colors)
    return dag, dag.templates, dag.k


def build_distributed_plan(
    g: Graph,
    tree,
    num_shards: int,
    *,
    root: int = 0,
    n_colors: Optional[int] = None,
    compact: bool = False,
    density_threshold: float = DEFAULT_DENSITY_THRESHOLD,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    probes: int = 2,
    device=None,
    **unused,
) -> DistributedPlan:
    """Shard ``g`` into ``num_shards`` contiguous vertex blocks and plan
    ``tree`` (a Tree, a treewidth-2 Template, or a sequence of templates
    or names counted as one family).

    Per bucket (dst shard p, src shard q): the distinct rows of q that p's
    edges read, in ascending order, are the request list (the paper's
    ``C_{q,p}``), and each edge's slot in it is its column in q's chunk.
    ``r_pad`` pads the longest list past one more slot, so the last slot of
    every chunk is the zero sentinel.  The split tables go to ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``compact=True`` probes each node's density on ``probes`` colorings, on
    the plan's device, and sizes the exchange, ring and combine capacities
    of the nodes at or below ``density_threshold`` (the reference's rules;
    a bag program stays dense, as there).  The reference's other plan
    options (``bucket_tile``) are accepted and have no effect here.
    """
    dev = resolve_device(device)
    Pn = int(num_shards)
    if Pn < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    program, templates, k = _resolve_program(tree, root, n_colors)
    ss = (g.n + Pn - 1) // Pn
    n_loc_pad = ops.pad_to(ss + 1, ops.ROW_BLOCK)
    sentinel = ss

    rows, cols = edge_list(g)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    p_of = rows // ss
    q_of = cols // ss
    key = p_of * Pn + q_of
    counts = np.bincount(key, minlength=Pn * Pn).reshape(Pn, Pn)

    # request lists and each edge's slot in its bucket's list
    order = np.argsort(key, kind="stable")
    bkt_start = np.zeros(Pn * Pn + 1, np.int64)
    np.cumsum(counts.reshape(-1), out=bkt_start[1:])
    slot_of = np.zeros(len(rows), np.int64)
    uniq_lists = {}
    r_len = 0
    for pp in range(Pn):
        for qq in range(Pn):
            sel = order[bkt_start[pp * Pn + qq]: bkt_start[pp * Pn + qq + 1]]
            uniq, inv = np.unique(cols[sel] - qq * ss, return_inverse=True)
            uniq_lists[(pp, qq)] = uniq
            slot_of[sel] = inv.reshape(-1)
            r_len = max(r_len, len(uniq))
    r_pad = ops.pad_to(r_len + 1, ops.ROW_BLOCK)
    send_idx = np.full((Pn, Pn, r_pad), sentinel, np.int32)
    for (pp, qq), u in uniq_lists.items():
        send_idx[qq, pp, : len(u)] = u  # shard q sends rows u to shard p

    has_bags = program_has_bags(program)
    combine, widths = build_node_tables(program, k, device=dev, x_dim=g.n if has_bags else None)

    edge_slice = np.searchsorted(p_of, np.arange(Pn + 1))  # rows are sorted
    shards = []
    for pp in range(Pn):
        sl = slice(edge_slice[pp], edge_slice[pp + 1])
        dst = rows[sl] - pp * ss
        q = q_of[sl]
        a2a = ops.build_rect_csr(dst, q * r_pad + slot_of[sl], n_loc_pad)
        sub = np.argsort(q, kind="stable")  # by source shard, destination order kept
        buckets = ops.build_bucket_csrs(q[sub], dst[sub],
                                        (slot_of[sl][sub], (cols[sl] - q * ss)[sub]),
                                        Pn, n_loc_pad)
        pin = None
        if has_bags:
            pin = torch.zeros((n_loc_pad, g.n), dtype=torch.float32)
            pin[torch.from_numpy(dst), torch.from_numpy(cols[sl])] = 1.0
        shards.append(ShardArrays(a2a, buckets, torch.from_numpy(send_idx[pp].astype(np.int64)),
                                  pin))

    compaction = None
    if compact and not has_bags:
        compaction = distributed_compaction(
            g, program, combine, k, num_shards=Pn, shard_size=ss, n_loc_pad=n_loc_pad,
            r_pad=r_pad, send_idx=send_idx, threshold=density_threshold,
            capacity_factor=capacity_factor, probes=probes)

    return DistributedPlan(
        templates=tuple(templates),
        program=program,
        k=k,
        n=g.n,
        num_shards=Pn,
        shard_size=ss,
        n_loc_pad=n_loc_pad,
        r_pad=r_pad,
        bucket_tile=None,
        num_tiles=None,
        slabs_per_block=None,
        auts=tuple(automorphism_count(t) for t in templates),
        combine=combine,
        widths=widths,
        send_idx=send_idx,
        bucket_counts=counts,
        shards=tuple(shards),
        device=dev,
        compaction=compaction,
    )


def abstract_plan(
    num_vertices: int,
    num_edges: int,
    tree,
    num_shards: int,
    *,
    root: int = 0,
    skew_headroom: float = 3.0,
    compact_requests: bool = True,
    bucket_tile: int = 128,
    n_colors: Optional[int] = None,
    compact: bool = False,
    density_threshold: float = DEFAULT_DENSITY_THRESHOLD,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
) -> DistributedPlan:
    """A shape-only plan at paper scale, where no graph exists (the
    reference's ``distributed.py:427``), for the dry-run.

    The sizes are the reference's, from the paper's Eq. 5 expectation
    ``E[bucket] = |E_directed| / P^2`` with ``skew_headroom``:
    ``shard_size``, ``n_loc_pad``, ``r_pad`` (capped at a shard),
    ``num_tiles`` (``bucket_tile``-edge tiles a shard) and
    ``slabs_per_block``.  Every shard's arrays are ``meta`` tensors of one
    rank's shapes: a bucket CSR holds as many edges as the reference's tiles
    hold slots (``bucket_counts`` is that capacity per bucket), the
    alltoall CSR as many as its slabs, ``send_idx`` is ``[P, r_pad]``.  As
    there, the arrays the mode never reads are kept minimal:
    ``compact_requests=False`` (ring) gives the request slots, the alltoall
    CSR and ``send_idx`` one tile and ``r_pad = 128``, and ``True`` the shard
    rows.

    The split tables are built exactly, on the host, so routes and combine
    shapes are exact; ``compact=True`` sizes the capacities from them
    (:func:`.frontier.abstract_compaction`: the exact probe on a sampled
    same-degree graph).  Then they go to ``meta`` with the rest of the
    plan; nothing reads their values after plan time.  ``tree`` may be a
    family or a treewidth-2 template, as for :func:`build_distributed_plan`.
    """
    Pn = int(num_shards)
    if Pn < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    program, templates, k = _resolve_program(tree, root, n_colors)
    ss = (num_vertices + Pn - 1) // Pn
    n_loc_pad = ops.pad_to(ss + 1, ops.ROW_BLOCK)
    e_dev = 2.0 * num_edges / Pn
    avg_bucket = e_dev / Pn
    r_pad = ops.pad_to(min(int(avg_bucket * skew_headroom) + 128, ss + 1), 128)
    tiles_a_bucket = int(avg_bucket * skew_headroom / bucket_tile) + 1
    num_tiles = Pn * tiles_a_bucket
    nrb_loc = n_loc_pad // 128
    spb = int(e_dev * skew_headroom / (nrb_loc * bucket_tile)) + 1

    has_bags = program_has_bags(program)
    combine, widths = build_node_tables(program, k, device=torch.device("cpu"),
                                        x_dim=num_vertices if has_bags else None)
    compaction = None
    if compact and not has_bags:
        compaction = abstract_compaction(
            num_vertices, 2.0 * num_edges / max(num_vertices, 1), program, k, r_pad=r_pad,
            n_loc_pad=n_loc_pad, threshold=density_threshold, capacity_factor=capacity_factor,
            combine=combine)

    bucket_edges = tiles_a_bucket * bucket_tile
    slot_edges = row_edges = num_tiles * bucket_tile
    a2a_edges = nrb_loc * spb * bucket_tile
    if compact_requests:
        row_edges = bucket_tile  # ring-only
    else:
        slot_edges = a2a_edges = bucket_tile
        r_pad, spb = 128, 1
    meta = torch.device("meta")

    def shape(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=meta)

    arrays = ShardArrays(
        a2a=ops.RectCsr(shape(n_loc_pad + 1, dtype=torch.int64), shape(a2a_edges), a2a_edges),
        buckets=ops.BucketCsrs(shape(Pn, n_loc_pad + 1, dtype=torch.int64),
                               (shape(slot_edges), shape(row_edges)), (bucket_edges,) * Pn),
        send_idx=shape(Pn, r_pad, dtype=torch.int64),
        pin_adj=shape(n_loc_pad, num_vertices, dtype=torch.float32) if has_bags else None)
    return DistributedPlan(
        templates=tuple(templates),
        program=program,
        k=k,
        n=num_vertices,
        num_shards=Pn,
        shard_size=ss,
        n_loc_pad=n_loc_pad,
        r_pad=r_pad,
        bucket_tile=bucket_tile,
        num_tiles=num_tiles,
        slabs_per_block=spb,
        auts=tuple(automorphism_count(t) for t in templates),
        combine={i: t.to(meta) for i, t in combine.items()},
        widths=widths,
        send_idx=shape(Pn, Pn, r_pad),
        bucket_counts=np.full((Pn, Pn), bucket_edges, np.int64),
        shards=(arrays,) * Pn,
        device=meta,
        compaction=compaction,
    )


def shard_coloring(plan: DistributedPlan, coloring) -> np.ndarray:
    """Global coloring ``[n]`` -> the sharded layout ``[P, n_loc_pad]``
    (rows past a shard's vertices, and past ``n`` on a ragged last shard,
    take color 0), as the reference lays it out."""
    Pn, ss = plan.num_shards, plan.shard_size
    coloring = np.asarray(coloring, np.int32).reshape(-1)[: plan.n]
    out = np.zeros((Pn, plan.n_loc_pad), np.int32)
    padded = np.zeros(Pn * ss, np.int32)
    padded[: plan.n] = coloring
    out[:, :ss] = padded.reshape(Pn, ss)
    return out


def global_coloring(key: prng.Key, n: int, k: int, *, device=None) -> torch.Tensor:
    """The keyed backend's coloring of one iteration, int32 ``[n]``:
    ``jax.random.randint(key, (n,), 0, k)`` bit for bit.  A function of
    ``(key, n, k)`` only, so the stream is the same on every mesh."""
    return prng.randint(key, (n,), 0, k, device=device)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _node_flops(plan: DistributedPlan, i: int) -> float:
    """A rank's compute consuming node ``i``'s exchange, per coloring: the
    SpMM's ``2 E_dev W`` and the combine's ``2 n_loc_pad x S J``."""
    nd = plan.program.nodes[i]
    tbl = plan.combine[i]
    edges_dev = float(plan.bucket_counts.sum()) / plan.num_shards
    spmm_flops = 2.0 * edges_dev * plan.widths[nd.right]
    x = plan.n if nd.kind == "bag_combine" else 1
    return spmm_flops + 2.0 * plan.n_loc_pad * x * tbl.s * tbl.j


def _route(plan: DistributedPlan, i: int, model: HockneyModel, group_factor: int,
           wire_dtype: str):
    """The Hockney router on the bytes the wire ships: compacted and at
    ``wire_dtype`` width (:func:`.frontier.node_exchange_bytes`)."""
    return choose_mode_full(node_exchange_bytes(plan, i, "alltoall", wire_dtype)[1],
                            node_exchange_bytes(plan, i, "ring", wire_dtype)[1],
                            _node_flops(plan, i), plan.num_shards, model, group_factor)


def _exchange_nodes(plan: DistributedPlan):
    return [i for i, nd in enumerate(plan.program.nodes) if nd.kind in ("combine", "bag_combine")]


def plan_route_report(plan: DistributedPlan, *, mode: str = "adaptive", group_factor: int = 1,
                      wire_dtype: str = "float32", adaptive: str = "model",
                      hockney: HockneyModel = V5E_ICI, mesh=None) -> dict:
    """Per-node routes and the modeled costs behind them, for plan reports.

    With ``adaptive="measured"`` and a mesh the model is
    :func:`comm.calibrate`'s; otherwise ``hockney`` (the reference's
    assumed constants by default).  Per exchanged node: the bytes each
    wire layout ships, compacted and at ``wire_dtype`` width (the compact
    half of :func:`node_exchange_bytes`), the flops, each schedule's
    modeled seconds and the mode taken."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype={wire_dtype!r}; expected one of {sorted(WIRE_DTYPES)}")
    model, calibrated = hockney, False
    if adaptive == "measured" and mesh is not None:
        model = calibrate(mesh, base=hockney)
        calibrated = model is not hockney
    per_node = {}
    for i in _exchange_nodes(plan):
        picked, diag = _route(plan, i, model, group_factor, wire_dtype)
        chosen = picked if mode == "adaptive" else mode
        per_node[i] = {
            "mode": chosen,
            "a2a_bytes": int(node_exchange_bytes(plan, i, "alltoall", wire_dtype)[1]),
            "ring_bytes": int(node_exchange_bytes(plan, i, "ring", wire_dtype)[1]),
            "flops": float(_node_flops(plan, i)),
            "costs_s": diag["costs_s"],
            "predicted_s": diag["costs_s"].get(chosen, diag["predicted_s"]),
        }
    return {
        "wire_dtype": wire_dtype,
        "adaptive": adaptive,
        "calibrated": calibrated,
        "model": {"alpha": model.alpha, "beta": model.beta, "flops_per_s": model.flops_per_s},
        "per_node": per_node,
    }


# ---------------------------------------------------------------------------
# the count function, per rank
# ---------------------------------------------------------------------------


def _compact_slabs(table: torch.Tensor, act: torch.Tensor, table_rows: torch.Tensor, cap: int,
                   fill: int, wire_dtype: str, flags: List[torch.Tensor]) -> torch.Tensor:
    """The compacted payload of ``G`` chunks: ``[G, cap, B, W + extra]``.

    ``act [G, B, L]`` marks each coloring's active positions of a chunk of
    ``L`` rows (``fill`` is a position that is never active and names a
    zero row); ``table_rows [G, L]`` maps a position to its row of
    ``table [rows, B, W]``.  Per (chunk, coloring), the first ``cap``
    active positions in ascending order, then ``fill``: their rows, and
    beside them a bitcast slot column (float32) or the bit-packed
    ``act`` (a narrow wire, whose flags go to ``flags``)."""
    G, B, L = act.shape
    w = table.shape[2]
    slots = chunk_slots(act, cap, fill)  # [G, B, cap]
    rows = table_rows.unsqueeze(1).expand(G, B, L).gather(-1, slots)
    flat = rows * B + torch.arange(B, device=rows.device).view(1, B, 1)
    data = table.view(-1, w).index_select(0, flat.transpose(1, 2).reshape(-1))
    data = data.view(G, cap, B, w)
    if wire_dtype == "float32":
        return torch.cat([data, encode_slots(slots.transpose(1, 2))[..., None]], dim=-1)
    bits = mask_columns(act, cap, wire_dtype).transpose(1, 2)  # [G, cap, B, ncols]
    return torch.cat([narrow_cast(data, wire_dtype, flags), bits], dim=-1)


def _expand_slabs(payload: torch.Tensor, w: int, L: int, fill: int,
                  wire_dtype: str) -> torch.Tensor:
    """The receiver's inverse of :func:`_compact_slabs`: ``[G, cap, B, W +
    extra]`` -> the dense float32 chunks ``[G L, B, W]``, zero on every
    inactive row.  The activity comes from the slot column (the slots'
    positions set; the pads all name ``fill``, which is never active) or
    from the bitmap; a position's slab row is its rank among its chunk's and
    coloring's active positions, the order the sender's capacity-padded
    nonzero shipped them in.  Every dense row is then gathered once, from
    its slab row or from a zero row past the slabs, so no two writes meet;
    the slot carrier is decoded, never widened."""
    G, cap, B, _ = payload.shape
    dev = payload.device
    if wire_dtype == "float32":
        act = torch.zeros((G, B, L), dtype=torch.bool, device=dev)
        act.scatter_(-1, decode_slots(payload[..., w]).transpose(1, 2), True)
        act[..., fill] = False
    else:
        act = mask_from_columns(payload[..., w:].transpose(1, 2), L, wire_dtype)
    rank = row_cumsum(act) - 1
    src = ((torch.arange(G, device=dev).view(G, 1, 1) * cap + rank) * B
           + torch.arange(B, device=dev).view(1, B, 1))
    src = torch.where(act & (rank < cap), src, G * cap * B)  # [G, B, L]
    rows = torch.empty((G * cap * B + 1, w), dtype=torch.float32, device=dev)
    rows[:-1].view(G, cap, B, w).copy_(payload[..., :w])  # widens a narrow wire
    rows[-1] = 0.0
    return rows.index_select(0, src.transpose(1, 2).reshape(-1)).view(G * L, B, w)


def _node_fn(plan: DistributedPlan, arrays: ShardArrays, group, node_modes, fuse: bool,
             group_factor: int, wire_dtype: str, flags: List[torch.Tensor]):
    """The exchange neighbor sum of one rank (see the module docstring).

    Per node, with the plan's compaction: the right child's table ships
    compacted where it has a capacity for the node's mode and a frontier
    (the exchange or ring capacity), and the unfused combine gathers its
    active rows where the node has a combine capacity.  Every payload ships
    at ``wire_dtype`` width.  Flags go to ``flags``, one ``bool [B]`` each."""
    Pn, r_pad, x_dim, ss = plan.num_shards, plan.r_pad, plan.n, plan.shard_size
    spec = plan.compaction if plan.compaction is not None and plan.compaction.enabled else None

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        nd = plan.program.nodes[i]
        is_bag = nd.kind == "bag_combine"
        node_fuse = fuse and not is_bag  # the fused kernel cannot pair the x blocks
        mode = node_modes[i]
        rows, b, w = c_right.shape
        caps = ({} if spec is None or f_right is None
                else spec.shard_caps if mode == "ring" else spec.exchange_caps)
        cap = caps.get(nd.right)
        ccap = spec.combine_caps.get(i) if spec is not None and not fuse else None

        def combine_m(m):
            if ccap is not None:
                return compact_combine(c_left, m, tbl, ccap, ss, flags,
                                       left_mask=f_left.mask if f_left is not None else None)
            if is_bag:
                out = ops.color_combine(c_left.view(rows, b * x_dim, -1),
                                        m.view(rows, b * x_dim, -1), tbl)
                return out.view(rows, b, x_dim * tbl.s)
            return ops.color_combine(c_left, m, tbl)

        def consume_with(view, expand):
            def consume(acc, chunk, src):
                chunk = expand(chunk)
                csr = arrays.buckets.csr(src, view)
                part = (ops.fused_count_rect(csr, c_left, chunk, tbl) if node_fuse
                        else ops.spmm_rect(csr, chunk))
                return part if acc is None else acc.add_(part)

            return consume

        def expanded(L, fill):
            """A received compacted chunk ``[cap, B, W + extra]`` -> ``[L, B, W]``."""
            return lambda chunk: _expand_slabs(chunk[None], w, L, fill, wire_dtype)

        def request_slabs():
            """Every peer's compacted request chunk, ``[P, cap, B, W + extra]``."""
            act = f_right.mask.index_select(0, arrays.send_idx.view(-1)).view(Pn, r_pad, b)
            act = act.transpose(1, 2)  # [P, B, r_pad]
            flags.append(act.sum(dim=-1).amax(dim=0) <= cap - 1)
            return _compact_slabs(c_right, act, arrays.send_idx, cap, r_pad - 1, wire_dtype,
                                  flags)

        if mode == "alltoall":
            if cap is not None:
                received = group.all_to_all(request_slabs())
                remote = _expand_slabs(received, w, r_pad, r_pad - 1, wire_dtype)
            else:
                chunks = c_right.index_select(0, arrays.send_idx.view(-1)).view(Pn, r_pad, b, w)
                sent = narrow_cast(chunks, wire_dtype, flags)
                del chunks
                remote = widen(group.all_to_all(sent)).view(Pn * r_pad, b, w)
                del sent
            if node_fuse:
                return ops.fused_count_rect(arrays.a2a, c_left, remote, tbl)
            return combine_m(ops.spmm_rect(arrays.a2a, remote))

        if mode == "ring":
            if cap is not None:
                act = f_right.mask.t()[None]  # [1, B, n_loc_pad]
                flags.append(act[0].sum(dim=-1) <= cap - 1)
                own = torch.arange(rows, device=c_right.device)[None]
                payload = _compact_slabs(c_right, act, own, cap, ss, wire_dtype, flags)[0]
                expand = expanded(rows, ss)
            else:
                payload, expand = narrow_cast(c_right, wire_dtype, flags), widen
            acc = ring_allgather_overlap(group, payload, consume_with(1, expand), None)
        elif cap is not None:  # pipeline, compacted
            consume = consume_with(0, expanded(r_pad, r_pad - 1))
            acc = grouped_exchange(group, request_slabs(), consume, None,
                                   group_factor=group_factor)
        else:  # pipeline
            acc = grouped_exchange(
                group,
                lambda q: narrow_cast(c_right.index_select(0, arrays.send_idx[q]), wire_dtype,
                                      flags),
                consume_with(0, widen), None, group_factor=group_factor)
        return acc if node_fuse else combine_m(acc)

    return node_fn


def _bag_fns(plan: DistributedPlan, group, arrays: ShardArrays, leaf: torch.Tensor,
             global_colors) -> BagFns:
    """The bag-only kinds on a shard (DESIGN.md §19): the collapse sums its
    rows and all-reduces the ``[B, x, W]`` sums, so collapsed and joined
    tables are replicated; its apex filter reads the global coloring."""
    n_loc_pad, b, k = leaf.shape
    x_dim = plan.n

    def leaf_fn(i, nd):
        if nd.pin:
            t = leaf[:, :, None, :] * arrays.pin_adj[:, None, :, None]
        else:
            t = leaf[:, :, None, :].expand(n_loc_pad, b, x_dim, k)
        return t.reshape(n_loc_pad, b, x_dim * k)

    def collapse_fn(i, child):
        w = child.shape[2] // x_dim
        r = group.all_reduce_sum(child.view(n_loc_pad, b * x_dim * w).sum(dim=0))
        r = r.view(b, x_dim, w)
        filt = torch.from_numpy(excluded_color_mask(plan.k, plan.program.nodes[i].size)).to(r.device)
        return (r * filt[global_colors().long()]).transpose(0, 1).contiguous()

    def join_fn(i, tbl, left, right):
        return ops.color_combine(left, right, tbl)

    return BagFns(leaf_fn, collapse_fn, join_fn)


def make_count_fn(plan: DistributedPlan, mesh, *, mode: str = "adaptive", group_factor: int = 1,
                  fuse: bool = False, hockney: HockneyModel = V5E_ICI,
                  wire_dtype: str = "float32", adaptive: str = "model", keyed: bool = False,
                  return_raw: bool = False):
    """The distributed count function on ``mesh`` (``comm.LocalMesh`` or a
    ``launch.mesh.process_mesh``), whose data axis has ``plan.num_shards``
    ranks.

    Default contract: ``f(colorings) -> counts``, colorings int
    ``[I, P, n_loc_pad]`` (the :func:`shard_coloring` layout of I
    colorings, I a multiple of the mesh's iteration ranks) and counts
    float64 ``[I]`` on the host (colorful map counts; times ``plan.scale``
    for copy estimates), ``[I, R]`` for a family plan.  ``keyed=True``:
    ``f(keys [I, 2]) -> counts``, each rank drawing :func:`global_coloring`
    of its keys.  Every rank returns the same counts.

    ``fuse=True`` never holds a node's whole neighbor sum: the fused kernel
    over the alltoall buffer, and per-chunk fused counts added into the
    output table on the incremental modes.  ``adaptive="measured"``
    replaces the assumed Hockney constants with :func:`comm.calibrate`'s on
    this mesh before the routes are fixed.

    A compacted plan (``plan.compaction``) ships its sparse tables' active
    rows and gathers its sparse combines; ``wire_dtype`` (``"float32"``,
    ``"int16"`` or ``"int8"``) narrows every payload.  Either makes the
    program speculative: each rank ANDs its per-coloring flags, the
    failures are all-reduced with the counts, and where any coloring of the
    call overflowed or saturated, the whole batch runs again on the next
    rung (int8 -> int16 -> float32 with the same compaction -> the dense
    float32 twin), each built once and kept.  ``f.rung`` names the rung
    that gave the last call's counts (``"int16 compact"``, ``"float32
    dense"``, ...), ``f.fallbacks`` counts the calls that went up a rung.

    ``return_raw=True`` (the dry-run's; not with ``keyed``) returns
    ``(program, structs)`` in place of ``f``: ``program(ctx, colorings)`` is
    one rank's program with no mesh and no host wrapper around it, the
    reference's raw contract (``distributed.py:708-727``).  ``colorings`` is
    the rank's int ``[B, n_loc_pad]`` on the mesh's device; the rank reads
    its shard's arrays (:meth:`DistributedPlan.shard_arrays`) and the split
    tables from the plan.  It returns the counts on the device, ``[B I,
    R]`` gathered over the iteration ranks, and on a speculative program
    the failure column beside them: the first rung only, never copied to
    the host and never checked there.  ``structs`` is ``(colorings,)``, one
    coloring a rank (as the reference's raw program takes) on the mesh's
    device.
    """
    if keyed and return_raw:
        raise ValueError("keyed and return_raw are exclusive")
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype={wire_dtype!r}; expected one of {sorted(WIRE_DTYPES)}")
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; expected one of {MODES}")
    if adaptive not in ("model", "measured"):
        raise ValueError(f"adaptive={adaptive!r}; expected 'model' or 'measured'")
    if mesh.data_size != plan.num_shards:
        raise ValueError(f"the plan has {plan.num_shards} shards; the mesh {mesh.data_size} "
                         f"data ranks")
    if getattr(mesh, "pod_size", 1) > 1:
        raise ValueError(f"the counting engine runs on a data x iteration mesh: fold the "
                         f"{mesh.pod_size} pods into the iteration axis (as the reference's "
                         f"iter_axis=('pod', 'model'); make_production_mesh's counting view)")
    if mesh.device != plan.device:
        raise ValueError(f"the plan's split tables are on {plan.device}; the mesh runs on "
                         f"{mesh.device}")
    if mode == "adaptive" and adaptive == "measured":
        hockney = calibrate(mesh, base=hockney)
    node_modes = {i: (_route(plan, i, hockney, group_factor, wire_dtype)[0]
                      if mode == "adaptive" else mode)
                  for i in _exchange_nodes(plan)}
    dev, ss, n_iter_ranks = mesh.device, plan.shard_size, mesh.iter_size
    compact_on = plan.compaction is not None and plan.compaction.enabled
    narrow = wire_dtype != "float32"
    speculative = compact_on or narrow
    masked = _frontier_tables(plan, node_modes, fuse) if compact_on else frozenset()
    # bag roots (collapse, join) are replicated by their collapse's
    # all-reduce: summing them over the shards again would count P times;
    # a speculative program's failure count rides the same all-reduce
    root_w = [0.0 if plan.program.nodes[r].kind in ("bag_collapse", "bag_join") else 1.0
              for r in plan.program.roots] + [1.0] * speculative
    w_root = torch.tensor(root_w, dtype=torch.float64, device=dev)
    mixed_roots = 0.0 in root_w

    def gathered_colors(ctx, colorings: torch.Tensor):
        """The global coloring of a rank's ``[bl, n_loc_pad]`` rows, for the
        bag collapses' apex filter."""

        def global_colors():
            got = ctx.data.all_gather(colorings[:, :ss].contiguous())  # [P, bl, ss]
            return got.transpose(0, 1).reshape(colorings.shape[0], -1)[:, : plan.n]

        return global_colors

    def count_rank(ctx, colorings: torch.Tensor, global_colors) -> torch.Tensor:
        """One rank's counts of its ``[bl, n_loc_pad]`` colorings, on the
        device: ``[bl I, R (+ 1)]``, reduced over the data ranks and gathered
        over the iteration ranks."""
        bl = colorings.shape[0]
        arrays = plan.shard_arrays(ctx.data.rank, dev)
        leaf = leaf_table(colorings, plan.k, ss)
        flags: List[torch.Tensor] = []
        node_fn = _node_fn(plan, arrays, ctx.data, node_modes, fuse, group_factor, wire_dtype,
                           flags)
        bag = _bag_fns(plan, ctx.data, arrays, leaf, global_colors) if plan.has_bags else None
        frontier_fn = make_frontier_fn({}, ss, flags, masked) if masked else None
        roots = run_table_program(plan.program, plan.combine, leaf, ss, node_fn,
                                  root_fn=root_count, bag=bag, frontier_fn=frontier_fn)
        partials = torch.stack(roots, dim=1)  # [bl, R] float64
        if speculative:
            ok = torch.ones(bl, dtype=torch.bool, device=dev)
            for fl in flags:
                ok &= fl
            partials = torch.cat([partials, (~ok).to(torch.float64)[:, None]], dim=1)
        if mixed_roots:
            counts = ctx.data.all_reduce_sum(partials * w_root) + partials * (1.0 - w_root)
        else:
            counts = ctx.data.all_reduce_sum(partials)
        return ctx.iters.all_gather(counts).reshape(bl * n_iter_ranks, -1)

    if return_raw:
        def program(ctx, colorings: torch.Tensor) -> torch.Tensor:
            return count_rank(ctx, colorings, gathered_colors(ctx, colorings))

        return program, (torch.empty((1, plan.n_loc_pad), dtype=torch.int32, device=dev),)

    def rank_fn(ctx, data: torch.Tensor) -> torch.Tensor:
        p, i = ctx.data.rank, ctx.iters.rank
        bl = data.shape[0] // n_iter_ranks
        mine = data[i * bl: (i + 1) * bl]
        if keyed:
            full = prng.randint_keys(mine, (plan.n,), 0, plan.k, device=dev)  # global_coloring's
            rows = (p * ss + torch.arange(plan.n_loc_pad, device=dev)).clamp(max=plan.n - 1)
            colorings = full[:, rows]  # rows past n take a clipped (edgeless) color

            def global_colors():
                return full
        else:
            colorings = mine[:, p].to(dev)
            global_colors = gathered_colors(ctx, colorings)
        return count_rank(ctx, colorings, global_colors).cpu()

    def f(data) -> torch.Tensor:
        data = data if torch.is_tensor(data) else torch.tensor(np.asarray(data))
        if data.shape[0] % n_iter_ranks:
            raise ValueError(f"{data.shape[0]} colorings do not split over {n_iter_ranks} "
                             f"iteration ranks")
        if keyed:
            if data.dim() != 2 or data.shape[1] != 2:
                raise ValueError(f"keys must be [I, 2]; got {tuple(data.shape)}")
        elif tuple(data.shape[1:]) != (plan.num_shards, plan.n_loc_pad):
            raise ValueError(f"colorings must be [I, {plan.num_shards}, {plan.n_loc_pad}]; got "
                             f"{tuple(data.shape)}")
        out = run(data)
        return out if plan.is_multi else out[:, 0]

    rung = f"{wire_dtype} {'compact' if compact_on else 'dense'}"
    twin: Dict[str, object] = {}

    def run(data) -> torch.Tensor:
        """``[I, R]`` counts of a validated call, up the ladder as needed."""
        out = mesh.run(lambda ctx: rank_fn(ctx, data))[0]
        if not speculative:
            f.rung = rung
            return out
        counts, bad = out[:, :-1].contiguous(), out[:, -1]
        # the fault sites force a saturation or overflow storm, so tests
        # drive the ladder without a lucky coloring (the reference's order)
        forced = narrow and faults.fire("compression.saturate") is not None
        forced = forced or (compact_on and faults.fire("compaction.overflow") is not None)
        if not forced and not bool((bad > 0).any()):
            f.rung = rung
            return counts
        nxt = twin.get("fn")
        if nxt is None:
            nxt = twin["fn"] = make_count_fn(
                plan if narrow else dataclasses.replace(plan, compaction=None), mesh,
                mode=mode, group_factor=group_factor, fuse=fuse, hockney=hockney,
                wire_dtype=WIRE_ESCALATION.get(wire_dtype, "float32"), keyed=keyed)
        f.fallbacks += 1
        counts = nxt.run(data)
        f.rung = nxt.rung
        return counts

    f.node_modes = node_modes  # node -> the schedule it runs (adaptive resolved)
    f.run = run
    f.rung = None
    f.fallbacks = 0
    return f


def _frontier_tables(plan: DistributedPlan, node_modes, fuse: bool) -> frozenset:
    """The tables whose activity mask a compacted program reads: a right
    child shipped compacted under its parent's mode (ring: a shard
    capacity; alltoall and pipeline: an exchange capacity), and the left
    child of an unfused compact combine.  Leaves are dense."""
    spec = plan.compaction
    want = set()
    for i in _exchange_nodes(plan):
        nd = plan.program.nodes[i]
        caps = spec.shard_caps if node_modes[i] == "ring" else spec.exchange_caps
        if nd.right in caps:
            want.add(nd.right)
        if i in spec.combine_caps and not fuse:
            want.add(nd.left)
    return frozenset(j for j in want if plan.program.nodes[j].kind != "leaf")


def keyed_sample_fn(plan: DistributedPlan, mesh, **kw):
    """The estimator's protocol over the distributed backend:
    ``sample_fn(key, batch) -> float64 [batch]`` copy estimates (``[batch,
    R]`` for a family plan), from ``prng.split(key, batch)`` iteration keys,
    as the reference's ``keyed_sample_fn`` splits them.  The key count is
    rounded up to a multiple of the mesh's iteration ranks and the surplus
    estimates dropped.  ``kw`` goes to :func:`make_count_fn`."""
    f = make_count_fn(plan, mesh, keyed=True, **kw)
    isz = mesh.iter_size
    scales = np.asarray(plan.scales, np.float64)

    def sample(key: prng.Key, batch: int) -> np.ndarray:
        b = -(-batch // isz) * isz
        counts = f(prng.split(key, b)).numpy().astype(np.float64)
        if plan.is_multi:
            return counts[:batch] * scales[None, :]
        return counts.reshape(-1)[:batch] * plan.scale

    return sample
