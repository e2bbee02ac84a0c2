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
fused.  Compacted exchange and the narrow wire (DESIGN.md §15, §18) wait
for ROADMAP queue 1 item 7, shape-only plans for item 9: they raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..comm import (
    V5E_ICI,
    HockneyModel,
    calibrate,
    choose_mode_full,
    grouped_exchange,
    ring_allgather_overlap,
)
from ..device import resolve_device
from ..kernels import ops
from . import prng
from .colorsets import excluded_color_mask
from .count_engine import copy_scale
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

_ITEM7 = "ROADMAP queue 1 item 7"


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
    auts: Tuple[int, ...]
    combine: Dict[int, ops.CombineTables]
    widths: Dict[int, int]  # true widths, per coloring (and per apex vertex x on bag nodes)
    send_idx: np.ndarray  # [P, P, r_pad] int32: send_idx[q, p] = rows q sends to p
    bucket_counts: np.ndarray  # [P, P] edges of bucket (dst shard, src shard)
    shards: Tuple[ShardArrays, ...]  # on the host
    device: torch.device
    _on_device: Dict[tuple, ShardArrays] = dataclasses.field(default_factory=dict, repr=False,
                                                             compare=False)

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
    (``cuda`` unless the caller asks for the CPU).  ``compact=True``, the
    compacted exchange, is ROADMAP queue 1 item 7; the reference's other
    plan options (``bucket_tile``, the compaction knobs) are accepted and
    have no effect here.
    """
    if compact:
        raise NotImplementedError(f"the compacted exchange (compact=True) is {_ITEM7}")
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

    return DistributedPlan(
        templates=tuple(templates),
        program=program,
        k=k,
        n=g.n,
        num_shards=Pn,
        shard_size=ss,
        n_loc_pad=n_loc_pad,
        r_pad=r_pad,
        auts=tuple(automorphism_count(t) for t in templates),
        combine=combine,
        widths=widths,
        send_idx=send_idx,
        bucket_counts=counts,
        shards=tuple(shards),
        device=dev,
    )


def abstract_plan(*args, **kwargs):
    """The reference's shape-only plan for dry-run lowering
    (``distributed.py:427``): goes with the dry-run, ROADMAP queue 1 item 9."""
    raise NotImplementedError("abstract_plan goes with the dry-run: ROADMAP queue 1 item 9")


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


def node_exchange_bytes(plan: DistributedPlan, i: int, mode: str) -> int:
    """Bytes a rank ships for node ``i``'s exchange, per coloring: ``P - 1``
    peers times the rows of one chunk (``r_pad`` requested rows, or the
    ``n_loc_pad`` rows of a relayed shard on ``ring``) times the right
    child's true width in float32 (the dense part of the reference's
    ``frontier.node_exchange_bytes``; its widths are padded to 128 lanes,
    the port's are not).  A batch of B colorings ships B times this."""
    nd = plan.program.nodes[i]
    rows = plan.n_loc_pad if mode == "ring" else plan.r_pad
    return (plan.num_shards - 1) * rows * plan.widths[nd.right] * 4


def _node_flops(plan: DistributedPlan, i: int) -> float:
    """A rank's compute consuming node ``i``'s exchange, per coloring: the
    SpMM's ``2 E_dev W`` and the combine's ``2 n_loc_pad x S J``."""
    nd = plan.program.nodes[i]
    tbl = plan.combine[i]
    edges_dev = float(plan.bucket_counts.sum()) / plan.num_shards
    spmm_flops = 2.0 * edges_dev * plan.widths[nd.right]
    x = plan.n if nd.kind == "bag_combine" else 1
    return spmm_flops + 2.0 * plan.n_loc_pad * x * tbl.s * tbl.j


def _route(plan: DistributedPlan, i: int, model: HockneyModel, group_factor: int):
    return choose_mode_full(node_exchange_bytes(plan, i, "alltoall"),
                            node_exchange_bytes(plan, i, "ring"), _node_flops(plan, i),
                            plan.num_shards, model, group_factor)


def _exchange_nodes(plan: DistributedPlan):
    return [i for i, nd in enumerate(plan.program.nodes) if nd.kind in ("combine", "bag_combine")]


def _check_wire(wire_dtype: str) -> None:
    if wire_dtype != "float32":
        raise NotImplementedError(f"wire_dtype={wire_dtype!r}: the narrow wire is {_ITEM7}")


def plan_route_report(plan: DistributedPlan, *, mode: str = "adaptive", group_factor: int = 1,
                      wire_dtype: str = "float32", adaptive: str = "model",
                      hockney: HockneyModel = V5E_ICI, mesh=None) -> dict:
    """Per-node routes and the modeled costs behind them, for plan reports.

    With ``adaptive="measured"`` and a mesh the model is
    :func:`comm.calibrate`'s; otherwise ``hockney`` (the reference's
    assumed constants by default).  Per exchanged node: the bytes of both
    wire layouts (:func:`node_exchange_bytes`), the flops, each schedule's
    modeled seconds and the mode taken."""
    _check_wire(wire_dtype)
    model, calibrated = hockney, False
    if adaptive == "measured" and mesh is not None:
        model = calibrate(mesh, base=hockney)
        calibrated = model is not hockney
    per_node = {}
    for i in _exchange_nodes(plan):
        picked, diag = _route(plan, i, model, group_factor)
        chosen = picked if mode == "adaptive" else mode
        per_node[i] = {
            "mode": chosen,
            "a2a_bytes": int(node_exchange_bytes(plan, i, "alltoall")),
            "ring_bytes": int(node_exchange_bytes(plan, i, "ring")),
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


def _node_fn(plan: DistributedPlan, arrays: ShardArrays, group, node_modes, fuse: bool,
             group_factor: int):
    """The exchange neighbor sum of one rank (see the module docstring)."""
    Pn, r_pad, x_dim = plan.num_shards, plan.r_pad, plan.n

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        is_bag = plan.program.nodes[i].kind == "bag_combine"
        node_fuse = fuse and not is_bag  # the fused kernel cannot pair the x blocks
        mode = node_modes[i]
        rows, b, w = c_right.shape

        def combine_m(m):
            if is_bag:
                out = ops.color_combine(c_left.view(rows, b * x_dim, -1),
                                        m.view(rows, b * x_dim, -1), tbl)
                return out.view(rows, b, x_dim * tbl.s)
            return ops.color_combine(c_left, m, tbl)

        if mode == "alltoall":
            chunks = c_right.index_select(0, arrays.send_idx.view(-1)).view(Pn, r_pad, b, w)
            remote = group.all_to_all(chunks).view(Pn * r_pad, b, w)
            del chunks
            if node_fuse:
                return ops.fused_count_rect(arrays.a2a, c_left, remote, tbl)
            return combine_m(ops.spmm_rect(arrays.a2a, remote))

        view = 1 if mode == "ring" else 0  # shard rows, or request slots

        def consume(acc, chunk, src):
            csr = arrays.buckets.csr(src, view)
            part = (ops.fused_count_rect(csr, c_left, chunk, tbl) if node_fuse
                    else ops.spmm_rect(csr, chunk))
            return part if acc is None else acc.add_(part)

        if mode == "ring":
            acc = ring_allgather_overlap(group, c_right, consume, None)
        else:
            acc = grouped_exchange(group, lambda q: c_right.index_select(0, arrays.send_idx[q]),
                                   consume, None, group_factor=group_factor)
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
                  wire_dtype: str = "float32", adaptive: str = "model", keyed: bool = False):
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
    this mesh before the routes are fixed.  A narrow ``wire_dtype`` is
    ROADMAP queue 1 item 7.
    """
    _check_wire(wire_dtype)
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; expected one of {MODES}")
    if adaptive not in ("model", "measured"):
        raise ValueError(f"adaptive={adaptive!r}; expected 'model' or 'measured'")
    if mesh.data_size != plan.num_shards:
        raise ValueError(f"the plan has {plan.num_shards} shards; the mesh {mesh.data_size} "
                         f"data ranks")
    if mesh.device != plan.device:
        raise ValueError(f"the plan's split tables are on {plan.device}; the mesh runs on "
                         f"{mesh.device}")
    if mode == "adaptive" and adaptive == "measured":
        hockney = calibrate(mesh, base=hockney)
    node_modes = {i: (_route(plan, i, hockney, group_factor)[0] if mode == "adaptive" else mode)
                  for i in _exchange_nodes(plan)}
    dev, ss, n_iter_ranks = mesh.device, plan.shard_size, mesh.iter_size
    # bag roots (collapse, join) are replicated by their collapse's
    # all-reduce: summing them over the shards again would count P times
    w_root = torch.tensor([0.0 if plan.program.nodes[r].kind in ("bag_collapse", "bag_join")
                           else 1.0 for r in plan.program.roots], dtype=torch.float64,
                          device=dev)
    mixed_roots = bool((w_root == 0.0).any())

    def rank_fn(ctx, data: torch.Tensor) -> torch.Tensor:
        p, i = ctx.data.rank, ctx.iters.rank
        bl = data.shape[0] // n_iter_ranks
        arrays = plan.shard_arrays(p, dev)
        mine = data[i * bl: (i + 1) * bl]
        if keyed:
            full = prng.randint_keys(mine, (plan.n,), 0, plan.k, device=dev)  # global_coloring's
            rows = (p * ss + torch.arange(plan.n_loc_pad, device=dev)).clamp(max=plan.n - 1)
            colorings = full[:, rows]  # rows past n take a clipped (edgeless) color

            def global_colors():
                return full
        else:
            colorings = mine[:, p].to(dev)

            def global_colors():
                got = ctx.data.all_gather(colorings[:, :ss].contiguous())  # [P, bl, ss]
                return got.transpose(0, 1).reshape(bl, -1)[:, : plan.n]

        leaf = leaf_table(colorings, plan.k, ss)
        node_fn = _node_fn(plan, arrays, ctx.data, node_modes, fuse, group_factor)
        bag = _bag_fns(plan, ctx.data, arrays, leaf, global_colors) if plan.has_bags else None
        roots = run_table_program(plan.program, plan.combine, leaf, ss, node_fn,
                                  root_fn=root_count, bag=bag)
        partials = torch.stack(roots, dim=1)  # [bl, R] float64
        if mixed_roots:
            counts = ctx.data.all_reduce_sum(partials * w_root) + partials * (1.0 - w_root)
        else:
            counts = ctx.data.all_reduce_sum(partials)
        return ctx.iters.all_gather(counts).reshape(bl * n_iter_ranks, -1).cpu()

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
        out = mesh.run(lambda ctx: rank_fn(ctx, data))[0]
        return out if plan.is_multi else out[:, 0]

    f.node_modes = node_modes  # node -> the schedule it runs (adaptive resolved)
    return f


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
