"""The table program: the partition-DP executor (dense, in core).

Counterpart of ``repro/core/table_program.py``.  Walk the partition nodes in
topological order, keep a table ``C_node [n_pad, B, W]`` per live node, and
at each internal node contract the left child against the neighbor sum of
the right child.  The neighbor-sum strategy is the ``node_fn`` callback
(:func:`local_node_fn`: SpMM then combine, or the fused kernel that never
holds ``M``); the executor owns leaf construction, pad-row re-masking after
every combine, reference-counted table lifetimes and the root reduction.

A program is one template's :class:`~.templates.PartitionChain` or
:class:`~.templates.BagProgram`, or a whole family compiled into a
:class:`~.templates.TemplateDag`.  Treewidth-2 bag nodes (DESIGN.md §19)
carry the pinned apex's host vertex ``x`` as one more axis: a bag table is
``[n_pad, B, x * W]``, ``x`` blocks of width ``W`` per (vertex, coloring)
row.  A ``bag_combine`` goes through ``node_fn`` like a ``combine``; the
bag-only kinds (leaf, collapse, join) through :class:`BagFns`.  Collapsed
and joined tables live on the ``x`` axis, ``[n, B, W]``.

Tables run at true widths, so there are no pad columns to mask; pad rows
are zeroed in place, which costs no copy of a multi-gigabyte table.  A
compacted plan threads active-row frontiers (:mod:`.frontier`) through
the program: each ``combine`` table's frontier is computed once, freed with
the table and handed to every reader as ``f_left``/``f_right``.  The
distributed engine (:mod:`.distributed`) runs this executor per shard with
its exchange strategy as ``node_fn``; its compacted exchange reads the
frontiers' masks to ship only active rows.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from .frontier import CompactionSpec, Frontier, compact_combine

__all__ = [
    "build_node_tables",
    "leaf_table",
    "run_table_program",
    "root_count",
    "local_node_fn",
    "BagFns",
]

#: strategy signature: (node_index, combine_tables, c_left, c_right, f_left,
#: f_right) -> output table [n_pad, B, S] of that internal node (pad rows
#: unspecified); ``f_left``/``f_right`` are the children's frontiers (None
#: where dense)
NodeFn = Callable[[int, ops.CombineTables, torch.Tensor, torch.Tensor, Optional[Frontier],
                   Optional[Frontier]], torch.Tensor]

#: frontier hook: (node_index, masked table) -> Frontier or None
FrontierFn = Callable[[int, torch.Tensor], Optional[Frontier]]


class BagFns(NamedTuple):
    """Backend strategy for the three bag-only node kinds (DESIGN.md §19).

    ``bag_combine`` nodes flow through the ordinary ``node_fn``, whose
    strategy views ``[rows, B, x*W]`` tables as ``[rows, B*x, W]`` around its
    color convolution, so only the kinds with no tree analogue need
    callbacks here:

    * ``leaf_fn(i, nd)``: the bag leaf table ``[n_pad, B, x * k]``
      (``pin=True`` multiplies the one-hot by the apex adjacency);
    * ``collapse_fn(i, child)``: sum the finished forest-tree table over
      its vertex rows and apply the apex-color filter; returns ``[x, B, W]``;
    * ``join_fn(i, tbl, left, right)``: disjoint color-set convolution of
      two collapsed ``[x, B, W]`` tables on aligned rows.
    """

    leaf_fn: Callable[[int, object], torch.Tensor]
    collapse_fn: Callable[[int, torch.Tensor], torch.Tensor]
    join_fn: Callable[[int, ops.CombineTables, torch.Tensor, torch.Tensor], torch.Tensor]


def build_node_tables(
    program, k: int, *, device: torch.device, x_dim: Optional[int] = None
) -> Tuple[Dict[int, ops.CombineTables], Dict[int, int]]:
    """Per-node split tables and table widths (per coloring) of a program.

    ``x_dim`` (the host vertex count) is required when the program carries
    bag nodes: a ``bag_leaf`` is ``k * x`` wide, a ``bag_combine`` ``S * x``
    (``x`` blocks of the true width), and a ``bag_collapse`` its child's
    width over ``x``, since its rows are the ``x`` axis itself; a
    ``bag_join`` is ``S`` wide.
    """
    combine: Dict[int, ops.CombineTables] = {}
    widths: Dict[int, int] = {}
    for i, nd in enumerate(program.nodes):
        kind = nd.kind
        if kind.startswith("bag_") and x_dim is None:
            raise ValueError("bag-node programs need x_dim (host vertex count)")
        if kind == "leaf":
            widths[i] = k
        elif kind == "bag_leaf":
            widths[i] = k * x_dim
        elif kind == "bag_collapse":
            widths[i] = widths[nd.left] // x_dim
        else:  # "combine" / "bag_combine" / "bag_join": a color convolution
            t1 = program.nodes[nd.left].size
            t2 = program.nodes[nd.right].size
            tables = ops.build_combine_tables(k, t1, t2, device=device)
            combine[i] = tables
            widths[i] = tables.s * (x_dim if kind == "bag_combine" else 1)
    return combine, widths


def leaf_table(colorings: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Leaf tables ``[n_pad, B, k]``: one-hot of the ``[B, n_pad]`` colorings,
    rows ``>= n`` zeroed."""
    leaf = torch.nn.functional.one_hot(colorings.long().t(), k).to(torch.float32)
    leaf[n:] = 0.0
    return leaf.contiguous()


def run_table_program(
    program,
    combine: Mapping[int, ops.CombineTables],
    leaf: torch.Tensor,
    n: int,
    node_fn: NodeFn,
    root_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    frontier_fn: Optional[FrontierFn] = None,
    bag: Optional[BagFns] = None,
) -> tuple:
    """Execute a program; returns one value per ``program.roots`` entry.

    Every leaf shares the single ``leaf`` table; each ``combine`` or
    ``bag_combine`` output from ``node_fn`` gets its pad rows (``>= n``)
    zeroed before anyone reads it.  Collapse and join outputs have rows on
    the apex axis ``x``, which holds the ``n`` real vertices only, so they
    are not masked.  ``bag`` supplies the bag-only kinds (:class:`BagFns`);
    it is required iff the program carries bag nodes.  Table lifetime is
    reference-counted from ``program.table_reads()``: a table is dropped the
    moment its last reader has consumed it.  ``root_fn`` (e.g.
    :func:`root_count`) reduces each root table as soon as it is built
    (``None``: the root tables themselves).
    ``frontier_fn`` (a compacted plan's, :func:`.frontier.make_frontier_fn`)
    gives each ``combine`` table that has readers its frontier once, which
    lives as long as the table and reaches ``node_fn`` as ``f_left`` or
    ``f_right``.
    """
    reads = list(program.table_reads())
    want: Dict[int, int] = {}
    for r in program.roots:
        want[r] = want.get(r, 0) + 1
    live: Dict[int, torch.Tensor] = {}  # node index -> table still to be read
    frontiers: Dict[int, Frontier] = {}
    delivered: Dict[int, torch.Tensor] = {}
    for i, nd in enumerate(program.nodes):
        kind = nd.kind
        if kind.startswith("bag_") and bag is None:
            raise ValueError("program has bag nodes but no BagFns strategy")
        if kind == "leaf":
            out = leaf  # leaves are dense: every vertex has a color
        elif kind == "bag_leaf":
            out = bag.leaf_fn(i, nd)
        elif kind == "bag_collapse":
            out = bag.collapse_fn(i, live[nd.left])
        elif kind == "bag_join":
            out = bag.join_fn(i, combine[i], live[nd.left], live[nd.right])
        else:  # "combine" / "bag_combine": the neighbor-sum contraction
            out = node_fn(i, combine[i], live[nd.left], live[nd.right],
                          frontiers.get(nd.left), frontiers.get(nd.right))
            out[n:] = 0.0
        # the children just had one read each consumed; free at zero
        for c in nd.children[::-1]:
            reads[c] -= 1
            if reads[c] == 0:
                live.pop(c, None)
                frontiers.pop(c, None)
        if i in want:
            delivered[i] = root_fn(out) if root_fn is not None else out
            reads[i] -= want[i]
        if reads[i] > 0:
            live[i] = out
            if frontier_fn is not None and kind == "combine":
                fr = frontier_fn(i, out)
                if fr is not None:
                    frontiers[i] = fr
        del out
    return tuple(delivered[r] for r in program.roots)


def root_count(root: torch.Tensor) -> torch.Tensor:
    """Colorful map counts from a root table: ``sum_{v, S} C_root[v, b, S]``
    per coloring ``b``, accumulated in float64 (pad rows are zero).  A bag
    root's rows are the apex axis: the sum runs over ``(x, S)``.

    The float64 sum casts its input, so it runs over blocks of rows: a
    family's sub-``k`` roots are wide (``C(10, 5)`` columns at k = 10), and
    a float64 copy of a whole root table would double its bytes."""
    rows = max(1, ROOT_BLOCK_ELEMENTS // max(1, root[0].numel()))
    return torch.stack([blk.sum(dim=(0, 2), dtype=torch.float64)
                        for blk in root.split(rows)]).sum(dim=0)


#: elements of one block of :func:`root_count`'s float64 sum
ROOT_BLOCK_ELEMENTS = 1 << 26


def local_node_fn(
    spmm_plan: ops.SpmmPlan,
    *,
    fuse: bool = False,
    compaction: Optional[CompactionSpec] = None,
    sentinel_row: Optional[int] = None,
    flags: Optional[List[torch.Tensor]] = None,
) -> NodeFn:
    """The in-core neighbor-sum strategy: SpMM over the whole graph.

    The SpMM goes through the plan's format (``ops.spmm``: the edge kernel
    or the block-dense kernel).  With ``fuse=True`` on an edge plan each
    node is one ``ops.fused_count`` call that never holds the whole
    ``[n_pad, B, W]`` neighbor sum (the paper's fine-grained pipeline,
    §3.2, at kernel granularity).  The fused kernel walks the CSR, so a
    block plan runs block SpMM then combine, as the reference's
    ``ops.fused_count`` does on a plan without edge slabs.  ``M`` needs no
    pad-row mask: pad rows have no edges, so every SpMM writes them as
    exact zeros.

    With ``compaction`` (DESIGN.md §15): a right child carrying a compact
    frontier feeds the SpMM or the fused kernel as its compact table
    through the row-index indirection (``ops.spmm_compact``,
    ``ops.fused_count_compact``), and a node with a ``combine_caps`` entry
    contracts only the rows where the left table and the neighbor sum are
    both active (:func:`~.frontier.compact_combine`), appending its flags
    to ``flags``.  Such a node takes SpMM then combine even under ``fuse``:
    skipping inactive rows beats skipping ``M`` once the table is sparse.
    """

    def compact_right(c_right, f_right):
        """(compact table, inverse map), or (None, None) where dense."""
        if f_right is None or f_right.idx is None:
            return None, None
        return c_right.index_select(0, f_right.idx), f_right.inv

    def neighbor_sum(c_right, f_right):
        right_c, inv = compact_right(c_right, f_right)
        if right_c is not None:
            return ops.spmm_compact(spmm_plan, right_c, inv)
        return ops.spmm(spmm_plan, c_right)

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        cap = compaction.combine_caps.get(i) if compaction is not None else None
        if cap is not None:
            return compact_combine(c_left, neighbor_sum(c_right, f_right), tbl, cap,
                                   sentinel_row, flags,
                                   left_mask=f_left.mask if f_left is not None else None)
        if fuse and spmm_plan.kind == "edges":
            right_c, inv = compact_right(c_right, f_right)
            if right_c is not None:
                return ops.fused_count_compact(spmm_plan, c_left, right_c, inv, tbl)
            return ops.fused_count(spmm_plan.indptr, spmm_plan.indices, c_left, c_right, tbl)
        return ops.color_combine(c_left, neighbor_sum(c_right, f_right), tbl)

    return node_fn
