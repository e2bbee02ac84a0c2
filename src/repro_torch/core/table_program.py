"""The table program: the partition-DP executor (dense, in core, trees).

Counterpart of ``repro/core/table_program.py``.  Walk the partition nodes in
topological order, keep a table ``C_node [n_pad, B, W]`` per live node, and
at each internal node contract the left child against the neighbor sum of
the right child.  The neighbor-sum strategy is the ``node_fn`` callback
(:func:`local_node_fn`: SpMM then combine, or the fused kernel that never
holds ``M``); the executor owns leaf construction, pad-row re-masking after
every combine, reference-counted table lifetimes and the root reduction.

Tables run at true widths, so there are no pad columns to mask; pad rows
are zeroed in place, which costs no copy of a multi-gigabyte table.  The
frontier (compaction), bag-template and distributed-exchange arguments of
the reference wait for their slices (ROADMAP queue 1 items 4, 5 and 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from ..kernels import ops

__all__ = [
    "build_node_tables",
    "leaf_table",
    "run_table_program",
    "root_count",
    "local_node_fn",
]

#: strategy signature: (node_index, combine_tables, c_left, c_right) ->
#: output table [n_pad, B, S] of that internal node (pad rows unspecified)
NodeFn = Callable[[int, ops.CombineTables, torch.Tensor, torch.Tensor], torch.Tensor]


def build_node_tables(
    program, k: int, *, device: torch.device
) -> Tuple[Dict[int, ops.CombineTables], Dict[int, int]]:
    """Per-node split tables and table widths of a tree program."""
    combine: Dict[int, ops.CombineTables] = {}
    widths: Dict[int, int] = {}
    for i, nd in enumerate(program.nodes):
        if nd.kind == "leaf":
            widths[i] = k
        else:
            t1 = program.nodes[nd.left].size
            t2 = program.nodes[nd.right].size
            tables = ops.build_combine_tables(k, t1, t2, device=device)
            combine[i] = tables
            widths[i] = tables.s
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
    root_fn: Callable[[torch.Tensor], torch.Tensor],
) -> tuple:
    """Execute a tree program; returns one value per ``program.roots`` entry.

    Every leaf shares the single ``leaf`` table; each internal node's output
    from ``node_fn`` gets its pad rows (``>= n``) zeroed before anyone reads
    it.  Table lifetime is reference-counted from ``program.table_reads()``:
    a table is dropped the moment its last reader has consumed it.
    ``root_fn`` (e.g. :func:`root_count`) reduces each root table as soon as
    it is built.
    """
    reads = list(program.table_reads())
    want: Dict[int, int] = {}
    for r in program.roots:
        want[r] = want.get(r, 0) + 1
    live: Dict[int, torch.Tensor] = {}  # node index -> table still to be read
    delivered: Dict[int, torch.Tensor] = {}
    for i, nd in enumerate(program.nodes):
        if nd.kind == "leaf":
            out = leaf  # leaves are dense: every vertex has a color
        else:
            out = node_fn(i, combine[i], live[nd.left], live[nd.right])
            out[n:] = 0.0
        # the children just had one read each consumed; free at zero
        for c in nd.children[::-1]:
            reads[c] -= 1
            if reads[c] == 0:
                live.pop(c, None)
        if i in want:
            delivered[i] = root_fn(out)
            reads[i] -= want[i]
        if reads[i] > 0:
            live[i] = out
        del out
    return tuple(delivered[r] for r in program.roots)


def root_count(root: torch.Tensor) -> torch.Tensor:
    """Colorful map counts from a root table: ``sum_{v, S} C_root[v, b, S]``
    per coloring ``b``, accumulated in float64 (pad rows are zero)."""
    return root.sum(dim=(0, 2), dtype=torch.float64)


def local_node_fn(spmm_plan: ops.SpmmPlan, *, fuse: bool = False) -> NodeFn:
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
    """

    def node_fn(i, tbl, c_left, c_right):
        if fuse and spmm_plan.kind == "edges":
            return ops.fused_count(spmm_plan.indptr, spmm_plan.indices, c_left, c_right, tbl)
        return ops.color_combine(c_left, ops.spmm(spmm_plan, c_right), tbl)

    return node_fn
