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
from . import prng
from .colorsets import excluded_color_mask
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
    "colorful_map_count_many",
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


def _graph_plan(g: Graph, program, spmm_kind: str, k: int, dev: torch.device):
    """The SpMM plan, split tables, widths and (for bag programs) pinned
    adjacency of ``program`` on ``g``."""
    has_bags = program_has_bags(program)
    rows, cols = edge_list(g)
    spmm_plan = ops.build_spmm_plan(rows, cols, g.n, kind=spmm_kind, device=dev)
    combine, widths = build_node_tables(program, k, device=dev,
                                        x_dim=g.n if has_bags else None)
    pin_adj = _build_pin_adj(g, spmm_plan.n_pad, dev) if has_bags else None
    return spmm_plan, combine, widths, pin_adj


def build_counting_plan(
    g: Graph,
    tree: Union[Tree, Template],
    *,
    root: int = 0,
    spmm_kind: str = "edges",
    fuse: bool = False,
    n_colors: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> CountingPlan:
    """Plan a template on graph ``g``: the adjacency and split tables go to
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the plain
    versions).  ``spmm_kind`` is ``"edges"``, ``"blocks"`` or ``"auto"``
    (``ops.build_spmm_plan``); ``fuse`` takes effect on the tree nodes of
    edge plans.  ``n_colors`` widens the color budget past the template
    size (a single template counted as a family member with shared ``k``).

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
    spmm_plan, combine, widths, pin_adj = _graph_plan(g, chain, spmm_kind, k, dev)
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
) -> MultiCountingPlan:
    """One plan for a whole template family: compile the set into a shared
    :class:`~.templates.TemplateDag` and build each unique node's split
    tables once (options as :func:`build_counting_plan`)."""
    dev = resolve_device(device)
    dag = compile_templates(templates, n_colors=n_colors, roots=roots)
    spmm_plan, combine, widths, pin_adj = _graph_plan(g, dag, spmm_kind, dag.k, dev)
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

    def node_fn(i, tbl, c_left, c_right):
        if program.nodes[i].kind != "bag_combine":
            return base_fn(i, tbl, c_left, c_right)
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


def _program_counts(plan, program, colorings: torch.Tensor) -> tuple:
    """Run ``program`` on ``[B, n_pad]`` colorings; one float64 ``[B]`` of
    colorful map counts per program root."""
    leaf = leaf_table(colorings, plan.k, plan.n)
    node_fn = local_node_fn(plan.spmm_plan, fuse=plan.fuse)
    bag = None
    if program_has_bags(program):
        bag = _bag_fns(plan, program, colorings, leaf)
        node_fn = _bag_node_fn(plan, program, node_fn)
    return run_table_program(program, plan.combine, leaf, plan.n, node_fn,
                             root_fn=root_count, bag=bag)


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
    are ignored.  Runs on the plan's device.
    """
    c = _as_colorings(plan, coloring)
    single = c.dim() == 1
    (maps,) = _program_counts(plan, plan.chain, c[None] if single else c)
    return maps[0] if single else maps


def colorful_map_count_many(plan: MultiCountingPlan, coloring) -> torch.Tensor:
    """Per-template colorful map counts for fixed colorings, in one pass over
    the deduplicated DAG: float64 ``[num_templates]`` for one coloring
    (``[n]`` or ``[n_pad]``), ``[B, num_templates]`` for a batch."""
    c = _as_colorings(plan, coloring)
    single = c.dim() == 1
    maps = torch.stack(_program_counts(plan, plan.dag, c[None] if single else c), dim=1)
    return maps[0] if single else maps


def draw_colorings(plan, batch: int, key: prng.Key) -> torch.Tensor:
    """``[batch, n_pad]`` int32 colorings uniform in ``{0..k-1}`` on the plan's
    device: the reference's ``jax.random.randint(key, (batch, n_pad), 0, k,
    dtype=int32)`` (``count_engine.py:547``), bit for bit.  A family plan
    draws with its shared ``k``, so a family run and a per-template run
    with ``n_colors=k`` see identical colorings for one key."""
    return prng.randint(key, (batch, plan.n_pad), 0, plan.k, device=plan.device)


def count_fn(
    plan: CountingPlan, batch: int = 1
) -> Callable[[prng.Key], Tuple[torch.Tensor, torch.Tensor]]:
    """Per-call counter ``f(key) -> (maps[B], estimates[B])``, float64 on the
    plan's device.

    Each call draws ``batch`` independent colorings from ``key`` and runs
    the DP once over all of them: every internal node is one launch with
    the batch as a table dimension.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")

    def f(key: prng.Key):
        maps = colorful_map_count(plan, draw_colorings(plan, batch, key))
        return maps, maps * plan.scale

    return f


def count_fn_many(
    plan: MultiCountingPlan, batch: int = 1
) -> Callable[[prng.Key], Tuple[torch.Tensor, torch.Tensor]]:
    """Family counter ``f(key) -> (maps[B, R], estimates[B, R])``, float64 on
    the plan's device: the colorings :func:`count_fn` draws from ``key``
    with ``n_colors=plan.k``, one DAG pass over all ``B`` of them."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    scales = torch.tensor(plan.scales, dtype=torch.float64, device=plan.device)

    def f(key: prng.Key):
        maps = colorful_map_count_many(plan, draw_colorings(plan, batch, key))
        return maps, maps * scales

    return f


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
