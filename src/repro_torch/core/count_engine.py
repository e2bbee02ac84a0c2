"""Single-device color-coding DP engine (trees), on the card or the CPU.

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

The DP uses ``d = 1`` in the recurrence and divides the final count by
``|Aut(T)|`` once (DESIGN.md §1), so a fixed coloring's count is exactly
testable against the brute-force oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from . import prng
from .graphs import Graph, edge_list
from .table_program import (
    build_node_tables,
    leaf_table,
    local_node_fn,
    root_count,
    run_table_program,
)
from .templates import PartitionChain, Tree, automorphism_count, template_program

__all__ = [
    "CountingPlan",
    "build_counting_plan",
    "colorful_map_count",
    "draw_colorings",
    "count_fn",
    "plan_sample_fn",
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

    tree: Tree
    chain: PartitionChain
    k: int  # color budget: the template's size
    n: int
    n_pad: int
    aut: int
    spmm_plan: ops.SpmmPlan
    combine: Dict[int, ops.CombineTables]  # internal node index -> tables
    widths: Dict[int, int]  # node index -> table width
    device: torch.device
    #: route each internal node through the fused SpMM->combine kernel
    fuse: bool = False

    @property
    def scale(self) -> float:
        """Maps the colorful map count to the copy estimate."""
        return copy_scale(self.k, self.tree.n, self.aut)


def build_counting_plan(
    g: Graph,
    tree: Tree,
    *,
    root: int = 0,
    spmm_kind: str = "edges",
    fuse: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> CountingPlan:
    """Plan a tree template on graph ``g``: the adjacency and split tables go
    to ``device`` (default ``cuda``; pass ``device="cpu"`` for the plain
    versions).  ``spmm_kind`` is ``"edges"``, ``"blocks"`` or ``"auto"``
    (``ops.build_spmm_plan``); ``fuse`` takes effect on edge plans.
    """
    dev = resolve_device(device)
    chain = template_program(tree, root=root)
    k = tree.n
    rows, cols = edge_list(g)
    spmm_plan = ops.build_spmm_plan(rows, cols, g.n, kind=spmm_kind, device=dev)
    combine, widths = build_node_tables(chain, k, device=dev)
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
    )


def _as_colorings(plan: CountingPlan, coloring) -> torch.Tensor:
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
    if single:
        c = c[None]
    leaf = leaf_table(c, plan.k, plan.n)
    node_fn = local_node_fn(plan.spmm_plan, fuse=plan.fuse)
    (maps,) = run_table_program(plan.chain, plan.combine, leaf, plan.n, node_fn,
                                root_fn=root_count)
    return maps[0] if single else maps


def draw_colorings(plan: CountingPlan, batch: int, key: prng.Key) -> torch.Tensor:
    """``[batch, n_pad]`` int32 colorings uniform in ``{0..k-1}`` on the plan's
    device: the reference's ``jax.random.randint(key, (batch, n_pad), 0, k,
    dtype=int32)`` (``count_engine.py:547``), bit for bit."""
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


def plan_sample_fn(plan: CountingPlan):
    """Adapt a plan to the estimator's backend protocol: ``sample_fn(key,
    batch) -> float64 [batch]`` copy estimates for ``batch`` colorings
    drawn from ``key`` (the reference's protocol, ``count_engine.py:600``)."""
    fns: Dict[int, Callable] = {}

    def sample(key: prng.Key, batch: int) -> np.ndarray:
        f = fns.get(batch)
        if f is None:
            f = fns[batch] = count_fn(plan, batch)
        _, est = f(key)
        return est.cpu().numpy().astype(np.float64).reshape(-1)

    return sample
