"""Exact (exponential) oracles for testing the color-coding DP.

``count_embedding_maps`` counts injective maps of the template into the
graph (rooted-anywhere, i.e. plain subgraph-isomorphism maps); the number
of subgraph *copies* is ``maps / |Aut(T)|``.  The backtracking extends
candidates along a BFS spanning tree and then checks every remaining
template edge, so any connected template with an ``adjacency()`` is exact
(for trees the extra check is vacuous).  A copy of
``repro.core.brute_force``: the oracle of the port's tests and of the small
phase of ``chip_smoke.py``.

``count_colorful_maps`` counts only maps whose image uses pairwise-distinct
colors under a fixed coloring — the quantity the DP computes exactly (for a
fixed coloring the DP is deterministic, so the two must agree exactly; this
is the strongest correctness oracle available and is exercised heavily by
the property tests).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .graphs import Graph

__all__ = ["count_embedding_maps", "count_colorful_maps", "count_copies"]


def _bfs_order(tree):
    """Template vertices in BFS order from 0, with parent pointers."""
    adj = tree.adjacency()
    order = [0]
    parent = {0: -1}
    i = 0
    while i < len(order):
        v = order[i]
        i += 1
        for u in adj[v]:
            if u not in parent:
                parent[u] = v
                order.append(u)
    return order, parent


def _count_maps(g: Graph, tree, coloring: Optional[np.ndarray]) -> int:
    order, parent = _bfs_order(tree)
    n = g.n
    k = tree.n
    total = 0
    assignment = np.full(k, -1, np.int64)
    used_vertices = set()
    used_colors = set()
    # host adjacency as sets, for the non-spanning-tree edge checks
    gadj = [set(int(u) for u in g.neighbors(v)) for v in range(n)]
    tadj = tree.adjacency()

    def rec(i: int) -> int:
        if i == len(order):
            return 1
        tv = order[i]
        tp = parent[tv]
        count = 0
        candidates = range(n) if tp < 0 else g.neighbors(assignment[tp])
        for gv in candidates:
            gv = int(gv)
            if gv in used_vertices:
                continue
            # every template edge whose other end is already placed must be
            # a host edge too (trees: only tp is placed, already satisfied)
            ok = True
            for tu in tadj[tv]:
                if tu == tp:
                    continue
                gu = assignment[tu]
                if gu >= 0 and gv not in gadj[int(gu)]:
                    ok = False
                    break
            if not ok:
                continue
            if coloring is not None:
                c = int(coloring[gv])
                if c in used_colors:
                    continue
                used_colors.add(c)
            used_vertices.add(gv)
            assignment[tv] = gv
            count += rec(i + 1)
            assignment[tv] = -1
            used_vertices.discard(gv)
            if coloring is not None:
                used_colors.discard(int(coloring[gv]))
        return count

    total = rec(0)
    return total


def count_embedding_maps(g: Graph, tree) -> int:
    """Number of injective maps (labeled embeddings) of the template into g."""
    return _count_maps(g, tree, None)


def count_colorful_maps(g: Graph, tree, coloring: np.ndarray) -> int:
    """Number of injective maps whose image is colorful under ``coloring``."""
    return _count_maps(g, tree, np.asarray(coloring))


def count_copies(g: Graph, tree) -> float:
    """Number of non-induced subgraph copies of the template in g."""
    from .templates import automorphism_count

    return count_embedding_maps(g, tree) / automorphism_count(tree)
