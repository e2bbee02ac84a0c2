"""Plain color-coding reference: a tree template's colorful maps under one coloring.

Written from the algorithm (Alon, Yuster and Zwick; the paper's Algorithm 1)
in plain PyTorch, with its own template partition, color-set indexing and
automorphism count; it imports nothing of the program.

For a tree ``T`` rooted at vertex 0, each vertex ``x`` of ``T`` grows a
table over the host graph: ``C[v, S]`` counts the maps of the part of
``x``'s subtree built so far that send ``x`` to host vertex ``v``, are
edge-preserving, and use exactly the colors ``S`` (``|S|`` = the part's
size), each once.  It starts as the one-hot of ``v``'s color; each child
``y`` of ``x`` (in edge-list order) is folded in as

    N[v, S2]  = sum over neighbors u of v of C_y[u, S2]          (neighbor sum)
    C[v, S]  <- sum over S = S1 + S2 (disjoint) of C[v, S1] N[v, S2]

and the colorful map count is the sum of the root's table.  The copy
estimate of that coloring is ``maps k^t (k - t)! / k! / |Aut(T)|`` with
``k`` colors and ``t`` template vertices.

Precision: ``dtype=torch.float64`` is the reference.  Other dtypes store
every table in that dtype and round each operation's result to it (the
neighbor sum is summed in float32 and rounded, as a card's library sums a
bf16 product); the benchmark's control runs it in ``torch.bfloat16``.
Color-set combines run in blocks of vertices, so that no temporary passes
``block_elements`` entries.
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import Dict, List, Sequence, Tuple

import torch

#: entries of one block's gathered operands in a combine
BLOCK_ELEMENTS = 1 << 26


def automorphisms(n: int, edges: Sequence[Sequence[int]]) -> int:
    """|Aut(T)| of a tree: rooted at its center (or centers), the product over
    vertices of the automorphisms of their children's multiset of
    isomorphism classes."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    deg = [len(x) for x in adj]
    removed = [False] * n
    layer = [v for v in range(n) if deg[v] <= 1]
    left = n
    while left > 2:
        nxt = []
        for v in layer:
            removed[v] = True
            left -= 1
            for u in adj[v]:
                if not removed[u]:
                    deg[u] -= 1
                    if deg[u] == 1:
                        nxt.append(u)
        layer = nxt
    centers = [v for v in range(n) if not removed[v]]

    def canon(v: int, parent: int) -> Tuple[tuple, int]:
        kids = [canon(u, v) for u in adj[v] if u != parent]
        forms = sorted(f for f, _ in kids)
        aut = 1
        for _, a in kids:
            aut *= a
        for _, group in itertools.groupby(forms):
            aut *= math.factorial(len(list(group)))
        return tuple(forms), aut

    if len(centers) == 1:
        return canon(centers[0], -1)[1]
    (f1, a1), (f2, a2) = canon(centers[0], centers[1]), canon(centers[1], centers[0])
    return a1 * a2 * (2 if f1 == f2 else 1)


def copy_scale(k: int, t: int, aut: int) -> float:
    """``k^t (k - t)! / k! / aut``: colorful maps to a copy estimate."""
    return k ** t * math.factorial(k - t) / math.factorial(k) / aut


class ColorSets:
    """Color sets of each size as rows of ``itertools.combinations(range(k), t)``."""

    def __init__(self, k: int):
        self.k = k
        self._rank: Dict[int, Dict[tuple, int]] = {}
        self._splits: Dict[Tuple[int, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rank(self, t: int) -> Dict[tuple, int]:
        if t not in self._rank:
            self._rank[t] = {s: i for i, s in enumerate(itertools.combinations(range(self.k), t))}
        return self._rank[t]

    def splits(self, t1: int, t2: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(i1, i2)`` int64 ``[C(k, t1 + t2), C(t1 + t2, t1)]``: for output set
        ``s`` and split ``j``, the ranks of ``S1`` (size ``t1``) and ``S - S1``."""
        key = (t1, t2, str(device))
        if key not in self._splits:
            r1, r2 = self.rank(t1), self.rank(t2)
            i1, i2 = [], []
            for s in self.rank(t1 + t2):
                row1, row2 = [], []
                for s1 in itertools.combinations(s, t1):
                    row1.append(r1[s1])
                    row2.append(r2[tuple(c for c in s if c not in s1)])
                i1.append(row1)
                i2.append(row2)
            self._splits[key] = (torch.tensor(i1, dtype=torch.int64, device=device),
                                 torch.tensor(i2, dtype=torch.int64, device=device))
        return self._splits[key]


class Graph:
    """The host graph's adjacency as a sparse CSR matrix on ``device``."""

    def __init__(self, n: int, indptr, indices, device, dtype=torch.float64):
        self.n = n
        self.dtype = dtype
        # the neighbor sum's own precision: float64 for the reference,
        # float32 (rounded to ``dtype`` after) for lower precisions
        self.sum_dtype = torch.float64 if dtype == torch.float64 else torch.float32
        crow = torch.as_tensor(indptr).to(device=device, dtype=torch.int64)
        col = torch.as_tensor(indices).to(device=device, dtype=torch.int64)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.adj = torch.sparse_csr_tensor(
                crow, col, torch.ones(col.numel(), dtype=self.sum_dtype, device=device),
                size=(n, n), check_invariants=False)

    def neighbor_sum(self, table: torch.Tensor) -> torch.Tensor:
        out = torch.sparse.mm(self.adj, table.to(self.sum_dtype))
        return out.to(self.dtype)


def _combine(left: torch.Tensor, nsum: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
             block_elements: int) -> torch.Tensor:
    n = left.shape[0]
    s, j = i1.shape
    out = torch.empty((n, s), dtype=left.dtype, device=left.device)
    rows = max(1, block_elements // (s * j))
    for r0 in range(0, n, rows):
        a = left[r0:r0 + rows][:, i1]
        b = nsum[r0:r0 + rows][:, i2]
        out[r0:r0 + rows] = (a * b).sum(dim=-1)
        del a, b
    return out


def colorful_maps(graph: Graph, tree_n: int, tree_edges: Sequence[Sequence[int]],
                  coloring: torch.Tensor, k: int, *, sets: ColorSets = None,
                  block_elements: int = BLOCK_ELEMENTS) -> float:
    """Colorful maps of the tree ``(tree_n, tree_edges)`` under ``coloring``
    (int ``[n]`` in ``{0..k-1}``, on the graph's device), summed in float64."""
    sets = sets or ColorSets(k)
    dev = graph.adj.device
    adj: List[List[int]] = [[] for _ in range(tree_n)]
    for a, b in tree_edges:
        adj[a].append(b)
        adj[b].append(a)
    leaf = torch.nn.functional.one_hot(coloring.to(dev, torch.int64), k).to(graph.dtype)

    def grow(x: int, parent: int) -> Tuple[torch.Tensor, int]:
        table, size = leaf, 1
        for y in adj[x]:
            if y == parent:
                continue
            child, child_size = grow(y, x)
            nsum = graph.neighbor_sum(child)
            del child
            i1, i2 = sets.splits(size, child_size, dev)
            table = _combine(table, nsum, i1, i2, block_elements)
            del nsum
            size += child_size
        return table, size

    root, size = grow(0, -1)
    # ``grow`` refers to itself through its closure: the cycle would keep
    # the leaf table and the graph alive until the cyclic collector runs
    del grow
    if size != tree_n:
        raise ValueError(f"the edges reach {size} of the template's {tree_n} vertices")
    return float(root.to(torch.float64).sum())


def estimates(graph: Graph, templates: Sequence[Dict], coloring: torch.Tensor, k: int,
              **kw) -> List[float]:
    """Each template's copy estimate under one coloring with ``k`` colors;
    ``templates`` are ``{"n": t, "edges": [[a, b], ...]}``."""
    sets = ColorSets(k)
    out = []
    for t in templates:
        maps = colorful_maps(graph, t["n"], t["edges"], coloring, k, sets=sets, **kw)
        out.append(maps * copy_scale(k, t["n"], automorphisms(t["n"], t["edges"])))
    return out
