"""The float64 reference against brute force, written from the definition."""

import gc
import itertools
import weakref

import numpy as np
import pytest
import torch

from portbench.gen import rmat
from portbench.reference import colorcoding

TEMPLATES = {
    "u3-1": (3, [[0, 2], [0, 1]]),
    "u5-2": (5, [[0, 4], [0, 3], [0, 2], [0, 1]]),
    "u7-2": (7, [[0, 4], [4, 6], [4, 5], [0, 3], [0, 2], [0, 1]]),
    "path4": (4, [[0, 1], [1, 2], [2, 3]]),
    "spider6": (6, [[0, 1], [1, 2], [0, 3], [3, 4], [0, 5]]),
}


def _er(n, p, seed):
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1)
    a = a | a.T
    indptr = np.concatenate([[0], np.cumsum(a.sum(1))]).astype(np.int64)
    indices = np.nonzero(a)[1].astype(np.int32)
    return n, indptr, indices


def _rmat(n, m, seed):
    indptr, indices, _ = rmat.make_csr(
        {"vertices": n, "edges": m, "probs": [0.45, 0.22, 0.22, 0.11], "graph_seed": seed},
        "cpu")
    return n, indptr, indices


def brute_maps(n, indptr, indices, t, edges, coloring):
    """Injective edge-preserving maps of the template whose image's colors
    are pairwise distinct, enumerated one template vertex at a time."""
    adj = [set(indices[indptr[v]:indptr[v + 1]].tolist()) for v in range(n)]
    order = [0]
    for _ in range(t):
        for a, b in edges:
            for x, y in ((a, b), (b, a)):
                if x in order and y not in order:
                    order.append(y)
    images = {}

    def extend(i):
        if i == t:
            return 1
        x = order[i]
        count = 0
        for v in range(n):
            if v in images.values() or int(coloring[v]) in {int(coloring[u])
                                                             for u in images.values()}:
                continue
            if all(images[y] in adj[v] for a, b in edges for y in (a, b)
                   if x in (a, b) and y != x and y in images):
                images[x] = v
                count += extend(i + 1)
                del images[x]
        return count

    return extend(0)


def brute_automorphisms(t, edges):
    es = {frozenset(e) for e in map(tuple, edges)}
    return sum(1 for p in itertools.permutations(range(t))
               if {frozenset((p[a], p[b])) for a, b in edges} == es)


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_automorphisms(name):
    t, edges = TEMPLATES[name]
    assert colorcoding.automorphisms(t, edges) == brute_automorphisms(t, edges)


@pytest.mark.parametrize("graph", ["er", "rmat"])
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_reference_equals_brute_force(graph, name):
    n, indptr, indices = _er(12, 0.6, 3) if graph == "er" else _rmat(12, 90, 11)
    t, edges = TEMPLATES[name]
    g = colorcoding.Graph(n, indptr, indices, "cpu")
    rng = np.random.default_rng(5)
    seen_nonzero = False
    for k in (t, t + 2):
        for _ in range(3):
            coloring = rng.integers(0, k, n)
            want = brute_maps(n, indptr, indices, t, edges, coloring)
            got = colorcoding.colorful_maps(g, t, edges, torch.from_numpy(coloring), k)
            assert got == want
            seen_nonzero |= want > 0
    assert seen_nonzero


def test_estimate_is_maps_times_copy_scale():
    n, indptr, indices = _er(9, 0.6, 1)
    t, edges = TEMPLATES["u5-2"]
    g = colorcoding.Graph(n, indptr, indices, "cpu")
    coloring = torch.from_numpy(np.random.default_rng(0).integers(0, 7, n))
    maps = colorcoding.colorful_maps(g, t, edges, coloring, 7)
    (est,) = colorcoding.estimates(g, [{"n": t, "edges": edges}], coloring, 7)
    # 7^5 2! / 7! / 24: a copy is colorful with probability 7!/(2! 7^5)
    assert est == pytest.approx(maps * 7 ** 5 * 2 / 5040 / 24, rel=1e-15)


def test_blocked_combine_is_exact():
    n, indptr, indices = _rmat(300, 3000, 2)
    t, edges = TEMPLATES["u7-2"]
    g = colorcoding.Graph(n, indptr, indices, "cpu")
    coloring = torch.from_numpy(np.random.default_rng(1).integers(0, 7, n))
    whole = colorcoding.colorful_maps(g, t, edges, coloring, 7)
    blocked = colorcoding.colorful_maps(g, t, edges, coloring, 7, block_elements=50)
    assert whole == blocked > 0


def test_a_count_leaves_nothing_for_the_cyclic_collector():
    """Every table and the graph go when the count returns: a check of many
    colorings in one process holds one coloring's tables at a time."""
    n, indptr, indices = _rmat(300, 3000, 2)
    t, edges = TEMPLATES["u7-2"]
    g = colorcoding.Graph(n, indptr, indices, "cpu")
    coloring = torch.from_numpy(np.random.default_rng(1).integers(0, 7, n))
    gone = weakref.ref(g)
    gc.collect()
    gc.disable()
    try:
        assert colorcoding.colorful_maps(g, t, edges, coloring, 7) > 0
        del g
        assert gone() is None
    finally:
        gc.enable()
