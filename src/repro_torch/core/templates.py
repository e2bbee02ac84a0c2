"""Tree templates ("treelets"), partition chains, and automorphism counting.

A template is an unrooted tree ``T`` on ``k`` vertices.  Color-coding
partitions a rooted copy of ``T`` recursively: at each step the sub-template
``T_i`` (rooted at ``rho``) is split by cutting the edge to one child ``c``,
producing ``T_i'`` (same root, without ``c``'s subtree) and ``T_i''`` (``c``'s
subtree rooted at ``c``).  The result is a binary *partition chain* whose
leaves are single vertices.  The DP computes one count table per chain node,
in postorder.

The paper's Table 3 complexity figures are reproduced by
:func:`partition_complexity` with the paper's convention (sum over internal
nodes ``1 < |T_i| < k``):

    memory  = sum_i C(k, |T_i|)
    compute = sum_i C(k, |T_i|) * C(|T_i|, |T_i'|)

Because both quantities depend only on the *split profile* (the binary tree
of sizes), the named templates below are realized from profiles found to
exactly match Table 3 (see ``tools/find_templates.py``).

This is the tree subset of ``repro.core.templates``, copied so that the
port imports no JAX: general ``Template`` graphs, bag programs and template
families wait for their slices (ROADMAP queue 1 items 3 and 5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ._template_profiles import SEARCHED_PROFILES

__all__ = [
    "Tree",
    "PartitionNode",
    "PartitionChain",
    "partition_tree",
    "template_program",
    "partition_complexity",
    "automorphism_count",
    "canonical_form",
    "path_tree",
    "star_tree",
    "spider_tree",
    "random_tree",
    "realize_profile",
    "TEMPLATES",
    "NONTREE_TEMPLATES",
    "template",
]


# ---------------------------------------------------------------------------
# Tree representation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tree:
    """An unrooted tree on ``n`` vertices given by an edge list.

    ``children_order`` matters only through the partition cut policy: the
    partition always cuts the *first* child (in adjacency insertion order) of
    the current root, which lets profile-realized trees reproduce their
    profile exactly.
    """

    n: int
    edges: Tuple[Tuple[int, int], ...]
    name: str = ""

    def __post_init__(self):
        if len(self.edges) != self.n - 1:
            raise ValueError(
                f"tree on {self.n} vertices needs {self.n - 1} edges, got {len(self.edges)}"
            )
        seen = set()
        adj = self.adjacency()
        # connectivity check (BFS)
        stack, seen = [0], {0}
        while stack:
            v = stack.pop()
            for u in adj[v]:
                if u not in seen:
                    seen.add(u)
                    stack.append(u)
        if len(seen) != self.n:
            raise ValueError("edge list does not describe a connected tree")

    def adjacency(self) -> List[List[int]]:
        adj: List[List[int]] = [[] for _ in range(self.n)]
        for a, b in self.edges:
            adj[a].append(b)
            adj[b].append(a)
        return adj

    @property
    def k(self) -> int:
        """Number of colors used for this template (== template size)."""
        return self.n


def path_tree(n: int, name: str = "") -> Tree:
    return Tree(n, tuple((i, i + 1) for i in range(n - 1)), name or f"path-{n}")


def star_tree(n: int, name: str = "") -> Tree:
    return Tree(n, tuple((0, i) for i in range(1, n)), name or f"star-{n}")


def spider_tree(legs: Sequence[int], name: str = "") -> Tree:
    """A root with ``len(legs)`` paths of the given lengths attached."""
    edges = []
    nxt = 1
    for L in legs:
        prev = 0
        for _ in range(L):
            edges.append((prev, nxt))
            prev = nxt
            nxt += 1
    return Tree(nxt, tuple(edges), name or f"spider-{'-'.join(map(str, legs))}")


def random_tree(n: int, seed: int = 0) -> Tree:
    """Uniform random labeled tree via a random Prufer sequence."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if n == 1:
        return Tree(1, (), f"rand-{n}-{seed}")
    if n == 2:
        return Tree(2, ((0, 1),), f"rand-{n}-{seed}")
    prufer = rng.integers(0, n, size=n - 2)
    degree = [1] * n
    for p in prufer:
        degree[p] += 1
    edges = []
    import heapq

    leaves = [i for i in range(n) if degree[i] == 1]
    heapq.heapify(leaves)
    for p in prufer:
        leaf = heapq.heappop(leaves)
        edges.append((leaf, int(p)))
        degree[p] -= 1
        if degree[p] == 1:
            heapq.heappush(leaves, int(p))
    u = heapq.heappop(leaves)
    v = heapq.heappop(leaves)
    edges.append((u, v))
    return Tree(n, tuple(edges), f"rand-{n}-{seed}")


# ---------------------------------------------------------------------------
# Canonical form and automorphisms (AHU)
# ---------------------------------------------------------------------------


def _rooted_canon(
    adj: List[List[int]], v: int, parent: int, banned: frozenset = frozenset()
) -> tuple:
    subs = sorted(
        _rooted_canon(adj, u, v, banned)
        for u in adj[v]
        if u != parent and u not in banned
    )
    return tuple(subs)


def _rooted_aut(adj: List[List[int]], v: int, parent: int) -> int:
    """|Aut| of the rooted tree at v: products of child-group factorials."""
    groups: Dict[tuple, int] = {}
    total = 1
    for u in adj[v]:
        if u == parent:
            continue
        c = _rooted_canon(adj, u, v)
        groups[c] = groups.get(c, 0) + 1
        total *= _rooted_aut(adj, u, v)
    for mult in groups.values():
        total *= math.factorial(mult)
    return total


def _centroids(tree: Tree) -> List[int]:
    adj = tree.adjacency()
    n = tree.n
    if n == 1:
        return [0]
    size = [0] * n
    best = [n]
    cents: List[int] = []

    # iterative postorder to compute subtree sizes and max-component
    order = []
    parent = [-1] * n
    stack = [0]
    visited = [False] * n
    while stack:
        v = stack.pop()
        visited[v] = True
        order.append(v)
        for u in adj[v]:
            if not visited[u]:
                parent[u] = v
                stack.append(u)
    for v in reversed(order):
        size[v] = 1 + sum(size[u] for u in adj[v] if parent[u] == v)
    for v in range(n):
        comp = n - size[v]
        for u in adj[v]:
            if parent[u] == v:
                comp = max(comp, size[u])
        if comp < best[0]:
            best[0] = comp
            cents = [v]
        elif comp == best[0]:
            cents.append(v)
    return cents


def canonical_form(tree: Tree) -> tuple:
    """Canonical form of the unrooted tree (rooted at centroid)."""
    adj = tree.adjacency()
    cents = _centroids(tree)
    forms = sorted(_rooted_canon(adj, c, -1) for c in cents)
    return (len(cents),) + tuple(forms)


def automorphism_count(tree) -> int:
    """|Aut(T)| — AHU at the centroid."""
    adj = tree.adjacency()
    cents = _centroids(tree)
    if len(cents) == 1:
        return _rooted_aut(adj, cents[0], -1)
    c1, c2 = cents
    a1 = _rooted_aut(adj, c1, c2)
    a2 = _rooted_aut(adj, c2, c1)
    if _rooted_canon(adj, c1, c2) == _rooted_canon(adj, c2, c1):
        return 2 * a1 * a2
    return a1 * a2


# ---------------------------------------------------------------------------
# Partition chain
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PartitionNode:
    """One node of the binary partition chain.

    ``left``/``right`` index into :class:`PartitionChain.nodes`; -1 for leaf
    nodes (size-1 sub-templates).  ``left`` keeps the root (``T_i'``);
    ``right`` is the cut child subtree (``T_i''``).
    """

    size: int
    left: int = -1
    right: int = -1

    @property
    def is_leaf(self) -> bool:
        return self.left < 0

    @property
    def kind(self) -> str:
        return "leaf" if self.is_leaf else "combine"

    @property
    def children(self) -> Tuple[int, ...]:
        return () if self.is_leaf else (self.left, self.right)


@dataclass(frozen=True)
class PartitionChain:
    """Postorder list of partition nodes; the last node is the full template."""

    nodes: Tuple[PartitionNode, ...]
    k: int

    @property
    def root_index(self) -> int:
        return len(self.nodes) - 1

    @property
    def roots(self) -> Tuple[int, ...]:
        """Root nodes whose tables the executor must deliver: the chain root."""
        return (self.root_index,)

    def table_reads(self) -> List[int]:
        """Program protocol: how many times each node's table is read (by
        parents, plus one read per root delivery).  In a chain every node is
        the child of exactly one parent, so every count is 1."""
        return _table_reads(self.nodes, self.roots)

    def postorder(self) -> Tuple[PartitionNode, ...]:
        return self.nodes

    def internal_nodes(self) -> List[Tuple[int, PartitionNode]]:
        return [(i, nd) for i, nd in enumerate(self.nodes) if not nd.is_leaf]

    def profile(self) -> tuple:
        """Nested size profile, e.g. (5, (2, 1, 1), (3, ...))."""

        def rec(i: int):
            nd = self.nodes[i]
            if nd.is_leaf:
                return 1
            return (nd.size, rec(nd.left), rec(nd.right))

        return rec(self.root_index)


def partition_tree(tree: Tree, root: int = 0) -> PartitionChain:
    """Build the partition chain, cutting the first-listed child each time."""
    adj = tree.adjacency()
    nodes: List[PartitionNode] = []

    def rec(v: int, parent: int, banned: frozenset) -> int:
        """Partition the subtree at ``v`` excluding ``banned`` vertices.

        Returns the chain index of the created node.
        """
        children = [u for u in adj[v] if u != parent and u not in banned]
        if not children:
            nodes.append(PartitionNode(1))
            return len(nodes) - 1
        cut = children[0]
        # T'' = subtree rooted at cut (within the current sub-template)
        right = rec(cut, v, banned)
        right_size = nodes[right].size
        # T' = current sub-template minus cut's subtree: ban the cut subtree
        cut_sub = _collect_subtree(adj, cut, v, banned)
        left = rec(v, parent, banned | cut_sub)
        left_size = nodes[left].size
        nodes.append(PartitionNode(left_size + right_size, left, right))
        return len(nodes) - 1

    rec(root, -1, frozenset())
    chain = PartitionChain(tuple(nodes), tree.n)
    assert chain.nodes[chain.root_index].size == tree.n
    return chain


def _collect_subtree(adj, v, parent, banned) -> frozenset:
    out = {v}
    stack = [(v, parent)]
    while stack:
        x, p = stack.pop()
        for u in adj[x]:
            if u != p and u not in banned and u not in out:
                out.add(u)
                stack.append((u, x))
    return frozenset(out)


def partition_complexity(chain: PartitionChain, paper_convention: bool = True):
    """(memory, compute) complexity of a chain; see module docstring.

    With ``paper_convention=True`` only internal nodes with ``1 < t < k``
    count (this reproduces the paper's Table 3); otherwise all non-leaf nodes
    count (the true total table/compute footprint).
    """
    k = chain.k
    mem = 0
    comp = 0
    for _, nd in chain.internal_nodes():
        t = nd.size
        if paper_convention and t >= k:
            continue
        t1 = chain.nodes[nd.left].size
        mem += math.comb(k, t)
        comp += math.comb(k, t) * math.comb(t, t1)
    return mem, comp


def _table_reads(nodes: Sequence, roots: Sequence[int]) -> List[int]:
    reads = [0] * len(nodes)
    for nd in nodes:
        for c in nd.children:
            reads[c] += 1
    for r in roots:
        reads[r] += 1
    return reads


def template_program(t, root: int = 0) -> PartitionChain:
    """The single-template program: the :func:`partition_tree` chain.

    Only trees are ported so far; treewidth-2 templates (bag programs)
    are ROADMAP queue 1 item 5.
    """
    t = template(t) if isinstance(t, str) else t
    if not isinstance(t, Tree):
        raise NotImplementedError(
            f"only tree templates are ported (got {type(t).__name__}); "
            "treewidth-2 bag programs are ROADMAP queue 1 item 5"
        )
    return partition_tree(t, root=root)


# ---------------------------------------------------------------------------
# Profile realization: build a tree whose first-child partition reproduces a
# given nested size profile.
# ---------------------------------------------------------------------------


def realize_profile(profile, name: str = "") -> Tree:
    """Build a Tree whose partition chain has the given nested profile.

    A profile is ``1`` (single vertex) or ``(t, left_profile, right_profile)``
    where left keeps the root.  The cut child is attached *first* so that
    :func:`partition_tree`'s first-child policy cuts it.
    """
    edges: List[Tuple[int, int]] = []
    counter = [0]

    def rec(prof) -> int:
        """Returns root vertex id of the realized sub-tree."""
        if prof == 1:
            v = counter[0]
            counter[0] += 1
            return v
        _, left, right = prof
        # Realize the cut subtree first so it is the first child of the root.
        # Order of construction: root comes from left profile; right subtree
        # attaches to it as the FIRST child in adjacency insertion order.
        # We must create the left root before the right subtree would claim
        # adjacency priority; edges are inserted right-first below.
        right_root_placeholder: List[int] = []

        def build_right():
            r = rec(right)
            right_root_placeholder.append(r)
            return r

        # build left structure, get its root id
        lroot = rec(left)
        rroot = build_right()
        # attach: insert edge so that rroot is FIRST child of lroot.
        edges.insert(0, (lroot, rroot))
        return lroot

    root = rec(profile)
    n = counter[0]
    t = Tree(n, tuple(edges), name)
    # sanity: the realized tree must reproduce the profile
    got = partition_tree(t, root=root).profile()
    want = profile
    if got != want:
        raise AssertionError(f"profile realization failed: got {got}, want {want}")
    return t


# NOTE on ordering: Tree.adjacency() inserts neighbors in edge-list order, so
# prepending the (root, cut-child) edge makes the cut child the first-listed
# child at every level. realize_profile asserts this invariant.


# ---------------------------------------------------------------------------
# Named templates (paper Fig. 5 / Table 3)
# ---------------------------------------------------------------------------
# Profiles found by tools/find_templates.py to exactly reproduce Table 3's
# (memory, compute) complexity figures under the paper's convention.  Shapes
# for u3-1/u5-2/u7-2 are derived analytically (path-3, path-5, 2-leg spider).
# Larger profiles are search results.  Filled by _register_named_templates().

TEMPLATES: Dict[str, Tree] = {}  # named tree templates
TEMPLATE_TABLE3 = {
    # name: (memory, compute) from paper Table 3
    "u3-1": (3, 6),
    "u5-2": (25, 70),
    "u7-2": (147, 434),
    "u10-2": (1047, 5610),
    "u12-1": (4082, 24552),
    "u12-2": (3135, 38016),
    "u13": (4823, 109603),
    "u14": (7371, 242515),
    "u15-1": (12383, 753375),
    "u15-2": (15773, 617820),
}

# Nested split profiles (filled in from the profile search; see
# tools/find_templates.py).  ``1`` = leaf; ``(t, left, right)`` = internal.
_P3 = (3, (2, 1, 1), 1)
_P5 = (5, (4, (3, (2, 1, 1), 1), 1), 1)
_P7 = (7, (4, (3, (2, 1, 1), 1), 1), (3, (2, 1, 1), 1))

_NAMED_PROFILES: Dict[str, tuple] = {
    "u3-1": _P3,
    "u5-2": _P5,
    "u7-2": _P7,
    # the remaining profiles are tools/find_templates.py's search results
    # (the data module _template_profiles.py)
}


_NAMED_PROFILES.update(SEARCHED_PROFILES)


def _register_named_templates() -> None:
    # realize_profile raises on a broken realization: never registered
    for nm, prof in _NAMED_PROFILES.items():
        TEMPLATES[nm] = realize_profile(prof, name=nm)


#: treewidth-2 registry names of the reference package, not ported yet
NONTREE_TEMPLATES = (
    "cycle3", "cycle4", "cycle5", "cycle6", "diamond", "bowtie", "house",
)


_register_named_templates()


def template(name: str) -> Tree:
    """Look up a named tree template (u3-1 .. u15-2)."""
    if name in NONTREE_TEMPLATES:
        raise NotImplementedError(
            f"template {name!r} is a treewidth-2 pattern; bag programs are "
            "ROADMAP queue 1 item 5 of the PyTorch port"
        )
    if name not in TEMPLATES:
        raise KeyError(f"unknown template {name!r}; have {sorted(TEMPLATES)}")
    return TEMPLATES[name]
