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

Beside trees: general :class:`Template` graphs with a one-vertex feedback
set compile to apex-pinned bag programs (:func:`bag_program`, DESIGN.md
§19), and a template family compiles into one deduplicated
:class:`TemplateDag` (:func:`compile_templates`, DESIGN.md §14).  A copy of
``repro.core.templates``, so that the port imports no JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ._template_profiles import SEARCHED_PROFILES

__all__ = [
    "Tree",
    "Template",
    "PartitionNode",
    "BagNode",
    "PartitionChain",
    "BagProgram",
    "TemplateDag",
    "compile_templates",
    "rooted_signature",
    "family_signature",
    "partition_tree",
    "bag_program",
    "template_program",
    "program_has_bags",
    "partition_complexity",
    "automorphism_count",
    "canonical_form",
    "path_tree",
    "star_tree",
    "spider_tree",
    "cycle_template",
    "random_tree",
    "realize_profile",
    "TEMPLATES",
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


# ---------------------------------------------------------------------------
# General (non-tree) templates: connected simple graphs of small treewidth
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Template:
    """An unrooted connected simple graph on ``n`` vertices.

    The treewidth-2 front end (:func:`bag_program`) compiles a ``Template``
    into a bag-table program by pinning an *apex* vertex whose removal leaves
    a forest: cycles, the diamond, the bowtie, the house, and every other
    small pattern with a one-vertex feedback set.  A ``Template`` that is a
    tree (``is_tree``) is converted with :meth:`as_tree` and compiled
    through the ordinary :func:`partition_tree` path, bit-identically.
    """

    n: int
    edges: Tuple[Tuple[int, int], ...]
    name: str = ""

    def __post_init__(self):
        seen_edges = set()
        for a, b in self.edges:
            if a == b:
                raise ValueError(f"template has a self-loop at vertex {a}")
            if not (0 <= a < self.n and 0 <= b < self.n):
                raise ValueError(f"edge ({a}, {b}) out of range for n={self.n}")
            e = (min(a, b), max(a, b))
            if e in seen_edges:
                raise ValueError(f"duplicate edge {e} in template")
            seen_edges.add(e)
        adj = self.adjacency()
        stack, seen = [0], {0}
        while stack:
            v = stack.pop()
            for u in adj[v]:
                if u not in seen:
                    seen.add(u)
                    stack.append(u)
        if len(seen) != self.n:
            raise ValueError("edge list does not describe a connected graph")

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

    @property
    def is_tree(self) -> bool:
        return len(self.edges) == self.n - 1

    def as_tree(self) -> Tree:
        """The same graph as a :class:`Tree` (valid only when ``is_tree``)."""
        if not self.is_tree:
            raise ValueError(f"template {self.name!r} is not a tree")
        return Tree(self.n, self.edges, self.name)


def cycle_template(n: int, name: str = "") -> Template:
    if n < 3:
        raise ValueError("cycles need at least 3 vertices")
    return Template(n, tuple((i, (i + 1) % n) for i in range(n)), name or f"cycle{n}")


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


def _graph_aut(t: Template) -> int:
    """|Aut| of a small general graph by degree-pruned backtracking."""
    if t.n > 10:
        raise ValueError(f"automorphism backtracking capped at n=10, got n={t.n}")
    adj = [set(ns) for ns in t.adjacency()]
    deg = [len(a) for a in adj]
    n = t.n
    perm = [-1] * n
    used = [False] * n
    count = 0

    def rec(i: int) -> None:
        nonlocal count
        if i == n:
            count += 1
            return
        for img in range(n):
            if used[img] or deg[img] != deg[i]:
                continue
            if all((j in adj[i]) == (perm[j] in adj[img]) for j in range(i)):
                perm[i] = img
                used[img] = True
                rec(i + 1)
                used[img] = False
        perm[i] = -1

    rec(0)
    return count


def automorphism_count(tree) -> int:
    """|Aut(T)| — AHU at the centroid for trees, backtracking for templates."""
    if isinstance(tree, Template):
        if tree.is_tree:
            return automorphism_count(tree.as_tree())
        return _graph_aut(tree)
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
# Apex-pinned tree decomposition (treewidth <= 2)
# ---------------------------------------------------------------------------
# A non-tree Template is compiled by choosing an *apex* vertex ``a`` whose
# removal leaves a forest F (a one-vertex feedback set; every cycle of the
# template passes through ``a``).  This is a width-2 tree decomposition in
# normal form: the apex sits in every bag {a, v, parent(v)} along each
# forest tree's partition spine, so bag tables carry one extra index ``x``
# (the host vertex the apex is mapped to) next to the usual (v, S).


def _marked_canon(
    adj: List[List[int]],
    D: frozenset,
    v: int,
    parent: int,
    banned: frozenset = frozenset(),
) -> tuple:
    """AHU canonical form of a forest subtree with apex-adjacency marks.

    Like :func:`_rooted_canon` but each vertex also carries whether it is
    adjacent to the apex (``v in D``): the mark changes the leaf table
    (pinned vs broadcast), so interning must distinguish it.
    """
    subs = sorted(
        _marked_canon(adj, D, u, v, banned)
        for u in adj[v]
        if u != parent and u not in banned
    )
    return (v in D, tuple(subs))


def _apex_plan(t: Template):
    """Choose the canonical apex of ``t`` and decompose the rest into trees.

    Returns ``(apex, forest_adj, D, roots)``: the apex vertex, the forest
    adjacency (apex removed), the set ``D`` of forest vertices adjacent to
    the apex, and one canonically chosen root per forest tree, ordered by
    ``(size, marked canonical form)`` so equal decompositions, across
    templates and across vertex labelings, compile to identical programs.
    """
    best_key = None
    best = None
    for a in range(t.n):
        forest_adj: List[List[int]] = [[] for _ in range(t.n)]
        ok = True
        parent_uf = list(range(t.n))

        def find(x: int) -> int:
            while parent_uf[x] != x:
                parent_uf[x] = parent_uf[parent_uf[x]]
                x = parent_uf[x]
            return x

        for u, w in t.edges:
            if a in (u, w):
                continue
            ru, rw = find(u), find(w)
            if ru == rw:
                ok = False  # T - a still has a cycle: a is not an apex
                break
            parent_uf[ru] = rw
            forest_adj[u].append(w)
            forest_adj[w].append(u)
        if not ok:
            continue
        D = frozenset(u for u, w in t.edges if w == a) | frozenset(w for u, w in t.edges if u == a)
        # forest components, each rooted at its canonically minimal vertex
        seen: set = set()
        trees = []
        for v0 in range(t.n):
            if v0 == a or v0 in seen:
                continue
            comp = [v0]
            seen.add(v0)
            stack = [v0]
            while stack:
                v = stack.pop()
                for u in forest_adj[v]:
                    if u not in seen:
                        seen.add(u)
                        comp.append(u)
                        stack.append(u)
            root = min(comp, key=lambda v: _marked_canon(forest_adj, D, v, -1))
            trees.append((len(comp), _marked_canon(forest_adj, D, root, -1), root))
        trees.sort(key=lambda e: (e[0], e[1]))
        key = tuple((s, c) for s, c, _ in trees)
        if best_key is None or key < best_key:
            best_key = key
            best = (a, forest_adj, D, tuple(r for _, _, r in trees))
    if best is None:
        raise ValueError(
            f"template {t.name or t.edges!r} is not apex-reducible: removing no "
            "single vertex leaves a forest.  The treewidth-2 front-end supports "
            "templates with a one-vertex feedback set (cycles, diamond, bowtie, "
            "house, chordal fans) — decompose wider patterns by hand or extend "
            "bag_program to multi-vertex bags."
        )
    return best


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
        """Node-kind protocol shared with :class:`BagNode`."""
        return "leaf" if self.is_leaf else "combine"

    @property
    def children(self) -> Tuple[int, ...]:
        return () if self.is_leaf else (self.left, self.right)


@dataclass(frozen=True)
class BagNode:
    """One node of a bag-table program (treewidth-2 front end).

    Bag tables are indexed by ``(v, x, S)``: the current sub-template root
    mapped to host vertex ``v``, the pinned apex mapped to ``x``, and the
    color set ``S`` of the *forest* vertices covered so far (``size`` of
    them; the apex color is kept outside ``S`` by the collapse filter).
    Kinds:

    * ``bag_leaf``: a single forest vertex; ``pin=True`` when it is
      adjacent to the apex in the template, which multiplies the one-hot
      color table by the host adjacency ``A[x, v]``.
    * ``bag_combine``: the ordinary tree combine (cut-first-child) run on
      bag tables; the same SpMM and color convolution, width ``x * S``.
    * ``bag_collapse``: sum the finished forest-tree table over ``v`` and
      apply the apex-color filter ``col(x) not in S``; output rows are the
      ``x`` axis (unary: only ``left`` is set).
    * ``bag_join``: disjoint color-set convolution of two collapsed
      forest-tree tables on aligned ``x`` rows (multi-tree forests, e.g.
      the bowtie).
    """

    kind: str
    size: int
    left: int = -1
    right: int = -1
    pin: bool = False

    @property
    def is_leaf(self) -> bool:
        return self.kind == "bag_leaf"

    @property
    def children(self) -> Tuple[int, ...]:
        if self.kind == "bag_leaf":
            return ()
        if self.kind == "bag_collapse":
            return (self.left,)
        return (self.left, self.right)


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


class _Interner:
    """Signature-keyed node interning shared by tree and bag compilation."""

    def __init__(self):
        self.sig2idx: Dict[tuple, int] = {}
        self.nodes: List = []
        self.sigs: List[tuple] = []

    def get(self, sig: tuple) -> Optional[int]:
        return self.sig2idx.get(sig)

    def put(self, sig: tuple, node) -> int:
        self.nodes.append(node)
        self.sigs.append(sig)
        self.sig2idx[sig] = len(self.nodes) - 1
        return len(self.nodes) - 1


def _compile_tree(it: _Interner, adj, v: int, parent: int, banned: frozenset) -> int:
    """Interned first-child partition of a (sub)tree; tree sigs are the raw
    AHU tuples, so they can never collide with the tagged bag signatures."""
    sig = _rooted_canon(adj, v, parent, banned)
    idx = it.get(sig)
    if idx is not None:
        return idx  # canonically identical subtree: reuse its table
    children = [u for u in adj[v] if u != parent and u not in banned]
    if not children:
        return it.put(sig, PartitionNode(1))
    cut = children[0]
    right = _compile_tree(it, adj, cut, v, banned)
    cut_sub = _collect_subtree(adj, cut, v, banned)
    left = _compile_tree(it, adj, v, parent, banned | cut_sub)
    size = it.nodes[left].size + it.nodes[right].size
    return it.put(sig, PartitionNode(size, left, right))


def _compile_bag_tree(
    it: _Interner, adj, D: frozenset, v: int, parent: int, banned: frozenset
) -> int:
    """Forest-tree recursion on bag tables: same cut policy, marked sigs."""
    children = [u for u in adj[v] if u != parent and u not in banned]
    if not children:
        pin = v in D
        sig = ("bagleaf", pin)
        idx = it.get(sig)
        if idx is not None:
            return idx
        return it.put(sig, BagNode("bag_leaf", 1, pin=pin))
    sig = ("bagc", _marked_canon(adj, D, v, parent, banned))
    idx = it.get(sig)
    if idx is not None:
        return idx
    cut = children[0]
    right = _compile_bag_tree(it, adj, D, cut, v, banned)
    cut_sub = _collect_subtree(adj, cut, v, banned)
    left = _compile_bag_tree(it, adj, D, v, parent, banned | cut_sub)
    size = it.nodes[left].size + it.nodes[right].size
    return it.put(sig, BagNode("bag_combine", size, left, right))


def _compile_bag(it: _Interner, t: Template) -> int:
    """Compile one non-tree template: per-forest-tree DP, collapse, join."""
    _, forest_adj, D, roots = _apex_plan(t)
    collapsed = []
    for r in roots:
        root_idx = _compile_bag_tree(it, forest_adj, D, r, -1, frozenset())
        sig = ("bagcol", it.sigs[root_idx])
        idx = it.get(sig)
        if idx is None:
            idx = it.put(sig, BagNode("bag_collapse", it.nodes[root_idx].size, root_idx))
        collapsed.append((it.nodes[idx].size, sig, idx))
    # canonical left-deep join order: joins are commutative, so sort first
    collapsed.sort(key=lambda e: (e[0], e[1]))
    cur_size, cur_sig, cur = collapsed[0]
    for nxt_size, nxt_sig, nxt in collapsed[1:]:
        sig = ("bagjoin", cur_sig, nxt_sig)
        idx = it.get(sig)
        if idx is None:
            idx = it.put(sig, BagNode("bag_join", cur_size + nxt_size, cur, nxt))
        cur_size, cur_sig, cur = cur_size + nxt_size, sig, idx
    return cur


@dataclass(frozen=True)
class BagProgram:
    """Bag-table program for one apex-reducible (non-tree) template.

    Program-protocol sibling of :class:`PartitionChain` (``roots`` /
    ``table_reads``): a postorder list of :class:`BagNode` whose last node,
    the final collapse or join, is the root.  The root table's rows are the
    apex axis ``x``; summing it (after the apex-color filter) over
    ``(x, S)`` counts colorful template maps, as summing a chain root over
    ``(v, S)`` does for trees.
    """

    nodes: Tuple[BagNode, ...]
    k: int
    template: Template

    @property
    def root_index(self) -> int:
        return len(self.nodes) - 1

    @property
    def roots(self) -> Tuple[int, ...]:
        return (self.root_index,)

    def table_reads(self) -> List[int]:
        return _table_reads(self.nodes, self.roots)

    def internal_nodes(self) -> List[Tuple[int, BagNode]]:
        return [(i, nd) for i, nd in enumerate(self.nodes) if not nd.is_leaf]


def bag_program(t: Template, *, n_colors: Optional[int] = None) -> BagProgram:
    """Compile a non-tree :class:`Template` into a :class:`BagProgram`."""
    if t.is_tree:
        raise ValueError(f"template {t.name!r} is a tree — use partition_tree(t.as_tree())")
    k = n_colors if n_colors is not None else t.n
    if k < t.n:
        raise ValueError(f"n_colors={k} is smaller than the template ({t.n})")
    it = _Interner()
    idx = _compile_bag(it, t)
    assert idx == len(it.nodes) - 1 and it.nodes[idx].size == t.n - 1
    return BagProgram(nodes=tuple(it.nodes), k=k, template=t)


def template_program(t, root: int = 0):
    """The single-template program, dispatching on template shape.

    Trees (and tree-shaped :class:`Template` objects) get the classic
    :func:`partition_tree` chain, bit-identically; apex-reducible non-trees
    get a :class:`BagProgram`.
    """
    t = template(t) if isinstance(t, str) else t
    if isinstance(t, Template):
        if not t.is_tree:
            return bag_program(t)
        t = t.as_tree()
    return partition_tree(t, root=root)


def program_has_bags(program) -> bool:
    """True when any node of the program needs the bag execution strategy."""
    return any(isinstance(nd, BagNode) for nd in program.nodes)


@dataclass(frozen=True)
class TemplateDag:
    """A set of templates compiled into one deduplicated DAG.

    Each node is a rooted sub-template keyed by its canonical form
    (:func:`_rooted_canon` for tree nodes, tagged marked forms for bag
    nodes); canonically identical subtrees across (and within) the compiled
    templates collapse to one node, so the DP computes every unique table
    once and each template's root reads its own entry.  ``nodes`` is
    topologically ordered (children before parents); ``roots[i]`` is
    template ``i``'s root node; ``sigs[i]`` is node ``i``'s signature.

    All tables are built against the shared color budget ``k`` (at least
    the largest template), which is what makes cross-template reuse sound:
    a node's table depends only on the rooted sub-template's isomorphism
    class and on ``k``, never on which template asked for it.
    """

    nodes: Tuple
    sigs: Tuple[tuple, ...]
    k: int
    roots: Tuple[int, ...]
    templates: Tuple

    @property
    def num_templates(self) -> int:
        return len(self.roots)

    def table_reads(self) -> List[int]:
        """Program protocol: reference count per node table (parent reads
        plus root deliveries); the executor frees a table at count zero."""
        return _table_reads(self.nodes, self.roots)

    def internal_nodes(self) -> List[Tuple[int, object]]:
        return [(i, nd) for i, nd in enumerate(self.nodes) if not nd.is_leaf]


def compile_templates(
    templates: Sequence,
    *,
    n_colors: Optional[int] = None,
    roots: Optional[Sequence[int]] = None,
) -> TemplateDag:
    """Compile a template family into one shared :class:`TemplateDag`.

    ``templates`` are :class:`Tree` or :class:`Template` objects or
    registered names.  Every tree is partitioned with the cut policy of
    :func:`partition_tree` (rooted at ``roots[i]``, default 0), but nodes
    are interned by rooted canonical signature: a sub-template whose
    signature was already produced (by an earlier template, an earlier
    branch of the same template, or a symmetric sibling) reuses the
    existing node.  Non-tree :class:`Template` members compile through the
    apex-pinned bag path into the same interner; tree-shaped ``Template``
    objects are converted to :class:`Tree` first, so they land on the
    identical tree-node path.

    ``n_colors`` fixes the shared color budget ``k`` (default: the largest
    template size).
    """
    trees = tuple(template(t) if isinstance(t, str) else t for t in templates)
    trees = tuple(t.as_tree() if isinstance(t, Template) and t.is_tree else t for t in trees)
    if not trees:
        raise ValueError("compile_templates needs at least one template")
    k_min = max(t.n for t in trees)
    k = n_colors if n_colors is not None else k_min
    if k < k_min:
        raise ValueError(f"n_colors={k} is smaller than the largest template ({k_min})")
    root_of = tuple(roots) if roots is not None else (0,) * len(trees)
    if len(root_of) != len(trees):
        raise ValueError("roots must match templates in length")

    it = _Interner()
    root_ids = []
    for tree, r in zip(trees, root_of):
        if isinstance(tree, Template):
            idx = _compile_bag(it, tree)
            # bag roots cover the forest (apex pinned on the x axis)
            assert it.nodes[idx].size == tree.n - 1
        else:
            idx = _compile_tree(it, tree.adjacency(), r, -1, frozenset())
            assert it.nodes[idx].size == tree.n
        root_ids.append(idx)
    return TemplateDag(
        nodes=tuple(it.nodes),
        sigs=tuple(it.sigs),
        k=k,
        roots=tuple(root_ids),
        templates=trees,
    )


def rooted_signature(tree, root: int = 0) -> tuple:
    """Canonical signature of ``tree`` rooted at ``root``.

    The signature :func:`compile_templates` interns tree nodes by: two
    templates with equal rooted signatures are isomorphic as rooted trees,
    so they compile to the same DAG node and carry the same ``|Aut|``.
    Non-tree templates get a tagged apex-decomposition signature instead
    (``root`` is ignored: bag programs have a canonical apex), a complete
    isomorphism invariant for apex-reducible graphs.
    """
    t = template(tree) if isinstance(tree, str) else tree
    if isinstance(t, Template):
        if not t.is_tree:
            return _bag_signature(t)
        t = t.as_tree()
    return _rooted_canon(t.adjacency(), root, -1)


def _bag_signature(t: Template) -> tuple:
    """Label-independent identity of the apex decomposition of ``t``: the
    marked forest (component canonical forms and apex-adjacency marks)
    reconstructs the template up to isomorphism, and the apex choice is
    itself canonical, so equal signatures mean isomorphic templates."""
    _, forest_adj, D, roots = _apex_plan(t)

    def canon_size(c: tuple) -> int:
        return 1 + sum(canon_size(s) for s in c[1])

    canons = [_marked_canon(forest_adj, D, r, -1) for r in roots]
    return ("bag", tuple(sorted((canon_size(c), c) for c in canons)))


def family_signature(templates: Sequence, n_colors: Optional[int] = None) -> tuple:
    """Order-insensitive identity of a compiled template family:
    ``(k, sorted unique rooted signatures)``, the identity of the DAG
    :func:`compile_templates` produces up to column order."""
    trees = tuple(template(t) if isinstance(t, str) else t for t in templates)
    if not trees:
        raise ValueError("family_signature needs at least one template")
    k_min = max(t.n for t in trees)
    k = n_colors if n_colors is not None else k_min
    if k < k_min:
        raise ValueError(f"n_colors={k} is smaller than the largest template ({k_min})")
    return (k, tuple(sorted(set(rooted_signature(t) for t in trees))))


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

TEMPLATES: Dict[str, object] = {}  # named Tree and (non-tree) Template entries
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


def _register_nontree_templates() -> None:
    """Treewidth-2 registry entries compiled via the apex-pinned bag path."""
    entries = (
        cycle_template(3, "cycle3"),  # triangle
        cycle_template(4, "cycle4"),
        cycle_template(5, "cycle5"),
        cycle_template(6, "cycle6"),
        # K4 minus an edge: two deg-3 apexes, forest = a path, all pinned
        Template(4, ((0, 1), (0, 2), (1, 2), (1, 3), (2, 3)), "diamond"),
        # two triangles sharing a vertex: the one 2-tree forest that joins
        Template(5, ((0, 1), (0, 2), (1, 2), (2, 3), (2, 4), (3, 4)), "bowtie"),
        # square with a triangular roof (apex on the roof ridge)
        Template(5, ((0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)), "house"),
    )
    for t in entries:
        _apex_plan(t)  # refuse to register a non-apex-reducible entry
        TEMPLATES[t.name] = t


_register_named_templates()
_register_nontree_templates()


def template(name: str):
    """Look up a named template: trees (u3-1 .. u15-2) or treewidth-2
    patterns (cycle3 .. cycle6, diamond, bowtie, house)."""
    if name not in TEMPLATES:
        raise KeyError(f"unknown template {name!r}; have {sorted(TEMPLATES)}")
    return TEMPLATES[name]
