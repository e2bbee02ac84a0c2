"""Graph substrate: CSR storage, generators, edge-list ingestion.

A numpy copy of ``repro.core.graphs`` (generators give the same graph for
the same seed, bit for bit, and ``load_npz`` reads the reference's
``save_npz`` archives).  Graphs are undirected and stored in CSR with both
edge directions, which is what the color-coding neighbor sum consumes
(``M[v] += C[u]`` for every directed entry ``(v, u)``).  The CSR itself is
the layout the Hopper SpMM and fused-count kernels walk
(:func:`repro_torch.kernels.ops.build_spmm_plan`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Graph",
    "GraphFormatError",
    "from_edges",
    "from_csr",
    "erdos_renyi",
    "rmat",
    "relabel_random",
    "edge_list",
    "pad_vertices",
    "edge_tiles",
    "partition_edges_by_src_shard",
    "load_edge_file",
    "save_npz",
    "load_npz",
    "RMAT_SKEW",
]


class GraphFormatError(ValueError):
    """Malformed graph input, caught at ingestion with a precise message.

    Raised by :func:`load_edge_file` / :func:`load_npz` for non-integer or
    truncated lines (with the line number), out-of-range vertex ids, and
    missing/corrupt npz contents — so bad input fails at the door instead
    of crashing deep inside plan build.  Subclasses ``ValueError``, so
    pre-existing handlers keep working; pass ``validate=False`` to restore
    the old lenient behavior (skip unparseable lines, trust the arrays).
    """


@dataclass(frozen=True)
class Graph:
    """Undirected graph in CSR form (both directions stored)."""

    n: int
    indptr: np.ndarray  # int64 [n+1]
    indices: np.ndarray  # int32 [2m]
    name: str = ""

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return int(self.indices.shape[0]) // 2

    @property
    def num_directed(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    @property
    def avg_degree(self) -> float:
        return float(self.num_directed / max(self.n, 1))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def skewness(self) -> float:
        """max degree / avg degree — the paper's workload-skew indicator."""
        return self.max_degree / max(self.avg_degree, 1e-12)


def from_edges(n: int, edges: np.ndarray, name: str = "") -> Graph:
    """Build a Graph from an array of undirected edges [m, 2].

    Self loops and duplicate edges are removed.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size:
        edges = edges[edges[:, 0] != edges[:, 1]]
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n + hi
        _, first = np.unique(key, return_index=True)
        edges = np.stack([lo[first], hi[first]], axis=1)
    both = np.concatenate([edges, edges[:, ::-1]], axis=0) if edges.size else edges
    order = np.lexsort((both[:, 1], both[:, 0])) if both.size else np.array([], np.int64)
    both = both[order] if both.size else both.reshape(0, 2)
    counts = np.bincount(both[:, 0], minlength=n) if both.size else np.zeros(n, np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = both[:, 1].astype(np.int32) if both.size else np.zeros(0, np.int32)
    return Graph(n, indptr, indices, name)


def from_csr(n: int, indptr, indices, name: str = "") -> Graph:
    """Wrap existing CSR arrays (both edge directions already stored).

    The arrays are taken as they are, cast to the dtypes :class:`Graph`
    holds; this is how a caller hands the exact CSR of another graph
    object (the reference package's, a file's) to the port.
    """
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    if indptr.shape != (n + 1,) or int(indptr[-1]) != indices.shape[0]:
        raise GraphFormatError(
            f"CSR mismatch: indptr {indptr.shape} ending at "
            f"{int(indptr[-1]) if indptr.size else None} for n={n} and "
            f"{indices.shape[0]} indices"
        )
    return Graph(n, indptr, indices, name)


def load_edge_file(
    path: str,
    *,
    n: Optional[int] = None,
    comments: Tuple[str, ...] = ("#", "%"),
    zero_indexed: bool = True,
    name: str = "",
    validate: bool = True,
) -> Graph:
    """Load an undirected graph from a whitespace-separated edge-list file.

    The format accepted is the de-facto standard of SNAP / Network Repository
    dumps (the paper's Table 2 datasets ship this way): one ``u v`` pair per
    line, blank lines and lines starting with any prefix in ``comments``
    skipped, extra columns (weights, timestamps) ignored.  ``n`` defaults to
    ``max vertex id + 1``; ``zero_indexed=False`` shifts 1-based ids down.
    Self loops and duplicate edges are removed by :func:`from_edges`.

    With ``validate=True`` (default) malformed input raises
    :class:`GraphFormatError` naming the offending line: non-integer
    tokens, a single-column line (the signature of a truncated download),
    negative or out-of-range vertex ids.  ``validate=False`` is the escape
    hatch for dirty-but-known files: bad lines are skipped silently, as the
    pre-hardening loader did.
    """
    src, dst = [], []
    lo_bound = 0 if zero_indexed else 1
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith(comments):
                continue
            parts = line.split()
            if len(parts) < 2:
                if validate:
                    raise GraphFormatError(
                        f"{path}:{lineno}: expected 'u v', got {line!r} "
                        f"(truncated file?)"
                    )
                continue
            try:
                u, v = int(parts[0]), int(parts[1])
            except ValueError:
                if validate:
                    raise GraphFormatError(
                        f"{path}:{lineno}: non-integer vertex id in {line!r}"
                    ) from None
                continue
            if validate:
                if u < lo_bound or v < lo_bound:
                    raise GraphFormatError(
                        f"{path}:{lineno}: vertex id {min(u, v)} below "
                        f"{lo_bound} (zero_indexed={zero_indexed} wrong?)"
                    )
                if n is not None and max(u, v) - (0 if zero_indexed else 1) >= n:
                    raise GraphFormatError(
                        f"{path}:{lineno}: vertex id {max(u, v)} out of "
                        f"range for n={n}"
                    )
            src.append(u)
            dst.append(v)
    edges = np.array([src, dst], np.int64).T.reshape(-1, 2)
    if not zero_indexed and edges.size:
        edges -= 1
    if validate and edges.size == 0:
        raise GraphFormatError(
            f"{path}: no edges found (empty, truncated, or fully-commented "
            f"file) — pass validate=False if an empty graph is intended"
        )
    if edges.size and edges.min() < 0:
        raise GraphFormatError(f"negative vertex id in {path} (zero_indexed wrong?)")
    n_found = int(edges.max(initial=-1)) + 1
    if n is None:
        n = n_found
    elif n < n_found:
        raise GraphFormatError(f"n={n} smaller than max vertex id + 1 = {n_found}")
    return from_edges(n, edges, name or os.path.basename(path))


def save_npz(g: Graph, path: str) -> None:
    """Persist a graph's CSR arrays with ``np.savez_compressed``.

    Round-trips through :func:`load_npz`; the compressed CSR form loads
    orders of magnitude faster than re-parsing a text edge list, which is
    what makes repeat runs on real datasets practical.
    """
    np.savez_compressed(
        path,
        n=np.int64(g.n),
        indptr=g.indptr,
        indices=g.indices,
        name=np.str_(g.name),
    )


def load_npz(path: str, *, validate: bool = True) -> Graph:
    """Load a graph previously written by :func:`save_npz`.

    With ``validate=True`` (default) a file that is not a ``save_npz``
    graph fails with :class:`GraphFormatError` naming what's wrong — a
    missing key, a truncated/corrupt archive, an ``indptr`` that doesn't
    match ``indices``, or out-of-range vertex ids — instead of crashing
    deep in plan build.  ``validate=False`` trusts the arrays.
    """
    try:
        z = np.load(path, allow_pickle=False)
    except Exception as e:  # zipfile.BadZipFile, OSError, ...
        raise GraphFormatError(
            f"{path}: not a readable npz archive (truncated or corrupt? "
            f"{type(e).__name__}: {e})"
        ) from e
    with z:
        for k in ("n", "indptr", "indices"):
            if k not in z:
                raise GraphFormatError(f"{path}: missing npz key {k!r} — not a save_npz graph?")
        try:
            n = int(z["n"])
            indptr = z["indptr"].astype(np.int64)
            indices = z["indices"].astype(np.int32)
            graph_name = str(z["name"]) if "name" in z else ""
        except Exception as e:
            raise GraphFormatError(
                f"{path}: unreadable npz member (truncated archive? "
                f"{type(e).__name__}: {e})"
            ) from e
    if validate:
        if n < 0:
            raise GraphFormatError(f"{path}: negative vertex count n={n}")
        if indptr.shape != (n + 1,):
            raise GraphFormatError(
                f"{path}: indptr has shape {indptr.shape}, expected "
                f"({n + 1},) for n={n}"
            )
        if indptr.size and (indptr[0] != 0 or indptr[-1] != indices.shape[0]):
            raise GraphFormatError(
                f"{path}: indptr spans [{int(indptr[0])}, {int(indptr[-1])}] "
                f"but indices has {indices.shape[0]} entries (truncated "
                f"arrays?)"
            )
        if np.any(np.diff(indptr) < 0):
            raise GraphFormatError(f"{path}: indptr is not nondecreasing")
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            raise GraphFormatError(
                f"{path}: vertex id {int(indices.max())} out of range "
                f"[0, {n})"
            )
    return Graph(n=n, indptr=indptr, indices=indices, name=graph_name)


def erdos_renyi(n: int, avg_degree: float, seed: int = 0, name: str = "") -> Graph:
    """G(n, m) with m ~= n*avg_degree/2 sampled uniformly."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    edges = rng.integers(0, n, size=(int(m * 1.15) + 8, 2), dtype=np.int64)
    return from_edges(n, edges[:m] if len(edges) >= m else edges, name or f"er-{n}-{avg_degree}")


#: Mapping of the paper's PaRMAT "skewness k" knob to RMAT (a, b, c, d).
#: Higher a = heavier-tailed degree distribution; k=1 is near-uniform
#: (matches the paper: R250K1 has max degree 170 at avg 100, R250K8 has
#: 433K max at avg 217).
RMAT_SKEW = {
    1: (0.30, 0.25, 0.25, 0.20),
    3: (0.45, 0.22, 0.22, 0.11),
    8: (0.57, 0.19, 0.19, 0.05),
}


def rmat(
    n: int,
    num_edges: int,
    skew: int = 3,
    seed: int = 0,
    probs: Optional[Tuple[float, float, float, float]] = None,
    name: str = "",
) -> Graph:
    """R-MAT generator (Chakrabarti et al.), vectorized bit-recursive sampling.

    ``n`` is rounded up to the next power of two internally; vertices beyond
    ``n`` are folded back with a modulo, matching common practice.
    """
    a, b, c, d = probs if probs is not None else RMAT_SKEW[skew]
    scale = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    rng = np.random.default_rng(seed)
    m = num_edges
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.random(m)
        src <<= 1
        dst <<= 1
        # quadrant probabilities: a (0,0), b (0,1), c (1,0), d (1,1)
        q_b = (r >= a) & (r < a + b)
        q_c = (r >= a + b) & (r < a + b + c)
        q_d = r >= a + b + c
        dst += q_b | q_d
        src += q_c | q_d
    src %= n
    dst %= n
    return from_edges(n, np.stack([src, dst], 1), name or f"rmat-{n}-{num_edges}-s{skew}")


def relabel_random(g: Graph, seed: int = 0) -> Graph:
    """Random vertex relabeling — the paper's random-partition assumption.

    Contiguous block partitioning of a randomly relabeled graph is equivalent
    to random vertex partitioning (Eq. 5's E[N_r,w] = |E|/P^2 analysis).
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.n).astype(np.int64)
    rows, cols = edge_list(g)
    return from_edges(g.n, np.stack([perm[rows], perm[cols]], 1), g.name + "-shuf")


def edge_list(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Expanded directed edge list (rows nondecreasing)."""
    rows = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(g.indptr))
    return rows, g.indices.astype(np.int32)


def pad_vertices(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def edge_tiles(
    g: Graph, tile_size: int, n_pad: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Neighbor-list partitioning: fixed-size edge tiles with sentinel pad.

    Returns ``(rows, cols, num_tiles)`` with both arrays padded to
    ``num_tiles * tile_size``.  Padding entries point at the sentinel row
    ``n_pad`` (callers allocate ``n_pad + 1`` rows; the sentinel row of the
    operand table must be zero, and the sentinel output row is discarded).
    """
    rows, cols = edge_list(g)
    sentinel = g.n if n_pad is None else n_pad
    e = rows.shape[0]
    num_tiles = max((e + tile_size - 1) // tile_size, 1)
    padded = num_tiles * tile_size
    rows_p = np.full(padded, sentinel, np.int32)
    cols_p = np.full(padded, sentinel, np.int32)
    rows_p[:e] = rows
    cols_p[:e] = cols
    return rows_p, cols_p, num_tiles


def partition_edges_by_src_shard(
    g: Graph, num_shards: int, tile_size: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket each shard's incoming edges by the *source* shard of ``u``.

    For the pipelined (ring) exchange, device ``p`` processes, at ring step
    ``w``, only the edges ``(v, u)`` whose source vertex ``u`` lives in the
    shard arriving at step ``w``.  This routine builds, for every
    (dst-shard ``p``, src-shard ``q``) pair, the padded edge bucket:

    Returns ``(rows, cols, counts)``:
      * ``rows``  int32 [P, P, max_bucket] — local dst row (within shard p)
      * ``cols``  int32 [P, P, max_bucket] — local src row (within shard q)
      * ``counts`` int64 [P, P] — true bucket sizes (before padding)

    Padding entries use the sentinel local row ``shard_size`` (callers pad
    tables with one extra zero row).  ``max_bucket`` is rounded up to
    ``tile_size``.  Vertices are assigned to shards in contiguous blocks of
    ``ceil(n/P)``; combine with :func:`relabel_random` for the random
    partition of the paper.
    """
    P = num_shards
    shard_size = (g.n + P - 1) // P
    rows, cols = edge_list(g)
    p_of = rows // shard_size
    q_of = cols // shard_size
    counts = np.zeros((P, P), np.int64)
    np.add.at(counts, (p_of, q_of), 1)
    max_bucket = int(counts.max(initial=0))
    max_bucket = max(((max_bucket + tile_size - 1) // tile_size) * tile_size, tile_size)
    out_rows = np.full((P, P, max_bucket), shard_size, np.int32)
    out_cols = np.full((P, P, max_bucket), shard_size, np.int32)
    key = p_of * P + q_of
    order = np.argsort(key, kind="stable")
    skey = key[order]
    group_start = np.zeros(P * P, np.int64)
    np.cumsum(np.bincount(skey, minlength=P * P)[:-1], out=group_start[1:])
    pos_in_group = np.arange(len(order)) - group_start[skey]
    flat_rows = out_rows.reshape(P * P, max_bucket)
    flat_cols = out_cols.reshape(P * P, max_bucket)
    flat_rows[skey, pos_in_group] = (rows[order] - p_of[order] * shard_size).astype(np.int32)
    flat_cols[skey, pos_in_group] = (cols[order] - q_of[order] * shard_size).astype(np.int32)
    return out_rows, out_cols, counts
