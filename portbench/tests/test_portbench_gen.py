"""The device R-MAT generator, run on the CPU."""

import numpy as np
import pytest

from portbench.gen import rmat

CFG = {"vertices": 1000, "edges": 12000, "probs": [0.57, 0.19, 0.19, 0.05], "graph_seed": 5}


def _edges(indptr, indices):
    rows = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    return rows, indices


def test_one_graph_seed_one_graph_in_one_order():
    a = rmat.make_csr(CFG, "cpu")
    b = rmat.make_csr(CFG, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
    other = rmat.make_csr(dict(CFG, graph_seed=6), "cpu")
    assert not np.array_equal(np.sort(np.diff(a[0])), np.sort(np.diff(other[0])))


@pytest.mark.parametrize("n,m,probs", [(1000, 12000, [0.57, 0.19, 0.19, 0.05]),
                                       (777, 5000, [0.45, 0.22, 0.22, 0.11]),
                                       (64, 3000, [0.30, 0.25, 0.25, 0.20])])
def test_csr_is_symmetric_without_loops_or_duplicates(n, m, probs):
    indptr, indices, stats = rmat.make_csr({"vertices": n, "edges": m, "probs": probs,
                                            "graph_seed": 1}, "cpu")
    assert indptr.dtype == np.int64 and indices.dtype == np.int32
    assert indptr.shape == (n + 1,) and indptr[0] == 0 and indptr[-1] == indices.size
    assert np.all(np.diff(indptr) >= 0)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert indices.min() >= 0 and indices.max() < n
    assert not np.any(rows == indices)
    same_row = rows[1:] == rows[:-1]
    assert np.all(np.diff(indices.astype(np.int64))[same_row] > 0)  # ascending, no duplicate
    fwd = set(zip(rows.tolist(), indices.tolist()))
    assert fwd == {(c, r) for r, c in fwd}
    assert stats["edges"] == indices.size // 2 <= m
    assert stats["max_degree"] == int(np.diff(indptr).max())
    assert stats["average_degree"] == indices.size / n


def test_relabelling_spreads_the_hub():
    """Without the random relabelling the skewed draw's hub is vertex 0."""
    indptr, _, _ = rmat.make_csr(CFG, "cpu")
    deg = np.diff(indptr)
    assert deg.max() > 10 * deg.mean()
    hubs = [int(np.argmax(np.diff(rmat.make_csr(dict(CFG, graph_seed=s), "cpu")[0])))
            for s in (1, 2, 3)]
    assert len(set(hubs)) > 1 and 0 not in hubs
