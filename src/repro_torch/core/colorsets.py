"""Combinadic indexing of color sets and split tables for the color-coding DP.

The color-coding dynamic program stores, per sub-template ``T_i`` of size ``t``,
a count table ``C[v, S]`` indexed by vertex ``v`` and color set ``S`` with
``|S| = t`` drawn from ``k`` colors.  Color sets are ranked combinadically
(lexicographic order of the sorted color tuples), giving each table a dense
second axis of width ``C(k, t)``.

The combine step for ``T_i -> (T_i', T_i'')`` needs, for every output set
``S`` of size ``t = t1 + t2``, the list of ordered splits ``S = S1 (+) S2``
with ``|S1| = t1``.  ``split_tables`` precomputes these as two integer index
matrices of shape ``[C(k,t), C(t,t1)]`` mapping output rank -> (rank of S1 in
the t1 table, rank of S2 in the t2 table).  These tables are tiny (worst case
k=15, t=8, t1=4: 6435 x 70 int32) and are built once per plan.

A copy of ``repro.core.colorsets``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from itertools import combinations
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "num_sets",
    "set_masks",
    "rank_of_mask",
    "split_tables",
    "excluded_color_mask",
    "full_set_rank",
    "singleton_ranks",
]


def num_sets(k: int, t: int) -> int:
    """Number of color sets of size ``t`` from ``k`` colors: C(k, t)."""
    return math.comb(k, t)


@lru_cache(maxsize=None)
def set_masks(k: int, t: int) -> Tuple[int, ...]:
    """All size-``t`` subsets of ``{0..k-1}`` as bitmasks, in rank order."""
    if not (0 <= t <= k):
        raise ValueError(f"invalid subset size t={t} for k={k}")
    masks = []
    for comb in combinations(range(k), t):
        m = 0
        for c in comb:
            m |= 1 << c
        masks.append(m)
    return tuple(masks)


@lru_cache(maxsize=None)
def _rank_lookup(k: int, t: int) -> Dict[int, int]:
    return {m: i for i, m in enumerate(set_masks(k, t))}


def rank_of_mask(k: int, t: int, mask: int) -> int:
    """Rank of a bitmask among size-``t`` subsets of ``{0..k-1}``."""
    return _rank_lookup(k, t)[mask]


@lru_cache(maxsize=None)
def split_tables(k: int, t1: int, t2: int) -> Tuple[np.ndarray, np.ndarray]:
    """Index tables for the color-set combine.

    Returns ``(idx1, idx2)`` of shape ``[C(k, t1+t2), C(t1+t2, t1)]`` such that
    for output rank ``s`` and split index ``j``::

        out[v, s] = sum_j left[v, idx1[s, j]] * right[v, idx2[s, j]]

    enumerates exactly the ordered splits ``S = S1 (+) S2``.
    """
    t = t1 + t2
    if t > k:
        raise ValueError(f"t1+t2={t} exceeds k={k}")
    out_masks = set_masks(k, t)
    r1 = _rank_lookup(k, t1)
    r2 = _rank_lookup(k, t2)
    n_out = len(out_masks)
    n_splits = math.comb(t, t1)
    idx1 = np.zeros((n_out, n_splits), np.int32)
    idx2 = np.zeros((n_out, n_splits), np.int32)
    for s, m in enumerate(out_masks):
        bits = [b for b in range(k) if (m >> b) & 1]
        for j, comb in enumerate(combinations(bits, t1)):
            m1 = 0
            for c in comb:
                m1 |= 1 << c
            m2 = m ^ m1
            idx1[s, j] = r1[m1]
            idx2[s, j] = r2[m2]
    return idx1, idx2


@lru_cache(maxsize=None)
def excluded_color_mask(k: int, t: int) -> np.ndarray:
    """``[k, C(k, t)]`` float32 mask: 1.0 where color ``c`` is NOT in set ``S``.

    The bag-table collapse of the treewidth-2 front end pins the apex
    vertex's color outside the forest's color set; row ``c`` of this mask
    filters the size-``t`` table columns down to the sets that exclude ``c``.
    """
    masks = set_masks(k, t)
    out = np.ones((k, len(masks)), np.float32)
    for s, m in enumerate(masks):
        for c in range(k):
            if (m >> c) & 1:
                out[c, s] = 0.0
    return out


def full_set_rank(k: int) -> int:
    """Rank of the full color set (always 0: the only size-k subset)."""
    return 0


def singleton_ranks(k: int) -> np.ndarray:
    """rank of {c} in the size-1 table, for each color c (identity order)."""
    masks = set_masks(k, 1)
    return np.array([_rank_lookup(k, 1)[m] for m in masks], np.int32)
