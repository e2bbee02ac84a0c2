"""The benchmark's graph generator: R-MAT on the device.

1. Bit-recursive quadrant sampling: each of ``num_edges`` requested edges
   picks one of the adjacency matrix's four quadrants per bit of the vertex
   id, with the configuration's probabilities ``(a, b, c, d)`` (PaRMAT's
   skew-K rows, held as data in the configuration file).  The id space is
   ``2^ceil(log2 n)``; ids past ``n`` fold back modulo ``n``.
2. Self-loops and duplicate edges (either direction) go.
3. A random relabelling (the paper's random partition).
4. A CSR holding both directions, each row's neighbors ascending.

Every step draws from the configuration's ``graph_seed``, so every run of
a configuration counts one graph in one order of its vertices, as a
deployment does; a run's seed draws only its colorings.  Each draw comes
from a ``torch.Generator`` on ``device``, in a few large calls; the same
configuration on the same card and PyTorch build gives the same CSR.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def make_csr(cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """``(indptr int64 [n + 1], indices int32 [2 m], stats)`` on the host for
    the configuration ``cfg`` (``vertices``, ``edges``, ``probs``,
    ``graph_seed``)."""
    n = int(cfg["vertices"])
    m = int(cfg["edges"])
    a, b, c, _ = (float(p) for p in cfg["probs"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["graph_seed"]))
    scale = max(1, (max(n, 2) - 1).bit_length())
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        src <<= 1
        dst <<= 1
        # quadrants a (0, 0), b (0, 1), c (1, 0), d (1, 1)
        src += r >= a + b
        dst += ((r >= a) & (r < a + b)) | (r >= a + b + c)
        del r
    src %= n
    dst %= n
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    del src, dst, keep
    key = torch.unique(lo * n + hi)
    del lo, hi
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[key // n], perm[key % n]
    del key, perm
    both = torch.sort(torch.cat([u * n + v, v * n + u])).values
    del u, v
    rows = both // n
    indices = (both - rows * n).to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(rows, minlength=n), 0, out=indptr[1:])
    del both, rows
    degrees = indptr[1:] - indptr[:-1]
    stats = {"vertices": n, "edges_requested": m, "edges": int(indices.numel()) // 2,
             "average_degree": int(indices.numel()) / n, "max_degree": int(degrees.max())}
    return indptr.cpu().numpy(), indices.cpu().numpy(), stats
