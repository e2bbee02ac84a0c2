"""Plans and dispatch for the count-table ops.

Counterpart of ``repro/kernels/ops.py`` for the single-device tree path.
There is no ``impl`` switch: every op is its kernel module's wrapper,
re-exported here, and routes by the tensor's device.  A CPU tensor runs the
op's plain PyTorch version; a CUDA tensor runs the hand-written kernel or
raises.

Layout conventions (kept from the reference so tables line up row for row):

* vertex dimension padded to ``n_pad = pad_to(n + 1, ROW_BLOCK)``, so row
  ``n`` is a zero sentinel and rows ``>= n`` are pad rows;
* tables are vertex-major ``[n_pad, B, W]`` at their true width ``W``
  (``lane = 1`` in the reference's terms), one ``W``-wide block per
  coloring of the batch, so a neighbor gather reads ``B * W`` contiguous
  floats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.colorsets import split_tables
from .color_combine import color_combine
from .fused_count import fused_count
from .spmm_edgetile import spmm_edge_tile as spmm

__all__ = [
    "pad_to",
    "ROW_BLOCK",
    "AUTO_DENSITY_THRESHOLD",
    "SpmmPlan",
    "build_spmm_plan",
    "spmm",
    "CombineTables",
    "build_combine_tables",
    "color_combine",
    "fused_count",
]

#: the block-dense SpMM format is not ported yet
_BLOCKS_TODO = "the block-dense SpMM format is ROADMAP queue 1 item 6 of the PyTorch port"

#: the vertex dimension is padded to a multiple of this, and ``kind="auto"``
#: measures density over ``ROW_BLOCK x ROW_BLOCK`` adjacency patches
ROW_BLOCK = 128

#: ``kind="auto"`` would pick the block-dense format at this many edges per
#: occupied patch (the reference's threshold, ops.py:131)
AUTO_DENSITY_THRESHOLD = 64.0


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """The graph's CSR on the device, for the neighbor-sum ops.

    ``indptr`` int64 ``[n_pad + 1]`` (rows ``>= n`` have no edges) and
    ``indices`` int32 ``[E_dir]`` in destination order: the layout every
    SpMM and fused-count kernel walks.  Only ``kind == "edges"`` exists.
    """

    kind: str
    n: int
    n_pad: int
    indptr: torch.Tensor
    indices: torch.Tensor
    #: measured edges per occupied 128x128 patch (set by ``kind="auto"``)
    patch_density: Optional[float] = None

    @property
    def num_directed(self) -> int:
        return int(self.indices.numel())


def _patch_density(rows: np.ndarray, cols: np.ndarray, n_pad: int) -> float:
    if not len(rows):
        return 0.0
    keys = (rows // ROW_BLOCK).astype(np.int64) * (n_pad // ROW_BLOCK) + cols // ROW_BLOCK
    return len(rows) / len(np.unique(keys))


def build_spmm_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    *,
    kind: str = "edges",
    device: torch.device,
) -> SpmmPlan:
    """Build the plan from a directed edge list (``rows`` nondecreasing).

    ``kind="auto"`` measures the density over occupied :data:`ROW_BLOCK`
    patches as the reference does and keeps the edge plan below
    :data:`AUTO_DENSITY_THRESHOLD`; above it, and for ``kind="blocks"``,
    it raises ``NotImplementedError``.
    """
    n_pad = pad_to(n + 1, ROW_BLOCK)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    density = None
    if kind == "auto":
        density = _patch_density(rows, cols, n_pad)
        if density >= AUTO_DENSITY_THRESHOLD:
            raise NotImplementedError(
                f"spmm kind 'auto' picks the block-dense format at {density:.1f} "
                f"edges/patch; {_BLOCKS_TODO}"
            )
        kind = "edges"
    if kind == "blocks":
        raise NotImplementedError(_BLOCKS_TODO)
    if kind != "edges":
        raise ValueError(f"unknown spmm plan kind {kind!r}")
    if len(rows) and np.any(np.diff(rows) < 0):
        raise ValueError("edge rows must be nondecreasing (CSR order)")
    indptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_pad), out=indptr[1:])
    return SpmmPlan(
        kind="edges",
        n=n,
        n_pad=n_pad,
        indptr=torch.from_numpy(indptr).to(device),
        indices=torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(device),
        patch_density=density,
    )


@dataclasses.dataclass(frozen=True)
class CombineTables:
    """Split tables for one partition node, in the forms the ops read.

    ``idx1``/``idx2`` int64 ``[S, J]`` feed the plain versions.  ``pairs``
    is the kernels' packed form: int32 ``[ceil(S / ts), J, ts]`` holding
    ``idx1 | idx2 << 16`` for output column ``tile * ts + x`` (0 past
    ``S``), so the ``ts`` columns of one s-tile read one contiguous run per
    split ``j``.
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    pairs: torch.Tensor
    a: int  # left child's width C(k, t1)
    w: int  # right child's width C(k, t2)
    s: int  # output width C(k, t)
    j: int  # split count C(t, t1)
    ts: int  # output columns per s-tile: min(32, next power of two >= S)


def build_combine_tables(k: int, t1: int, t2: int, *, device: torch.device) -> CombineTables:
    idx1, idx2 = split_tables(k, t1, t2)
    s, j = idx1.shape
    a, w = math.comb(k, t1), math.comb(k, t2)
    if max(a, w) > 1 << 16:
        raise ValueError(f"k={k} is too wide for 16-bit packed split indices")
    ts = min(32, 1 << (s - 1).bit_length())
    n_tiles = -(-s // ts)
    packed = np.zeros((n_tiles * ts, j), np.int64)
    packed[:s] = idx1.astype(np.int64) | (idx2.astype(np.int64) << 16)
    pairs = packed.reshape(n_tiles, ts, j).transpose(0, 2, 1).astype(np.int32)
    return CombineTables(
        idx1=torch.from_numpy(idx1.astype(np.int64)).to(device),
        idx2=torch.from_numpy(idx2.astype(np.int64)).to(device),
        pairs=torch.from_numpy(np.ascontiguousarray(pairs)).to(device),
        a=a,
        w=w,
        s=s,
        j=j,
        ts=ts,
    )
