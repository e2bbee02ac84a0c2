"""Plans and dispatch for the count-table ops, and flash attention.

Counterpart of ``repro/kernels/ops.py`` for the single-device tree path and
the language model's attention.
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
from .flash_attention import flash_attention
from .fused_count import fused_count
from .spmm_block import spmm_block
from .spmm_edgetile import spmm_edge_tile

__all__ = [
    "pad_to",
    "ROW_BLOCK",
    "AUTO_DENSITY_THRESHOLD",
    "SpmmPlan",
    "build_spmm_plan",
    "expected_patch_density",
    "patch_density",
    "spmm",
    "spmm_edge_tile",
    "spmm_block",
    "CombineTables",
    "build_combine_tables",
    "color_combine",
    "fused_count",
    "flash_attention",
]

#: the vertex dimension is padded to a multiple of this; the block-dense
#: format stores ``ROW_BLOCK x ROW_BLOCK`` adjacency patches
ROW_BLOCK = 128

#: ``kind="auto"`` picks the block-dense format once occupied patches
#: average this many edges (the reference's threshold, ops.py:131; it was
#: derived for the TPU's matrix unit and is not yet re-derived for the card)
AUTO_DENSITY_THRESHOLD = 64.0


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """The graph's adjacency on the device, for the neighbor-sum ops.

    Every plan carries the CSR: ``indptr`` int64 ``[n_pad + 1]`` (rows
    ``>= n`` have no edges) and ``indices`` int32 ``[E_dir]`` in
    destination order, the layout the edge SpMM and the fused kernel walk.
    A ``kind == "blocks"`` plan also carries the block-dense layout that
    ``spmm_block`` walks: the occupied ``128 x 128`` patches sorted by row
    block, then column block, as a patch CSR (``patch_ptr`` int32
    ``[n_pad / 128 + 1]``, ``patch_col`` int32 ``[NB]``) and 0/1 bitmasks
    ``patch_bits`` int32 ``[NB, 128, 4]`` (bit ``k % 32`` of word ``k // 32``
    of row ``r`` is the edge from source ``128 * col + k`` to destination
    ``128 * row_block + r``; the words are uint32 bit patterns).
    """

    kind: str
    n: int
    n_pad: int
    indptr: torch.Tensor
    indices: torch.Tensor
    #: measured edges per occupied 128x128 patch (set by ``kind="auto"``)
    patch_density: Optional[float] = None
    patch_ptr: Optional[torch.Tensor] = None
    patch_col: Optional[torch.Tensor] = None
    patch_bits: Optional[torch.Tensor] = None

    @property
    def num_directed(self) -> int:
        return int(self.indices.numel())

    @property
    def num_patches(self) -> int:
        return 0 if self.patch_col is None else int(self.patch_col.numel())


def patch_density(rows: np.ndarray, cols: np.ndarray, n_pad: int) -> float:
    """Edges per occupied ``ROW_BLOCK x ROW_BLOCK`` adjacency patch: the
    ``kind="auto"`` signal, keyed as the reference keys it."""
    if not len(rows):
        return 0.0
    keys = (rows // ROW_BLOCK).astype(np.int64) * (n_pad // ROW_BLOCK) + cols // ROW_BLOCK
    return len(rows) / len(np.unique(keys))


def expected_patch_density(n: int, e_directed: int, block: int = ROW_BLOCK) -> float:
    """Model of the ``kind="auto"`` signal for shape-only plans, where no
    edges exist to measure: expected edges per occupied ``block x block``
    patch under uniform placement, ``E[occupied] = patches * (1 -
    exp(-e / patches))`` (the reference's ``ops.py:328``)."""
    nb = max(1, pad_to(n + 1, block) // block)
    patches = float(nb) * float(nb)
    occupied = patches * (1.0 - math.exp(-float(e_directed) / patches))
    return float(e_directed) / max(occupied, 1.0)


def _block_layout(rows: np.ndarray, cols: np.ndarray, n_pad: int):
    """Patch CSR and bitmasks of a CSR-ordered edge list (see :class:`SpmmPlan`)."""
    vb = ROW_BLOCK
    same_row = np.diff(rows) == 0
    if np.any(same_row & (np.diff(cols) <= 0)):
        raise ValueError(
            "the block-dense plan needs each row's neighbors strictly ascending: "
            "a duplicate edge would make a patch entry other than 0/1"
        )
    nrb = n_pad // vb
    stride = nrb + 1  # the reference's patch key
    keys = (rows // vb).astype(np.int64) * stride + cols // vb
    uniq, inv = np.unique(keys, return_inverse=True)
    nb = len(uniq)
    patch_ptr = np.zeros(nrb + 1, np.int64)
    np.cumsum(np.bincount(uniq // stride, minlength=nrb), out=patch_ptr[1:])
    r, c = rows % vb, cols % vb
    word = inv.astype(np.int64) * (vb * vb // 32) + r * (vb // 32) + c // 32
    # distinct bits of one word sum to their OR, exactly in float64
    bits = np.bincount(word, weights=np.left_shift(np.int64(1), (c % 32).astype(np.int64)).astype(np.float64),
                       minlength=nb * vb * vb // 32)
    patch_bits = bits.astype(np.uint32).view(np.int32).reshape(nb, vb, vb // 32)
    return (patch_ptr.astype(np.int32), (uniq % stride).astype(np.int32), patch_bits)


def build_spmm_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    *,
    kind: str = "edges",
    device: torch.device,
) -> SpmmPlan:
    """Build the plan from a directed edge list (``rows`` nondecreasing).

    ``kind="auto"`` measures the density over occupied patches as the
    reference does (``ops.py:235-325``) and picks ``"blocks"`` at
    :data:`AUTO_DENSITY_THRESHOLD` edges per patch or more, ``"edges"``
    below.
    """
    n_pad = pad_to(n + 1, ROW_BLOCK)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    density = None
    if kind == "auto":
        density = patch_density(rows, cols, n_pad)
        kind = "blocks" if density >= AUTO_DENSITY_THRESHOLD else "edges"
    if kind not in ("edges", "blocks"):
        raise ValueError(f"unknown spmm plan kind {kind!r}")
    if len(rows) and np.any(np.diff(rows) < 0):
        raise ValueError("edge rows must be nondecreasing (CSR order)")
    indptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_pad), out=indptr[1:])
    blocks = {}
    if kind == "blocks":
        ptr, col, bits = _block_layout(rows, cols, n_pad)
        blocks = dict(patch_ptr=torch.from_numpy(ptr).to(device),
                      patch_col=torch.from_numpy(col).to(device),
                      patch_bits=torch.from_numpy(bits).to(device))
    return SpmmPlan(
        kind=kind,
        n=n,
        n_pad=n_pad,
        indptr=torch.from_numpy(indptr).to(device),
        indices=torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(device),
        patch_density=density,
        **blocks,
    )


def spmm(plan: SpmmPlan, table: torch.Tensor) -> torch.Tensor:
    """Neighbor sum ``M[v] = sum_{(v, u) in E} table[u]`` over ``[n_pad, B, W]``,
    through the plan's format: ``spmm_block`` for a block plan, else
    ``spmm_edge_tile``.  Both add each row's neighbors in ascending source
    order into one accumulator, so the two give bitwise-equal tables on the
    card; rows without edges come out exactly zero."""
    if plan.kind == "blocks":
        return spmm_block(plan.patch_ptr, plan.patch_col, plan.patch_bits, table)
    return spmm_edge_tile(plan.indptr, plan.indices, table)


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
