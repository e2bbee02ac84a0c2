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
from typing import Optional, Tuple

import numpy as np
import torch

from .color_combine import color_combine
from .flash_attention import flash_attention
from .fused_count import fused_count
from .spmm_block import spmm_block
from .spmm_edgetile import spmm_edge_tile

__all__ = [
    "pad_to",
    "popcount32",
    "ROW_BLOCK",
    "AUTO_DENSITY_THRESHOLD",
    "SpmmPlan",
    "build_spmm_plan",
    "expected_patch_density",
    "patch_density",
    "spmm",
    "spmm_compact",
    "spmm_edge_tile",
    "spmm_block",
    "CombineTables",
    "build_combine_tables",
    "color_combine",
    "fused_count",
    "fused_count_compact",
    "RectCsr",
    "build_rect_csr",
    "BucketCsrs",
    "build_bucket_csrs",
    "spmm_rect",
    "fused_count_rect",
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
    ``128 * row_block + r``; the words are uint32 bit patterns).  The
    bitmasks stay in host memory whatever the plan's device: only the plain
    version reads them, and a caller holding it to a CUDA table moves them
    over.  Beside them, port-only (the reference's plan has no counterpart), what the
    block kernel reads in place of the bitmasks:

    * ``patch_union`` int32 ``[NB, 4]``: the OR of each patch's 128 rows,
      the source columns the patch uses.  The kernel stages those rows
      packed by slot, the popcount of the union's bits below the column;
      ``patch_max_used`` is the largest popcount and sizes its staging ring.
    * the patch's edges as slots, in CSR order: ``patch_offs`` int16
      ``[NB, 136]`` (entry ``r`` is the first edge of row ``r`` within the
      patch, entry 128 the patch's edge count; 129-135 pad the row to 272
      bytes), and ``patch_slots`` uint8 (each edge's slot; patch ``p``'s
      list starts at byte ``patch_slots_ptr[p]``, int64 ``[NB + 1]``, and is
      padded with zeros to a multiple of 16 bytes, at most
      ``patch_max_slots``).
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
    patch_union: Optional[torch.Tensor] = None
    patch_offs: Optional[torch.Tensor] = None
    patch_slots: Optional[torch.Tensor] = None
    patch_slots_ptr: Optional[torch.Tensor] = None
    patch_max_used: int = 0
    patch_max_slots: int = 0

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


def popcount32(words: np.ndarray) -> np.ndarray:
    """Set bits of each 32-bit word (any integer dtype holding uint32 bit
    patterns), as int64."""
    x = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


#: int16 row offsets per patch in ``SpmmPlan.patch_offs``: 129 used, the
#: rest pad each patch's entry to 272 bytes (a multiple of 16)
PATCH_OFFS = 136


def _patch_lists(inv: np.ndarray, r: np.ndarray, c: np.ndarray, union: np.ndarray):
    """Each patch's edges as staging slots, row by row in CSR order: the
    ``patch_offs``, ``patch_slots`` and ``patch_slots_ptr`` of
    :class:`SpmmPlan`, and the largest padded list in bytes."""
    vb = ROW_BLOCK
    nb = len(union)
    # the slot of source column k: the union's set bits below k
    used = np.unpackbits(np.ascontiguousarray(union).view(np.uint8).reshape(nb, -1), axis=1,
                         bitorder="little")
    slot_of = np.cumsum(used, axis=1, dtype=np.uint8) - used
    offs = np.zeros((nb, PATCH_OFFS), np.int64)
    np.cumsum(np.bincount(inv * vb + r, minlength=nb * vb).reshape(nb, vb), axis=1,
              out=offs[:, 1:vb + 1])
    n_edges = offs[:, vb]
    sizes = -(-n_edges // 16) * 16
    slots_ptr = np.zeros(nb + 1, np.int64)
    np.cumsum(sizes, out=slots_ptr[1:])
    first = slots_ptr[:-1] - np.concatenate([[0], np.cumsum(n_edges)[:-1]])
    order = np.argsort(inv, kind="stable")  # by patch, CSR order within one
    slots = np.zeros(slots_ptr[-1], np.uint8)
    slots[first[inv[order]] + np.arange(len(order))] = slot_of[inv[order], c[order]]
    offs[:, vb + 1:] = n_edges[:, None]
    return offs.astype(np.int16), slots, slots_ptr, int(sizes.max(initial=0))


def _block_layout(rows: np.ndarray, cols: np.ndarray, n_pad: int):
    """Patch CSR, bitmasks, column unions and slot lists of a CSR-ordered
    edge list (see :class:`SpmmPlan`)."""
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
    patch_union = (np.bitwise_or.reduce(patch_bits, axis=1) if nb
                   else np.zeros((0, vb // 32), np.int32))
    offs, slots, slots_ptr, max_slots = _patch_lists(inv.astype(np.int64), r, c, patch_union)
    return dict(patch_ptr=patch_ptr.astype(np.int32), patch_col=(uniq % stride).astype(np.int32),
                patch_bits=patch_bits, patch_union=patch_union, patch_offs=offs,
                patch_slots=slots, patch_slots_ptr=slots_ptr), max_slots


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
        arrays, max_slots = _block_layout(rows, cols, n_pad)
        used = popcount32(arrays["patch_union"]).sum(axis=1)
        blocks = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        blocks.update({k: v.to(device) for k, v in blocks.items() if k != "patch_bits"})
        blocks.update(patch_max_used=int(used.max(initial=0)), patch_max_slots=max_slots)
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
        return spmm_block(plan, table)
    return spmm_edge_tile(plan.indptr, plan.indices, table)


def _remap(plan: SpmmPlan, inv: torch.Tensor) -> torch.Tensor:
    """The CSR's source columns through the row-index indirection ``inv``
    (vertex row -> compact slot), int32 in CSR order: the compact ops'
    ``indices``, made once per call."""
    if plan.kind != "edges":
        raise ValueError("the compact ops walk the CSR: they need an edge plan")
    if inv.dtype != torch.int32 or inv.shape != (plan.n_pad,):
        raise ValueError(f"inv must be int32 [{plan.n_pad}]; got {inv.dtype} {tuple(inv.shape)}")
    return torch.index_select(inv, 0, plan.indices)


def spmm_compact(plan: SpmmPlan, table_c: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The neighbor sum of :func:`spmm` from a compact source (the reference's
    ``ops.py:386``): ``table_c`` ``[rows_c, B, W]`` holds the source's active
    rows and ``inv`` int32 ``[n_pad]`` maps each vertex row to its slot,
    inactive rows to a slot that holds zeros.  The edge kernel walks the
    same CSR with the remapped columns, so every output element adds the
    same terms in the same order (``x + 0.0 == x`` for the inactive ones):
    bitwise the dense SpMM.  Returns ``[n_pad, B, W]``."""
    return spmm_edge_tile(plan.indptr, _remap(plan, inv), table_c)


def fused_count_compact(plan: SpmmPlan, left: torch.Tensor, right_c: torch.Tensor,
                        inv: torch.Tensor, tables: "CombineTables") -> torch.Tensor:
    """:func:`fused_count` with its right operand in compact form, through the
    indirection of :func:`spmm_compact` (the reference's ``ops.py:622``):
    bitwise the dense fused count.  ``left`` is ``[n_pad, B, A]``; returns
    ``[n_pad, B, S]``."""
    return fused_count(plan.indptr, _remap(plan, inv), left, right_c, tables)


@dataclasses.dataclass(frozen=True)
class RectCsr:
    """A CSR of ``rows`` destination rows whose columns index a source of
    another shape: the distributed engine's shard over the received
    ``[P r_pad, B, W]`` buffer (the counterpart of the reference's
    ``spmm_slabs`` layout, ``ops.py:419``, without its padded slabs).
    ``indptr`` int64 ``[rows + 1]``, ``indices`` int32 in destination order.
    ``edges`` is its edge count, kept on the host: a shape-only (``meta``)
    CSR cannot be read, and the kernels' work counts need it."""

    indptr: torch.Tensor
    indices: torch.Tensor
    edges: int

    @property
    def rows(self) -> int:
        return self.indptr.numel() - 1

    def to(self, device) -> "RectCsr":
        return RectCsr(self.indptr.to(device), self.indices.to(device), self.edges)


def build_rect_csr(dst: np.ndarray, cols: np.ndarray, rows: int) -> RectCsr:
    """A :class:`RectCsr` on the host from destination-sorted ``dst`` and
    their source ``cols``."""
    dst = np.asarray(dst, np.int64)
    if len(dst) and np.any(np.diff(dst) < 0):
        raise ValueError("destination rows must be nondecreasing (CSR order)")
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=rows), out=indptr[1:])
    return RectCsr(torch.from_numpy(indptr),
                   torch.from_numpy(np.ascontiguousarray(cols, np.int32)), len(dst))


@dataclasses.dataclass(frozen=True)
class BucketCsrs:
    """One CSR per source bucket over the same ``rows`` destination rows,
    sharing one edge array: ``indptr[q]`` (int64 ``[rows + 1]``, a row of
    ``[Q, rows + 1]``) holds bucket ``q``'s absolute offsets into the
    bucket-major edge list, and each of ``indices`` (int32) is one view of
    those edges' sources (the distributed engine keeps two: request slots
    and shard-local rows).  The counterpart of the reference's tiled
    buckets (``ops.build_bucket_tiles``, ``ops.py:176``): storage is
    ``O(E + Q rows)``, and a bucket is consumed by one kernel launch over
    its CSR, not a loop over fixed-size tiles.  ``edges[q]``, on the host,
    is bucket ``q``'s edge count (see :class:`RectCsr`)."""

    indptr: torch.Tensor
    indices: Tuple[torch.Tensor, ...]
    edges: Tuple[int, ...]

    def csr(self, q: int, view: int = 0) -> RectCsr:
        return RectCsr(self.indptr[q], self.indices[view], self.edges[q])

    def to(self, device) -> "BucketCsrs":
        return BucketCsrs(self.indptr.to(device), tuple(t.to(device) for t in self.indices),
                          self.edges)


def build_bucket_csrs(bucket: np.ndarray, dst: np.ndarray, srcs: Tuple[np.ndarray, ...],
                      num_buckets: int, rows: int) -> BucketCsrs:
    """Per-bucket CSRs of a bucketed edge list, on the host.

    ``bucket`` must be nondecreasing and ``dst`` nondecreasing within each
    bucket (a stable sort by bucket of a destination-sorted list); ``srcs``
    are parallel per-edge source indices."""
    bucket = np.asarray(bucket, np.int64)
    dst = np.asarray(dst, np.int64)
    if len(bucket) and np.any(np.diff(bucket) < 0):
        raise ValueError("edges must be sorted by bucket")
    counts = np.bincount(bucket * rows + dst, minlength=num_buckets * rows)
    indptr = np.zeros(num_buckets * rows + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    # bucket q's rows are entries q*rows .. (q+1)*rows: overlapping windows
    # of one cumulative sum, so each row of [Q, rows + 1] is absolute
    idx = np.arange(num_buckets)[:, None] * rows + np.arange(rows + 1)[None, :]
    edges = np.bincount(bucket, minlength=num_buckets)
    return BucketCsrs(torch.from_numpy(indptr[idx]),
                      tuple(torch.from_numpy(np.ascontiguousarray(s, np.int32)) for s in srcs),
                      tuple(int(e) for e in edges))


def spmm_rect(csr: RectCsr, source: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum_{e in row v} source[indices[e]]`` over a rectangular
    CSR: ``source`` ``[C, B, W]`` -> ``[rows, B, W]`` through the edge
    kernel, which adds each row's terms in CSR order (rows without edges
    come out zero)."""
    return spmm_edge_tile(csr.indptr, csr.indices, source, edges=csr.edges)


def fused_count_rect(csr: RectCsr, left: torch.Tensor, source: torch.Tensor,
                     tables: "CombineTables") -> torch.Tensor:
    """The fused count over a rectangular CSR (the counterpart of the
    reference's ``fused_count_slabs``, ``ops.py:665``): ``left`` ``[rows, B,
    A]`` contracted with the neighbor sum of ``source`` ``[C, B, W]``, which
    never exists whole; returns ``[rows, B, S]``."""
    return fused_count(csr.indptr, csr.indices, left, source, tables, edges=csr.edges)


@dataclasses.dataclass(frozen=True)
class CombineTables:
    """Split tables for one partition node, in the forms the ops read.

    ``idx1``/``idx2`` int32 ``[S, J]`` feed the plain versions.  ``pairs``
    is the kernels' packed form: int32 ``[S, jp]`` holding ``idx1 | idx2 <<
    16`` for split ``j < J`` of output column ``s`` and 0 past ``J``, so a
    column's splits are one contiguous run that the kernels read four at a
    time (one 16-byte load) and a chunk of columns one contiguous block.
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    pairs: torch.Tensor
    a: int  # left child's width C(k, t1)
    w: int  # right child's width C(k, t2)
    s: int  # output width C(k, t)
    j: int  # split count C(t, t1)
    jp: int  # J padded to a multiple of 4: the row pitch of ``pairs``

    def to(self, device) -> "CombineTables":
        return dataclasses.replace(self, idx1=self.idx1.to(device), idx2=self.idx2.to(device),
                                   pairs=self.pairs.to(device))


def build_combine_tables(k: int, t1: int, t2: int, *, device: torch.device) -> CombineTables:
    # imported here: ``core`` loads the engine, which imports this module
    from ..core.colorsets import split_tables

    idx1, idx2 = split_tables(k, t1, t2)
    s, j = idx1.shape
    a, w = math.comb(k, t1), math.comb(k, t2)
    if max(a, w) > 1 << 16:
        raise ValueError(f"k={k} is too wide for 16-bit packed split indices")
    jp = pad_to(j, 4)
    packed = np.zeros((s, jp), np.int64)
    packed[:, :j] = idx1.astype(np.int64) | (idx2.astype(np.int64) << 16)
    return CombineTables(
        idx1=torch.from_numpy(idx1.astype(np.int32)).to(device),
        idx2=torch.from_numpy(idx2.astype(np.int32)).to(device),
        pairs=torch.from_numpy(packed.astype(np.int32)).to(device),
        a=a,
        w=w,
        s=s,
        j=j,
        jp=jp,
    )
