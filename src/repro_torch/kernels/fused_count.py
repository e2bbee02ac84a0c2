"""Fused neighbor sum and color-set combine: CUDA kernel, plain version, launch count.

Computes, per sub-template split::

    out[v, b, s] = sum_j left[v, b, idx1[s, j]] * M[v, b, idx2[s, j]],
    M = A @ right   (neighbor sum)

without writing ``M`` to device memory, so a node's footprint is
``|left| + |right| + |out|`` instead of ``+ |M|``.

Replaces ``fused_count_pallas`` (``src/repro/kernels/fused_count.py``),
which accumulates a ``[row_tile, B]`` block of ``M`` in VMEM scratch over
the block's edge slabs on a sequential grid and contracts it on the last
slab.  Hopper has no sequential grid and 227 KB of shared memory per block.

Kernel (``csrc/fused_count.cu``): one CTA of 8 warps per tile of ``V`` whole
vertices, whose ``V B`` (vertex, coloring) rows are one contiguous run of the
tables.  Phase 1 is the edge kernel's walk: a warp sums one (vertex,
128-float chunk of the ``B W`` neighbor row) unit with ``csr_chunk_gather``
(float4 gathers, eight in flight; the scalar variant where ``B W`` is not a
multiple of 4); the warps take units in turn from a counter, so a hub's
chunks spread over all of them; each lane writes its sums into the tile's
``M`` in shared memory, column-major.  Phase 2 is the combine kernel's
(``csrc/combine_tile.cuh``) on that buffer and ``left``'s staged rows.
:func:`color_combine.plan_tile` sizes the tile so that four CTAs fit an SM
wherever they can, so one CTA's gathers run under another's contraction:
at u12-2's widths, ``V = 2`` at ``W = 792`` (``B = 4``: 8 rows, 41 KB).
Where one vertex's ``B`` rows do not fit (wide nodes at large ``B``), a tile
is one vertex and a group of its colorings.  Both phases share their
arithmetic with the unfused kernels, term for term, so fused and unfused
counts are bitwise equal on the card at any size.

Bound on the H100: bytes, as the edge SpMM's: every edge gathers its
neighbor's ``B W`` floats, ``E_dir B W 4`` bytes (234.4 ms over a u12-2
pass on the main cell at the HBM rate); the contraction runs under the
gathers, and the ``M`` write and re-read of the unfused path
(``2 rows B W 4`` bytes) and the ``M`` allocation are saved.  Unlike the
edge kernel's chunk-major grid, concurrent tiles share no source rows, so
no gather comes from L2.  The earlier design (one CTA of 1024 threads per
64 rows and one coloring, each row's walk one warp's, 32 columns a pass)
filled an SM with one CTA at ``W >= 495`` and ran at 53.9x its bound over a
u12-2 pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, work
from .color_combine import check_pairs, device_smem_limits, plan_tile
from .ref import fused_count_ref
from .spmm_edgetile import _check_args

__all__ = ["fused_count", "fused_count_plain"]

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


def fused_count_plain(indptr, indices, left, right, tables) -> torch.Tensor:
    """The plain version the wrapper takes for a CPU tensor (row-blocked:
    ``M`` never exists as a whole table here either)."""
    return fused_count_ref(indptr, indices, left, right, tables.idx1, tables.idx2)


def fused_count(indptr, indices, left: torch.Tensor, right: torch.Tensor, tables, *,
                edges: Optional[int] = None) -> torch.Tensor:
    """``left`` ``[rows, B, A]``, ``right`` ``[C, B, W]`` -> ``[rows, B, S]``.

    ``indptr`` int64 ``[rows + 1]`` and ``indices`` int32 are the CSR of the
    destination rows; ``indices`` must lie below ``C``: the kernel reads
    ``right`` only through them, so a compact source works
    (``ops.fused_count_compact``).  ``tables`` is an ``ops.CombineTables``.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  A ``meta`` tensor (a shape-only run) checks the same
    contract and plans the same tile (for the H100's shared memory),
    allocates the CUDA branch's output, never ``M``, and records the launch
    and its work (:func:`.work.record`) with ``edges`` CSR entries, as
    ``spmm_edge_tile`` does.  No other branch reads ``edges``.
    """
    if left.shape[0] != indptr.numel() - 1 or right.dim() != 3 or right.shape[0] < 1:
        raise ValueError(
            f"left has {left.shape[0]} rows and right is {tuple(right.shape)}; the CSR has "
            f"{indptr.numel() - 1} rows"
        )
    if left.device.type == "cpu":
        return fused_count_plain(indptr, indices, left, right, tables)
    _check_args(left, (indptr, torch.int64), (indices, torch.int32))
    _check_args(right)
    check_pairs(tables, left.device)
    rows, b, a = left.shape
    w = right.shape[2]
    if right.shape[1:] != (b, tables.w) or a != tables.a:
        raise ValueError(
            f"left {tuple(left.shape)} and right {tuple(right.shape)} do not fit split "
            f"tables of widths ({tables.a}, {tables.w})"
        )
    tile = plan_tile(a, w, tables.s, tables.jp, device_smem_limits(left.device), batch=b)
    vec = (b * w) % 4 == 0 and (tile.colorings * w) % 4 == 0 and right.data_ptr() % 16 == 0
    out = torch.empty((rows, b, tables.s), dtype=torch.float32, device=left.device)
    if left.device.type == "meta":
        e = indices.numel() if edges is None else edges
        work.record("fused_count", (indptr, indices, left, right, out),
                    work.fused_count(rows, right.shape[0], e, b, a, w, tables.s, tables.j,
                                     tables.jp))
        return out
    fn = _build.kernel_fn("fused_count", "fused_count_launch", _ARGTYPES)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        err = fn(indptr.data_ptr(), indices.data_ptr(), left.data_ptr(), right.data_ptr(),
                 tables.pairs.data_ptr(), out.data_ptr(), rows, b, a, w, tables.s, tables.j,
                 tables.jp, tile.vertices, tile.colorings, tile.chunk, tile.columns, tile.per_sm,
                 int(vec), stream)
    _build.check(err, "fused_count_launch")
    _build.count_launch(fused_count)
    return out


#: kernel launches since the count was last set to 0
fused_count.launches = 0
