"""Fused neighbor sum and color-set combine: CUDA kernel, plain version, launch count.

Computes, per sub-template split::

    out[v, b, s] = sum_j left[v, b, idx1[s, j]] * M[v, b, idx2[s, j]],
    M = A @ right   (neighbor sum)

without writing ``M`` to device memory, so a node's footprint is
``|left| + |right| + |out|`` instead of ``+ |M|``.

Replaces ``fused_count_pallas`` (``src/repro/kernels/fused_count.py``),
which accumulates a ``[row_tile, B]`` block of ``M`` in VMEM scratch over
the block's edge slabs on a sequential grid and contracts it on the last
slab.  Hopper has no sequential grid and 227 KB of shared memory per block,
so the block of rows is sized from the right child's width instead of
fixed at 128.

Kernel (``csrc/fused_count.cu``): one CTA per block of ``R`` rows and one
coloring.  Phase 1 builds the ``[R, W]`` block of ``M`` in dynamic shared
memory with the SpMM kernel's own edge walk (``csr_row_sum``); phase 2
runs the combine kernel's own ``j`` loop (``combine_dot``) against it.
Because both phases share their arithmetic with the unfused kernels,
fused and unfused counts are bitwise equal on the card at any size.
``R = min(64, smem_limit // (4 W))``: for u12-2's widest right child
(``W = 792``) the 227 KB limit allows 73 rows, and 64 are taken.

Bound on the H100: bytes, as the SpMM's — the gathers of ``right`` rows
dominate; the fused kernel saves the ``M`` write and re-read
(``2 * rows * B * W * 4`` bytes) and the ``M`` allocation.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import fused_count_ref
from .spmm_edgetile import _check_cuda

__all__ = ["fused_count", "fused_count_plain", "rows_per_block", "MAX_ROWS_PER_BLOCK"]

#: upper bound on the destination rows one CTA owns
MAX_ROWS_PER_BLOCK = 64

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_smem_limit = {}


def fused_count_plain(indptr, indices, left, right, tables) -> torch.Tensor:
    """The plain version the wrapper takes for a CPU tensor (row-blocked:
    ``M`` never exists as a whole table here either)."""
    return fused_count_ref(indptr, indices, left, right, tables.idx1, tables.idx2)


def rows_per_block(width: int, smem_limit: int) -> int:
    """Rows of ``M`` one CTA holds: ``R * width * 4 <= smem_limit``, capped at 64."""
    r = min(MAX_ROWS_PER_BLOCK, smem_limit // (4 * max(width, 1)))
    if r < 1:
        raise ValueError(
            f"a right table {width} columns wide does not fit one row in "
            f"{smem_limit} bytes of shared memory"
        )
    return r


def _device_smem_limit(device: torch.device) -> int:
    limit = _smem_limit.get(device.index)
    if limit is None:
        fn = _build.kernel_fn("fused_count", "fused_count_smem_limit", [ctypes.c_int])
        limit = fn(device.index)
        if limit <= 0:
            _build.check(-limit, "fused_count_smem_limit")
        _smem_limit[device.index] = limit
    return limit


def fused_count(indptr, indices, left: torch.Tensor, right: torch.Tensor, tables) -> torch.Tensor:
    """``left`` ``[rows, B, A]``, ``right`` ``[rows, B, W]`` -> ``[rows, B, S]``.

    ``indptr`` int64 ``[rows + 1]`` and ``indices`` int32 are the CSR of the
    destination rows; ``tables`` is an ``ops.CombineTables``.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises.
    """
    if not left.shape[0] == right.shape[0] == indptr.numel() - 1:
        raise ValueError(
            f"left has {left.shape[0]} rows and right {right.shape[0]}; the CSR has "
            f"{indptr.numel() - 1}"
        )
    if left.device.type == "cpu":
        return fused_count_plain(indptr, indices, left, right, tables)
    _check_cuda(left, (indptr, torch.int64), (indices, torch.int32), (tables.pairs, torch.int32))
    _check_cuda(right)
    rows, b, a = left.shape
    w = right.shape[2]
    if right.shape[1:] != (b, tables.w) or a != tables.a:
        raise ValueError(
            f"left {tuple(left.shape)} and right {tuple(right.shape)} do not fit split "
            f"tables of widths ({tables.a}, {tables.w})"
        )
    r = rows_per_block(w, _device_smem_limit(left.device))
    out = torch.empty((rows, b, tables.s), dtype=torch.float32, device=left.device)
    fn = _build.kernel_fn("fused_count", "fused_count_launch", _ARGTYPES)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        err = fn(indptr.data_ptr(), indices.data_ptr(), left.data_ptr(), right.data_ptr(),
                 tables.pairs.data_ptr(), out.data_ptr(), rows, b, a, w, tables.s, tables.j,
                 tables.ts, r, stream)
    _build.check(err, "fused_count_launch")
    fused_count.launches += 1
    return out


#: kernel launches since the count was last set to 0
fused_count.launches = 0
