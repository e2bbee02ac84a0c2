"""Neighbor-sum SpMM ``M = A @ C`` over the CSR: CUDA kernel, plain version, launch count.

Replaces ``spmm_edge_tile_pallas`` (``src/repro/kernels/spmm_edgetile.py``).
The TPU kernel cuts the edge list into uniform ``tile_size``-edge slabs per
128-row destination block, padded to the largest block's slab count, keeps
the whole table resident in VMEM and scatters each slab with a one-hot MXU
matmul.  None of that carries over: the padding grows with degree skew
(every block pays for the densest one), the table (gigabytes at u12-2
widths) does not fit any on-chip memory, and a float32 table may not
go through the tensor cores (counts must stay exact).

Kernel (``csrc/spmm_edgetile.cu``): the plan keeps the graph's CSR
(``indptr``, ``indices`` in destination order), and the table is read as
``[rows, F]`` with ``F = B * W``: the neighbor sum does not depend on the
coloring, so one ``F``-float run is one gather.  The work unit is (row,
128-float chunk of that run); one warp owns it, each lane gathers a float4
(512 B a warp instruction), eight gathers are in flight a warp, and the
row's indices are read 32 at a time.  A hub row is split by columns into
``F / 128`` warps, never by edges.  Chunks run on the grid's second axis, so
the CTAs resident at once share one chunk's source slice (``rows * 512``
bytes: 33.5 MB on a 2^16-vertex graph, which stays in L2).  Tables whose
``F`` is not a multiple of 4, or that are not 16-byte aligned, take a scalar
variant (one float a lane, four columns 32 apart).  Every output element is
one float32 accumulator that starts at 0 and adds the row's neighbors in
CSR order (``csr_chunk_sum`` in ``csrc/common.cuh``, term for term the order
of ``csr_chunk_gather``, which the fused kernel uses, and of ``spmm_block``), so
edge and block plans, fused and unfused, agree bitwise.  No atomics, so the
result is deterministic; rows without edges (zero-degree, sentinel and pad
rows) come out exactly zero.

Bound on the H100: bytes.  Every edge gathers one ``F``-float source row,
``E_dir * F * 4`` bytes, against ``E_dir * F`` adds (0.25 flop/byte, far
below the card's balance point); the least the card could do is read the
table and the CSR once and write ``out`` once.  The earlier design (one warp
per row and coloring, one float a lane) walked each row's indices once per
32 columns and coloring, kept four 128-byte gathers in flight a warp, left
a hub row to one warp per coloring and swept the whole table at once, so
no gather came from L2: half the HBM gather rate on the main cell.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, work
from .ref import spmm_segment_ref

__all__ = ["spmm_edge_tile", "spmm_edge_tile_plain"]

#: the plain version the wrapper takes for a CPU tensor
spmm_edge_tile_plain = spmm_segment_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def spmm_edge_tile(indptr: torch.Tensor, indices: torch.Tensor, table: torch.Tensor, *,
                   edges: Optional[int] = None) -> torch.Tensor:
    """``out[v, b, :] = sum_{e in row v} table[indices[e], b, :]``.

    ``indptr`` int64 ``[rows + 1]``, ``indices`` int32, ``table`` float32
    ``[C, B, W]``; returns ``[rows, B, W]``.  The source need not be square:
    the kernel addresses it only through ``indices``, which must lie below
    ``C`` (a compact source, ``ops.spmm_compact``).  A CPU table runs the
    plain version; a CUDA table launches the kernel or raises.  A ``meta``
    table (a shape-only run) checks the same contract, allocates the CUDA
    branch's output and records the launch and its work
    (:func:`.work.record`) with ``edges`` CSR entries: the caller's host
    count where ``indptr`` covers part of ``indices`` (a bucket), else all
    of them.  No other branch reads ``edges``.
    """
    if table.dim() != 3 or table.shape[0] < 1:
        raise ValueError(f"the source table must be [C >= 1, B, W]; got {tuple(table.shape)}")
    if table.device.type == "cpu":
        return spmm_edge_tile_plain(indptr, indices, table)
    _check_args(table, (indptr, torch.int64), (indices, torch.int32))
    rows = indptr.numel() - 1
    _, b, w = table.shape
    out = torch.empty((rows, b, w), dtype=torch.float32, device=table.device)
    width = b * w
    if table.device.type == "meta":
        e = indices.numel() if edges is None else edges
        work.record("spmm_edgetile", (indptr, indices, table, out),
                    work.spmm_edge(rows, table.shape[0], e, width))
        return out
    vec = width % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = _build.kernel_fn("spmm_edgetile", "spmm_edgetile_launch", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(indptr.data_ptr(), indices.data_ptr(), table.data_ptr(), out.data_ptr(),
                 rows, width, int(vec), stream)
    _build.check(err, "spmm_edgetile_launch")
    _build.count_launch(spmm_edge_tile)
    return out


#: kernel launches since the count was last set to 0
spmm_edge_tile.launches = 0


def _check_args(table: torch.Tensor, *index_args, meta: bool = True) -> None:
    """The kernels' argument contract, on the card and (for a kernel with a
    shape-only branch, ``meta=True``) on ``meta`` alike; raises on anything
    they do not take."""
    if table.device.type not in (("cuda", "meta") if meta else ("cuda",)):
        raise ValueError(f"kernel tables must be on a CUDA device{', the meta device' * meta} "
                         f"or the CPU, got {table.device}")
    if table.dtype != torch.float32 or table.dim() != 3 or not table.is_contiguous():
        raise ValueError(
            f"kernel tables are contiguous float32 [rows, B, W]; got {table.dtype} "
            f"{tuple(table.shape)} contiguous={table.is_contiguous()}"
        )
    for t, dtype in index_args:
        if t.device != table.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"index tensor must be contiguous {dtype} on {table.device}; got "
                f"{t.dtype} on {t.device}"
            )
