"""Block-dense SpMM over 128x128 0/1 patches: CUDA kernel, plain version, launch count.

Replaces ``spmm_block_pallas`` (``src/repro/kernels/spmm_edgetile.py``),
which stores each occupied adjacency patch as a dense float32
``[128, 128]`` tile and runs one MXU matmul ``patch @ table[col_block]``
per patch on a sequential grid, zeroing the resident output block on its
first visit.  None of that carries over: at the densities where the format
is picked (about 112 edges per 16,384-entry patch, 0.7% full) a dense FFMA
product does some 146 times the useful adds; tensor cores would round the
counts (TF32, bf16); and the float32 patches of a 2^16-vertex dense graph
take 17.2 GB.

Kernel (``csrc/spmm_block.cu``): the plan stores each patch as a bitmask
(``[NB, 128, 4]`` uint32 words, 2 KB) in a patch CSR sorted by row block,
then column block.  One CTA owns one row block and one 128-float tile of
the flattened ``B * W`` row.  It walks the row block's patches in
ascending column block; for each it stages the source rows its bits use
(at most 128 rows of 512 bytes) in shared memory, then one warp per
destination row walks that row's set bits in ascending source column and
adds the staged values into register accumulators that live across all
the row block's patches.  The output is written once, with no atomics, and
row blocks without a patch come out exactly zero.  Each row's neighbors are
added in ascending source order into one accumulator that starts at 0, the
order ``csr_row_sum`` (``csrc/common.cuh``) uses, so ``spmm_block`` equals
``spmm_edge_tile`` bitwise at any size.

Bound on the H100: the contract bound (patches, table and output moved
once) is 7.2 GB, 2.15 ms at 3.35 TB/s, for the widest u12-2 node of the
dense cell (W = 792, B = 16, 262,144 patches); its 3.7e11 adds take
11.1 ms at 33.5e12 float32 adds/s (the data sheet's 67 TFLOP/s counts an
FMA as two), so by the contract it is bound by operations.  What the design moves is the staging: up to
``NB * 128 * B * W * 4`` = 1.70 TB through shared memory, 508 ms if every
stage came from device memory.  The CTAs resident at once share one
column tile and walk the column blocks in the same order, so a tile's
source rows (n_pad * 512 B, 34 MB on the dense cell) can stay in the
50 MB L2.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import spmm_block_ref
from .spmm_edgetile import _check_cuda

__all__ = ["spmm_block", "spmm_block_plain", "TILE"]

#: floats of the flattened ``B * W`` row one CTA owns
TILE = 128

#: the plain version the wrapper takes for a CPU tensor
spmm_block_plain = spmm_block_ref

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def spmm_block(
    patch_ptr: torch.Tensor, patch_col: torch.Tensor, patch_bits: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """``out[128 R + r, b, :] = sum_p sum_k patch_p[r, k] table[128 C_p + k, b, :]``.

    ``patch_ptr`` int32 ``[n_pad / 128 + 1]``, ``patch_col`` int32
    ``[NB]`` and ``patch_bits`` int32 ``[NB, 128, 4]`` are the plan's block
    layout (``ops.SpmmPlan``); ``table`` is float32 ``[n_pad, B, W]``;
    returns ``[n_pad, B, W]``.  A CPU table runs the plain version; a CUDA
    table launches the kernel or raises.
    """
    n_row_blocks = patch_ptr.numel() - 1
    if table.shape[0] != n_row_blocks * 128:
        raise ValueError(f"table has {table.shape[0]} rows, the patch CSR covers "
                         f"{n_row_blocks * 128}")
    if patch_bits.shape[1:] != (128, 4) or patch_bits.shape[0] != patch_col.numel():
        raise ValueError(f"patch bits {tuple(patch_bits.shape)} do not fit {patch_col.numel()} "
                         f"patches of 128x128")
    if table.device.type == "cpu":
        return spmm_block_plain(patch_ptr, patch_col, patch_bits, table)
    _check_cuda(table, (patch_ptr, torch.int32), (patch_col, torch.int32),
                (patch_bits, torch.int32))
    width = table.shape[1] * table.shape[2]
    out = torch.empty_like(table)
    vec = width % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = _build.kernel_fn("spmm_block", "spmm_block_launch", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(patch_ptr.data_ptr(), patch_col.data_ptr(), patch_bits.data_ptr(),
                 table.data_ptr(), out.data_ptr(), n_row_blocks, width, int(vec), stream)
    _build.check(err, "spmm_block_launch")
    spmm_block.launches += 1
    return out


#: kernel launches since the count was last set to 0
spmm_block.launches = 0
