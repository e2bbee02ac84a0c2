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

Kernel (``csrc/spmm_block.cu``): the plan keeps a patch CSR sorted by row
block, then column block, and derives from each patch's bitmask what the
kernel reads: the patch's column union (``[NB, 4]``, the OR of its rows:
the source rows it uses) and its edges as staging slots, row by row in CSR
order (int16 row offsets ``patch_offs``, then one uint8 slot an edge in
``patch_slots``; the slot of source column ``k`` is the popcount of the
union's bits below ``k``).  One CTA owns one row block and one 128-float
tile of the flattened ``B * W`` row, two CTAs an SM.  Two producer warps
run ahead through the row block's patches and, for each, issue bulk
asynchronous copies (``cp.async.bulk``, completing on a "full" mbarrier by
bytes) of its offsets, its slot list and each used source row's 512-byte
segment, packed by slot, into a ring of 2-4 shared-memory stages sized by
the plan's largest union and list (4-byte ``cp.async`` on the same barrier
for tables that are not 16-byte aligned).  Sixteen consumer warps of eight
destination rows each wait on the stage, add the staged rows of each of
their rows' edges in slot-list order into register accumulators that live
across all the row block's patches, and release the stage on its "empty"
mbarrier; no CTA-wide barrier runs per patch.  The output is written once,
with no atomics, and row blocks without a patch come out exactly zero.
Each row's neighbors are added in ascending source order into one
accumulator that starts at 0, the order ``csr_chunk_gather`` and
``csr_chunk_sum`` (``csrc/common.cuh``) use, so ``spmm_block`` equals
``spmm_edge_tile`` bitwise at any size.

Bound on the H100: the contract bound (patches, table and output moved
once) is 7.2 GB, 2.15 ms at 3.35 TB/s, for the widest u12-2 node of the
dense cell (W = 792, B = 16, 262,144 patches); its 3.7e11 adds take
11.1 ms at 33.5e12 float32 adds/s (the data sheet's 67 TFLOP/s counts an
FMA as two), so by the contract it is bound by operations.  What the design
moves is the staging: each patch's used source rows (0.384 of 128 on the
dense cell), 653 GB at W = 792, 195 ms if every stage came from device
memory.  The CTAs resident at once share one column tile and walk the
column blocks in the same order, so a tile's source rows (``n_pad * 512``
bytes, 33.5 MB on the dense cell) can stay in the 50 MB L2.  The earlier
design ran each patch as a serial chain (bitmask load, one warp computing
the union while the others waited, a staging every thread waited on, four
barriers) for 56 adds a thread: bound by latency, at a third of its staging
bytes' HBM rate.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import spmm_block_ref
from .spmm_edgetile import _check_args

__all__ = ["spmm_block", "spmm_block_plain", "TILE"]

#: floats of the flattened ``B * W`` row one CTA owns
TILE = 128

#: the plain version the wrapper takes for a CPU tensor
spmm_block_plain = spmm_block_ref

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def spmm_block(plan, table: torch.Tensor) -> torch.Tensor:
    """``out[128 R + r, b, :] = sum_p sum_k patch_p[r, k] table[128 C_p + k, b, :]``.

    ``plan`` is a block plan (``ops.SpmmPlan`` of kind ``"blocks"``): the
    plain version reads its ``patch_ptr``, ``patch_col`` and
    ``patch_bits``, the kernel its ``patch_ptr``, ``patch_col``,
    ``patch_union``, ``patch_offs``, ``patch_slots`` and ``patch_slots_ptr``,
    with ``patch_max_used`` and ``patch_max_slots`` sizing its staging ring.
    ``table`` is float32 ``[n_pad, B, W]``; returns ``[n_pad, B, W]``.  A CPU
    table runs the plain version; a CUDA table launches the kernel or raises.
    """
    n_row_blocks = plan.patch_ptr.numel() - 1
    n_patches = plan.patch_col.numel()
    if table.shape[0] != n_row_blocks * 128:
        raise ValueError(f"table has {table.shape[0]} rows, the patch CSR covers "
                         f"{n_row_blocks * 128}")
    if table.device.type == "cpu":
        return spmm_block_plain(plan.patch_ptr, plan.patch_col, plan.patch_bits, table)
    if (tuple(plan.patch_union.shape) != (n_patches, 4)
            or tuple(plan.patch_offs.shape) != (n_patches, 136)
            or plan.patch_slots_ptr.numel() != n_patches + 1
            or not 0 <= plan.patch_max_used <= 128 or plan.patch_max_slots % 16):
        raise ValueError(f"the plan's unions {tuple(plan.patch_union.shape)}, offsets "
                         f"{tuple(plan.patch_offs.shape)} or bounds do not fit {n_patches} "
                         f"patches of 128x128")
    _check_args(table, (plan.patch_ptr, torch.int32), (plan.patch_col, torch.int32),
                (plan.patch_union, torch.int32), (plan.patch_offs, torch.int16),
                (plan.patch_slots, torch.uint8), (plan.patch_slots_ptr, torch.int64), meta=False)
    if any(t.data_ptr() % 16 for t in (plan.patch_union, plan.patch_offs, plan.patch_slots)):
        raise ValueError("the kernel copies unions, offsets and slots in 16-byte units: all "
                         "three must be 16-byte aligned")
    width = table.shape[1] * table.shape[2]
    out = torch.empty_like(table)
    vec = width % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = _build.kernel_fn("spmm_block", "spmm_block_launch", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(plan.patch_ptr.data_ptr(), plan.patch_col.data_ptr(),
                 plan.patch_union.data_ptr(), plan.patch_offs.data_ptr(),
                 plan.patch_slots.data_ptr(), plan.patch_slots_ptr.data_ptr(), table.data_ptr(),
                 out.data_ptr(), n_row_blocks, width, plan.patch_max_used,
                 plan.patch_max_slots, int(vec), stream)
    _build.check(err, "spmm_block_launch")
    _build.count_launch(spmm_block)
    return out


#: kernel launches since the count was last set to 0
spmm_block.launches = 0
