"""Color-set combine: CUDA kernel, plain version, launch count.

Computes, per sub-template split ``T_i -> (T_i', T_i'')`` and per
(vertex, coloring) row ``r``::

    out[r, s] = sum_{j < J} left[r, idx1[s, j]] * m[r, idx2[s, j]]

with ``S = C(k, t)`` output color sets and ``J = C(t, t1)`` splits each.

Replaces ``color_combine_pallas`` (``src/repro/kernels/color_combine.py``).
The TPU kernel transposes the split tables to ``[J_pad, S_pad]`` and pads
every width to 128 lanes for Mosaic's lane gather; here tables run at true
widths and the split table is packed for the kernel instead
(``ops.build_combine_tables``: ``idx1 | idx2 << 16`` in ``[s_tile][J][ts]``
order, so a warp's ``ts`` output columns read one contiguous run per ``j``).

Kernel (``csrc/color_combine.cu``): one thread per ``(r, s)``; a block
stages its s-tile of the packed table in shared memory (48 KB cap; larger
``J`` reads it through the read-only path) and strides over rows, and each
thread runs ``fmaf`` over ``j`` in ascending order — the same loop as the
fused kernel's second phase, so the two paths agree bitwise.

Bound on the H100: for the widest u12-2 node (``S = 792, J = 35``) it does
``2 * J`` flops per output float against ``(A + Bw + S) * 4`` bytes per row
of reads and writes, about 9 flop/byte: bytes bound against the 67 TFLOP/s
float32 rate (no tensor cores: counts stay exact float32).  Each row's
operands (at most a few KB) are reused by all ``S`` threads of the row
through L1, so the design reads ``left`` and ``m`` about once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import color_combine_ref
from .spmm_edgetile import _check_cuda

__all__ = ["color_combine", "color_combine_plain"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def color_combine_plain(left: torch.Tensor, m: torch.Tensor, tables) -> torch.Tensor:
    """The plain version the wrapper takes for a CPU tensor."""
    return color_combine_ref(left, m, tables.idx1, tables.idx2)


def color_combine(left: torch.Tensor, m: torch.Tensor, tables) -> torch.Tensor:
    """``left`` ``[n, B, A]``, ``m`` ``[n, B, Bw]`` -> ``[n, B, S]``.

    ``tables`` is an ``ops.CombineTables``.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises.
    """
    if left.device.type == "cpu":
        return color_combine_plain(left, m, tables)
    _check_cuda(left, (tables.pairs, torch.int32))
    _check_cuda(m)
    n, b, a = left.shape
    if m.shape != (n, b, tables.w) or a != tables.a:
        raise ValueError(
            f"left {tuple(left.shape)} and m {tuple(m.shape)} do not fit split tables of "
            f"widths ({tables.a}, {tables.w})"
        )
    out = torch.empty((n, b, tables.s), dtype=torch.float32, device=left.device)
    fn = _build.kernel_fn("color_combine", "color_combine_launch", _ARGTYPES)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        err = fn(left.data_ptr(), m.data_ptr(), tables.pairs.data_ptr(), out.data_ptr(),
                 n * b, a, tables.w, tables.s, tables.j, tables.ts, stream)
    _build.check(err, "color_combine_launch")
    color_combine.launches += 1
    return out


#: kernel launches since the count was last set to 0
color_combine.launches = 0
