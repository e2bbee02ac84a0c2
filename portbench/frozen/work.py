"""Frozen yardstick: the least work of a counting kernel launch, and the H100's roofline.

Copied from ``src/repro_torch/kernels/work.py`` (``Work``, ``spmm_edge``,
``color_combine``, ``fused_count``) and ``src/repro_torch/roofline/analysis.py``
(``bound_s`` and its three peaks) at commit
a494de88284566a21c06859f56eb82c9335cb1f8.  A ``Work`` is what a launch must
do at its shapes, whatever implements it: each input read once, each
output written once (bytes), and its float32 adds and FMAs on the CUDA
cores (count tables stay exact, so they never reach the tensor cores).
The peaks are the data sheet's for one H100 SXM at 700 W.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: HBM3 bytes a second (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores: 67e12 flop/s with an FMA as two, so
#: 33.5e12 adds or FMAs a second (data sheet)
FP32_OPS_PER_S = 33.5e12
#: bf16 tensor cores, dense (data sheet)
BF16_FLOPS_PER_S = 989e12

#: bytes of a count-table entry (float32) and of an index (int32); CSR row
#: offsets are int64
F32 = 4
I32 = 4
I64 = 8


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's least work: bytes moved, float32 adds and FMAs, bf16
    tensor-core flops."""

    bytes: float = 0.0
    adds: float = 0.0
    fmas: float = 0.0
    bf16_flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.adds + other.adds, self.fmas + other.fmas,
                    self.bf16_flops + other.bf16_flops)


def _csr_bytes(rows: int, edges: int) -> int:
    return (rows + 1) * I64 + edges * I32


def spmm_edge(rows: int, source_rows: int, edges: int, width: int) -> Work:
    """The edge SpMM: ``rows`` output rows of ``width`` floats summed over
    ``edges`` CSR entries from a ``source_rows``-row source; an add an edge
    and column."""
    return Work(bytes=(source_rows + rows) * width * F32 + _csr_bytes(rows, edges),
                adds=edges * width)


def color_combine(rows: int, a: int, w: int, s: int, j: int, jp: int) -> Work:
    """The color-set combine over ``rows`` table rows (vertices x colorings):
    reads ``left`` (``a`` wide), ``m`` (``w``) and the packed split table
    (``[s, jp]`` int32), writes ``s`` columns; ``s j`` FMAs a row."""
    return Work(bytes=rows * (a + w + s) * F32 + s * jp * I32, fmas=rows * s * j)


def fused_count(rows: int, source_rows: int, edges: int, batch: int, a: int, w: int, s: int,
                j: int, jp: int) -> Work:
    """The fused neighbor sum and combine: ``M`` is never read or written."""
    return Work(bytes=(rows * (a + s) + source_rows * w) * batch * F32 + _csr_bytes(rows, edges)
                + s * jp * I32,
                adds=edges * batch * w, fmas=rows * batch * s * j)


def bound_s(w: Work) -> Tuple[float, str]:
    """The least time one H100 could take for ``w``: the larger of its bytes
    at the HBM rate and its operations at their peaks; and which it is."""
    t_bytes = w.bytes / HBM_BYTES_PER_S
    t_ops = (w.adds + w.fmas) / FP32_OPS_PER_S + w.bf16_flops / BF16_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
