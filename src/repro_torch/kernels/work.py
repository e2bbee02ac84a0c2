"""What one launch of each kernel must do, and the log of shape-only launches.

A :class:`Work` is the least a launch has to do at its shapes, whatever
implements it: the bytes it must move (each input read once, each output
written once), its float32 adds and FMAs on the CUDA cores (count tables
stay exact, so they never reach the tensor cores; float32 flash attention)
and its bf16 tensor-core flops (bf16 flash attention).  Where the work
depends on the data (a CSR's edges), the caller passes what this launch's
data holds.  The roofline
(:mod:`repro_torch.roofline.analysis`) turns a ``Work`` into the least time a
card could take; ``chip_smoke.py``'s bound column and the dry-run's cost
(:mod:`repro_torch.launch.dryrun`) read the same functions.

The kernels' shape-only (``meta``) branches report each launch with
:func:`record` to the :class:`LaunchLog` open on the calling thread, if any:
a dry-run reads a program's launches and their work from it, and a launch
on the card or the CPU never reaches it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Work",
    "spmm_edge",
    "color_combine",
    "fused_count",
    "spmm_block",
    "flash_attention",
    "attention_pairs",
    "Launch",
    "LaunchLog",
    "record",
    "launch_shapes",
]

#: bytes of a count-table entry (float32) and of an index (int32); CSR row
#: offsets are int64
F32 = 4
I32 = 4
I64 = 8


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's least work: bytes moved, float32 adds and FMAs (an FMA
    issues as one operation), bf16 tensor-core flops (an FMA as two)."""

    bytes: float = 0.0
    adds: float = 0.0
    fmas: float = 0.0
    bf16_flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.adds + other.adds, self.fmas + other.fmas,
                    self.bf16_flops + other.bf16_flops)

    @property
    def flops(self) -> float:
        """Floating-point operations, an FMA as two."""
        return self.adds + 2.0 * self.fmas + self.bf16_flops


def _csr_bytes(rows: int, edges: int) -> int:
    return (rows + 1) * I64 + edges * I32


def spmm_edge(rows: int, source_rows: int, edges: int, width: int) -> Work:
    """``spmm_edgetile``: ``rows`` output rows of ``width`` floats (``B W``),
    summed over ``edges`` CSR entries from a ``source_rows``-row source.
    Reads the source and the CSR, writes the output; an add an edge and
    column."""
    return Work(bytes=(source_rows + rows) * width * F32 + _csr_bytes(rows, edges),
                adds=edges * width)


def color_combine(rows: int, a: int, w: int, s: int, j: int, jp: int) -> Work:
    """``color_combine`` over ``rows`` table rows (vertices x colorings):
    reads ``left`` (``a`` wide), ``m`` (``w``) and the packed split table
    (``[s, jp]`` int32), writes ``s`` columns; ``s j`` FMAs a row."""
    return Work(bytes=rows * (a + w + s) * F32 + s * jp * I32, fmas=rows * s * j)


def fused_count(rows: int, source_rows: int, edges: int, batch: int, a: int, w: int, s: int,
                j: int, jp: int) -> Work:
    """``fused_count``: the neighbor sum of a ``source_rows``-row source
    (``w`` wide a coloring) over ``edges`` CSR entries, contracted with
    ``left`` (``a``) into ``s`` columns, for ``rows`` vertices of ``batch``
    colorings; ``M`` is never read or written."""
    return Work(bytes=(rows * (a + s) + source_rows * w) * batch * F32 + _csr_bytes(rows, edges)
                + s * jp * I32,
                adds=edges * batch * w, fmas=rows * batch * s * j)


def spmm_block(n_pad: int, patches: int, edges: int, width: int, block: int = 128) -> Work:
    """``spmm_block`` over a plan of ``patches`` occupied ``block x block``
    patches: reads their bitmasks (``block`` rows of ``block / 32`` words)
    and the patch CSR, the table, writes the output; an add an edge and
    column."""
    nrb = n_pad // block
    layout = patches * block * (block // 32) * I32 + (nrb + 1 + patches) * I32
    return Work(bytes=layout + 2 * n_pad * width * F32, adds=edges * width)


def attention_pairs(length: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask allows in self-attention over ``length`` tokens."""
    i = np.arange(length, dtype=np.int64)
    hi = i + 1 if causal else np.full_like(i, length)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(batch: int, q_heads: int, kv_heads: int, length: int, head_dim: int,
                    itemsize: int, causal: bool, window: int) -> Work:
    """Flash attention: reads ``q``, ``k``, ``v`` and writes ``o`` once; an
    allowed pair costs ``D`` multiply-adds for ``Q K^T`` and ``D`` for ``P V``:
    ``2 D`` float32 FMAs on the CUDA cores for a float32 launch (``itemsize``
    4), ``4 D`` bf16 tensor-core flops otherwise."""
    q_elems = batch * q_heads * length * head_dim
    kv_elems = batch * kv_heads * length * head_dim
    nbytes = (2 * q_elems + 2 * kv_elems) * itemsize
    macs = 2 * batch * q_heads * attention_pairs(length, causal, window) * head_dim
    if itemsize == 4:
        return Work(bytes=nbytes, fmas=macs)
    return Work(bytes=nbytes, bf16_flops=2 * macs)


# ---------------------------------------------------------------------------
# shape-only launches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Launch:
    """One shape-only launch: the kernel, the shapes of its tensor arguments
    (in the wrapper's order) and of its output, and its work."""

    name: str
    shapes: Tuple[Tuple[int, ...], ...]
    work: Work


def launch_shapes(*tensors: torch.Tensor) -> Tuple[Tuple[int, ...], ...]:
    """The shapes a :class:`Launch` records for these tensors."""
    return tuple(tuple(t.shape) for t in tensors)


_local = threading.local()


class LaunchLog:
    """The shape-only launches made on this thread while the log is open
    (``with LaunchLog() as log``); logs nest, and every open one records."""

    def __init__(self):
        self.launches: List[Launch] = []

    def __enter__(self) -> "LaunchLog":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _local.stack.remove(self)

    def counts(self) -> dict:
        out: dict = {}
        for launch in self.launches:
            out[launch.name] = out.get(launch.name, 0) + 1
        return out

    def work(self) -> Work:
        total = Work()
        for launch in self.launches:
            total = total + launch.work
        return total


def record(name: str, tensors: Sequence[torch.Tensor], work: Work) -> None:
    """Report a shape-only launch to every open log on this thread."""
    launch = Launch(name, launch_shapes(*tensors), work)
    for log in getattr(_local, "stack", ()):
        log.launches.append(launch)
