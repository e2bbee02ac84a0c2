"""Color-set combine: CUDA kernel, plain version, launch count, tile plan.

Computes, per sub-template split ``T_i -> (T_i', T_i'')`` and per
(vertex, coloring) row ``r``::

    out[r, s] = sum_{j < J} left[r, idx1[s, j]] * m[r, idx2[s, j]]

with ``S = C(k, t)`` output color sets and ``J = C(t, t1)`` splits each.

Replaces ``color_combine_pallas`` (``src/repro/kernels/color_combine.py``).
The TPU kernel transposes the split tables to ``[J_pad, S_pad]`` and pads
every width to 128 lanes for Mosaic's lane gather; here tables run at true
widths and the split table is packed for the kernel instead
(``ops.build_combine_tables``: ``idx1 | idx2 << 16``, ``[S, Jp]`` with ``J``
padded to 4, so four splits are one 16-byte load).

Kernel (``csrc/color_combine.cu``, tile machinery in
``csrc/combine_tile.cuh``): one CTA of 8 warps per tile of ``T`` rows.  It
stages ``left`` and ``m`` of its rows in shared memory, column-major with an
odd pitch ``T | 1`` (coalesced 16-byte loads), and walks the output in
chunks of ``SC`` columns: the chunk's split entries land in shared memory
by ``cp.async`` while the previous chunk is computed; a warp item is 32 rows
(lane = row) by up to four output columns, so a chain's lanes read the same
split entries (a broadcast) and one column of 32 rows from 32 banks, and a
lane keeps up to four chains in flight; outputs go back through shared
memory and out in coalesced rows.  Each output is ``fmaf`` over ascending
``j`` into one accumulator (``combine_dot``), as in the fused kernel's
second phase, so the two paths agree bitwise.  :func:`plan_tile` picks
``T``, ``SC`` and the item width from the card's shared memory, for both
kernels; the rules were measured on the H100 (``PERF.md``).

Bound on the H100: bytes at most nodes (each operand row read once, each
output row written once).  At u12-2's (220, 495, 792, 35) the FMAs' operands
bind: exact float32 (no tensor cores), two operands an FMA from shared
memory and the split entries broadcast, 2.25 wavefronts of 128 bytes an FMA,
about 28 ms a pass at 128 bytes a clock an SM against 7.5 ms of bytes.
The earlier design (one thread per ``(row, s)``, operands read at scattered
columns through L1, one warp spanning 32 columns of one row, or 32 rows of
the root's single column) reached 6.3x its bound over a u12-2 pass.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build, work
from .ref import color_combine_ref
from .spmm_edgetile import _check_args

__all__ = ["color_combine", "color_combine_plain", "plan_tile", "tile_bytes", "chunk_columns",
           "columns_an_item", "check_pairs",
           "SmemLimits", "Tile", "H100_SMEM", "MAX_TILE_ROWS", "TILE_WARPS",
           "device_smem_limits"]

#: warps of one CTA of the combine and fused kernels (``kTileWarps``)
TILE_WARPS = 8
#: the most table rows one tile holds
MAX_TILE_ROWS = 128
#: a chunk's packed split entries take at most this many 4-byte words, within
#: the kernel's floor on chunk columns (``CHUNK_FLOOR``) and 128 columns
CHUNK_WORDS = 1024
CHUNK_FLOOR = {"combine": 32, "fused": 64}
#: CTAs an SM a tile is sized for first (shared memory of an SM over them)
TILE_CTAS = {"combine": 3, "fused": 4}
#: the most output columns a warp item takes (chains in flight a lane)
MAX_COLUMNS = {"combine": 4, "fused": 2}
#: the fused kernel's static shared memory (its unit counter), at most
FUSED_STATIC_BYTES = 16


@dataclasses.dataclass(frozen=True)
class SmemLimits:
    """A card's shared memory, in bytes."""

    per_block: int  # the most a block may opt in to
    per_sm: int  # an SM's
    reserved: int  # what the runtime keeps of it a block


#: the H100's (cudaDevAttrMaxSharedMemoryPerBlockOptin, ...PerMultiprocessor,
#: ReservedSharedMemoryPerBlock)
H100_SMEM = SmemLimits(per_block=232_448, per_sm=233_472, reserved=1024)


@dataclasses.dataclass(frozen=True)
class Tile:
    """One CTA's share of a combine or fused launch."""

    rows: int  # T: table rows of the tile (vertices x colorings for the fused kernel)
    colorings: int  # colorings of a vertex the tile holds (1 for the combine)
    chunk: int  # SC: output columns computed and written at a time
    smem_bytes: int  # dynamic shared memory of one CTA (the fused kernel adds static)
    per_sm: int  # CTAs an SM holds by shared memory
    columns: int = 1  # output columns a warp item takes: 1, 2 or 4

    @property
    def vertices(self) -> int:
        return self.rows // self.colorings


def chunk_columns(rows: int, s: int, jp: int, kernel: str = "combine") -> int:
    """``SC``, the output columns of a chunk: as many as keep the chunk's
    split entries within ``CHUNK_WORDS`` words, between the kernel's floor
    and 128, and at least ``8 * 32 / rows`` at tiles below 8 rows (so that
    each of the 8 warps has a column group); evened out over ``S``."""
    groups = 32 // min(rows, 32)
    sc = min(128, max(CHUNK_FLOOR[kernel], CHUNK_WORDS // jp))
    sc = min(s, max(sc, TILE_WARPS * groups))
    n_chunks = -(-s // sc)
    return -(-s // n_chunks)


def columns_an_item(rows: int, s: int, sc: int, kernel: str = "combine") -> int:
    """Output columns a warp item takes, each lane running as many chains:
    4 (the fused kernel: 2) where a chunk holds four column groups or more,
    2 where it holds two or three, else 1 (``S = 1``, and outputs narrower
    than a warp's column groups)."""
    groups = 32 // min(rows, 32)
    n_cg = -(-min(sc, s) // groups)
    cols = 4 if n_cg >= 4 else 2 if n_cg >= 2 else 1
    return min(cols, MAX_COLUMNS[kernel])


def tile_bytes(rows: int, a: int, w: int, s: int, jp: int, kernel: str = "combine") -> int:
    """Dynamic shared memory of a ``rows``-row tile (``tile_smem_bytes`` in
    ``csrc/combine_tile.cuh``): left, M and the output chunk at pitch
    ``rows | 1``, and two chunks' packed split entries (the next one lands
    while the current one is read)."""
    sc = chunk_columns(rows, s, jp, kernel)
    return 4 * ((rows | 1) * (a + w + sc) + 2 * sc * jp)


def plan_tile(a: int, w: int, s: int, jp: int, limits: SmemLimits, batch: int = 0) -> Tile:
    """Tile rows and chunk columns for a node of widths ``(a, w, s)`` and
    padded split count ``jp``, deterministically from the card's shared
    memory.

    ``batch == 0`` (the combine): ``T`` in 128, 64, ..., 1; the largest whose
    tile fits ``TILE_CTAS["combine"]`` (three) CTAs an SM, raised to 32 rows
    (a warp's lanes on 32 rows of one column) where those fit two.
    ``batch = B`` (the fused kernel): whole vertices, ``T = V B`` with ``V``
    in powers of two from the largest with ``V B <= 128`` down to 1; the
    first that fits four CTAs an SM (so that their phases overlap).  Where
    nothing fits that many, the first candidate that fits the most CTAs
    wins.  Only where not even one vertex's ``B`` rows fit a CTA, one vertex
    and ``Bt < B`` of its colorings, ``Bt`` in powers of two.  Raises
    ``ValueError`` if not even one row fits.
    """
    kernel = "fused" if batch else "combine"
    if batch:
        whole, split = [], []
        if batch <= MAX_TILE_ROWS:
            v = 1 << ((MAX_TILE_ROWS // batch).bit_length() - 1)
            while v:
                whole.append((v * batch, batch))
                v //= 2
        bt = 1 << (min(batch - 1, MAX_TILE_ROWS).bit_length() - 1) if batch > 1 else 0
        while bt:
            split.append((bt, bt))
            bt //= 2
        groups = (whole, split)
    else:
        groups = ([(MAX_TILE_ROWS >> i, 1) for i in range(MAX_TILE_ROWS.bit_length())],)
    static = FUSED_STATIC_BYTES if batch else 0

    def tile(rows, colorings):
        n = tile_bytes(rows, a, w, s, jp, kernel)
        sc = chunk_columns(rows, s, jp, kernel)
        return Tile(rows=rows, colorings=colorings, chunk=sc, smem_bytes=n,
                    per_sm=limits.per_sm // (n + static + limits.reserved),
                    columns=columns_an_item(rows, s, sc, kernel))

    def fits(t, ctas):
        return (t.smem_bytes + static <= limits.per_block
                and t.smem_bytes + static <= limits.per_sm // ctas - limits.reserved)

    for cands in groups:  # coloring groups only where no whole vertex fits
        tiles = [tile(r, c) for r, c in cands]
        for ctas in range(TILE_CTAS[kernel], 0, -1):
            for t in tiles:
                if fits(t, ctas):
                    if not batch and ctas == 3 and t.rows < 32 and fits(tile(32, 1), 2):
                        return tile(32, 1)
                    return t
    raise ValueError(
        f"a node of widths (A={a}, W={w}, S={s}, Jp={jp}) does not fit one row in "
        f"{limits.per_block} bytes of shared memory"
    )


_smem = {}


def device_smem_limits(device: torch.device) -> SmemLimits:
    """The card's shared memory, read once per device; a shape-only run
    (``meta``) plans for the H100's, which it does not query."""
    if device.type == "meta":
        return H100_SMEM
    limits = _smem.get(device.index)
    if limits is None:
        fn = _build.kernel_fn("color_combine", "combine_smem_limits",
                              [ctypes.c_int, ctypes.c_void_p])
        out = (ctypes.c_int * 3)()
        _build.check(fn(device.index, ctypes.addressof(out)), "combine_smem_limits")
        limits = _smem[device.index] = SmemLimits(*out)
    return limits


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def check_pairs(tables, device: torch.device) -> None:
    """The packed split table as the kernels read it: int32 ``[S, jp]``,
    contiguous and 16-byte aligned (four splits a 16-byte load), on
    ``device``; raises otherwise."""
    p = tables.pairs
    if (p.device != device or p.dtype != torch.int32 or not p.is_contiguous()
            or tuple(p.shape) != (tables.s, tables.jp) or p.data_ptr() % 16):
        raise ValueError(
            f"packed split table must be a contiguous, 16-byte aligned int32 "
            f"[{tables.s}, {tables.jp}] on {device}; got {p.dtype} {tuple(p.shape)} on {p.device}"
        )


def color_combine_plain(left: torch.Tensor, m: torch.Tensor, tables) -> torch.Tensor:
    """The plain version the wrapper takes for a CPU tensor."""
    return color_combine_ref(left, m, tables.idx1, tables.idx2)


def color_combine(left: torch.Tensor, m: torch.Tensor, tables) -> torch.Tensor:
    """``left`` ``[n, B, A]``, ``m`` ``[n, B, Bw]`` -> ``[n, B, S]``.

    ``tables`` is an ``ops.CombineTables``.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises.  A ``meta`` tensor
    (a shape-only run) checks the same contract, allocates the CUDA
    branch's output and records the launch and its work
    (:func:`.work.record`).
    """
    if left.device.type == "cpu":
        return color_combine_plain(left, m, tables)
    _check_args(left)
    _check_args(m)
    check_pairs(tables, left.device)
    n, b, a = left.shape
    if m.shape != (n, b, tables.w) or a != tables.a:
        raise ValueError(
            f"left {tuple(left.shape)} and m {tuple(m.shape)} do not fit split tables of "
            f"widths ({tables.a}, {tables.w})"
        )
    tile = plan_tile(a, tables.w, tables.s, tables.jp, device_smem_limits(left.device))
    out = torch.empty((n, b, tables.s), dtype=torch.float32, device=left.device)
    if left.device.type == "meta":
        work.record("color_combine", (left, m, out),
                    work.color_combine(n * b, a, tables.w, tables.s, tables.j, tables.jp))
        return out
    fn = _build.kernel_fn("color_combine", "color_combine_launch", _ARGTYPES)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        err = fn(left.data_ptr(), m.data_ptr(), tables.pairs.data_ptr(), out.data_ptr(),
                 n * b, a, tables.w, tables.s, tables.j, tables.jp, tile.rows, tile.chunk,
                 tile.columns, stream)
    _build.check(err, "color_combine_launch")
    _build.count_launch(color_combine)
    return out


#: kernel launches since the count was last set to 0
color_combine.launches = 0
