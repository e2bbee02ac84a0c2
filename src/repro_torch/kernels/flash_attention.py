"""Flash attention (online softmax, GQA, causal and sliding-window masks):
two CUDA kernels by dtype, the plain version, launch counts.

Replaces ``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py``),
whose grid ``(B, Hq, L/128, L/128)`` runs in order on one TPU core and
carries the running max, denominator and accumulator in VMEM scratch across
the innermost KV dimension.  On the card the CTAs run in no order, so the KV
sweep is a loop inside one CTA.  Both kernels compute
:func:`~repro_torch.kernels.ref.flash_attention_ref`: the finite ``-1e30``
mask, probabilities zeroed where masked, a zero denominator read as 1, any
``L``, D in {64, 128, 256}.

- **bf16** (``csrc/flash_attention_wgmma.cu``): one CTA per (128-row query
  tile, query head, batch), a producer warp that stages Q once and K and V
  through a two-stage ring with TMA (3-D tensor maps ``(D, L, B H)``, 128-byte
  swizzle, rows past ``L`` read as zeros), and two consumer warpgroups of 64
  rows that run ``Q K^T`` and ``P V`` as ``wgmma`` with float32 accumulators.
  P is split into three bf16 terms, each the bf16 truncation of what the
  terms before it leave, which hold float32 P exactly, and all three go
  through ``P V``, so the products keep the reference's float32 P: P rounded
  to bf16 alone, or split in two, misses the one-bf16-step gate.  At D = 256
  the KV tiles hold 64 keys (:func:`kv_tile`), so Q and the ring fit the
  shared memory a CTA may opt into and O, S and P the registers.  Bound on the H100:
  operations, ``4 B Hq pairs D`` flops at 989e12 bf16 flop/s; the split does
  ``8 D`` a pair.
- **float32** (``csrc/flash_attention.cu``): plain float32 FMAs on the CUDA
  cores (TF32 tensor cores would break the float32 checks' 1e-5).  One CTA
  of 256 threads per (query tile, head, batch), 128 query rows (64 at
  D = 256), grid ``(Hq, B, query tiles)``; Q staged once and the tile stream
  ``K_0, V_0, K_1, ...`` of 64 keys through a ring of shared-memory slots
  with ``cp.async`` (as many slots as fit, up to 4), rows padded by 16 bytes;
  a lane holds 8 query rows (4 at D = 256) x 4 keys of S and the same rows
  of O; P goes to the P V layout through its warp's own block of shared
  memory.  Its geometry is :func:`fp32_geometry`, :func:`fp32_launch_grid`
  and :func:`fp32_kv_tiles` / :func:`fp32_tile_needs_mask`.  Bound on the
  H100: operations, ``2 B Hq pairs D`` float32 FMAs at 33.5e12 a second.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel of its
dtype or raises; a ``meta`` tensor (the dry-run's shape-only run) checks the
same contract, allocates the output and records the launch and its work
(:func:`.work.flash_attention`) under ``work.LaunchLog``.  The host-side arithmetic of the bf16 kernel lives here as
plain functions the CPU tests reach: :func:`launch_grid`,
:func:`tensor_map_geometry`, and :func:`kv_tiles` / :func:`tile_needs_mask`,
which the kernel computes on the device the same way; and the float32
kernel's, the ``fp32_`` functions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build, work
from .ref import flash_attention_ref

__all__ = [
    "flash_attention", "flash_attention_plain", "HEAD_DIMS", "TILE", "BOX_COLS", "query_tiles",
    "kv_tile", "kv_tiles", "tile_needs_mask", "launch_grid", "tensor_map_geometry",
    "Fp32Geometry", "fp32_geometry", "fp32_launch_grid", "fp32_kv_tiles", "fp32_tile_needs_mask",
]

#: the plain version the wrapper takes for a CPU tensor
flash_attention_plain = flash_attention_ref

#: head dimensions the kernels are built for
HEAD_DIMS = (64, 128, 256)

#: query rows per CTA of the bf16 kernel, and keys per KV tile below D = 256
TILE = 128

#: bf16 columns of one 128-byte-swizzled TMA box
BOX_COLS = 64

_FP32_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_longlong),
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])


def query_tiles(length: int) -> int:
    """Query tiles (and KV tiles) of ``TILE`` rows over ``length`` tokens."""
    return -(-length // TILE)


def kv_tile(d: int) -> int:
    """Keys per KV tile of the bf16 kernel at head dim ``d``: ``TILE``, and 64
    at D = 256 (a 128-key ring beside Q would need 320 KB of shared memory)."""
    return 64 if d == 256 else TILE


def kv_tiles(qt: int, length: int, causal: bool, window: int, block_n: int = TILE,
             block_m: int = TILE) -> range:
    """The KV tiles of ``block_n`` keys query tile ``qt`` (``block_m`` rows)
    visits: every tile holding a key that some row of the tile may attend, in
    ascending order."""
    m0 = qt * block_m
    q_last = min(m0 + block_m, length) - 1
    end = q_last // block_n + 1 if causal else -(-length // block_n)
    begin = max(0, m0 - window + 1) // block_n if window > 0 else 0
    return range(begin, end)


def tile_needs_mask(qt: int, kt: int, length: int, causal: bool, window: int,
                    block_n: int = TILE, block_m: int = TILE) -> bool:
    """Whether some (row < length, key) pair of query tile ``qt`` (``block_m``
    rows) and KV tile ``kt`` (of ``block_n`` keys) is masked (keys past
    ``length`` included); the kernel skips the mask code on the others."""
    m0, n0 = qt * block_m, kt * block_n
    q_last = min(m0 + block_m, length) - 1
    return (n0 + block_n > length or (causal and n0 + block_n - 1 > m0)
            or (window > 0 and n0 <= q_last - window))


def launch_grid(b: int, hq: int, length: int) -> Tuple[int, int, int]:
    """``(Hq, B, query tiles)``: one CTA per (query tile, head, batch); the
    kernel reverses the tile index so the longest causal tiles start first."""
    return hq, b, query_tiles(length)


def tensor_map_geometry(batch_heads: int, length: int, d: int,
                        rows: int = TILE) -> Tuple[int, ...]:
    """One bf16 tensor map over ``[B, H, L, D]`` as 3-D ``(D, L, B H)``: its
    dims (innermost first), the byte strides of dims 1 and 2, and the box of
    ``BOX_COLS`` columns by ``rows`` rows of one head (a 128-byte row, the
    swizzle's width, so D = 128 takes two boxes and D = 256 four).  Q's box
    is ``TILE`` rows, K's and V's ``kv_tile(d)``."""
    return (d, length, batch_heads, 2 * d, 2 * d * length, BOX_COLS, rows, 1)


class Fp32Geometry(NamedTuple):
    """The float32 kernel's CTA at one head dim (``csrc/flash_attention.cu``,
    ``Geo<D>``; its ``flash_attention_geometry`` entry reports the same)."""

    rows: int  # query rows a CTA
    keys: int  # keys a KV tile
    threads: int
    stages: int  # slots of the K/V ring
    lane_rows: int  # query rows a lane owns in S and O
    smem_bytes: int  # dynamic shared memory: Q, the ring, each warp's block of P


#: dynamic shared memory a CTA may opt into on the H100, bytes
MAX_SMEM = 232_448


def fp32_geometry(d: int) -> Fp32Geometry:
    """The float32 kernel's geometry at head dim ``d``: 8 warps of 2 row
    groups; 8 rows a lane up to D = 128 and 4 at D = 256 (a 128-row Q tile
    would leave no room for two slots of 64 keys); rows staged at a pitch of
    ``d + 4`` floats; as many ring slots as fit in :data:`MAX_SMEM` beside Q
    and the warps' blocks of P, up to 4."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the float32 kernel is built for head dims {HEAD_DIMS}, got {d}")
    threads, keys, pitch = 256, 64, d + 4
    lane_rows = 8 if d <= 128 else 4
    warps = threads // 32
    rows = 2 * lane_rows * warps
    fixed = 4 * (rows * pitch + warps * keys * 2 * lane_rows)
    stages = min(4, (MAX_SMEM - fixed) // (4 * keys * pitch))
    return Fp32Geometry(rows, keys, threads, stages, lane_rows,
                        fixed + stages * 4 * keys * pitch)


def fp32_launch_grid(b: int, hq: int, length: int, d: int) -> Tuple[int, int, int]:
    """``(Hq, B, query tiles)`` of the float32 kernel: tiles of
    ``fp32_geometry(d).rows`` rows, the index reversed on the card so the
    longest causal tiles of every head start first."""
    return hq, b, -(-length // fp32_geometry(d).rows)


def fp32_kv_tiles(qt: int, length: int, causal: bool, window: int, d: int) -> range:
    """The KV tiles the float32 kernel's query tile ``qt`` visits at head dim ``d``."""
    g = fp32_geometry(d)
    return kv_tiles(qt, length, causal, window, g.keys, g.rows)


def fp32_tile_needs_mask(qt: int, kt: int, length: int, causal: bool, window: int,
                         d: int) -> bool:
    """Whether the float32 kernel runs the mask code on query tile ``qt`` and
    KV tile ``kt`` at head dim ``d``."""
    g = fp32_geometry(d)
    return tile_needs_mask(qt, kt, length, causal, window, g.keys, g.rows)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Softmax attention of ``q`` ``[B, Hq, L, D]`` over ``k``, ``v`` ``[B, Hkv, L, D]``.

    Query head ``h`` reads KV head ``h // (Hq / Hkv)``; ``causal`` masks keys
    after the query, ``window > 0`` keys at or before ``query - window``;
    the logits are scaled by ``D**-0.5``.  Returns ``[B, Hq, L, D]`` in ``q``'s
    dtype.  A CPU tensor runs the plain version (which also takes ``Lq !=
    Lk``); a CUDA tensor launches the bf16 (wgmma) or the float32 (CUDA-core)
    kernel, or raises; a ``meta`` tensor checks the kernels' contract and
    records the launch a CUDA tensor would make (:func:`.work.record`),
    returning a ``meta`` output and counting no launch.  Neither the kernels nor the reference's Pallas kernel
    has a backward, so a tensor that requires a gradient (with grad mode on)
    raises on either device: training attends through
    ``models.attention.chunked_attention``, as the reference trains.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B, Hq, L, D], k and v [B, Hkv, L, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k and v {tuple(k.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention has no backward: a tensor that requires a gradient "
                           "attends through models.attention.chunked_attention")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    if q.device.type == "meta":
        work.record("flash_attention", (q, k, v, out),
                    work.flash_attention(b, hq, hkv, lq, d, q.element_size(), causal, window))
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, lq, d,
            int(bool(causal)), int(window))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            fn = _build.kernel_fn("flash_attention_wgmma", "flash_attention_wgmma_launch",
                                  _WGMMA_ARGTYPES)
            grid = (ctypes.c_uint * 3)(*launch_grid(b, hq, lq))
            q_geo = (ctypes.c_longlong * 8)(*tensor_map_geometry(b * hq, lq, d))
            kv_geo = (ctypes.c_longlong * 8)(*tensor_map_geometry(b * hkv, lq, d, kv_tile(d)))
            err = fn(*args, grid, q_geo, kv_geo, stream)
            _build.check(err, "flash_attention_wgmma_launch")
            flash_attention.launches_wgmma += 1
        else:
            fn = _build.kernel_fn("flash_attention", "flash_attention_launch", _FP32_ARGTYPES)
            _build.check(fn(*args, stream), "flash_attention_launch")
            flash_attention.launches_fp32 += 1
    flash_attention.launches += 1
    return out


#: kernel launches since the counts were last set to 0: all, and by route
flash_attention.launches = 0
flash_attention.launches_wgmma = 0  # bf16, csrc/flash_attention_wgmma.cu
flash_attention.launches_fp32 = 0  # float32, csrc/flash_attention.cu


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernels' argument contract, on the card and on ``meta`` alike;
    raises on anything they do not take."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"q must be on a CUDA device, the meta device or the CPU, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernels take bfloat16 (wgmma) or float32, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the kernels are built for head dims {HEAD_DIMS}, got {q.shape[3]}")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"the kernels are self-attention (Lq == Lk), got Lq {q.shape[2]} and "
                         f"Lk {k.shape[2]}")
    tiles = (fp32_launch_grid(*q.shape[:3], q.shape[3])[2] if q.dtype == torch.float32
             else query_tiles(q.shape[2]))
    if q.shape[0] > 65535 or q.shape[1] > 65535 or tiles > 65535:
        raise ValueError(f"batch, heads and query tiles must each be at most 65535, got "
                         f"{tuple(q.shape[:3])}")
