"""The exact narrow wire of the exchange (DESIGN.md §18).

Counterpart of the exact half of ``repro/comm/compress.py``.  Count table
entries are nonnegative integers held in float32, so a slab whose maximum
fits an integer type round-trips through it bit for bit.  ``narrow_cast``
ships a slab at wire width and appends its saturation flags (``max <=
dtype max``, one per coloring) to the caller's flag list; where a flag is
false the whole batch re-runs one rung wider (:data:`WIRE_ESCALATION`),
as a compaction overflow does.  A compacted slab on a narrow wire carries
its activity bitmap bit-packed into extra columns of the wire dtype
(:func:`mask_columns`), in place of the float32 slot column: the receiver
re-derives the slots from the bitmap with the sender's own deterministic
capacity-padded nonzero.

The packed words are the reference's bit for bit: bit ``i`` of a word is
entry ``i`` of its group of 8 or 16 (little-endian), and a word is the
unsigned value bitcast to the signed wire type.

The lossy int8 gradient path of the reference is here too:
:func:`int8_compress` (per-block scales, ``round`` half to even as
``jnp.round``), :func:`int8_decompress` and
:func:`compressed_ring_reduce_scatter` on a :class:`~.group.Group`, whose
``shift`` stands for the reference's ``ppermute``.  It is a library
function, as in the reference: its train step never calls it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .group import Group

__all__ = [
    "WIRE_DTYPES",
    "WIRE_ESCALATION",
    "wire_itemsize",
    "narrow_cast",
    "widen",
    "mask_column_count",
    "mask_columns",
    "mask_from_columns",
    "int8_compress",
    "int8_decompress",
    "compressed_ring_reduce_scatter",
]

#: wire dtype name -> (torch dtype, bytes an element, largest count it holds
#: exactly); float32 is the wide (identity) wire
WIRE_DTYPES: Dict[str, tuple] = {
    "float32": (torch.float32, 4, None),
    "int16": (torch.int16, 2, 32767),
    "int8": (torch.int8, 1, 127),
}

#: on saturation a batch re-runs one rung up this ladder (the float32 rung
#: still runs the plan's compaction; its own twin is dense)
WIRE_ESCALATION: Dict[str, str] = {"int8": "int16", "int16": "float32"}

_WORD_BITS = {"int8": 8, "int16": 16}

#: elements :func:`narrow_cast` clips at a time
_CAST_BLOCK = 1 << 24


def wire_itemsize(wire_dtype: str) -> int:
    """Bytes an exchanged element takes at ``wire_dtype``."""
    return WIRE_DTYPES[wire_dtype][1]


def narrow_cast(x: torch.Tensor, wire_dtype: str,
                flags: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """A nonnegative integer-valued float32 slab ``[..., B, W]`` at wire width.

    Appends to ``flags`` the per-coloring guard ``bool [B]``: the maximum
    over coloring ``b``'s entries (every axis but the coloring axis -2) is
    at most the dtype's maximum, the reference's flag ``jax.vmap``'d over
    colorings.  Under its flag a coloring's entries cast exactly; the clip
    makes a saturated cast deterministic (its batch is re-run anyway).  The
    clip runs a block of rows at a time, so a multi-gigabyte chunk stack
    takes no float32 temporary of its own size.  ``float32`` returns ``x``
    itself.
    """
    dt, _, maxv = WIRE_DTYPES[wire_dtype]
    if maxv is None:
        return x
    if flags is not None:
        if x.numel():
            others = tuple(d for d in range(x.dim()) if d != x.dim() - 2)
            flags.append(x.amax(dim=others) <= maxv)
        else:
            flags.append(torch.ones(x.shape[-2], dtype=torch.bool, device=x.device))
    out = torch.empty(x.shape, dtype=dt, device=x.device)
    if x.numel():
        w = x.shape[-1]
        rows = max(1, _CAST_BLOCK // w)
        for src, dst in zip(x.reshape(-1, w).split(rows), out.view(-1, w).split(rows)):
            dst.copy_(src.clamp(0, maxv))
    return out


def widen(x: torch.Tensor) -> torch.Tensor:
    """The receiver's inverse of :func:`narrow_cast` (exact for in-range counts)."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _pack_mask_words(mask: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """``[..., r]`` bool -> ``[..., ceil(r / bits)]`` words of the wire dtype."""
    wb = _WORD_BITS[wire_dtype]
    r = mask.shape[-1]
    r_pad = -(-r // wb) * wb
    bits = mask.to(torch.int64)
    if r_pad != r:
        bits = torch.nn.functional.pad(bits, (0, r_pad - r))
    bits = bits.reshape(bits.shape[:-1] + (-1, wb))
    shifts = torch.arange(wb, dtype=torch.int64, device=mask.device)
    words = (bits << shifts).sum(dim=-1)  # the unsigned word, below 2^wb
    # bitcast to the signed type: values past its maximum wrap negative
    words = torch.where(words >= 1 << (wb - 1), words - (1 << wb), words)
    return words.to(WIRE_DTYPES[wire_dtype][0])


def mask_column_count(r_len: int, cap: int, wire_dtype: str) -> int:
    """Payload columns a length-``r_len`` bitmap takes beside ``cap`` rows."""
    n_words = -(-r_len // _WORD_BITS[wire_dtype])
    return -(-n_words // cap)


def mask_columns(mask: torch.Tensor, cap: int, wire_dtype: str) -> torch.Tensor:
    """``mask [..., r]`` packed into ``[..., cap, ncols]`` wire-dtype columns,
    to be concatenated onto a ``[..., cap, W]`` compact slab so the bitmap
    rides the collective of the rows it describes."""
    words = _pack_mask_words(mask, wire_dtype)
    n_words = words.shape[-1]
    ncols = -(-n_words // cap)
    if ncols * cap != n_words:
        words = torch.nn.functional.pad(words, (0, ncols * cap - n_words))
    return words.reshape(words.shape[:-1] + (ncols, cap)).transpose(-1, -2)


def mask_from_columns(cols: torch.Tensor, r_len: int, wire_dtype: str) -> torch.Tensor:
    """The inverse of :func:`mask_columns`: ``[..., cap, ncols]`` -> bool
    ``[..., r_len]``."""
    wb = _WORD_BITS[wire_dtype]
    n_words = -(-r_len // wb)
    flat = cols.transpose(-1, -2).reshape(cols.shape[:-2] + (-1,))[..., :n_words]
    u = flat.to(torch.int64) & ((1 << wb) - 1)  # the unsigned word
    shifts = torch.arange(wb, dtype=torch.int64, device=cols.device)
    bits = (u[..., None] >> shifts) & 1
    return bits.reshape(bits.shape[:-2] + (-1,))[..., :r_len] != 0


# ---------------------------------------------------------------------------
# the lossy int8 gradient ring
# ---------------------------------------------------------------------------


#: 1 / 127 rounded to float32, the factor XLA folds the division into
_INV_127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))


def int8_compress(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat int8 quantization with a float32 scale per block of ``block``
    elements: ``(q [N] int8, scales [N / block])`` of ``x`` (``N`` a multiple
    of ``block``); ``q = clip(round(x / scale), -127, 127)`` with ``scale =
    max |x| / 127`` of the block (1 where the block is all zero).

    The scale is ``max |x| * float32(1 / 127)``: traced (in the ring, or any
    jitted caller) XLA rewrites the reference's division by the constant
    into that product, which differs from a division in about 4.5% of
    floats by an ulp."""
    flat = x.reshape(-1, block)
    scale = flat.abs().amax(1, keepdim=True) * _INV_127
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0].float()


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, block: int = 256) -> torch.Tensor:
    return (q.reshape(-1, block).float() * scale[:, None]).reshape(-1)


def compressed_ring_reduce_scatter(group: Group, x: torch.Tensor, *,
                                   block: int = 256) -> torch.Tensor:
    """Ring reduce-scatter with int8 payloads: ``x`` is ``[P, chunk...]`` on
    every rank, and rank ``p`` gets its chunk ``sum_q x_q[p]`` (float32),
    each partial sum requantized before every hop, so the result is within
    the quantization of the exact sum.

    Chunk ``c`` starts at rank ``c + 1`` and travels the ring as int8 values
    and float32 block scales, gathering its partial sums, as
    ``ring.ring_reduce_scatter`` does in float32.  ``block`` halves until it
    divides the chunk's size, as the reference's does for small chunks."""
    P, p = group.size, group.rank
    if x.shape[0] != P:
        raise ValueError(f"compressed_ring_reduce_scatter takes [P={P}, ...]; "
                         f"got {tuple(x.shape)}")
    chunk_shape = x.shape[1:]
    total = x[0].numel()
    while total % block:  # shrink block to divide small chunks
        block //= 2
    block = max(block, 1)

    def dequant_add(q, s, c):
        """``q * s + c`` rounded once, as XLA contracts the reference's
        dequantize-and-add into an FMA (computed in float64, where the
        int8-by-float32 product is exact)."""
        qs = q.reshape(-1, block).double() * s[:, None].double()
        return (qs.reshape(-1) + c.reshape(-1).double()).float()

    q, s = int8_compress(x[(p - 1) % P].reshape(-1), block)
    for w in range(P - 1):
        q = group.shift(q, 1)
        s = group.shift(s, 1)
        # after this hop (q, s) holds the partial sum of chunk (p - w - 2)
        q, s = int8_compress(dequant_add(q, s, x[(p - w - 2) % P]), block)
    return int8_decompress(q, s, block).reshape(chunk_shape)
