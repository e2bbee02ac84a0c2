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
unsigned value bitcast to the signed wire type.  The lossy int8 gradient
path of the reference (``int8_compress`` and the compressed ring
reduce-scatter) serves training only: ROADMAP queue 1 item 16.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = [
    "WIRE_DTYPES",
    "WIRE_ESCALATION",
    "wire_itemsize",
    "narrow_cast",
    "widen",
    "mask_column_count",
    "mask_columns",
    "mask_from_columns",
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
