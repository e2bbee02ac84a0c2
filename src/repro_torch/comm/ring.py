"""Ring collectives over a :class:`~.group.Group`: shift-by-one relays that
overlap each hop with the compute on the chunk in hand.

Counterpart of ``repro/comm/ring.py``.  The reference issues the next hop's
``ppermute`` before the compute on the current chunk and lets XLA's async
scheduler overlap them; here the hop is posted with ``shift_start`` before
the compute and waited for after it.  The cold-start stage (the paper's
Fig. 3, stage 0) is the local chunk's compute, issued before the first hop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .group import Group

__all__ = ["ring_allgather", "ring_allgather_overlap", "ring_reduce_scatter"]


def ring_allgather(group: Group, x: torch.Tensor, *, tiled: bool = False) -> torch.Tensor:
    """All-gather by P - 1 relayed hops: ``out[q]`` is rank ``q``'s ``x``
    (``[P * x.shape[0], ...]`` when ``tiled``)."""
    P, p = group.size, group.rank
    parts = [None] * P
    parts[p] = x
    buf = x
    for w in range(P - 1):
        buf = group.shift(buf, 1)
        parts[(p - w - 1) % P] = buf
    out = torch.stack(parts)
    return out.reshape((P * x.shape[0],) + tuple(x.shape[1:])) if tiled else out


def ring_allgather_overlap(
    group: Group,
    x: torch.Tensor,
    combine: Callable[[Optional[torch.Tensor], torch.Tensor, int], torch.Tensor],
    init: Optional[torch.Tensor],
) -> Optional[torch.Tensor]:
    """Pipelined all-gather-and-consume that never holds all P chunks.

    ``combine(acc, chunk, src)`` folds rank ``src``'s ``x`` into ``acc``,
    once per rank, starting from ``init`` (which may be None: the first
    call then starts the accumulator).  Live chunks are the one in hand and
    the one in flight: ``|acc| + 2 |x|`` against ``|acc| + P |x|`` for
    gather-then-consume (the paper's Eq. 12).  Hop ``w + 1`` is posted
    before chunk ``w``'s compute.
    """
    P, p = group.size, group.rank
    acc, buf = init, x
    for w in range(P - 1):
        nxt = group.shift_start(buf, 1)  # hop w + 1 in flight
        acc = combine(acc, buf, (p - w) % P)  # buf holds rank (p - w)'s shard
        buf = nxt.wait()
    # the last chunk arrived with the final hop: consume it without another
    return combine(acc, buf, (p + 1) % P)


def ring_reduce_scatter(group: Group, x: torch.Tensor) -> torch.Tensor:
    """Ring reduce-scatter: ``x`` is ``[P, ...]`` on every rank; rank ``p``
    gets ``sum_q x_q[p]``.  Chunk ``c`` starts at rank ``c + 1`` and gathers
    its partial sums around the ring, arriving whole at rank ``c``."""
    P, p = group.size, group.rank
    if x.shape[0] != P:
        raise ValueError(f"ring_reduce_scatter takes [P={P}, ...]; got {tuple(x.shape)}")
    buf = x[(p - 1) % P]
    for w in range(P - 1):
        buf = group.shift(buf, 1)
        # after this hop buf holds the partial sum of chunk (p - w - 2)
        buf = buf + x[(p - w - 2) % P]
    return buf
