"""Grouped direct-send exchange over a :class:`~.group.Group`: the paper's
Algorithm 3 / Figure 2.

Counterpart of ``repro/comm/pipelined.py``.  The all-to-all among P ranks
is cut into W steps: at step ``w`` rank ``p`` sends its chunk for ``p + w``
and receives the chunk rank ``p - w`` addressed to it.  With group factor
``g`` (the paper's communication group ``m = g + 1``) each step posts ``g``
shifts, so ``W = ceil((P - 1) / g)`` and at most ``g`` received chunks are
in flight.  Step ``w + 1``'s shifts are posted before step ``w``'s chunks
are consumed, so the transfer runs under the compute; the cold-start
stage consumes the rank's own chunk.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .group import Group

__all__ = ["grouped_exchange", "fused_exchange"]

#: a rank's outgoing chunks: ``[P, ...]`` (``chunks[q]`` for rank ``q``), or a
#: function of ``q`` that makes chunk ``q`` when it is sent
Chunks = Union[torch.Tensor, Callable[[int], torch.Tensor]]
Consume = Callable[[Optional[torch.Tensor], torch.Tensor, int], torch.Tensor]


def _chunk(chunks: Chunks, q: int) -> torch.Tensor:
    return chunks(q) if callable(chunks) else chunks[q]


def fused_exchange(group: Group, chunks: torch.Tensor, consume: Consume,
                   init: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """One all-to-all, then consume: the paper's Naive mode.  All P received
    chunks exist before the compute starts (the peak-memory pathology the
    pipeline removes, kept for the baseline).  ``consume(acc, chunk, src)``
    folds the chunk received from ``src``, in rank order."""
    received = group.all_to_all(chunks)
    acc = init
    for q in range(group.size):
        acc = consume(acc, received[q], q)
    return acc


def grouped_exchange(group: Group, chunks: Chunks, consume: Consume,
                     init: Optional[torch.Tensor], *, group_factor: int = 1,
                     include_local: bool = True) -> Optional[torch.Tensor]:
    """Pipelined Adaptive-Group exchange (Algorithm 3, large-|T| arm).

    ``chunks[q]`` (or ``chunks(q)``) is this rank's payload for rank ``q``;
    with ``include_local`` its own chunk is consumed at the cold start.
    ``consume(acc, chunk, src)`` folds the chunk from ``src``, starting from
    ``init`` (None lets the first call start the accumulator).  Received
    chunks in memory: ``group_factor``, not P (Eq. 12); each group's
    transfers run under the previous group's consumes (Eq. 13/14).  The
    order of consumes is the reference's.
    """
    P, p = group.size, group.rank
    g = max(1, min(group_factor, P - 1))
    acc = init
    pending = [(_chunk(chunks, p), p)] if include_local else []
    for w0 in range(1, P, g):
        # post this step's g shifts, then consume the previous step's chunks
        arrived = [(group.shift_start(_chunk(chunks, (p + s) % P), s), (p - s) % P)
                   for s in range(w0, min(w0 + g, P))]
        for chunk, src in pending:
            acc = consume(acc, chunk, src)
        pending = [(work.wait(), src) for work, src in arrived]
    for chunk, src in pending:
        acc = consume(acc, chunk, src)
    return acc
