"""Collectives that autograd can differentiate, over a :class:`~.group.Group`.

A rank of a tensor-parallel program calls these where GSPMD would insert a
collective in the reference (Megatron's pattern):

* :func:`copy_to` (Megatron's ``f``): identity forward, all-reduce of the
  gradient backward; where a replicated activation enters rank-specific
  compute;
* :func:`reduce_from` (Megatron's ``g``): all-reduce forward, identity
  backward; where partial results become replicated;
* :func:`all_gather_cat`: the blocks of every rank concatenated along a
  dimension forward, the gradient reduce-scattered back to the blocks
  (FSDP's gather of a weight where it is used);
* :func:`all_gather_cat_many`: the same for a layer's weights at once, in
  one all-gather and one reduce-scatter;
* :func:`gather_replicated`: an all-gather whose result every rank goes on
  computing with as the same replicated value, so every rank holds the
  whole gradient and keeps its own part of it (no collective backward);
  :func:`gather_cat_replicated` the same concatenated along a dimension;
* :func:`reduce_scatter` (sequence parallelism's exit): the sum over the
  group, this rank's block of a dimension forward, the gradient
  all-gathered back;
* :func:`split`: this rank's block of a replicated activation forward, the
  blocks' gradients all-gathered back into the replicated one's whole
  gradient;
* :func:`all_to_all` and :func:`shift`: the :class:`~.group.Group`
  collectives with their adjoints (an all-to-all back, a shift the other
  way), for the experts' exchange; :class:`DifferentiableGroup` offers
  them as a ``Group``.

Every rank of a group must call them, forward and backward, in the same
order: identical graphs on every rank give that, since autograd walks a
graph in an order fixed by its structure.  Sums over ranks (the all-reduce,
the reduce-scatter) run in rank order, so every rank gets the same bits.
"""

from __future__ import annotations

import math

import torch

from .group import Group, Work

__all__ = ["copy_to", "reduce_from", "all_gather_cat", "all_gather_cat_many", "gather_replicated",
           "gather_cat_replicated", "reduce_scatter", "split", "all_to_all", "shift",
           "DifferentiableGroup"]


def _solo(group: Group) -> bool:
    return group is None or group.size == 1


def _reduce_scatter(group: Group, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block of ``dim``: the
    blocks go out on one all-to-all and are summed in rank order."""
    chunks = torch.stack(x.chunk(group.size, dim))
    got = group.all_to_all(chunks)
    out = got[0].clone()
    for y in got[1:]:
        out += y
    return out


def _gather_cat(group: Group, x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(list(group.all_gather(x.contiguous()).unbind(0)), dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(g.contiguous()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(group, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.group, g.contiguous(), ctx.dim), None, None


class _AllGatherCatMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, *xs):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [x.shape for x in xs]
        got = group.all_gather(torch.cat([x.reshape(-1) for x in xs]))
        outs, off = [], 0
        for x, d in zip(xs, dims):
            n = x.numel()
            outs.append(torch.cat(list(got[:, off : off + n].unflatten(1, x.shape).unbind(0)), d))
            off += n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        group = ctx.group
        sends = [torch.cat([g.contiguous().chunk(group.size, d)[r].reshape(-1)
                            for g, d in zip(gs, ctx.dims)]) for r in range(group.size)]
        got = group.all_to_all(torch.stack(sends))
        flat = got[0].clone()
        for y in got[1:]:
            flat += y
        sizes = [math.prod(s) for s in ctx.shapes]
        return (None, None, *(f.view(s) for f, s in zip(flat.split(sizes), ctx.shapes)))


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = group.rank
        return group.all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _GatherCatReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(group, x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.group.size, ctx.dim)[ctx.group.rank].contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(group, x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(ctx.group, g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(group.size, dim)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(ctx.group, g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunks, group):
        ctx.group = group
        return group.all_to_all(chunks.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g.contiguous()), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, s):
        ctx.group, ctx.s = group, s
        return group.shift(x.contiguous(), s)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.shift(g.contiguous(), -ctx.s), None, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity; the gradient is summed over ``group``."""
    return x if _solo(group) else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes through."""
    return x if _solo(group) else _ReduceFrom.apply(x, group)


def all_gather_cat(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient is reduce-scattered back."""
    return x if _solo(group) else _AllGatherCat.apply(x, group, dim)


def all_gather_cat_many(xs, dims, group: Group) -> list:
    """:func:`all_gather_cat` of each tensor of ``xs`` along its ``dims``
    entry, in one all-gather (one dtype); the gradients go back in one
    reduce-scatter."""
    if _solo(group):
        return list(xs)
    return list(_AllGatherCatMany.apply(group, tuple(dims), *xs))


def gather_replicated(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` stacked ``[P, ...]``, to be used alike on every
    rank (a replicated activation); the gradient of this rank's ``x`` is its
    part of its own whole gradient."""
    return _GatherReplicated.apply(x, group)


def gather_cat_replicated(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, to be used alike on
    every rank; the gradient of this rank's ``x`` is its block of its own
    whole gradient."""
    return x if _solo(group) else _GatherCatReplicated.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's block of ``dim`` (which
    the group's size must divide); the gradient is all-gathered back."""
    return x if _solo(group) else _ReduceScatter.apply(x, group, dim)


def split(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of ``x``, a replicated activation; the
    blocks' gradients are all-gathered, so every rank holds the whole
    gradient of ``x``."""
    return x if _solo(group) else _Split.apply(x, group, dim)


def all_to_all(chunks: torch.Tensor, group: Group) -> torch.Tensor:
    """``Group.all_to_all``; its gradient goes back on another."""
    return _AllToAll.apply(chunks, group)


def shift(x: torch.Tensor, group: Group, s: int) -> torch.Tensor:
    """``Group.shift`` by ``s``; its gradient shifts by ``-s``."""
    return _Shift.apply(x, group, s)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class DifferentiableGroup(Group):
    """The ``all_to_all`` and shifts of a :class:`Group`, differentiable, for
    code written against the ``Group`` interface (``grouped_exchange``).
    Under ``torch.no_grad``, or on a tensor that needs no gradient, they are
    the wrapped group's (a posted shift overlaps what runs before its
    wait); with a gradient to take, a shift completes when it is posted."""

    def __init__(self, group: Group):
        self.inner = group
        self.rank = group.rank
        self.size = group.size

    def all_to_all(self, chunks):
        return all_to_all(chunks, self.inner) if _needs_grad(chunks) else \
            self.inner.all_to_all(chunks)

    def shift_start(self, x, s):
        if not _needs_grad(x):
            return self.inner.shift_start(x, s)
        out = shift(x, self.inner, s)
        return Work(lambda: out)
