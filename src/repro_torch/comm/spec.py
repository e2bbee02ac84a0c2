"""Partition specs: which mesh axes split each dimension of a tensor.

The port's counterpart of ``jax.sharding.PartitionSpec``.  A spec holds,
for each dimension, ``None`` (whole on every rank), an axis name, or a
tuple of axis names (the dimension split over their product, the first
axis major).  A rank holds the contiguous block of each split dimension
that its coordinates on those axes select, as a ``NamedSharding`` places
it.  An axis the mesh does not have splits nothing (the reference's
``batch_axes`` default ``("pod", "data")`` on a mesh without ``pod``).

* :func:`local_shape` is the shape of a rank's block;
* :func:`shard_of` cuts a rank's block out of the whole tensor;
* :func:`gather_whole` is the inverse, a collective: every rank of the
  mesh calls it with its block and gets the whole tensor.

A dimension that does not divide its axes raises.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import torch

from .group import Group

__all__ = ["PartitionSpec", "Placement", "axes_of", "used_axes", "local_shape", "shard_of",
           "gather_whole"]


class PartitionSpec(tuple):
    """A tuple with one entry per dimension: ``None``, an axis name, or a
    tuple of axis names (a tuple of one name is that name, as JAX's
    ``PartitionSpec`` reads it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


def axes_of(part) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def used_axes(spec: Sequence) -> set:
    """Every axis a spec names."""
    return {a for part in spec for a in axes_of(part)}


def _split(part, sizes: Mapping[str, int], index: Mapping[str, int]) -> Tuple[int, int]:
    """``(blocks, this rank's block)`` of a dimension under spec entry ``part``."""
    k, j = 1, 0
    for a in axes_of(part):
        s = sizes.get(a, 1)
        k, j = k * s, j * s + (index.get(a, 0) if s > 1 else 0)
    return k, j


def _block(n: int, k: int, dim: int) -> int:
    if n % k:
        raise ValueError(f"dimension {dim} of size {n} does not split into {k} blocks")
    return n // k


def local_shape(shape: Sequence[int], spec: Sequence, sizes: Mapping[str, int]
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    return tuple(_block(n, _split(spec[d] if d < len(spec) else None, sizes, {})[0], d)
                 for d, n in enumerate(shape))


def shard_of(x: torch.Tensor, spec: Sequence, sizes: Mapping[str, int],
             index: Mapping[str, int]) -> torch.Tensor:
    """The block of ``x`` at mesh coordinates ``index`` (axis -> rank on it,
    ``sizes`` axis -> size): a view (the caller clones it to let ``x``
    go)."""
    for d in range(x.dim()):
        k, j = _split(spec[d] if d < len(spec) else None, sizes, index)
        if k > 1:
            b = _block(x.shape[d], k, d)
            x = x.narrow(d, j * b, b)
    return x


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one rank's block of a tensor lies: a spec, the mesh's axis
    sizes and the rank's coordinates (the port's ``NamedSharding``)."""

    spec: Tuple
    sizes: Mapping[str, int]
    index: Mapping[str, int]

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of the whole ``x`` (a view)."""
        return shard_of(x, self.spec, self.sizes, self.index)


def gather_whole(x: torch.Tensor, spec: Sequence, groups: Mapping[str, Group]) -> torch.Tensor:
    """The whole tensor from this rank's block ``x`` (a collective over
    ``groups``, axis name -> this rank's group on that axis; every rank of
    each group calls it in the same order)."""
    for d in range(x.dim()):
        part = spec[d] if d < len(spec) else None
        for a in reversed(axes_of(part)):  # the minor axis first
            g = groups.get(a)
            if g is not None and g.size > 1:
                x = torch.cat(list(g.all_gather(x.contiguous()).unbind(0)), d)
    return x
