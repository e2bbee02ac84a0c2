"""Frozen copy of the port's coloring draw: Threefry-2x32 keys and ``randint``.

Copied from ``src/repro_torch/core/prng.py`` and
``src/repro_torch/core/count_engine.draw_colorings`` at commit
a494de88284566a21c06859f56eb82c9335cb1f8, so that the benchmark can redraw
the colorings of any call from its key without asking the program.  It is
JAX's default PRNG (``jax_threefry_partitionable=True``, 32-bit mode): a key
is an int64 tensor ``[2]`` of two uint32 words; ``randint`` splits the key
in two, draws 32 bits per element from each and folds the pair into
``[minval, maxval)``.

The draw covers the program's padded vertex axis: a call of ``B``
colorings draws ``[B, n_pad]`` with ``n_pad = pad_to(n + 1, 128)`` (the
port's row layout, ``kernels/ops.py``), and the real vertices read the
first ``n`` columns.  The flat index of every element enters the hash, so
the padding changes which bits a vertex gets and is part of the draw.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the port's vertex padding (``kernels/ops.ROW_BLOCK``)
ROW_BLOCK = 128


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of counter pairs ``(x1, x2)`` under key ``(k1, k2)``:
    twenty rounds in five groups of four, a key injection after each."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` in 32-bit mode: ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def key_data(k: torch.Tensor) -> Tuple[int, ...]:
    return tuple(int(w) for w in torch.as_tensor(k).reshape(-1).tolist())


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the key of call ``data`` of a run keyed by ``k``."""
    k1, k2 = key_data(k)
    d = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    a, b = threefry_2x32(k1, k2, torch.zeros_like(d), d)
    return torch.cat([a, b])


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    n = 1
    for s in shape:
        n *= int(s)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return counts >> 32, counts & _MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[num, 2]`` keys."""
    k1, k2 = key_data(k)
    hi, lo = _iota_2x32((num,), "cpu")
    a, b = threefry_2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def _random_bits32(k: torch.Tensor, shape: Sequence[int], device) -> torch.Tensor:
    k1, k2 = key_data(k)
    hi, lo = _iota_2x32(shape, device)
    a, b = threefry_2x32(k1, k2, hi, lo)
    return a ^ b


def randint(k: torch.Tensor, shape: Sequence[int], minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, dtype=int32)``."""
    span = maxval - minval
    if not 0 < span < 1 << 31:
        raise ValueError(f"randint needs 0 < maxval - minval < 2^31; got [{minval}, {maxval})")
    k_hi, k_lo = split(k)
    higher = _random_bits32(k_hi, shape, device)
    lower = _random_bits32(k_lo, shape, device)
    multiplier = ((1 << 16) % span) ** 2 % span
    offset = ((((higher % span) * multiplier) & _MASK) + lower % span) & _MASK
    return (offset % span + minval).to(torch.int32)


def n_pad(n: int) -> int:
    """The port's padded vertex count: ``n + 1`` rounded up to 128."""
    return -(-(n + 1) // ROW_BLOCK) * ROW_BLOCK


def draw_colorings(call_key: torch.Tensor, n: int, k: int, batch: int, *,
                   device=None) -> torch.Tensor:
    """The ``[batch, n]`` int32 colorings in ``{0..k-1}`` that a call keyed by
    ``call_key`` counts on an ``n``-vertex graph (the padded draw, real
    vertices only)."""
    return randint(call_key, (batch, n_pad(n)), 0, k, device=device)[:, :n]
