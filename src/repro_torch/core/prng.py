"""Threefry-2x32 keys: the slice of ``jax.random`` the counting path uses.

A bit-for-bit copy, in torch integer ops, of JAX's default PRNG as the
reference runs it (``jax_threefry_partitionable=True``, 32-bit mode): the
same key gives the same colorings in both packages, so an estimate of the
port can be held against the reference's sample for sample.

A key is its raw data: an int64 tensor ``[2]`` holding two uint32 words
(``jax.random.key_data`` of the reference's key).  Words are carried in
int64 and masked to 32 bits after every add and shift, because torch's
uint32 support is thin.  Keys are tiny and live on the CPU; ``randint``
computes its bits on the device it is asked for.

What is copied (``jax/_src/prng.py`` and ``jax/_src/random.py``):

* ``key(seed)``: ``threefry_seed`` in 32-bit mode, ``[0, seed mod 2^32]``;
* ``fold_in(key, data)``: ``threefry_2x32(key, [0, data])``;
* ``split(key, num)``: the fold-like split, hashing the counters
  ``(hi, lo)`` of ``0..num-1``;
* ``randint(key, shape, minval, maxval)``: split the key in two, draw 32
  random bits per element from each (``bits1 ^ bits2`` of the hash of the
  element's flat index), and fold the pair into ``[minval, maxval)`` with
  the reference's double-width remainder;
* ``uniform(key, shape, minval, maxval)``: 32 random bits per element from
  the key itself (no split), the top 23 as the mantissa of a float32 in
  ``[1, 2)``, minus 1, scaled and shifted into ``[minval, maxval)`` and
  clamped below at ``minval``: the training data stream's draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

__all__ = ["key", "PRNGKey", "key_data", "fold_in", "split", "randint", "randint_keys",
           "uniform", "threefry_2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = torch.Tensor


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter pairs ``(x1, x2)`` under key ``(k1, k2)``.

    ``k1``/``k2`` are Python ints or int64 tensors that broadcast against
    the counters; all values are uint32 words held in int64.  Twenty rounds
    in five groups of four, with a key injection after each group, as
    ``jax._src.prng._threefry2x32_lowering``.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def key(seed: int) -> Key:
    """The key of an integer seed, as ``jax.random.key(seed)`` (32-bit mode:
    the seed is taken modulo 2^32 and the high word is 0)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


#: the legacy name; keys are raw data either way
PRNGKey = key


def key_data(k: Key) -> Tuple[int, ...]:
    """The key's uint32 words as Python ints."""
    return tuple(int(w) for w in torch.as_tensor(k).reshape(-1).tolist())


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: a new key from ``k`` and a 32-bit integer."""
    k1, k2 = key_data(k)
    d = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    a, b = threefry_2x32(k1, k2, torch.zeros_like(d), d)
    return torch.cat([a, b])


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The high and low words of every element's flat index, row-major."""
    n = 1
    for s in shape:
        n *= int(s)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return counts >> 32, counts & _MASK


def split(k: Key, num: Union[int, Sequence[int]] = 2) -> Key:
    """``jax.random.split``: ``[*num, 2]`` new keys."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    k1, k2 = key_data(k)
    hi, lo = _iota_2x32(shape, "cpu")
    a, b = threefry_2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def _random_bits32(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    k1, k2 = key_data(k)
    hi, lo = _iota_2x32(shape, device)
    a, b = threefry_2x32(k1, k2, hi, lo)
    return a ^ b


def _check_span(minval: int, maxval: int) -> None:
    if not 0 < maxval - minval < 1 << 31:
        raise ValueError(f"randint needs 0 < maxval - minval < 2^31; got [{minval}, {maxval})")


def _randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int, maxval: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """Fold two 32-bit draws into ``[minval, maxval)`` with the reference's
    double-width remainder."""
    span = maxval - minval
    multiplier = ((1 << 16) % span) ** 2 % span
    # uint32 arithmetic with wrap-around, as the reference computes it
    offset = ((((higher % span) * multiplier) & _MASK) + lower % span) & _MASK
    offset = offset % span
    return (offset + minval).to(dtype)


def randint(
    k: Key,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    *,
    dtype: torch.dtype = torch.int32,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, dtype=int32)`` on ``device``.

    Integers uniform in ``[minval, maxval)`` (with the reference's small
    modulo bias when the span is not a power of two), computed in int64 on
    ``device`` and returned as ``dtype``.
    """
    _check_span(minval, maxval)
    k_hi, k_lo = split(k)
    higher = _random_bits32(k_hi, shape, device)
    lower = _random_bits32(k_lo, shape, device)
    return _randint_from_bits(higher, lower, minval, maxval, dtype)


def randint_keys(
    keys: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    *,
    dtype: torch.dtype = torch.int32,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """``randint`` of each key of ``keys`` (``[K, 2]``, as :func:`split`
    returns them) at once: ``[K, *shape]``, row ``i`` bit for bit
    ``randint(keys[i], shape, ...)``, in one pass of tensor ops instead of K."""
    _check_span(minval, maxval)
    kd = torch.as_tensor(keys).reshape(-1, 2).to(device=device, dtype=torch.int64)
    lead = (-1,) + (1,) * len(tuple(shape))
    # split(key, 2): the counters (0, 0) and (0, 1)
    zero = torch.zeros(2, dtype=torch.int64, device=kd.device)
    a, b = threefry_2x32(kd[:, :1], kd[:, 1:], zero, torch.arange(2, device=kd.device))
    hi, lo = _iota_2x32(shape, kd.device)

    def bits(w1, w2):
        x, y = threefry_2x32(w1.reshape(lead), w2.reshape(lead), hi, lo)
        return x ^ y

    return _randint_from_bits(bits(a[:, 0], b[:, 0]), bits(a[:, 1], b[:, 1]), minval, maxval,
                              dtype)


def uniform(
    k: Key,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` on ``device``.

    As the reference computes it: ``bits >> 9 | 0x3F800000`` bitcast to a
    float32 in ``[1, 2)``, minus 1, times ``maxval - minval`` (both bounds
    rounded to float32 first), plus ``minval``, then ``max(minval, .)``.
    XLA fuses the multiply and the add into one FMA, rounded once; here
    they run in float64, where the product of two 24-bit significands and
    the sum stay exact for ``[0, 1)``-scale bounds, and the one rounding is
    the cast back to float32.
    """
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    bits = _random_bits32(k, shape, device)
    words = (bits >> 9) | 0x3F800000  # < 2^31: an int32 holds it as is
    floats = words.to(torch.int32).view(torch.float32) - 1.0
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)
