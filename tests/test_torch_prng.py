"""The port's threefry keys against ``jax.random``, bit for bit: the same key
data, the same ``fold_in`` and ``split``, the same ``randint`` draws, and so
the same colorings in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 7, 2**31 + 5]


def _words(key):
    return tuple(int(w) for w in jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    assert prng.key_data(prng.key(seed)) == _words(jax.random.key(seed))
    assert prng.key_data(prng.PRNGKey(seed)) == tuple(int(w) for w in jax.random.PRNGKey(seed))
    for data in (0, 1, 12345, 2**32 - 1):
        assert prng.key_data(prng.fold_in(prng.key(seed), data)) == \
            _words(jax.random.fold_in(jax.random.key(seed), data))
    for num in (2, 5, (2, 3)):
        want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), num)))
        np.testing.assert_array_equal(prng.split(prng.key(seed), num).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1, 5), (4, 384), (3, 1000)])
def test_randint(seed, shape):
    key = prng.key(seed)
    jkey = jax.random.key(seed)
    for k in range(3, 16):
        want = np.asarray(jax.random.randint(jkey, shape, 0, k, dtype=jnp.int32))
        got = prng.randint(key, shape, 0, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_after_fold_in_and_offset_range():
    key = prng.fold_in(prng.key(3), 2)
    jkey = jax.random.fold_in(jax.random.key(3), 2)
    for lo, hi in [(0, 2), (5, 12), (-3, 4), (0, 1000)]:
        np.testing.assert_array_equal(
            prng.randint(key, (2, 300), lo, hi).numpy(),
            np.asarray(jax.random.randint(jkey, (2, 300), lo, hi, dtype=jnp.int32)))
    with pytest.raises(ValueError):
        prng.randint(key, (3,), 4, 4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(97,), (2, 300)])
def test_randint_keys(seed, shape):
    """Many keys at once == each key's randint == jax.random.randint of each
    split key (the distributed backend's keyed colorings)."""
    keys = prng.split(prng.key(seed), 5)
    jkeys = jax.random.split(jax.random.key(seed), 5)
    got = prng.randint_keys(keys, shape, 0, 11)
    assert got.shape == (5,) + shape and got.dtype == torch.int32
    for i in range(5):
        assert torch.equal(got[i], prng.randint(keys[i], shape, 0, 11))
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax.random.randint(jkeys[i], shape, 0, 11, dtype=jnp.int32)))
    with pytest.raises(ValueError):
        prng.randint_keys(keys, shape, 2, 2)


def test_threefry_known_answer():
    """Threefry-2x32's published test vector (Salmon et al., 20 rounds)."""
    x = prng.threefry_2x32(0x13198A2E, 0x03707344, torch.tensor([0x243F6A88]),
                           torch.tensor([0x85A308D3]))
    assert (int(x[0]), int(x[1])) == (0xC4923A9C, 0x483DF7A0)
