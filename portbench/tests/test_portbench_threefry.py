"""The frozen coloring draw against the port's, bit for bit."""

import types

import pytest
import torch

from portbench import harness
from portbench.frozen import threefry
from repro_torch.core import count_engine, prng
from repro_torch.kernels import ops


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31 + 12345, 2**32 + 5])
def test_keys_match_the_port(seed):
    base = harness.base_key(seed)
    want = prng.key(seed & 0xFFFFFFFF)
    if seed >> 32:
        want = prng.fold_in(want, seed >> 32)
    assert torch.equal(base, want)
    for i in (0, 1, 17, 2**31 + 3):
        assert torch.equal(threefry.fold_in(base, i), prng.fold_in(base, i))


@pytest.mark.parametrize("n,k,batch", [(1, 3, 1), (300, 12, 4), (1000, 10, 8), (127, 5, 2)])
def test_draw_matches_draw_colorings(n, k, batch):
    n_pad = ops.pad_to(n + 1, ops.ROW_BLOCK)
    assert threefry.n_pad(n) == n_pad
    plan = types.SimpleNamespace(n_pad=n_pad, k=k, device=torch.device("cpu"))
    for i in range(3):
        key = threefry.fold_in(harness.base_key(2**31 + 99), i)
        want = count_engine.draw_colorings(plan, batch, key)[:, :n]
        got = threefry.draw_colorings(key, n, k, batch, device="cpu")
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)
