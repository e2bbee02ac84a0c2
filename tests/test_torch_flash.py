"""The port's flash-attention plain version against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and its XLA
oracle, on the same numpy inputs.

Float32 agrees to rtol = atol = 2e-4 and bf16 to 5e-2, the reference
test's own tolerances (the two sum in other orders; bf16 inputs round the
products' inputs, not the float32 sums).  The CUDA kernel is held against
the plain version on the card in test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention


def _qkv(seed, b, hq, hkv, lq, d, lk=None):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    out = ref.flash_attention_ref(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize(
    "b,hq,hkv,l,d", [(1, 4, 4, 256, 64), (2, 8, 2, 128, 64), (1, 6, 2, 384, 128)]
)
def test_causal_matches_pallas(b, hq, hkv, l, d):
    q, k, v = _qkv(0, b, hq, hkv, l, d)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=True, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, causal=True), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [64, 128, 200])
def test_sliding_window_matches_pallas(window):
    q, k, v = _qkv(1, 1, 2, 2, 256, 64)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                                  interpret=True)
    got = _port(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_bidirectional_matches_pallas():
    q, k, v = _qkv(2, 1, 4, 2, 128, 64)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=False, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, causal=False), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_bf16_matches_pallas():
    q, k, v = _qkv(2, 1, 2, 2, 128, 64)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    got = _port(q, k, v, torch.bfloat16, causal=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37), (False, 0), (False, 50)])
def test_ragged_length_matches_xla_oracle(causal, window):
    """L = 200 (the Pallas kernel asserts L % 128 == 0): the reference's XLA
    oracle, which masks with -inf and zeroes the NaNs of empty rows."""
    q, k, v = _qkv(3, 2, 6, 3, 200, 64)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    got = _port(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("lq,lk", [(5, 40), (12, 8)])
def test_end_aligned_queries_and_empty_rows(lq, lk):
    """Queries align to the end of the keys; with Lq > Lk the first causal
    rows see no key, and the zero-denominator guard gives them 0."""
    q, k, v = _qkv(4, 1, 4, 2, lq, 16, lk=lk)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=True))
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if lq > lk:
        assert not got[:, :, : lq - lk].any()


def test_plain_version_chunks_query_rows(monkeypatch):
    """Chunking over query rows (to bound the logits on the card) changes nothing."""
    q, k, v = _qkv(5, 1, 4, 2, 96, 32)
    whole = _port(q, k, v, causal=True, window=40)
    monkeypatch.setattr(ref, "ELEMENT_BUDGET", 2 * 96 * 7)  # 7 query rows a chunk
    np.testing.assert_array_equal(_port(q, k, v, causal=True, window=40), whole)


def test_ops_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 4, 2, 64, 64))
    flash_attention.launches = 0
    got = ops.flash_attention(q, k, v, causal=True, window=0)
    assert flash_attention.launches == 0
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("shapes", [
    ((1, 4, 8, 64), (1, 3, 8, 64), (1, 3, 8, 64)),  # heads do not group
    ((1, 4, 8, 64), (1, 2, 8, 32), (1, 2, 8, 32)),  # head dims differ
    ((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 9, 64)),  # k and v differ
    ((4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64)),  # q is not 4-D
])
def test_wrapper_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError):
        flash_attention(*(torch.zeros(s) for s in shapes))
