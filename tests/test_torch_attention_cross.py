"""Cross-attention and the chunked attention path, and the flash kernels at
head dim 256, against the JAX package.

* ``chunked_attention`` against the reference's XLA ``chunked_attention``
  (the same numpy inputs) over causal, sliding-window, bidirectional and
  cross (``Lq != Lk``) masks, ragged lengths and fully masked rows, float32
  within rtol = atol = 1e-4;
* ``attention_block`` with a context against the reference's (keys and
  values from the context, no rope, no mask), float32 1e-4 and bf16 2e-2;
* the flash plain version at D = 256 against ``flash_attention_pallas`` in
  interpret mode (2e-4, the reference test's tolerance), and the bf16
  kernel's host-side geometry at D = 256 and GQA group 10 (recurrentgemma's
  local attention) against a brute-force mask; the work count the flash
  bound reads, at recurrentgemma's prefill launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, work
from repro_torch.models import attention
from repro_torch.models.layers import Dense


def _qkv(seed, b, hq, hkv, lq, d, lk=None):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


@pytest.mark.parametrize("lq,lk,causal,window,chunk", [
    (96, 96, True, 0, 32),  # causal, whole chunks
    (100, 100, True, 24, 32),  # window, ragged
    (77, 77, False, 0, 32),  # bidirectional, ragged
    (40, 150, False, 0, 64),  # cross: Lq < Lk, ragged keys
    (130, 40, False, 0, 64),  # cross: Lq > Lk
    (50, 20, True, 0, 16),  # end-aligned causal: the first 30 rows see no key
    (64, 64, True, 1, 1024),  # window 1: one key a row; one chunk
])
def test_chunked_attention_matches_reference(lq, lk, causal, window, chunk):
    q, k, v = _qkv(0, 2, 4, 2, lq, 16, lk)
    want = ref_attention.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                           window=window, q_chunk=chunk, kv_chunk=chunk)
    got = attention.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                      window=window, q_chunk=chunk, kv_chunk=chunk)
    assert got.shape == (2, 4, lq, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if lq > lk and causal:
        assert not got[:, :, : lq - lk].any()  # fully masked rows give 0


def test_chunked_attention_equals_the_flash_plain_version():
    """Both are the same function: chunked over queries and keys, or not."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 6, 3, 90, 32, 120))
    for causal, window in ((True, 0), (True, 17), (False, 0)):
        a = attention.chunked_attention(q, k, v, causal=causal, window=window, q_chunk=32,
                                        kv_chunk=48)
        b = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,jdt,tol", [(torch.float32, jnp.float32, 1e-4),
                                           (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_cross_attention_block_matches_reference(dtype, jdt, tol):
    """The vision row's cross-attention: queries from the tokens, keys and
    values from the context (biases drawn nonzero), no rope."""
    name = "llama-3.2-vision-90b"
    rcfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    rparams = ref_build_model(rcfg).init_fn(jax.random.key(2))
    rng = np.random.default_rng(3)
    rp = {k: dict(w=np.asarray(v["w"][0]), b=(rng.standard_normal(v["w"].shape[-1]) * 0.5
                                               ).astype(np.float32))
          for k, v in rparams["groups"]["pos4"]["xattn"].items()}
    rp["wo"].pop("b")
    x = (rng.standard_normal((2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    ctx = (rng.standard_normal((2, 8, cfg.d_model)) * 0.5).astype(np.float32)
    want, cache = ref_attention.attention_block(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in rp.items()},
        jnp.asarray(x, jdt), rcfg, context=jnp.asarray(ctx, jdt), dtype=jdt)
    assert cache is None
    p = attention.Attention(*(Dense(torch.from_numpy(rp[n]["w"]),
                                    torch.from_numpy(rp[n]["b"]) if "b" in rp[n] else None)
                              for n in ("wq", "wk", "wv", "wo")))
    got, none = attention.attention_block(p, torch.from_numpy(x).to(dtype), cfg,
                                          context=torch.from_numpy(ctx).to(dtype), dtype=dtype)
    assert none is None and got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv,l,causal,window", [
    (10, 1, 256, True, 128),  # recurrentgemma's local attention: group 10, window
    (4, 2, 128, False, 0),  # bidirectional
])
def test_flash_plain_at_d256_matches_pallas(hq, hkv, l, causal, window):
    q, k, v = _qkv(4, 1, hq, hkv, l, 256)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                                  interpret=True)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_the_kernels_take_head_dim_256():
    """D = 256 joins the kernels' head dims, with 64-key KV tiles; on the CPU
    the wrapper runs the plain version at any D (the card's refusal of other
    head dims is tests/test_torch_gpu.py's)."""
    assert fa.HEAD_DIMS == (64, 128, 256)
    assert fa.kv_tile(256) == 64 and fa.kv_tile(128) == fa.kv_tile(64) == fa.TILE
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 10, 1, 8, 256))
    torch.testing.assert_close(fa.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


def _allowed(length, causal, window, block_n):
    n = -(-length // block_n) * block_n
    r = np.arange(length)[:, None]
    c = np.arange(n)[None, :]
    ok = (c < length) & (r >= 0)
    if causal:
        ok = ok & (c <= r)
    if window > 0:
        ok = ok & (c > r - window)
    return ok


@pytest.mark.parametrize("length", [1, 64, 127, 1000, 4096])
@pytest.mark.parametrize("causal,window", [(True, 2048), (True, 0), (False, 0), (True, 100)])
def test_kv_tiles_and_masks_at_d256(causal, window, length):
    """At D = 256 a 128-row query tile visits 64-key KV tiles: exactly those
    where one of its rows may attend a key, in order, and skips the mask code
    exactly where every (row < L, key) pair is allowed."""
    bn = fa.kv_tile(256)
    ok = _allowed(length, causal, window, bn)
    for qt in range(fa.query_tiles(length)):
        rows = ok[qt * fa.TILE : (qt + 1) * fa.TILE]
        want = [kt for kt in range(ok.shape[1] // bn) if rows[:, kt * bn : (kt + 1) * bn].any()]
        got = fa.kv_tiles(qt, length, causal, window, bn)
        assert list(got) == want, (qt, list(got), want)
        for kt in got:
            masked = not rows[:, kt * bn : (kt + 1) * bn].all()
            assert fa.tile_needs_mask(qt, kt, length, causal, window, bn) == masked, (qt, kt)


@pytest.mark.parametrize("length", [1, 1000, 4096])
def test_grid_and_tensor_maps_at_d256_group_10(length):
    """recurrentgemma's launch: B = 2, Hq = 10, Hkv = 1.  The grid covers
    every query row once; Q's map has 128-row boxes and K's and V's 64-row
    ones, four 64-column boxes across D, strides where torch has them."""
    b, hq, hkv, d = 2, 10, 1, 256
    grid = fa.launch_grid(b, hq, length)
    assert grid[:2] == (hq, b) and (grid[2] - 1) * fa.TILE < length <= grid[2] * fa.TILE
    for heads, rows in ((b * hq, fa.TILE), (b * hkv, fa.kv_tile(d))):
        d0, d1, d2, s1, s2, box0, box1, box2 = fa.tensor_map_geometry(heads, length, d, rows)
        assert (d0, d1, d2) == (d, length, heads) and (box1, box2) == (rows, 1)
        assert box0 * 2 == 128 and d // box0 == 4
        strides = torch.empty(b, heads // b, length, d, dtype=torch.bfloat16).stride()
        assert (s1, s2) == (2 * strides[2], 2 * strides[1])


def test_flash_work_at_recurrentgemma_prefill():
    """The bound's work at recurrentgemma's local-attention launch (B = 2,
    Hq = 10, Hkv = 1, L = 4096, D = 256, causal, window 2048): the allowed
    pairs counted row by row, 4 D flops each, q, k, v and o moved once."""
    l, w = 4096, 2048
    pairs = sum(min(i + 1, w) for i in range(l))
    assert work.attention_pairs(l, True, w) == pairs == 2048 * 2049 // 2 + 2048 * 2048
    got = work.flash_attention(2, 10, 1, l, 256, 2, True, w)
    assert got.bf16_flops == 4 * 2 * 10 * pairs * 256
    assert got.bytes == (2 * 2 * 10 * l * 256 + 2 * 2 * 1 * l * 256) * 2
