"""The port's flash-attention plain version against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and its XLA
oracle, on the same numpy inputs; the bf16 kernel's host-side tile
arithmetic against a brute-force mask; and a torch emulation of the bf16
kernel's numerics against the plain version and the Pallas kernel.

Float32 agrees to rtol = atol = 2e-4 and bf16 to 5e-2, the reference
test's own tolerances (the two sum in other orders; bf16 inputs round the
products' inputs, not the float32 sums).  The emulation is held to the gate
the card holds the kernel to (chip_smoke.py, test_torch_gpu.py): within one
bf16 step of the plain version's float32 result rounded, plus 1e-6.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.testing.numerics import bf16_excess, bf16_ulp


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


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    """The plain version is taken because a tensor lies on the CPU, never as
    a fallback: a ``meta`` tensor (the dry-run's) runs neither it nor a
    kernel, records the launch a CUDA tensor would make and returns a
    ``meta`` output, and holds the kernels' contract as a CUDA tensor does."""
    from repro_torch.kernels import work

    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    launched = flash_attention.launches
    with work.LaunchLog() as log:
        out = flash_attention(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    assert log.counts() == {"flash_attention": 1}
    assert log.work() == work.flash_attention(1, 4, 2, 128, 64, 2, True, 0)
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), v.half())
    assert flash_attention.launches == launched


@pytest.mark.parametrize("shapes", [
    ((1, 4, 8, 64), (1, 3, 8, 64), (1, 3, 8, 64)),  # heads do not group
    ((1, 4, 8, 64), (1, 2, 8, 32), (1, 2, 8, 32)),  # head dims differ
    ((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 9, 64)),  # k and v differ
    ((4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64)),  # q is not 4-D
])
def test_wrapper_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError):
        flash_attention(*(torch.zeros(s) for s in shapes))


# ---------------------------------------------------------------------------
# the bf16 kernel's host-side arithmetic and its numerics
# ---------------------------------------------------------------------------

MASKS = [(True, 0), (True, 100), (True, 1024), (False, 0), (False, 300)]
LENGTHS = [1, 129, 1000, 4097]


def _allowed(length, causal, window):
    """Brute force: ``[rows, keys]`` of the query rows < length against keys
    padded to whole tiles (keys past ``length`` masked)."""
    n = fa.query_tiles(length) * fa.TILE
    r = np.arange(length)[:, None]
    c = np.arange(n)[None, :]
    ok = (c < length) & (r >= 0)
    if causal:
        ok = ok & (c <= r)
    if window > 0:
        ok = ok & (c > r - window)
    return ok


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_kv_tiles_and_masks_match_brute_force(causal, window, length):
    """A query tile visits exactly the KV tiles where one of its rows may
    attend a key, in ascending order, and skips the mask code exactly where
    every (row < L, key) pair of the two tiles is allowed."""
    ok = _allowed(length, causal, window)
    t = fa.TILE
    nt = fa.query_tiles(length)
    for qt in range(nt):
        rows = ok[qt * t : (qt + 1) * t]
        want = [kt for kt in range(nt) if rows[:, kt * t : (kt + 1) * t].any()]
        got = fa.kv_tiles(qt, length, causal, window)
        assert list(got) == want, (qt, list(got), want)
        for kt in got:
            masked = not rows[:, kt * t : (kt + 1) * t].all()
            assert fa.tile_needs_mask(qt, kt, length, causal, window) == masked, (qt, kt)


# ---------------------------------------------------------------------------
# the float32 kernel's host-side geometry (csrc/flash_attention.cu's Geo<D>)
# ---------------------------------------------------------------------------

FP32_LENGTHS = [1, 65, 129, 1000, 4097]


@pytest.mark.parametrize("length", FP32_LENGTHS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fp32_tiles_masks_and_grid_match_brute_force(d, causal, window, length):
    """The float32 kernel's grid covers every query row once, a query tile
    of ``rows`` rows visits exactly the 64-key tiles where one of its rows
    may attend a key, in ascending order, and runs the mask code exactly
    where some (row < L, key) pair of the two tiles is masked."""
    g = fa.fp32_geometry(d)
    b, hq = 2, 3
    grid = fa.fp32_launch_grid(b, hq, length, d)
    assert grid[:2] == (hq, b)
    assert (grid[2] - 1) * g.rows < length <= grid[2] * g.rows
    nk = -(-length // g.keys)
    r = np.arange(length)[:, None]
    c = np.arange(nk * g.keys)[None, :]
    ok = (c < length) & (r >= 0)
    if causal:
        ok = ok & (c <= r)
    if window > 0:
        ok = ok & (c > r - window)
    for qt in range(grid[2]):
        rows = ok[qt * g.rows : (qt + 1) * g.rows]
        want = [kt for kt in range(nk) if rows[:, kt * g.keys : (kt + 1) * g.keys].any()]
        got = fa.fp32_kv_tiles(qt, length, causal, window, d)
        assert list(got) == want, (qt, list(got), want)
        for kt in got:
            masked = not rows[:, kt * g.keys : (kt + 1) * g.keys].all()
            assert fa.fp32_tile_needs_mask(qt, kt, length, causal, window, d) == masked, (qt, kt)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fp32_geometry_fits_a_cta(d):
    """Q, a ring of at least two 64-key slots (rows padded by 16 bytes) and
    each warp's block of P fit the 232,448 bytes a CTA may opt into; the
    lanes' tiles cover the CTA's rows, a KV tile's keys and D's columns."""
    g = fa.fp32_geometry(d)
    warps, pitch = g.threads // 32, 4 * (d + 4)
    assert g.smem_bytes == (g.rows * pitch + g.stages * g.keys * pitch
                            + warps * g.keys * 2 * g.lane_rows * 4)
    assert g.smem_bytes <= fa.MAX_SMEM and g.stages >= 2
    assert g.smem_bytes + g.keys * pitch > fa.MAX_SMEM or g.stages == 4  # as many as fit
    assert g.rows == warps * 2 * g.lane_rows  # two row groups of lane_rows a warp
    assert g.keys == 16 * 4  # a row group's 16 lanes, 4 keys each
    assert (g.rows, g.stages, g.lane_rows) == {64: (128, 4, 8), 128: (128, 3, 8),
                                               256: (64, 2, 4)}[d]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("length", LENGTHS)
def test_grid_and_tensor_maps(length, d):
    """The grid covers every query row once; each tensor map addresses
    element (bh, l, d) of a contiguous [B, H, L, D] bf16 tensor where torch
    does, its box is one 128-byte swizzle row wide and ``TILE`` rows tall,
    and D is a whole number of boxes."""
    b, hq = 3, 4
    grid = fa.launch_grid(b, hq, length)
    assert grid[:2] == (hq, b)
    assert (grid[2] - 1) * fa.TILE < length <= grid[2] * fa.TILE
    dims = fa.tensor_map_geometry(b * hq, length, d)
    (d0, d1, d2, s1, s2, box0, box1, box2) = dims
    assert (d0, d1, d2) == (d, length, b * hq) and (box1, box2) == (fa.TILE, 1)
    assert box0 * 2 == 128 and d % box0 == 0
    strides = torch.empty(b, hq, length, d, dtype=torch.bfloat16).stride()
    assert (s1, s2) == (2 * strides[2], 2 * strides[1]) and strides[3] == 1
    assert s1 % 16 == 0 and s2 % 16 == 0  # TMA's stride alignment


def _truncate_bf16(x):
    """x truncated toward zero to bf16 (its high 16 bits), as float32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _emulate(q, k, v, *, causal=True, window=0, terms=3, nearest=False):
    """The bf16 kernel's numerics in torch: 128-row query tiles over the KV
    tiles ``kv_tiles`` visits, float32 logits scaled in base 2, an online
    softmax with the finite -1e30 mask, P split into ``terms`` bf16 terms
    (each the bf16 truncation of what the terms before it leave; rounded to
    nearest with ``nearest``) that each go through P.V with float32
    accumulation, l summed from the float32 P, and acc / l rounded to bf16."""
    b, hq, length, d = q.shape
    g = hq // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, 1) for x in (k, v))
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                    dtype=torch.float32)
    pos = torch.arange(length)
    out = torch.empty_like(qf)
    for qt in range(fa.query_tiles(length)):
        r = slice(qt * fa.TILE, min((qt + 1) * fa.TILE, length))
        m = torch.full((b, hq, r.stop - r.start), ref.NEG)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hq, r.stop - r.start, d)
        for kt in fa.kv_tiles(qt, length, causal, window):
            kk = slice(kt * fa.TILE, min((kt + 1) * fa.TILE, length))
            t = (qf[:, :, r] @ kf[:, :, kk].transpose(-1, -2)) * c
            mask = torch.ones(r.stop - r.start, kk.stop - kk.start, dtype=torch.bool)
            if causal:
                mask &= pos[kk][None] <= pos[r][:, None]
            if window > 0:
                mask &= pos[kk][None] > pos[r][:, None] - window
            t = torch.where(mask, t, ref.NEG)
            m_new = torch.maximum(m, t.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(mask, torch.exp2(t - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            m = m_new
            rest = p
            for _ in range(terms):
                part = rest.bfloat16().float() if nearest else _truncate_bf16(rest)
                acc = acc + part @ vf[:, :, kk]
                rest = rest - part
        out[:, :, r] = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype)


def _bf16(*xs):
    return [torch.from_numpy(x).bfloat16() for x in xs]


@pytest.mark.parametrize("b,hq,hkv,l,d,causal,window", [
    (1, 8, 2, 1000, 128, True, 0),  # ragged L, GQA group 4
    (2, 4, 4, 384, 64, True, 0),  # group 1
    (1, 8, 1, 512, 128, False, 0),  # group 8, bidirectional
    (1, 4, 2, 700, 64, True, 300),  # window
    (1, 4, 2, 129, 128, False, 64),  # bidirectional window, one key past a tile
    (1, 2, 1, 1, 128, True, 0),  # one token
])
def test_kernel_numerics_match_plain(b, hq, hkv, l, d, causal, window):
    q, k, v = _bf16(*_qkv(7, b, hq, hkv, l, d))
    got = _emulate(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bf16_excess(got, want, atol=1e-6) == 0.0


@pytest.mark.parametrize("d,causal,window", [(128, True, 0), (64, False, 0), (128, True, 100)])
def test_kernel_numerics_match_pallas(d, causal, window):
    q, k, v = _qkv(8, 1, 4, 2, 256, d)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = _emulate(*_bf16(q, k, v), causal=causal, window=window)
    assert bf16_excess(got, want, atol=1e-6) == 0.0


def test_p_rounded_to_bf16_misses_the_gate():
    """Why P is split: rounded to bf16 once, as SDPA's P.V does, P moves a
    tenth of the outputs beyond one bf16 step (+ 1e-6) of the plain version."""
    q, k, v = _bf16(*_qkv(9, 1, 4, 1, 1024, 128))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    one = _emulate(q, k, v, causal=True, terms=1, nearest=True)
    assert bf16_excess(one, want, atol=1e-6) > 1e-4
    err = (one.float() - want.float()).abs() - bf16_ulp(want) - 1e-6
    assert (err > 0).float().mean() > 0.05
    assert bf16_excess(_emulate(q, k, v, causal=True), want, atol=1e-6) == 0.0


@pytest.mark.parametrize("nearest", [False, True])
def test_three_bf16_terms_hold_float32_p_exactly(nearest):
    """Why three terms: P_0 + P_1 keeps about 16 bits of a float32 P in (0, 1],
    P_0 + P_1 + P_2 all 24 (each difference is exact in float32), down to
    P = 2^-100, where the products stop mattering to a row's sum; with the
    kernel's truncated terms and with terms rounded to nearest."""
    split = (lambda x: x.bfloat16().float()) if nearest else _truncate_bf16
    p = torch.from_numpy(np.random.default_rng(10).random(1 << 16, dtype=np.float32))
    p = torch.cat([p, torch.exp2(-torch.arange(0, 100, dtype=torch.float32)) * 0.7071067])
    p0 = split(p)
    p1 = split(p - p0)
    p2 = split(p - p0 - p1)
    assert torch.equal(p0 + p1 + p2, p)
    two = (p0 + p1 - p).abs() / p
    assert (two > 0).float().mean() > 0.5 and two.max() <= 2.0 ** -15
