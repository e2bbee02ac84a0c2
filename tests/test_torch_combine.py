"""The combine and fused kernels' tile schedules, on the CPU.

No CUDA kernel runs here, so each kernel's schedule is emulated in torch as
the kernel runs it: the host's tile plan (``plan_tile``: tile rows, whole
vertices or one vertex's coloring group, output chunk), the packed split
table (``[S, Jp]``), the staging of each tile's rows into column-major
buffers at pitch ``T | 1``, the fused kernel's phase 1 (one (vertex,
128-float chunk) unit a warp, each lane's sums scattered into the tile's
``M`` buffer), and phase 2's warp items (lane -> row and output column),
output chunks and write-out, ragged last tiles included.  Every address is
computed as the kernels compute it.  The emulations are held ``==`` the plain
versions and the reference's Pallas kernels (interpret mode) at u12-2's and
u15-2's node shapes, and on tables whose sums round, fused == unfused and
both == the ascending-``j`` ``fmaf`` chain, bitwise.  The kernels themselves
are held to the same on the card in test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmat
from repro.core.graphs import edge_list
from repro.kernels import ops as jops
from repro.kernels.color_combine import color_combine_pallas
from repro.kernels.fused_count import fused_count_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.color_combine import (H100_SMEM, MAX_TILE_ROWS, SmemLimits,
                                               chunk_columns, plan_tile, tile_bytes)

CPU = torch.device("cpu")
NAN = float("nan")

#: (k, t1, t2) of u12-2's six node shapes and u15-2's widest two
U12_2 = {"12-12-66": (12, 1, 1), "12-66-220": (12, 1, 2), "12-220-495": (12, 1, 3),
         "12-792-495": (12, 1, 7), "220-495-792": (12, 3, 4), "root12": (12, 4, 8)}
U15_2 = {"455-6435-3003": (15, 3, 7), "root15": (15, 4, 11)}


def _fma(acc, x, y):
    """fmaf: ``x * y + acc`` rounded once to float32.  Exact here: every
    table holds integers, whose products and sums stay below 2^53."""
    return (acc.double() + x.double() * y.double()).float()


def warp_items(t: int, sca: int, cols: int = 1):
    """The (row, chunk column, chain) of every working lane's chains in a
    chunk's warp items (``combine_tile``): ``RL = min(T, 32)`` rows an item,
    ``G = 32 / RL`` column groups of ``cols`` columns; lane ``l`` takes row
    ``l % RL`` and, for chain ``c``, column ``((item / n_rg) cols + c) G + l
    / RL``."""
    rl = min(t, 32)
    groups = 32 // rl
    n_rg = -(-t // rl)
    n_cg = -(-sca // groups)
    it = torch.arange(n_rg * -(-n_cg // cols))[:, None, None]
    lane = torch.arange(32)[None, :, None]
    c = torch.arange(cols)[None, None, :]
    r = ((it % n_rg) * rl + lane % rl).expand(-1, -1, cols)
    sl = ((it // n_rg) * cols + c) * groups + lane // rl
    on = (lane // rl < groups) & (r < t) & (sl < sca)
    return r[on], sl[on], (it * cols + c).expand(-1, 32, -1)[on]


def stage(table2d, firsts, nrows, t):
    """``stage_rows`` for every tile: ``buf[tile, c * P + r] = table2d[first
    + r, c]`` for ``r < nrows`` (NaN elsewhere: never read)."""
    p = t | 1
    width = table2d.shape[1]
    r = torch.arange(t)
    rows = (firsts[:, None] + r).clamp(max=table2d.shape[0] - 1)
    vals = torch.where((r < nrows[:, None])[..., None], table2d[rows], NAN)  # [tiles, t, width]
    buf = torch.full((len(firsts), width, p), NAN)
    buf[:, :, :t] = vals.transpose(1, 2)
    return buf.reshape(len(firsts), width * p)


def phase2(s_left, s_m, nrows, tables, tile):
    """``combine_tile`` over every tile at once; returns ``[tiles, T, S]``."""
    t, p = tile.rows, tile.rows | 1
    n_tiles = len(nrows)
    out = torch.full((n_tiles, t, tables.s), NAN)
    rr = torch.arange(t)
    for s0 in range(0, tables.s, tile.chunk):
        sca = min(tile.chunk, tables.s - s0)
        sp = tables.pairs[s0:s0 + sca]  # the chunk's staged split entries, [sca, Jp]
        r, sl, _ = warp_items(t, sca, tile.columns)
        acc = torch.zeros(n_tiles, len(r))
        for j in range(tables.j):
            e = sp[sl, j]
            acc = _fma(acc, s_left[:, (e & 0xFFFF).long() * p + r], s_m[:, (e >> 16).long() * p + r])
        s_out = torch.full((n_tiles, sca * p), NAN)
        s_out[:, sl * p + r] = torch.where(r < nrows[:, None], acc, NAN)
        c = torch.arange(sca)
        out[:, :, s0:s0 + sca] = s_out[:, c[None, :] * p + rr[:, None]]
    return out


def emulate_combine(left, m, tables, limits=H100_SMEM):
    """color_combine.cu on ``[n, B, *]`` tables: tiles of T flattened rows."""
    n, b, a = left.shape
    rows = n * b
    tile = plan_tile(a, tables.w, tables.s, tables.jp, limits)
    firsts = torch.arange(0, rows, tile.rows)
    nrows = (rows - firsts).clamp(max=tile.rows)
    out = phase2(stage(left.reshape(rows, a), firsts, nrows, tile.rows),
                 stage(m.reshape(rows, -1), firsts, nrows, tile.rows), nrows, tables, tile)
    valid = torch.arange(tile.rows) < nrows[:, None]
    return out[valid].reshape(n, b, tables.s)


def emulate_fused(indptr, indices, left, right, tables, limits=H100_SMEM):
    """fused_count.cu: tiles of V whole vertices (or one vertex's group of Bt
    colorings, grid.y), phase 1 unit by unit into the tile's M buffer."""
    n, b, a = left.shape
    w = right.shape[2]
    tile = plan_tile(a, w, tables.s, tables.jp, limits, batch=b)
    v, bt, t, p = tile.vertices, tile.colorings, tile.rows, tile.rows | 1
    vec = (b * w) % 4 == 0 and (bt * w) % 4 == 0
    # each element of M is csr_chunk_gather's CSR-order sum (test_torch_spmm.py
    # holds the edge kernel's chunked walk == this sequential sum)
    m_full = ref.spmm_csr_order_ref(indptr, indices, right).reshape(n, b * w)
    lane = torch.arange(32)[:, None]
    k = torch.arange(4)[None, :]
    f = (4 * lane + k if vec else lane + 32 * k).reshape(-1)  # lane's columns of a chunk
    firsts, nrows, s_m = [], [], []
    for v0 in range(0, n, v):
        for b0 in range(0, b, bt):
            nv, nb = min(v, n - v0), min(bt, b - b0)
            firsts.append(v0 * b + b0)
            nrows.append(nv * nb)
            buf = torch.full((w * p,), NAN)
            c0 = torch.arange(0, nb * w, 128)[:, None]
            g = c0 + f  # [units of a vertex, lane columns]
            g = g[f < (nb * w - c0).clamp(max=128)]
            bb = g // w
            for i in range(nv):  # one warp per (vertex, chunk) unit
                buf[(g - bb * w) * p + i * bt + bb] = m_full[v0 + i, b0 * w + g]
            s_m.append(buf)
    firsts, nrows = torch.tensor(firsts), torch.tensor(nrows)
    out = phase2(stage(left.reshape(n * b, a), firsts, nrows, t), torch.stack(s_m), nrows,
                 tables, tile)
    flat = torch.full((n * b, tables.s), NAN)
    for i, (first, nr) in enumerate(zip(firsts.tolist(), nrows.tolist())):
        flat[first:first + nr] = out[i, :nr]  # a tile's rows are one run of the table
    return flat.reshape(n, b, tables.s), tile


def fma_chain(left, m, tables, reverse=False):
    """The oracle of the order: every output the ``fmaf`` chain over
    ascending ``j`` (descending with ``reverse``) into one accumulator."""
    acc = torch.zeros(left.shape[:-1] + (tables.s,))
    js = range(tables.j - 1, -1, -1) if reverse else range(tables.j)
    for j in js:
        acc = _fma(acc, left[..., tables.idx1[:, j]], m[..., tables.idx2[:, j]])
    return acc


def _graph(n, seed, hub=3):
    """R-MAT edges (6 n) plus a hub joined to every other vertex; a complete
    graph below 16 vertices (none on one)."""
    if n < 16:
        e = np.array([(a, b) for a in range(n) for b in range(n) if a != b], np.int32)
        e = e.reshape(-1, 2)
        return e[:, 0], e[:, 1]
    rows, cols = edge_list(rmat(n, 6 * n, skew=3, seed=seed))
    extra = np.arange(n)
    extra = extra[extra != hub]
    pairs = set(zip(rows.tolist(), cols.tolist()))
    pairs |= {(hub, int(u)) for u in extra} | {(int(u), hub) for u in extra}
    e = np.array(sorted(pairs), dtype=np.int32)
    return e[:, 0], e[:, 1]


def _ints(rng, shape, hi, n_valid=None):
    t = torch.from_numpy(rng.integers(0, hi, shape).astype(np.float32))
    if n_valid is not None:
        t[n_valid:] = 0
    return t


def _pallas_combine(left, m, k, t1, t2):
    """color_combine_pallas (interpret mode) per coloring, at 128-padded widths."""
    jt = jops.build_combine_tables(k, t1, t2)
    n, b, a = left.shape
    rows = jops.pad_to(n, 128)
    out = []
    for bi in range(b):
        lp = np.zeros((rows, jops.pad_to(a, 128)), np.float32)
        mp = np.zeros((rows, jops.pad_to(m.shape[2], 128)), np.float32)
        lp[:n, :a] = left[:, bi].numpy()
        mp[:n, :m.shape[2]] = m[:, bi].numpy()
        got = color_combine_pallas(jnp.asarray(lp), jnp.asarray(mp), jt.idx1_t, jt.idx2_t,
                                   num_splits=jt.j, interpret=True)
        out.append(np.asarray(got)[:n, :jt.s])
    return torch.from_numpy(np.stack(out, 1))


@pytest.mark.parametrize("name", list(U12_2) + list(U15_2))
def test_combine_schedule_matches_plain_and_pallas(name):
    """Rows not a multiple of the tile (a ragged last tile) at every shape."""
    k, t1, t2 = (U12_2 | U15_2)[name]
    tables = ops.build_combine_tables(k, t1, t2, device=CPU)
    n, b = (45, 3) if name in U12_2 else (37, 1)
    rng = np.random.default_rng(k + t1)
    left, m = _ints(rng, (n, b, tables.a), 4), _ints(rng, (n, b, tables.w), 4)
    tile = plan_tile(tables.a, tables.w, tables.s, tables.jp, H100_SMEM)
    assert (n * b) % tile.rows
    got = emulate_combine(left, m, tables)
    assert torch.equal(got, ref.color_combine_ref(left, m, tables.idx1, tables.idx2))
    assert torch.equal(got, _pallas_combine(left, m, k, t1, t2))


def _fused_case(name, n, b, seed, limits=H100_SMEM, padded=True):
    """Tables of the node shape on an R-MAT graph with a hub; ``padded=False``
    runs the kernel on the CSR of the ``n`` vertices alone (no pad rows), so
    that the last tile is ragged."""
    k, t1, t2 = (U12_2 | U15_2)[name]
    tables = ops.build_combine_tables(k, t1, t2, device=CPU)
    plan = ops.build_spmm_plan(*_graph(n, seed), n, device=CPU)
    rows = plan.n_pad if padded else n
    indptr = plan.indptr[:rows + 1]
    rng = np.random.default_rng(seed)
    left = _ints(rng, (rows, b, tables.a), 2, n)
    right = _ints(rng, (rows, b, tables.w), 2, n)
    got, tile = emulate_fused(indptr, plan.indices, left, right, tables, limits)
    want = ref.fused_count_ref(indptr, plan.indices, left, right, tables.idx1, tables.idx2)
    return (k, t1, t2), tables, plan, left, right, got, want, tile


@pytest.mark.parametrize("name,b", [(s, b) for s in U12_2 for b in (1, 4)]
                         + [(s, 1) for s in U15_2])
def test_fused_schedule_matches_plain_and_pallas(name, b):
    """Tiles of whole vertices; the emulated kernel == fused_count_ref and ==
    fused_count_pallas (interpret mode) coloring by coloring."""
    (k, t1, t2), tables, plan, left, right, got, want, tile = _fused_case(name, 150, b,
                                                                          seed=len(name))
    assert tile.colorings == b and tile.rows == tile.vertices * b
    assert torch.equal(got, want)
    jplan = jops.build_spmm_plan(*_graph(150, len(name)), 150, kind="edges")
    jt = jops.build_combine_tables(k, t1, t2)
    for bi in range(b):
        lp = np.zeros((plan.n_pad, jops.pad_to(tables.a, 128)), np.float32)
        rp = np.zeros((plan.n_pad, jops.pad_to(tables.w, 128)), np.float32)
        lp[:, :tables.a] = left[:, bi].numpy()
        rp[:, :tables.w] = right[:, bi].numpy()
        want = fused_count_pallas(jplan.slab_dst, jplan.slab_cols, jnp.asarray(lp),
                                  jnp.asarray(rp), jt.idx1_t, jt.idx2_t, num_splits=jt.j,
                                  slabs_per_block=jplan.slabs_per_block, interpret=True)
        np.testing.assert_array_equal(got[:150, bi].numpy(), np.asarray(want)[:150, :jt.s])


SMALL_SMEM = SmemLimits(per_block=24 * 1024, per_sm=100 * 1024, reserved=1024)


@pytest.mark.parametrize("name,b,limits,sizes", [
    ("12-12-66", 3, H100_SMEM, (1, 37, 130)),
    ("220-495-792", 3, H100_SMEM, (1, 37)),
    ("12-792-495", 1, H100_SMEM, (1, 45)),
    ("root12", 9, SMALL_SMEM, (1, 5)),
    ("455-6435-3003", 9, H100_SMEM, (1, 3)),
], ids=["narrow-B3", "wide-B3", "792-B1", "root-B9-small-smem", "u15-B9"])
def test_fused_ragged_tiles_and_coloring_groups(name, b, limits, sizes):
    """The kernel on a CSR of n vertices with no pad rows: a last tile that
    is ragged (n not a multiple of the tile's vertices, one vertex alone),
    B = 3 and 9 (the scalar walk) and, where one vertex's B rows do not fit
    the card's shared memory, tiles of one vertex and a group of its
    colorings, the last group ragged."""
    for n in sizes:
        _, tables, _, _, _, got, want, tile = _fused_case(name, n, b, seed=n, limits=limits,
                                                          padded=False)
        if b == 9:
            assert tile.vertices == 1 and b % tile.colorings  # coloring groups, the last ragged
        elif n > 1:
            assert n % tile.vertices
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,b", [("12-66-220", 4), ("220-495-792", 1), ("12-792-495", 3)])
def test_fused_equals_unfused_where_sums_round(name, b):
    """Values near 2^22: M's sums pass 2^24 and round (a hub row of degree
    149), so the results show the order of the adds and of the FMAs.  The
    emulated fused kernel == the emulated combine of the CSR-order neighbor
    sum == the ascending-j fmaf chain, bitwise; the descending chain differs."""
    k, t1, t2 = U12_2[name]
    tables = ops.build_combine_tables(k, t1, t2, device=CPU)
    plan = ops.build_spmm_plan(*_graph(150, seed=3), 150, device=CPU)
    rng = np.random.default_rng(1)
    right = _ints(rng, (plan.n_pad, b, tables.w), 1024, 150) + 2.0 ** 22
    right[150:] = 0
    left = _ints(rng, (plan.n_pad, b, tables.a), 4, 150)
    m = ref.spmm_csr_order_ref(plan.indptr, plan.indices, right)
    assert m.max() >= 2.0 ** 24
    fused, _ = emulate_fused(plan.indptr, plan.indices, left, right, tables)
    want = fma_chain(left, m, tables)
    assert torch.equal(fused, emulate_combine(left, m, tables))
    assert torch.equal(fused, want)
    if tables.j > 2:
        assert not torch.equal(fma_chain(left, m, tables, reverse=True), want)


@pytest.mark.parametrize("cols", [1, 2, 4])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 6, 8, 9, 12, 16, 18, 24, 32, 36, 48, 64, 72, 96, 128])
def test_warp_items_cover_each_output_once(t, cols):
    """Every (row, column) of a chunk is one lane chain's, at every tile
    height the plan gives (powers of two, and V B for B = 3 and 9) and every
    item width; at T >= 32 a chain's 32 lanes are 32 rows of one column, so
    they share their split entries."""
    for sca in (1, 5, 22, 31, 32, 64, 125, 256):
        r, sl, chain = warp_items(t, sca, cols)
        seen = r * sca + sl
        assert torch.equal(seen.sort().values, torch.arange(t * sca))
        if t >= 32:  # a chain's lanes share one column
            col0 = torch.full((int(chain.max()) + 1,), -1).scatter_reduce(
                0, chain, sl, "amax", include_self=False)
            assert torch.equal(col0[chain], sl)


def test_pair_packing_is_the_kernels_form():
    """``[S, Jp]``: J padded to a multiple of 4 with zeros, so a column's
    splits are one 16-byte aligned run; a chunk of columns one block."""
    for k, t1, t2 in list(U12_2.values()) + list(U15_2.values()) + [(14, 3, 6)]:
        tables = ops.build_combine_tables(k, t1, t2, device=CPU)
        assert tables.pairs.dtype == torch.int32 and tables.pairs.is_contiguous()
        assert tables.pairs.shape == (tables.s, tables.jp) and tables.jp % 4 == 0
        assert tables.jp - 4 < tables.j <= tables.jp
        p = tables.pairs[:, :tables.j]
        assert torch.equal(p & 0xFFFF, tables.idx1.int()) and torch.equal(p >> 16, tables.idx2.int())
        assert not tables.pairs[:, tables.j:].any()
        tile = plan_tile(tables.a, tables.w, tables.s, tables.jp, H100_SMEM)
        assert tile.smem_bytes == tile_bytes(tile.rows, tables.a, tables.w, tables.s, tables.jp)
        assert tile.chunk == chunk_columns(tile.rows, tables.s, tables.jp)
        assert tile.rows <= MAX_TILE_ROWS and tile.chunk <= tables.s
