"""The port's CUDA kernels on the card: each against its plain version, the
engine against the brute-force oracle, and the LM's prefill and decode on
the card against the same weights on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports nothing of JAX, so it runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import (
    build_counting_plan,
    build_multi_counting_plan,
    colorful_map_count,
    colorful_map_count_many,
)
from repro_torch.core.graphs import edge_list, erdos_renyi, rmat
from repro_torch.core.templates import template
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.color_combine import color_combine, device_smem_limits, plan_tile
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_count import fused_count
from repro_torch.kernels.spmm_block import spmm_block
from repro_torch.kernels.spmm_edgetile import spmm_edge_tile
from repro_torch.models import build_model
from repro_torch.testing.numerics import bf16_excess

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("k,t1,t2,batch", [(12, 3, 4, 2), (12, 1, 7, 3), (12, 4, 8, 2), (5, 2, 2, 1)])
def test_cuda_kernels_match_plain(cuda_device, k, t1, t2, batch):
    g = rmat(1 << 12, 40_000, skew=8, seed=2)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=cuda_device)
    tbl = ops.build_combine_tables(k, t1, t2, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k + batch)
    a, w = math.comb(k, t1), math.comb(k, t2)
    left = torch.randint(0, 2, (plan.n_pad, batch, a), generator=gen, device=cuda_device).float()
    right = torch.randint(0, 2, (plan.n_pad, batch, w), generator=gen, device=cuda_device).float()
    launched = (spmm_edge_tile.launches, color_combine.launches, fused_count.launches)
    m = ops.spmm(plan, right)
    assert torch.equal(m, ref.spmm_segment_ref(plan.indptr, plan.indices, right))
    c = ops.color_combine(left, m, tbl)
    assert torch.equal(c, ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2))
    fused = ops.fused_count(plan.indptr, plan.indices, left, right, tbl)
    assert torch.equal(fused, c)  # bitwise fused == unfused
    torch.cuda.synchronize()
    after = (spmm_edge_tile.launches, color_combine.launches, fused_count.launches)
    assert [y - x for x, y in zip(launched, after)] == [1, 1, 1]


def _hub_plan(n, device, hub=3, seed=6):
    """R-MAT edges plus a hub joined to every other vertex (degree n - 1)."""
    rows, cols = edge_list(rmat(n, 6 * n, skew=3, seed=seed))
    pairs = set(zip(rows.tolist(), cols.tolist()))
    pairs |= {(hub, v) for v in range(n) if v != hub} | {(v, hub) for v in range(n) if v != hub}
    e = np.array(sorted(pairs), dtype=np.int32)
    return ops.build_spmm_plan(e[:, 0], e[:, 1], n, device=device)


#: (k, t1, t2) -> the route of the combine's tile plan on the H100 at B = 1
#: (rows a tile; >= 32: a warp is 32 rows of one output column, < 32: its
#: lanes split over output columns)
ROUTE_NODES = {
    "u12-2 (12, 792, 495, 8)": (12, 1, 7),  # 32 rows
    "u12-2 (220, 495, 792, 35)": (12, 3, 4),  # 32 rows
    "u12-2 root (495, 495, 1, 495)": (12, 4, 8),  # 16 rows
    "u12-2 (12, 12, 66, 2)": (12, 1, 1),  # 128 rows, four row groups
    "u14 (364, 3003, 2002, 84)": (14, 3, 6),  # 4 rows
    "u15-2 (455, 6435, 3003, 120)": (15, 3, 7),  # 4 rows, one CTA an SM
    "u15-2 root (1365, 1365, 1, 1365)": (15, 4, 11),  # 8 rows
}


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("node", list(ROUTE_NODES))
def test_combine_and_fused_tile_routes(cuda_device, node, batch):
    """Both kernels == their plain versions, and fused == color_combine of
    spmm_edge_tile bitwise, at u12-2's, u14's and u15-2's widest nodes, on a
    graph with a hub row: on the padded table, on the CSR of the n vertices
    alone (a ragged last tile) and on one vertex.  B = 3 and 9 take the
    fused kernel's scalar walk; at u14's and u15-2's widest nodes B = 9 takes
    tiles of one vertex and a group of its colorings (grid.y)."""
    k, t1, t2 = ROUTE_NODES[node]
    n = 301
    plan = _hub_plan(n, cuda_device)
    tbl = ops.build_combine_tables(k, t1, t2, device=cuda_device)
    limits = device_smem_limits(cuda_device)
    tile = plan_tile(tbl.a, tbl.w, tbl.s, tbl.jp, limits, batch=batch)
    if batch == 9 and (k, t1, t2) == (15, 3, 7):  # 9 rows of 6,890 floats do not fit
        assert tile.vertices == 1 and tile.colorings < batch
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k * batch + t1)
    for rows in (plan.n_pad, n, 1):
        indptr = plan.indptr[: rows + 1].contiguous()
        indices = plan.indices if rows > 1 else plan.indices[:0]
        if rows == 1:
            indptr = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        left = torch.randint(0, 2, (rows, batch, tbl.a), generator=gen, device=cuda_device).float()
        right = torch.randint(0, 2, (rows, batch, tbl.w), generator=gen,
                              device=cuda_device).float()
        launched = (color_combine.launches, fused_count.launches)
        m = spmm_edge_tile(indptr, indices, right)
        got = color_combine(left, m, tbl)
        want = ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2)
        assert torch.equal(got, want)
        fused = fused_count(indptr, indices, left, right, tbl)
        assert torch.equal(fused, got)
        assert torch.equal(fused, ref.fused_count_ref(indptr, indices, left, right, tbl.idx1,
                                                      tbl.idx2))
        assert (color_combine.launches, fused_count.launches) == tuple(x + 1 for x in launched)
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("k,t1,t2", [(12, 1, 2), (12, 3, 4), (12, 1, 7)])
def test_fused_equals_unfused_where_sums_round(cuda_device, k, t1, t2, batch):
    """Right tables near 2^22: M's sums pass 2^24 and round (the hub row's
    degree is 300), so the result shows the order of the adds and FMAs.
    fused_count == color_combine(left, spmm_edge_tile(right)), bitwise, also
    for unaligned views of the tables (the 4-byte staging and scalar walk)."""
    plan = _hub_plan(301, cuda_device)
    tbl = ops.build_combine_tables(k, t1, t2, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k + batch)
    right = _near_2_22(gen, (plan.n_pad, batch, tbl.w), 301, cuda_device)
    left = torch.randint(0, 4, (plan.n_pad, batch, tbl.a), generator=gen,
                         device=cuda_device).float()
    m = spmm_edge_tile(plan.indptr, plan.indices, right)
    assert m.max() >= 2.0 ** 24
    unfused = color_combine(left, m, tbl)
    assert torch.equal(fused_count(plan.indptr, plan.indices, left, right, tbl), unfused)
    assert torch.equal(fused_count(plan.indptr, plan.indices, _unaligned(left),
                                   _unaligned(right), tbl), unfused)
    assert torch.equal(color_combine(_unaligned(left), _unaligned(m), tbl), unfused)
    torch.cuda.synchronize()


def test_combine_library_sass(cuda_device):
    """Both combine kernels stage with 16-byte loads (the fused kernel's
    gathers too), read four split entries a broadcast (LDS.128) and prefetch
    the next chunk's entries with cp.async (LDGSTS)."""
    for name in ("color_combine", "fused_count"):
        text = _build.sass(name)
        if text is None:
            pytest.skip("the CUDA toolkit here has no cuobjdump")
        assert "LDG.E.128" in text and "LDS.128" in text and "LDGSTS" in text


def test_cuda_kernels_refuse_bad_tensors(cuda_device):
    """A CUDA tensor reaches the kernel or an exception, never the plain version."""
    g = erdos_renyi(50, 3.0, seed=0)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=cuda_device)
    table = torch.ones(plan.n_pad, 1, 3, device=cuda_device)
    with pytest.raises(ValueError):
        spmm_edge_tile(plan.indptr, plan.indices, table.double())
    with pytest.raises(ValueError):
        spmm_edge_tile(plan.indptr, plan.indices.long(), table)
    tbl = ops.build_combine_tables(5, 2, 2, device=cuda_device)  # widths (10, 10)
    with pytest.raises(ValueError):
        color_combine(table, table, tbl)
    with pytest.raises(ValueError):
        fused_count(plan.indptr, plan.indices, table, table, tbl)
    # a split table the kernels cannot read four entries a 16-byte load
    wide = torch.ones(plan.n_pad, 1, 10, device=cuda_device)
    buf = torch.zeros(tbl.pairs.numel() + 1, dtype=torch.int32, device=cuda_device)
    shifted = buf[1:].view(tbl.pairs.shape)
    shifted.copy_(tbl.pairs)
    for bad in (shifted, tbl.pairs.long(), tbl.pairs[:, :2].contiguous()):
        with pytest.raises(ValueError):
            color_combine(wide, wide, dataclasses.replace(tbl, pairs=bad))
        with pytest.raises(ValueError):
            fused_count(plan.indptr, plan.indices, wide, wide, dataclasses.replace(tbl, pairs=bad))
    assert torch.equal(color_combine(wide, wide, tbl),
                       ref.color_combine_ref(wide, wide, tbl.idx1, tbl.idx2))


def _near_2_22(gen, shape, n_valid, device):
    """Integers 2^22 .. 2^22 + 1023 as float32 (exact), 0 past ``n_valid``:
    a row of degree above 4 sums past 2^24, where float32 rounds and the
    summation order shows in the result."""
    t = (torch.randint(0, 1024, shape, generator=gen, device=device) + 2.0 ** 22).float()
    t[n_valid:] = 0
    return t


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: the kernels take their scalar path for it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _check_orders(plan, n_valid, b, w, gen, device):
    """spmm_block == spmm_edge_tile == the sequential CSR-order sum, bitwise,
    on values whose sums round, aligned and through the scalar path."""
    floats = _near_2_22(gen, (plan.n_pad, b, w), n_valid, device)
    want = ref.spmm_csr_order_ref(plan.indptr, plan.indices, floats)
    deg = torch.diff(plan.indptr)
    assert (want.reshape(plan.n_pad, -1)[deg > 4] >= 2.0 ** 24).all()
    for table in (floats, _unaligned(floats)):
        edges = spmm_edge_tile(plan.indptr, plan.indices, table)
        assert torch.equal(edges, want)
        if plan.kind == "blocks":
            assert torch.equal(spmm_block(plan, table), want)


@pytest.mark.parametrize("width", [1, 3, 12, 128, 192, 1000, 1056])
def test_spmm_block_matches_plain_and_edges(cuda_device, width):
    """``spmm_block`` == its plain version on integer tables (exact sums);
    on tables near 2^22, whose sums round, ``spmm_block`` ==
    ``spmm_edge_tile`` == the sequential float32 sum in CSR order, bitwise,
    for aligned tables and for an unaligned view (the scalar paths).  Widths
    cover the scalar path (not a multiple of 4) and partial column tiles
    and chunks."""
    g = rmat(1 << 11, 60_000, skew=3, seed=4)  # dense: the reference's 'auto' picks blocks
    plan = ops.build_spmm_plan(*edge_list(g), g.n, kind="auto", device=cuda_device)
    assert plan.kind == "blocks"
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(width)
    b = 2 if width % 2 == 0 else 1
    ints = torch.randint(0, 4, (plan.n_pad, b, width // b), generator=gen,
                         device=cuda_device).float()
    ints[g.n:] = 0
    launched = spmm_block.launches
    got = spmm_block(plan, ints)
    assert spmm_block.launches == launched + 1
    assert torch.equal(got, ref.spmm_block_ref(plan.patch_ptr, plan.patch_col,
                                               plan.patch_bits.to(cuda_device), ints))
    assert torch.equal(got, spmm_edge_tile(plan.indptr, plan.indices, ints))
    assert torch.equal(got, ops.spmm(plan, ints))
    _check_orders(plan, g.n, b, width // b, gen, cuda_device)
    torch.cuda.synchronize()


def _star(n):
    """Vertex 0 joined to every other vertex: one hub row of degree n - 1."""
    others = np.arange(1, n, dtype=np.int32)
    rows = np.concatenate([np.zeros(n - 1, np.int32), others])
    cols = np.concatenate([others, np.zeros(n - 1, np.int32)])
    return rows, cols, n


def _patch_shapes():
    """A directed graph over 4 row blocks: block 0 one patch whose rows use
    all 128 source columns (row r -> 256 + r, and row 0 -> all of 256..383),
    block 1 no patch, block 2 one patch using one column (every row -> 5),
    block 3 random rows over several patches, then the sentinel and pad
    rows."""
    rng = np.random.default_rng(0)
    adj = {r: {256 + r} for r in range(128)}
    adj[0] |= set(range(256, 384))
    adj.update({r: {5} for r in range(256, 384)})
    adj.update({r: set(rng.choice(500, rng.integers(1, 60), replace=False).tolist())
                for r in range(384, 500)})
    rows = np.concatenate([np.full(len(adj[r]), r, np.int32) for r in sorted(adj)])
    cols = np.concatenate([np.array(sorted(adj[r]), np.int32) for r in sorted(adj)])
    return rows, cols, 500


@pytest.mark.parametrize("width", [3, 12, 1056])
@pytest.mark.parametrize("graph", ["star", "patch-shapes"])
def test_spmm_hub_rows_and_patch_shapes(cuda_device, graph, width):
    """A star whose hub has more edges than the grid has column chunks, and
    row blocks with no patch, one patch using all 128 columns, one using a
    single column: both kernels == the plain version on integer tables and
    == the sequential CSR-order sum on tables whose sums round."""
    rows, cols, n = _star(5000) if graph == "star" else _patch_shapes()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(width)
    for kind in ("edges", "blocks"):
        plan = ops.build_spmm_plan(rows, cols, n, kind=kind, device=cuda_device)
        if graph == "star":
            assert int(torch.diff(plan.indptr).max()) > -(-width // 128)
        if kind == "blocks" and graph == "patch-shapes":
            used = ops.popcount32(plan.patch_union.cpu().numpy()).sum(axis=1)
            counts = torch.diff(plan.patch_ptr.long()).tolist()
            assert counts[1] == 0 and counts[0] == counts[2] == 1 and counts[3] > 1
            assert used[0] == 128 and used[1] == 1 and plan.patch_max_used == 128
        ints = torch.randint(0, 4, (plan.n_pad, 1, width), generator=gen,
                             device=cuda_device).float()
        ints[n:] = 0
        want = ref.spmm_segment_ref(plan.indptr, plan.indices, ints)
        assert torch.equal(ops.spmm(plan, ints), want)
        assert not ops.spmm(plan, ints)[n:].any()
        _check_orders(plan, n, 1, width, gen, cuda_device)
    torch.cuda.synchronize()


def test_spmm_block_refuses_bad_layouts(cuda_device):
    """The wrapper raises on staging bounds past what the kernel takes and on
    unions or offsets of the wrong shape (the kernel itself traps on a patch
    above the plan's bounds, which would end the test process's context)."""
    plan = ops.build_spmm_plan(*_patch_shapes(), kind="blocks", device=cuda_device)
    table = torch.ones(plan.n_pad, 1, 4, device=cuda_device)
    for bad in (dict(patch_max_used=129), dict(patch_max_slots=plan.patch_max_slots + 8),
                dict(patch_union=plan.patch_union[:, :3].contiguous()),
                dict(patch_offs=plan.patch_offs[:, :129].contiguous()),
                dict(patch_slots=plan.patch_slots.int())):
        with pytest.raises(ValueError):
            spmm_block(dataclasses.replace(plan, **bad), table)


def test_spmm_library_sass(cuda_device):
    """The block kernel stages with bulk asynchronous copies and the edge
    kernel gathers 128 bits a lane."""
    block, edges = _build.sass("spmm_block"), _build.sass("spmm_edgetile")
    if block is None:
        pytest.skip("the CUDA toolkit here has no cuobjdump")
    assert "UBLKCP" in block and "LDGSTS" in block
    assert "LDG.E.128" in edges


def test_spmm_block_refuses_bad_tensors(cuda_device):
    g = rmat(512, 30_000, skew=3, seed=1)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, kind="blocks", device=cuda_device)
    table = torch.ones(plan.n_pad, 1, 3, device=cuda_device)
    with pytest.raises(ValueError):
        spmm_block(plan, table.double())
    with pytest.raises(ValueError):
        spmm_block(dataclasses.replace(plan, patch_ptr=plan.patch_ptr.long()), table)
    with pytest.raises(ValueError):
        spmm_block(plan, table[:-128])


@pytest.mark.parametrize("name", ["u3-1", "u5-2", "u7-2"])
def test_engine_on_card_matches_brute_force(cuda_device, name):
    tree = template(name)
    for g in (erdos_renyi(40, 4.0, seed=2), rmat(64, 300, skew=3, seed=5)):
        coloring = np.random.default_rng(7).integers(0, tree.n, g.n).astype(np.int32)
        want = count_colorful_maps(g, tree, coloring)
        for kind in ("edges", "blocks"):
            for fuse in (False, True):
                plan = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device=cuda_device)
                assert float(colorful_map_count(plan, coloring)) == want


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("k,t1,t2", [(6, 1, 1), (6, 2, 1), (6, 1, 3)])
def test_bag_combine_view_matches_plain(cuda_device, k, t1, t2, batch):
    """A bag node's tables: the SpMM on ``[n_pad, B, x W]`` and the combine
    on the ``[n_pad, B x, W]`` views, == their plain versions."""
    g = rmat(300, 2000, skew=3, seed=4)
    x = g.n
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=cuda_device)
    tbl = ops.build_combine_tables(k, t1, t2, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k + t1 + batch)
    left = torch.randint(0, 4, (plan.n_pad, batch, x * tbl.a), generator=gen,
                         device=cuda_device).float()
    right = torch.randint(0, 4, (plan.n_pad, batch, x * tbl.w), generator=gen,
                          device=cuda_device).float()
    m = spmm_edge_tile(plan.indptr, plan.indices, right)
    assert torch.equal(m, ref.spmm_segment_ref(plan.indptr, plan.indices, right))
    lv = left.view(plan.n_pad, batch * x, tbl.a)
    mv = m.view(plan.n_pad, batch * x, tbl.w)
    out = color_combine(lv, mv, tbl)
    assert out.shape == (plan.n_pad, batch * x, tbl.s)
    assert torch.equal(out, ref.color_combine_ref(lv, mv, tbl.idx1, tbl.idx2))


@pytest.mark.parametrize("fuse", [False, True])
def test_mixed_dag_on_card_matches_plain(cuda_device, fuse):
    """The mixed tree and treewidth-2 DAG on the card == the CPU's plain
    versions == brute force; tree nodes take the fused kernel when asked,
    bag nodes never (one SpMM and one combine each, a join one combine)."""
    names = ("u3-1", "cycle4", "u5-2", "cycle6", "diamond", "bowtie")
    g = erdos_renyi(30, 5.0, seed=4)
    plan = build_multi_counting_plan(g, names, fuse=fuse, device=cuda_device)
    cpu = build_multi_counting_plan(g, names, device="cpu")
    cols = np.random.default_rng(3).integers(0, plan.k, (2, g.n)).astype(np.int32)
    kinds = [nd.kind for nd in plan.dag.nodes]
    tree, bag, join = kinds.count("combine"), kinds.count("bag_combine"), kinds.count("bag_join")
    before = (spmm_edge_tile.launches, color_combine.launches, fused_count.launches)
    got = colorful_map_count_many(plan, cols)
    after = (spmm_edge_tile.launches, color_combine.launches, fused_count.launches)
    assert [b - a for a, b in zip(before, after)] == (
        [bag, bag + join, tree] if fuse else [tree + bag, tree + bag + join, 0])
    assert torch.equal(got.cpu(), colorful_map_count_many(cpu, cols))
    want = [[count_colorful_maps(g, template(n), c) for n in names] for c in cols]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _sparse_table(gen, n_pad, n, batch, width, active, device):
    """Integer table rows ``[n_pad, B, W]`` (0-3) on a random ``active``
    fraction of (vertex, coloring) rows, zero elsewhere and past ``n``."""
    t = torch.randint(0, 4, (n_pad, batch, width), generator=gen, device=device).float()
    keep = torch.rand((n_pad, batch, 1), generator=gen, device=device) < active
    t *= keep
    t[n:] = 0
    return t


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("k,t1,t2", [(10, 5, 5), (12, 3, 4), (10, 2, 3)])
def test_rectangular_sources_match_plain(cuda_device, k, t1, t2, batch):
    """The edge and fused kernels read a compact ``[B (cap - 1) + 1, B, W]``
    source through remapped columns: == their plain versions on the same
    compact source, and == the dense kernels bitwise (the compact ops);
    the combine on gathered rows (``compact_combine``) == the dense combine."""
    from repro_torch.core.frontier import compact_combine, make_frontier_fn

    g = rmat(1 << 12, 20_000, skew=8, seed=3)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=cuda_device)
    tbl = ops.build_combine_tables(k, t1, t2, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k * 7 + t1 + batch)
    left = _sparse_table(gen, plan.n_pad, g.n, batch, tbl.a, 0.6, cuda_device)
    right = _sparse_table(gen, plan.n_pad, g.n, batch, tbl.w, 0.2, cuda_device)
    flags = []
    fr = make_frontier_fn({0: 1024}, g.n, flags)(0, right)
    assert fr.idx is not None and bool(flags[0].all())
    right_c = right.index_select(0, fr.idx)
    cols = torch.index_select(fr.inv, 0, plan.indices)
    m = ops.spmm_compact(plan, right_c, fr.inv)
    assert torch.equal(m, ref.spmm_segment_ref(plan.indptr, cols, right_c))
    assert torch.equal(m, spmm_edge_tile(plan.indptr, plan.indices, right))
    fused = ops.fused_count_compact(plan, left, right_c, fr.inv, tbl)
    assert torch.equal(fused, ref.fused_count_ref(plan.indptr, cols, left, right_c, tbl.idx1,
                                                  tbl.idx2))
    assert torch.equal(fused, fused_count(plan.indptr, plan.indices, left, right, tbl))
    out = compact_combine(left, m, tbl, g.n + 1, g.n, flags)
    assert bool(flags[1].all())
    assert torch.equal(out, color_combine(left, m, tbl))
    assert torch.equal(out, ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2))


@pytest.mark.parametrize("fuse", [False, True])
def test_compacted_engine_on_card_matches_dense(cuda_device, fuse, monkeypatch):
    """A compacted u7-2 plan on the card (floors forced down so every route
    engages) == its dense twin bitwise, through count_fn; with every
    capacity overflowing, count_fn re-runs the dense twin on the card.  The
    graph keeps every map below 2^24, so the CPU's plain versions give the
    same counts."""
    from repro_torch.core import frontier
    from repro_torch.core.count_engine import count_fn

    monkeypatch.setattr(frontier, "MIN_COMBINE_ELEMENTS", 1)
    monkeypatch.setattr(frontier, "MIN_TABLE_WIDTH", 1)
    g = rmat(1024, 1000, skew=3, seed=2)
    tree = template("u7-2")
    dense = build_counting_plan(g, tree, fuse=fuse, device=cuda_device)
    comp = build_counting_plan(g, tree, fuse=fuse, device=cuda_device, compact=True,
                               density_threshold=0.7)
    tiny = build_counting_plan(g, tree, fuse=fuse, device=cuda_device, compact=True,
                               density_threshold=1.0, capacity_factor=1e-6)
    assert comp.compaction.table_caps and comp.compaction.combine_caps
    key = prng.key(4)
    want = count_fn(dense, 3)(key)[0]
    for plan, fallbacks in ((comp, 0), (tiny, 1)):
        f = count_fn(plan, 3)
        got = f(key)[0]
        assert got.device.type == "cuda" and torch.equal(got, want)
        assert f.fallbacks == fallbacks
    cpu = build_counting_plan(g, tree, device="cpu", compact=True, density_threshold=0.7)
    assert torch.equal(count_fn(cpu, 3)(key)[0], want.cpu())


@pytest.mark.parametrize("seed,k", [(0, 12), (7, 5), (2**31 + 5, 15)])
def test_colorings_on_card_equal_cpu(cuda_device, seed, k):
    """Threefry on the card draws what it draws on the CPU (which the CPU
    tests hold == jax.random), including past 2^24 elements."""
    key = prng.fold_in(prng.key(seed), 3)
    for shape in [(1, 5), (3, 1000), (17, 1 << 20)]:
        got = prng.randint(key, shape, 0, k, device=cuda_device)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), prng.randint(key, shape, 0, k, device="cpu"))


def _qkv(device, dtype, b, hq, hkv, l, d, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, hq, l, d), (b, hkv, l, d), (b, hkv, l, d))]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal,window,l", [(True, 0, 256), (True, 100, 300), (False, 0, 200),
                                             (False, 64, 129), (True, 0, 1), (True, 0, 127),
                                             (False, 0, 128), (True, 0, 4097)])
def test_flash_attention_matches_plain(cuda_device, d, dtype, group, causal, window, l):
    """The kernel == its plain version on the same inputs: float32 within
    1e-5 (float32 sums in other orders), bf16 within one bf16 step of the
    plain version's float32 result rounded, plus 1e-6 for the sums' order
    near zero.  GQA groups 1, 4 and 8; ragged L, one tile, windows and
    bidirectional masks.  bf16 takes the wgmma kernel, float32 the CUDA-core
    one."""
    q, k, v = _qkv(cuda_device, dtype, 2, 2 * group, 2, l, d, seed=d + l + group)
    launched = (flash_attention.launches, flash_attention.launches_wgmma,
                flash_attention.launches_fp32)
    got = flash_attention(q, k, v, causal=causal, window=window)
    route = (1, 1, 0) if dtype == torch.bfloat16 else (1, 0, 1)
    assert (flash_attention.launches, flash_attention.launches_wgmma,
            flash_attention.launches_fp32) == tuple(x + y for x, y in zip(launched, route))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bf16_excess(got, want, atol=1e-6) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 10])
@pytest.mark.parametrize("causal,window,l", [(True, 0, 1), (True, 0, 127), (True, 64, 300),
                                             (False, 0, 1000), (True, 2048, 2200)])
def test_flash_attention_at_head_dim_256(cuda_device, dtype, group, causal, window, l):
    """D = 256 (recurrentgemma's local attention, GQA group 10): the kernel of
    each dtype == its plain version under the same gates; 64-key KV tiles
    in the bf16 kernel."""
    q, k, v = _qkv(cuda_device, dtype, 1, group, 1, l, 256, seed=l + group)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bf16_excess(got, want, atol=1e-6) == 0.0


def test_flash_library_sass_has_wgmma_and_tma(cuda_device):
    """The bf16 kernel runs its products on the tensor cores (HGMMA) and
    stages its tiles with TMA (UTMALDG)."""
    text = _build.sass("flash_attention_wgmma")
    if text is None:
        pytest.skip("the CUDA toolkit here has no cuobjdump")
    assert "HGMMA" in text and "UTMALDG" in text


def test_flash_attention_refuses_bad_tensors(cuda_device):
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 2, 64, 64, seed=0)
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), v.half())  # dtype
    with pytest.raises(ValueError):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])  # head dim, contiguity
    with pytest.raises(ValueError):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())  # head dim 32
    for d in (96, 512):  # head dims the kernels are not built for
        q2, k2, v2 = _qkv(cuda_device, torch.bfloat16, 1, 4, 2, 64, d, seed=1)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q2, k2, v2)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :32].contiguous(), k, v)  # Lq != Lk
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)


def test_lm_prefill_and_decode_on_card_match_cpu(cuda_device):
    """A small granite (head_dim 64, so the kernel runs) in float32: the
    card's prefill and decode logits equal the CPU's on the same weights
    within 1e-4 (TF32 off), with one kernel launch per layer per prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(), head_dim=64, num_layers=3)
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    card = build_model(cfg, dtype=torch.float32, device=cuda_device)
    params = cpu.init_fn(torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(params).to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 201)))
    launched = flash_attention.launches
    got, caches = card.prefill_fn(on_card, {"tokens": toks[:, :200].to(cuda_device)})
    assert flash_attention.launches == launched + cfg.num_layers
    want, cpu_caches = cpu.prefill_fn(params, {"tokens": toks[:, :200]})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    got, _ = card.decode_fn(on_card, {"tokens": toks[:, 200:].to(cuda_device), "pos": 200,
                                      "caches": caches})
    want, _ = cpu.decode_fn(params, {"tokens": toks[:, 200:], "pos": 200, "caches": cpu_caches})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


DIST_MODES = [("alltoall", 1), ("pipeline", 1), ("pipeline", 3), ("adaptive", 1), ("ring", 1)]


@pytest.mark.parametrize("name", ["u3-1", "u5-2", "cycle4"])
def test_distributed_engine_on_the_card(cuda_device, name):
    """Every mode x fuse on LocalMesh ranks sharing the card == brute force,
    and the count reaches the kernels (their launch counts rise)."""
    from repro_torch.comm import LocalMesh
    from repro_torch.core.distributed import build_distributed_plan, make_count_fn, shard_coloring

    g = erdos_renyi(97, 5.0, seed=7)
    tree = template(name)
    col = np.random.default_rng(3).integers(0, tree.n, g.n).astype(np.int32)
    want = count_colorful_maps(g, tree, col)
    before = spmm_edge_tile.launches + fused_count.launches
    for P, I in ((4, 1), (8, 2)):
        plan = build_distributed_plan(g, tree, P, device=cuda_device)
        cols = np.broadcast_to(shard_coloring(plan, col)[None], (I, P, plan.n_loc_pad))
        for mode, gf in DIST_MODES:
            for fuse in (False, True):
                f = make_count_fn(plan, LocalMesh(P, I, device=cuda_device), mode=mode,
                                  group_factor=gf, fuse=fuse)
                assert f(cols).tolist() == [want] * I, (P, I, mode, gf, fuse)
    assert spmm_edge_tile.launches + fused_count.launches > before


def test_distributed_counter_on_the_card(cuda_device):
    """The keyed samples of the distributed Counter on the card equal the
    CPU's, at another shard count (the stream ignores the shard count)."""
    from repro_torch.api import Counter

    g = erdos_renyi(200, 4.0, seed=1)
    card = Counter.from_graph(g, "u5-2", backend="distributed", num_shards=4, mode="pipeline",
                              device=cuda_device)
    cpu = Counter.from_graph(g, "u5-2", backend="distributed", num_shards=2, mode="ring",
                             device="cpu")
    a = card.estimate(n_iter=8, key=prng.key(1), batch=4).samples
    b = cpu.estimate(n_iter=8, key=prng.key(1), batch=4).samples
    np.testing.assert_array_equal(a, b)


def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step of a reduced row in float32 (TF32 off) on the card ==
    the same step on the CPU: the loss, the gradient norm and the updated
    weights within 1e-4 relative; the train path launches no flash kernel."""
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step
    from repro_torch.train.data import DataConfig, synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    tcfg = TrainConfig(opt=AdamWConfig(lr_peak=1e-2, warmup_steps=0))
    out = {}
    for dev in ("cpu", cuda_device):
        model = build_model(cfg, dtype=torch.float32, device=dev)
        params = model.init_fn(torch.Generator().manual_seed(0)) if dev == "cpu" else \
            copy.deepcopy(out["cpu_init"]).to(dev)
        if dev == "cpu":
            out["cpu_init"] = copy.deepcopy(params)
        step, _ = make_train_step(model, tcfg)
        batch = synthetic_batch(DataConfig(cfg.vocab_size, 2, 64, 0), 0, dev)
        n0 = flash_attention.launches
        params, _, metrics = step(params, init_opt_state(dict(params.named_parameters())), batch)
        assert flash_attention.launches == n0
        out[str(torch.device(dev).type)] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                                            {k: v.detach().cpu() for k, v in
                                             params.named_parameters()})
    (l1, g1, p1), (l2, g2, p2) = out["cpu"], out["cuda"]
    assert abs(l1 - l2) <= 1e-4 * abs(l1) and abs(g1 - g2) <= 1e-4 * abs(g1)
    for k in p1:
        assert (p1[k] - p2[k]).norm() <= 1e-4 * p1[k].norm(), k


def test_flash_kernel_refuses_tensors_that_need_a_gradient(cuda_device):
    q = torch.randn(1, 2, 64, 64, device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 1, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    n0 = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    assert flash_attention.launches == n0
