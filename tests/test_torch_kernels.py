"""The port's count-table ops against the JAX package's Pallas kernels.

On the CPU every op runs its plain PyTorch version; the JAX side runs the
Pallas kernels in interpret mode exactly as tests/test_kernels.py does.
Tables hold integers in 0..3 and every sum stays far below 2^24, so every
summation order is exact and the true columns compare with ``==``.  The
CUDA kernels are held against the plain versions on the card in
test_torch_gpu.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import erdos_renyi, rmat
from repro.core.graphs import edge_list
from repro.kernels import ops as jops
from repro.kernels.color_combine import color_combine_pallas
from repro.kernels.fused_count import fused_count_pallas
from repro.kernels.spmm_edgetile import spmm_block_pallas, spmm_edge_tile_pallas
from repro_torch.api import Counter
from repro_torch.core.count_engine import build_counting_plan
from repro_torch.core.templates import TEMPLATES, template
from repro_torch.core.graphs import erdos_renyi as port_erdos_renyi
from repro_torch.core.graphs import rmat as port_rmat
from repro_torch.kernels import ops, ref
from repro_torch.kernels.color_combine import color_combine
from repro_torch.kernels.color_combine import FUSED_STATIC_BYTES, H100_SMEM, plan_tile, tile_bytes
from repro_torch.kernels.fused_count import fused_count
from repro_torch.kernels.spmm_block import spmm_block
from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

CPU = torch.device("cpu")


def _int_table(rng, n_pad, width, n_valid, hi=4):
    t = rng.integers(0, hi, (n_pad, width)).astype(np.float32)
    t[n_valid:] = 0.0
    return t


def _port_plan(g, kind="edges"):
    return ops.build_spmm_plan(*edge_list(g), g.n, kind=kind, device=CPU)


SPMM_CASES = [
    (lambda: erdos_renyi(100, 5.0, seed=100), 128, 128),
    (lambda: erdos_renyi(300, 8.0, seed=300), 256, 64),
    (lambda: erdos_renyi(64, 3.0, seed=64), 384, 32),
    (lambda: rmat(200, 3000, skew=8, seed=3), 128, 64),  # supernode rows own many slabs
]


@pytest.mark.parametrize("make_graph,width,tile", SPMM_CASES)
def test_spmm_matches_pallas(make_graph, width, tile):
    g = make_graph()
    jplan = jops.build_spmm_plan(*edge_list(g), g.n, kind="edges", tile_size=tile)
    plan = _port_plan(g)
    assert plan.n_pad == jplan.n_pad
    table = _int_table(np.random.default_rng(tile), plan.n_pad, width, g.n)
    want = np.asarray(spmm_edge_tile_pallas(
        jplan.slab_dst, jplan.slab_cols, jnp.asarray(table),
        slabs_per_block=jplan.slabs_per_block, interpret=True,
    ))
    got = ops.spmm(plan, torch.from_numpy(table)[:, None, :])[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[g.n:].any()  # zero-degree, sentinel and pad rows are exactly zero


@pytest.mark.parametrize("k,t1,t2", [(5, 2, 2), (7, 3, 2), (10, 3, 3), (12, 4, 3)])
def test_color_combine_matches_pallas(k, t1, t2):
    jt = jops.build_combine_tables(k, t1, t2)
    tbl = ops.build_combine_tables(k, t1, t2, device=CPU)
    a, b = math.comb(k, t1), math.comb(k, t2)
    rng = np.random.default_rng(k)
    left = _int_table(rng, 256, jops.pad_to(a, 128), 256)
    m = _int_table(rng, 256, jops.pad_to(b, 128), 256)
    want = np.asarray(color_combine_pallas(
        jnp.asarray(left), jnp.asarray(m), jt.idx1_t, jt.idx2_t, num_splits=jt.j, interpret=True
    ))[:, : jt.s]
    got = ops.color_combine(torch.from_numpy(left[:, None, :a]).contiguous(),
                            torch.from_numpy(m[:, None, :b]).contiguous(), tbl)[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,t1,t2", [(3, 1, 1), (5, 2, 2), (7, 3, 2), (10, 4, 3)])
def test_fused_count_matches_pallas(k, t1, t2):
    g = erdos_renyi(150, 6.0, seed=k)
    jplan = jops.build_spmm_plan(*edge_list(g), g.n, kind="edges")
    jt = jops.build_combine_tables(k, t1, t2)
    plan = _port_plan(g)
    tbl = ops.build_combine_tables(k, t1, t2, device=CPU)
    a, b = math.comb(k, t1), math.comb(k, t2)
    rng = np.random.default_rng(k)
    left = _int_table(rng, plan.n_pad, jops.pad_to(a, 128), g.n)
    right = _int_table(rng, plan.n_pad, jops.pad_to(b, 128), g.n)
    want = np.asarray(fused_count_pallas(
        jplan.slab_dst, jplan.slab_cols, jnp.asarray(left), jnp.asarray(right),
        jt.idx1_t, jt.idx2_t, num_splits=jt.j, slabs_per_block=jplan.slabs_per_block,
        interpret=True,
    ))[: g.n, : jt.s]
    lt = torch.from_numpy(left[:, None, :a]).contiguous()
    rt = torch.from_numpy(right[:, None, :b]).contiguous()
    got = ops.fused_count(plan.indptr, plan.indices, lt, rt, tbl)[:, 0]
    np.testing.assert_array_equal(got[: g.n].numpy(), want)
    # and the unfused composition of the port's own ops, bitwise
    unfused = ops.color_combine(lt, ops.spmm(plan, rt), tbl)[:, 0]
    assert torch.equal(got, unfused)


def test_combine_tables_packing():
    tbl = ops.build_combine_tables(12, 3, 4, device=CPU)  # S = 792, J = 35
    assert (tbl.s, tbl.j, tbl.jp) == (792, 35, 36)
    assert tuple(tbl.pairs.shape) == (792, 36)
    p = tbl.pairs[:, : tbl.j]  # [S, J]
    assert torch.equal(p & 0xFFFF, tbl.idx1.int()) and torch.equal(p >> 16, tbl.idx2.int())
    assert not tbl.pairs[:, tbl.j:].any()
    root = ops.build_combine_tables(12, 4, 8, device=CPU)  # the u12-2 root: S = 1
    assert (root.s, root.j, root.jp) == (1, 495, 496)


#: node (A, W, S, J), batch (0: the combine) -> tile (rows, colorings, chunk,
#: CTAs an SM) on the H100
ROWS_PER_BLOCK = [
    ((12, 12, 66, 2), 0, (128, 1, 66, 4)),  # a chunk is the whole output row
    ((12, 66, 220, 3), 0, (64, 1, 110, 4)),
    ((12, 220, 495, 4), 0, (32, 1, 124, 4)),
    ((12, 792, 495, 8), 0, (16, 1, 124, 3)),  # u12-2's widest right child
    ((220, 495, 792, 35), 0, (32, 1, 32, 2)),  # 16 rows fit three CTAs, 32 rows two
    ((495, 495, 1, 495), 0, (16, 1, 1, 3)),  # the root
    ((12, 792, 495, 8), 4, (8, 4, 124, 5)),  # 2 whole vertices, four CTAs an SM or more
    ((495, 495, 1, 495), 3, (12, 3, 1, 4)),
    ((220, 495, 792, 35), 4, (8, 4, 61, 5)),
    ((495, 495, 1, 495), 4, (8, 4, 1, 5)),
    ((364, 3003, 2002, 84), 4, (4, 4, 63, 2)),  # u14's widest: one vertex
    ((1365, 1365, 1, 1365), 4, (4, 4, 1, 3)),  # u15-2's root
    ((455, 6435, 3003, 120), 1, (4, 1, 64, 1)),  # u15-2's widest: one CTA an SM
    ((455, 6435, 3003, 120), 9, (4, 4, 64, 1)),  # one vertex, colorings in groups of 4
]


@pytest.mark.parametrize("node,batch,want", ROWS_PER_BLOCK)
def test_rows_per_block(node, batch, want):
    a, w, s, j = node
    jp = ops.pad_to(j, 4)
    tile = plan_tile(a, w, s, jp, H100_SMEM, batch=batch)
    assert (tile.rows, tile.colorings, tile.chunk, tile.per_sm) == want
    kernel, static = ("fused", FUSED_STATIC_BYTES) if batch else ("combine", 0)
    assert tile.smem_bytes == tile_bytes(tile.rows, a, w, s, jp, kernel)
    assert tile.smem_bytes + static <= H100_SMEM.per_block
    assert tile.per_sm == H100_SMEM.per_sm // (tile.smem_bytes + static + H100_SMEM.reserved)


def test_rows_per_block_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        plan_tile(30_000, 30_000, 100, 4, H100_SMEM)
    with pytest.raises(ValueError):
        plan_tile(12, 100_000, 100, 4, H100_SMEM, batch=4)


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_rows_per_block_fits_every_template(name):
    """Every node of every named template (trees, and the treewidth-2 rows'
    bag nodes, whose collapses contract nothing) gets a tile of at least
    one row in the H100's 232,448 bytes, for the combine and for the fused
    kernel at B = 1, 4 and 16."""
    g = port_erdos_renyi(40, 4.0, seed=2)
    plan = build_counting_plan(g, template(name), device=CPU)
    contracting = [i for i, nd in plan.chain.internal_nodes() if nd.kind != "bag_collapse"]
    assert sorted(plan.combine) == contracting
    for tbl in plan.combine.values():
        for batch in (0, 1, 4, 16):
            tile = plan_tile(tbl.a, tbl.w, tbl.s, tbl.jp, H100_SMEM, batch=batch)
            static = FUSED_STATIC_BYTES if batch else 0
            assert tile.rows >= 1 and tile.smem_bytes + static <= 232_448 and tile.per_sm >= 1


@pytest.mark.parametrize("make_graph", [
    lambda: erdos_renyi(5000, 3.0, seed=2),  # sparse patches
    lambda: rmat(512, 30_000, skew=3, seed=1),  # dense patches
    lambda: rmat(300, 2000, skew=8, seed=3),
    lambda: erdos_renyi(90, 2.0, seed=9),  # one row block
], ids=["er-sparse", "rmat-dense", "rmat-skew", "er-small"])
def test_plan_kinds(make_graph):
    """The block layout holds the reference's patches: the same occupied
    (row block, column block) pairs in the same order, the same 0/1
    entries, the same written rows, the same measured density."""
    g = make_graph()
    rows, cols = edge_list(g)
    plan = ops.build_spmm_plan(rows, cols, g.n, kind="blocks", device=CPU)
    jplan = jops.build_spmm_plan(rows, cols, g.n, kind="blocks")
    assert plan.kind == jplan.kind == "blocks" and plan.n_pad == jplan.n_pad
    patch_row = np.repeat(np.arange(plan.n_pad // 128), np.diff(plan.patch_ptr.numpy()))
    np.testing.assert_array_equal(patch_row, np.asarray(jplan.block_rows)[:-1])  # [-1]: sentinel
    np.testing.assert_array_equal(plan.patch_col.numpy(), np.asarray(jplan.block_cols)[:-1])
    np.testing.assert_array_equal(ref.unpack_patches(plan.patch_bits).numpy(),
                                  np.asarray(jplan.patches)[:-1])
    written = np.repeat(np.diff(plan.patch_ptr.numpy()) > 0, 128)
    np.testing.assert_array_equal(written, np.asarray(jplan.written_mask))
    auto = ops.build_spmm_plan(rows, cols, g.n, kind="auto", device=CPU)
    jauto = jops.build_spmm_plan(rows, cols, g.n, kind="auto")
    assert auto.kind == jauto.kind
    assert auto.patch_density == jauto.patch_density
    assert ops.patch_density(rows, cols, plan.n_pad) == jauto.patch_density


def test_auto_picks_what_the_reference_picks():
    dense = rmat(512, 30_000, skew=3, seed=1)
    sparse = erdos_renyi(5000, 3.0, seed=2)
    assert _port_plan(dense, "auto").kind == "blocks"
    assert _port_plan(sparse, "auto").kind == "edges"
    assert ops.AUTO_DENSITY_THRESHOLD == jops.AUTO_DENSITY_THRESHOLD == 64.0
    for n, e in [(1000, 5000), (1 << 16, 29_426_902), (1 << 20, 19_985_166), (5, 0)]:
        assert ops.expected_patch_density(n, e) == jops.expected_patch_density(n, e)


def test_block_plan_refuses_duplicates_and_other_patch_sizes():
    rows = np.array([0, 0, 1], np.int32)
    with pytest.raises(ValueError, match="0/1"):
        ops.build_spmm_plan(rows, np.array([1, 1, 0], np.int32), 2, kind="blocks", device=CPU)
    with pytest.raises(ValueError, match="128x128"):
        Counter.from_graph(port_erdos_renyi(90, 2.0, seed=9), "u3-1", backend="single",
                           spmm_kind="blocks", block_size=64, device=CPU)


@pytest.mark.parametrize("n,deg,width", [(200, 6.0, 128), (500, 10.0, 256)])
def test_spmm_block_matches_pallas(n, deg, width):
    """The reference's block-kernel cases: the plain version == the Pallas
    kernel in interpret mode (masked by its written rows), == the port's
    edge path, and the block wrapper takes the plain version on the CPU."""
    g = rmat(n, int(n * deg / 2), skew=3, seed=n)
    rows, cols = edge_list(g)
    jplan = jops.build_spmm_plan(rows, cols, g.n, kind="blocks")
    plan = _port_plan(g, "blocks")
    table = _int_table(np.random.default_rng(1), plan.n_pad, width, g.n)
    want = spmm_block_pallas(jplan.block_rows, jplan.block_cols, jplan.patches,
                             jnp.asarray(table), num_row_blocks=plan.n_pad // 128,
                             interpret=True)[: plan.n_pad]
    want = np.asarray(jnp.where(jplan.written_mask[:, None], want, 0))
    t = torch.from_numpy(table).reshape(plan.n_pad, 2, width // 2)
    got = ref.spmm_block_ref(plan.patch_ptr, plan.patch_col, plan.patch_bits, t)
    np.testing.assert_array_equal(got.reshape(plan.n_pad, width).numpy(), want)
    assert torch.equal(ops.spmm(plan, t), got)
    assert torch.equal(ops.spmm(_port_plan(g), t), got)


def test_spmm_block_on_port_graphs():
    """The port's own graph generators give the same block layout and sums."""
    g = port_rmat(700, 20_000, skew=3, seed=8)
    plan = _port_plan(g, "auto")
    assert plan.kind == "blocks" and plan.num_patches > 1
    t = torch.from_numpy(_int_table(np.random.default_rng(3), plan.n_pad, 66, g.n)).reshape(
        plan.n_pad, 6, 11)
    assert torch.equal(ops.spmm(plan, t), ops.spmm(_port_plan(g), t))
    small = port_erdos_renyi(40, 4.0, seed=2)  # one patch
    assert _port_plan(small, "blocks").num_patches == 1


def test_plain_versions_chunk(monkeypatch):
    # a tiny element budget forces many chunks; results must not change
    g = rmat(200, 3000, skew=8, seed=3)
    plan = _port_plan(g)
    tbl = ops.build_combine_tables(7, 3, 2, device=CPU)
    rng = np.random.default_rng(0)
    left = torch.from_numpy(_int_table(rng, plan.n_pad, 2 * 35, g.n)).reshape(-1, 2, 35)
    right = torch.from_numpy(_int_table(rng, plan.n_pad, 2 * 21, g.n)).reshape(-1, 2, 21)
    m = ops.spmm(plan, right)
    whole = ops.color_combine(left, m, tbl)
    bplan = _port_plan(g, "blocks")
    monkeypatch.setattr(ref, "ELEMENT_BUDGET", 1000)
    assert torch.equal(ops.spmm(plan, right), m)
    assert torch.equal(ops.spmm(bplan, right), m)
    assert torch.equal(ops.color_combine(left, m, tbl), whole)
    assert torch.equal(
        ref.fused_count_ref(plan.indptr, plan.indices, left, right, tbl.idx1, tbl.idx2,
                            row_block=100), whole)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op allocates (views and
    in-place results share an input's storage and are not recorded)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        seen = {a.untyped_storage().data_ptr()
                for a in torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)}
        out = func(*args, **kwargs)
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
                self.shapes.append(tuple(t.shape))
        return out


def test_fused_never_materializes_m():
    """The plain fused version never produces a tensor with ``n_pad`` rows
    and the right child's full ``B * W`` width; the unfused path does
    (which also proves the detector works).  On the card, chip_smoke.py's
    peak-memory comparison is the same proof for the kernel."""
    g = erdos_renyi(5000, 3.0, seed=4)  # n_pad = 5120 > the 4096-row plain block
    plan = _port_plan(g)
    k, t1, t2, batch = 7, 2, 2, 2  # C(7,2) = 21 != C(7,4) = 35: W and S differ
    tbl = ops.build_combine_tables(k, t1, t2, device=CPU)
    w = math.comb(k, t2)
    rng = np.random.default_rng(0)
    left = torch.from_numpy(_int_table(rng, plan.n_pad, batch * w, g.n)).reshape(-1, batch, w)
    right = torch.from_numpy(_int_table(rng, plan.n_pad, batch * w, g.n)).reshape(-1, batch, w)
    forbidden = {(plan.n_pad, batch, w), (plan.n_pad, batch * w)}
    assert plan.num_directed != plan.n_pad  # an edge gather cannot look like M
    with _Shapes() as fused_mode:
        fused = ops.fused_count(plan.indptr, plan.indices, left, right, tbl)
    with _Shapes() as unfused_mode:
        unfused = ops.color_combine(left, ops.spmm(plan, right), tbl)
    assert forbidden & set(unfused_mode.shapes)  # detector sanity
    assert not forbidden & set(fused_mode.shapes)
    assert (plan.n_pad, batch, tbl.s) in fused_mode.shapes  # the fused output
    assert torch.equal(fused, unfused)


def test_wrappers_route_by_device():
    """A CPU tensor takes the plain version and launches nothing."""
    g = erdos_renyi(50, 3.0, seed=0)
    plan = _port_plan(g)
    tbl = ops.build_combine_tables(3, 1, 1, device=CPU)
    t = torch.ones(plan.n_pad, 1, 3)
    bplan = _port_plan(g, "blocks")
    counts = lambda: (spmm_edge_tile.launches, spmm_block.launches,  # noqa: E731
                      color_combine.launches, fused_count.launches)
    before = counts()
    ops.fused_count(plan.indptr, plan.indices, t, t, tbl)
    ops.color_combine(t, ops.spmm(plan, t), tbl)
    ops.spmm(bplan, t)
    assert counts() == before
