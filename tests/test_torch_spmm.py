"""The two SpMM kernels' plan-time data and schedules, on the CPU.

The block plan carries, beside the reference's patches, what the block
kernel reads: each patch's column union and its edges as staging slots.
Those are held here against the bitmasks (and the bitmasks against the
Pallas kernel's dense patches in test_torch_kernels.py).  No CUDA kernel
runs here, so the kernels' arithmetic is held instead: a torch emulation of
each kernel's schedule, adding in the order the kernel adds, on tables near
2^22 whose sums round, must equal the sequential float32 sum in CSR order
bitwise, and each other.  The kernels themselves are held to the same sums
on the card in test_torch_gpu.py and chip_smoke.py.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmat
from repro.core.graphs import edge_list
from repro.kernels import ops as jops
from repro.kernels.spmm_edgetile import spmm_edge_tile_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.spmm_block import TILE
from repro_torch.kernels.spmm_block import spmm_block
from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hub_graph(n=700, m=12_000, hub=3, seed=5):
    """R-MAT edges plus a hub joined to every other vertex (degree n - 1)."""
    rows, cols = edge_list(rmat(n, m, skew=3, seed=seed))
    extra = np.arange(n, dtype=rows.dtype)
    extra = extra[extra != hub]
    pairs = set(zip(rows.tolist(), cols.tolist()))
    pairs |= {(hub, int(v)) for v in extra} | {(int(v), hub) for v in extra}
    edges = np.array(sorted(pairs), dtype=np.int32)
    return edges[:, 0], edges[:, 1], n


GRAPHS = {
    "hub": _hub_graph,
    "rmat-dense": lambda: (*edge_list(rmat(512, 30_000, skew=3, seed=1)), 512),
    "rmat-skew": lambda: (*edge_list(rmat(300, 2000, skew=8, seed=3)), 300),
}


def _plan(name, kind="blocks"):
    rows, cols, n = GRAPHS[name]()
    return ops.build_spmm_plan(rows, cols, n, kind=kind, device=CPU), n


def _used_columns(plan):
    """[NB, 128] bool: source columns with a set bit in any row of the patch,
    from the dense 0/1 patches (independent of the plan's own unions)."""
    return ref.unpack_patches(plan.patch_bits).amax(dim=1).bool()


def _near_2_22(n_pad, batch, width, n_valid, seed=0):
    t = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1024, (n_pad, batch, width)).astype(np.float32)) + 2.0 ** 22
    t[n_valid:] = 0
    return t


@pytest.mark.parametrize("name", list(GRAPHS))
def test_patch_union_is_the_or_of_rows(name):
    plan, _ = _plan(name)
    union = ref.unpack_patches(plan.patch_union[:, None, :])[:, 0].bool()
    assert torch.equal(union, _used_columns(plan))
    used = ops.popcount32(plan.patch_union.numpy()).sum(axis=1)
    assert plan.patch_max_used == used.max() <= 128
    # the total is the count chip_smoke.py reports as staged source rows
    assert _chip_smoke().used_source_rows(plan) == int(_used_columns(plan).sum()) == used.sum()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_slots_are_one_to_one_and_in_csr_order(name):
    """The slot of a used column is the popcount of the union's bits below
    it: one to one onto 0..n_used - 1, below n_used.  The slot lists hold,
    row by row, the slot of each edge in CSR order."""
    plan, _ = _plan(name)
    used = _used_columns(plan)
    dense = ref.unpack_patches(plan.patch_bits).bool()
    offs, slots, ptr = plan.patch_offs.long(), plan.patch_slots.long(), plan.patch_slots_ptr
    assert plan.patch_offs.dtype == torch.int16 and plan.patch_slots.dtype == torch.uint8
    assert plan.patch_offs.shape[1] == ops.PATCH_OFFS and plan.patch_offs.numel() * 2 % 16 == 0
    assert (ptr % 16 == 0).all() and int(torch.diff(ptr).max()) == plan.patch_max_slots
    for p in range(plan.num_patches):
        cols = torch.nonzero(used[p])[:, 0]
        slot_of = torch.full((128,), -1, dtype=torch.long)
        slot_of[cols] = torch.cumsum(used[p].long(), 0)[cols] - 1
        assert sorted(slot_of[cols].tolist()) == list(range(len(cols)))  # one to one
        r, k = torch.nonzero(dense[p], as_tuple=True)  # row-major: CSR order in the patch
        n_edges = len(r)
        assert int(offs[p, 128]) == n_edges and (offs[p, 129:] == n_edges).all()
        assert torch.equal(offs[p, :129], torch.searchsorted(r, torch.arange(129)))
        lst = slots[int(ptr[p]): int(ptr[p]) + n_edges]
        assert torch.equal(lst, slot_of[k]) and (lst < len(cols)).all()
        assert not slots[int(ptr[p]) + n_edges: int(ptr[p + 1])].any()  # zero padding


def test_edge_plans_carry_no_block_layout():
    plan, _ = _plan("rmat-skew", "edges")
    assert plan.patch_union is None and plan.patch_slots is None and plan.patch_max_used == 0


def emulate_edge_kernel(indptr, indices, table, chunk=128, batch=8):
    """spmm_edgetile's schedule: per (row, 128-float chunk), lanes of four
    consecutive columns (one column each, 32 apart, when the row is not a
    multiple of 4), index tiles of 32, eight gathers, then their eight adds
    in CSR order.  All rows run in lockstep, each masked past its degree."""
    n = indptr.numel() - 1
    flat = table.reshape(table.shape[0], -1)
    f = flat.shape[1]
    deg = torch.diff(indptr)
    out = torch.empty(n, f)
    vec = f % 4 == 0
    for c0 in range(0, f, chunk):
        ncols = min(chunk, f - c0)
        lanes = torch.arange(32)
        cols = (4 * lanes[:, None] + torch.arange(4) if vec
                else lanes[:, None] + 32 * torch.arange(4))  # [lane, 4]
        active = cols < ncols
        cols = torch.where(active, cols, 0) + c0
        acc = torch.zeros(n, 32, 4)
        for e0 in range(0, int(deg.max()), 32):
            n_tile = (deg - e0).clamp(0, 32)
            for i in range(0, 32, batch):
                xs = []
                for j in range(batch):
                    walks = n_tile > i + j
                    u = indices[(indptr[:-1] + e0 + i + j).clamp(max=indices.numel() - 1)].long()
                    x = flat[u][:, cols] * active
                    xs.append((walks, x))
                for walks, x in xs:
                    acc[walks] = acc[walks] + x[walks]
        got = acc.reshape(n, -1)[:, active.reshape(-1)]
        order = torch.argsort(cols.reshape(-1)[active.reshape(-1)])
        out[:, c0:c0 + ncols] = got[:, order]
    return out.reshape((n,) + tuple(table.shape[1:]))


def emulate_block_kernel(plan, table):
    """spmm_block's schedule: per (row block, 128-float tile), the patches in
    ascending column block; each stages its used source rows packed by slot
    (the union's bits in ascending column), then every destination row adds
    the staged rows of its edges in list order into an accumulator that lives
    across the row block's patches."""
    flat = table.reshape(table.shape[0], -1)
    f = flat.shape[1]
    out = torch.zeros(table.shape[0], f)
    ptr = plan.patch_ptr.long()
    used = ref.unpack_patches(plan.patch_union[:, None, :])[:, 0].bool()
    for c0 in range(0, f, TILE):
        tile = flat[:, c0:c0 + TILE]
        for rb in range(ptr.numel() - 1):
            acc = torch.zeros(128, tile.shape[1])
            for p in range(int(ptr[rb]), int(ptr[rb + 1])):
                stage = tile[128 * int(plan.patch_col[p]) + torch.nonzero(used[p])[:, 0]]
                offs = plan.patch_offs[p].long()
                lst = plan.patch_slots[int(plan.patch_slots_ptr[p]):].long()
                for r in range(128):
                    for e in range(int(offs[r]), int(offs[r + 1])):
                        acc[r] = acc[r] + stage[lst[e]]
            out[128 * rb:128 * rb + 128, c0:c0 + TILE] = acc
    return out.reshape(table.shape)


def _reverse_csr_sum(plan, table):
    """The same neighbor sum, added in descending CSR order."""
    rev = torch.cat([plan.indices[int(a):int(b)].flip(0)
                     for a, b in zip(plan.indptr[:-1], plan.indptr[1:])])
    return ref.spmm_csr_order_ref(plan.indptr, rev, table)


@pytest.mark.parametrize("batch,width", [(2, 66), (1, 3), (3, 50)])
def test_edge_schedule_sums_in_csr_order(batch, width):
    """float4 lanes (B * W = 132, 150: multiples of 4, partial chunks) and the
    scalar lanes (B * W = 3), on a graph with a hub row of degree 699."""
    plan, n = _plan("hub", "edges")
    t = _near_2_22(plan.n_pad, batch, width, n)
    want = ref.spmm_csr_order_ref(plan.indptr, plan.indices, t)
    assert not torch.equal(_reverse_csr_sum(plan, t), want)  # the data shows the order
    assert torch.equal(emulate_edge_kernel(plan.indptr, plan.indices, t), want)


@pytest.mark.parametrize("name", ["hub", "rmat-dense"])
def test_block_schedule_sums_in_csr_order(name):
    """The block kernel's schedule == the sequential CSR-order sum == the
    edge kernel's schedule, bitwise, with a tile past one 128-float tile."""
    plan, n = _plan(name)
    t = _near_2_22(plan.n_pad, 2, 70, n, seed=1)
    want = ref.spmm_csr_order_ref(plan.indptr, plan.indices, t)
    assert not torch.equal(_reverse_csr_sum(plan, t), want)
    got = emulate_block_kernel(plan, t)
    assert torch.equal(got, want)
    assert torch.equal(got, emulate_edge_kernel(plan.indptr, plan.indices, t))


def test_plain_versions_and_order_on_the_cpu():
    """On the CPU the wrappers run the plain versions.  ``spmm_segment_ref``
    (``index_add_``) walks the edge index in order there, so it is order-exact
    on the CPU and equals the CSR-order sum bitwise; on the card it adds with
    atomics and is not (chip_smoke.py logs which).  The block plain version
    multiplies dense 0/1 patches, whose sums take another order, so it holds
    only on tables whose sums stay exact."""
    plan, n = _plan("hub")
    t = _near_2_22(plan.n_pad, 2, 66, n)
    want = ref.spmm_csr_order_ref(plan.indptr, plan.indices, t)
    assert torch.equal(ref.spmm_segment_ref(plan.indptr, plan.indices, t), want)
    assert torch.equal(spmm_edge_tile(plan.indptr, plan.indices, t), want)
    ints = torch.randint(0, 4, t.shape, generator=torch.Generator().manual_seed(0)).float()
    ints[n:] = 0
    assert torch.equal(spmm_block(plan, ints), ref.spmm_csr_order_ref(plan.indptr, plan.indices,
                                                                       ints))


def test_csr_order_sum_matches_pallas():
    """The sequential CSR-order sum computes the reference's neighbor sum:
    == spmm_edge_tile_pallas (interpret mode) on integer tables."""
    g = rmat(200, 3000, skew=8, seed=3)
    jplan = jops.build_spmm_plan(*edge_list(g), g.n, kind="edges", tile_size=64)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=CPU)
    table = np.random.default_rng(2).integers(0, 4, (plan.n_pad, 128)).astype(np.float32)
    table[g.n:] = 0
    want = np.asarray(spmm_edge_tile_pallas(jplan.slab_dst, jplan.slab_cols, jnp.asarray(table),
                                            slabs_per_block=jplan.slabs_per_block, interpret=True))
    got = ref.spmm_csr_order_ref(plan.indptr, plan.indices, torch.from_numpy(table)[:, None])
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
