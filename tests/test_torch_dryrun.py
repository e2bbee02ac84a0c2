"""The counting dry-run on the CPU, against the JAX reference.

* ``abstract_compaction`` == the reference's, field by field, with split
  tables (the sampled probe) and without (the Markov bound);
* ``abstract_plan`` == the reference's for every ``COUNTING_CONFIGS`` row
  and both ``compact_requests``: every scalar, every per-rank array shape
  (the reference's less its leading shard axis; a CSR holds as many edges
  as the array it stands for has slots), the widths (the reference's at
  true width) and the split tables;
* one rank's program on ``meta`` (``measure_rank``) == rank 0 of a real
  ``LocalMesh`` CPU run of the same plan: the kernel launches by name and
  shape, and the all-to-all and collective-permute bytes == what rank 0
  sends == ``node_exchange_bytes`` summed over the exchanged nodes
  (bench-small every mode x fuse; bench-sparse compacted at float32 and
  int16);
* fused temporaries below unfused at u12-2's shapes, and by exactly ``M``
  on a program of one combine;
* ``_compaction_report`` and ``routing`` == the reference's on the same
  shapes; the kernels' shape-only branches; ``make_production_mesh``.
"""

import dataclasses
import json
import os
import threading
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from repro.configs import COUNTING_CONFIGS as REF_CONFIGS
from repro.core import distributed as ref_dist
from repro.core import frontier as ref_frontier
from repro.core import table_program as ref_tp
from repro.core import templates as ref_templates
from repro_torch.comm import AbstractGroup, AbstractMesh, LocalMesh, group as group_mod
from repro_torch.configs.subgraph import COUNTING_CONFIGS
from repro_torch.core import frontier, templates
from repro_torch.core.distributed import (
    _exchange_nodes,
    _resolve_program,
    abstract_plan,
    build_distributed_plan,
    make_count_fn,
    node_exchange_bytes,
    plan_route_report,
)
from repro_torch.core.table_program import build_node_tables
from repro_torch.kernels import color_combine as cc_mod
from repro_torch.kernels import fused_count as fc_mod
from repro_torch.kernels import ops, work
from repro_torch.kernels import spmm_edgetile as se_mod
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

ROWS = sorted(COUNTING_CONFIGS)
CPU = torch.device("cpu")


def _trees(row):
    """The row's template (or family) in both packages."""
    c = COUNTING_CONFIGS[row]
    if c.templates:
        return ([templates.template(t) for t in c.templates],
                [ref_templates.template(t) for t in c.templates])
    return templates.template(c.template), ref_templates.template(c.template)


def _mode(row):
    return COUNTING_CONFIGS[row].mode


@lru_cache(maxsize=None)
def _plans(row, compact_requests):
    c = COUNTING_CONFIGS[row]
    mine_t, ref_t = _trees(row)
    kw = dict(compact_requests=compact_requests, compact=c.compact,
              density_threshold=c.density_threshold, capacity_factor=c.capacity_factor)
    return (abstract_plan(c.num_vertices, c.num_edges, mine_t, c.num_shards, **kw),
            ref_dist.abstract_plan(c.num_vertices, c.num_edges, ref_t, c.num_shards, **kw))


def _ref_dryrun():
    """The reference's dry-run module, imported without letting its
    512-device ``XLA_FLAGS`` reach this process's JAX (started first)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _spec_fields(spec):
    return {f: getattr(spec, f) for f in ("threshold", "capacity_factor", "density",
                                          "gather_density", "table_caps", "combine_caps",
                                          "exchange_caps", "shard_caps")}


def test_rows_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in COUNTING_CONFIGS.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_CONFIGS.items()}


# ---------------------------------------------------------------------------
# shape-only plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", ["rmat-sparse-u10-2", "bench-sparse", "rmat500-u12-2",
                                 "rmat500-family"])
@pytest.mark.parametrize("tables", [True, False], ids=["sampled", "markov"])
def test_abstract_compaction_equals_reference(row, tables):
    c = COUNTING_CONFIGS[row]
    mine_t, ref_t = _trees(row)
    mine_p, _, k = _resolve_program(mine_t, 0, None)
    ref_p, _, ref_k = ref_dist._resolve_program(ref_t, 0, None)
    assert k == ref_k
    avg = 2.0 * c.num_edges / c.num_vertices
    shapes = dict(r_pad=1664, n_loc_pad=c.num_vertices // 16 + 128,
                  threshold=max(c.density_threshold, 0.5), capacity_factor=c.capacity_factor)
    mine = frontier.abstract_compaction(
        c.num_vertices, avg, mine_p, k,
        combine=build_node_tables(mine_p, k, device=CPU)[0] if tables else None, **shapes)
    ref = ref_frontier.abstract_compaction(
        c.num_vertices, avg, ref_p, k,
        combine=ref_tp.build_node_tables(ref_p, k, lane=1)[0] if tables else None, **shapes)
    assert _spec_fields(mine) == _spec_fields(ref)


@pytest.mark.parametrize("compact_requests", [True, False], ids=["requests", "ring"])
@pytest.mark.parametrize("row", ROWS)
def test_abstract_plan_equals_reference(row, compact_requests):
    mine, ref = _plans(row, compact_requests)
    Pn = ref.num_shards
    for f in ("k", "n", "num_shards", "shard_size", "n_loc_pad", "r_pad", "bucket_tile",
              "num_tiles", "slabs_per_block", "auts"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.device.type == "meta" and len(mine.shards) == Pn
    sh = mine.shards[0]
    per_rank = lambda a: tuple(a.shape[1:])  # noqa: E731
    assert tuple(sh.send_idx.shape) == per_rank(ref.send_idx)
    assert tuple(mine.send_idx.shape) == tuple(ref.send_idx.shape)
    # each CSR holds as many edges as the array it stands for has slots
    assert sh.buckets.indices[0].numel() == np.prod(per_rank(ref.tile_src_compact))
    assert sh.buckets.indices[1].numel() == np.prod(per_rank(ref.tile_src_local))
    assert sh.a2a.indices.numel() == sh.a2a.edges == np.prod(per_rank(ref.a2a_slab_cols))
    assert tuple(sh.buckets.indptr.shape) == (Pn, mine.n_loc_pad + 1)
    assert sum(sh.buckets.edges) == np.prod(per_rank(ref.tile_dst)) == ref.num_tiles * 128
    assert int(mine.bucket_counts.sum()) // Pn == ref.num_tiles * ref.bucket_tile
    if ref.pin_adj is None:
        assert sh.pin_adj is None
    else:
        assert tuple(sh.pin_adj.shape) == per_rank(ref.pin_adj)
    assert all(t.device.type == "meta" for t in (sh.send_idx, sh.a2a.indices, sh.buckets.indptr))
    # widths: the reference's at true width (its plan pads them to 128 lanes)
    x = mine.n if mine.has_bags else None
    true_ref = ref_tp.build_node_tables(ref.program, ref.k, lane=1, x_dim=x)
    assert mine.widths == true_ref[1]
    # split tables: meta on the plan, their shapes and the host copies' values exact
    host = build_node_tables(mine.program, mine.k, device=CPU, x_dim=x)[0]
    assert sorted(mine.combine) == sorted(ref.combine) == sorted(host)
    for i, tbl in mine.combine.items():
        r = ref.combine[i]
        assert tbl.idx1.device.type == "meta" and (tbl.s, tbl.j) == (r.s, r.j)
        assert tuple(tbl.idx1.shape) == tuple(r.idx1.shape) == tuple(host[i].idx1.shape)
        np.testing.assert_array_equal(host[i].idx1.numpy(), np.asarray(r.idx1))
        np.testing.assert_array_equal(host[i].idx2.numpy(), np.asarray(r.idx2))
    if ref.compaction is None:
        assert mine.compaction is None
    else:
        assert _spec_fields(mine.compaction) == _spec_fields(ref.compaction)


@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("row", ROWS)
def test_compaction_report_and_routing_equal_reference(row, wire):
    """On the same shapes: the reference's plan with the port's true widths
    (its own are padded to 128 lanes, which the port's wire never ships)."""
    mode = _mode(row)
    mine, ref = _plans(row, mode != "ring")
    ref = dataclasses.replace(ref, widths=dict(mine.widths))
    gf = COUNTING_CONFIGS[row].group_factor
    ref_mod = _ref_dryrun()
    assert dryrun._compaction_report(mine, mode, wire) == ref_mod._compaction_report(ref, mode,
                                                                                     wire)
    assert plan_route_report(mine, mode=mode, group_factor=gf, wire_dtype=wire) == \
        ref_dist.plan_route_report(ref, mode=mode, group_factor=gf, wire_dtype=wire)


# ---------------------------------------------------------------------------
# one rank on meta against a real LocalMesh run
# ---------------------------------------------------------------------------

BENCH_SMALL = [(m, gf, fuse, "float32") for m, gf in (("alltoall", 1), ("pipeline", 1),
                                                       ("pipeline", 3), ("adaptive", 1),
                                                       ("ring", 1))
               for fuse in (False, True)]
BENCH_SPARSE = [(m, 1, fuse, wire) for m in ("alltoall", "pipeline", "ring")
                for wire in ("float32", "int16") for fuse in (False, True)]
BATCH = 2


@lru_cache(maxsize=None)
def _real_plan(row):
    c = COUNTING_CONFIGS[row]
    g = c.synthesize()
    return g, build_distributed_plan(g, templates.template(c.template), c.num_shards,
                                     device="cpu", compact=c.compact,
                                     density_threshold=c.density_threshold,
                                     capacity_factor=c.capacity_factor)


@lru_cache(maxsize=None)
def _runs(row, mode, gf, fuse, wire):
    """Rank 0's launches and sent bytes in a LocalMesh CPU run of the raw
    program, and the meta run of the same plan with its launches."""
    g, plan = _real_plan(row)
    kw = dict(mode=mode, group_factor=gf, fuse=fuse, wire_dtype=wire)
    P = plan.num_shards
    with work.LaunchLog() as log:
        meta = dryrun.measure_rank(plan.to("meta"), AbstractMesh(P), batch=BATCH, **kw)
    rng = np.random.default_rng(5)
    cols = torch.from_numpy(rng.integers(0, plan.k, (P, BATCH, plan.n_loc_pad)).astype(np.int32))
    mesh = LocalMesh(P, device="cpu")
    program, structs = make_count_fn(plan, mesh, return_raw=True, **kw)
    assert tuple(structs[0].shape) == (1, plan.n_loc_pad)
    sent = {"all-to-all": 0.0, "collective-permute": 0.0}
    seen = []
    lock = threading.Lock()
    a2a, shift = group_mod.LocalGroup.all_to_all, group_mod.LocalGroup.shift_start

    def rank0():
        return threading.current_thread().name.endswith("(0, 0)")

    def all_to_all(self, chunks):
        if rank0():
            sent["all-to-all"] += chunks.numel() * chunks.element_size() * (self.size - 1) \
                / self.size
        return a2a(self, chunks)

    def shift_start(self, x, s):
        if rank0() and s % self.size:
            sent["collective-permute"] += x.numel() * x.element_size()
        return shift(self, x, s)

    def shapes_of(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if rank0():
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                with lock:
                    seen.append((name, work.launch_shapes(*tensors, out)))
            return out

        return wrapped

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(group_mod.LocalGroup, "all_to_all", all_to_all)
        mp.setattr(group_mod.LocalGroup, "shift_start", shift_start)
        for name, attr in (("spmm_edgetile", "spmm_edge_tile"), ("fused_count", "fused_count"),
                           ("color_combine", "color_combine")):
            mp.setattr(ops, attr, shapes_of(name, getattr(ops, attr)))
        out = mesh.run(lambda ctx: program(ctx, cols[ctx.data.rank]))
    finally:
        mp.undo()
    assert all(torch.isfinite(o).all() and o.shape == (BATCH, 2 if plan.compaction is not None
                                                       or wire != "float32" else 1)
               for o in out)
    return plan, seen, sent, meta, log


def _cases():
    return ([("bench-small",) + c for c in BENCH_SMALL]
            + [("bench-sparse",) + c for c in BENCH_SPARSE])


@pytest.mark.parametrize("row,mode,gf,fuse,wire", _cases(),
                         ids=[f"{r}-{m}-g{g}-{'fused' if f else 'unfused'}-{w}"
                              for r, m, g, f, w in _cases()])
def test_meta_launches_equal_local_mesh_rank0(row, mode, gf, fuse, wire):
    plan, real, _, meta, log = _runs(row, mode, gf, fuse, wire)
    got = [(launch.name, launch.shapes) for launch in log.launches]
    assert got == real and got
    assert meta["launches"] == {n: sum(1 for m, _ in real if m == n) for n, _ in real}
    # the work the meta branch recorded is the work of those shapes
    for launch in log.launches:
        assert launch.work.bytes > 0
    if plan.compaction is not None and mode == "ring":
        # the compacted relay really ran
        assert any(nd.right in plan.compaction.shard_caps
                   for i, nd in enumerate(plan.program.nodes) if not nd.is_leaf)


@pytest.mark.parametrize("row,mode,gf,fuse,wire", _cases(),
                         ids=[f"{r}-{m}-g{g}-{'fused' if f else 'unfused'}-{w}"
                              for r, m, g, f, w in _cases()])
def test_meta_collective_bytes_equal_sent_and_node_exchange_bytes(row, mode, gf, fuse, wire):
    plan, _, sent, meta, _ = _runs(row, mode, gf, fuse, wire)
    coll = meta["collectives"]
    assert coll["all-to-all"] == sent["all-to-all"]
    assert coll["collective-permute"] == sent["collective-permute"]
    f = make_count_fn(plan, LocalMesh(plan.num_shards, device="cpu"), mode=mode,
                      group_factor=gf, wire_dtype=wire)
    want = sum(node_exchange_bytes(plan, i, f.node_modes[i], wire)[1] for i in _exchange_nodes(plan))
    assert coll["all-to-all"] + coll["collective-permute"] == BATCH * want > 0


@pytest.mark.parametrize("mode,P", [("alltoall", 1), ("pipeline", 1), ("ring", 1),
                                    ("pipeline", 16), ("ring", 16)])
def test_fused_temporaries_below_unfused(mode, P):
    """At rmat500-u12-2's shapes the fused program holds less: no node's
    neighbor sum ``M``.  (It saves less than the widest ``M``, 15.8 GB at
    P = 1: the fused program peaks at another node, and an incremental
    fused consume holds its chunk's ``[rows, B, S]`` part beside the
    accumulator.  At P = 16 alltoall both peak at the exchange buffers.)"""
    c = COUNTING_CONFIGS["rmat500-u12-2"]
    plan = abstract_plan(c.num_vertices, c.num_edges, templates.template(c.template), P,
                         compact_requests=mode != "ring")
    temp = {fuse: dryrun.measure_rank(plan, AbstractMesh(P), mode=mode,
                                      fuse=fuse)["memory"]["temp_bytes"]
            for fuse in (False, True)}
    assert temp[True] < temp[False]


@pytest.mark.parametrize("mode", ["alltoall", "ring"])
def test_fused_one_node_program_saves_its_m(mode):
    """A program of one combine at world size 1: fused temporaries are the
    unfused ones less ``M``, ``rows B W 4`` bytes, to a few allocator
    granules (the float64 root sums).  (Pipeline's local chunk, a copy of
    the right table, sits beside the fused part and sets its peak.)"""
    plan = abstract_plan(3_000_000, 30_000_000, templates.path_tree(2), 1, n_colors=8,
                         compact_requests=mode != "ring")
    (i,) = _exchange_nodes(plan)
    m_bytes = plan.n_loc_pad * 2 * plan.widths[plan.program.nodes[i].right] * 4
    temp = {fuse: dryrun.measure_rank(plan, AbstractMesh(1), batch=2, mode=mode,
                                      fuse=fuse)["memory"]["temp_bytes"]
            for fuse in (False, True)}
    assert abs(temp[False] - temp[True] - dryrun.granule_bytes(m_bytes)) <= 4 * dryrun.ALLOC_GRANULE


def test_meta_run_touches_no_device_and_counts_no_launch():
    c = COUNTING_CONFIGS["bench-small"]
    plan = abstract_plan(c.num_vertices, c.num_edges, templates.template(c.template), 8)
    before = {f: f.launches for f in (se_mod.spmm_edge_tile, cc_mod.color_combine,
                                      fc_mod.fused_count)}
    rec = dryrun.measure_rank(plan, AbstractMesh(8, 32), mode="alltoall", fuse=True)
    assert rec["launches"] == {"fused_count": 4}
    assert {f: f.launches for f in before} == before
    mem = rec["memory"]
    assert mem["argument_bytes"] > mem["shared_bytes"] > 0 and mem["output_bytes"] == 512
    # held between ops: at most the peak, and at least the output kept at the end
    assert mem["output_bytes"] <= mem["settled_bytes"] <= mem["temp_bytes"] + mem["output_bytes"]
    assert rec["cost"]["fp32_ops"] > 0 and rec["cost"]["bytes_accessed"] > rec["cost"][
        "kernel_bytes"] > 0


# ---------------------------------------------------------------------------
# the kernels' shape-only branches, the abstract group, the production mesh
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_meta_branches_allocate_the_cuda_outputs_and_record_work():
    tbl = ops.build_combine_tables(8, 3, 2, device=torch.device("meta"))
    rows, src, b, e = 300, 500, 2, 4096
    indptr, indices = _meta(rows + 1, dtype=torch.int64), _meta(e, dtype=torch.int32)
    left, right = _meta(rows, b, tbl.a), _meta(src, b, tbl.w)
    with work.LaunchLog() as log, dryrun.LiveBytes([indptr, indices, left, right, tbl.pairs]) \
            as live:
        m = se_mod.spmm_edge_tile(indptr, indices, right, edges=1000)
        out = cc_mod.color_combine(left, _meta(rows, b, tbl.w), tbl)
        fused = fc_mod.fused_count(indptr, indices, left, right, tbl)
    assert tuple(m.shape) == (rows, b, tbl.w) and m.device.type == "meta"
    assert tuple(out.shape) == tuple(fused.shape) == (rows, b, tbl.s)
    names = [launch.name for launch in log.launches]
    assert names == ["spmm_edgetile", "color_combine", "fused_count"]
    assert log.launches[0].work == work.spmm_edge(rows, src, 1000, b * tbl.w)
    assert log.launches[1].work == work.color_combine(rows * b, tbl.a, tbl.w, tbl.s, tbl.j,
                                                      tbl.jp)
    assert log.launches[2].work == work.fused_count(rows, src, e, b, tbl.a, tbl.w, tbl.s,
                                                    tbl.j, tbl.jp)
    g = dryrun.granule_bytes
    assert live.peak == g(m.numel() * 4) + g(out.numel() * 4) + g(fused.numel() * 4)
    with pytest.raises(ValueError, match="contiguous float32"):
        se_mod.spmm_edge_tile(indptr, indices, right.double())
    with pytest.raises(ValueError, match="contiguous torch.int32"):
        fc_mod.fused_count(indptr, indices.long(), left, right, tbl)
    with pytest.raises(ValueError, match="do not fit"):
        cc_mod.color_combine(left, _meta(rows, b, tbl.w + 1), tbl)


def test_fused_meta_branch_holds_no_m():
    tbl = ops.build_combine_tables(12, 6, 6, device=torch.device("meta"))
    rows, b = 4096, 4
    indptr, indices = _meta(rows + 1, dtype=torch.int64), _meta(50_000, dtype=torch.int32)
    left, right = _meta(rows, b, tbl.a), _meta(rows, b, tbl.w)
    with dryrun.LiveBytes([indptr, indices, left, right, tbl.pairs]) as live:
        out = fc_mod.fused_count(indptr, indices, left, right, tbl)
    assert live.peak == dryrun.granule_bytes(out.numel() * 4)
    assert cc_mod.device_smem_limits(torch.device("meta")) == cc_mod.H100_SMEM


def test_abstract_group_ring_model():
    led = AbstractGroup(4).ledger
    grp = AbstractGroup(4, 1, led)
    x = _meta(4, 10, 3)
    assert tuple(grp.all_to_all(x).shape) == (4, 10, 3)
    assert tuple(grp.shift_start(x[0], 1).wait().shape) == (10, 3)
    grp.shift(x[0], 4)  # to itself: no transfer
    assert tuple(grp.all_gather(x[0]).shape) == (4, 10, 3)
    grp.all_reduce_sum(x[0])
    grp.barrier()
    assert led.bytes == {"all-gather": 480 * 3 / 4, "all-reduce": 2 * 120 * 3 / 4,
                         "reduce-scatter": 0.0, "all-to-all": 480 * 3 / 4,
                         "collective-permute": 120}
    assert led.ops["collective-permute"] == 1
    solo = AbstractGroup(1)
    solo.all_to_all(x[:1])
    solo.all_reduce_sum(x)
    assert solo.ledger.as_dict()["ops"] == dict.fromkeys(led.ops, 0)
    with pytest.raises(ValueError, match=r"\[P=4"):
        grp.all_to_all(x[:3])
    with pytest.raises(ValueError, match="meta device"):
        AbstractMesh(2, device="cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.device.type == "meta" and mesh.data_size == 16
    assert mesh.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert mesh.shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert mesh.size == (512 if multi_pod else 256) and mesh.iter_size == mesh.size // 16
    got = mesh.run(lambda ctx: (ctx.data.size, ctx.iters.size, ctx.device.type))
    assert got == [(16, mesh.iter_size, "meta")]


def test_lm_dryrun_waits_for_items_16_and_17(monkeypatch, capsys):
    """The LM dry-run is ported: ``--arch A --shape S`` prints one ``ok``
    record, and ``--all`` (over two rows and three shapes here) one record
    a cell, the skips the reference's, and its summary line."""
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--multi-pod"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "2x16x16", 512)
    monkeypatch.setattr(dryrun, "ARCHS", {k: dryrun.ARCHS[k] for k in ("smollm-360m",
                                                                       "whisper-base")})
    monkeypatch.setattr(dryrun, "SHAPES", {k: dryrun.SHAPES[k] for k in ("prefill_32k",
                                                                         "decode_32k",
                                                                         "long_500k")})
    assert dryrun.main(["--all"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(x) for x in lines[:-1]]
    assert lines[-1] == "# dry-run summary: 4 ok, 2 skipped, 0 errors"
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        (a, sh, "skipped" if sh == "long_500k" else "ok")
        for a in ("smollm-360m", "whisper-base") for sh in ("prefill_32k", "decode_32k",
                                                           "long_500k")]
