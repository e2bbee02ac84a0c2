"""The port's distributed engine on the CPU, against the JAX reference.

* plans: ``build_distributed_plan`` against the reference's on one device
  (the plan is host arrays): the same ``shard_size``, ``n_loc_pad``,
  ``r_pad``, ``send_idx`` and ``bucket_counts``, and each bucket's multiset
  of (dst, request slot) and (dst, shard row) pairs == the reference's
  tiles', the alltoall CSR's (dst, column) == its slabs';
* counts: every mode (``alltoall``, ``pipeline`` at g 1 and 3,
  ``adaptive``, ``ring``) x fuse x P in {1, 4, 8} x I in {1, 2} x {p4,
  sp21, u5-2} on a fixed coloring of the reference worker's graph ==
  brute force and == the reference's single-device count; families and
  treewidth-2 rows == brute force and the port's single-device counts;
* keyed colorings: ``global_coloring`` == ``jax.random.randint``, the
  samples of P = 1 == P = 8 == the reference's keyed sampler;
* the reference's own distributed engine on 8 forced host devices (a
  subprocess) == the port's ``LocalMesh`` P = 8, and 4 gloo processes
  through ``ProcessGroupComm`` == ``LocalMesh`` P = 4;
* ``Counter(backend="distributed")``, ``with_options``, the launcher's
  ``--mode``, the routing report, and the surfaces left to ROADMAP items
  7 and 9.

The sums of these small graphs stay far below 2^24, so every comparison
of counts is ``==``.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_engine as ref_engine
from repro.core import distributed as ref_dist
from repro.core import graphs as ref_graphs
from repro.core import templates as ref_templates
from repro_torch.api import Counter
from repro_torch.comm import LocalMesh, V5E_ICI, choose_mode_full
from repro_torch.core import prng
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import build_multi_counting_plan, colorful_map_count_many
from repro_torch.core.distributed import (
    abstract_plan,
    build_distributed_plan,
    global_coloring,
    keyed_sample_fn,
    make_count_fn,
    node_exchange_bytes,
    plan_route_report,
    shard_coloring,
)
from repro_torch.core.graphs import erdos_renyi, rmat
from repro_torch.core.templates import path_tree, spider_tree, template
from repro_torch.launch import count as launch_count

ROOT = Path(__file__).resolve().parents[1]
MODES = [("alltoall", 1), ("pipeline", 1), ("pipeline", 3), ("adaptive", 1), ("ring", 1)]
TREES = {"p4": (lambda: path_tree(4), lambda: ref_templates.path_tree(4)),
         "sp21": (lambda: spider_tree([2, 1]), lambda: ref_templates.spider_tree([2, 1])),
         "u5-2": (lambda: template("u5-2"), lambda: ref_templates.template("u5-2"))}


@lru_cache(maxsize=None)
def _graphs(name):
    """The port's graph and the reference's, built alike (and checked equal)."""
    if name == "er97":
        g, r = erdos_renyi(97, 5.0, seed=7), ref_graphs.erdos_renyi(97, 5.0, seed=7)
    else:  # the reference worker's skew-8 R-MAT (contiguous shards: heavy skew)
        g, r = rmat(1024, 12_000, skew=8, seed=2), ref_graphs.rmat(1024, 12_000, skew=8, seed=2)
    assert np.array_equal(g.indptr, r.indptr) and np.array_equal(g.indices, r.indices)
    return g, r


@lru_cache(maxsize=None)
def _plan(graph, tname, P):
    return build_distributed_plan(_graphs(graph)[0], TREES[tname][0](), P, device="cpu")


@lru_cache(maxsize=None)
def _coloring(graph, tname):
    """A fixed coloring, its brute-force count and the reference's
    single-device count."""
    g, r = _graphs(graph)
    k = TREES[tname][0]().n
    col = np.random.default_rng(3).integers(0, k, g.n).astype(np.int32)
    want = count_colorful_maps(g, TREES[tname][0](), col)
    rplan = ref_engine.build_counting_plan(r, TREES[tname][1]())
    padded = np.zeros(rplan.n_pad, np.int32)
    padded[: g.n] = col
    ref = float(ref_engine.colorful_map_count(rplan, jnp.asarray(padded)))
    return col, want, ref


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def _bucket_pairs(indptr_q: torch.Tensor, indices: torch.Tensor):
    deg = torch.diff(indptr_q)
    dst = torch.repeat_interleave(torch.arange(deg.numel()), deg)
    cols = indices[int(indptr_q[0]): int(indptr_q[-1])]
    return sorted(zip(dst.tolist(), cols.tolist()))


@pytest.mark.parametrize("graph", ["er97", "skew8"])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_plan_equals_reference(graph, P):
    g, r = _graphs(graph)
    mine = build_distributed_plan(g, path_tree(4), P, device="cpu")
    ref = ref_dist.build_distributed_plan(r, ref_templates.path_tree(4), P)
    assert (mine.shard_size, mine.n_loc_pad, mine.r_pad) == (ref.shard_size, ref.n_loc_pad,
                                                             ref.r_pad)
    np.testing.assert_array_equal(mine.send_idx, np.asarray(ref.send_idx))
    np.testing.assert_array_equal(mine.bucket_counts, ref.bucket_counts)
    tile_dst, tile_off = np.asarray(ref.tile_dst), np.asarray(ref.tile_off)
    tile_cmp, tile_loc = np.asarray(ref.tile_src_compact), np.asarray(ref.tile_src_local)
    slab_dst, slab_cols = np.asarray(ref.a2a_slab_dst), np.asarray(ref.a2a_slab_cols)
    for p in range(P):
        sh = mine.shards[p]
        assert torch.equal(sh.send_idx, torch.from_numpy(mine.send_idx[p].astype(np.int64)))
        for q in range(P):
            t = slice(tile_off[p, q], tile_off[p, q + 1])
            real = tile_dst[p, t] != ref.shard_size
            for view, tiles in ((0, tile_cmp), (1, tile_loc)):
                want = sorted(zip(tile_dst[p, t][real].tolist(), tiles[p, t][real].tolist()))
                assert _bucket_pairs(sh.buckets.indptr[q], sh.buckets.indices[view]) == want
        # alltoall: the slab layout's (block row + local dst, column) pairs
        spb = ref.slabs_per_block
        blk = np.arange(slab_dst.shape[1]) // spb
        d = slab_dst[p] + (blk * 128)[:, None]
        keep = slab_dst[p] >= 0
        want = sorted(zip(d[keep].tolist(), slab_cols[p][keep].tolist()))
        assert _bucket_pairs(sh.a2a.indptr, sh.a2a.indices) == want


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tname", list(TREES))
@pytest.mark.parametrize("P,I", [(1, 1), (1, 2), (4, 1), (4, 2), (8, 1), (8, 2)])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode,gf", MODES, ids=[f"{m}-g{g}" for m, g in MODES])
def test_counts_equal_brute_force_and_reference(mode, gf, fuse, P, I, tname):
    col, want, ref = _coloring("er97", tname)
    plan = _plan("er97", tname, P)
    f = make_count_fn(plan, LocalMesh(P, I, device="cpu"), mode=mode, group_factor=gf, fuse=fuse)
    cols = np.broadcast_to(shard_coloring(plan, col)[None], (2 * I, P, plan.n_loc_pad))
    got = f(cols)
    assert got.shape == (2 * I,) and got.dtype == torch.float64
    assert got.tolist() == [want] * (2 * I)
    assert want == ref


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode,gf", MODES, ids=[f"{m}-g{g}" for m, g in MODES])
def test_skew8_counts(mode, gf, fuse):
    """The skewed R-MAT on 8 shards (buckets of very different sizes), as
    the reference worker's ``test_tiled_skew_parity``."""
    col, want, ref = _coloring("skew8", "p4")
    plan = _plan("skew8", "p4", 8)
    f = make_count_fn(plan, LocalMesh(8, device="cpu"), mode=mode, group_factor=gf, fuse=fuse)
    assert f(shard_coloring(plan, col)[None]).tolist() == [want] == [ref]


FAMILIES = {"spiders": ["u3-1", "u5-2", "u7-2"], "cycle4": ["cycle4"], "diamond": ["diamond"],
            "mixed": ["u3-1", "cycle4", "u5-2", "diamond"]}


@lru_cache(maxsize=None)
def _family_case(fam):
    g = erdos_renyi(60, 4.0, seed=7)
    temps = [template(t) for t in FAMILIES[fam]]
    single = build_multi_counting_plan(g, temps, device="cpu")
    col = np.random.default_rng(5).integers(0, single.k, g.n).astype(np.int32)
    want = colorful_map_count_many(single, col).tolist()
    assert want == [count_colorful_maps(g, t, col) for t in temps]
    return g, temps, col, want


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("P,I", [(4, 1), (8, 2)])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode,gf", [("alltoall", 1), ("pipeline", 3), ("ring", 1)])
def test_families_and_treewidth2(mode, gf, fuse, P, I, fam):
    """One shared-DAG pass per coloring: each template's count == brute
    force == the single-device port's; bag roots are not counted P times."""
    g, temps, col, want = _family_case(fam)
    plan = build_distributed_plan(g, temps, P, device="cpu")
    assert plan.is_multi
    f = make_count_fn(plan, LocalMesh(P, I, device="cpu"), mode=mode, group_factor=gf, fuse=fuse)
    got = f(np.broadcast_to(shard_coloring(plan, col)[None], (I, P, plan.n_loc_pad)))
    assert got.shape == (I, len(temps)) and got.tolist() == [want] * I


def test_single_treewidth2_template():
    g = erdos_renyi(60, 4.0, seed=7)
    cyc = template("cycle5")
    col = np.random.default_rng(1).integers(0, 5, g.n).astype(np.int32)
    plan = build_distributed_plan(g, cyc, 4, device="cpu")
    assert not plan.is_multi and plan.has_bags
    got = make_count_fn(plan, LocalMesh(4, device="cpu"), mode="adaptive")(
        shard_coloring(plan, col)[None])
    assert got.tolist() == [count_colorful_maps(g, cyc, col)]


# ---------------------------------------------------------------------------
# keyed colorings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,seed", [(97, 4, 0), (1024, 7, 3), (5000, 12, 11)])
def test_global_coloring_is_jax_randint(n, k, seed):
    key = prng.split(prng.key(seed), 3)[1]
    want = np.asarray(jax.random.randint(jax.random.wrap_key_data(
        jnp.asarray(key.numpy().astype(np.uint32))), (n,), 0, k, dtype=jnp.int32))
    got = global_coloring(key, n, k, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_keyed_samples_elastic_and_equal_reference():
    """The keyed stream depends on (key, n, k) alone: P = 1, 2 (I = 2) and 8
    give identical samples, == the reference's keyed sampler (sums below
    2^24, so the shards' other summation orders change no bit)."""
    g, r = _graphs("er97")
    key = prng.key(4)
    outs = []
    for P, I in ((1, 1), (2, 2), (8, 1)):
        plan = build_distributed_plan(g, template("u5-2"), P, device="cpu")
        outs.append(keyed_sample_fn(plan, LocalMesh(P, I, device="cpu"), mode="pipeline",
                                    fuse=P == 8)(key, 5))
    assert outs[0].shape == (5,)
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0], outs[2])
    rplan = ref_dist.build_distributed_plan(r, ref_templates.template("u5-2"), 1)
    from repro.compat import make_mesh

    rsample = ref_dist.keyed_sample_fn(rplan, make_mesh((1,), ("data",)), mode="alltoall")
    want = rsample(jax.random.key(4), 5)
    np.testing.assert_allclose(outs[0], want, rtol=1e-12)


def test_keyed_family_samples():
    g, temps, _, _ = _family_case("mixed")
    a = build_distributed_plan(g, temps, 1, device="cpu")
    b = build_distributed_plan(g, temps, 8, device="cpu")
    sa = keyed_sample_fn(a, LocalMesh(1, device="cpu"))(prng.key(2), 3)
    sb = keyed_sample_fn(b, LocalMesh(8, device="cpu"), mode="ring")(prng.key(2), 3)
    assert sa.shape == (3, 4) and np.array_equal(sa, sb)


# ---------------------------------------------------------------------------
# the API, the launcher, routing
# ---------------------------------------------------------------------------


def test_counter_distributed_backend():
    g = _graphs("er97")[0]
    c = Counter.from_graph(g, "u5-2", backend="distributed", num_shards=4, mode="pipeline",
                           device="cpu", bucket_tile=64, impl="xla")
    assert c.plan_opts == {"num_shards": 4, "mode": "pipeline", "device": "cpu"}
    res = c.estimate(n_iter=8, key=prng.key(0), batch=4)
    assert res.backend == "distributed" and res.samples.shape == (8,)
    ring = c.with_options(mode="ring", fuse=True, impl="pallas")
    assert ring.plan is c.plan and ring.mesh is c.mesh
    assert np.array_equal(ring.estimate(n_iter=8, key=prng.key(0), batch=4).samples, res.samples)
    auto = Counter.from_graph(g, "u5-2", mesh=LocalMesh(8, 2, device="cpu"))
    assert auto.backend == "distributed"
    assert np.array_equal(auto.estimate(n_iter=8, key=prng.key(0), batch=4).samples, res.samples)
    col, want, _ = _coloring("er97", "u5-2")
    assert c.count_coloring(col) == want == auto.count_coloring(col)
    fam = ["u3-1", "u5-2", "cycle4"]
    single = Counter.from_graph(g, "u5-2", backend="single", device="cpu")
    assert np.array_equal(c.count_coloring_many(fam, col), single.count_coloring_many(fam, col))
    many = c.estimate_many(fam, n_iter=4, key=prng.key(1), batch=2)
    assert many.samples.shape == (4, 3) and many.backend == "distributed"
    with pytest.raises(ValueError, match="distributed backend"):
        single.with_options(mode="ring")
    with pytest.raises(TypeError, match="only swaps"):
        c.with_options(num_shards=2)
    with pytest.raises(ValueError, match="does not match"):
        Counter.from_graph(g, "u5-2", backend="distributed", num_shards=2,
                           mesh=LocalMesh(4, device="cpu")).plan


def test_counter_auto_without_a_wide_mesh_is_single():
    g = _graphs("er97")[0]
    assert Counter.from_graph(g, "u5-2", device="cpu", num_shards=8).backend == "single"
    assert Counter.from_graph(g, "u5-2", mesh=LocalMesh(1, device="cpu")).backend == "single"


def test_distributed_counter_resume_on_another_mesh(tmp_path):
    """Killed after a checkpoint at P = 2, resumed at P = 4: the samples of
    an uninterrupted run (the keyed stream ignores the shard count)."""
    from repro_torch.testing import faults

    g = _graphs("er97")[0]

    def mk(P):
        return Counter.from_graph(g, "u3-1", backend="distributed", num_shards=P, device="cpu")

    full = mk(2).estimate(n_iter=8, key=prng.key(3), batch=2)
    with faults.active(faults.inject("estimator.kill", at=(0,))):
        with pytest.raises(faults.InjectedCrash):
            mk(2).estimate(n_iter=8, key=prng.key(3), batch=2, checkpoint=str(tmp_path),
                           checkpoint_every=4)
    res = mk(4).estimate(n_iter=8, key=prng.key(3), batch=2, resume=str(tmp_path))
    assert res.resumed_from == 4
    assert np.array_equal(res.samples, full.samples)


def test_only_rank_zero_writes_checkpoints(tmp_path, monkeypatch):
    """Under a torch.distributed world every rank runs the estimator loop;
    a rank other than 0 restores checkpoints but never writes them."""
    import torch.distributed as dist

    g = _graphs("er97")[0]
    c = Counter.from_graph(g, "u3-1", backend="distributed", num_shards=2, device="cpu")
    c.plan, c.sample_fn  # built before the world is faked
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    res = c.estimate(n_iter=4, key=prng.key(1), batch=2, checkpoint=str(tmp_path),
                     checkpoint_every=2)
    assert res.niter == 4 and not any(tmp_path.iterdir())
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    c.estimate(n_iter=4, key=prng.key(1), batch=2, checkpoint=str(tmp_path), checkpoint_every=2)
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    again = c.estimate(n_iter=4, key=prng.key(1), batch=2, resume=str(tmp_path))
    assert again.resumed_from == 4 and np.array_equal(again.samples, res.samples)


def _launch(argv, capsys):
    launch_count.main(argv)
    return capsys.readouterr().out.splitlines()


def _estimates(lines):
    return [ln for ln in lines if ln.startswith("estimate")]


def test_launcher_modes(capsys):
    base = ["--config", "bench-small", "--iters", "4", "--batch", "2", "--device", "cpu"]
    two = _launch(base + ["--mode", "adaptive", "--shards", "2"], capsys)
    four = _launch(base + ["--mode", "pipeline", "--shards", "4", "--group-factor", "2",
                           "--fuse"], capsys)
    measured = _launch(base + ["--mode", "adaptive", "--shards", "2", "--adaptive", "measured"],
                       capsys)
    assert len(_estimates(two)) == 2 and _estimates(two) == _estimates(four) == \
        _estimates(measured)
    assert any(ln.startswith("routing: wire=float32 assumed model") for ln in two)
    assert any(ln.startswith("routing: wire=float32 calibrated model") for ln in measured)
    assert any(ln.startswith("mode=pipeline(batch=2,fuse=True,g=2,mesh=4x1) shards=4")
               for ln in four)
    fam = _launch(base + ["--mode", "ring", "--shards", "3", "--templates", "u3-1,u5-2"],
                  capsys)
    single = _launch(base + ["--mode", "single", "--templates", "u3-1,u5-2"], capsys)
    assert any("shards=3: family of 2" in ln for ln in fam)
    assert any("shards=1: family of 2" in ln for ln in single)


def test_route_report_costs_the_ports_bytes():
    """Per node: the true-width bytes of both layouts, the flops, and the
    mode ``choose_mode_full`` picks on them (the reference's router, held
    equal in ``test_torch_comm.py``)."""
    plan = _plan("skew8", "u5-2", 8)
    rep = plan_route_report(plan, group_factor=2)
    assert rep["calibrated"] is False and rep["model"]["alpha"] == V5E_ICI.alpha
    assert sorted(rep["per_node"]) == [i for i, nd in enumerate(plan.program.nodes)
                                       if nd.kind == "combine"]
    for i, row in rep["per_node"].items():
        w = plan.widths[plan.program.nodes[i].right]
        a2a = 7 * plan.r_pad * w * 4
        assert row["a2a_bytes"] == a2a and node_exchange_bytes(plan, i, "pipeline") == (a2a, a2a)
        ring = 7 * plan.n_loc_pad * w * 4
        assert row["ring_bytes"] == ring and node_exchange_bytes(plan, i, "ring") == (ring, ring)
        mode, diag = choose_mode_full(row["a2a_bytes"], row["ring_bytes"], row["flops"], 8,
                                      V5E_ICI, 2)
        assert row["mode"] == mode and row["predicted_s"] == diag["predicted_s"]
    fixed = plan_route_report(plan, mode="ring")
    assert {r["mode"] for r in fixed["per_node"].values()} == {"ring"}
    f = make_count_fn(plan, LocalMesh(8, device="cpu"), group_factor=2)
    assert f.node_modes == {i: r["mode"] for i, r in rep["per_node"].items()}
    slow_link = make_count_fn(plan, LocalMesh(8, device="cpu"),
                              hockney=V5E_ICI.__class__(1.0, 1e-3, 1e9))
    assert set(slow_link.node_modes.values()) <= {"alltoall", "pipeline", "ring"}


def test_unported_surfaces_name_their_items():
    """Compaction and the narrow wire are ported (a plan carries its spec;
    an unknown wire is the reference's ValueError); shape-only plans are
    the reference's (``tests/test_torch_dryrun.py`` holds them row by row)."""
    g = _graphs("er97")[0]
    assert build_distributed_plan(g, path_tree(4), 2, compact=True, device="cpu",
                                  density_threshold=1.0).compaction.enabled
    plan = _plan("er97", "p4", 4)
    with pytest.raises(ValueError, match="wire_dtype='int4'"):
        make_count_fn(plan, LocalMesh(4, device="cpu"), wire_dtype="int4")
    with pytest.raises(ValueError, match="wire_dtype='int4'"):
        plan_route_report(plan, wire_dtype="int4")
    assert plan_route_report(plan, wire_dtype="int16")["wire_dtype"] == "int16"
    assert Counter.from_graph(g, "u3-1", backend="distributed", device="cpu",
                              compact=True).plan.compaction is not None
    shape = abstract_plan(10**6, 10**7, path_tree(4), 8)
    ref = ref_dist.abstract_plan(10**6, 10**7, ref_templates.path_tree(4), 8)
    assert (shape.shard_size, shape.n_loc_pad, shape.r_pad, shape.num_tiles) == (
        ref.shard_size, ref.n_loc_pad, ref.r_pad, ref.num_tiles)
    assert shape.device.type == "meta" and shape.shards[0].send_idx.device.type == "meta"
    assert tuple(shape.shards[0].send_idx.shape) == tuple(ref.send_idx.shape[1:])
    with pytest.raises(ValueError, match="mode="):
        make_count_fn(plan, LocalMesh(4, device="cpu"), mode="naive")
    with pytest.raises(ValueError, match="4 shards"):
        make_count_fn(plan, LocalMesh(2, device="cpu"))
    with pytest.raises(ValueError, match="iteration ranks"):
        make_count_fn(plan, LocalMesh(4, 2, device="cpu"))(np.zeros((3, 4, plan.n_loc_pad)))


def test_failing_rank_fails_the_call(monkeypatch):
    """A rank whose kernel call raises fails the whole count at once, and the
    launcher run exits non-zero."""
    from repro_torch.kernels import ops

    real = ops.spmm_rect

    def flaky(csr, source):
        if threading.current_thread().name == "LocalMesh rank (0, 2)":
            raise RuntimeError("injected kernel failure on rank 2")
        return real(csr, source)

    monkeypatch.setattr(ops, "spmm_rect", flaky)
    col, _, _ = _coloring("er97", "p4")
    plan = _plan("er97", "p4", 4)
    f = make_count_fn(plan, LocalMesh(4, device="cpu", timeout=60.0), mode="pipeline")
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        f(shard_coloring(plan, col)[None])
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        launch_count.main(["--config", "bench-small", "--iters", "2", "--batch", "2",
                           "--device", "cpu", "--mode", "ring", "--shards", "4"])


# ---------------------------------------------------------------------------
# the reference's distributed engine, and gloo processes
# ---------------------------------------------------------------------------

_REFERENCE_WORKER = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.core import erdos_renyi
    from repro.core.distributed import build_distributed_plan, make_count_fn, shard_coloring
    from repro.core.templates import path_tree, template

    name, fuse = sys.argv[1], bool(int(sys.argv[2]))
    g = erdos_renyi(97, 5.0, seed=7)
    mesh = make_mesh((8,), ("data",))
    plan = build_distributed_plan(g, path_tree(4) if name == "p4" else template(name), 8)
    rng = np.random.default_rng(11)
    colorings = [rng.integers(0, plan.k, g.n).astype(np.int32) for _ in range(2)]
    cols = jnp.asarray(np.stack([shard_coloring(plan, c) for c in colorings]))
    out = {"colorings": [c.tolist() for c in colorings]}
    for mode, gf in %s:
        f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse)
        out[f"{mode}-g{gf}"] = np.asarray(f(cols)).tolist()
    print("RESULT " + json.dumps(out))
""" % (MODES,))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", ["p4", "u5-2"])
def test_reference_distributed_engine_on_8_devices(name, fuse):
    """The reference's ``make_count_fn`` on 8 forced host devices, every
    mode, on fixed colorings == the port's LocalMesh P = 8 (the reference's
    rtol 1e-6, and ``==`` since the sums stay below 2^24) == brute force.
    One subprocess a (template, fuse): the reference compiles each mode's
    program, and the flags below keep that compile short."""
    flags = ("--xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_WORKER, name, str(int(fuse))],
                          env=env, capture_output=True, text=True, timeout=110)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.split("RESULT ", 1)[1])
    g = _graphs("er97")[0]
    plan = _plan("er97", name, 8)
    cols = np.stack([shard_coloring(plan, c) for c in res["colorings"]])
    brute = [count_colorful_maps(g, TREES[name][0](), np.asarray(c)) for c in res["colorings"]]
    mesh = LocalMesh(8, device="cpu")
    for mode, gf in MODES:
        got = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse)(cols)
        want = res[f"{mode}-g{gf}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert got.tolist() == want == brute


_GLOO_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    MODES = %s
    COLORINGS = [np.random.default_rng(9 + i).integers(0, 4, 97).astype(np.int32)
                 for i in range(2)]

    def work(rank, world, port, out_path):
        sys.path.insert(0, %r)
        from repro_torch.core import prng
        from repro_torch.core.distributed import (build_distributed_plan, keyed_sample_fn,
                                                  make_count_fn, shard_coloring)
        from repro_torch.core.graphs import erdos_renyi
        from repro_torch.core.templates import path_tree, template
        from repro_torch.launch.mesh import process_mesh

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        g = erdos_renyi(97, 5.0, seed=7)
        out = {}
        for shape in ((4, 1), (2, 2)):
            mesh = process_mesh(data=shape[0], iters=shape[1], device="cpu")
            for name in ("u3-1", "u5-2", "cycle4"):
                plan = build_distributed_plan(g, template(name), shape[0], device="cpu")
                col = np.random.default_rng(5).integers(0, plan.k, g.n).astype(np.int32)
                cols = np.broadcast_to(shard_coloring(plan, col)[None],
                                       (2, shape[0], plan.n_loc_pad))
                for mode, gf in MODES:
                    for fuse in (False, True):
                        f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse)
                        out[f"{shape}-{name}-{mode}-g{gf}-{int(fuse)}"] = f(cols).tolist()
                out[f"{shape}-{name}-keyed"] = keyed_sample_fn(plan, mesh)(prng.key(1), 4).tolist()
            # compacted and narrow: int16 and int8 payloads as bitcast bytes
            plan = build_distributed_plan(g, path_tree(4), shape[0], device="cpu", compact=True,
                                          density_threshold=1.0)
            cols = np.stack([shard_coloring(plan, c) for c in COLORINGS])
            for mode, gf in MODES:
                for fuse in (False, True):
                    for wire in ("int16", "int8"):
                        f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse,
                                          wire_dtype=wire)
                        out[f"{shape}-p4-compact-{mode}-g{gf}-{int(fuse)}-{wire}"] = [
                            f(cols).tolist(), f.rung]
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(out, fh)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(work, args=(4, port, sys.argv[1]), nprocs=4, join=True)
""" % (MODES, str(ROOT / "src")))


def test_gloo_processes_equal_local_mesh(tmp_path):
    """Four gloo processes (``ProcessGroupComm`` through ``process_mesh``, as
    a 4 x 1 and a 2 x 2 mesh), every mode and fuse, fixed and keyed
    colorings == ``LocalMesh`` of the same shape; and a compacted plan at
    the int16 and int8 wires (gloo takes no int16: the payloads cross as
    bitcast bytes) == brute force, on the narrow rung itself."""
    script = tmp_path / "gloo_worker.py"
    script.write_text(_GLOO_WORKER)
    out_path = tmp_path / "out.json"
    proc = subprocess.run([sys.executable, str(script), str(out_path)], capture_output=True,
                          text=True, timeout=240, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(out_path.read_text())
    g = erdos_renyi(97, 5.0, seed=7)
    n = 0
    for shape in ((4, 1), (2, 2)):
        mesh = LocalMesh(*shape, device="cpu")
        for name in ("u3-1", "u5-2", "cycle4"):
            plan = build_distributed_plan(g, template(name), shape[0], device="cpu")
            col = np.random.default_rng(5).integers(0, plan.k, g.n).astype(np.int32)
            cols = np.broadcast_to(shard_coloring(plan, col)[None], (2, shape[0], plan.n_loc_pad))
            for mode, gf in MODES:
                for fuse in (False, True):
                    want = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse)(cols)
                    assert got[f"{shape}-{name}-{mode}-g{gf}-{int(fuse)}"] == want.tolist()
                    n += 1
            assert got[f"{shape}-{name}-keyed"] == keyed_sample_fn(plan, mesh)(
                prng.key(1), 4).tolist()
        colorings = [np.random.default_rng(9 + i).integers(0, 4, 97).astype(np.int32)
                     for i in range(2)]
        brute = [count_colorful_maps(g, path_tree(4), c) for c in colorings]
        for mode, gf in MODES:
            for fuse in (False, True):
                for wire in ("int16", "int8"):
                    counts, rung = got[f"{shape}-p4-compact-{mode}-g{gf}-{int(fuse)}-{wire}"]
                    assert counts == brute and rung == f"{wire} compact"
                    n += 1
    assert n == 2 * 3 * len(MODES) * 2 + 2 * len(MODES) * 2 * 2
