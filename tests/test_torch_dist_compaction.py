"""The distributed engine's compacted exchange and narrow wire on the CPU.

* the spec: ``distributed_compaction``'s densities, gather densities and
  exchange, ring and combine capacities ``==`` the reference's (its probe
  colorings), with the profitability floors forced down in both packages;
* the bytes: ``node_exchange_bytes`` ``==`` the reference's formula on the
  port's true widths, and a batch of B colorings ships B times it;
* counts: every mode x fuse x wire (float32, int16, int8) x {dense,
  compact} on ``LocalMesh`` P = 4 (two iteration ranks) and P = 8, on
  distinct colorings, ``==`` brute force and ``==`` the dense float32
  exchange bitwise; one case under ``torch.set_flush_denormal(True)``, where
  the bitcast slot carriers are subnormal floats;
* the ladder: a forced saturation storm, a dense graph that saturates int8
  by itself, a forced overflow storm and ``capacity_factor=1e-6`` (overflow
  down to the dense twin) all give the dense counts, on the rung
  ``f.rung`` names;
* the reference's own engine on 8 host devices (a subprocess), compacted
  and at int16 and int8, ``==`` ``LocalMesh`` P = 8;
* ``Counter(backend="distributed", compact=True, wire_dtype=...)``,
  ``with_options(wire_dtype=...)`` and the launcher's ``--compact
  --wire-dtype``.

The counts of these small graphs stay far below 2^24, so every comparison
is ``==``.
"""

import json
import os
import subprocess
import sys
import textwrap
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.comm import compress as ref_compress
from repro.core import distributed as ref_dist
from repro.core import frontier as ref_frontier
from repro.core import graphs as ref_graphs
from repro.core import templates as ref_templates
from repro_torch.api import Counter
from repro_torch.comm import LocalMesh, group as group_mod
from repro_torch.core import frontier, prng
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
from repro_torch.core.distributed import (
    build_distributed_plan,
    make_count_fn,
    node_exchange_bytes,
    plan_route_report,
    shard_coloring,
)
from repro_torch.core.graphs import erdos_renyi, rmat
from repro_torch.core.templates import path_tree, spider_tree, template
from repro_torch.launch import count as launch_count
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]
MODES = [("alltoall", 1), ("pipeline", 1), ("pipeline", 3), ("adaptive", 1), ("ring", 1)]
WIRES = ("float32", "int16", "int8")
#: templates whose partition has internal right children (root 0), so the
#: exchange and ring capacities engage
TREES = {"p4": lambda: path_tree(4), "sp21": lambda: spider_tree([2, 1])}


@pytest.fixture
def force_floors(monkeypatch):
    """Drop the combine floor in the port and the reference, so that the
    compact combine engages on templates the CPU's brute force affords."""
    for mod in (frontier, ref_frontier):
        monkeypatch.setattr(mod, "MIN_COMBINE_ELEMENTS", 1)
        monkeypatch.setattr(mod, "MIN_TABLE_WIDTH", 1)


@lru_cache(maxsize=None)
def _er():
    return erdos_renyi(97, 5.0, seed=7)


@lru_cache(maxsize=None)
def _colorings(tname, count=4):
    """Distinct colorings (their active rows differ) and their brute force."""
    g, tree = _er(), TREES[tname]()
    rng = np.random.default_rng(17)
    cols = [rng.integers(0, tree.n, g.n).astype(np.int32) for _ in range(count)]
    return cols, [count_colorful_maps(g, tree, c) for c in cols]


def _plans(tname, P):
    """The dense plan and the compacted one (threshold 1.0: every node
    whose capacity is below its limit engages), floors as the caller set."""
    return _built_plans(tname, P, frontier.MIN_COMBINE_ELEMENTS)


@lru_cache(maxsize=None)
def _built_plans(tname, P, floor):
    g, tree = _er(), TREES[tname]()
    dense = build_distributed_plan(g, tree, P, device="cpu")
    comp = build_distributed_plan(g, tree, P, device="cpu", compact=True, density_threshold=1.0)
    return dense, comp


def _layout(plan, cols):
    return np.stack([shard_coloring(plan, c) for c in cols])


# ---------------------------------------------------------------------------
# the spec and the bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold,factor", [(1.0, 1.5), (0.5, 1.25)])
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("tname", ["u5-2", "u7-2"])
@pytest.mark.parametrize("graph", ["er97", "skew8"])
def test_spec_equals_reference(force_floors, graph, tname, P, threshold, factor):
    if graph == "er97":
        g, r = _er(), ref_graphs.erdos_renyi(97, 5.0, seed=7)
    else:
        g, r = rmat(1024, 3000, skew=8, seed=2), ref_graphs.rmat(1024, 3000, skew=8, seed=2)
    kw = dict(compact=True, density_threshold=threshold, capacity_factor=factor)
    mine = build_distributed_plan(g, template(tname), P, device="cpu", **kw).compaction
    ref = ref_dist.build_distributed_plan(r, ref_templates.template(tname), P, **kw).compaction
    assert mine.density == ref.density and mine.gather_density == ref.gather_density
    assert mine.exchange_caps == ref.exchange_caps and mine.shard_caps == ref.shard_caps
    assert mine.combine_caps == ref.combine_caps and mine.table_caps == {} == ref.table_caps
    assert mine.enabled == ref.enabled


def test_spec_engages_every_kind(force_floors):
    """The skewed graph's u7-2 at P = 4 engages all three capacity kinds."""
    spec = build_distributed_plan(rmat(1024, 3000, skew=8, seed=2), template("u7-2"), 4,
                                  device="cpu", compact=True, density_threshold=1.0).compaction
    assert spec.exchange_caps and spec.shard_caps and spec.combine_caps and spec.enabled
    assert all(c % 8 == 0 for c in list(spec.exchange_caps.values())
               + list(spec.shard_caps.values()))


def test_bag_programs_stay_dense():
    plan = build_distributed_plan(erdos_renyi(40, 4.0, seed=7), template("cycle4"), 4,
                                  device="cpu", compact=True, density_threshold=1.0)
    assert plan.compaction is None


@pytest.mark.parametrize("wire", WIRES)
def test_node_exchange_bytes_equal_reference_formula(wire):
    """(dense, compact) a coloring == the reference's formula
    (``frontier.py:481``) on the port's true widths, for every mode."""
    plan = _plans("p4", 4)[1]
    spec = plan.compaction
    assert spec.exchange_caps and spec.shard_caps
    e = ref_compress.wire_itemsize(wire)
    for i, nd in enumerate(plan.program.nodes):
        if nd.kind != "combine":
            continue
        w = plan.widths[nd.right]
        for mode in ("alltoall", "pipeline", "ring"):
            rows, caps = ((plan.n_loc_pad, spec.shard_caps) if mode == "ring"
                          else (plan.r_pad, spec.exchange_caps))
            dense = 3 * rows * w * e
            cap = caps.get(nd.right)
            extra = 1 if wire == "float32" else ref_compress.mask_column_count(rows, cap or 1,
                                                                               wire)
            want = (dense, 3 * cap * (w + extra) * e if cap else dense)
            assert node_exchange_bytes(plan, i, mode, wire) == want
    dense_plan = _plans("p4", 4)[0]
    for i, nd in enumerate(dense_plan.program.nodes):
        if nd.kind == "combine":
            for mode in ("alltoall", "ring"):
                dense, compact = node_exchange_bytes(dense_plan, i, mode, wire)
                assert dense == compact


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mode", ["alltoall", "pipeline", "ring"])
def test_shipped_bytes_are_b_times_the_formula(monkeypatch, mode, wire):
    """The payloads a rank ships to its peers (the all-to-all's P - 1
    off-diagonal chunks, or its P - 1 shifts) add up to B times the compact
    half of ``node_exchange_bytes`` over the exchanged nodes."""
    dense, plan = _plans("p4", 4)
    cols, want = _colorings("p4")
    sent = []
    real_a2a, real_shift = group_mod.LocalGroup.all_to_all, group_mod.LocalGroup.shift_start

    def a2a(self, chunks):
        if self.rank == 0:
            sent.append(chunks.nbytes * (self.size - 1) // self.size)
        return real_a2a(self, chunks)

    def shift(self, x, s):
        if self.rank == 0 and s % self.size:
            sent.append(x.nbytes)
        return real_shift(self, x, s)

    monkeypatch.setattr(group_mod.LocalGroup, "all_to_all", a2a)
    monkeypatch.setattr(group_mod.LocalGroup, "shift_start", shift)
    f = make_count_fn(plan, LocalMesh(4, device="cpu"), mode=mode, wire_dtype=wire)
    assert f(_layout(plan, cols)).tolist() == want and f.rung == f"{wire} compact"
    nodes = [i for i, nd in enumerate(plan.program.nodes) if nd.kind == "combine"]
    assert sum(sent) == len(cols) * sum(node_exchange_bytes(plan, i, mode, wire)[1]
                                        for i in nodes)
    assert sum(sent) < len(cols) * sum(node_exchange_bytes(plan, i, mode, wire)[0]
                                       for i in nodes)


def test_route_report_prices_the_compacted_narrow_bytes():
    plan = _plans("p4", 4)[1]
    for wire in WIRES:
        rep = plan_route_report(plan, wire_dtype=wire)
        assert rep["wire_dtype"] == wire
        for i, row in rep["per_node"].items():
            assert row["a2a_bytes"] == node_exchange_bytes(plan, i, "alltoall", wire)[1]
            assert row["ring_bytes"] == node_exchange_bytes(plan, i, "ring", wire)[1]
    with pytest.raises(ValueError, match="wire_dtype='int4'"):
        plan_route_report(plan, wire_dtype="int4")


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode,gf", MODES, ids=[f"{m}-g{g}" for m, g in MODES])
def test_counts_equal_brute_force_and_dense(force_floors, mode, gf, fuse, wire, P):
    """Dense and compacted plans, both templates: == brute force on four
    distinct colorings, and == the dense float32 exchange bitwise.  P = 4
    runs two iteration ranks (two colorings a data group)."""
    mesh = LocalMesh(P, 2 if P == 4 else 1, device="cpu")
    for tname in TREES:
        cols, want = _colorings(tname)
        dense, comp = _plans(tname, P)
        assert comp.compaction.exchange_caps and comp.compaction.shard_caps
        base = make_count_fn(dense, mesh, mode=mode, group_factor=gf, fuse=fuse)(
            _layout(dense, cols))
        assert base.tolist() == want
        for plan, tag in ((dense, "dense"), (comp, "compact")):
            f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse, wire_dtype=wire)
            got = f(_layout(plan, cols))
            assert torch.equal(got, base), (tname, tag)
            assert f.rung == f"{wire} {tag}" and f.fallbacks == 0


def test_skewed_u7_compact_narrow_equals_dense(force_floors):
    """u7-2 on the skewed graph (every capacity kind engaged, tables past
    int8): every mode x wire, compacted, == the dense float32 exchange
    bitwise.  Its maps pass 2^24, so the dense exchange is held within
    float32 rounding (rtol 1e-6) of the single-device port."""
    g = rmat(1024, 3000, skew=8, seed=2)
    rng = np.random.default_rng(21)
    cols = [rng.integers(0, 7, g.n).astype(np.int32) for _ in range(2)]
    dense = build_distributed_plan(g, template("u7-2"), 4, device="cpu")
    comp = build_distributed_plan(g, template("u7-2"), 4, device="cpu", compact=True,
                                  density_threshold=1.0)
    mesh = LocalMesh(4, device="cpu")
    single = build_counting_plan(g, template("u7-2"), device="cpu")
    want = [float(colorful_map_count(single, np.pad(c, (0, single.n_pad - g.n)))) for c in cols]
    for mode, gf in MODES:
        for fuse in (False, True):
            base = make_count_fn(dense, mesh, mode=mode, group_factor=gf, fuse=fuse)(
                _layout(dense, cols))
            np.testing.assert_allclose(base.numpy(), want, rtol=1e-6)
            for wire in WIRES:
                f = make_count_fn(comp, mesh, mode=mode, group_factor=gf, fuse=fuse,
                                  wire_dtype=wire)
                assert torch.equal(f(_layout(comp, cols)), base), (mode, fuse, wire, f.rung)


def test_flush_to_zero_keeps_the_slot_carriers(force_floors):
    """Under flush-to-zero arithmetic a subnormal float computes as zero; the
    slot carriers (bitcast int32 slots, all subnormal) are only copied, so
    the compacted float32 wire still counts exactly."""
    if not torch.set_flush_denormal(True):
        pytest.fail("this CPU cannot switch flush-to-zero on")
    try:
        tiny = torch.tensor([1e-40])
        assert (tiny * 1.0).item() == 0.0  # the mode is on: arithmetic flushes
        cols, want = _colorings("p4")
        plan = _plans("p4", 4)[1]
        for mode, gf in MODES:
            for fuse in (False, True):
                f = make_count_fn(plan, LocalMesh(4, device="cpu"), mode=mode, group_factor=gf,
                                  fuse=fuse)
                assert f(_layout(plan, cols)).tolist() == want and f.rung == "float32 compact"
    finally:
        torch.set_flush_denormal(False)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


def test_saturation_storm_climbs_the_ladder():
    """``compression.saturate`` at the int8 and int16 rungs: the batch ends
    on the float32 compact rung with the same counts."""
    cols, want = _colorings("p4")
    plan = _plans("p4", 4)[1]
    f = make_count_fn(plan, LocalMesh(4, device="cpu"), mode="pipeline", wire_dtype="int8")
    with faults.active(faults.inject("compression.saturate", at=(0, 1))) as fp:
        assert f(_layout(plan, cols)).tolist() == want
    assert [s for s, _ in fp.fired] == ["compression.saturate"] * 2
    assert f.rung == "float32 compact" and f.fallbacks == 1
    assert f(_layout(plan, cols)).tolist() == want and f.rung == "int8 compact"


@pytest.mark.parametrize("mode", ["alltoall", "pipeline", "ring"])
def test_overflow_storm_runs_the_dense_twin(mode):
    cols, want = _colorings("sp21")
    plan = _plans("sp21", 4)[1]
    f = make_count_fn(plan, LocalMesh(4, device="cpu"), mode=mode)
    with faults.active(faults.inject("compaction.overflow", at=None)) as fp:
        assert f(_layout(plan, cols)).tolist() == want
    assert [s for s, _ in fp.fired] == ["compaction.overflow"]
    assert f.rung == "float32 dense"


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_dense_graph_saturates_int8(compact):
    """Entries past 127 on a dense graph: int8 saturates by itself, int16
    holds, and the counts are the float32 exchange's."""
    g = erdos_renyi(64, 40.0, seed=3)
    tree = path_tree(4)
    rng = np.random.default_rng(2)
    cols = [rng.integers(0, 4, g.n).astype(np.int32) for _ in range(2)]
    kw = dict(compact=True, density_threshold=1.0) if compact else {}
    plan = build_distributed_plan(g, tree, 4, device="cpu", **kw)
    mesh = LocalMesh(4, device="cpu")
    base = make_count_fn(plan, mesh, mode="ring")(_layout(plan, cols))
    single = build_counting_plan(g, tree, device="cpu")
    assert base.tolist() == [float(colorful_map_count(single, np.pad(c, (0, single.n_pad - g.n))))
                             for c in cols]
    tag = "compact" if compact else "dense"
    for mode, gf in MODES:
        f8 = make_count_fn(plan, mesh, mode=mode, group_factor=gf, wire_dtype="int8")
        assert torch.equal(f8(_layout(plan, cols)), base)
        assert f8.rung == f"int16 {tag}" and f8.fallbacks == 1


@pytest.mark.parametrize("wire", WIRES)
def test_tiny_capacities_overflow_to_the_dense_twin(force_floors, wire):
    """``capacity_factor=1e-6``: every capacity overflows, each narrow rung
    saturates nothing but keeps the compaction, so the batch ends on the
    dense float32 twin with the brute-force counts."""
    cols, want = _colorings("p4")
    plan = build_distributed_plan(_er(), path_tree(4), 4, device="cpu", compact=True,
                                  density_threshold=1.0, capacity_factor=1e-6)
    assert plan.compaction.exchange_caps and plan.compaction.shard_caps
    for mode, gf in MODES:
        f = make_count_fn(plan, LocalMesh(4, device="cpu"), mode=mode, group_factor=gf,
                          wire_dtype=wire)
        assert f(_layout(plan, cols)).tolist() == want
        assert f.rung == "float32 dense" and f.fallbacks == 1


def test_keyed_compact_narrow_samples_equal_dense():
    g = _er()
    dense = build_distributed_plan(g, path_tree(4), 4, device="cpu")
    comp = build_distributed_plan(g, path_tree(4), 4, device="cpu", compact=True,
                                  density_threshold=1.0)
    from repro_torch.core.distributed import keyed_sample_fn

    a = keyed_sample_fn(dense, LocalMesh(4, device="cpu"), mode="ring")(prng.key(5), 4)
    b = keyed_sample_fn(comp, LocalMesh(4, 2, device="cpu"), mode="pipeline",
                        wire_dtype="int16")(prng.key(5), 4)
    assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the API and the launcher
# ---------------------------------------------------------------------------


def test_counter_compact_narrow(force_floors):
    g = _er()
    c = Counter.from_graph(g, path_tree(4), backend="distributed", num_shards=4, device="cpu",
                           mode="pipeline", compact=True, density_threshold=1.0,
                           capacity_factor=1.25, probes=1, wire_dtype="int16")
    spec = c.plan.compaction
    assert (spec.threshold, spec.capacity_factor, spec.probes) == (1.0, 1.25, 1) and spec.enabled
    res = c.estimate(n_iter=8, key=prng.key(0), batch=4)
    dense = Counter.from_graph(g, path_tree(4), backend="distributed", num_shards=4,
                               device="cpu")
    assert np.array_equal(res.samples, dense.estimate(n_iter=8, key=prng.key(0),
                                                      batch=4).samples)
    int8 = c.with_options(wire_dtype="int8", mode="ring")
    assert int8.plan is c.plan and int8.sample_fn is not c.sample_fn
    assert np.array_equal(int8.estimate(n_iter=8, key=prng.key(0), batch=4).samples,
                          res.samples)
    cols, want = _colorings("p4")
    assert c.count_coloring(cols[0]) == want[0] == int8.count_coloring(cols[0])


def _launch(argv, capsys):
    launch_count.main(argv)
    return capsys.readouterr().out.splitlines()


def test_launcher_compact_wire(capsys):
    base = ["--config", "bench-sparse", "--mode", "pipeline", "--shards", "4", "--iters", "4",
            "--batch", "2", "--device", "cpu"]
    narrow = _launch(base + ["--compact", "--wire-dtype", "int16"], capsys)
    dense = _launch(base + ["--wire-dtype", "float32", "--density-threshold", "-1"], capsys)
    est = lambda lines: [ln for ln in lines if ln.startswith("estimate")]  # noqa: E731
    assert len(est(narrow)) == 2 and est(narrow) == est(dense)
    assert any(ln.startswith("compaction: threshold 0.5 node densities: n") for ln in narrow)
    caps = next(ln for ln in narrow if ln.startswith("compaction caps"))
    assert "exchange[" in caps and "ring[" in caps
    assert "compaction caps: none engaged" in dense
    assert any(ln.startswith("routing: wire=int16 ") for ln in narrow)
    assert any(ln.startswith("routing: wire=float32 ") for ln in dense)
    with pytest.raises(SystemExit):
        launch_count.main(base + ["--wire-dtype", "int4"])


# ---------------------------------------------------------------------------
# the reference's engine on 8 host devices
# ---------------------------------------------------------------------------

_REFERENCE_WORKER = textwrap.dedent("""
    import json, sys
    import jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.core import erdos_renyi, frontier
    from repro.core.distributed import build_distributed_plan, make_count_fn, shard_coloring
    from repro.core.templates import path_tree

    frontier.MIN_COMBINE_ELEMENTS = 1
    wire, fuse = sys.argv[1], bool(int(sys.argv[2]))
    g = erdos_renyi(97, 5.0, seed=7)
    mesh = make_mesh((8,), ("data",))
    plan = build_distributed_plan(g, path_tree(4), 8, compact=True, density_threshold=1.0)
    rng = np.random.default_rng(11)
    colorings = [rng.integers(0, plan.k, g.n).astype(np.int32) for _ in range(2)]
    cols = jnp.asarray(np.stack([shard_coloring(plan, c) for c in colorings]))
    out = {"colorings": [c.tolist() for c in colorings],
           "caps": [sorted(plan.compaction.exchange_caps.items()),
                    sorted(plan.compaction.shard_caps.items()),
                    sorted(plan.compaction.combine_caps.items())]}
    for mode, gf in %s:
        f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse, wire_dtype=wire)
        out[f"{mode}-g{gf}"] = np.asarray(f(cols)).tolist()
    print("RESULT " + json.dumps(out))
""" % (MODES,))


@pytest.mark.timeout(200)
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("wire", ["int16", "int8"])
def test_reference_engine_compact_narrow_on_8_devices(force_floors, wire, fuse):
    """The reference's ``make_count_fn`` on a compacted plan at ``wire``, 8
    forced host devices, every mode == the port's LocalMesh P = 8 on the
    same plan and colorings == brute force.  One subprocess a (wire, fuse)."""
    flags = ("--xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_WORKER, wire, str(int(fuse))],
                          env=env, capture_output=True, text=True, timeout=190)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.split("RESULT ", 1)[1])
    g = _er()
    plan = build_distributed_plan(g, path_tree(4), 8, device="cpu", compact=True,
                                  density_threshold=1.0)
    spec = plan.compaction
    assert res["caps"] == [[list(x) for x in sorted(m.items())]
                           for m in (spec.exchange_caps, spec.shard_caps, spec.combine_caps)]
    cols = np.stack([shard_coloring(plan, c) for c in res["colorings"]])
    brute = [count_colorful_maps(g, path_tree(4), np.asarray(c)) for c in res["colorings"]]
    mesh = LocalMesh(8, device="cpu")
    for mode, gf in MODES:
        f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse, wire_dtype=wire)
        got = f(cols)
        assert got.tolist() == res[f"{mode}-g{gf}"] == brute and f.rung == f"{wire} compact"
