"""Active-frontier compaction in the port (CPU, plain versions) against the
JAX reference (``impl="xla"``) and the brute-force oracle.

The same graphs, templates and colorings go through both packages.  The
probe's masks, densities and capacities and the per-coloring no-overflow
flags are held ``==`` the reference's ``single_device_compaction`` and its
``jax.vmap``'d ``colorful_map_count_checked`` (the reference's compaction
itself: its one failing test draws an R-MAT skew ``rmat`` does not know,
which says nothing of compaction).  Counts: a compacted plan's are held
``==`` its dense twin's bit for bit, and ``==`` the reference's dense
program and brute force where every count stays below 2^24 (float32 sums
are exact in any order there).  The profitability floors are forced down
(``force_floors``, as the reference's tests do) so that compaction engages
on templates small enough for the CPU; exactness must hold whether or not
compaction pays.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as ref_frontier
from repro.core.count_engine import build_counting_plan as ref_build
from repro.core.count_engine import build_multi_counting_plan as ref_build_multi
from repro.core.count_engine import colorful_map_count as ref_count
from repro.core.count_engine import colorful_map_count_checked as ref_checked
from repro.core.count_engine import colorful_map_count_many as ref_count_many
from repro.core.count_engine import colorful_map_count_many_checked as ref_many_checked
from repro.core.count_engine import count_fn as ref_count_fn
from repro.core.count_engine import count_fn_many as ref_count_fn_many
from repro.core.graphs import Graph as RefGraph
from repro.core.templates import template as ref_template
from repro_torch.api import Counter
from repro_torch.core import frontier, prng
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import (
    build_counting_plan,
    build_multi_counting_plan,
    colorful_map_count,
    colorful_map_count_checked,
    colorful_map_count_many,
    colorful_map_count_many_checked,
    count_fn,
    count_fn_many,
)
from repro_torch.core.graphs import rmat
from repro_torch.core.templates import path_tree, spider_tree, template
from repro_torch.launch import count as launch_count
from repro_torch.testing import faults

FAMILY = ("u3-1", "u5-2", "u7-2")


@pytest.fixture
def force_floors(monkeypatch):
    """Drop the profitability floors, in the port and in the reference, so
    that compaction engages on the small templates the CPU can afford."""
    for mod in (frontier, ref_frontier):
        monkeypatch.setattr(mod, "MIN_COMBINE_ELEMENTS", 1)
        monkeypatch.setattr(mod, "MIN_TABLE_WIDTH", 1)


def _ref_graph(g):
    return RefGraph(g.n, g.indptr, g.indices, g.name)


def _skewed():
    """The reference's compaction graph: maps past 2^24, so held within the
    port only, and against the reference's flags and spec."""
    return rmat(1024, 3000, skew=8, seed=2)


def _exact():
    """Sparse enough that u7-2's maps stay below 2^24 (0.4-0.7M), with a
    table cap and combine caps engaged at threshold 0.7."""
    return rmat(1024, 1000, skew=3, seed=2)


def _colorings(n, k, batch, seed=0):
    return np.random.default_rng(seed).integers(0, k, (batch, n)).astype(np.int32)


def _padded(colorings, n_pad):
    out = np.zeros((colorings.shape[0], n_pad), np.int32)
    out[:, : colorings.shape[1]] = colorings
    return out


def _plans(g, program, **kw):
    """The port's and the reference's plans of ``program`` ("chain": u7-2;
    "family": the spiders' DAG) on ``g``."""
    if program == "chain":
        return (build_counting_plan(g, template("u7-2"), device="cpu", **kw),
                ref_build(_ref_graph(g), ref_template("u7-2"), impl="xla", **kw))
    return (build_multi_counting_plan(g, FAMILY, device="cpu", **kw),
            ref_build_multi(_ref_graph(g), [ref_template(t) for t in FAMILY], impl="xla", **kw))


def _program(plan):
    return plan.chain if hasattr(plan, "chain") else plan.dag


@pytest.mark.parametrize("program", ["chain", "family"])
def test_probe_masks_equal_reference(program):
    """The port's batched probe (SpMM and combine on 0/1 tables, clamped)
    gives the reference's boolean DP's masks, probe for probe."""
    g = _skewed()
    port, ref = _plans(g, program)
    acts = frontier._probe_activity_batched(g, _program(port), port.combine, port.k, probes=3,
                                            seed=5)
    ref_acts = list(ref_frontier.probe_activity(_ref_graph(g), _program(ref), ref.combine, ref.k,
                                                probes=3, seed=5))
    assert len(ref_acts) == 3
    for p, ra in enumerate(ref_acts):
        assert set(acts) == set(ra)
        for i, a in ra.items():
            np.testing.assert_array_equal(acts[i].table[p].numpy(), a.table)
            np.testing.assert_array_equal(acts[i].gather[p].numpy(), a.gather)
    assert frontier._probe_activity_batched(g, _program(port), port.combine, port.k,
                                            probes=0) == {}


def _assert_probe_equal(got, want):
    """One probe's ``{node: NodeActivity}``: the same nodes in the same
    order, each mask an ``[n]`` numpy bool array equal bit for bit."""
    assert list(got) == list(want)
    for i, a in want.items():
        for mine, theirs in zip(got[i], a):
            assert isinstance(mine, np.ndarray) and mine.dtype == theirs.dtype == np.bool_
            np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("program", ["chain", "family"])
def test_probe_activity_is_the_reference_generator(program):
    """``probe_activity`` is the reference's generator: the reference's own
    idiom (``tests/test_compaction.py``: ``next(...)`` and ``.mean()`` on
    a mask) runs on it, ``list`` gives one dict a probe equal to the
    reference's, and ``probes=0`` yields nothing."""
    g = _skewed()
    port, ref = _plans(g, program)
    args = (_program(port), port.combine, port.k)
    ref_args = (_ref_graph(g), _program(ref), ref.combine, ref.k)
    gen = frontier.probe_activity(g, *args, probes=1, seed=5)
    first = next(gen)
    _assert_probe_equal(first, next(ref_frontier.probe_activity(*ref_args, probes=1, seed=5)))
    assert next(gen, None) is None
    dens = {i: m.table.mean() for i, m in first.items()}
    assert all(0.0 <= d <= 1.0 for d in dens.values())
    got = list(frontier.probe_activity(g, *args, probes=3, seed=5))
    want = list(ref_frontier.probe_activity(*ref_args, probes=3, seed=5))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _assert_probe_equal(a, b)
    assert list(frontier.probe_activity(g, *args, probes=0)) == []


@pytest.mark.parametrize("kind", ["edges", "blocks"])
@pytest.mark.parametrize("program", ["chain", "family"])
@pytest.mark.parametrize("threshold,probes", [(0.7, 2), (0.3, 1), (1.0, 3)])
def test_spec_equals_reference(force_floors, program, kind, threshold, probes):
    """Densities, gather densities, table and combine capacities ==
    ``single_device_compaction``'s; a block plan gets no table caps."""
    g = _skewed()
    kw = dict(spmm_kind=kind, compact=True, density_threshold=threshold, probes=probes)
    port, ref = _plans(g, program, **kw)
    a, b = port.compaction, ref.compaction
    assert a.density == dict(b.density) and a.gather_density == dict(b.gather_density)
    assert a.table_caps == dict(b.table_caps) and a.combine_caps == dict(b.combine_caps)
    assert (a.threshold, a.capacity_factor, a.probes) == (b.threshold, b.capacity_factor,
                                                           b.probes)
    assert a.enabled == b.enabled and a.combine_caps
    if kind == "blocks":
        assert not a.table_caps


def test_floors_gate_as_reference():
    """At the shipped floors the narrow u7-2 nodes stay dense, as in the
    reference (MIN_COMBINE_ELEMENTS, MIN_TABLE_WIDTH)."""
    port, ref = _plans(_skewed(), "chain", compact=True, density_threshold=0.7)
    assert port.compaction.table_caps == dict(ref.compaction.table_caps)
    assert port.compaction.combine_caps == dict(ref.compaction.combine_caps)
    assert (frontier.MIN_COMBINE_ELEMENTS, frontier.MIN_TABLE_WIDTH,
            frontier.DEFAULT_DENSITY_THRESHOLD, frontier.DEFAULT_CAPACITY_FACTOR) == (
        ref_frontier.MIN_COMBINE_ELEMENTS, ref_frontier.MIN_TABLE_WIDTH,
        ref_frontier.DEFAULT_DENSITY_THRESHOLD, ref_frontier.DEFAULT_CAPACITY_FACTOR)


def test_capacity_and_density_models_equal_reference():
    for max_active in (0, 1, 10, 127, 128, 1000, 5000):
        for factor in (1e-6, 0.5, 1.0, 1.5, 2.0):
            for limit in (64, 128, 1536, 1537, 10_000):
                for multiple in (8, 128):
                    assert frontier.capacity_for(max_active, factor, limit, multiple) == \
                        ref_frontier.capacity_for(max_active, factor, limit, multiple)
    for t in range(1, 13):
        for k in (t, 12, 15):
            for d in (1.0, 1.47, 2.0, 19.0, 449.0):
                assert frontier.model_density(t, k, d) == ref_frontier.model_density(t, k, d)


@pytest.mark.parametrize("program", ["chain", "family"])
def test_sampled_density_equals_reference(program):
    port, ref = _plans(_skewed(), program)
    for n, d in ((512, 2.0), (3000, 5.9)):
        got = frontier.sampled_density(n, d, _program(port), port.combine, port.k,
                                       sample_vertices=1024, probes=2, seed=3)
        want = ref_frontier.sampled_density(n, d, _program(ref), ref.combine, ref.k,
                                            sample_vertices=1024, probes=2, seed=3)
        assert got == want


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["edges", "blocks"])
@pytest.mark.parametrize("fuse", [False, True])
def test_compact_equals_dense_and_reference(force_floors, fuse, kind, batch):
    """Compact == dense bit for bit, on fixed colorings and through
    ``count_fn``'s keyed colorings; == the reference's dense program."""
    g = _exact()
    tree = template("u7-2")
    dense = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device="cpu")
    comp = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device="cpu", compact=True,
                               density_threshold=0.7)
    assert comp.compaction.enabled and comp.compaction.combine_caps
    assert bool(comp.compaction.table_caps) == (kind == "edges")
    cols = _colorings(g.n, tree.n, batch, seed=batch)
    got, ok = colorful_map_count_checked(comp, cols)
    assert bool(ok.all()) and ok.shape == (batch,)
    want = colorful_map_count(dense, cols)
    assert torch.equal(got, want)
    rplan = ref_build(_ref_graph(g), ref_template("u7-2"), spmm_kind=kind, impl="xla")
    ref = [float(ref_count(rplan, jnp.asarray(c))) for c in _padded(cols, rplan.n_pad)]
    assert got.tolist() == ref and max(ref) < 2 ** 24
    key = prng.key(batch)
    fc = count_fn(comp, batch)
    (mc, ec), (md, ed) = fc(key), count_fn(dense, batch)(key)
    assert torch.equal(mc, md) and torch.equal(ec, ed) and fc.fallbacks == 0


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("program", ["chain", "family"])
def test_count_fn_scalar_contract_equals_reference(force_floors, program, compact):
    """``count_fn`` and ``count_fn_many`` without a batch: the reference's
    scalar contract, ``(maps, estimate)`` 0-d (``[R]`` for a family) for the
    one coloring the key draws, on a compacted plan too; == the reference's
    own, and == the first sample of ``batch=1``."""
    g = _exact()
    kw = dict(compact=True, density_threshold=0.7) if compact else {}
    port, ref = _plans(g, program, **kw)
    assert (port.compaction is not None and port.compaction.enabled) == compact
    fn, ref_fn = ((count_fn, ref_count_fn) if program == "chain"
                  else (count_fn_many, ref_count_fn_many))
    f = fn(port)
    maps, est = f(prng.key(7))
    rmaps, rest = ref_fn(ref)(jax.random.key(7))
    assert maps.shape == est.shape == np.shape(rmaps) == (() if program == "chain"
                                                            else (len(FAMILY),))
    assert maps.max() < 2 ** 24
    np.testing.assert_array_equal(maps.numpy(), np.asarray(rmaps, np.float64))
    np.testing.assert_allclose(est.numpy(), np.asarray(rest, np.float64), rtol=1e-6)
    one = fn(port, 1)(prng.key(7))
    assert torch.equal(maps, one[0][0]) and torch.equal(est, one[1][0])
    assert getattr(f, "fallbacks", 0) == 0


@pytest.mark.parametrize("program", ["chain", "family"])
@pytest.mark.parametrize("factor", [1e-6, 0.5, 1.5])
def test_overflow_flags_equal_reference(force_floors, program, factor):
    """The port's per-coloring flags ``[B]`` == the reference's vmapped
    ``ok`` on the same colorings; where they all hold the counts are the
    dense ones."""
    g = _skewed()
    port, ref = _plans(g, program, compact=True, density_threshold=0.7, capacity_factor=factor)
    cols = _colorings(g.n, port.k, 5, seed=11)
    if program == "chain":
        maps, ok = colorful_map_count_checked(port, cols)
        _, rok = jax.vmap(lambda c: ref_checked(ref, c))(jnp.asarray(_padded(cols, ref.n_pad)))
        dense = colorful_map_count(port, cols)
    else:
        maps, ok = colorful_map_count_many_checked(port, cols)
        _, rok = jax.vmap(lambda c: ref_many_checked(ref, c))(
            jnp.asarray(_padded(cols, ref.n_pad)))
        dense = colorful_map_count_many(port, cols)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert bool(ok.all()) == (factor == 1.5)
    assert torch.equal(maps[ok], dense[ok])


def test_overflow_falls_back_to_dense(force_floors):
    """A capacity too small for every coloring trips the flags; ``count_fn``
    re-runs the batch on the dense twin and returns its counts exactly."""
    g = _skewed()
    tree = template("u5-2")
    dense = build_counting_plan(g, tree, device="cpu")
    tiny = build_counting_plan(g, tree, device="cpu", compact=True, density_threshold=1.0,
                               capacity_factor=1e-6)
    assert tiny.compaction.enabled
    cols = _colorings(g.n, tree.n, 3)
    _, ok = colorful_map_count_checked(tiny, cols)
    assert not bool(ok.any())
    ft = count_fn(tiny, 3)
    key = prng.key(1)
    (mt, et), (md, ed) = ft(key), count_fn(dense, 3)(key)
    assert torch.equal(mt, md) and torch.equal(et, ed) and ft.fallbacks == 1


def test_fault_site_forces_the_dense_twin(force_floors):
    g = _exact()
    comp = build_counting_plan(g, template("u7-2"), device="cpu", compact=True,
                               density_threshold=0.7)
    dense = build_counting_plan(g, template("u7-2"), device="cpu")
    f = count_fn(comp, 2)
    with faults.active(faults.inject("compaction.overflow", at=(1,))) as plan:
        first, second = f(prng.key(3)), f(prng.key(4))
    assert plan.fired == [("compaction.overflow", 1)] and f.fallbacks == 1
    for got, key in ((first, 3), (second, 4)):
        assert torch.equal(got[0], count_fn(dense, 2)(prng.key(key))[0])


def test_colorful_map_count_stays_dense(force_floors):
    """The unchecked entry point keeps its dense contract on a compacted
    plan whose every capacity overflows."""
    g = _skewed()
    comp = build_counting_plan(g, template("u5-2"), device="cpu", compact=True,
                               density_threshold=1.0, capacity_factor=1e-6)
    dense = build_counting_plan(g, template("u5-2"), device="cpu")
    cols = _colorings(g.n, 5, 2)
    assert torch.equal(colorful_map_count(comp, cols), colorful_map_count(dense, cols))


@pytest.mark.parametrize("fuse", [False, True])
def test_family_compact_equals_dense_and_reference(force_floors, fuse):
    g = _exact()
    dense = build_multi_counting_plan(g, FAMILY, device="cpu", fuse=fuse)
    comp = build_multi_counting_plan(g, FAMILY, device="cpu", fuse=fuse, compact=True,
                                     density_threshold=0.7)
    assert comp.compaction.table_caps and comp.compaction.combine_caps
    key = prng.key(2)
    fc = count_fn_many(comp, 3)
    (mc, ec), (md, ed) = fc(key), count_fn_many(dense, 3)(key)
    assert torch.equal(mc, md) and torch.equal(ec, ed) and fc.fallbacks == 0
    rplan = ref_build_multi(_ref_graph(g), [ref_template(t) for t in FAMILY], impl="xla")
    cols = _colorings(g.n, comp.k, 2, seed=4)
    got = colorful_map_count_many_checked(comp, cols)[0]
    for c, row in zip(_padded(cols, rplan.n_pad), got.tolist()):
        assert row == np.asarray(ref_count_many(rplan, jnp.asarray(c))).tolist()


def test_estimate_many_compact_equals_dense(force_floors):
    g = _exact()
    opts = dict(device="cpu", compact=True, density_threshold=0.7)
    comp = Counter.from_graph(g, "u7-2", **opts)
    dense = Counter.from_graph(g, "u7-2", device="cpu")
    a = comp.estimate_many(FAMILY, n_iter=6, batch=3, key=prng.key(5))
    b = dense.estimate_many(FAMILY, n_iter=6, batch=3, key=prng.key(5))
    assert np.array_equal(a.samples, b.samples)
    assert comp._family(FAMILY)["plan"].compaction.enabled
    cols = _colorings(g.n, 7, 1)[0]
    assert np.array_equal(comp.count_coloring_many(FAMILY, cols),
                          dense.count_coloring_many(FAMILY, cols))


def test_bag_programs_and_mixed_families_run_dense():
    g = rmat(64, 200, skew=3, seed=1)
    assert build_counting_plan(g, template("cycle4"), device="cpu",
                               compact=True).compaction is None
    mixed = build_multi_counting_plan(g, ("u3-1", "cycle4"), device="cpu", compact=True,
                                      density_threshold=1.0)
    assert mixed.compaction is None
    assert build_counting_plan(g, template("u5-2"), device="cpu",
                               compact=True).compaction is not None


def test_compacted_plan_needs_the_card_or_the_cpu(monkeypatch):
    """A compacted plan, its probe included, is built on the card unless the
    caller names the CPU; with no card it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat(64, 200, skew=3, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_counting_plan(g, template("u5-2"), compact=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Counter.from_graph(g, "u5-2", compact=True).plan
    assert build_counting_plan(g, template("u5-2"), device="cpu", compact=True).compaction


def test_resume_under_overflow_storm(tmp_path, force_floors):
    """Resume composes with compaction, including a forced overflow storm
    on the resumed leg: the samples equal an uninterrupted run's bitwise
    (the reference's ``test_resume_under_compaction``)."""
    g = rmat(256, 700, skew=8, seed=2)
    opts = dict(device="cpu", compact=True, density_threshold=0.7)
    key = prng.key(2)
    base = Counter.from_graph(g, "u5-2", **opts).estimate(n_iter=8, key=key, batch=4)
    d = tmp_path / "compact"
    c = Counter.from_graph(g, "u5-2", **opts)
    with faults.active(faults.inject("estimator.kill", at=(0,))):
        with pytest.raises(faults.InjectedCrash):
            c.estimate(n_iter=8, key=key, batch=4, checkpoint=str(d), checkpoint_every=4)
    c2 = Counter.from_graph(g, "u5-2", **opts)
    assert c2.plan.compaction.enabled
    with faults.active(faults.inject("compaction.overflow", at=None)) as plan:
        res = c2.estimate(n_iter=8, key=key, batch=4, resume=str(d))
        assert plan.fired
    assert res.resumed_from == 4
    np.testing.assert_array_equal(res.samples, base.samples)
    assert res.estimate == base.estimate


def test_api_accepts_compaction_opts(force_floors):
    g = rmat(256, 800, skew=8, seed=5)
    c = Counter.from_graph(g, path_tree(4), device="cpu", compact=True, density_threshold=1.0,
                           capacity_factor=1.2, probes=1)
    spec = c.plan.compaction
    assert (spec.threshold, spec.capacity_factor, spec.probes) == (1.0, 1.2, 1)
    assert spec.enabled
    coloring = _colorings(g.n, 4, 1, seed=8)[0]
    want = count_colorful_maps(g, path_tree(4), coloring)
    assert c.count_coloring(coloring) == want
    assert Counter.from_graph(g, path_tree(4), device="cpu").count_coloring(coloring) == want
    with pytest.raises(TypeError, match="unknown plan_opts"):
        Counter.from_graph(g, path_tree(3), device="cpu", compacct=True)


def test_count_coloring_falls_back_on_overflow(force_floors):
    g = rmat(256, 800, skew=8, seed=5)
    tree = spider_tree([2, 1])
    tiny = Counter.from_graph(g, tree, device="cpu", compact=True, density_threshold=1.0,
                              capacity_factor=1e-6)
    coloring = _colorings(g.n, tree.n, 1, seed=3)[0]
    assert not bool(colorful_map_count_checked(tiny.plan, coloring)[1])
    assert tiny.count_coloring(coloring) == count_colorful_maps(g, tree, coloring)


def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_count.main(argv)
    return buf.getvalue().splitlines()


def _estimates(lines):
    return [ln for ln in lines if ln.startswith("estimate")]


def test_launcher_bench_sparse_equals_dense():
    """bench-sparse (compact, threshold 0.5) prints the probed densities and
    engaged caps, and the estimates of the same run with no node engaged."""
    base = ["--config", "bench-sparse", "--iters", "4", "--batch", "2", "--device", "cpu"]
    comp, dense = _launch(base), _launch(base + ["--density-threshold", "-1"])
    report = [ln for ln in comp if ln.startswith("compaction")]
    assert report[0].startswith("compaction: threshold 0.5 node densities: n")
    assert report[1].startswith("compaction caps: {'combine[")
    assert "table[" in report[1]
    assert "compaction caps: none engaged" in dense
    assert len(_estimates(comp)) == 2 and _estimates(comp) == _estimates(dense)


def test_launcher_compact_flags():
    """--compact on a dense row, with --probes and --capacity-factor: the
    report shows the knobs, and the estimates equal the plain run's."""
    base = ["--config", "bench-small", "--iters", "4", "--batch", "2", "--device", "cpu"]
    comp = _launch(base + ["--compact", "--density-threshold", "0.9", "--probes", "1",
                           "--capacity-factor", "2"])
    assert any(ln.startswith("compaction: threshold 0.9 node densities: n") for ln in comp)
    assert _estimates(comp) == _estimates(_launch(base))


def test_compact_parity_property(force_floors):
    """The reference's property sweep (compaction on vs off agree bitwise on
    keyed counts and samples over random skewed graphs, templates and
    capacity factors, small enough to overflow), with the skew drawn from
    the R-MAT skews ``rmat`` knows."""
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @given(
        st.integers(100, 500),
        st.sampled_from([1, 3, 8]),
        st.sampled_from(["p4", "sp21", "u5-2"]),
        st.floats(0.05, 2.0),
        st.integers(0, 10_000),
    )
    @settings(max_examples=8, deadline=None,
              suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
    def check(n, skew, tname, cf, seed):
        g = rmat(n, 3 * n, skew=skew, seed=seed)
        tree = {"p4": path_tree(4), "sp21": spider_tree([2, 1]), "u5-2": template("u5-2")}[tname]
        dense = build_counting_plan(g, tree, device="cpu")
        comp = build_counting_plan(g, tree, device="cpu", compact=True, density_threshold=1.0,
                                   capacity_factor=cf, probes=1)
        key = prng.key(seed)
        (md, ed), (mc, ec) = count_fn(dense, 2)(key), count_fn(comp, 2)(key)
        assert torch.equal(md, mc) and torch.equal(ed, ec)

    check()
