"""Family counting in the port (CPU, plain versions) against the JAX
reference (``impl="xla"``) and the brute-force oracle.

The same inputs go through both packages: graphs from a numpy seed, fixed
colorings from ``np.random.default_rng``, and threefry keys that draw the
same colorings on either side.  Tolerances: the compiled DAGs, signatures,
automorphism counts and colorful map counts are held ``==`` (every count
here stays below 2^24, so float32 sums are exact in any order); per-coloring
copy estimates are held to ``RTOL``, because the reference scales its maps
in float32 and the port in float64; within the port, family and
per-template runs, and a resumed and an uninterrupted run, are held ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import Counter as RefCounter
from repro.core import templates as ref_templates
from repro.core.count_engine import build_multi_counting_plan as ref_build_multi
from repro.core.count_engine import colorful_map_count_many as ref_count_many
from repro.core.count_engine import count_fn_many as ref_count_fn_many
from repro.core.graphs import Graph as RefGraph
from repro_torch.api import Counter
from repro_torch.core import prng, templates
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import (
    build_multi_counting_plan,
    colorful_map_count_many,
    count_fn_many,
    draw_colorings,
)
from repro_torch.core.estimator import EstimatorState, estimate_counts_many
from repro_torch.core.graphs import erdos_renyi
from repro_torch.launch import count as launch_count
from repro_torch.testing import faults
from repro_torch.train.checkpoint import CheckpointManager

#: two float32 ulps: the reference's scale and its product round in float32
RTOL = 2.4e-7

SPIDERS = ("u3-1", "u5-2", "u7-2")
FAMILIES = {
    "spiders": SPIDERS,
    "rmat500-family": ("u5-2", "u7-2", "u10-2"),
    "bench-cycles": ("cycle3", "cycle5", "diamond"),
    "bench-tw2-mixed": ("u3-1", "cycle4", "u5-2", "cycle6", "diamond"),
}
#: the families small enough for brute force and the reference's DP here
COUNTED = ("spiders", "bench-cycles", "bench-tw2-mixed")


def _ref_graph(g):
    return RefGraph(g.n, g.indptr, g.indices, g.name)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(120, 5.0, seed=2)


@pytest.fixture(scope="module")
def bag_graph():
    """Bag tables grow as n^2: the treewidth-2 families run on a smaller graph."""
    return erdos_renyi(30, 5.0, seed=4)


def _graph_for(name, graph, bag_graph):
    return bag_graph if any(t.startswith(("cycle", "diamond")) for t in FAMILIES[name]) else graph


def _node_fields(nd):
    return (type(nd).__name__,) + tuple(vars(nd).values())


@pytest.mark.parametrize("n_colors", [None, 11])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_compile_templates_equals_reference(family, n_colors):
    names = FAMILIES[family]
    dag = templates.compile_templates(names, n_colors=n_colors)
    ref = ref_templates.compile_templates(names, n_colors=n_colors)
    assert [_node_fields(nd) for nd in dag.nodes] == [_node_fields(nd) for nd in ref.nodes]
    assert dag.sigs == ref.sigs
    assert dag.roots == ref.roots
    assert dag.k == ref.k
    assert dag.table_reads() == ref.table_reads()
    assert [t.name for t in dag.templates] == [t.name for t in ref.templates]


def test_rmat500_family_shares_its_chains():
    """The reckoning of the full-width family: 11 nodes, 10 internal, against
    19 internal nodes of the three chains; the widest table C(10, 5)."""
    dag = templates.compile_templates(FAMILIES["rmat500-family"], n_colors=10)
    chains = [templates.template_program(n) for n in FAMILIES["rmat500-family"]]
    assert len(dag.nodes) == 11 and len(dag.internal_nodes()) == 10
    assert sum(len(c.internal_nodes()) for c in chains) == 19
    assert max(nd.size for nd in dag.nodes) == 10
    mixed = templates.compile_templates(FAMILIES["bench-tw2-mixed"], n_colors=6)
    kinds = [nd.kind for nd in mixed.nodes]
    assert len(kinds) == 17
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "leaf": 1, "combine": 4, "bag_leaf": 2, "bag_combine": 7, "bag_collapse": 3}


@pytest.mark.parametrize("names", [SPIDERS, ("u5-2", "u5-2", "u3-1"), ("cycle5", "diamond"),
                                   ("cycle4", "bowtie", "house")])
def test_family_signature_equals_reference(names):
    assert templates.family_signature(names) == ref_templates.family_signature(names)
    assert templates.family_signature(names, 9) == ref_templates.family_signature(names, 9)
    for name in names:
        assert templates.rooted_signature(name) == ref_templates.rooted_signature(name)
        assert (templates.automorphism_count(templates.template(name))
                == ref_templates.automorphism_count(ref_templates.template(name)))


def test_family_signature_mixed_raises_as_reference():
    """Tree and bag signatures do not order against each other, in either
    package: a mixed family has no family signature (ROADMAP queue 3)."""
    with pytest.raises(TypeError):
        ref_templates.family_signature(("u5-2", "cycle4"))
    with pytest.raises(TypeError):
        templates.family_signature(("u5-2", "cycle4"))


def test_compile_validation():
    with pytest.raises(ValueError, match="at least one"):
        templates.compile_templates([])
    with pytest.raises(ValueError, match="smaller than the largest"):
        templates.compile_templates(SPIDERS, n_colors=5)
    with pytest.raises(ValueError, match="roots"):
        templates.compile_templates(SPIDERS, roots=(0,))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("family", COUNTED)
def test_fixed_colorings_equal_reference_and_brute_force(family, fuse, graph, bag_graph):
    g = _graph_for(family, graph, bag_graph)
    names = FAMILIES[family]
    plan = build_multi_counting_plan(g, names, fuse=fuse, device="cpu")
    rplan = ref_build_multi(_ref_graph(g), [ref_templates.template(n) for n in names],
                            impl="xla", fuse=fuse)
    rng = np.random.default_rng(7)
    cols = rng.integers(0, plan.k, (2, g.n)).astype(np.int32)
    got = colorful_map_count_many(plan, cols).numpy()
    assert got.shape == (2, len(names))
    for b in range(2):
        col = np.zeros(rplan.n_pad, np.int32)
        col[: g.n] = cols[b]
        want = [count_colorful_maps(g, templates.template(n), cols[b]) for n in names]
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(np.asarray(ref_count_many(rplan, jnp.asarray(col))), want)
        np.testing.assert_array_equal(colorful_map_count_many(plan, cols[b]).numpy(), want)


@pytest.mark.parametrize("family", COUNTED)
def test_count_fn_many_equals_reference(family, graph, bag_graph):
    g = _graph_for(family, graph, bag_graph)
    names = FAMILIES[family]
    plan = build_multi_counting_plan(g, names, device="cpu")
    rplan = ref_build_multi(_ref_graph(g), [ref_templates.template(n) for n in names],
                            impl="xla")
    maps, ests = count_fn_many(plan, 3)(prng.key(11))
    rmaps, rests = ref_count_fn_many(rplan, batch=3)(jax.random.key(11))
    assert maps.shape == (3, len(names)) and maps.max() < 2**24
    np.testing.assert_array_equal(maps.numpy(), np.asarray(rmaps, np.float64))
    np.testing.assert_allclose(ests.numpy(), np.asarray(rests, np.float64), rtol=RTOL)
    assert plan.scales == pytest.approx(rplan.scales, rel=1e-15)


@pytest.mark.parametrize("family", COUNTED)
def test_family_equals_per_template_plans(family, graph, bag_graph):
    """One family pass == each member's own plan with ``n_colors=k`` on the
    colorings both draw from one key."""
    from repro_torch.core.count_engine import build_counting_plan, count_fn

    g = _graph_for(family, graph, bag_graph)
    names = FAMILIES[family]
    plan = build_multi_counting_plan(g, names, fuse=True, device="cpu")
    maps, ests = count_fn_many(plan, 4)(prng.key(2))
    for r, name in enumerate(names):
        single = build_counting_plan(g, templates.template(name), n_colors=plan.k, device="cpu")
        assert draw_colorings(single, 4, prng.key(2)).equal(draw_colorings(plan, 4, prng.key(2)))
        smaps, sests = count_fn(single, 4)(prng.key(2))
        assert smaps.equal(maps[:, r]) and sests.equal(ests[:, r])


def test_estimate_many_equals_reference(graph):
    c = Counter.from_graph(graph, "u5-2", backend="single", device="cpu")
    r = RefCounter.from_graph(_ref_graph(graph), "u5-2", backend="single", impl="xla")
    res = c.estimate_many(SPIDERS, n_iter=12, batch=4, key=prng.key(3))
    ref = r.estimate_many(SPIDERS, n_iter=12, batch=4, key=jax.random.key(3))
    assert res.templates == ref.templates == SPIDERS
    assert (res.k, res.unique_tables, res.chain_tables, res.niter) == (
        ref.k, ref.unique_tables, ref.chain_tables, ref.niter) == (7, 6, 27, 12)
    np.testing.assert_allclose(res.samples, ref.samples, rtol=RTOL)
    np.testing.assert_allclose(res.estimates, ref.estimates, rtol=RTOL)
    np.testing.assert_allclose(res.means, ref.means, rtol=RTOL)
    assert res[1].template == "u5-2" and res[1].samples.shape == (12,)
    np.testing.assert_array_equal(
        c.count_coloring_many(SPIDERS, np.arange(graph.n) % 7),
        r.count_coloring_many(SPIDERS, np.arange(graph.n) % 7))
    assert (c._signature_extra(family=res.templates, k=7)
            == r._signature_extra(family=ref.templates, k=7))


def test_estimate_many_equals_n_colors_estimate(graph):
    """The family-parity invariant: a per-template ``estimate`` on a Counter
    with ``n_colors=k`` gives the family column's samples, bit for bit."""
    res = Counter.from_graph(graph, "u3-1", device="cpu").estimate_many(
        SPIDERS, n_iter=8, batch=4, key=prng.key(9))
    for i, name in enumerate(SPIDERS):
        one = Counter.from_graph(graph, name, device="cpu", n_colors=7).estimate(
            n_iter=8, batch=4, key=prng.key(9))
        np.testing.assert_array_equal(one.samples, res.samples[:, i])
        assert one.estimate == res.estimates[i]
    c = Counter.from_graph(graph, "u5-2", device="cpu", n_colors=7)
    r = RefCounter.from_graph(_ref_graph(graph), "u5-2", backend="single", impl="xla",
                              n_colors=7)
    assert c._signature_extra() == r._signature_extra()


@pytest.mark.parametrize("kill_at", [0, 1])
def test_estimate_many_resume_is_bit_identical(graph, tmp_path, kill_at):
    key = prng.key(4)
    names = ("u3-1", "cycle4")
    g = erdos_renyi(40, 4.0, seed=6)
    base = Counter.from_graph(g, "u3-1", device="cpu").estimate_many(
        names, n_iter=12, batch=4, key=key)
    d = tmp_path / "ckpt"
    with faults.active(faults.inject("estimator.kill", at=(kill_at,))):
        with pytest.raises(faults.InjectedCrash):
            Counter.from_graph(g, "u3-1", device="cpu").estimate_many(
                names, n_iter=12, batch=4, key=key, checkpoint=str(d), checkpoint_every=4)
    state = EstimatorState.from_arrays(CheckpointManager(str(d)).load_latest()[1]["estimator"])
    assert state.samples.shape == (4 * (kill_at + 1), 2)
    res = Counter.from_graph(g, "u3-1", device="cpu").estimate_many(
        names, n_iter=12, batch=4, key=key, resume=str(d))
    assert res.resumed_from == 4 * (kill_at + 1)
    np.testing.assert_array_equal(res.samples, base.samples)
    np.testing.assert_array_equal(res.estimates, base.estimates)
    np.testing.assert_array_equal(res.relative_sds, base.relative_sds)


def test_target_rsd_gates_on_worst_template(graph):
    c = Counter.from_graph(graph, "u3-1", device="cpu")
    r = RefCounter.from_graph(_ref_graph(graph), "u3-1", backend="single", impl="xla")
    res = c.estimate_many(SPIDERS, n_iter=64, batch=4, key=prng.key(1), target_rsd=0.05)
    ref = r.estimate_many(SPIDERS, n_iter=64, batch=4, key=jax.random.key(1), target_rsd=0.05)
    assert res.niter == ref.niter < 64
    np.testing.assert_allclose(res.samples, ref.samples, rtol=RTOL)


def test_estimate_counts_many_refuses_flat_samples():
    with pytest.raises(ValueError, match=r"\[batch, T\]"):
        estimate_counts_many(lambda key, b: np.ones(b), 4, prng.key(0), batch=2)


def _launch(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_count.main(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("templates_arg,message", [
    ("cycle5,notatmpl", "unknown template(s) notatmpl; registry has"),
    ("cycle5,cycle5", "duplicate template(s) in --templates: cycle5"),
    (" , ", "--templates is empty after parsing"),
])
def test_launcher_templates_errors(templates_arg, message, capsys):
    with pytest.raises(SystemExit):
        launch_count.main(["--config", "bench-small", "--iters", "1", "--device", "cpu",
                           "--templates", templates_arg])
    assert message in capsys.readouterr().err


def test_launcher_family_line_equals_smaller_family():
    """``--config bench-family`` prints a u5-2 line equal to a run of
    u5-2 with the same key and ``k`` (the family u5-2, u7-2: k = 7)."""
    base = ["--config", "bench-family", "--iters", "4", "--batch", "2", "--device", "cpu"]
    full = _launch(base)
    pair = _launch(base + ["--templates", "u5-2,u7-2", "--fuse"])
    line = lambda lines, name: [ln for ln in lines if ln.strip().startswith(f"{name}:")]  # noqa: E731
    assert any("family of 3 templates, k=7, 6 unique tables (vs 27 chain nodes)" in ln
               for ln in full)
    assert line(full, "u5-2") and line(full, "u5-2") == line(pair, "u5-2")
    assert line(full, "u7-2") == line(pair, "u7-2")
