"""Treewidth-2 bag programs in the port (CPU, plain versions) against the
JAX reference (``impl="xla"``) and the brute-force oracle.

Every registry row that is not a tree (cycle3-cycle6, diamond, bowtie,
house) compiles to the reference's bag program and counts, on fixed
colorings, exactly (``==``) what the reference and brute force count: the
counts stay below 2^24, so the float32 sums (the collapse over ``v``, the
combine, the root sum) are exact in any order.  Copy estimates are held to
``RTOL``, because the reference scales its maps in float32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Counter as RefCounter
from repro.core import templates as ref_templates
from repro.core.count_engine import build_counting_plan as ref_build_plan
from repro.core.count_engine import colorful_map_count as ref_count
from repro.core.graphs import Graph as RefGraph
from repro_torch.api import Counter
from repro_torch.core import prng, templates
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import build_counting_plan, colorful_map_count, count_fn
from repro_torch.core.graphs import erdos_renyi, rmat
from repro_torch.core.table_program import build_node_tables, run_table_program
from repro_torch.launch import count as launch_count

#: two float32 ulps: the reference's scale and its product round in float32
RTOL = 2.4e-7

BAG_NAMES = ["cycle3", "cycle4", "cycle5", "cycle6", "diamond", "bowtie", "house"]


def _ref_graph(g):
    return RefGraph(g.n, g.indptr, g.indices, g.name)


def _node_fields(nd):
    return (type(nd).__name__,) + tuple(vars(nd).values())


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(22, 7.0, seed=5)


@pytest.mark.parametrize("name", BAG_NAMES)
def test_registry_rows_equal_reference(name):
    t, rt = templates.template(name), ref_templates.template(name)
    assert isinstance(t, templates.Template) and not t.is_tree
    assert (t.n, t.edges, t.name) == (rt.n, rt.edges, rt.name)
    assert templates.automorphism_count(t) == ref_templates.automorphism_count(rt)
    assert templates.rooted_signature(t) == ref_templates.rooted_signature(rt)
    prog, ref = templates.bag_program(t), ref_templates.bag_program(rt)
    assert [_node_fields(nd) for nd in prog.nodes] == [_node_fields(nd) for nd in ref.nodes]
    assert prog.k == ref.k and prog.roots == ref.roots
    assert prog.table_reads() == ref.table_reads()
    assert templates.program_has_bags(prog)
    wide = templates.bag_program(t, n_colors=t.n + 2)
    assert wide.k == t.n + 2 and wide.nodes == prog.nodes


def test_template_validation_and_helpers():
    for edges, msg in ((((0, 0),), "self-loop"), (((0, 5),), "out of range"),
                       (((0, 1), (1, 0)), "duplicate"), (((0, 1),), "connected")):
        with pytest.raises(ValueError, match=msg):
            templates.Template(3 if msg == "connected" else 2, edges)
    assert templates.cycle_template(5).edges == ref_templates.cycle_template(5).edges
    with pytest.raises(ValueError, match="at least 3"):
        templates.cycle_template(2)
    k4 = templates.Template(4, ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)), "k4")
    with pytest.raises(ValueError, match="not apex-reducible"):
        templates.bag_program(k4)
    with pytest.raises(ValueError, match="not apex-reducible"):
        ref_templates.bag_program(ref_templates.Template(k4.n, k4.edges, "k4"))
    assert templates.automorphism_count(k4) == 24
    with pytest.raises(ValueError, match="is a tree"):
        templates.bag_program(templates.Template(3, ((0, 1), (1, 2))))
    with pytest.raises(ValueError, match="smaller than the template"):
        templates.bag_program(templates.template("cycle5"), n_colors=4)
    with pytest.raises(KeyError, match="unknown template"):
        templates.template("cycle7")


def test_tree_shaped_template_takes_the_tree_path(graph):
    """A Template that is a tree compiles and counts bit-identically to the
    same Tree."""
    tree = templates.template("u5-2")
    as_template = templates.Template(tree.n, tree.edges, "u5-2")
    assert templates.template_program(as_template) == templates.partition_tree(tree)
    assert templates.automorphism_count(as_template) == templates.automorphism_count(tree)
    plan = build_counting_plan(graph, as_template, device="cpu")
    assert isinstance(plan.tree, templates.Tree) and plan.pin_adj is None
    col = np.random.default_rng(0).integers(0, 5, graph.n)
    assert colorful_map_count(plan, col) == colorful_map_count(
        build_counting_plan(graph, tree, device="cpu"), col)


def test_bag_node_widths():
    prog = templates.bag_program(templates.template("bowtie"))
    _, widths = build_node_tables(prog, 5, device=torch.device("cpu"), x_dim=7)
    kinds = [nd.kind for nd in prog.nodes]
    assert kinds.count("bag_join") == 1
    for i, nd in enumerate(prog.nodes):
        # leaves and combines hold x = 7 blocks; collapses and joins live on the x axis
        per_x = 7 if nd.kind in ("bag_leaf", "bag_combine") else 1
        assert widths[i] == per_x * math.comb(5, nd.size)
    with pytest.raises(ValueError, match="x_dim"):
        build_node_tables(prog, 5, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="BagFns"):
        run_table_program(prog, {}, torch.zeros(128, 1, 5), 5, None, lambda t: t)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", BAG_NAMES)
def test_fixed_coloring_exact(graph, name, fuse):
    t = templates.template(name)
    plan = build_counting_plan(graph, t, fuse=fuse, device="cpu")
    rplan = ref_build_plan(_ref_graph(graph), ref_templates.template(name), impl="xla",
                           fuse=fuse)
    for seed in range(2):
        col = np.random.default_rng(seed).integers(0, t.n, graph.n).astype(np.int32)
        want = count_colorful_maps(graph, t, col)
        rcol = np.zeros(rplan.n_pad, np.int32)
        rcol[: graph.n] = col
        assert float(colorful_map_count(plan, col)) == want
        assert float(ref_count(rplan, jnp.asarray(rcol))) == want


@pytest.mark.parametrize("name", ["cycle4", "diamond", "bowtie"])
def test_widened_colors_exact(graph, name):
    t = templates.template(name)
    plan = build_counting_plan(graph, t, n_colors=t.n + 2, device="cpu")
    col = np.random.default_rng(3).integers(0, t.n + 2, (3, graph.n)).astype(np.int32)
    got = colorful_map_count(plan, col).numpy()
    np.testing.assert_array_equal(got, [count_colorful_maps(graph, t, c) for c in col])


def test_blocks_plan_and_batches_agree():
    """A bag table runs through the block SpMM as it does through the edge
    walk; each coloring of a batch filters the apex axis by its own colors."""
    g = rmat(48, 200, skew=3, seed=2)
    t = templates.template("cycle5")
    cols = np.random.default_rng(5).integers(0, 5, (3, g.n)).astype(np.int32)
    want = [count_colorful_maps(g, t, c) for c in cols]
    for kind in ("edges", "blocks"):
        plan = build_counting_plan(g, t, spmm_kind=kind, device="cpu")
        np.testing.assert_array_equal(colorful_map_count(plan, cols).numpy(), want)


@pytest.mark.parametrize("name", ["cycle3", "cycle6", "house"])
def test_count_fn_equals_reference(graph, name):
    plan = build_counting_plan(graph, templates.template(name), device="cpu")
    rplan = ref_build_plan(_ref_graph(graph), ref_templates.template(name), impl="xla")
    from repro.core.count_engine import count_fn as ref_count_fn

    maps, ests = count_fn(plan, 4)(prng.key(6))
    rmaps, rests = ref_count_fn(rplan, batch=4)(jax.random.key(6))
    np.testing.assert_array_equal(maps.numpy(), np.asarray(rmaps, np.float64))
    np.testing.assert_allclose(ests.numpy(), np.asarray(rests, np.float64), rtol=RTOL)


def test_counter_estimate_by_name_equals_reference(graph):
    res = Counter.from_graph(graph, "cycle6", device="cpu").estimate(
        n_iter=12, batch=4, key=prng.key(8))
    ref = RefCounter.from_graph(_ref_graph(graph), "cycle6", backend="single",
                                impl="xla").estimate(n_iter=12, batch=4, key=jax.random.key(8))
    np.testing.assert_allclose(res.samples, ref.samples, rtol=RTOL)
    assert res.estimate == pytest.approx(ref.estimate, rel=RTOL)
    assert res.template == ref.template == "cycle6"
    c = Counter.from_graph(graph, "cycle6", device="cpu")
    assert c.count_coloring(np.arange(graph.n) % 6) == RefCounter.from_graph(
        _ref_graph(graph), "cycle6", backend="single", impl="xla").count_coloring(
        np.arange(graph.n) % 6)


def _launch(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_count.main(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("config,names", [
    ("bench-cycles", ("cycle3", "cycle5", "diamond")),
    ("bench-tw2-mixed", ("u3-1", "cycle4", "u5-2", "cycle6", "diamond")),
])
def test_launcher_treewidth2_rows_run(config, names):
    """The rows' family runs, fused and unfused print the same estimates,
    and each equals ``Counter.estimate_many`` on the row's graph."""
    from repro_torch.configs.subgraph import COUNTING_CONFIGS

    base = ["--config", config, "--iters", "4", "--batch", "2", "--device", "cpu"]
    plain, fused = _launch(base), _launch(base + ["--fuse"])
    est = lambda lines: [ln for ln in lines if "median-of-means" in ln]  # noqa: E731
    assert len(est(plain)) == len(names) and est(plain) == est(fused)
    res = Counter.from_graph(COUNTING_CONFIGS[config].synthesize(), names[0],
                             device="cpu").estimate_many(names, n_iter=4, batch=2,
                                                         key=prng.key(0))
    for line, one in zip(est(plain), res):
        assert line.split(":")[0].strip() == one.template
        assert f"median-of-means {one.estimate:.6g} " in line
