"""The port's single-device engine (CPU, plain versions) against the JAX
reference's ``colorful_map_count`` (``impl="xla"``) and the brute-force
oracle, on the same CSR and the same fixed colorings."""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_counting_plan as ref_build_plan
from repro.core import colorful_map_count as ref_colorful_map_count
from repro.core.graphs import Graph as RefGraph
from repro_torch.core import prng, templates
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import (
    build_counting_plan,
    colorful_map_count,
    count_fn,
    draw_colorings,
)
from repro_torch.core.graphs import erdos_renyi, rmat, save_npz
from repro_torch.launch import count as launch_count


def _ref_tree(tree):
    from repro.core.templates import Tree

    return Tree(tree.n, tree.edges, tree.name)


def _ref_count(g, tree, coloring, root=0, spmm_kind="edges"):
    plan = ref_build_plan(RefGraph(g.n, g.indptr, g.indices), _ref_tree(tree), root=root,
                          spmm_kind=spmm_kind, impl="xla")
    col = np.zeros(plan.n_pad, np.int32)
    col[: g.n] = coloring
    return float(ref_colorful_map_count(plan, jnp.asarray(col)))


def _port_counts(g, tree, coloring, root=0):
    return [
        float(colorful_map_count(build_counting_plan(g, tree, root=root, fuse=f, device="cpu"),
                                 coloring))
        for f in (False, True)
    ]


TREES = {
    "path3": lambda: templates.path_tree(3),
    "path4": lambda: templates.path_tree(4),
    "star4": lambda: templates.star_tree(4),
    "star5": lambda: templates.star_tree(5),
    "spider21": lambda: templates.spider_tree([2, 1]),
    "spider221": lambda: templates.spider_tree([2, 2, 1]),
    "u5-2": lambda: templates.template("u5-2"),
    "u7-2": lambda: templates.template("u7-2"),
}
GRAPHS = {
    "er": lambda seed: erdos_renyi(24, 4.0, seed=seed),
    "rmat": lambda seed: rmat(32, 90, skew=3, seed=seed),
}


@pytest.mark.parametrize("tree_name", sorted(TREES))
@pytest.mark.parametrize("graph_name", sorted(GRAPHS))
def test_fixed_coloring_exact(tree_name, graph_name):
    tree = TREES[tree_name]()
    g = GRAPHS[graph_name](len(tree_name))
    coloring = np.random.default_rng(len(tree_name)).integers(0, tree.n, g.n).astype(np.int32)
    want = count_colorful_maps(g, tree, coloring)
    assert _port_counts(g, tree, coloring) == [want, want]
    assert _ref_count(g, tree, coloring) == want


@pytest.mark.parametrize("seed", range(3))
def test_random_trees(seed):
    rng = np.random.default_rng(100 + seed)
    tree = templates.random_tree(int(rng.integers(2, 7)), seed=seed)
    g = erdos_renyi(18, 3.5, seed=seed + 50)
    coloring = rng.integers(0, tree.n, g.n).astype(np.int32)
    want = count_colorful_maps(g, tree, coloring)
    assert _port_counts(g, tree, coloring) == [want, want]
    assert _ref_count(g, tree, coloring) == want


@pytest.mark.parametrize("root", [0, 1, 2])
def test_root_invariance(root):
    tree = templates.spider_tree([2, 2])
    g = rmat(24, 70, skew=3, seed=3)
    coloring = np.random.default_rng(7).integers(0, tree.n, g.n).astype(np.int32)
    want = count_colorful_maps(g, tree, coloring)
    assert _port_counts(g, tree, coloring, root=root) == [want, want]
    assert _ref_count(g, tree, coloring, root=root) == want


def test_u10_2_against_reference():
    tree = templates.template("u10-2")
    g = rmat(200, 400, skew=3, seed=11)  # 1.07e6 maps: every float32 sum exact
    coloring = np.random.default_rng(5).integers(0, tree.n, g.n).astype(np.int32)
    want = _ref_count(g, tree, coloring)
    assert want > 0
    assert _port_counts(g, tree, coloring) == [want, want]


@pytest.mark.parametrize("name", ["u3-1", "u5-2", "u7-2"])
@pytest.mark.parametrize("graph_name", sorted(GRAPHS))
def test_block_plan_exact(name, graph_name):
    """Block-dense plans ('blocks', and 'auto', which picks blocks on these
    one-patch graphs), fused and unfused, == the reference's block path
    and brute force on a fixed coloring."""
    tree = templates.template(name)
    g = GRAPHS[graph_name](tree.n)
    coloring = np.random.default_rng(tree.n).integers(0, tree.n, g.n).astype(np.int32)
    want = count_colorful_maps(g, tree, coloring)
    assert _ref_count(g, tree, coloring, spmm_kind="blocks") == want
    for kind in ("blocks", "auto"):
        for fuse in (False, True):
            plan = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device="cpu")
            assert plan.spmm_plan.kind == "blocks"
            assert float(colorful_map_count(plan, coloring)) == want


def test_count_fn_batch_equals_single_calls():
    tree = templates.template("u5-2")
    g = erdos_renyi(60, 4.0, seed=15)
    for fuse in (False, True):
        plan = build_counting_plan(g, tree, fuse=fuse, device="cpu")
        cols = draw_colorings(plan, 4, prng.key(3))
        maps, ests = count_fn(plan, batch=4)(prng.key(3))
        singles = torch.stack([colorful_map_count(plan, c) for c in cols])
        assert torch.equal(maps, singles)
        assert maps.dtype == torch.float64 and maps.shape == (4,)
        assert torch.allclose(ests, maps * plan.scale)
        assert torch.equal(colorful_map_count(plan, cols), singles)  # a fixed batch


def test_plan_scale_and_widths():
    tree = templates.template("u12-2")
    g = erdos_renyi(40, 3.0, seed=1)
    plan = build_counting_plan(g, tree, device="cpu")
    ref = ref_build_plan(RefGraph(g.n, g.indptr, g.indices), _ref_tree(tree), impl="xla")
    assert plan.scale == pytest.approx(ref.scale)
    assert (plan.n_pad, plan.k, plan.aut) == (ref.n_pad, ref.k, ref.aut)
    assert plan.widths == ref.widths  # true widths, lane = 1
    assert max(plan.widths.values()) == 792


def test_no_hidden_cpu_fallback(monkeypatch):
    g = erdos_renyi(20, 3.0, seed=0)
    tree = templates.path_tree(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_counting_plan(g, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_counting_plan(g, tree, device="cuda")
    build_counting_plan(g, tree, device="cpu")  # the explicit request works


def test_unported_options_raise(capsys):
    g = erdos_renyi(20, 3.0, seed=0)
    plan = build_counting_plan(g, templates.path_tree(3), spmm_kind="blocks", device="cpu")
    assert plan.spmm_plan.kind == "blocks" and plan.spmm_plan.num_patches == 1
    # compaction runs where the config asks for it: bench-sparse reports its spec
    launch_count.main(["--config", "bench-sparse", "--iters", "2", "--batch", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "compaction: threshold 0.5 node densities: n" in out
    assert "compaction caps: {'combine[" in out


def _launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_count.main(argv)
    return buf.getvalue().splitlines()


def test_launcher_fused_and_unfused_agree():
    base = ["--config", "bench-small", "--mode", "single", "--iters", "4", "--batch", "2",
            "--device", "cpu"]
    plain, fused = _launch(base), _launch(base + ["--fuse"])
    est = lambda lines: [ln for ln in lines if ln.startswith("estimate")]  # noqa: E731
    assert len(est(plain)) == 2 and est(plain) == est(fused)
    assert any(ln.startswith("mode=single(batch=2,fuse=True,spmm=edges)") for ln in fused)


@pytest.mark.parametrize("flag,item", [
    (["--mode", "ring", "--compact", "--wire-dtype", "int8", "--shards", "2", "--iters", "2",
      "--batch", "2"], "item 7"),
])
def test_launcher_unported_flags(flag, item, capsys):
    """A distributed mode with --compact once exited naming ROADMAP item 7;
    the compacted exchange and the narrow wire are ported, so the run now
    prints its estimates and names no item."""
    launch_count.main(["--device", "cpu"] + flag)
    out = capsys.readouterr()
    assert len(_estimates(out.out.splitlines())) == 2
    assert item not in out.out + out.err


_SMALL = ["--config", "bench-small", "--iters", "6", "--batch", "2", "--device", "cpu"]


def _estimates(lines):
    return [ln for ln in lines if ln.startswith("estimate")]


@pytest.mark.parametrize("flag", ["--checkpoint-dir", "--resume"])
def test_launcher_checkpoint_flags(flag, tmp_path):
    """Both flags run, write a checkpoint and print the plain run's estimate;
    --resume of an empty directory starts from zero."""
    d = tmp_path / "ckpt"
    lines = _launch(_SMALL + [flag, str(d)])
    assert _estimates(lines) == _estimates(_launch(_SMALL))
    assert not any(ln.startswith("resumed") for ln in lines)
    assert any(path.name.startswith("step_") for path in d.iterdir())


def test_launcher_checkpoint_then_resume(tmp_path):
    """--checkpoint-dir, then --resume of that directory: the resumed run
    restores every coloring and prints the same estimate."""
    d = str(tmp_path / "ckpt")
    first = _launch(_SMALL + ["--checkpoint-dir", d])
    again = _launch(_SMALL + ["--resume", d])
    assert len(_estimates(first)) == 2 and _estimates(again) == _estimates(first)
    assert "resumed: 6 colorings restored from checkpoint (progress/RSD include them)" in again


def test_launcher_fuse_auto_on_dense_graph(tmp_path):
    """Under --fuse, 'auto' is steered to the edge plan (the fused kernel walks
    the CSR), so fusion engages and the label says so; unfused, 'auto'
    picks blocks on the same graph.  The estimates agree."""
    path = str(tmp_path / "dense.npz")
    save_npz(rmat(512, 30_000, skew=3, seed=1), path)
    base = ["--graph", path, "--config", "bench-small", "--iters", "4", "--batch", "2",
            "--device", "cpu"]
    fused = _launch(base + ["--fuse", "--spmm-kind", "auto"])
    assert any(ln.startswith("mode=single(batch=2,fuse=True,spmm=edges)") for ln in fused)
    assert not any(ln.startswith("spmm auto") for ln in fused)  # auto never ran
    plain = _launch(base + ["--spmm-kind", "auto"])
    density = [ln for ln in plain if ln.startswith("spmm auto")]
    assert len(density) == 1 and re.search(r"-> kind=blocks$", density[0])
    assert any(ln.startswith("mode=single(batch=2,fuse=False,spmm=blocks)") for ln in plain)
    # a block plan cannot fuse: the label reports fusion as not engaged
    blocks_fused = _launch(base + ["--fuse", "--spmm-kind", "blocks"])
    assert any(ln.startswith("mode=single(batch=2,fuse=False,spmm=blocks)")
               for ln in blocks_fused)
    assert _estimates(fused) == _estimates(plain) == _estimates(blocks_fused)


def test_launcher_seed_matches_reference_launcher(monkeypatch):
    """`--seed S` keys the run with prng.key(S), as the reference launcher keys
    jax.random.key(S): the two launchers print the same estimates."""
    from repro.launch import count as ref_launch

    argv = ["--config", "bench-small", "--mode", "single", "--iters", "6", "--batch", "3",
            "--seed", "7"]
    monkeypatch.setattr("sys.argv", ["count"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_launch.main()
    want = _estimates(buf.getvalue().splitlines())
    assert len(want) == 2 and _estimates(_launch(argv + ["--device", "cpu"])) == want
