"""The port's examples and its experiments renderer, each through its
``main(argv)`` on the CPU at small sizes: ``examples/torch_quickstart.py``
(the exact count == the reference's brute force, Table 3 == the
reference's ``partition_complexity``), ``examples/torch_count_distributed.py``
(every exchange mode == the single-device counts of the same colorings),
``examples/torch_train_lm.py`` (2 steps, then a resume whose next loss
and weights equal an uninterrupted run's) and
``tools/torch_render_experiments.py`` (a record the port's counting
dry-run writes, rendered between the reference tool's markers)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import brute_force as ref_brute_force
from repro.core import graphs as ref_graphs
from repro.core import templates as ref_templates

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart():
    return _load("examples/torch_quickstart.py").main(["--device", "cpu"])


def test_quickstart_exact_count_equals_reference(quickstart):
    rg = ref_graphs.erdos_renyi(200, 6.0, seed=0)
    np.testing.assert_array_equal(quickstart["graph"].indices, rg.indices)
    assert quickstart["exact"] == ref_brute_force.count_copies(rg, ref_templates.star_tree(4))


def test_quickstart_table3_equals_reference(quickstart):
    want = [(name, *ref_templates.partition_complexity(
        ref_templates.partition_tree(ref_templates.template(name))))
        for name in ref_templates.TEMPLATE_TABLE3]
    assert quickstart["table3"] == want


def test_quickstart_estimates(quickstart):
    est, many = quickstart["estimate"], quickstart["many"]
    assert est.backend == "single" and est.niter == 150
    assert abs(est.estimate - quickstart["exact"]) / quickstart["exact"] < 0.2
    assert list(many.templates) == ["u3-1", "u5-2", "star-4"] and many.niter == 60
    assert np.all(np.isfinite(many.samples))


@pytest.mark.parametrize("fuse", [False, True])
def test_count_distributed_every_mode_equals_single(fuse):
    out = _load("examples/torch_count_distributed.py").main(
        ["--device", "cpu", "--vertices", "512", "--edges", "2500", "--shards", "4",
         "--iters", "4"] + (["--fuse"] if fuse else []))
    assert sorted(out["modes"]) == sorted(["alltoall", "pipeline(g=1)", "pipeline(g=3)",
                                           "adaptive", "ring"])
    for label, mode in out["modes"].items():
        assert mode["rel"] <= 1e-5, label
        np.testing.assert_allclose(mode["result"].samples, out["single"], rtol=1e-5)


def test_train_lm_resumes_to_the_uninterrupted_run(tmp_path):
    train = _load("examples/torch_train_lm.py")
    common = ["--device", "cpu", "--batch", "2", "--seq", "32", "--checkpoint-every", "1",
              "--log-every", "1"]
    first = train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    assert first["start"] == 0 and sorted(first["losses"]) == [1, 2]
    resumed = train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")])
    whole = train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 2 and sorted(resumed["losses"]) == [3]
    assert whole["losses"][1] == first["losses"][1] and whole["losses"][2] == first["losses"][2]
    assert resumed["losses"][3] == whole["losses"][3]
    for (name, a), (_, b) in zip(resumed["params"].named_parameters(),
                                 whole["params"].named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("example", ["torch_quickstart", "torch_count_distributed",
                                     "torch_train_lm"])
def test_examples_need_a_card_unless_asked(example, tmp_path):
    argv = ["--ckpt-dir", str(tmp_path)] if example == "torch_train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(f"examples/{example}.py").main(argv)


def test_renderer_on_a_counting_dryrun_record(tmp_path):
    from repro_torch.launch.dryrun import run_counting_cell

    records = tmp_path / "dryrun"
    rec = run_counting_cell("bench-small", False, str(records))
    assert rec["status"] == "ok"
    target = tmp_path / "EXPERIMENTS.md"
    target.write_text("# results\n\n<!-- DRYRUN_SUMMARY -->\n\nbetween\n\n"
                      "<!-- ROOFLINE_TABLE -->\n")
    render = _load("tools/torch_render_experiments.py")
    argv = [str(target), "--records", str(records)]
    text = render.main(argv)
    row = (f"| counting:bench-small | u5-2 | 16x16 | adaptive | ok | "
           f"{rec['memory']['temp_bytes'] / 2**30:.2f} | {rec['analysis_s']:.2f} |")
    assert row in text
    assert "**1 ok / 0 skipped (documented) / 0 errors.**" in text
    assert "| counting:bench-small | u5-2 | 16x16 | adaptive | " in text.split(
        "<!-- ROOFLINE_TABLE -->")[1]
    assert text.index("<!-- /DRYRUN_SUMMARY -->") < text.index("between")
    assert render.main(argv) == text  # a second run replaces the first's blocks
