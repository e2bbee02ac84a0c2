"""Checks that need the card; they skip without one.

    python -m pytest portbench/tests -m gpu
"""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.frozen import threefry
from portbench.gen import rmat
from portbench.reference import colorcoding


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_draw_on_the_card_equals_the_cpu(cuda):
    key = threefry.fold_in(harness.base_key(2**31 + 1), 3)
    got = threefry.draw_colorings(key, 5000, 12, 4, device=cuda).cpu()
    assert torch.equal(got, threefry.draw_colorings(key, 5000, 12, 4, device="cpu"))


@pytest.mark.gpu
def test_reference_on_the_card_equals_the_cpu(cuda):
    indptr, indices, _ = rmat.make_csr({"vertices": 3000, "edges": 40000,
                                        "probs": [0.45, 0.22, 0.22, 0.11], "graph_seed": 9}, "cpu")
    edges = [[0, 4], [4, 5], [5, 7], [7, 8], [8, 9], [5, 6], [0, 1], [1, 2], [2, 3]]
    coloring = torch.from_numpy(np.random.default_rng(2).integers(0, 10, 3000))
    cpu = colorcoding.colorful_maps(colorcoding.Graph(3000, indptr, indices, "cpu"), 10, edges,
                                    coloring, 10)
    gpu = colorcoding.colorful_maps(colorcoding.Graph(3000, indptr, indices, cuda), 10, edges,
                                    coloring, 10)
    assert cpu > 0 and gpu == pytest.approx(cpu, rel=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["miami-k3.u12-2", "rmat250-k8.u12-2"])
def test_small_run_on_the_card_is_correct(cuda, cell):
    spec = harness.cell_spec(cell)
    spec["config"] = dict(spec["config"], vertices=20000, edges=200000)
    r = harness.run_cell(spec, 2**31 + 77, 1.0, True, device="cuda", log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {"launches_per_call", "spmm_edge_roofline", "color_combine_roofline"} <= set(
        r["metrics"])
    for name in ("spmm_edge_roofline", "color_combine_roofline"):
        assert 0 < r["metrics"][name]["value"] <= 105
