"""The port's CUDA kernels on the card: each against its plain version, and
the engine against the brute-force oracle.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports nothing of JAX, so it runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
from repro_torch.core.graphs import edge_list, erdos_renyi, rmat
from repro_torch.core.templates import template
from repro_torch.kernels import ops, ref
from repro_torch.kernels.color_combine import color_combine
from repro_torch.kernels.fused_count import fused_count
from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("k,t1,t2,batch", [(12, 3, 4, 2), (12, 1, 7, 3), (12, 4, 8, 2), (5, 2, 2, 1)])
def test_cuda_kernels_match_plain(cuda_device, k, t1, t2, batch):
    g = rmat(1 << 12, 40_000, skew=8, seed=2)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=cuda_device)
    tbl = ops.build_combine_tables(k, t1, t2, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(k + batch)
    a, w = math.comb(k, t1), math.comb(k, t2)
    left = torch.randint(0, 2, (plan.n_pad, batch, a), generator=gen, device=cuda_device).float()
    right = torch.randint(0, 2, (plan.n_pad, batch, w), generator=gen, device=cuda_device).float()
    launched = (spmm_edge_tile.launches, color_combine.launches, fused_count.launches)
    m = ops.spmm(plan.indptr, plan.indices, right)
    assert torch.equal(m, ref.spmm_segment_ref(plan.indptr, plan.indices, right))
    c = ops.color_combine(left, m, tbl)
    assert torch.equal(c, ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2))
    fused = ops.fused_count(plan.indptr, plan.indices, left, right, tbl)
    assert torch.equal(fused, c)  # bitwise fused == unfused
    torch.cuda.synchronize()
    after = (spmm_edge_tile.launches, color_combine.launches, fused_count.launches)
    assert [y - x for x, y in zip(launched, after)] == [1, 1, 1]


def test_cuda_kernels_refuse_bad_tensors(cuda_device):
    """A CUDA tensor reaches the kernel or an exception, never the plain version."""
    g = erdos_renyi(50, 3.0, seed=0)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, device=cuda_device)
    table = torch.ones(plan.n_pad, 1, 3, device=cuda_device)
    with pytest.raises(ValueError):
        spmm_edge_tile(plan.indptr, plan.indices, table.double())
    with pytest.raises(ValueError):
        spmm_edge_tile(plan.indptr, plan.indices.long(), table)
    tbl = ops.build_combine_tables(5, 2, 2, device=cuda_device)  # widths (10, 10)
    with pytest.raises(ValueError):
        color_combine(table, table, tbl)
    with pytest.raises(ValueError):
        fused_count(plan.indptr, plan.indices, table, table, tbl)


@pytest.mark.parametrize("name", ["u3-1", "u5-2", "u7-2"])
def test_engine_on_card_matches_brute_force(cuda_device, name):
    tree = template(name)
    for g in (erdos_renyi(40, 4.0, seed=2), rmat(64, 300, skew=3, seed=5)):
        coloring = np.random.default_rng(7).integers(0, tree.n, g.n).astype(np.int32)
        want = count_colorful_maps(g, tree, coloring)
        for fuse in (False, True):
            plan = build_counting_plan(g, tree, fuse=fuse, device=cuda_device)
            assert float(colorful_map_count(plan, coloring)) == want
