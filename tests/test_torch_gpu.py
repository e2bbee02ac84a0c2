"""The port's CUDA kernels on the card: each against its plain version, the
engine against the brute-force oracle, and the LM's prefill and decode on
the card against the same weights on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports nothing of JAX, so it runs on
a machine with only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.core.brute_force import count_colorful_maps
from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
from repro_torch.core.graphs import edge_list, erdos_renyi, rmat
from repro_torch.core.templates import template
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.color_combine import color_combine
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_count import fused_count
from repro_torch.kernels.spmm_block import spmm_block
from repro_torch.kernels.spmm_edgetile import spmm_edge_tile
from repro_torch.models import build_model
from repro_torch.testing.numerics import bf16_excess

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
    m = ops.spmm(plan, right)
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


@pytest.mark.parametrize("width", [1, 3, 12, 128, 192, 1000, 1056])
def test_spmm_block_matches_plain_and_edges(cuda_device, width):
    """``spmm_block`` == its plain version on integer tables (exact sums), and
    == ``spmm_edge_tile`` bitwise on float tables whose sums round: both add
    each row's neighbors in ascending source order.  Widths cover the
    scalar path (not a multiple of 4) and partial column tiles."""
    g = rmat(1 << 11, 60_000, skew=3, seed=4)  # dense: the reference's 'auto' picks blocks
    plan = ops.build_spmm_plan(*edge_list(g), g.n, kind="auto", device=cuda_device)
    assert plan.kind == "blocks"
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(width)
    b = 2 if width % 2 == 0 else 1
    ints = torch.randint(0, 4, (plan.n_pad, b, width // b), generator=gen,
                         device=cuda_device).float()
    ints[g.n:] = 0
    launched = spmm_block.launches
    got = spmm_block(plan.patch_ptr, plan.patch_col, plan.patch_bits, ints)
    assert spmm_block.launches == launched + 1
    assert torch.equal(got, ref.spmm_block_ref(plan.patch_ptr, plan.patch_col, plan.patch_bits,
                                               ints))
    assert torch.equal(got, spmm_edge_tile(plan.indptr, plan.indices, ints))
    floats = torch.rand((plan.n_pad, b, width // b), generator=gen, device=cuda_device) * 1e4
    floats[g.n:] = 0
    assert torch.equal(ops.spmm(plan, floats), spmm_edge_tile(plan.indptr, plan.indices, floats))
    torch.cuda.synchronize()


def test_spmm_block_refuses_bad_tensors(cuda_device):
    g = rmat(512, 30_000, skew=3, seed=1)
    plan = ops.build_spmm_plan(*edge_list(g), g.n, kind="blocks", device=cuda_device)
    table = torch.ones(plan.n_pad, 1, 3, device=cuda_device)
    with pytest.raises(ValueError):
        spmm_block(plan.patch_ptr, plan.patch_col, plan.patch_bits, table.double())
    with pytest.raises(ValueError):
        spmm_block(plan.patch_ptr.long(), plan.patch_col, plan.patch_bits, table)
    with pytest.raises(ValueError):
        spmm_block(plan.patch_ptr, plan.patch_col, plan.patch_bits, table[:-128])


@pytest.mark.parametrize("name", ["u3-1", "u5-2", "u7-2"])
def test_engine_on_card_matches_brute_force(cuda_device, name):
    tree = template(name)
    for g in (erdos_renyi(40, 4.0, seed=2), rmat(64, 300, skew=3, seed=5)):
        coloring = np.random.default_rng(7).integers(0, tree.n, g.n).astype(np.int32)
        want = count_colorful_maps(g, tree, coloring)
        for kind in ("edges", "blocks"):
            for fuse in (False, True):
                plan = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device=cuda_device)
                assert float(colorful_map_count(plan, coloring)) == want


@pytest.mark.parametrize("seed,k", [(0, 12), (7, 5), (2**31 + 5, 15)])
def test_colorings_on_card_equal_cpu(cuda_device, seed, k):
    """Threefry on the card draws what it draws on the CPU (which the CPU
    tests hold == jax.random), including past 2^24 elements."""
    key = prng.fold_in(prng.key(seed), 3)
    for shape in [(1, 5), (3, 1000), (17, 1 << 20)]:
        got = prng.randint(key, shape, 0, k, device=cuda_device)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), prng.randint(key, shape, 0, k, device="cpu"))


def _qkv(device, dtype, b, hq, hkv, l, d, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, hq, l, d), (b, hkv, l, d), (b, hkv, l, d))]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal,window,l", [(True, 0, 256), (True, 100, 300), (False, 0, 200),
                                             (False, 64, 129), (True, 0, 1), (True, 0, 127),
                                             (False, 0, 128), (True, 0, 4097)])
def test_flash_attention_matches_plain(cuda_device, d, dtype, group, causal, window, l):
    """The kernel == its plain version on the same inputs: float32 within
    1e-5 (float32 sums in other orders), bf16 within one bf16 step of the
    plain version's float32 result rounded, plus 1e-6 for the sums' order
    near zero.  GQA groups 1, 4 and 8; ragged L, one tile, windows and
    bidirectional masks.  bf16 takes the wgmma kernel, float32 the CUDA-core
    one."""
    q, k, v = _qkv(cuda_device, dtype, 2, 2 * group, 2, l, d, seed=d + l + group)
    launched = (flash_attention.launches, flash_attention.launches_wgmma,
                flash_attention.launches_fp32)
    got = flash_attention(q, k, v, causal=causal, window=window)
    route = (1, 1, 0) if dtype == torch.bfloat16 else (1, 0, 1)
    assert (flash_attention.launches, flash_attention.launches_wgmma,
            flash_attention.launches_fp32) == tuple(x + y for x, y in zip(launched, route))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bf16_excess(got, want, atol=1e-6) == 0.0


def test_flash_library_sass_has_wgmma_and_tma(cuda_device):
    """The bf16 kernel runs its products on the tensor cores (HGMMA) and
    stages its tiles with TMA (UTMALDG)."""
    text = _build.sass("flash_attention_wgmma")
    if text is None:
        pytest.skip("the CUDA toolkit here has no cuobjdump")
    assert "HGMMA" in text and "UTMALDG" in text


def test_flash_attention_refuses_bad_tensors(cuda_device):
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 2, 64, 64, seed=0)
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), v.half())  # dtype
    with pytest.raises(ValueError):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])  # head dim, contiguity
    with pytest.raises(ValueError):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())  # head dim 32
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :32].contiguous(), k, v)  # Lq != Lk
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)


def test_lm_prefill_and_decode_on_card_match_cpu(cuda_device):
    """A small granite (head_dim 64, so the kernel runs) in float32: the
    card's prefill and decode logits equal the CPU's on the same weights
    within 1e-4 (TF32 off), with one kernel launch per layer per prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(), head_dim=64, num_layers=3)
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    card = build_model(cfg, dtype=torch.float32, device=cuda_device)
    params = cpu.init_fn(torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(params).to(cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 201)))
    launched = flash_attention.launches
    got, caches = card.prefill_fn(on_card, {"tokens": toks[:, :200].to(cuda_device)})
    assert flash_attention.launches == launched + cfg.num_layers
    want, cpu_caches = cpu.prefill_fn(params, {"tokens": toks[:, :200]})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    got, _ = card.decode_fn(on_card, {"tokens": toks[:, 200:].to(cuda_device), "pos": 200,
                                      "caches": caches})
    want, _ = cpu.decode_fn(params, {"tokens": toks[:, 200:], "pos": 200, "caches": cpu_caches})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
