"""The names the surface audit found missing, ported, each held against the
reference on identical inputs: ``EstimatorState.group_sums``,
``DistributedPlan.tree``/``.aut``/``.num_templates``, ``pad_vertices``,
``edge_tiles``, ``partition_edges_by_src_shard``, ``spmm_ref``,
``flash_attention_ref(scale=)``, ``attention_block(positions=)``,
``forward(return_hidden=)``, ``layernorm_params`` and the packages'
re-exports; the positional forms of ``run_table_program`` and
``init_kv_cache``, which bind as the reference's; ``forward(cast_params=)``;
and ``Model`` as a plain (mutable) dataclass.  Integer and numpy
results are held bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import distributed as ref_dist
from repro.core import estimator as ref_est
from repro.core import graphs as ref_graphs
from repro.core import templates as ref_templates
from repro.kernels import ref as ref_kernels
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models.transformer import forward as ref_forward
from repro_torch.configs import get_arch
from repro_torch.core import (
    count_engine,
    distributed,
    estimator,
    frontier,
    graphs,
    table_program,
    templates,
)
from repro_torch.kernels import ref
from repro_torch.models import attention, layers
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.models.transformer import forward


def _graph_pair(kind):
    if kind == "er":
        return graphs.erdos_renyi(61, 4.0, seed=3), ref_graphs.erdos_renyi(61, 4.0, seed=3)
    return graphs.rmat(200, 900, skew=3, seed=5), ref_graphs.rmat(200, 900, skew=3, seed=5)


# ---------------------------------------------------------------- estimator


def _states(samples, n_iter):
    kw = dict(signature="s", n_iter=n_iter, batch=4, delta=0.1, cursor=0, samples=samples)
    return estimator.EstimatorState(**kw), ref_est.EstimatorState(**kw)


@pytest.mark.parametrize("num_groups", [None, 1, 3, 8])
@pytest.mark.parametrize("family", [False, True])
def test_group_sums_equal_reference(num_groups, family):
    """At every prefix of the stream, with and without ``num_groups``."""
    n_iter = 40
    rng = np.random.default_rng(11)
    full = rng.standard_normal((n_iter, 3) if family else (n_iter,)) * 1e3
    for done in (0, 1, 7, 20, 33, n_iter):
        port, want = _states(full[:done].copy(), n_iter)
        ps, pc = port.group_sums(num_groups)
        ws, wc = want.group_sums(num_groups)
        assert ps.dtype == ws.dtype and pc.dtype == wc.dtype
        np.testing.assert_array_equal(ps, ws)
        np.testing.assert_array_equal(pc, wc)


# ---------------------------------------------------------------- graphs


@pytest.mark.parametrize("n,multiple", [(0, 8), (1, 8), (127, 128), (128, 128), (129, 128),
                                        (1000, 7)])
def test_pad_vertices_equal_reference(n, multiple):
    assert graphs.pad_vertices(n, multiple) == ref_graphs.pad_vertices(n, multiple)


@pytest.mark.parametrize("kind", ["er", "rmat"])
@pytest.mark.parametrize("tile_size,n_pad", [(1, None), (8, None), (64, 256), (4096, None)])
def test_edge_tiles_equal_reference(kind, tile_size, n_pad):
    g, rg = _graph_pair(kind)
    np.testing.assert_array_equal(g.indices, rg.indices)
    got = graphs.edge_tiles(g, tile_size, n_pad)
    want = ref_graphs.edge_tiles(rg, tile_size, n_pad)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["er", "rmat"])
@pytest.mark.parametrize("shards,tile_size", [(1, 1), (3, 1), (4, 8), (8, 16)])
def test_partition_edges_by_src_shard_equal_reference(kind, shards, tile_size):
    g, rg = _graph_pair(kind)
    got = graphs.partition_edges_by_src_shard(g, shards, tile_size)
    want = ref_graphs.partition_edges_by_src_shard(rg, shards, tile_size)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert int(got[2].sum()) == g.num_edges * 2


# ---------------------------------------------------------------- distributed plan


@pytest.mark.parametrize("names", [("u5-2",), ("u3-1", "u5-2", "u7-2")])
def test_distributed_plan_properties_equal_reference(names):
    g, rg = _graph_pair("er")
    tree = names if len(names) > 1 else templates.template(names[0])
    rtree = names if len(names) > 1 else ref_templates.template(names[0])
    plan = distributed.build_distributed_plan(g, tree, 4, device="cpu")
    want = ref_dist.build_distributed_plan(rg, rtree, 4)
    assert plan.tree.name == want.tree.name
    assert plan.tree is plan.templates[0]
    assert plan.aut == want.aut
    assert plan.num_templates == want.num_templates


# ---------------------------------------------------------------- positional order


def _table_program_roots(plan, colorings, positional):
    """The plan's root counts through ``run_table_program`` called as the
    engine calls it, by keyword, or positionally in the reference's order
    ``(program, combine, leaf, n, node_fn, root_fn, frontier_fn, bag)``."""
    leaf = table_program.leaf_table(colorings, plan.k, plan.n)
    spec, flags, frontier_fn, bag = plan.compaction, [], None, None
    if spec is not None:
        node_fn = table_program.local_node_fn(plan.spmm_plan, compaction=spec,
                                              sentinel_row=plan.n, flags=flags)
        frontier_fn = frontier.make_frontier_fn(spec.table_caps, plan.n, flags)
    else:
        node_fn = table_program.local_node_fn(plan.spmm_plan)
        bag = count_engine._bag_fns(plan, plan.chain, colorings, leaf)
        node_fn = count_engine._bag_node_fn(plan, plan.chain, node_fn)
    args = (plan.chain, plan.combine, leaf, plan.n, node_fn)
    if positional:
        roots = table_program.run_table_program(*args, table_program.root_count, frontier_fn,
                                                bag)
    else:
        roots = table_program.run_table_program(*args, root_fn=table_program.root_count,
                                                frontier_fn=frontier_fn, bag=bag)
    return roots, flags


@pytest.mark.parametrize("kind", ["compact", "bags"])
def test_run_table_program_binds_the_reference_positional_order(kind, monkeypatch):
    """A call in the reference's positional form binds ``frontier_fn`` and
    ``bag`` where the reference does: the same root counts, bitwise, as the
    keyword call, on a compacted chain (a frontier function engaged) and on
    a bag program (bag functions required)."""
    if kind == "compact":
        monkeypatch.setattr(frontier, "MIN_TABLE_WIDTH", 1)
        monkeypatch.setattr(frontier, "MIN_COMBINE_ELEMENTS", 1)
        g = graphs.rmat(1024, 1000, skew=3, seed=2)
        plan = count_engine.build_counting_plan(g, templates.template("u7-2"), device="cpu",
                                                compact=True, density_threshold=0.7)
        assert plan.compaction.table_caps
    else:
        g = graphs.erdos_renyi(61, 4.0, seed=3)
        plan = count_engine.build_counting_plan(g, templates.template("cycle4"), device="cpu")
        assert templates.program_has_bags(plan.chain)
    colorings = np.zeros((2, plan.n_pad), np.int64)
    colorings[:, : g.n] = np.random.default_rng(1).integers(0, plan.k, (2, g.n))
    colorings = torch.from_numpy(colorings)
    got, got_flags = _table_program_roots(plan, colorings, positional=True)
    want, want_flags = _table_program_roots(plan, colorings, positional=False)
    assert len(got) == len(want) == 1
    assert torch.equal(got[0], want[0]) and float(want[0].sum()) > 0
    assert len(got_flags) == len(want_flags) and bool(got_flags) == (kind == "compact")
    assert all(torch.equal(a, b) for a, b in zip(got_flags, want_flags))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_kv_cache_takes_dtype_by_position(dtype):
    """``init_kv_cache(b, kv, L, hd, dtype)`` as the reference calls it: the
    same shapes, dtypes and contents; the device is the card unless the
    caller asks for the CPU."""
    want = ref_attention.init_kv_cache(2, 3, 5, 4, getattr(jnp, dtype))
    got = attention.init_kv_cache(2, 3, 5, 4, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and str(got[k].dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(w, np.float32))
    default = attention.init_kv_cache(2, 3, 5, 4, device="cpu")
    assert default["k"].dtype == torch.bfloat16 == getattr(torch, str(
        ref_attention.init_kv_cache(2, 3, 5, 4)["k"].dtype))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            attention.init_kv_cache(2, 3, 5, 4, getattr(torch, dtype))


# ---------------------------------------------------------------- oracles


@pytest.mark.parametrize("width", [1, 5, 16])
def test_spmm_ref_equals_reference(width):
    """The COO scatter-add on integer-valued float32 tables: exact, so bitwise."""
    rng = np.random.default_rng(width)
    n, e = 37, 300
    rows = np.concatenate([rng.integers(0, n, e), np.full(20, n)]).astype(np.int32)
    cols = np.concatenate([rng.integers(0, n, e), np.full(20, n)]).astype(np.int32)
    table = rng.integers(0, 50, (n + 1, width)).astype(np.float32)
    table[n] = 0.0
    want = np.asarray(ref_kernels.spmm_ref(jnp.asarray(rows), jnp.asarray(cols),
                                           jnp.asarray(table), n))
    got = ref.spmm_ref(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(table), n)
    assert got.shape == (n + 1, width)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's [rows, B, W] tables: the trailing axes ride along
    got3 = ref.spmm_ref(torch.from_numpy(rows), torch.from_numpy(cols),
                        torch.from_numpy(table).reshape(n + 1, 1, width), n)
    np.testing.assert_array_equal(got3.reshape(n + 1, width).numpy(), want)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_attention_ref_scale_equals_reference(causal, window, scale):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 12, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    want = np.asarray(ref_kernels.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v), causal=causal,
                                                      window=window, scale=scale))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=causal, window=window, scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- LM pieces


@pytest.fixture(scope="module")
def qwen():
    """The reduced qwen row (QKV biases) with one layer's attention weights,
    drawn by the reference and carried across."""
    cfg, rcfg = get_arch("qwen1.5-0.5b").reduced(), ref_get_arch("qwen1.5-0.5b").reduced()
    rp = jax.tree.map(np.asarray,
                      ref_attention.attn_init(ref_layers.Initializer(jax.random.key(2)), rcfg))
    rng = np.random.default_rng(4)
    for name in ("wq", "wk", "wv"):
        rp[name]["b"] = (rng.standard_normal(rp[name]["b"].shape) * 0.5).astype(np.float32)

    def dense(d):
        return layers.Dense(torch.from_numpy(np.array(d["w"])),
                            torch.from_numpy(np.array(d["b"])) if "b" in d else None)

    port = attention.Attention(*(dense(rp[n]) for n in ("wq", "wk", "wv", "wo")))
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return cfg, rcfg, rp, port, x


@pytest.mark.parametrize("offset", [None, 0, 9])
def test_attention_block_positions_equal_reference(qwen, offset):
    """Rope at the given positions (``None``: the default ``0 .. L-1``)."""
    cfg, rcfg, rp, port, x = qwen
    pos = None if offset is None else np.arange(x.shape[1]) + offset
    want, _ = ref_attention.attention_block(
        jax.tree.map(jnp.asarray, rp), jnp.asarray(x), rcfg, dtype=jnp.float32,
        positions=None if pos is None else jnp.asarray(pos))
    got, _ = attention.attention_block(
        port, torch.from_numpy(x), cfg, dtype=torch.float32,
        positions=None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_attention_block_positions_move_the_result(qwen):
    cfg, _, _, port, x = qwen
    xt = torch.from_numpy(x)
    a, _ = attention.attention_block(port, xt, cfg, dtype=torch.float32)
    b, _ = attention.attention_block(port, xt, cfg, dtype=torch.float32,
                                     positions=torch.arange(x.shape[1]) + 9)
    assert not torch.equal(a, b)


@pytest.fixture(scope="module")
def smollm():
    rcfg, cfg = ref_get_arch("smollm-360m").reduced(), get_arch("smollm-360m").reduced()
    rparams = jax.tree.map(np.asarray, ref_build_model(rcfg).init_fn(jax.random.key(0)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return rcfg, cfg, rparams, toks


def test_forward_return_hidden_equals_reference(smollm):
    rcfg, cfg, rparams, toks = smollm
    want, _, _ = ref_forward(jax.tree.map(jnp.asarray, rparams), rcfg, jnp.asarray(toks),
                             mode="train", dtype=jnp.float32, return_hidden=True)
    params = from_reference_params(rparams, cfg)
    got, caches, aux = forward(params, cfg, torch.from_numpy(toks), mode="train",
                               dtype=torch.float32, return_hidden=True)
    assert caches is None and got.shape == (2, 32, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_forward_cast_params_equals_reference(smollm):
    """``forward(cast_params=True)`` reads the float32 weights of two or more
    dimensions rounded to the compute dtype, as the reference's does: the
    logits equal the forward over weights stored in bf16, bitwise, and the
    reference's cast forward within bf16's 2e-2; the rounded LM head moves
    them from the uncast forward's."""
    rcfg, cfg, rparams, toks = smollm
    want, _, _ = ref_forward(jax.tree.map(jnp.asarray, rparams), rcfg, jnp.asarray(toks),
                             mode="train", dtype=jnp.bfloat16, cast_params=True)
    params = from_reference_params(rparams, cfg)
    got, _, _ = forward(params, cfg, torch.from_numpy(toks), mode="train", cast_params=True)
    stored, _, _ = forward(from_reference_params(rparams, cfg, dtype=torch.bfloat16), cfg,
                           torch.from_numpy(toks), mode="train")
    uncast, _, _ = forward(params, cfg, torch.from_numpy(toks), mode="train")
    assert torch.equal(got, stored) and not torch.equal(got, uncast)
    assert {w.dtype for w in params.parameters()} == {torch.float32}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_model_is_a_mutable_dataclass(smollm):
    """``Model`` is the reference's plain dataclass: a caller may rebind
    ``decode_fn`` (here to count its calls) on both packages."""
    rcfg, cfg, _, toks = smollm
    calls = []
    for model in (ref_build_model(rcfg), build_model(cfg, dtype=torch.float32, device="cpu")):
        assert dataclasses.is_dataclass(model) and not type(model).__dataclass_params__.frozen
        inner = model.decode_fn
        model.decode_fn = lambda params, batch, inner=inner: calls.append(1) or inner(params,
                                                                                    batch)
    params = model.init_fn(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(toks)
    _, caches = model.prefill_fn(params, {"tokens": tokens[:, :31]})
    logits, _ = model.decode_fn(params, {"tokens": tokens[:, 31:], "pos": 31, "caches": caches})
    assert calls == [1] and logits.shape == (2, cfg.padded_vocab)


REMATS = ("none", "full", "dots")


@pytest.fixture(scope="module")
def remat_runs(smollm):
    """The hidden state of a train-mode forward and the gradients of
    ``sum(hidden * w)`` for a fixed ``w`` with respect to the embedding and
    the final norm: the reference's under its default ``remat="full"`` (one
    JAX job), the port's under each of its remat modes."""
    rcfg, cfg, rparams, toks = smollm
    w = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model)).astype(np.float32)

    def ref_loss(p):
        h, _, _ = ref_forward(p, rcfg, jnp.asarray(toks), mode="train", dtype=jnp.float32,
                              remat="full", return_hidden=True)
        return jnp.sum(h * w), h

    (_, want), rgrads = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, rparams))
    ref = (np.asarray(want), {k: np.asarray(rgrads[k]) for k in ("embed", "final_norm")})
    port = {}
    for remat in REMATS:
        params = from_reference_params(rparams, cfg).requires_grad_()
        with torch.enable_grad():
            got, _, _ = params(torch.from_numpy(toks), mode="train", dtype=torch.float32,
                               remat=remat, return_hidden=True)
            (got * torch.from_numpy(w)).sum().backward()
        port[remat] = (got.detach().numpy(), {"embed": params.embed.grad.numpy(),
                                              "final_norm": params.final_norm.grad.numpy()})
    return ref, port


@pytest.mark.parametrize("remat", REMATS)
def test_transformer_forward_remat_equals_reference(remat_runs, remat):
    """``Transformer.forward(remat=)`` under autograd, each mode, == the
    reference's ``forward`` under its default remat on the same weights
    (the function's ``remat`` is a departure: it reaches the method)."""
    (want, _), port = remat_runs
    got = port[remat][0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", REMATS)
def test_transformer_remat_gradients_equal_reference(remat_runs, remat):
    """What ``remat`` recomputes in the backward gives the reference's
    gradients of the embedding and the final norm, within 1e-5 of their
    norm (1.2e-6 measured)."""
    (_, want), port = remat_runs
    for name, got in port[remat][1].items():
        assert np.linalg.norm(got - want[name]) <= 1e-5 * np.linalg.norm(want[name]), name


def test_layer_helpers_equal_reference():
    init = layers.Initializer(torch.Generator().manual_seed(0), device=torch.device("cpu"))
    rinit = ref_layers.Initializer(jax.random.key(0))
    got, want = layers.layernorm_params(init, 24), ref_layers.layernorm_params(rinit, 24)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    for fn, rfn in ((init.zeros, rinit.zeros), (init.ones, rinit.ones)):
        a, b = fn((2, 3)), np.asarray(rfn((2, 3)))
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), b)


def test_package_re_exports_are_the_modules_names():
    import repro_torch.configs as configs
    import repro_torch.core as core
    import repro_torch.models as models
    import repro_torch.testing as testing
    from repro_torch.configs import subgraph
    from repro_torch.models import factory
    from repro_torch.testing import faults

    assert core.erdos_renyi is graphs.erdos_renyi
    assert core.EstimatorState is estimator.EstimatorState
    assert configs.COUNTING_CONFIGS is subgraph.COUNTING_CONFIGS
    assert models.chunked_ce_loss is factory.chunked_ce_loss
    assert testing.faults is faults
