"""The port's experts against the JAX package's: routing, dispatch with
capacity drops, the combine and the dense ``moe_block``, float32 within
1e-4 and bf16 within 2e-2; and the distributed ``moe_block_manual`` on a
``LocalMesh`` of P = 4 thread ranks (EP with one ``all_to_all``, EP through
the pipelined Adaptive-Group exchange at g = 1 and 3, TP, and the
replicated-token fallback at a token count that 4 does not divide) against
the reference's dense ``moe_block`` within 2e-4, the reference's own
tolerance for its manual-versus-dense check (tests/_dist_worker.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import moe as ref_moe
from repro.models.layers import Initializer as RefInitializer
from repro_torch.comm import LocalMesh
from repro_torch.configs import get_arch
from repro_torch.models import moe

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _weights(name, seed=7, **over):
    rcfg = dataclasses.replace(ref_get_arch(name).reduced(), **over)
    cfg = dataclasses.replace(get_arch(name).reduced(), **over)
    rp = ref_moe.moe_init(RefInitializer(jax.random.key(seed)), rcfg)
    p = moe.MoE(*(torch.from_numpy(np.array(rp[k])) for k in ("router", "w_gate", "w_up",
                                                               "w_down")))
    return rcfg, cfg, rp, p


def _x(shape, d, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((*shape, d)) * scale).astype(np.float32)


def _leaning(rp, shape, d, seed):
    """Unit-variance tokens leaning toward expert 0 (its router column, unit
    length, added): a trained router's favourite draws more than its share,
    so at capacity factor 1.25 some of its slots are dropped.  Random
    tokens alone spread within 1.25x of an even share."""
    u = np.asarray(rp["router"])[:, 0]
    return _x(shape, d, seed=seed, scale=1.0) + (u / np.linalg.norm(u)).astype(np.float32)


def test_route_matches_reference():
    rcfg, cfg, rp, p = _weights("phi3.5-moe-42b-a6.6b")
    xt = _x((64,), cfg.d_model, scale=1.0)
    w_ref, e_ref, aux_ref = ref_moe._route(jnp.asarray(xt), rp["router"], 2)
    w, e, aux = moe._route(torch.from_numpy(xt), p.router, 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dispatch_drops_and_combine_match_reference(dtype):
    """At 96 tokens, top-2 of 4 experts and capacity factor 1.25 (capacity
    64), tokens leaning toward expert 0 choose it more than 64 times: the
    same slots are dropped on both sides, the buffers and the combine agree."""
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, rp, p = _weights("phi3.5-moe-42b-a6.6b")
    t = 96
    xt = _leaning(rp, (t,), cfg.d_model, seed=1)
    cap = moe._capacity(cfg, t)
    assert cap == ref_moe._capacity(rcfg, t) == 64
    _, e_ref, _ = ref_moe._route(jnp.asarray(xt), rp["router"], 2)
    buf_r, ef_r, pos_r, keep_r, tok_r = ref_moe._dispatch(jnp.asarray(xt, jdt), e_ref, cap, 4, jdt)
    top_w, top_e, _ = moe._route(torch.from_numpy(xt), p.router, 2)
    buf, e_flat, pos_c, keep = moe._dispatch(torch.from_numpy(xt).to(tdt), top_e, cap, 4, tdt)
    assert not keep.all(), "no slot dropped: the capacity is not exercised"
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_r))
    np.testing.assert_array_equal(pos_c.numpy(), np.asarray(pos_r))
    np.testing.assert_array_equal(buf.float().numpy(), np.asarray(buf_r.astype(jnp.float32)))
    out_buf = buf * 2 - 1
    want = ref_moe._combine(jnp.asarray(out_buf.float().numpy(), jdt), ef_r, pos_r, keep_r,
                            tok_r, jnp.asarray(top_w.numpy()), t, jdt)
    got = moe._combine(out_buf, e_flat, pos_c, keep, top_w, tdt)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    dropped_tokens = (~keep).reshape(t, 2).any(1)
    kept_only = ~dropped_tokens
    assert dropped_tokens.any() and kept_only.any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"])
def test_moe_block_matches_reference(name, dtype):
    """The dense path at a token count where tokens are dropped; aux too."""
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, rp, p = _weights(name, seed=3)
    x = _leaning(rp, (4, 24), cfg.d_model, seed=2)
    _, top_e, _ = moe._route(torch.from_numpy(x).reshape(96, -1), p.router, 2)
    assert torch.bincount(top_e.reshape(-1)).max() > moe._capacity(cfg, 96)  # drops
    want, aux_ref = ref_moe.moe_block(rp, jnp.asarray(x, jdt), rcfg, dtype=jdt)
    got, aux = moe.moe_block(p, torch.from_numpy(x).to(tdt), cfg, dtype=tdt)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-4)


MANUAL = [  # (label, moe_sharding, pipeline, group factor, batch shape)
    ("ep_fused", "ep", False, 1, (4, 8)),
    ("ep_pipe_g1", "ep", True, 1, (4, 8)),
    ("ep_pipe_g3", "ep", True, 3, (4, 8)),
    ("tp", "tp", False, 1, (4, 8)),
    ("ep_fallback", "ep", False, 1, (3, 1)),  # 3 tokens: 4 does not divide them
]


@pytest.mark.parametrize("label,sharding,pipeline,gf,shape", MANUAL, ids=[m[0] for m in MANUAL])
def test_moe_block_manual_on_local_mesh_matches_reference(label, sharding, pipeline, gf, shape):
    rcfg, cfg, rp, p = _weights("phi3.5-moe-42b-a6.6b", num_experts=4, experts_per_token=2,
                                moe_sharding=sharding, capacity_factor=64.0)
    x = _x(shape, cfg.d_model, seed=4)
    want, aux_ref = jax.jit(lambda p_, x_: ref_moe.moe_block(p_, x_, rcfg, dtype=jnp.float32))(
        rp, jnp.asarray(x))
    xt = torch.from_numpy(x)

    def rank(ctx):
        mine = moe.shard_expert_weights(p, cfg, ctx.data.rank, ctx.data.size)
        return moe.moe_block_manual(mine, xt, cfg, group=ctx.data, pipeline=pipeline,
                                    group_factor=gf, dtype=torch.float32)

    outs = LocalMesh(4, device="cpu", timeout=60).run(rank)
    for out, aux in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
        if sharding == "tp" or label == "ep_fallback":
            np.testing.assert_allclose(aux.item(), float(aux_ref), rtol=1e-5)
    if label == "ep_fused":
        # token-sharded: each rank's aux is over its quarter, then averaged
        assert len({round(a.item(), 6) for _, a in outs}) == 1


def test_shard_expert_weights_follow_the_reference_specs():
    _, cfg, _, p = _weights("phi3.5-moe-42b-a6.6b", num_experts=4)
    r2 = moe.shard_expert_weights(p, cfg, 2, 4)
    assert torch.equal(r2.w_gate, p.w_gate[2:3]) and torch.equal(r2.w_down, p.w_down[2:3])
    assert r2.router.data_ptr() == p.router.data_ptr()
    tp = dataclasses.replace(cfg, moe_sharding="tp")
    r1 = moe.shard_expert_weights(p, tp, 1, 4)
    assert torch.equal(r1.w_up, p.w_up[:, :, 32:64]) and torch.equal(r1.w_down, p.w_down[:, 32:64])
    with pytest.raises(ValueError, match="do not split"):
        moe.shard_expert_weights(p, cfg, 0, 3)
    # the FSDP unshard: expert weights split over a data axis of 2 as the
    # specs say (router dim 0, w_gate/w_up dim 1, w_down dim 2), gathered at
    # entry == the same rank's weights whole
    x = torch.from_numpy(_x((2, 8), cfg.d_model, seed=3))

    def rank(ctx):
        ep = moe.shard_expert_weights(p, cfg, ctx.iters.rank, 2)
        d, n = ctx.data.rank, cfg.d_model // 2
        fs = moe.MoE(ep.router[d * n : (d + 1) * n], ep.w_gate[:, d * n : (d + 1) * n],
                     ep.w_up[:, d * n : (d + 1) * n], ep.w_down[:, :, d * n : (d + 1) * n])
        kw = dict(group=ctx.iters, data_group=ctx.data, dtype=torch.float32)
        return (moe.moe_block_manual(fs, x, cfg, fsdp=True, **kw),
                moe.moe_block_manual(ep, x, cfg, **kw))

    for (out_f, aux_f), (out, aux) in LocalMesh(2, 2, device="cpu").run(rank):
        assert torch.equal(out_f, out) and torch.equal(aux_f, aux)
