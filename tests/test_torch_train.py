"""The train-mode forward and the loss of every row, held against the JAX
package: ``Model.loss_fn`` and its gradients (``torch.autograd``) against
``jax.value_and_grad(model.loss_fn)`` of the reference on the reduced
configs, in float32 (the rows' weights, batches and both sides' runs are
``tests/_train_rows.py``'s; bf16 and the remat modes are
``tests/test_torch_train_bf16.py``'s), and the pieces under autograd: the
experts with drops, the chunked CE, chunked attention's backward, the
flash kernel's refusal, the WKV's backward.

Tolerances: float32, the loss within 1e-4 relative and each gradient leaf
within 1e-4 of its own norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_rows import B, ROWS, S, cfgs, one_thread, port, reference  # noqa: F401
from repro.models.factory import chunked_ce_loss as ref_chunked_ce_loss
from repro.models.moe import moe_block as ref_moe_block
from repro_torch.kernels import ops
from repro_torch.models.attention import chunked_attention
from repro_torch.models.factory import chunked_ce_loss
from repro_torch.models.layers import Initializer
from repro_torch.models.moe import _capacity, _dispatch, _route, moe_block, moe_init
from repro_torch.models.rwkv6 import wkv_chunked

@pytest.mark.parametrize("name", ROWS)
def test_loss_and_gradients_match_reference_float32(name):
    want_loss, want = reference(name, "float32")
    loss, grads = port(name, "float32")
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        w = want[k]
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
        scale = w.norm().item()
        assert (g - w).norm().item() <= 1e-4 * scale + 1e-12, (k, (g - w).norm().item(), scale)


def test_expert_rows_drop_and_carry_the_aux_term():
    """At capacity factor 0.5 an expert holds 32 of the 64 slots its average
    load brings (B x S = 128 tokens, top-2 of 4), so tokens drop; the aux
    term is the reference's (its gradient is in the rows' test above)."""
    _, cfg = cfgs("phi3.5-moe-42b-a6.6b")
    t = B * S
    assert _capacity(cfg, t) * cfg.num_experts < t * cfg.experts_per_token
    x = torch.randn(t, cfg.d_model, generator=torch.Generator().manual_seed(0))
    p = moe_init(Initializer(torch.Generator().manual_seed(1), device=torch.device("cpu")), cfg)
    _, top_e, aux = _route(x, p.router, cfg.experts_per_token)
    keep = _dispatch(x, top_e, _capacity(cfg, t), cfg.num_experts, torch.float32)[3]
    assert 0 < int((~keep).sum()) and float(aux) > 0


def test_moe_block_gradients_with_drops_match_reference():
    """``moe_block`` alone: the expert, router and input gradients of
    ``sum(out * r) + aux`` == the reference's within 1e-5 of each one's
    norm, at a capacity that drops tokens."""
    rcfg, cfg = cfgs("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    p = moe_init(Initializer(torch.Generator().manual_seed(1), device=torch.device("cpu")), cfg)
    wp = {k: getattr(p, k).detach().numpy() for k in ("router", "w_gate", "w_up", "w_down")}

    def ref_loss(wp, x):
        out, aux = ref_moe_block(wp, x, rcfg, dtype=jnp.float32)
        return jnp.sum(out * r) + aux

    want_w, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in wp.items()}, jnp.asarray(x))
    p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_block(p, xt, cfg, dtype=torch.float32)
    loss = (out * torch.from_numpy(r)).sum() + aux
    got = torch.autograd.grad(loss, [getattr(p, k) for k in wp] + [xt])
    for g, w in zip(got, [want_w[k] for k in wp] + [want_x]):
        w = torch.from_numpy(np.array(w))
        assert (g - w).norm() <= 1e-5 * w.norm()


@pytest.mark.parametrize("s", [2047, 2048])
def test_chunked_ce_loss_equals_unchunked(s):
    """512-token chunks with a ragged last one (S = 2047, prime: the
    reference would fall to 1-token chunks) == one unchunked CE (in float64,
    so that the float32 sum is what is held) within 1e-6 relative (3.6e-8
    measured at 2047); == the reference's ``chunked_ce_loss`` within 1e-6
    relative plus the reference's own distance from the float64 CE (its
    2047 sequential one-token float32 adds put it 1.0e-6 off; 1.3e-8 at
    2048); the gradients within 1e-5 of their norm."""
    rng = np.random.default_rng(s)
    d, v_pad, vocab = 16, 96, 80
    h = rng.standard_normal((2, s, d)).astype(np.float32)
    head = rng.standard_normal((d, v_pad)).astype(np.float32) * 0.3
    labels = rng.integers(0, vocab, (2, s)).astype(np.int32)
    ht = torch.from_numpy(h).requires_grad_(True)
    headt = torch.from_numpy(head).requires_grad_(True)
    got = chunked_ce_loss(ht, headt, torch.from_numpy(labels), vocab_size=vocab)
    logits = ht.double() @ headt.double()
    logits = logits + torch.where(torch.arange(v_pad) < vocab, 0.0, -1e30).double()
    whole = torch.nn.functional.cross_entropy(logits.reshape(-1, v_pad),
                                              torch.from_numpy(labels).long().reshape(-1))
    assert abs(got.item() - whole.item()) <= 1e-6 * whole.item()
    want = float(ref_chunked_ce_loss(jnp.asarray(h), jnp.asarray(head), jnp.asarray(labels),
                                     vocab_size=vocab))
    assert abs(got.item() - want) <= 1e-6 * want + abs(want - whole.item())
    g1 = torch.autograd.grad(got, [ht, headt])
    g2 = torch.autograd.grad(whole, [ht, headt])
    for a, b in zip(g1, g2):
        assert (a.double() - b).norm() <= 1e-5 * b.norm()


def _naive_attention(q, k, v, causal, window):
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    logits = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    lq, lk = q.shape[2], k.shape[2]
    qpos = torch.arange(lq)[:, None] + lk - lq
    kpos = torch.arange(lk)[None, :]
    mask = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return torch.softmax(logits.masked_fill(~mask, float("-inf")), -1) @ v


@pytest.mark.parametrize("causal,window,lq,lk", [(True, 0, 50, 50), (True, 9, 50, 50),
                                                 (False, 0, 37, 50)])
def test_chunked_attention_gradients(causal, window, lq, lk):
    """Under autograd (KV steps checkpointed; 16-key tiles, ragged ends) the
    output and the q, k, v gradients == a float64 softmax attention's."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, n, 8, generator=gen, dtype=torch.float64)
               for n in (lq, lk, lk))
    k, v = k[:, :2], v[:, :2]
    r = torch.randn(2, 4, lq, 8, generator=gen, dtype=torch.float64)
    qs, ks, vs = (t.float().requires_grad_(True) for t in (q, k, v))
    out = chunked_attention(qs, ks, vs, causal=causal, window=window, q_chunk=16, kv_chunk=16)
    got = torch.autograd.grad((out * r.float()).sum(), [qs, ks, vs])
    qd, kd, vd = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = _naive_attention(qd, kd, vd, causal, window)
    want = torch.autograd.grad((ref * r).sum(), [qd, kd, vd])
    torch.testing.assert_close(out.double(), ref.detach(), rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=1e-4, atol=1e-5)


def test_flash_attention_refuses_tensors_that_need_a_gradient():
    """No flash kernel has a backward: a tensor that requires a gradient
    never reaches one (it raises on the CPU too); under no_grad it runs."""
    q = torch.randn(1, 2, 16, 16, requires_grad=True)
    k, v = torch.randn(1, 1, 16, 16), torch.randn(1, 1, 16, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape


def test_wkv_gradients_stay_finite_under_strong_decay():
    """Decays of exp(-exp(5)) a step make exp(lw_ex_i - lw_cum_j) overflow
    above the diagonal; the mask is applied before the exp, so the backward
    stays finite."""
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 2, 32, 8, generator=gen, requires_grad=True) for _ in range(3))
    logw = torch.full((1, 2, 32, 8), -float(np.exp(5.0)), requires_grad=True)
    u = torch.randn(2, 8, generator=gen, requires_grad=True)
    o, s = wkv_chunked(r, k, v, logw, u, torch.zeros(1, 2, 8, 8))
    grads = torch.autograd.grad(o.sum() + s.sum(), [r, k, v, logw, u])
    assert all(torch.isfinite(g).all() for g in grads)
