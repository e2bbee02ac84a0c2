"""The six rows beyond the dense decoders, served by the port and held
against the JAX package on their reduced configurations: vision
cross-attention (llama-3.2-vision-90b), experts (phi3.5-moe, mixtral),
RWKV6 (rwkv6-3b), RG-LRU with local attention (recurrentgemma-2b) and the
whisper encoder-decoder, plus an ``attn_cross`` pattern no row uses.

The reference's weights (random, from a key; biases and the cross gates,
zero at init, drawn from a seed) go through ``from_reference_params``;
both sides prefill the same tokens over the same context, then decode one
more.  The reference runs ``impl="pallas"`` (its flash kernel in interpret
mode); the port's self-attention on the CPU runs the kernel's plain version.
Tolerances as in tests/test_torch_models.py: float32 logits within 1e-4,
bf16 within 2e-2; caches within one bf16 step (bf16 keys and values) or the
logits' tolerance (states and context keys, scaled by each tensor's
largest magnitude in bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.models.transformer import encode as ref_encode
from repro.models.transformer import forward as ref_forward
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_caches, from_reference_params
from repro_torch.models.factory import context_len
from repro_torch.models.transformer import encode, forward

ROWS = ["llama-3.2-vision-90b", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
        "rwkv6-3b", "whisper-base"]
B, S = 2, 128
BF16_STEP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

_REF_PARAMS = {}
_REF_RUNS = {}


def _cfgs(name, pattern=None):
    rcfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    if pattern is not None:
        rcfg = dataclasses.replace(rcfg, block_pattern=pattern)
        cfg = dataclasses.replace(cfg, block_pattern=pattern)
    return rcfg, cfg


def _reference_params(name, pattern=None):
    """The reference's reduced weights, biases and ``xgate`` drawn nonzero."""
    key = (name, pattern)
    if key not in _REF_PARAMS:
        rcfg, _ = _cfgs(name, pattern)
        params = jax.tree.map(np.asarray, ref_build_model(rcfg).init_fn(jax.random.key(0)))
        rng = np.random.default_rng(7)

        def perturb(path, x):
            if path[-1].key in ("b", "xgate"):
                return (rng.standard_normal(x.shape) * 0.5).astype(x.dtype)
            return x

        _REF_PARAMS[key] = jax.tree_util.tree_map_with_path(perturb, params)
    return _REF_PARAMS[key]


def _batch(cfg, length, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, length)).astype(np.int32)}
    ctx_len, needed = context_len(cfg)
    if needed:
        batch["context"] = (rng.standard_normal((B, ctx_len, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _reference_run(name, dtype, cast, pattern=None):
    """The reference's prefill of S tokens then one decode step, run once per
    (row, dtype, cast); casting changes nothing in float32."""
    key = (name, dtype, cast and dtype == "bfloat16", pattern)
    if key not in _REF_RUNS:
        jdt = DTYPES[dtype][0]
        rcfg, _ = _cfgs(name, pattern)
        rmodel = ref_build_model(rcfg, impl="pallas", dtype=jdt, cast_params=key[2])
        batch = _batch(rcfg, S + 1)
        toks = batch["tokens"]
        pre = {"tokens": jnp.asarray(toks[:, :S])}
        if "context" in batch:
            pre["context"] = jnp.asarray(batch["context"])
        params = _reference_params(name, pattern)
        rlogits, rcaches = jax.jit(rmodel.prefill_fn)(params, pre)
        rdec, rcaches2 = jax.jit(rmodel.decode_fn)(params, {
            "tokens": jnp.asarray(toks[:, S:]), "pos": jnp.asarray(S, jnp.int32),
            "caches": rcaches})
        _REF_RUNS[key] = (batch, np.asarray(rlogits), jax.tree.map(np.asarray, rcaches),
                          np.asarray(rdec), jax.tree.map(np.asarray, rcaches2))
    return _REF_RUNS[key]


def _assert_caches_close(port, want, dtype):
    """Per layer the same keys; ``slot_pos`` equal; bf16 ``k``/``v`` within
    one bf16 step in float32 (99.9% equal) and within 2e-2 of the tensor's
    scale in bf16; every other tensor (states, context keys and values) in
    the reference's dtype, within the logits' tolerance (bf16: of the
    tensor's scale)."""
    tol = DTYPES[dtype][2]
    assert len(port) == len(want)
    for c, w in zip(port, want):
        assert sorted(c) == sorted(w)
        for key in c:
            assert c[key].dtype == w[key].dtype, key
            a, b = c[key].float(), w[key].float()
            if key == "slot_pos":
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            elif key in ("k", "v") and dtype == "float32":
                torch.testing.assert_close(a, b, rtol=BF16_STEP, atol=1e-4)
                assert (a != b).float().mean().item() <= 1e-3
            else:
                scale = max(1.0, b.abs().max().item()) if dtype == "bfloat16" else 1.0
                torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale)


def _prefill_decode(name, dtype, cast, pattern=None):
    _, tdt, tol = DTYPES[dtype]
    _, cfg = _cfgs(name, pattern)
    batch, rlogits, rcaches, rdec, rcaches2 = _reference_run(name, dtype, cast, pattern)
    model = build_model(cfg, dtype=tdt, cast_params=cast, device="cpu")
    params = from_reference_params(_reference_params(name, pattern), cfg,
                                   dtype=tdt if cast else None)
    toks = torch.from_numpy(batch["tokens"])
    pre = {"tokens": toks[:, :S]}
    if "context" in batch:
        pre["context"] = torch.from_numpy(batch["context"])
    logits, caches = model.prefill_fn(params, pre)
    assert logits.shape == (B, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), rlogits, rtol=tol, atol=tol)
    _assert_caches_close(caches, from_reference_caches(rcaches, cfg), dtype)
    dec, caches = model.decode_fn(params, {"tokens": toks[:, S:], "pos": S, "caches": caches})
    np.testing.assert_allclose(dec.numpy(), rdec, rtol=tol, atol=tol)
    _assert_caches_close(caches, from_reference_caches(rcaches2, cfg), dtype)


@pytest.mark.parametrize("dtype,cast", [("float32", False), ("float32", True),
                                        ("bfloat16", False), ("bfloat16", True)])
@pytest.mark.parametrize("name", ROWS)
def test_prefill_and_decode_match_reference(name, dtype, cast):
    _prefill_decode(name, dtype, cast)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attn_cross_pattern_matches_reference(dtype):
    """``attn_cross`` (self-attention, cross-attention and an FFN in one
    block), which no row uses, on whisper's reduced config."""
    _prefill_decode("whisper-base", dtype, False, pattern=("attn_cross",))


def _no_drop(cfg):
    # ample capacity: the forward over L + 1 tokens must drop no token, or
    # its logits rightly differ from the drop-free decode step
    return dataclasses.replace(cfg, capacity_factor=64.0) if cfg.num_experts else cfg


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ROWS + ["attn_cross"])
def test_prefill_then_decode_equals_forward(name, dtype):
    """The reference's test_decode_matches_forward on the port alone: the
    decode logits of token s equal the last logits of a forward over s + 1
    tokens within 2e-2 (s = 16: rwkv's chunk admits any L up to 32)."""
    _, tdt, _ = DTYPES[dtype]
    if name == "attn_cross":
        _, cfg = _cfgs("whisper-base", ("attn_cross",))
    else:
        _, cfg = _cfgs(name)
    cfg = _no_drop(cfg)
    model = build_model(cfg, dtype=tdt, cast_params=True, device="cpu")
    params = model.init_fn(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(5)
    for blk in params.blocks:  # zero gates would make the cross blocks no-ops
        if hasattr(blk, "xgate"):
            blk.xgate.copy_(torch.randn((), generator=gen))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 17, seed=4).items()}
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[:, :16])
    _, caches = model.prefill_fn(params, pre)
    dec, _ = model.decode_fn(params, {"tokens": toks[:, 16:], "pos": 16, "caches": caches})
    ctx = batch.get("context")
    if ctx is not None:
        ctx = encode(params, cfg, ctx, dtype=tdt) if cfg.family == "audio" else ctx.to(tdt)
    full, none, _ = forward(params, cfg, toks, context=ctx, mode="train", dtype=tdt)
    assert none is None
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ROWS)
def test_encode_and_forward_match_reference(name):
    """``forward`` in train mode (and the encoder for whisper) against the
    reference's, float32, on a prompt of S tokens: the logits, and the aux
    loss within 1e-5 of its magnitude (the experts' load-balancing loss on
    the MoE rows, 0 on the others)."""
    rcfg, cfg = _cfgs(name)
    rparams = _reference_params(name)
    batch = _batch(cfg, S, seed=9)
    rctx = ctx = None
    if "context" in batch:
        rctx = jnp.asarray(batch["context"])
        ctx = torch.from_numpy(batch["context"])
    params = from_reference_params(rparams, cfg)
    if cfg.family == "audio":
        rctx = ref_encode(rparams, rcfg, rctx, dtype=jnp.float32)
        ctx = encode(params, cfg, ctx, dtype=torch.float32)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(rctx), rtol=1e-4, atol=1e-4)
    want, _, want_aux = jax.jit(lambda p, t, c: ref_forward(
        p, rcfg, t, context=c, mode="train", impl="pallas", dtype=jnp.float32))(
        rparams, jnp.asarray(batch["tokens"]), rctx)
    got, none, aux = forward(params, cfg, torch.from_numpy(batch["tokens"]), context=ctx,
                             dtype=torch.float32)
    assert none is None and aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_aux = float(want_aux)
    assert (want_aux > 0) == (cfg.num_experts > 0), (name, want_aux)
    assert abs(float(aux) - want_aux) <= 1e-5 * abs(want_aux), (float(aux), want_aux)


@pytest.mark.parametrize("name", ROWS)
def test_init_caches_equal_reference(name):
    rcfg, cfg = _cfgs(name)
    want = from_reference_caches(jax.tree.map(np.asarray,
                                              ref_build_model(rcfg).init_caches_fn(3, 40)), cfg)
    got = build_model(cfg, device="cpu").init_caches_fn(3, 40)
    assert len(got) == len(want) == cfg.num_layers
    for c, w in zip(got, want):
        assert sorted(c) == sorted(w)
        for key in c:
            assert c[key].dtype == w[key].dtype
            torch.testing.assert_close(c[key], w[key], rtol=0, atol=0)


@pytest.mark.parametrize("cast", [False, True])
@pytest.mark.parametrize("name", ROWS)
def test_init_shapes_equal_converted_reference(name, cast):
    _, cfg = _cfgs(name)
    ours = build_model(cfg, cast_params=cast, device="cpu").init_fn(
        torch.Generator().manual_seed(0))
    theirs = from_reference_params(_reference_params(name), cfg,
                                   dtype=torch.bfloat16 if cast else None)
    got = {k: (tuple(v.shape), v.dtype) for k, v in ours.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in theirs.named_parameters()}
    assert got == want
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(_reference_params(name)))
    assert sum(v.numel() for v in ours.parameters()) == n_ref


def test_local_cache_holds_the_window():
    """A ``local`` layer's cache holds ``min(s_buf, local_window + 128)``
    slots, its ``attn`` neighbours ``s_buf``."""
    _, cfg = _cfgs("recurrentgemma-2b")
    caches = build_model(cfg, device="cpu").init_caches_fn(1, 4096)
    kinds = [cfg.block_pattern[i % 3] for i in range(cfg.num_layers)]
    local = [c["k"].shape[2] for c, k in zip(caches, kinds) if k == "local"]
    assert local == [cfg.local_window + 128]
    assert {tuple(c) for c, k in zip(caches, kinds) if k == "rglru"} == {("h", "conv")}


def test_a_float32_cache_takes_out_the_cache_rounding():
    """``cache_dtype``: keys and values stored in float32 (the reference's
    bf16 is the default) make the float32 decode step equal the forward to
    float32 rounding, where over the bf16 cache it carries the cache's own
    rounding; the chip smoke test holds the full-width rows this way."""
    _, cfg = _cfgs("llama-3.2-vision-90b")
    gen = torch.Generator().manual_seed(11)
    model = build_model(cfg, dtype=torch.float32, device="cpu", cache_dtype=torch.float32)
    params = model.init_fn(gen)
    for blk in params.blocks:
        if hasattr(blk, "xgate"):
            blk.xgate.copy_(torch.randn((), generator=gen))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 17, seed=12).items()}
    toks = batch["tokens"]
    _, caches = model.prefill_fn(params, dict(batch, tokens=toks[:, :16]))
    assert {c["k"].dtype for c in caches if "k" in c} == {torch.float32}
    assert model.init_caches_fn(2, 16)[0]["k"].dtype == torch.float32
    dec, _ = model.decode_fn(params, {"tokens": toks[:, 16:], "pos": 16, "caches": caches})
    full, _, _ = forward(params, cfg, toks, context=batch["context"], dtype=torch.float32)
    torch.testing.assert_close(dec, full[:, -1], rtol=1e-5, atol=1e-5)


def test_served_callables_refuse_weights_of_another_config():
    """The weights carry their config: ``prefill_fn`` and ``decode_fn`` of a
    model built for ``cfg`` refuse weights drawn under another capacity
    factor, and serve them once ``params.cfg`` is rebound to ``cfg``."""
    _, cfg = _cfgs("mixtral-8x22b")
    other = dataclasses.replace(cfg, capacity_factor=64.0)
    params = build_model(other, dtype=torch.float32, device="cpu").init_fn(
        torch.Generator().manual_seed(5))
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="capacity_factor"):
        model.prefill_fn(params, {"tokens": toks})
    with pytest.raises(ValueError, match="capacity_factor"):
        model.decode_fn(params, {"tokens": toks[:, :1], "pos": 4,
                                 "caches": model.init_caches_fn(1, 4)})
    params.cfg = cfg
    logits, _ = model.prefill_fn(params, {"tokens": toks})
    assert logits.shape == (1, cfg.padded_vocab) and torch.isfinite(logits).all()
