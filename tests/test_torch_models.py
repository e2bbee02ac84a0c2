"""The port's LM serving path against the JAX package's, on the reduced
configurations of the four dense rows (the other six rows are held in
tests/test_torch_lm_rows.py), and the registry of all ten.

The reference's weights (random, from a key) go through
``from_reference_params``; both sides prefill the same tokens, then decode
one more.  The reference runs ``impl="pallas"``, which reaches the Pallas
flash kernel in interpret mode; the port's prefill on the CPU runs the
kernel's plain version.  Tolerances:

* float32: logits within rtol = atol = 1e-4 (float32 sums in other orders).
  Both sides store KV caches in bf16 whatever the compute dtype (the
  reference's ``cache_dtype``), so a key that agrees to 1e-6 can round to
  either neighbouring bf16 value: the caches agree within one bf16 step
  (2^-7 relative), and on all but 0.1% of their elements exactly;
* bf16: logits within 2e-2, the reference's own tolerance for its
  decode-versus-forward test (tests/test_models.py), and caches within 2e-2
  of each tensor's scale (``_assert_caches_close``).  The reference rounds
  inside SwiGLU's SiLU at every bf16 operation, the port once, so the
  residual streams differ by bf16 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_caches, from_reference_params
from repro_torch.models.transformer import forward

DENSE = sorted(name for name, cfg in ARCHS.items() if cfg.family == "dense")
NEW_ROWS = ["rwkv6-3b", "phi3.5-moe-42b-a6.6b", "mixtral-8x22b", "llama-3.2-vision-90b",
            "whisper-base", "recurrentgemma-2b"]
B, S = 2, 128
BF16_STEP = 2.0 ** -7  # the spacing of bf16 values relative to their binade

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

_REF_CACHE = {}


def _tokens(cfg, seed=1, length=S + 1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, length)).astype(np.int32)


def _reference_params(name):
    """The reference's reduced weights; biases (zeros at init) are drawn
    from a seed, so that the QKV-bias row runs a bias that matters."""
    if name not in _REF_CACHE:
        cfg = ref_get_arch(name).reduced()
        params = jax.tree.map(np.asarray, ref_build_model(cfg).init_fn(jax.random.key(0)))
        rng = np.random.default_rng(7)

        def perturb(path, x):
            if path[-1].key == "b":
                return (rng.standard_normal(x.shape) * 0.5).astype(x.dtype)
            return x

        _REF_CACHE[name] = jax.tree_util.tree_map_with_path(perturb, params)
    return _REF_CACHE[name]


def _assert_caches_close(port, want, dtype):
    """Per layer ``slot_pos`` equal and ``k``/``v`` close (see the module's
    docstring): in float32 every element within one bf16 step and 99.9% of
    them equal; in bf16 every element within 2e-2 of the tensor's largest
    magnitude and 99.9% of them within 2e-2 elementwise.  A key is roped
    after its bf16 projection, so a one-step difference in the larger
    element of a rotated pair shows in the smaller one at the larger one's
    scale."""
    assert len(port) == len(want)
    for c, w in zip(port, want):
        torch.testing.assert_close(c["slot_pos"], w["slot_pos"], rtol=0, atol=0)
        for key in ("k", "v"):
            assert c[key].dtype == torch.bfloat16
            a, b = c[key].float(), w[key].float()
            if dtype == "float32":
                torch.testing.assert_close(a, b, rtol=BF16_STEP, atol=1e-4)
                assert (a != b).float().mean().item() <= 1e-3
            else:
                torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * b.abs().max().item())
                far = (a - b).abs() > 2e-2 + 2e-2 * b.abs()
                assert far.float().mean().item() <= 1e-3


@pytest.mark.parametrize("cast", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_reference(name, dtype, cast):
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    rparams = _reference_params(name)
    toks = _tokens(cfg)
    rmodel = ref_build_model(rcfg, impl="pallas", dtype=jdt, cast_params=cast)
    rlogits, rcaches = jax.jit(rmodel.prefill_fn)(rparams, {"tokens": jnp.asarray(toks[:, :S])})
    rdec, rcaches2 = jax.jit(rmodel.decode_fn)(
        rparams, {"tokens": jnp.asarray(toks[:, S:]), "pos": jnp.asarray(S, jnp.int32),
                  "caches": rcaches})

    model = build_model(cfg, dtype=tdt, cast_params=cast, device="cpu")
    params = from_reference_params(rparams, cfg, dtype=tdt if cast else None)
    logits, caches = model.prefill_fn(params, {"tokens": torch.from_numpy(toks[:, :S])})
    assert logits.shape == (B, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=tol, atol=tol)
    _assert_caches_close(caches, from_reference_caches(jax.tree.map(np.asarray, rcaches), cfg),
                         dtype)

    dec, caches = model.decode_fn(params, {"tokens": torch.from_numpy(toks[:, S:]), "pos": S,
                                           "caches": caches})
    np.testing.assert_allclose(dec.numpy(), np.asarray(rdec), rtol=tol, atol=tol)
    _assert_caches_close(caches, from_reference_caches(jax.tree.map(np.asarray, rcaches2), cfg),
                         dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_equals_forward(name, dtype):
    """The reference's test_decode_matches_forward, on the port alone: the
    decode logits of token s equal the last logits of a forward over s + 1
    tokens within its 2e-2 (the cache holds bf16 keys and values)."""
    _, tdt, _ = DTYPES[dtype]
    cfg = get_arch(name).reduced()
    model = build_model(cfg, dtype=tdt, cast_params=True, device="cpu")
    gen = torch.Generator().manual_seed(3)
    params = model.init_fn(gen)
    toks = torch.from_numpy(_tokens(cfg, seed=4, length=17))
    _, caches = model.prefill_fn(params, {"tokens": toks[:, :16]})
    dec, _ = model.decode_fn(params, {"tokens": toks[:, 16:], "pos": 16, "caches": caches})
    full, none, aux = forward(params, cfg, toks, mode="train", dtype=tdt)
    assert float(aux) == 0.0  # a dense row has no load-balancing loss
    assert none is None
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-2, atol=2e-2)


def test_decode_wraps_a_windowed_cache():
    """A sliding window shorter than the prompt: the cache keeps the last
    window + 128 positions at slots position % S, and decoding writes past
    its end by wrapping.  The reference's windowed row is a MoE row, so the
    window is set on a dense one here; the reference prefills through its
    XLA path (the Pallas kernel wants L % 128 == 0)."""
    window, length = 8, 160
    cfg = dataclasses.replace(get_arch("smollm-360m").reduced(), window=window)
    rcfg = dataclasses.replace(ref_get_arch("smollm-360m").reduced(), window=window)
    rparams = jax.tree.map(np.asarray, ref_build_model(rcfg).init_fn(jax.random.key(5)))
    rmodel = ref_build_model(rcfg, dtype=jnp.float32)
    toks = _tokens(cfg, seed=6, length=length + 2)
    rl, rc = jax.jit(rmodel.prefill_fn)(rparams, {"tokens": jnp.asarray(toks[:, :length])})
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = from_reference_params(rparams, cfg)
    logits, caches = model.prefill_fn(params, {"tokens": torch.from_numpy(toks[:, :length])})
    assert caches[0]["k"].shape[2] == window + 128 < length
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=1e-4, atol=1e-4)
    _assert_caches_close(caches, from_reference_caches(jax.tree.map(np.asarray, rc), cfg),
                         "float32")
    for pos in (length, length + 1):
        rd, rc = jax.jit(rmodel.decode_fn)(rparams, {
            "tokens": jnp.asarray(toks[:, pos : pos + 1]), "pos": jnp.asarray(pos, jnp.int32),
            "caches": rc})
        dec, caches = model.decode_fn(params, {"tokens": torch.from_numpy(toks[:, pos : pos + 1]),
                                               "pos": pos, "caches": caches})
        np.testing.assert_allclose(dec.numpy(), np.asarray(rd), rtol=1e-4, atol=1e-4)
    _assert_caches_close(caches, from_reference_caches(jax.tree.map(np.asarray, rc), cfg),
                         "float32")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_full_rows_param_count_equals_reference(name):
    assert get_arch(name).params_count() == ref_get_arch(name).params_count()
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(ref_get_arch(name))


@pytest.mark.parametrize("cast", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_init_shapes_equal_converted_reference(name, cast):
    cfg = get_arch(name).reduced()
    model = build_model(cfg, cast_params=cast, device="cpu")
    ours = model.init_fn(torch.Generator().manual_seed(0))
    theirs = from_reference_params(_reference_params(name), cfg,
                                   dtype=torch.bfloat16 if cast else None)
    got = {k: (tuple(v.shape), v.dtype) for k, v in ours.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in theirs.named_parameters()}
    assert got == want
    assert {v.dtype for v in ours.parameters() if v.dim() == 1} == {torch.float32}
    assert {v.dtype for v in ours.parameters() if v.dim() >= 2} == (
        {torch.bfloat16} if cast else {torch.float32})
    n = sum(v.numel() for v in ours.parameters())
    vocab_pad = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * 2
    norms = cfg.d_model * (2 * cfg.num_layers + 1)
    biases = cfg.num_layers * cfg.resolved_head_dim * (cfg.num_heads + 2 * cfg.num_kv_heads)
    assert n == cfg.params_count() + vocab_pad + norms + (biases if cfg.attn_bias else 0)


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(), d_model=256, d_ff=512)
    params = build_model(cfg, device="cpu").init_fn(torch.Generator().manual_seed(0))
    blk = params.blocks[0]
    for w, scale in ((params.embed, 0.02), (params.lm_head, 0.02), (blk.attn.wq.w, 256 ** -0.5),
                     (blk.ffn.w_gate, 256 ** -0.5), (blk.ffn.w_down, 512 ** -0.5)):
        assert abs(w.float().std().item() / scale - 1) < 0.05
        assert abs(w.float().mean().item()) < 0.05 * scale
    assert torch.equal(blk.ln1, torch.ones(256)) and torch.equal(params.final_norm, torch.ones(256))


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("granite-3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    assert build_model(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("name", NEW_ROWS)
def test_every_row_is_served(name):
    """The six rows that once waited for ROADMAP queue 1 items 11-15: the
    registry serves each, equal to the reference's row, and its reduced
    config builds and initialises on the CPU."""
    cfg = get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_arch(name))
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref_get_arch(name).reduced())
    model = build_model(cfg.reduced(), device="cpu")
    params = model.init_fn(torch.Generator().manual_seed(0))
    assert [blk.kind for blk in params.blocks] == [
        cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.reduced().num_layers)]
    assert list(ARCHS) == list(REF_ARCHS)


@pytest.mark.parametrize("name", DENSE)
def test_init_caches_equal_reference(name):
    rcfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    ref_caches = ref_build_model(rcfg).init_caches_fn(3, 40)
    want = from_reference_caches(jax.tree.map(np.asarray, ref_caches), cfg)
    got = build_model(cfg, device="cpu").init_caches_fn(3, 40)
    assert len(got) == len(want) == cfg.num_layers
    for c, w in zip(got, want):
        for key in ("k", "v", "slot_pos"):
            assert c[key].dtype == w[key].dtype
            torch.testing.assert_close(c[key], w[key], rtol=0, atol=0)
