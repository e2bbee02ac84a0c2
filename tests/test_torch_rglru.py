"""The port's RG-LRU against the JAX package's: the log-depth linear scan
against the reference's ``associative_scan`` and a sequential loop (with
and without an initial state), the block (float32 within 1e-4, bf16 within
2e-2), and the state a prefill leaves (``h`` and the conv's last three
pre-conv inputs), which decode continues as a longer prefill would.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import rglru as ref_rglru
from repro.models.layers import Initializer as RefInitializer
from repro_torch.configs import get_arch
from repro_torch.models import rglru
from repro_torch.models.layers import Dense

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _scan_inputs(l, seed=0, b=2, d=24):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, l, d)).astype(np.float32)
    bx = rng.standard_normal((b, l, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, bx, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l", [1, 2, 37, 256])
def test_lru_scan_matches_associative_scan_and_a_loop(l, with_h0):
    a, bx, h0 = _scan_inputs(l)
    want = ref_rglru._lru_scan(jnp.asarray(a), jnp.asarray(bx),
                               jnp.asarray(h0) if with_h0 else None)
    got = rglru._lru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                          torch.from_numpy(h0) if with_h0 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    h = h0 if with_h0 else np.zeros_like(h0)
    loop = np.empty_like(bx)
    for t in range(l):
        h = a[:, t] * h + bx[:, t]
        loop[:, t] = h
    np.testing.assert_allclose(got.numpy(), loop, rtol=1e-5, atol=1e-5)


def _weights(seed=0):
    rcfg, cfg = ref_get_arch("recurrentgemma-2b").reduced(), get_arch("recurrentgemma-2b").reduced()
    rp = jax.tree.map(np.asarray, ref_rglru.rglru_init(RefInitializer(jax.random.key(seed)), rcfg))
    rng = np.random.default_rng(seed + 10)
    for name in ("lru_a", "lru_x"):  # biases and conv bias are zero at init
        rp[name]["b"] = (rng.standard_normal(rp[name]["b"].shape) * 0.5).astype(np.float32)
    rp["conv_b"] = (rng.standard_normal(rp["conv_b"].shape) * 0.1).astype(np.float32)

    def ten(x):
        return torch.from_numpy(np.array(x))

    def dense(p):
        return Dense(ten(p["w"]), ten(p["b"]) if "b" in p else None)

    p = rglru.RgLru(w_in=dense(rp["w_in"]), w_gate=dense(rp["w_gate"]), conv_w=ten(rp["conv_w"]),
                    conv_b=ten(rp["conv_b"]), lru_a=dense(rp["lru_a"]), lru_x=dense(rp["lru_x"]),
                    lambda_raw=ten(rp["lambda_raw"]), w_out=dense(rp["w_out"]))
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_block_matches_reference(dtype, with_state):
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, rp, p = _weights()
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 50, cfg.d_model)) * 0.5).astype(np.float32)
    st = None
    if with_state:
        st = {"h": rng.standard_normal((2, cfg.d_model)).astype(np.float32),
              "conv": rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)}
    want, wst = ref_rglru.rglru_block(rp, jnp.asarray(x, jdt), rcfg,
                                      state=None if st is None else jax.tree.map(jnp.asarray, st),
                                      dtype=jdt)
    got, gst = rglru.rglru_block(p, torch.from_numpy(x).to(tdt), cfg,
                                 state=None if st is None else {k: torch.from_numpy(v)
                                                                for k, v in st.items()},
                                 dtype=tdt)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert (gst is None) == (not with_state)
    if with_state:
        for key in ("h", "conv"):
            scale = max(1.0, float(np.abs(np.asarray(wst[key])).max()))
            np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]), rtol=tol,
                                       atol=tol * scale)


def test_conv_state_carries_across_decode():
    """Prefill of 20 tokens, then three decode steps, == prefill of 23 at
    each step's position, and the state after == the longer prefill's."""
    _, cfg, _, p = _weights(2)
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((2, 23, cfg.d_model)) * 0.5
                          ).astype(np.float32))

    def zero():
        return rglru.init_rglru_state(2, cfg.d_model, device=torch.device("cpu"))

    full, s_full = rglru.rglru_block(p, x, cfg, state=zero(), dtype=torch.float32)
    _, state = rglru.rglru_block(p, x[:, :20], cfg, state=zero(), dtype=torch.float32)
    for t in range(20, 23):
        out, state = rglru.rglru_decode(p, x[:, t], cfg, state, dtype=torch.float32)
        torch.testing.assert_close(out, full[:, t], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state["h"], s_full["h"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state["conv"], s_full["conv"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state["conv"][:, -1], x[:, 22] @ p.w_in.w, rtol=1e-5, atol=1e-6)
