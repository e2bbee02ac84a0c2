"""The port's RWKV6 against the JAX package's: the chunked WKV recurrence
against the reference's and against the port's own step-by-step oracle,
the time-mix and channel-mix blocks (float32 within 1e-4, bf16 within
2e-2), and the state a prefill leaves, which decode continues exactly as a
longer prefill would.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import rwkv6 as ref_rwkv
from repro.models.layers import Initializer as RefInitializer
from repro_torch.configs import get_arch
from repro_torch.models import rwkv6
from repro_torch.models.layers import Dense

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _wkv_inputs(seed, b=2, h=3, l=96, d=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, h, l, d)).astype(np.float32) * 0.5 - 1.5)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("l", [96, 20, 1])
def test_wkv_chunked_matches_reference_and_scan(l):
    """Chunks of 32 (or one chunk of L <= 32) against the reference's
    chunked WKV and the port's step-by-step oracle, output and state."""
    xs = _wkv_inputs(0, l=l)
    o_ref, s_ref = ref_rwkv.wkv_chunked(*map(jnp.asarray, xs), chunk=32)
    o, s = rwkv6.wkv_chunked(*map(torch.from_numpy, xs), chunk=32)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-4)
    o2, s2 = rwkv6.wkv_scan_ref(*map(torch.from_numpy, xs))
    torch.testing.assert_close(o, o2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s2, rtol=1e-4, atol=1e-4)


def test_wkv_chunked_admits_only_whole_chunks():
    xs = [torch.from_numpy(x) for x in _wkv_inputs(1, l=33)]
    with pytest.raises(ValueError, match="multiple of 32"):
        rwkv6.wkv_chunked(*xs)


def _weights(seed=0):
    rcfg, cfg = ref_get_arch("rwkv6-3b").reduced(), get_arch("rwkv6-3b").reduced()
    rp = jax.tree.map(np.asarray, ref_rwkv.rwkv_init(RefInitializer(jax.random.key(seed)), rcfg))
    t, c = rp["time"], rp["channel"]

    def ten(x):
        return torch.from_numpy(np.array(x))

    time = rwkv6.RwkvTime(**{k: ten(t[k]) for k in ("mix_r", "mix_k", "mix_v", "mix_g",
                                                   "mix_w", "w_base", "w_lora_a", "w_lora_b",
                                                   "u_bonus", "ln_x")},
                          **{k: Dense(ten(t[k]["w"])) for k in ("wr", "wk", "wv", "wg", "wo")})
    channel = rwkv6.RwkvChannel(ten(c["mix_k"]), Dense(ten(c["wk"]["w"])),
                                Dense(ten(c["wv"]["w"])))
    return rcfg, cfg, rp, time, channel


def _state(rcfg, seed, b):
    hd = rcfg.resolved_head_dim
    h = rcfg.d_model // hd
    rng = np.random.default_rng(seed)
    return {"wkv": (rng.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32),
            "x_prev_t": rng.standard_normal((b, rcfg.d_model)).astype(np.float32),
            "x_prev_c": rng.standard_normal((b, rcfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_time_and_channel_mix_match_reference(dtype, with_state):
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, rp, time, channel = _weights()
    x = (np.random.default_rng(2).standard_normal((2, 64, cfg.d_model)) * 0.5).astype(np.float32)
    st = _state(rcfg, 3, 2) if with_state else None
    rst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    pst = None if st is None else {k: torch.from_numpy(v) for k, v in st.items()}
    want, wst = ref_rwkv.rwkv_block(rp, jnp.asarray(x, jdt), rcfg, state=rst, dtype=jdt)
    got, gst = rwkv6.rwkv_block(time, torch.from_numpy(x).to(tdt), cfg, state=pst, dtype=tdt)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    cw, cwst = ref_rwkv.rwkv_channel_mix(rp, jnp.asarray(x, jdt), state=wst, dtype=jdt)
    cg, cgst = rwkv6.rwkv_channel_mix(channel, torch.from_numpy(x).to(tdt), state=gst, dtype=tdt)
    np.testing.assert_allclose(cg.float().numpy(), np.asarray(cw.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert (gst is None) == (not with_state)
    if with_state:
        for key in ("wkv", "x_prev_t", "x_prev_c"):
            scale = max(1.0, float(np.abs(np.asarray(cwst[key])).max()))
            np.testing.assert_allclose(cgst[key].numpy(), np.asarray(cwst[key]), rtol=tol,
                                       atol=tol * scale)


def test_prefill_then_decode_equals_longer_prefill():
    """Prefill of L = 31 tokens then one decode step == prefill of 32, in
    float32: the last output and every state tensor (wkv, both shifts)."""
    rcfg, cfg, rp, time, channel = _weights(1)
    x = torch.from_numpy((np.random.default_rng(5).standard_normal((2, 32, cfg.d_model)) * 0.5
                          ).astype(np.float32))
    hd = cfg.resolved_head_dim

    def zero():
        return rwkv6.init_rwkv_state(2, cfg.d_model // hd, hd, cfg.d_model,
                                     device=torch.device("cpu"))

    def run(xs, state):
        out, state = rwkv6.rwkv_block(time, xs, cfg, state=state, dtype=torch.float32)
        cm, state = rwkv6.rwkv_channel_mix(channel, xs, state=state, dtype=torch.float32)
        return out + cm, state

    full, s_full = run(x, zero())
    _, s31 = run(x[:, :31], zero())
    step, s32 = rwkv6.rwkv_decode(time, x[:, 31], cfg, s31, dtype=torch.float32)
    cm, s32 = rwkv6.rwkv_channel_mix(channel, x[:, 31:], state=s32, dtype=torch.float32)
    torch.testing.assert_close(step + cm[:, 0], full[:, -1], rtol=1e-4, atol=1e-4)
    for key in ("wkv", "x_prev_t", "x_prev_c"):
        torch.testing.assert_close(s32[key], s_full[key], rtol=1e-4, atol=1e-4)
