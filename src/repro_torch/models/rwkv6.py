"""RWKV6 (Finch) block: time-mix with data-dependent decay, and channel-mix.

Counterpart of ``repro/models/rwkv6.py``.  The decay of each channel and
step is ``w_t = exp(-exp(base + tanh(x_t A) B))``; the r/k/v/g token-shift
interpolations use static learned mixes, as in the reference.

The recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,     o_t = r_t S_{t-1} + (r_t.u.k_t) v_t

runs in chunks (:func:`wkv_chunked`): within a chunk of C steps it is a
lower-triangular contraction with pairwise decays ``exp(lw_ex_i -
lw_cum_j)`` (exponentials of differences of cumulative log-decays, which
are <= 0), plus the state carried in from the chunks before.
:func:`wkv_scan_ref`, one step at a time, is its oracle.  Decode carries the
state ``S`` and the last token of each mix per layer.  All of it is plain
torch, as the reference's is XLA.

On a ``data x model`` mesh (:func:`rwkv_block_tp`,
:func:`rwkv_channel_mix_tp`) ``wr``, ``wk``, ``wv``, ``wg`` and the
channel-mix's ``wk`` are column-parallel, ``wo`` and the channel-mix's
``wv`` row-parallel; the mixes, the decay's LoRA and base, ``u`` and
``ln_x`` are replicated.  Where the heads divide the model axis a rank's
columns are ``H / model`` whole heads: it runs their WKV and group norm
alone, and its ``wkv`` state is those heads' ``[B, H / model, dk, dv]``.
The reference's cache spec splits ``dv`` over the model axis instead
(``[B, H, dk, dv / model]``): the same number of elements a rank, in
another layout, a reviewed departure (ROADMAP queue 3) that keeps the
heads' group norm on one rank.  Where the heads do not divide the axis,
every rank gathers r, k, v and g and runs every head (its state whole), as
cut attention heads do.  ``x_prev_t`` and ``x_prev_c`` are a rank's block
of channels ``[B, D / model]``, gathered where a step reads them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import all_gather_cat
from ..kernels.ref import ELEMENT_BUDGET
from .layers import Dense, Initializer, MeshShard, dense_init, weight

__all__ = [
    "RwkvTime",
    "RwkvChannel",
    "rwkv_init",
    "init_rwkv_state",
    "wkv_scan_ref",
    "wkv_chunked",
    "rwkv_block",
    "rwkv_block_tp",
    "rwkv_channel_mix",
    "rwkv_channel_mix_tp",
    "rwkv_decode",
]

#: steps per chunk of :func:`wkv_chunked`, the reference's
CHUNK = 32


class RwkvTime(nn.Module):
    """The time-mix weights: five token-shift mixes ``[d]``, the r/k/v/g/o
    projections, the decay's base ``[d]`` and LoRA ``[d, lora]``, ``[lora,
    d]``, the bonus ``u`` ``[H, hd]`` and the output group norm's scale."""

    def __init__(self, mix_r, mix_k, mix_v, mix_g, mix_w, wr: Dense, wk: Dense, wv: Dense,
                 wg: Dense, wo: Dense, w_base, w_lora_a, w_lora_b, u_bonus, ln_x):
        super().__init__()
        for name, x in (("mix_r", mix_r), ("mix_k", mix_k), ("mix_v", mix_v), ("mix_g", mix_g),
                        ("mix_w", mix_w), ("w_base", w_base), ("w_lora_a", w_lora_a),
                        ("w_lora_b", w_lora_b), ("u_bonus", u_bonus), ("ln_x", ln_x)):
            setattr(self, name, weight(x))
        self.wr, self.wk, self.wv, self.wg, self.wo = wr, wk, wv, wg, wo


class RwkvChannel(nn.Module):
    """The channel-mix weights: a token-shift mix ``[d]``, ``wk`` ``[d, f]``
    and ``wv`` ``[f, d]``."""

    def __init__(self, mix_k, wk: Dense, wv: Dense):
        super().__init__()
        self.mix_k = weight(mix_k)
        self.wk, self.wv = wk, wv


def rwkv_init(init: Initializer, cfg):
    """``(time, channel)`` with the reference's distributions."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h = d // hd
    lora = max(32, d // 16)
    time = RwkvTime(
        mix_r=init.normal((d,), 0.5), mix_k=init.normal((d,), 0.5),
        mix_v=init.normal((d,), 0.5), mix_g=init.normal((d,), 0.5),
        mix_w=init.normal((d,), 0.5),
        wr=dense_init(init, d, d), wk=dense_init(init, d, d), wv=dense_init(init, d, d),
        wg=dense_init(init, d, d), wo=dense_init(init, d, d),
        w_base=init.normal((d,), 0.5) - 6.0,
        w_lora_a=init.normal((d, lora), 0.02), w_lora_b=init.normal((lora, d), 0.02),
        u_bonus=init.normal((h, hd), 0.5), ln_x=init.ones((d,)))
    channel = RwkvChannel(mix_k=init.normal((d,), 0.5), wk=dense_init(init, d, cfg.d_ff),
                          wv=dense_init(init, cfg.d_ff, d))
    return time, channel


def init_rwkv_state(batch: int, num_heads: int, head_dim: int, d_model: int, *,
                    device: torch.device) -> dict:
    """Zero state: ``wkv`` ``[B, H, hd, hd]`` and the last token of the time
    and channel mixes ``[B, d]``, all float32."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {"wkv": z(batch, num_heads, head_dim, head_dim), "x_prev_t": z(batch, d_model),
            "x_prev_c": z(batch, d_model)}


# ---------------------------------------------------------------------------
# WKV recurrence
# ---------------------------------------------------------------------------


def wkv_scan_ref(r, k, v, logw, u, s0):
    """One step at a time (the oracle).  ``r``, ``k``, ``v``, ``logw``:
    ``[B, H, L, D]``; ``u`` ``[H, D]``; ``s0`` ``[B, H, D, D]``.  Returns
    ``(o [B, H, L, D], s_L)``."""
    s = s0
    outs = []
    for t in range(r.shape[2]):
        kv = torch.einsum("bhi,bhj->bhij", k[:, :, t], v[:, :, t])
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, :, t], s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, :, t])[..., None] * s + kv
    return torch.stack(outs, 2), s


def wkv_chunked(r, k, v, logw, u, s0, *, chunk: int = CHUNK):
    """Chunk-parallel WKV in float32; shapes as in :func:`wkv_scan_ref`.

    The chunk is ``min(chunk, L)`` steps and must divide ``L`` (the
    reference asserts it): a sequence of up to ``chunk`` steps, or any
    multiple of ``chunk``, is admitted.  Returns ``o`` in ``r``'s dtype and
    the float32 state.

    The reference scans its chunk step over the chunks.  Here only the state
    entering each chunk is sequential (one decay and one add a chunk); each
    chunk's own terms are batched over all chunks, the pairwise decays a
    group of chunks at a time (``ELEMENT_BUDGET`` elements).  The sums are
    the reference's, in other orders."""
    b, h, l, d = r.shape
    c = min(chunk, l)
    if l % c:
        raise ValueError(f"wkv_chunked takes L <= {chunk} or a multiple of {chunk}, got L={l}")
    n = l // c

    def chunks(a):
        return a.float().reshape(b, h, n, c, d)

    rr, kk, vv, lw = map(chunks, (r, k, v, logw))
    lw_cum = torch.cumsum(lw, 3)  # inclusive cumulative log-decay within each chunk
    lw_ex = lw_cum - lw  # exclusive
    lw_tot = lw_cum[:, :, :, -1:]  # [b, h, n, 1, d]
    # what each chunk adds to the state it hands on, and how it decays what it got:
    # S' = diag(exp(lw_total)) S + sum_j exp(lw_total - lw_cum_j) k_j v_j^T
    added = torch.einsum("bhncd,bhnce->bhnde", kk * torch.exp(lw_tot - lw_cum), vv)
    decay = torch.exp(lw_tot[:, :, :, 0, :, None])  # [b, h, n, d, 1]
    starts = torch.empty((b, h, n, d, d), dtype=torch.float32, device=r.device)
    s = s0.float()
    for j in range(n):
        starts[:, :, j] = s
        s = decay[:, :, j] * s + added[:, :, j]
    # the state carried in: o_i += (r_i * exp(lw_ex_i)) S
    o = torch.einsum("bhncd,bhnde->bhnce", rr * torch.exp(lw_ex), starts)
    # within a chunk: A[i, j] = sum_d r[i, d] k[j, d] exp(lw_ex[i, d] - lw_cum[j, d]), j < i
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    g = max(1, ELEMENT_BUDGET // (b * h * c * c * d))
    for n0 in range(0, n, g):
        sl = slice(n0, n0 + g)
        diff = lw_ex[:, :, sl, :, None, :] - lw_cum[:, :, sl, None, :, :]  # [b, h, g, c, c, d]
        # masked before the exp: for j >= i the difference is positive and its
        # exp may overflow, and 0 * inf in the backward would be NaN
        dec = torch.exp(torch.where(lower[:, :, None], diff, float("-inf")))
        a = torch.einsum("bhnid,bhnijd,bhnjd->bhnij", rr[:, :, sl], dec, kk[:, :, sl])
        o[:, :, sl] += a @ vv[:, :, sl]
    bonus = torch.einsum("bhncd,hd->bhnc", rr * kk, u)  # the current token's bonus
    o = o + bonus[..., None] * vv
    return o.reshape(b, h, l, d).to(r.dtype), s


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """``[B, L, D]`` -> the previous token's features (``x_prev`` at position 0)."""
    first = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], 1)


def _mix(x: torch.Tensor, xx: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    return x + (xx - x) * torch.sigmoid(mix)


def rwkv_block(p: RwkvTime, x: torch.Tensor, cfg, *, state: Optional[dict] = None,
               dtype=torch.bfloat16):
    """The time-mix over a sequence ``x`` ``[B, L, D]`` (the block owns norms
    and residuals; the channel-mix is :func:`rwkv_channel_mix`).  Returns
    ``(out [B, L, D], new state or None)``; the new state carries the
    channel-mix's ``x_prev_c`` over unchanged."""
    hd = cfg.resolved_head_dim
    h = cfg.d_model // hd
    b, l, d = x.shape
    x_prev = state["x_prev_t"] if state is not None else None
    xx = _token_shift(x, x_prev)

    def proj(w: Dense, mix):
        return (_mix(x, xx, mix).to(dtype) @ w.w.to(dtype)).float()

    def heads(y):
        return y.reshape(b, l, h, hd).transpose(1, 2)

    r = heads(proj(p.wr, p.mix_r))
    k = heads(proj(p.wk, p.mix_k))
    v = heads(proj(p.wv, p.mix_v))
    g = proj(p.wg, p.mix_g)
    xw = _mix(x, xx, p.mix_w).float()
    lora = torch.tanh(xw @ p.w_lora_a.float()) @ p.w_lora_b.float()
    logw = heads(-torch.exp(p.w_base.float() + lora))  # < 0

    s0 = state["wkv"] if state is not None else torch.zeros((b, h, hd, hd), device=x.device)
    o, s_l = wkv_chunked(r, k, v, logw, p.u_bonus.float(), s0)
    oh = o.transpose(1, 2)  # [b, l, h, hd]: a group norm per head
    var, mean = torch.var_mean(oh, -1, keepdim=True, unbiased=False)
    o = ((oh - mean) * torch.rsqrt(var + 1e-5)).reshape(b, l, d) * p.ln_x
    o = o.to(dtype) * F.silu(g.to(dtype))
    out = o @ p.wo.w.to(dtype)
    new_state = None
    if state is not None:
        new_state = {"wkv": s_l, "x_prev_t": x[:, -1].float(), "x_prev_c": state["x_prev_c"]}
    return out, new_state


def rwkv_channel_mix(p: RwkvChannel, x: torch.Tensor, *, state: Optional[dict] = None,
                     dtype=torch.bfloat16):
    """Squared-ReLU channel-mix of ``x`` ``[B, L, D]``; returns ``(out, new
    state or None)``."""
    x_prev = state["x_prev_c"] if state is not None else None
    xk = _mix(x, _token_shift(x, x_prev), p.mix_k).to(dtype)
    hidden = torch.square(torch.relu(xk @ p.wk.w.to(dtype)))
    out = hidden @ p.wv.w.to(dtype)
    new_state = None
    if state is not None:
        new_state = dict(state, x_prev_c=x[:, -1].float())
    return out, new_state


def _whole_prev(x_prev: Optional[torch.Tensor], rs: MeshShard) -> Optional[torch.Tensor]:
    """A state's last token ``[B, D]`` from every rank's channels."""
    if x_prev is None or rs.model.size == 1:
        return x_prev
    return torch.cat(list(rs.model.all_gather(x_prev.contiguous()).unbind(0)), -1)


def _own_cols(x: torch.Tensor, rs: MeshShard) -> torch.Tensor:
    cols = x.shape[-1] // rs.model.size
    return x[..., rs.model.rank * cols : (rs.model.rank + 1) * cols]


def rwkv_block_tp(p: RwkvTime, x: torch.Tensor, cfg, rs: MeshShard, *,
                  state: Optional[dict] = None, dtype=torch.bfloat16):
    """:func:`rwkv_block` as one rank of the mesh (see the module
    docstring): ``p`` holds the rank's weights, ``x`` is the stream, the
    output the rank's part of it (``MeshShard.leave``) and the state the
    rank's block."""
    hd = cfg.resolved_head_dim
    heads = cfg.d_model // hd
    pm = rs.model.size
    xe = rs.enter(x)
    b, l, d = xe.shape
    xx = _token_shift(xe, None if state is None else _whole_prev(state["x_prev_t"], rs))

    def proj(w: Dense, mix):
        return rs.column(w, _mix(xe, xx, rs.rep(mix)), dtype).float()

    r, k, v, g = (proj(w, mix) for w, mix in ((p.wr, p.mix_r), (p.wk, p.mix_k),
                                               (p.wv, p.mix_v), (p.wg, p.mix_g)))
    xw = _mix(xe, xx, rs.rep(p.mix_w)).float()
    lora = torch.tanh(xw @ rs.rep(p.w_lora_a).float())
    base, lora_b = rs.rep(p.w_base).float(), rs.rep(p.w_lora_b).float()
    u, ln_x = rs.rep(p.u_bonus).float(), rs.rep(p.ln_x)
    own = heads % pm == 0
    if own:  # this rank's H / model whole heads
        hh = heads // pm
        base, lora_b, ln_x = _own_cols(base, rs), _own_cols(lora_b, rs), _own_cols(ln_x, rs)
        u = u[rs.model.rank * hh : (rs.model.rank + 1) * hh]
    else:  # every head on every rank
        hh = heads
        r, k, v, g = (all_gather_cat(t, rs.model, -1) for t in (r, k, v, g))

    def split_heads(y):
        return y.reshape(b, l, hh, hd).transpose(1, 2)

    logw = split_heads(-torch.exp(base + lora @ lora_b))
    s0 = (state["wkv"] if state is not None
          else torch.zeros((b, hh, hd, hd), device=x.device))
    o, s_l = wkv_chunked(split_heads(r), split_heads(k), split_heads(v), logw, u, s0)
    oh = o.transpose(1, 2)
    var, mean = torch.var_mean(oh, -1, keepdim=True, unbiased=False)
    o = ((oh - mean) * torch.rsqrt(var + 1e-5)).reshape(b, l, hh * hd) * ln_x
    o = o.to(dtype) * F.silu(g.to(dtype))
    if not own:
        o = _own_cols(o, rs)
    out = rs.row(p.wo.w, o, dtype)
    new_state = None
    if state is not None:
        new_state = {"wkv": s_l, "x_prev_t": _own_cols(xe[:, -1], rs).float(),
                     "x_prev_c": state["x_prev_c"]}
    return out, new_state


def rwkv_channel_mix_tp(p: RwkvChannel, x: torch.Tensor, rs: MeshShard, *,
                        state: Optional[dict] = None, dtype=torch.bfloat16):
    """:func:`rwkv_channel_mix` as one rank of the mesh: ``wk``
    column-parallel, ``wv`` row-parallel."""
    xe = rs.enter(x)
    x_prev = None if state is None else _whole_prev(state["x_prev_c"], rs)
    xk = _mix(xe, _token_shift(xe, x_prev), rs.rep(p.mix_k)).to(dtype)
    hidden = torch.square(torch.relu(rs.column(p.wk, xk, dtype)))
    out = rs.row(p.wv.w, hidden, dtype)
    new_state = None
    if state is not None:
        new_state = dict(state, x_prev_c=_own_cols(xe[:, -1], rs).float())
    return out, new_state


def rwkv_decode(p: RwkvTime, x_t: torch.Tensor, cfg, state: dict, *, dtype=torch.bfloat16):
    """The time-mix of one token ``x_t`` ``[B, D]``: ``(out [B, D], new state)``."""
    out, new_state = rwkv_block(p, x_t[:, None, :], cfg, state=state, dtype=dtype)
    return out[:, 0], new_state
