"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.  Temporal mix: two input
projections (one GeLU-gated), a causal depthwise conv of width 4, then the
Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(L) * r_t)     (data-dependent per-channel decay)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence is a log-depth scan over the sequence (:func:`_lru_scan`:
``ceil(log2 L)`` doubling steps, where the reference runs
``jax.lax.associative_scan``); decode is the same block on one token.  All
plain torch, as the reference's is XLA.

On a ``data x model`` mesh (:func:`rglru_block_tp`) ``w_in`` and
``w_gate`` are column-parallel, the conv, ``lambda_raw`` and the gates'
biases split over channels, ``w_out`` row-parallel.  The gates ``lru_a``
and ``lru_x`` read every channel of the post-conv ``u``: a rank all-gathers
``u`` before them, and they come out on its own channels (column-parallel),
where the scan runs alone.  The states ``h`` ``[B, D / model]`` and
``conv`` ``[B, 3, D / model]`` are the rank's channels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import all_gather_cat
from .layers import Dense, Initializer, MeshShard, dense_init, weight

__all__ = ["RgLru", "rglru_init", "init_rglru_state", "rglru_block", "rglru_block_tp",
           "rglru_decode"]

_C = 8.0  # Griffin's recurrence sharpness constant
CONV_WIDTH = 4


class RgLru(nn.Module):
    """``w_in``, ``w_gate``, ``w_out`` ``[d, d]``; the conv's ``conv_w``
    ``[4, d]`` and ``conv_b`` ``[d]``; the gates ``lru_a``, ``lru_x`` (with
    biases); ``lambda_raw`` ``[d]``."""

    def __init__(self, w_in: Dense, w_gate: Dense, conv_w, conv_b, lru_a: Dense, lru_x: Dense,
                 lambda_raw, w_out: Dense):
        super().__init__()
        self.w_in, self.w_gate, self.lru_a, self.lru_x, self.w_out = (
            w_in, w_gate, lru_a, lru_x, w_out)
        self.conv_w = weight(conv_w)
        self.conv_b = weight(conv_b)
        self.lambda_raw = weight(lambda_raw)


def rglru_init(init: Initializer, cfg) -> RgLru:
    d = cfg.d_model
    return RgLru(w_in=dense_init(init, d, d), w_gate=dense_init(init, d, d),
                 conv_w=init.normal((CONV_WIDTH, d), 0.1), conv_b=init.zeros((d,)),
                 lru_a=dense_init(init, d, d, bias=True), lru_x=dense_init(init, d, d, bias=True),
                 lambda_raw=init.normal((d,), 0.5), w_out=dense_init(init, d, d))


def init_rglru_state(batch: int, d_model: int, *, device: torch.device) -> dict:
    """Zero state: ``h`` ``[B, d]`` and the last 3 pre-conv inputs ``conv``
    ``[B, 3, d]``, float32."""
    return {"h": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, d_model), dtype=torch.float32,
                                device=device)}


def _conv_causal(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 state_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width 4 over ``x`` ``[B, L, D]``; the 3 inputs
    before position 0 are ``state_tail`` (zeros without one)."""
    bsz, l, d = x.shape
    tail = (torch.zeros((bsz, CONV_WIDTH - 1, d), dtype=x.dtype, device=x.device)
            if state_tail is None else state_tail.to(x.dtype))
    xp = torch.cat([tail, x], 1)  # [B, L + 3, D]
    out = xp[:, 0:l] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + xp[:, i : i + l] * w[i]
    return out + b


def _lru_scan(a: torch.Tensor, bx: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + bx_t`` over ``[B, L, D]`` (``h_{-1} = h0``, or 0).

    Hillis-Steele doubling: after the step of offset ``s`` each position
    holds the composition of the (up to) ``2 s`` steps ending there, as the
    reference's ``associative_scan`` composes ``(a_l, b_l), (a_r, b_r) ->
    (a_l a_r, b_r + a_r b_l)``; ``ceil(log2 L)`` steps in all."""
    l = a.shape[1]
    s = 1
    while s < l:
        a, bx = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1),
                 torch.cat([bx[:, :s], bx[:, s:] + a[:, s:] * bx[:, :-s]], 1))
        s *= 2
    if h0 is not None:
        bx = bx + a * h0[:, None, :]
    return bx


def rglru_block(p: RgLru, x: torch.Tensor, cfg, *, state: Optional[dict] = None,
                dtype=torch.bfloat16):
    """The temporal mix over ``x`` ``[B, L, D]``; returns ``(out, new state or
    None)``.  The new state holds ``h`` at the last position and the last 3
    pre-conv inputs (any ``L``, decode's 1 included)."""
    xb = x.to(dtype)
    gate = F.gelu(xb @ p.w_gate.w.to(dtype), approximate="tanh")  # jax.nn.gelu's default
    u_pre = xb @ p.w_in.w.to(dtype)  # pre-conv: what the conv state keeps
    u = _conv_causal(p.conv_w.to(dtype), p.conv_b.to(dtype), u_pre,
                     None if state is None else state["conv"])
    uf = u.float()
    r = torch.sigmoid(uf @ p.lru_a.w.float() + p.lru_a.b)
    i = torch.sigmoid(uf @ p.lru_x.w.float() + p.lru_x.b)
    a = torch.exp(-_C * F.softplus(p.lambda_raw.float()) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    h = _lru_scan(a, bx, None if state is None else state["h"])
    out = (h.to(dtype) * gate) @ p.w_out.w.to(dtype)
    new_state = None
    if state is not None:
        new_state = {"h": h[:, -1].float(),
                     "conv": torch.cat([state["conv"], u_pre.float()], 1)[:, -(CONV_WIDTH - 1):]}
    return out, new_state


def rglru_block_tp(p: RgLru, x: torch.Tensor, cfg, rs: MeshShard, *,
                   state: Optional[dict] = None, dtype=torch.bfloat16):
    """:func:`rglru_block` as one rank of the mesh (see the module
    docstring): ``p`` holds the rank's weights, ``x`` is the stream, the
    output the rank's part of it and the state the rank's channels."""
    xb = rs.enter(x).to(dtype)
    gate = F.gelu(rs.column(p.w_gate, xb, dtype), approximate="tanh")
    u_pre = rs.column(p.w_in, xb, dtype)
    u = _conv_causal(p.conv_w.to(dtype), p.conv_b.to(dtype), u_pre,
                     None if state is None else state["conv"])
    uf = u.float()
    u_all = all_gather_cat(uf, rs.model, -1)  # every channel, for the gates
    r = torch.sigmoid(rs.column(p.lru_a, u_all, torch.float32))
    i = torch.sigmoid(rs.column(p.lru_x, u_all, torch.float32))
    a = torch.exp(-_C * F.softplus(p.lambda_raw.float()) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    h = _lru_scan(a, bx, None if state is None else state["h"])
    out = rs.row(p.w_out.w, h.to(dtype) * gate, dtype)
    new_state = None
    if state is not None:
        new_state = {"h": h[:, -1].float(),
                     "conv": torch.cat([state["conv"], u_pre.float()], 1)[:, -(CONV_WIDTH - 1):]}
    return out, new_state


def rglru_decode(p: RgLru, x_t: torch.Tensor, cfg, state: dict, *, dtype=torch.bfloat16):
    """One token ``x_t`` ``[B, D]``: ``(out [B, D], new state)``."""
    out, new_state = rglru_block(p, x_t[:, None, :], cfg, state=state, dtype=dtype)
    return out[:, 0], new_state
