"""Mixture-of-Experts FFN: the dense capacity path and the distributed layer
over the port's ``comm.Group``.

Counterpart of ``repro/models/moe.py``.

``moe_block`` (one device; the oracle of the distributed layer)
    Top-k routing on float32 router probabilities, renormalised; each
    token's position in its expert by a stable sort; one scatter into an
    ``[E, C, D]`` buffer, tokens past an expert's capacity ``C`` dropped;
    batched expert GEMMs; the weighted combine.  Returns the output and the
    load-balancing aux loss.

``moe_block_manual`` (one rank of a model-axis group)
    The reference's three branches, with the reference's collectives on the
    port's transport:

    * ``moe_sharding == "tp"`` (mixtral): the expert hidden dim is split
      over the group; tokens stay replicated and the partial outputs are
      summed with ``all_reduce_sum`` in float32;
    * a token count not divisible by the group (decode) falls back to
      replicated-token EP: every rank runs its experts on every token and
      the partial combines are summed;
    * token-sharded EP (phi3.5): each rank routes its slice of the tokens
      into per-expert chunks and exchanges them with the experts' owners,
      in one ``all_to_all`` or in the paper's pipelined Adaptive-Group
      exchange (``grouped_exchange``), whose consume runs the expert FFN of
      each arriving chunk while the later chunks are still in flight
      (Algorithm 3).  Results return on a second ``all_to_all`` and the
      token outputs are gathered back over the group.

    A rank holds its own slice of the expert weights
    (:func:`shard_expert_weights`, the reference's ``in_specs``); under
    FSDP they are split over the data axis too and gathered at entry (the
    reference's ZeRO-3 unshard).  Autograd differentiates the layer, so a
    mesh trains through it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import (
    DifferentiableGroup,
    Group,
    all_gather_cat,
    copy_to,
    gather_replicated,
    grouped_exchange,
    reduce_from,
)
from .layers import Initializer, weight

__all__ = ["MoE", "moe_init", "moe_block", "moe_block_manual", "shard_expert_weights"]


class MoE(nn.Module):
    """``router`` ``[d, E]``; ``w_gate``, ``w_up`` ``[E, d, f]``; ``w_down`` ``[E, f, d]``."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.router = weight(router)
        self.w_gate = weight(w_gate)
        self.w_up = weight(w_up)
        self.w_down = weight(w_down)


def moe_init(init: Initializer, cfg) -> MoE:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return MoE(router=init.normal((d, e), scale=d ** -0.5),
               w_gate=init.normal((e, d, f), scale=d ** -0.5),
               w_up=init.normal((e, d, f), scale=d ** -0.5),
               w_down=init.normal((e, f, d), scale=f ** -0.5))


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """``(top_w [T, k] float32 renormalised, top_e [T, k] int64, aux loss)``."""
    t = xt.shape[0]
    e = router.shape[1]
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    assign = torch.zeros((t, e), dtype=torch.float32, device=xt.device)
    assign.scatter_(1, top_e, 1.0)
    aux = e * (assign.mean(0) * probs.mean(0)).sum()
    return top_w, top_e, aux


def _dispatch(xt: torch.Tensor, top_e: torch.Tensor, capacity: int, num_experts: int, dtype):
    """Scatter tokens into ``[E, C, D]``; returns ``(buf, e_flat, pos_c, keep)``.

    Slot ``i`` of ``e_flat`` is token ``i // k``'s ``i % k``-th choice; its
    position in its expert counts the slots before it (in that order) that
    chose the same expert.  Slots at or past ``capacity`` are dropped (kept
    out of the buffer and, in the combine, out of the output)."""
    t, d = xt.shape
    k = top_e.shape[1]
    e_flat = top_e.reshape(-1)
    sorted_e, order = torch.sort(e_flat, stable=True)
    # bincount, as a scatter: the same counts, and a shape the meta device knows
    counts = torch.zeros(num_experts, dtype=torch.int64, device=xt.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = pos < capacity
    pos_c = pos.clamp(max=capacity - 1)
    payload = torch.where(keep[:, None], xt.repeat_interleave(k, 0).to(dtype), 0)
    buf = torch.zeros((num_experts, capacity, d), dtype=dtype, device=xt.device)
    buf.index_put_((e_flat, pos_c), payload, accumulate=True)
    return buf, e_flat, pos_c, keep


def _combine(out_buf: torch.Tensor, e_flat, pos_c, keep, top_w: torch.Tensor, dtype):
    """Each token's kept slots, weighted and summed: ``[T, D]``."""
    t, k = top_w.shape
    slot_out = torch.where(keep[:, None], out_buf[e_flat, pos_c], 0)
    w = top_w.reshape(-1).to(dtype)
    return (slot_out * w[:, None]).reshape(t, k, -1).sum(1)


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor):
    """``buf`` ``[E, C, D]`` through each expert's SwiGLU: ``[E, C, D_out]``."""
    return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)


def _capacity(cfg, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


# ---------------------------------------------------------------------------
# Dense path (the oracle; one device)
# ---------------------------------------------------------------------------


def moe_block(p: MoE, x: torch.Tensor, cfg, *, dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``[B, L, D]`` through the experts; returns ``(out [B, L, D], aux)``."""
    b, l, d = x.shape
    t = b * l
    xt = x.reshape(t, d)
    top_w, top_e, aux = _route(xt, p.router, cfg.experts_per_token)
    buf, e_flat, pos_c, keep = _dispatch(xt, top_e, _capacity(cfg, t), cfg.num_experts, dtype)
    out_buf = _expert_ffn(buf, p.w_gate.to(dtype), p.w_up.to(dtype), p.w_down.to(dtype))
    return _combine(out_buf, e_flat, pos_c, keep, top_w, dtype).reshape(b, l, d), aux


# ---------------------------------------------------------------------------
# Distributed layer (one rank of the model-axis group)
# ---------------------------------------------------------------------------


def shard_expert_weights(p: MoE, cfg, rank: int, size: int) -> MoE:
    """Rank ``rank``'s slice of the expert weights over a model group of
    ``size`` ranks, as the reference's ``in_specs`` place them: the router
    whole; under ``"ep"`` experts ``[E/P r, E/P (r+1))``; under ``"tp"`` the
    hidden columns ``[f/P r, f/P (r+1))`` of ``w_gate`` and ``w_up`` and the
    same rows of ``w_down``.  The slices are views of ``p``'s weights."""
    if cfg.moe_sharding == "ep":
        e = cfg.num_experts
        if e % size:
            raise ValueError(f"{e} experts do not split over {size} ranks")
        sl = slice(rank * (e // size), (rank + 1) * (e // size))
        return MoE(p.router, p.w_gate[sl], p.w_up[sl], p.w_down[sl])
    f = p.w_gate.shape[2]
    if f % size:
        raise ValueError(f"d_ff {f} does not split over {size} ranks")
    sl = slice(rank * (f // size), (rank + 1) * (f // size))
    return MoE(p.router, p.w_gate[:, :, sl], p.w_up[:, :, sl], p.w_down[:, sl])


def _mean(x: torch.Tensor, *groups: Optional[Group]) -> torch.Tensor:
    for g in groups:
        if g is not None and g.size > 1:
            x = reduce_from(x, g) / g.size
    return x


def moe_block_manual(
    p: MoE,
    x: torch.Tensor,  # [B_loc, L, D], the same on every rank of ``group``
    cfg,
    *,
    group: Group,
    data_group: Optional[Group] = None,
    dp_groups: Optional[Sequence[Group]] = None,
    pipeline: bool = False,
    group_factor: int = 1,
    fsdp: bool = False,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank of the reference's distributed MoE layer.

    ``p`` holds this rank's weights (:func:`shard_expert_weights`; under
    ``fsdp`` also split over ``data_group`` as the specs say: ``router``
    dimension 0, ``w_gate`` and ``w_up`` 1, ``w_down`` 2, gathered here, the
    reference's ZeRO-3 unshard); ``group`` is the model axis, ``data_group``
    (optional) the data axis, and ``dp_groups`` the batch axes' groups over
    which the aux loss is averaged (``data_group`` alone without them).
    ``pipeline`` runs the token-sharded EP exchange as ``grouped_exchange``
    with ``group_factor`` shifts in flight; otherwise one ``all_to_all``.
    Returns ``(out [B_loc, L, D], aux)``, the output the same on every rank
    of ``group``.

    Autograd differentiates it (the collectives are
    :mod:`~repro_torch.comm.differentiable`'s): where every rank routes
    every token (TP, and the replicated-token fallback) the routing's
    gradient is whole on each rank and the experts' partial gradients of
    the tokens and of the routing weights are summed over ``group``; where
    each rank routes its own tokens, the gradients of the input and of the
    router are.
    """
    router, wg, wu, wd = p.router, p.w_gate, p.w_up, p.w_down
    if fsdp:
        if data_group is None:
            raise ValueError("the FSDP unshard gathers over data_group; none given")
        router, wg, wu, wd = (all_gather_cat(w, data_group, dim)
                              for w, dim in ((router, 0), (wg, 1), (wu, 1), (wd, 2)))
    dp = (data_group,) if dp_groups is None else tuple(dp_groups)
    pm, m = group.size, group.rank
    dgroup = DifferentiableGroup(group)
    b, l, d = x.shape
    t = b * l
    xt = x.reshape(t, d)
    wg, wu, wd = wg.to(dtype), wu.to(dtype), wd.to(dtype)
    k, e = cfg.experts_per_token, cfg.num_experts

    if cfg.moe_sharding != "ep" or t % pm:
        # every rank routes every token; TP experts: f split over the group,
        # the partial outputs summed; replicated-token EP (decode-sized
        # batches): this rank's experts on every token, the other experts'
        # slots zero and the sum fills them
        top_w, top_e, aux = _route(xt, router, k)
        buf, e_flat, pos_c, keep = _dispatch(copy_to(xt, group), top_e, _capacity(cfg, t), e,
                                             dtype)
        if cfg.moe_sharding != "ep":
            out_buf = _expert_ffn(buf, wg, wu, wd)
        else:
            e_loc = e // pm
            out_buf = torch.zeros_like(buf)
            out_buf[m * e_loc : (m + 1) * e_loc] = _expert_ffn(buf[m * e_loc : (m + 1) * e_loc],
                                                               wg, wu, wd)
        combined = _combine(out_buf, e_flat, pos_c, keep, copy_to(top_w, group), dtype)
        combined = reduce_from(combined.float(), group).to(dtype)
        return combined.reshape(b, l, d), _mean(aux, *dp)

    # token-sharded EP: the paper's exchange, one chunk per rank
    e_loc = e // pm  # this rank's experts
    tm = t // pm
    xt_m = copy_to(xt, group)[m * tm : (m + 1) * tm]
    top_w, top_e, aux = _route(xt_m, copy_to(router, group), k)
    cap = _capacity(cfg, tm)
    buf, e_flat, pos_c, keep = _dispatch(xt_m, top_e, cap, e, dtype)
    chunks = buf.reshape(pm, e_loc, cap, d)  # chunk q: rank q's experts
    if pipeline:
        def consume(acc, chunk, src):
            acc[src] = _expert_ffn(chunk, wg, wu, wd)
            return acc

        out_chunks = grouped_exchange(dgroup, chunks, consume,
                                      torch.zeros_like(chunks), group_factor=group_factor)
    else:
        recv = dgroup.all_to_all(chunks)  # recv[q]: rank q's tokens for this rank's experts
        out = _expert_ffn(recv.transpose(0, 1).reshape(e_loc, pm * cap, d), wg, wu, wd)
        out_chunks = out.reshape(e_loc, pm, cap, d).transpose(0, 1).contiguous()
    back = dgroup.all_to_all(out_chunks)  # back[q]: rank q's experts on this rank's tokens
    combined = _combine(back.reshape(e, cap, d), e_flat, pos_c, keep, top_w, dtype)
    full = gather_replicated(combined, group).reshape(t, d)
    return full.reshape(b, l, d), _mean(aux, *dp, group)
