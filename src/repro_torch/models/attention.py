"""Attention with GQA: self-attention (causal, sliding-window or
bidirectional) through the flash kernel, cross-attention through the
chunked path, a circular KV cache (bf16, as the reference's), and decode
over it.

Counterparts of ``repro/models/attention.py``.  Served self-attention
(``Lq == Lk``) goes through ``ops.flash_attention``: the hand-written CUDA
kernel for a CUDA tensor, its plain version for a CPU tensor.  Under
autograd (training) it goes through :func:`chunked_attention` instead, as
the reference trains through its XLA path: neither flash kernel has a
backward.  Cross-attention goes through
:func:`chunked_attention`, plain torch, as the reference's is XLA (it never
routes cross-attention through Pallas).  Decode is plain torch over the
cache, as it is XLA code in the reference.

On a ``data x model`` mesh, :func:`attention_block_tp` is one rank's
block: ``wq``, ``wk``, ``wv`` column-parallel, ``wo`` row-parallel.  The
specs split output columns, not heads, so a rank's columns may cut a head
(smollm-360m at ``model = 2``: 7.5 of 15 heads).  Where the heads and the
KV heads both divide the model axis, each rank attends on its own heads
with their whole GQA groups (the flash kernel on the rank's heads, when
serving).  With ``attn_anchor`` (``MeshShard.anchor``), where the heads
divide the axis and the KV heads do not (recurrentgemma-2b: 10 heads, 1
KV head), each rank all-gathers k and v and attends its own q heads over
the KV heads they read (the reference's ``attn_repeat_kv``: each KV head
once where the rank's q heads share it in whole groups, else repeated to
one a q head).  Otherwise every rank all-gathers q, k and v, attends on
all heads and keeps its own output columns for ``wo``.  The gather is the
simpler of the two reshards the cut allows (an all-to-all to whole heads
is the other): it costs ``model`` times the attention's compute, and its
gradient is a reduce-scatter.  The KV cache is sharded over the sequence
(``cache_pspecs``): ``k``, ``v`` ``[B, Hkv, ceil(S/model), hd]`` a rank,
the last blocks padded and masked where ``S`` does not divide the axis,
and ``slot_pos`` whole on every rank.  Decode combines each rank's partial
softmax over its slots (the flash-decoding combine); an anchored decode
takes the cut-head path.  :func:`cross_attention_tp` is the cross-attention
of a rank: heads as above through :func:`chunked_attention`, the context
replicated over the model axis and its keys and values whole in the cache
(``xk``, ``xv``, gathered at prefill).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..comm import all_gather_cat, copy_to
from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import NEG
from .layers import Dense, Initializer, MeshShard, dense_apply, dense_init, rope

__all__ = [
    "Attention",
    "attn_init",
    "attention_block",
    "attention_block_tp",
    "cross_attention_tp",
    "init_kv_cache_tp",
    "chunked_attention",
    "decode_attention",
    "init_kv_cache",
]

#: the reference stores every KV cache in bf16, whatever the compute dtype;
#: the port's default, which ``cache_dtype`` may override
CACHE_DTYPE = torch.bfloat16


class Attention(nn.Module):
    """The four projections, ``[d_in, d_out]`` each (biases for QKV-bias rows)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def attn_init(init: Initializer, cfg) -> Attention:
    """The four projections, for self- and cross-attention alike: a
    cross-attention's keys and values project the context, of width
    ``d_model`` too."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return Attention(
        wq=dense_init(init, d, h * hd, bias=cfg.attn_bias),
        wk=dense_init(init, d, kv * hd, bias=cfg.attn_bias),
        wv=dense_init(init, d, kv * hd, bias=cfg.attn_bias),
        wo=dense_init(init, h * hd, d),
    )


def _project(p: Dense, x: torch.Tensor, heads: int, hd: int, dtype) -> torch.Tensor:
    y = dense_apply(p, x, dtype)
    b, l, _ = y.shape
    return y.reshape(b, l, heads, hd).transpose(1, 2)  # [B, H, L, D]


def _kv_step(q32, kc, vc, acc, m, l, qpos, k0: int, lk: int, causal: bool, window: int):
    """One KV chunk of the online softmax: ``(acc, m, l)`` after it."""
    kc, vc = kc.float(), vc.float()
    logits = torch.einsum("bkgqd,bkcd->bkgqc", q32, kc)
    kpos = k0 + torch.arange(kc.shape[2], device=q32.device)[None, :]
    mask = kpos < lk
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask, logits, NEG)
    m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
    # masked logits are NEG, so logits - m_new <= 0 and the exp stays finite
    p = torch.where(mask, torch.exp(logits - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgqc,bkcd->bkgqd", p, vc)
    return acc, m_new, l


def chunked_attention(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, Hkv, Lk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style online-softmax attention in plain torch, chunk by chunk.

    The reference's XLA path: queries in chunks of ``q_chunk`` against keys
    in chunks of ``kv_chunk``, ragged lengths padded to whole chunks (padded
    keys masked, padded query rows dropped), queries aligned to the end of
    the real keys (``qpos = i + Lk - Lq``), a float32 online softmax with the
    finite ``-1e30`` mask and probabilities zeroed where masked, and a zero
    denominator read as 1 (a fully masked row gives 0).  Returns ``[B, H,
    Lq, D]`` in ``q``'s dtype.

    Under autograd each KV step runs under ``torch.utils.checkpoint``, as
    the reference wraps it in ``jax.checkpoint``: the backward recomputes
    a step's ``[.., q_chunk, kv_chunk]`` logits from the running ``(acc, m,
    l)``, so the saved residuals stay O(L), not O(L^2).
    """
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = h // hkv
    q_chunk, kv_chunk = min(q_chunk, lq), min(kv_chunk, lk)
    nq, nk = -(-lq // q_chunk), -(-lk // kv_chunk)
    scale = d ** -0.5
    offset = lk - lq
    dev = q.device
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    qg = q.reshape(b, hkv, g, lq, d)
    outs = []
    for iq in range(nq):
        q0 = iq * q_chunk
        q32 = qg[:, :, :, q0 : q0 + q_chunk].float() * scale
        rows = q32.shape[3]
        # padded query rows of the last chunk have no row here: their
        # positions only ever widen the mask of rows that are dropped
        qpos = offset + q0 + torch.arange(rows, device=dev)[:, None]
        acc = torch.zeros((b, hkv, g, rows, d), dtype=torch.float32, device=dev)
        m = torch.full((b, hkv, g, rows, 1), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, rows, 1), dtype=torch.float32, device=dev)
        for ik in range(nk):
            k0 = ik * kv_chunk
            args = (q32, k[:, :, k0 : k0 + kv_chunk], v[:, :, k0 : k0 + kv_chunk], acc, m, l,
                    qpos, k0, lk, causal, window)
            if grad:
                acc, m, l = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                acc, m, l = _kv_step(*args)
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l).to(q.dtype))
    return torch.cat(outs, 3).reshape(b, h, lq, d)


def decode_attention(
    q: torch.Tensor,  # [B, H, 1, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    slot_pos: torch.Tensor,  # [S] absolute position in each slot (-1 empty)
    pos: int,
    *,
    window: int = 0,
) -> torch.Tensor:
    """One query token over the cache, in float32 (plain torch)."""
    b, h, _, d = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float() * (d ** -0.5)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    mask = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        mask &= slot_pos > pos - window
    p = torch.softmax(torch.where(mask, logits, NEG), dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def init_kv_cache(batch: int, kv_heads: int, length: int, head_dim: int,
                  dtype: torch.dtype = CACHE_DTYPE, *,
                  device: Optional[Union[str, torch.device]] = None) -> dict:
    """Circular KV cache; ``slot_pos`` holds the absolute position in each
    slot (-1 where empty), and position ``p`` lives in slot ``p % length``.
    On ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    if device is None or torch.device(device).type != "meta":  # meta: the dry-run's shapes
        device = resolve_device(device)
    return {
        "k": torch.zeros((batch, kv_heads, length, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, kv_heads, length, head_dim), dtype=dtype, device=device),
        "slot_pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def attention_block(
    p: Attention,
    x: torch.Tensor,  # [B, L, D_model]
    cfg,
    *,
    causal: bool = True,
    window: int = 0,
    context: Optional[torch.Tensor] = None,  # cross-attention context [B, Lc, D_model]
    cache: Optional[dict] = None,
    pos: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,  # rope positions [L]
    dtype=torch.bfloat16,
    build_cache_len: Optional[int] = None,
    cache_dtype: torch.dtype = CACHE_DTYPE,
    attn_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One attention mix (the block owns norm and residual).

    With ``context`` the tokens attend to it (cross-attention): keys and
    values project the context, nothing is roped, and the path is
    :func:`chunked_attention` without a mask, as in the reference.
    Otherwise, without ``cache``, the tokens attend to each other through
    ``ops.flash_attention`` (``causal``, ``window``), or, where autograd
    needs a backward (``q``, ``k`` or ``v`` requires a gradient; training),
    through :func:`chunked_attention` in ``attn_chunk`` tiles (the
    reference's ``ShardingConfig.attn_chunk``); with
    ``build_cache_len`` a cache of that many slots is built from their keys
    and values, stored in ``cache_dtype`` (prefill).  With ``cache``
    (decode, one token at position ``pos``), the token's key and value are
    written at slot ``pos % S`` **in place**, in the cache's dtype, and the
    token attends over the cache.  Queries and keys are roped at
    ``positions`` where given (``[L]``), else at ``0 .. L-1`` (at ``pos`` in
    decode).  Returns ``(out [B, L, D_model], cache or None)``.
    """
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    b, l, _ = x.shape
    q = _project(p.wq, x, h, hd, dtype)
    kv_src = x if context is None else context
    k = _project(p.wk, kv_src, kv, hd, dtype)
    v = _project(p.wv, kv_src, kv, hd, dtype)
    if context is not None:
        out = chunked_attention(q, k, v, causal=False, window=0)
        out = out.transpose(1, 2).reshape(b, l, h * hd)
        return out @ p.wo.w.to(dtype), None
    if positions is None:
        positions = (torch.arange(l, device=x.device) if cache is None
                     else torch.full((l,), pos, device=x.device))
    q = rope(q, positions, cfg.rope_theta)
    # keys are roped at their absolute position, so a circular cache stays
    # right after it wraps
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        s_buf = cache["k"].shape[2]
        slot = pos % s_buf
        cache["k"][:, :, slot : slot + 1] = k.to(cache["k"].dtype)
        cache["v"][:, :, slot : slot + 1] = v.to(cache["v"].dtype)
        cache["slot_pos"][slot] = pos
        new_cache = cache
        out = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"], pos, window=window)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = chunked_attention(q, k, v, causal=causal, window=window, q_chunk=attn_chunk,
                                kv_chunk=attn_chunk)
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)
    if cache is None and build_cache_len is not None:
        s_buf = build_cache_len
        keep = min(l, s_buf)
        new_cache = init_kv_cache(b, kv, s_buf, hd, device=x.device, dtype=cache_dtype)
        # the last `keep` positions (a windowed cache may be shorter than the
        # prompt), at slots absolute position % s_buf
        abs_pos = torch.arange(l - keep, l, device=x.device)
        slots = abs_pos % s_buf
        new_cache["k"][:, :, slots] = k[:, :, l - keep :].to(cache_dtype)
        new_cache["v"][:, :, slots] = v[:, :, l - keep :].to(cache_dtype)
        new_cache["slot_pos"][slots] = abs_pos.to(torch.int32)

    out = out.transpose(1, 2).reshape(b, l, h * hd)
    return out @ p.wo.w.to(dtype), new_cache


# ---------------------------------------------------------------------------
# one rank of a data x model mesh
# ---------------------------------------------------------------------------


def _whole_heads(cfg, pm: int) -> bool:
    """Whether each of ``pm`` model ranks' columns are whole heads with their
    whole KV groups."""
    return cfg.num_heads % pm == 0 and cfg.num_kv_heads % pm == 0


def _slot_block(s_buf: int, pm: int) -> int:
    """Slots of the sequence-sharded cache a rank holds: ``ceil(S / pm)``."""
    return -(-s_buf // pm)


def init_kv_cache_tp(batch: int, kv_heads: int, s_buf: int, head_dim: int, pm: int, *,
                     device: torch.device, dtype: torch.dtype = CACHE_DTYPE) -> dict:
    """One rank's empty cache of ``s_buf`` slots sharded over ``pm`` model
    ranks: ``k``, ``v`` ``[batch, kv_heads, ceil(s_buf / pm), head_dim]``,
    ``slot_pos`` ``[s_buf]`` whole (-1 where empty)."""
    return {
        "k": torch.zeros((batch, kv_heads, _slot_block(s_buf, pm), head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, kv_heads, _slot_block(s_buf, pm), head_dim), dtype=dtype,
                         device=device),
        "slot_pos": torch.full((s_buf,), -1, dtype=torch.int32, device=device),
    }


def _own_slot_pos(slot_pos: torch.Tensor, m: int, blk: int) -> torch.Tensor:
    """Rank ``m``'s block of ``slot_pos``, padded with -1 (never attended)."""
    own = slot_pos[m * blk : (m + 1) * blk]
    if own.shape[0] < blk:
        own = torch.cat([own, own.new_full((blk - own.shape[0],), -1)])
    return own


def _decode_partial(q, k_cache, v_cache, slot_pos, pos: int, window: int):
    """One query token over this rank's slots, float32: ``(max [B, H, 1],
    sum [B, H, 1], unnormalised output [B, H, D])`` of the online softmax."""
    b, h, _, d = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float() * (d ** -0.5)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    mask = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        mask &= slot_pos > pos - window
    logits = torch.where(mask, logits, NEG)
    mx = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - mx), 0.0)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return (mx.reshape(b, h, 1), p.sum(-1).reshape(b, h, 1), acc.reshape(b, h, d))


def _decode_tp(rs: MeshShard, q, k, v, cache: dict, pos: int, window: int) -> torch.Tensor:
    """Decode on the sequence-sharded cache: the rank owning slot ``pos %
    S`` writes the token's key and value (all heads), every rank attends
    over its own slots for every head, and the partial softmaxes are
    combined across the model axis.  Returns ``[B, H, 1, D]``."""
    pm, m = rs.model.size, rs.model.rank
    s_buf = cache["slot_pos"].shape[0]
    blk = cache["k"].shape[2]
    slot = pos % s_buf
    if slot // blk == m:
        cache["k"][:, :, slot - m * blk : slot - m * blk + 1] = k.to(cache["k"].dtype)
        cache["v"][:, :, slot - m * blk : slot - m * blk + 1] = v.to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    mx, sm, acc = _decode_partial(q, cache["k"], cache["v"], _own_slot_pos(cache["slot_pos"],
                                                                           m, blk), pos, window)
    if pm > 1:  # one gather of every rank's (max, sum, output)
        got = rs.model.all_gather(torch.cat([mx, sm, acc], -1))
        mxs, sms, accs = got[..., :1], got[..., 1:2], got[..., 2:]
        top = mxs.amax(0)
        wts = torch.exp(mxs - top)
        sm = (wts * sms).sum(0)
        acc = (wts * accs).sum(0)
    sm = torch.where(sm == 0.0, 1.0, sm)
    return (acc / sm)[:, :, None].to(q.dtype)


def _cache_tp(rs: MeshShard, k, v, whole: bool, l: int, s_buf: int, dtype) -> dict:
    """This rank's block of the prefill cache.  ``k``, ``v`` are roped keys
    and values ``[B, h, L, D]``: the rank's own KV heads when ``whole``
    heads split over the model axis (an all-to-all then turns own heads on
    every slot into every head on own slots), else every head (each rank
    keeps its own slots)."""
    pm, m = rs.model.size, rs.model.rank
    b, h, _, d = k.shape
    blk = _slot_block(s_buf, pm)
    keep = min(l, s_buf)
    abs_pos = torch.arange(l - keep, l, device=k.device)
    slots = abs_pos % s_buf
    slot_pos = torch.full((s_buf,), -1, dtype=torch.int32, device=k.device)
    slot_pos[slots] = abs_pos.to(torch.int32)
    out = {"slot_pos": slot_pos}
    for name, x in (("k", k), ("v", v)):
        buf = torch.zeros((b, h, blk * pm, d), dtype=dtype, device=k.device)
        buf[:, :, slots] = x[:, :, l - keep :].to(dtype)
        if whole and pm > 1:
            chunks = buf.reshape(b, h, pm, blk, d).permute(2, 0, 1, 3, 4)
            got = rs.model.all_to_all(chunks.contiguous())  # [src, B, h, blk, D]
            out[name] = got.permute(1, 0, 2, 3, 4).reshape(b, h * pm, blk, d)
        else:
            out[name] = buf[:, :, m * blk : (m + 1) * blk].clone()
    return out


def _anchored(cfg, rs: MeshShard) -> bool:
    """Whether ``attn_anchor`` gives each rank its own q heads: the heads
    divide the model axis, the KV heads do not."""
    pm = rs.model.size
    return rs.anchor and pm > 1 and cfg.num_heads % pm == 0 and cfg.num_kv_heads % pm != 0


def _own_kv(k: torch.Tensor, cfg, rs: MeshShard) -> torch.Tensor:
    """The KV heads ``[B, n, L, D]`` of ``k`` (every KV head) that this
    rank's own q heads read: each once where they serve the rank's heads in
    equal consecutive groups, else one a q head (the reference's repeat)."""
    pm, m = rs.model.size, rs.model.rank
    hq, g = cfg.num_heads // pm, cfg.num_heads // cfg.num_kv_heads
    idx = [(m * hq + j) // g for j in range(hq)]
    n = idx[-1] - idx[0] + 1
    if hq % n == 0 and idx == [idx[0] + j // (hq // n) for j in range(hq)]:
        return k[:, idx[0] : idx[0] + n]
    return k[:, idx]


def _gather_cols(ts, rs: MeshShard, grad: bool):
    """Every rank's columns of each of ``ts`` ``[B, L, c_i]``, in one
    all-gather: ``[B, L, model * c_i]`` each, in rank order (the gradient
    reduce-scattered back where ``grad``)."""
    b, l = ts[0].shape[:2]
    pm = rs.model.size
    cols = [t.shape[-1] for t in ts]
    cat = torch.cat(ts, -1)
    got = (all_gather_cat(cat, rs.model, -1) if grad
           else torch.cat(list(rs.model.all_gather(cat.contiguous()).unbind(0)), -1))
    return [t.flatten(-2) for t in got.reshape(b, l, pm, sum(cols)).split(cols, -1)]


def attention_block_tp(
    p: Attention,
    x: torch.Tensor,  # the stream: [B, L, D_model] replicated, or this rank's block of it
    cfg,
    rs: MeshShard,
    *,
    causal: bool = True,
    window: int = 0,
    cache: Optional[dict] = None,
    pos: Optional[int] = None,
    dtype=torch.bfloat16,
    build_cache_len: Optional[int] = None,
    cache_dtype: torch.dtype = CACHE_DTYPE,
    attn_chunk: int = 1024,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """:func:`attention_block`'s self-attention as one rank of the mesh
    (see the module docstring): ``p`` holds the rank's weights; the output
    is the rank's part of the stream (:meth:`MeshShard.leave`).  With
    ``cache`` (decode) the rank's cache block is updated in place; with
    ``build_cache_len`` (prefill) the rank's block is built."""
    hd = cfg.resolved_head_dim
    pm, m = rs.model.size, rs.model.rank
    xe = rs.enter(x)
    b, l, _ = xe.shape
    q, k, v = (rs.column(w, xe, dtype) for w in (p.wq, p.wk, p.wv))
    whole = _whole_heads(cfg, pm)
    anchored = not whole and cache is None and _anchored(cfg, rs)
    grad = cache is None
    if whole:
        h, kv = cfg.num_heads // pm, cfg.num_kv_heads // pm
    elif anchored:  # own q heads; every rank's columns of k and v
        h, kv = cfg.num_heads // pm, cfg.num_kv_heads
        k, v = _gather_cols([k, v], rs, grad)
    else:  # every rank's columns of q, k and v
        h, kv = cfg.num_heads, cfg.num_kv_heads
        q, k, v = _gather_cols([q, k, v], rs, grad)
    q, k, v = (t.reshape(b, l, n, hd).transpose(1, 2) for t, n in ((q, h), (k, kv), (v, kv)))
    positions = (torch.arange(l, device=x.device) if cache is None
                 else torch.full((l,), pos, device=x.device))
    q = rope(q, positions, cfg.rope_theta, rs.rot)
    k = rope(k, positions, cfg.rope_theta, rs.rot)

    new_cache = None
    if cache is not None:
        if whole and pm > 1:  # every rank attends every head over its own slots
            got = rs.model.all_gather(torch.cat([q, k, v], 1))  # [pm, B, h + 2 kv, 1, D]
            q, k, v = (t.transpose(0, 1).flatten(1, 2) for t in got.split([h, kv, kv], 2))
            h = cfg.num_heads
        out = _decode_tp(rs, q, k, v, cache, pos, window)
        new_cache = cache
        cols = cfg.num_heads * hd // pm
        out = out.transpose(1, 2).reshape(b, l, cfg.num_heads * hd)[..., m * cols : (m + 1) * cols]
        return rs.row(p.wo.w, out, dtype), new_cache
    ka, va = (_own_kv(k, cfg, rs), _own_kv(v, cfg, rs)) if anchored else (k, v)
    if torch.is_grad_enabled() and (q.requires_grad or ka.requires_grad or va.requires_grad):
        out = chunked_attention(q, ka, va, causal=causal, window=window, q_chunk=attn_chunk,
                                kv_chunk=attn_chunk)
    else:
        out = ops.flash_attention(q.contiguous(), ka.contiguous(), va.contiguous(),
                                  causal=causal, window=window)
    if build_cache_len is not None:
        new_cache = _cache_tp(rs, k, v, whole, l, build_cache_len, cache_dtype)
    out = out.transpose(1, 2).reshape(b, l, h * hd)
    if not (whole or anchored):
        cols = h * hd // pm
        out = out[..., m * cols : (m + 1) * cols]
    return rs.row(p.wo.w, out, dtype), new_cache


def cross_attention_tp(
    p: Attention,
    x: torch.Tensor,  # the stream, as attention_block_tp takes it
    cfg,
    rs: MeshShard,
    *,
    context: Optional[torch.Tensor] = None,  # [B, Lc, D_model], replicated over the model axis
    cache: Optional[dict] = None,
    dtype=torch.bfloat16,
    build_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Cross-attention as one rank of the mesh: train and prefill over
    ``context`` (``build_cache``: the context's keys and values of every
    KV head, ``{"xk", "xv"}`` ``[B, Hkv, Lc, hd]``, gathered over the model
    axis), decode over ``cache["xk"]``, ``cache["xv"]``.  Heads split as in
    :func:`attention_block_tp`; the output is the rank's part of the
    stream."""
    hd = cfg.resolved_head_dim
    pm, m = rs.model.size, rs.model.rank
    xe = rs.enter(x)
    b, l, _ = xe.shape
    q = rs.column(p.wq, xe, dtype)
    whole = _whole_heads(cfg, pm)
    own = whole or _anchored(cfg, rs)
    new_cache = None
    if cache is None:
        if context is None:
            raise ValueError("a cross-attention needs a context outside decode")
        ctx = copy_to(context, rs.model)
        lc = ctx.shape[1]
        k, v = rs.column(p.wk, ctx, dtype), rs.column(p.wv, ctx, dtype)
        if build_cache:
            xk, xv = _gather_cols([k, v], rs, grad=False)
            new_cache = {n: t.reshape(b, lc, cfg.num_kv_heads, hd).transpose(1, 2)
                         for n, t in (("xk", xk), ("xv", xv))}
        if whole:
            kv = cfg.num_kv_heads // pm
        elif own:
            k, v = _gather_cols([k, v], rs, grad=True)
            kv = cfg.num_kv_heads
        else:  # q has the prompt's positions, k and v the context's
            (q,) = _gather_cols([q], rs, grad=True)
            k, v = _gather_cols([k, v], rs, grad=True)
            kv = cfg.num_kv_heads
        h = cfg.num_heads // pm if own else cfg.num_heads
        q = q.reshape(b, l, h, hd).transpose(1, 2)
        k, v = (t.reshape(b, lc, kv, hd).transpose(1, 2) for t in (k, v))
        if own and not whole:
            k, v = _own_kv(k, cfg, rs), _own_kv(v, cfg, rs)
        out = chunked_attention(q, k, v, causal=False, window=0)
    else:
        xk, xv = cache["xk"], cache["xv"]
        lc = xk.shape[2]
        if own:
            h = cfg.num_heads // pm
            xk, xv = _own_kv(xk, cfg, rs), _own_kv(xv, cfg, rs)
        else:
            h = cfg.num_heads
            (q,) = _gather_cols([q], rs, grad=False)
        q = q.reshape(b, l, h, hd).transpose(1, 2)
        out = decode_attention(q, xk, xv, torch.arange(lc, device=x.device), lc, window=0)
    out = out.transpose(1, 2).reshape(b, l, h * hd)
    if not own:
        cols = h * hd // pm
        out = out[..., m * cols : (m + 1) * cols]
    return rs.row(p.wo.w, out, dtype), new_cache
