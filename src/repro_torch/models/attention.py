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
serving); otherwise every rank all-gathers q, k and v, attends on all
heads and keeps its own output columns for ``wo``.  The gather is the
simpler of the two reshards the cut allows (an all-to-all to whole heads
is the other): it costs ``model`` times the attention's compute, and its
gradient is a reduce-scatter.  The KV cache is sharded over the sequence
(``cache_pspecs``): ``k``, ``v`` ``[B, Hkv, ceil(S/model), hd]`` a rank,
the last blocks padded and masked where ``S`` does not divide the axis,
and ``slot_pos`` whole on every rank.  Decode combines each rank's partial
softmax over its slots (the flash-decoding combine).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..comm import all_gather_cat
from ..kernels import ops
from ..kernels.ref import NEG
from .layers import Dense, Initializer, MeshShard, dense_apply, dense_init, rope

__all__ = [
    "Attention",
    "attn_init",
    "attention_block",
    "attention_block_tp",
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


def init_kv_cache(batch: int, kv_heads: int, length: int, head_dim: int, *,
                  device: torch.device, dtype: torch.dtype = CACHE_DTYPE) -> dict:
    """Circular KV cache; ``slot_pos`` holds the absolute position in each
    slot (-1 where empty), and position ``p`` lives in slot ``p % length``."""
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
    token attends over the cache.  Returns ``(out [B, L, D_model], cache or
    None)``.
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
    if cache is None:
        positions = torch.arange(l, device=x.device)
    else:
        positions = torch.full((l,), pos, device=x.device)
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


def attention_block_tp(
    p: Attention,
    x: torch.Tensor,  # [B, L, D_model], replicated over the model axis
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
    (see the module docstring): ``p`` holds the rank's weights, the output
    ``[B, L, D_model]`` is replicated over the model axis.  With ``cache``
    (decode) the rank's cache block is updated in place; with
    ``build_cache_len`` (prefill) the rank's block is built."""
    hd = cfg.resolved_head_dim
    pm, m = rs.model.size, rs.model.rank
    b, l, _ = x.shape
    xe = rs.enter(x)
    q, k, v = (rs.column(w, xe, dtype) for w in (p.wq, p.wk, p.wv))
    whole = _whole_heads(cfg, pm)
    if whole:
        h, kv = cfg.num_heads // pm, cfg.num_kv_heads // pm
    else:  # every rank's columns of q, k and v, in one gather
        h, kv = cfg.num_heads, cfg.num_kv_heads
        cols = [t.shape[-1] for t in (q, k, v)]
        qkv = torch.cat([q, k, v], -1)
        qkv = (all_gather_cat(qkv, rs.model, -1) if cache is None
               else torch.cat(list(rs.model.all_gather(qkv).unbind(0)), -1))
        qkv = qkv.reshape(b, l, pm, sum(cols))
        q, k, v = (t.flatten(-2) for t in qkv.split(cols, -1))
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = chunked_attention(q, k, v, causal=causal, window=window, q_chunk=attn_chunk,
                                kv_chunk=attn_chunk)
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)
    if build_cache_len is not None:
        new_cache = _cache_tp(rs, k, v, whole, l, build_cache_len, cache_dtype)
    out = out.transpose(1, 2).reshape(b, l, h * hd)
    if not whole:
        cols = h * hd // pm
        out = out[..., m * cols : (m + 1) * cols]
    return rs.row(p.wo.w, out, dtype), new_cache
