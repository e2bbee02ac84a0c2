"""Self-attention with GQA: prefill through the flash kernel, a circular bf16
KV cache, and decode over it.

Counterparts of ``repro/models/attention.py`` for self-attention.  Prefill
(``Lq == Lk``) goes through ``ops.flash_attention``: the hand-written CUDA
kernel for a CUDA tensor, its plain version for a CPU tensor.  Decode is
plain torch over the cache, as it is XLA code in the reference.  The
reference's XLA ``chunked_attention`` and cross-attention wait for ROADMAP
queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from ..kernels.ref import NEG
from .layers import Dense, Initializer, dense_apply, dense_init, rope

__all__ = [
    "Attention",
    "attn_init",
    "attention_block",
    "chunked_attention",
    "decode_attention",
    "init_kv_cache",
]

#: the reference stores every KV cache in bf16, whatever the compute dtype
CACHE_DTYPE = torch.bfloat16


class Attention(nn.Module):
    """The four projections, ``[d_in, d_out]`` each (biases for QKV-bias rows)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def attn_init(init: Initializer, cfg) -> Attention:
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


def chunked_attention(*args, **kwargs):
    raise NotImplementedError(
        "chunked_attention (the reference's XLA path) waits for ROADMAP queue 1 item 11; "
        "self-attention prefill runs ops.flash_attention"
    )


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
                  device: torch.device) -> dict:
    """Circular KV cache; ``slot_pos`` holds the absolute position in each
    slot (-1 where empty), and position ``p`` lives in slot ``p % length``."""
    return {
        "k": torch.zeros((batch, kv_heads, length, head_dim), dtype=CACHE_DTYPE, device=device),
        "v": torch.zeros((batch, kv_heads, length, head_dim), dtype=CACHE_DTYPE, device=device),
        "slot_pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def attention_block(
    p: Attention,
    x: torch.Tensor,  # [B, L, D_model]
    cfg,
    *,
    window: int = 0,
    cache: Optional[dict] = None,
    pos: Optional[int] = None,
    dtype=torch.bfloat16,
    build_cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One self-attention mix (the block owns norm and residual).

    Without ``cache`` the tokens attend to each other through
    ``ops.flash_attention``; with ``build_cache_len`` a cache of that many
    slots is built from their keys and values (prefill).  With ``cache``
    (decode, one token at position ``pos``), the token's key and value are
    written at slot ``pos % S`` **in place** and the token attends over the
    cache.  Returns ``(out [B, L, D_model], cache or None)``.
    """
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    b, l, _ = x.shape
    q = _project(p.wq, x, h, hd, dtype)
    k = _project(p.wk, x, kv, hd, dtype)
    v = _project(p.wv, x, kv, hd, dtype)
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
        cache["k"][:, :, slot : slot + 1] = k.to(CACHE_DTYPE)
        cache["v"][:, :, slot : slot + 1] = v.to(CACHE_DTYPE)
        cache["slot_pos"][slot] = pos
        new_cache = cache
        out = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"], pos, window=window)
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=True, window=window)
        if build_cache_len is not None:
            s_buf = build_cache_len
            keep = min(l, s_buf)
            new_cache = init_kv_cache(b, kv, s_buf, hd, device=x.device)
            # the last `keep` positions (a windowed cache may be shorter than
            # the prompt), at slots absolute position % s_buf
            abs_pos = torch.arange(l - keep, l, device=x.device)
            slots = abs_pos % s_buf
            new_cache["k"][:, :, slots] = k[:, :, l - keep :].to(CACHE_DTYPE)
            new_cache["v"][:, :, slots] = v[:, :, l - keep :].to(CACHE_DTYPE)
            new_cache["slot_pos"][slots] = abs_pos.to(torch.int32)

    out = out.transpose(1, 2).reshape(b, l, h * hd)
    return out @ p.wo.w.to(dtype), new_cache
