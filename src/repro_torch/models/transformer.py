"""Decoder LM assembled from an ArchConfig: ``"attn"`` blocks with a dense FFN.

Counterpart of ``repro/models/transformer.py`` for the dense rows.  The
reference stacks each position of the block pattern over depth and scans
it; here the layers are an ``nn.ModuleList`` walked by a Python loop, and
caches are a list with one dict per layer.  Other block kinds wait for
ROADMAP queue 1 items 11-15 (cross-attention 11, experts 12, ``rwkv`` 13,
``rglru`` 14, the encoder 15); each raises naming its item.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .attention import Attention, attention_block, attn_init, init_kv_cache
from .layers import MLP, Initializer, mlp_apply, mlp_init, rmsnorm, weight

__all__ = [
    "Block",
    "Transformer",
    "layer_plan",
    "init_params",
    "cache_buffer_len",
    "init_caches",
    "forward",
    "encode",
]

#: block kinds and experts the port does not run yet, with their ROADMAP item
_WAITING = {
    "local": "item 11 (chunked attention)",
    "cross": "item 11 (cross-attention)",
    "attn_cross": "item 11 (cross-attention)",
    "rwkv": "item 13 (rwkv6)",
    "rglru": "item 14 (rglru)",
}


def _check_supported(cfg) -> None:
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: experts wait for ROADMAP queue 1 item 12 (moe)")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder waits for ROADMAP queue 1 item 15 (whisper encoder)")
    for kind in cfg.block_pattern:
        if kind != "attn":
            what = _WAITING.get(kind)
            if what is None:
                raise ValueError(f"unknown block kind {kind!r}")
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} blocks wait for ROADMAP queue 1 {what}")


def layer_plan(cfg) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """``(n_full_groups, pattern, tail_kinds)``, as the reference plans depth."""
    pat = cfg.block_pattern
    n_full = cfg.num_layers // len(pat)
    tail = pat[: cfg.num_layers % len(pat)]
    return n_full, pat, tail


class Block(nn.Module):
    """Pre-norm ``"attn"`` block: attention and a dense FFN, each residual."""

    def __init__(self, ln1: torch.Tensor, attn: Attention, ln2: torch.Tensor, ffn: MLP):
        super().__init__()
        self.ln1 = weight(ln1)
        self.attn = attn
        self.ln2 = weight(ln2)
        self.ffn = ffn

    def forward(self, h, cfg, *, mode="train", cache=None, pos=None, dtype=torch.bfloat16,
                s_buf: Optional[int] = None):
        """The reference's ``_apply_block`` for ``"attn"``; returns ``(h, cache)``.

        Residual adds are in ``h``'s dtype (the compute dtype), as in the
        reference."""
        eps = cfg.norm_eps
        mix, new_cache = attention_block(
            self.attn, rmsnorm(self.ln1, h, eps), cfg,
            window=cfg.window,
            cache=cache if mode == "decode" else None,
            pos=pos,
            dtype=dtype,
            build_cache_len=s_buf if mode == "prefill" else None,
        )
        h = h + mix
        h = h + mlp_apply(self.ffn, rmsnorm(self.ln2, h, eps), cfg.act, dtype=dtype)
        return h, new_cache


def _block_init(init: Initializer, cfg) -> Block:
    """One ``"attn"`` block (``_check_supported`` refuses every other kind)."""
    d = cfg.d_model
    return Block(ln1=init.ones((d,)), attn=attn_init(init, cfg), ln2=init.ones((d,)),
                 ffn=mlp_init(init, cfg.d_model, cfg.d_ff, cfg.act))


class Transformer(nn.Module):
    """The weights of one decoder LM, and its forward pass.

    ``embed`` ``[V_pad, d]``, ``final_norm`` ``[d]``, ``lm_head`` ``[d,
    V_pad]`` (``None`` with tied embeddings) and ``blocks``, one per layer.
    """

    def __init__(self, cfg, embed: torch.Tensor, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor], blocks: List[Block]):
        super().__init__()
        _check_supported(cfg)
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, got {len(blocks)} blocks")
        self.cfg = cfg
        self.embed = weight(embed)
        self.final_norm = weight(final_norm)
        self.lm_head = None if lm_head is None else weight(lm_head)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, tokens: torch.Tensor, *, mode: str = "train", caches=None, pos=None,
                dtype=torch.bfloat16, s_buf: Optional[int] = None):
        """Returns ``(logits [B, L, V_pad] float32, caches or None)``.

        ``mode="train"`` runs without a cache; ``"prefill"`` builds caches of
        ``s_buf`` slots; ``"decode"`` runs one token at position ``pos`` and
        updates ``caches`` in place.  Pad vocab columns get ``-1e30`` added.
        """
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "decode":
            if caches is None or pos is None:
                raise ValueError("decode needs caches and pos")
            pos = int(pos)
        if mode == "prefill" and s_buf is None:
            s_buf = cache_buffer_len(cfg, tokens.shape[1])
        h = self.embed[tokens].to(dtype)
        new_caches = []
        for i, blk in enumerate(self.blocks):
            h, nc = blk(h, cfg, mode=mode, cache=caches[i] if mode == "decode" else None,
                        pos=pos, dtype=dtype, s_buf=s_buf)
            new_caches.append(nc)
        h = rmsnorm(self.final_norm, h, cfg.norm_eps)
        head = self.embed.T if self.lm_head is None else self.lm_head
        logits = h.float() @ head.float()
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.where(torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size,
                              0.0, -1e30)
            logits.add_(pad)
        return logits, (new_caches if mode != "train" else None)


def init_params(cfg, generator: torch.Generator, *, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """Random weights with the reference's distributions, drawn from
    ``generator`` on ``device``: normal(0.02) for the embedding and LM head,
    ``d_in**-0.5`` for dense weights (``d_ff**-0.5`` for ``w_down``), zeros
    for biases, ones for norms.  With ``dtype``, weights of two or more
    dimensions are stored in it as they are drawn (``cast_params``)."""
    _check_supported(cfg)
    init = Initializer(generator, device=device, dtype=dtype)
    d = cfg.d_model
    embed = init.normal((cfg.padded_vocab, d))
    final_norm = init.ones((d,))
    lm_head = None if cfg.tie_embeddings else init.normal((d, cfg.padded_vocab))
    blocks = [_block_init(init, cfg) for _ in range(cfg.num_layers)]
    return Transformer(cfg, embed, final_norm, lm_head, blocks)


def cache_buffer_len(cfg, seq_len: int) -> int:
    """Self-attention KV buffer length for decoding after ``seq_len`` tokens."""
    if cfg.window > 0:
        return min(seq_len + 128, cfg.window + 128)
    return seq_len + 128


def init_caches(cfg, batch: int, seq_len: int, *, device: torch.device) -> List[dict]:
    """Empty caches (one dict per layer) for decoding after ``seq_len`` tokens."""
    _check_supported(cfg)
    s_buf = cache_buffer_len(cfg, seq_len)
    return [init_kv_cache(batch, cfg.num_kv_heads, s_buf, cfg.resolved_head_dim, device=device)
            for _ in range(cfg.num_layers)]


def forward(params: Transformer, cfg, tokens: torch.Tensor, *, mode: str = "train",
            caches=None, pos=None, dtype=torch.bfloat16, s_buf: Optional[int] = None):
    """The reference's ``forward`` signature over :class:`Transformer` weights;
    returns ``(logits, caches or None)``."""
    if params.cfg != cfg:
        raise ValueError(f"weights are for {params.cfg.name}, not {cfg.name}")
    return params(tokens, mode=mode, caches=caches, pos=pos, dtype=dtype, s_buf=s_buf)


def encode(*args, **kwargs):
    raise NotImplementedError("encode (the whisper encoder) waits for ROADMAP queue 1 item 15")
