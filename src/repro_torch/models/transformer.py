"""Decoder LM assembled from an ArchConfig, every block kind of the
reference, and the whisper encoder.

Counterpart of ``repro/models/transformer.py``.  Block kinds:

  attn        causal self-attention (+ sliding window) and an FFN (dense or experts)
  local       windowed self-attention and an FFN
  cross       gated cross-attention over a context (llama-vision's image layers)
  attn_cross  self-attention, cross-attention and an FFN (a whisper-style decoder layer)
  rwkv        RWKV6 time-mix and channel-mix
  rglru       RG-LRU temporal mix and an FFN

The reference stacks each position of the block pattern over depth and
scans it; here the layers are an ``nn.ModuleList`` walked by a Python loop,
and caches are a list with one dict per layer: ``{"k", "v", "slot_pos"}``
for self-attention (``"xk"``, ``"xv"`` added for ``attn_cross``), ``{"xk",
"xv"}`` for ``cross``, ``{"wkv", "x_prev_t", "x_prev_c"}`` for ``rwkv`` and
``{"h", "conv"}`` for ``rglru``.  Whisper adds a bidirectional encoder over
its frame embeddings (:func:`encode`).

Training runs ``mode="train"`` under autograd with self-attention through
``chunked_attention`` (chosen by ``attention_block`` where autograd needs
a backward) and the reference's ``remat``: ``"full"`` recomputes each
layer in the backward (``torch.utils.checkpoint``), ``"dots"`` keeps the
outputs of the plain matmuls (the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
keeps everything.  The reference remats a
group of the block pattern, here each layer: the same values.  The
experts' load-balancing aux losses are summed over the layers.

On a ``data x model`` mesh (``rs``, a :class:`~.layers.MeshShard`) every
block kind runs as one rank's program: self-attention through
``attention_block_tp``, cross-attention through ``cross_attention_tp``,
the time- and channel-mix through ``rwkv_block_tp`` and
``rwkv_channel_mix_tp``, the RG-LRU through ``rglru_block_tp``, FFNs
column- and row-parallel, the experts through ``moe_block_manual``; the
whisper encoder likewise, its stream replicated over the model axis.
Under sequence parallelism the residual stream between blocks is the
rank's block (``MeshShard.sp``), so a remat carry is ``1 / model`` of a
rank's.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .attention import (
    CACHE_DTYPE,
    Attention,
    attention_block,
    attention_block_tp,
    attn_init,
    cross_attention_tp,
    decode_attention,
    init_kv_cache,
    init_kv_cache_tp,
)
from .layers import (
    MLP,
    Initializer,
    MeshShard,
    dense_apply,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rope_tables,
    weight,
)
from .moe import MoE, moe_block, moe_block_manual, moe_init
from .rglru import RgLru, init_rglru_state, rglru_block, rglru_block_tp, rglru_init
from .rwkv6 import (
    RwkvChannel,
    RwkvTime,
    init_rwkv_state,
    rwkv_block,
    rwkv_block_tp,
    rwkv_channel_mix,
    rwkv_channel_mix_tp,
    rwkv_init,
)

__all__ = [
    "Block",
    "CrossBlock",
    "AttnCrossBlock",
    "RwkvBlock",
    "RglruBlock",
    "EncoderBlock",
    "Encoder",
    "Transformer",
    "BLOCK_KINDS",
    "REMAT_MODES",
    "layer_plan",
    "layer_kinds",
    "init_params",
    "cache_buffer_len",
    "init_caches",
    "forward",
    "cast_weights",
    "check_weights",
    "encode",
]

BLOCK_KINDS = ("attn", "local", "cross", "attn_cross", "rwkv", "rglru")
#: the block kinds whose prefill builds a self-attention KV cache
_KV_KINDS = ("attn", "local", "attn_cross")
#: the reference's ``ShardingConfig.remat`` values
REMAT_MODES = ("full", "dots", "none")
#: what ``remat="dots"`` keeps: the plain matmuls (a batched one, as the
#: attention and expert einsums are, is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(remat: str) -> dict:
    if remat == "dots":
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)}
    return {}


def _check_supported(cfg) -> None:
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")


def layer_plan(cfg) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """``(n_full_groups, pattern, tail_kinds)``, as the reference plans depth."""
    pat = cfg.block_pattern
    n_full = cfg.num_layers // len(pat)
    tail = pat[: cfg.num_layers % len(pat)]
    return n_full, pat, tail


def layer_kinds(cfg) -> List[str]:
    """The block kind of each layer, in depth order (the pattern cycled)."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _ffn_apply(ffn, x: torch.Tensor, cfg, dtype, rs: Optional[MeshShard] = None):
    """A dense FFN, or the experts: ``(out, aux loss or None)``; on one
    device, or as one rank of the mesh ``rs`` (the reference's mesh
    ``_ffn_apply``: ``moe_block_manual`` over the model axis, its aux
    averaged over the batch axes, on the whole stream and back to the
    rank's block of it under sequence parallelism)."""
    if rs is None:
        if isinstance(ffn, MoE):
            return moe_block(ffn, x, cfg, dtype=dtype)
        return mlp_apply(ffn, x, cfg.act, dtype=dtype), None
    if isinstance(ffn, MoE):
        out, aux = moe_block_manual(ffn, rs.enter_whole(x), cfg, group=rs.model,
                                    data_group=rs.data, dp_groups=rs.dp,
                                    pipeline=rs.moe_pipeline, fsdp=rs.fsdp,
                                    dtype=dtype)
        return rs.own(out), aux
    return rs.mlp(ffn, x, cfg.act, dtype), None


def _norm(w: torch.Tensor, x: torch.Tensor, eps: float, rs: Optional[MeshShard]) -> torch.Tensor:
    """:func:`rmsnorm` of the stream, on one device or a rank of the mesh."""
    return rmsnorm(w, x, eps) if rs is None else rs.norm(w, x, eps)


def _project_context(p: Attention, cfg, context: torch.Tensor, dtype) -> dict:
    """A cross-attention's keys and values of ``context`` ``[B, Lc, D]``, in
    ``dtype``, for decode: ``{"xk", "xv"}`` ``[B, Hkv, Lc, hd]``."""
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    b, lc, _ = context.shape

    def proj(w):
        return dense_apply(w, context, dtype).reshape(b, lc, kv, hd).transpose(1, 2)

    return {"xk": proj(p.wk), "xv": proj(p.wv)}


def _cross_from_cache(p: Attention, x: torch.Tensor, cfg, xk: torch.Tensor, xv: torch.Tensor,
                      dtype) -> torch.Tensor:
    """Cross-attention of ``x`` ``[B, L, D]`` over cached keys and values."""
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    b, l, _ = x.shape
    q = dense_apply(p.wq, x, dtype).reshape(b, l, h, hd).transpose(1, 2)
    lc = xk.shape[2]
    slot_pos = torch.arange(lc, device=x.device)
    out = decode_attention(q, xk, xv, slot_pos, lc, window=0)
    return out.transpose(1, 2).reshape(b, l, h * hd) @ p.wo.w.to(dtype)


class Block(nn.Module):
    """Pre-norm ``"attn"`` or ``"local"`` block: self-attention and an FFN
    (dense, or experts), each residual."""

    def __init__(self, ln1: torch.Tensor, attn: Attention, ln2: torch.Tensor, ffn,
                 kind: str = "attn"):
        super().__init__()
        if kind not in ("attn", "local"):
            raise ValueError(f"a Block is 'attn' or 'local', not {kind!r}")
        self.kind = kind
        self.ln1 = weight(ln1)
        self.attn = attn
        self.ln2 = weight(ln2)
        self.ffn = ffn

    def forward(self, h, cfg, *, mode="train", cache=None, pos=None, context=None,
                dtype=torch.bfloat16, s_buf: Optional[int] = None, cache_dtype=CACHE_DTYPE,
                attn_chunk: int = 1024, rs: Optional[MeshShard] = None):
        """The reference's ``_apply_block``; returns ``(h, cache, aux)`` (aux:
        the experts' loss, or None).  Residual adds are in ``h``'s dtype (the
        compute dtype), as in the reference; ``attn_chunk`` tiles the
        self-attention under autograd (``attention_block``).  With ``rs``,
        one rank of the mesh (``attention_block_tp``)."""
        eps = cfg.norm_eps
        local = self.kind == "local"
        build = None
        if mode == "prefill":
            build = min(s_buf, cfg.local_window + 128) if local else s_buf
        kw = {}
        if rs is not None:
            kw["rs"] = rs = rs.gather(_fsdp_weights(self))
        mix, new_cache = (attention_block if rs is None else attention_block_tp)(
            self.attn, _norm(self.ln1, h, eps, rs), cfg,
            causal=True,
            window=cfg.local_window if local else cfg.window,
            cache=cache if mode == "decode" else None,
            pos=pos,
            dtype=dtype,
            build_cache_len=build,
            cache_dtype=cache_dtype,
            attn_chunk=attn_chunk,
            **kw,
        )
        h = h + mix
        ff, aux = _ffn_apply(self.ffn, _norm(self.ln2, h, eps, rs), cfg, dtype, rs)
        return h + ff, new_cache, aux


def _fsdp_weights(blk: nn.Module) -> list:
    """A block's ``(weight, dimension FSDP splits)`` that its rank gathers at
    its entry: every column-parallel projection's ``w`` (dimension 0) and
    row-parallel one's (dimension 1) of its attentions, mixes and dense FFN
    (the experts gather their own)."""
    out = []
    for a in (getattr(blk, "attn", None), getattr(blk, "xattn", None)):
        if a is not None:
            out += [(a.wq.w, 0), (a.wk.w, 0), (a.wv.w, 0), (a.wo.w, 1)]
    if isinstance(blk, RwkvBlock):
        t, c = blk.time, blk.channel
        out += [(d.w, 0) for d in (t.wr, t.wk, t.wv, t.wg, c.wk)] + [(t.wo.w, 1), (c.wv.w, 1)]
    if isinstance(blk, RglruBlock):
        r = blk.rec
        out += [(d.w, 0) for d in (r.w_in, r.w_gate, r.lru_a, r.lru_x)] + [(r.w_out.w, 1)]
    ffn = getattr(blk, "ffn", None)
    if isinstance(ffn, MLP):
        out += [(w, 0) for w in (ffn.w_gate, ffn.w_up) if w is not None]
        out.append((ffn.w_down, 1))
    return out


class CrossBlock(nn.Module):
    """Pre-norm ``"cross"`` block: cross-attention gated by ``tanh(xgate)``,
    then an FFN.  ``xgate`` is zero at init (the block starts as a no-op)."""

    kind = "cross"

    def __init__(self, ln1: torch.Tensor, xattn: Attention, ln2: torch.Tensor, ffn,
                 xgate: torch.Tensor):
        super().__init__()
        self.ln1 = weight(ln1)
        self.xattn = xattn
        self.ln2 = weight(ln2)
        self.ffn = ffn
        self.xgate = weight(xgate)

    def forward(self, h, cfg, *, mode="train", cache=None, pos=None, context=None,
                dtype=torch.bfloat16, s_buf: Optional[int] = None,
                rs: Optional[MeshShard] = None):
        eps = cfg.norm_eps
        if rs is not None:
            rs = rs.gather(_fsdp_weights(self))
            mix, new_cache = cross_attention_tp(
                self.xattn, rs.norm(self.ln1, h, eps), cfg, rs,
                context=context if mode != "decode" else None,
                cache=cache if mode == "decode" else None, dtype=dtype,
                build_cache=mode == "prefill")
            h = h + torch.tanh(rs.stream_weight(self.xgate)).to(h.dtype) * mix
            ff, aux = _ffn_apply(self.ffn, rs.norm(self.ln2, h, eps), cfg, dtype, rs)
            return h + ff, cache if mode == "decode" else new_cache, aux
        x = rmsnorm(self.ln1, h, eps)
        new_cache = None
        if mode == "decode":
            mix = _cross_from_cache(self.xattn, x, cfg, cache["xk"], cache["xv"], dtype)
            new_cache = cache
        else:
            if context is None:
                raise ValueError("a cross block needs a context outside decode")
            mix, _ = attention_block(self.xattn, x, cfg, context=context, dtype=dtype)
            if mode == "prefill":
                new_cache = _project_context(self.xattn, cfg, context, dtype)
        h = h + torch.tanh(self.xgate).to(h.dtype) * mix
        ff, aux = _ffn_apply(self.ffn, rmsnorm(self.ln2, h, eps), cfg, dtype)
        return h + ff, new_cache, aux


class AttnCrossBlock(nn.Module):
    """Pre-norm ``"attn_cross"`` block: causal self-attention, cross-attention
    over the context, an FFN; its cache is the self-attention's and the
    context's keys and values."""

    kind = "attn_cross"

    def __init__(self, ln1: torch.Tensor, attn: Attention, ln_c: torch.Tensor,
                 xattn: Attention, ln2: torch.Tensor, ffn):
        super().__init__()
        self.ln1 = weight(ln1)
        self.attn = attn
        self.ln_c = weight(ln_c)
        self.xattn = xattn
        self.ln2 = weight(ln2)
        self.ffn = ffn

    def forward(self, h, cfg, *, mode="train", cache=None, pos=None, context=None,
                dtype=torch.bfloat16, s_buf: Optional[int] = None, cache_dtype=CACHE_DTYPE,
                attn_chunk: int = 1024, rs: Optional[MeshShard] = None):
        eps = cfg.norm_eps
        if rs is not None:
            return self._forward_tp(h, cfg, mode, cache, pos, context, dtype, s_buf, cache_dtype,
                                    attn_chunk, rs.gather(_fsdp_weights(self)))
        mix, new_kv = attention_block(
            self.attn, rmsnorm(self.ln1, h, eps), cfg, causal=True,
            cache=cache if mode == "decode" else None, pos=pos, dtype=dtype,
            build_cache_len=s_buf if mode == "prefill" else None, cache_dtype=cache_dtype,
            attn_chunk=attn_chunk)
        h = h + mix
        x = rmsnorm(self.ln_c, h, eps)
        if mode == "decode":
            xmix = _cross_from_cache(self.xattn, x, cfg, cache["xk"], cache["xv"], dtype)
        else:
            if context is None:
                raise ValueError("an attn_cross block needs a context outside decode")
            xmix, _ = attention_block(self.xattn, x, cfg, context=context, dtype=dtype)
        h = h + xmix
        ff, aux = _ffn_apply(self.ffn, rmsnorm(self.ln2, h, eps), cfg, dtype)
        h = h + ff
        new_cache = None
        if mode == "prefill":
            new_cache = dict(new_kv, **_project_context(self.xattn, cfg, context, dtype))
        elif mode == "decode":
            new_cache = cache  # its k, v and slot_pos were written in place
        return h, new_cache, aux

    def _forward_tp(self, h, cfg, mode, cache, pos, context, dtype, s_buf, cache_dtype,
                    attn_chunk, rs: MeshShard):
        """One rank's block: the self-attention's cache sharded over the
        sequence, the context's keys and values whole."""
        eps = cfg.norm_eps
        decode = mode == "decode"
        mix, new_kv = attention_block_tp(
            self.attn, rs.norm(self.ln1, h, eps), cfg, rs, causal=True,
            cache=cache if decode else None, pos=pos, dtype=dtype,
            build_cache_len=s_buf if mode == "prefill" else None, cache_dtype=cache_dtype,
            attn_chunk=attn_chunk)
        h = h + mix
        xmix, ctx_kv = cross_attention_tp(self.xattn, rs.norm(self.ln_c, h, eps), cfg, rs,
                                          context=None if decode else context,
                                          cache=cache if decode else None, dtype=dtype,
                                          build_cache=mode == "prefill")
        h = h + xmix
        ff, aux = _ffn_apply(self.ffn, rs.norm(self.ln2, h, eps), cfg, dtype, rs)
        new_cache = cache if decode else (dict(new_kv, **ctx_kv) if mode == "prefill" else None)
        return h + ff, new_cache, aux


class RwkvBlock(nn.Module):
    """Pre-norm ``"rwkv"`` block: the time-mix, then the channel-mix."""

    kind = "rwkv"

    def __init__(self, ln1: torch.Tensor, time: RwkvTime, channel: RwkvChannel,
                 ln2: torch.Tensor):
        super().__init__()
        self.ln1 = weight(ln1)
        self.time = time
        self.channel = channel
        self.ln2 = weight(ln2)

    def forward(self, h, cfg, *, mode="train", cache=None, pos=None, context=None,
                dtype=torch.bfloat16, s_buf: Optional[int] = None,
                rs: Optional[MeshShard] = None):
        eps = cfg.norm_eps
        state = None
        if mode == "prefill":
            state = _block_cache(cfg, "rwkv", h.shape[0], 0, 0, h.device, torch.float32,
                                 0 if rs is None else rs.model.size)
        elif mode == "decode":
            state = cache
        time_mix, channel_mix, kw = rwkv_block, rwkv_channel_mix, {}
        if rs is not None:
            time_mix, channel_mix = rwkv_block_tp, rwkv_channel_mix_tp
            kw["rs"] = rs = rs.gather(_fsdp_weights(self))
        mix, state2 = time_mix(self.time, _norm(self.ln1, h, eps, rs), cfg, state=state,
                               dtype=dtype, **kw)
        h = h + mix
        cm, state3 = channel_mix(self.channel, _norm(self.ln2, h, eps, rs), state=state2,
                                 dtype=dtype, **kw)
        h = h + cm
        if mode == "decode":
            cache.update(state3)
            state3 = cache
        return h, state3, None


class RglruBlock(nn.Module):
    """Pre-norm ``"rglru"`` block: the RG-LRU temporal mix, then a dense FFN."""

    kind = "rglru"

    def __init__(self, ln1: torch.Tensor, rec: RgLru, ln2: torch.Tensor, ffn: MLP):
        super().__init__()
        self.ln1 = weight(ln1)
        self.rec = rec
        self.ln2 = weight(ln2)
        self.ffn = ffn

    def forward(self, h, cfg, *, mode="train", cache=None, pos=None, context=None,
                dtype=torch.bfloat16, s_buf: Optional[int] = None,
                rs: Optional[MeshShard] = None):
        eps = cfg.norm_eps
        state = None
        if mode == "prefill":
            state = _block_cache(cfg, "rglru", h.shape[0], 0, 0, h.device, torch.float32,
                                 0 if rs is None else rs.model.size)
        elif mode == "decode":
            state = cache
        mix_fn, kw = rglru_block, {}
        if rs is not None:
            mix_fn = rglru_block_tp
            kw["rs"] = rs = rs.gather(_fsdp_weights(self))
        mix, new_state = mix_fn(self.rec, _norm(self.ln1, h, eps, rs), cfg, state=state,
                                dtype=dtype, **kw)
        h = h + mix
        h = h + _ffn_apply(self.ffn, _norm(self.ln2, h, eps, rs), cfg, dtype, rs)[0]
        if mode == "decode":
            cache.update(new_state)
            new_state = cache
        return h, new_state, None


class EncoderBlock(nn.Module):
    """Pre-norm encoder block: bidirectional self-attention and a dense FFN."""

    def __init__(self, ln1: torch.Tensor, attn: Attention, ln2: torch.Tensor, ffn: MLP):
        super().__init__()
        self.ln1 = weight(ln1)
        self.attn = attn
        self.ln2 = weight(ln2)
        self.ffn = ffn


class Encoder(nn.Module):
    """Whisper's encoder: ``blocks`` and ``final_norm``."""

    def __init__(self, blocks: List[EncoderBlock], final_norm: torch.Tensor):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = weight(final_norm)


def _block_init(init: Initializer, cfg, kind: str) -> nn.Module:
    d = cfg.d_model

    def ffn():
        if cfg.num_experts:
            return moe_init(init, cfg)
        return mlp_init(init, d, cfg.d_ff, cfg.act)

    ln1 = init.ones((d,))
    if kind in ("attn", "local"):
        attn = attn_init(init, cfg)
        return Block(ln1=ln1, attn=attn, ln2=init.ones((d,)), ffn=ffn(), kind=kind)
    if kind == "cross":
        xattn = attn_init(init, cfg)
        ln2 = init.ones((d,))
        return CrossBlock(ln1=ln1, xattn=xattn, ln2=ln2, ffn=ffn(), xgate=init.zeros(()))
    if kind == "attn_cross":
        attn = attn_init(init, cfg)
        ln_c = init.ones((d,))
        xattn = attn_init(init, cfg)
        ln2 = init.ones((d,))
        return AttnCrossBlock(ln1=ln1, attn=attn, ln_c=ln_c, xattn=xattn, ln2=ln2, ffn=ffn())
    if kind == "rwkv":
        time, channel = rwkv_init(init, cfg)
        return RwkvBlock(ln1=ln1, time=time, channel=channel, ln2=init.ones((d,)))
    if kind == "rglru":
        rec = rglru_init(init, cfg)
        ln2 = init.ones((d,))
        return RglruBlock(ln1=ln1, rec=rec, ln2=ln2, ffn=mlp_init(init, d, cfg.d_ff, cfg.act))
    raise ValueError(f"unknown block kind {kind!r}")


class Transformer(nn.Module):
    """The weights of one LM, and its forward pass.

    ``embed`` ``[V_pad, d]``, ``final_norm`` ``[d]``, ``lm_head`` ``[d,
    V_pad]`` (``None`` with tied embeddings), ``blocks``, one per layer of
    the kind :func:`layer_kinds` gives it, and ``encoder`` for a row with
    encoder layers (else ``None``).
    """

    def __init__(self, cfg, embed: torch.Tensor, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor], blocks: List[nn.Module],
                 encoder: Optional[Encoder] = None):
        super().__init__()
        _check_supported(cfg)
        kinds = layer_kinds(cfg)
        got = [blk.kind for blk in blocks]
        if got != kinds:
            raise ValueError(f"{cfg.name} has layers {kinds}, got blocks {got}")
        if (encoder is None) != (not cfg.encoder_layers):
            raise ValueError(f"{cfg.name} has {cfg.encoder_layers} encoder layers; "
                             f"encoder {'missing' if encoder is None else 'given'}")
        self.cfg = cfg
        self.embed = weight(embed)
        self.final_norm = weight(final_norm)
        self.lm_head = None if lm_head is None else weight(lm_head)
        self.blocks = nn.ModuleList(blocks)
        self.encoder = encoder

    def forward(self, tokens: torch.Tensor, *, mode: str = "train", caches=None, pos=None,
                context: Optional[torch.Tensor] = None, dtype=torch.bfloat16,
                s_buf: Optional[int] = None, cache_dtype: torch.dtype = CACHE_DTYPE,
                remat: str = "none", attn_chunk: int = 1024,
                return_hidden: bool = False, rs: Optional[MeshShard] = None):
        """Returns ``(logits [B, L, V_pad] float32, caches or None, aux)``.

        ``mode="train"`` runs without a cache; ``"prefill"`` builds caches
        (``s_buf`` self-attention slots of keys and values in
        ``cache_dtype``, the reference's bf16 by default); ``"decode"`` runs one token at
        position ``pos`` and updates ``caches`` in place.  ``context``
        ``[B, Lc, d]`` (in the compute dtype; for whisper, the encoder's
        output) feeds the cross-attention outside decode, where the caches
        hold its keys and values.  Pad vocab columns get ``-1e30`` added.
        Under autograd self-attention runs in ``attn_chunk`` tiles
        (``attention_block``).
        ``remat`` (one of
        :data:`REMAT_MODES`) applies in train mode with grad enabled.
        ``return_hidden`` returns the final-normed hidden state ``[B, L, d]``
        in place of the logits (the loss chunks the head itself).  ``aux`` is
        the experts' aux losses summed over the layers (float32; 0 without
        experts).

        With ``rs`` it is one rank's program on the mesh: ``tokens`` are the
        rank's rows, the weights and caches its blocks, the hidden state
        replicated over the model axis (under sequence parallelism, outside
        decode, the rank's block of it: ``return_hidden`` returns that) and
        the logits its block of vocab columns ``[B_loc, L, V_pad / model]``.
        """
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat {remat!r}; one of {REMAT_MODES}")
        if mode == "decode":
            if caches is None or pos is None:
                raise ValueError("decode needs caches and pos")
            pos = int(pos)
        if mode == "prefill" and s_buf is None:
            s_buf = cache_buffer_len(cfg, tokens.shape[1])
        if rs is None:
            h = self.embed[tokens].to(dtype)
        else:
            # decode's one token keeps the stream replicated
            rs = dataclasses.replace(rs, sp=0 if mode == "decode" else rs.sp,
                                     seq_len=tokens.shape[1])
            h = rs.embed(self.embed, tokens, dtype)
            positions = (torch.full((1,), pos, device=h.device) if mode == "decode"
                         else torch.arange(tokens.shape[1], device=h.device))
            rs = dataclasses.replace(rs, rot=rope_tables(positions, cfg.resolved_head_dim,
                                                         cfg.rope_theta))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        remat_on = remat != "none" and mode == "train" and torch.is_grad_enabled()
        new_caches = []
        for i, blk in enumerate(self.blocks):
            kw = ({"cache_dtype": cache_dtype, "attn_chunk": attn_chunk}
                  if blk.kind in _KV_KINDS else {})
            if rs is not None:
                kw["rs"] = rs
            if remat_on:
                h, a = checkpoint(_train_layer, blk, h, cfg, context, dtype, kw,
                                  use_reentrant=False, **_remat_kwargs(remat))
                nc = None
            else:
                h, nc, a = blk(h, cfg, mode=mode, cache=caches[i] if mode == "decode" else None,
                               pos=pos, context=context, dtype=dtype, s_buf=s_buf, **kw)
            if a is not None:
                aux = aux + a
            new_caches.append(nc)
        h = _norm(self.final_norm, h, cfg.norm_eps, rs)
        caches_out = new_caches if mode != "train" else None
        if return_hidden:
            return h, caches_out, aux
        if rs is None:
            head, lo = (self.embed.T if self.lm_head is None else self.lm_head), 0
        else:
            head = (rs.unshard(self.embed, 1).T if self.lm_head is None
                    else rs.unshard(self.lm_head, 0))
            h, lo = rs.enter(h), rs.model.rank * head.shape[1]
        logits = h.float() @ head.float()
        if cfg.padded_vocab != cfg.vocab_size:
            cols = torch.arange(lo, lo + head.shape[1], device=logits.device)
            logits.add_(torch.where(cols < cfg.vocab_size, 0.0, -1e30))
        return logits, caches_out, aux


def _train_layer(blk, h, cfg, context, dtype, kw):
    """One layer of a train-mode forward, as remat recomputes it: ``(h, aux)``."""
    h, _, aux = blk(h, cfg, mode="train", context=context, dtype=dtype, **kw)
    return h, (torch.zeros((), dtype=torch.float32, device=h.device) if aux is None else aux)


def init_params(cfg, generator: Optional[torch.Generator], *, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """Random weights with the reference's distributions, drawn from
    ``generator`` on ``device``: normal(0.02) for the embedding and LM head,
    ``d_in**-0.5`` for dense weights and experts (``d_ff**-0.5`` for
    ``w_down``), zeros for biases and ``xgate``, ones for norms, and the
    reference's own scales for RWKV's mixes, decay and bonus and RG-LRU's
    conv and decay.  With ``dtype``, weights of two or more dimensions are
    stored in it as they are drawn (``cast_params``).  On ``device="meta"``
    (``generator`` None) the weights are shapes only, for the specs."""
    _check_supported(cfg)
    init = Initializer(generator, device=device, dtype=dtype)
    d = cfg.d_model
    embed = init.normal((cfg.padded_vocab, d))
    final_norm = init.ones((d,))
    lm_head = None if cfg.tie_embeddings else init.normal((d, cfg.padded_vocab))
    blocks = [_block_init(init, cfg, kind) for kind in layer_kinds(cfg)]
    encoder = None
    if cfg.encoder_layers:
        enc_blocks = []
        for _ in range(cfg.encoder_layers):
            ln1 = init.ones((d,))
            attn = attn_init(init, cfg)
            ln2 = init.ones((d,))
            enc_blocks.append(EncoderBlock(ln1=ln1, attn=attn, ln2=ln2,
                                           ffn=mlp_init(init, d, cfg.d_ff, cfg.act)))
        encoder = Encoder(enc_blocks, init.ones((d,)))
    return Transformer(cfg, embed, final_norm, lm_head, blocks, encoder)


def cache_buffer_len(cfg, seq_len: int) -> int:
    """Self-attention KV buffer length for decoding after ``seq_len`` tokens."""
    if cfg.window > 0:
        return min(seq_len + 128, cfg.window + 128)
    return seq_len + 128


def _block_cache(cfg, kind: str, batch: int, s_buf: int, context_len: int,
                 device: torch.device, dtype: torch.dtype, model_size: int = 0) -> dict:
    """One layer's empty cache; with ``model_size`` one rank's block of it:
    self-attention keys and values sharded over the sequence, the context's
    whole, recurrent states split over channels (``cache_pspecs``), the
    ``wkv`` state as ``H / model`` whole heads where the heads divide the
    axis (every head where they do not)."""
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    pm = model_size or 1
    if model_size and kind in ("attn", "local", "attn_cross"):
        length = min(s_buf, cfg.local_window + 128) if kind == "local" else s_buf
        kv = init_kv_cache_tp(batch, kvh, length, hd, model_size, device=device, dtype=dtype)
        if kind != "attn_cross":
            return kv

    def ctx_kv(lc):
        z = lambda: torch.zeros((batch, kvh, lc, hd), dtype=dtype, device=device)  # noqa: E731
        return {"xk": z(), "xv": z()}

    if kind == "attn":
        return init_kv_cache(batch, kvh, s_buf, hd, device=device, dtype=dtype)
    if kind == "local":
        return init_kv_cache(batch, kvh, min(s_buf, cfg.local_window + 128), hd, device=device,
                             dtype=dtype)
    if kind == "cross":
        return ctx_kv(context_len or cfg.num_image_tokens or cfg.encoder_context)
    if kind == "attn_cross":
        if not model_size:
            kv = init_kv_cache(batch, kvh, s_buf, hd, device=device, dtype=dtype)
        return dict(kv, **ctx_kv(context_len or cfg.encoder_context))
    if kind == "rwkv":
        heads = cfg.d_model // hd
        if heads % pm == 0:
            heads //= pm
        return init_rwkv_state(batch, heads, hd, cfg.d_model // pm, device=device)
    if kind == "rglru":
        return init_rglru_state(batch, cfg.d_model // pm, device=device)
    raise ValueError(f"unknown block kind {kind!r}")


def init_caches(cfg, batch: int, seq_len: int, *, context_len: int = 0,
                device: torch.device, cache_dtype: torch.dtype = CACHE_DTYPE,
                model_size: int = 0) -> List[dict]:
    """Empty caches (keys and values in ``cache_dtype``) and zero float32
    states, one dict per layer, for decoding after ``seq_len`` tokens; a
    cross-attention cache holds ``context_len`` context positions (the row's
    own context length by default).  With ``model_size`` each layer's cache
    is one rank's block of it over that many model ranks (``_block_cache``;
    ``batch`` is then the rank's rows)."""
    _check_supported(cfg)
    s_buf = cache_buffer_len(cfg, seq_len)
    return [_block_cache(cfg, kind, batch, s_buf, context_len, device, cache_dtype, model_size)
            for kind in layer_kinds(cfg)]


def forward(params: Transformer, cfg, tokens: torch.Tensor, *, context=None,
            mode: str = "train", caches=None, pos=None, dtype=torch.bfloat16,
            s_buf: Optional[int] = None, return_hidden: bool = False,
            cast_params: bool = False):
    """The reference's ``forward`` signature over :class:`Transformer` weights,
    served (self-attention through flash); returns ``(logits, caches or
    None, aux_loss)`` as the reference does, the final-normed hidden state
    ``[B, L, d]`` in place of the logits with ``return_hidden``; ``aux_loss``
    is the float32 sum of the MoE layers' load-balancing losses (0 on a row
    without experts).  ``cast_params`` reads the weights of two or more
    dimensions cast to ``dtype`` (:func:`cast_weights`)."""
    check_weights(params, cfg)
    if cast_params:
        params = cast_weights(params, dtype)
    out, caches, aux = params(tokens, mode=mode, caches=caches, pos=pos, context=context,
                              dtype=dtype, s_buf=s_buf, return_hidden=return_hidden)
    return out, caches, aux


def cast_weights(params: Transformer, dtype: torch.dtype) -> Transformer:
    """``params`` as the reference's ``cast_params`` reads them: a shallow
    copy of the module tree in which every float32 weight of two or more
    dimensions is ``w.to(dtype)``, differentiable, so that gradients reach
    the float32 weights themselves (the masters); 1-D weights stay float32.
    ``params`` itself where nothing is cast."""
    if dtype == torch.float32 or not any(w.dtype == torch.float32 and w.dim() >= 2
                                         for w in params.parameters()):
        return params

    def view(mod: nn.Module) -> nn.Module:
        out = copy.copy(mod)
        out.__dict__["_parameters"] = dict(mod._parameters)
        out.__dict__["_modules"] = {k: None if m is None else view(m)
                                    for k, m in mod._modules.items()}
        for k, w in mod._parameters.items():
            if w is not None and w.dtype == torch.float32 and w.dim() >= 2:
                del out._parameters[k]
                out.__dict__[k] = w.to(dtype)
        return out

    return view(params)


def check_weights(params: Transformer, cfg) -> None:
    """Raise unless ``params`` were drawn for ``cfg``: a :class:`Transformer`
    runs under the config it carries."""
    if params.cfg != cfg:
        apart = {f.name: (getattr(params.cfg, f.name), getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)
                 if getattr(params.cfg, f.name) != getattr(cfg, f.name)}
        raise ValueError(f"weights are for another config than {cfg.name}: (theirs, "
                         f"given) {apart}")


def encode(params: Transformer, cfg, frames: torch.Tensor, *, dtype=torch.bfloat16,
           attn_chunk: int = 1024, rs: Optional[MeshShard] = None) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings ``[B, T, d]``: each
    layer's self-attention through ``ops.flash_attention(causal=False)``, or
    under autograd ``chunked_attention`` (``attention_block``).  With ``rs``
    one rank's program (``attention_block_tp`` on the rank's heads, the
    FFN column- and row-parallel), its stream and output replicated over the
    model axis."""
    if params.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    eps = cfg.norm_eps
    h = frames.to(dtype)
    if rs is not None:
        pos = torch.arange(h.shape[1], device=h.device)
        rs = dataclasses.replace(rs, sp=0, seq_len=None, gathered=None,
                                 rot=rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta))
    for blk in params.encoder.blocks:
        rsb, kw = None, {}
        if rs is not None:
            kw["rs"] = rsb = rs.gather(_fsdp_weights(blk))
        mix, _ = (attention_block if rs is None else attention_block_tp)(
            blk.attn, rmsnorm(blk.ln1, h, eps), cfg, causal=False, dtype=dtype,
            attn_chunk=attn_chunk, **kw)
        h = h + mix
        h = h + _ffn_apply(blk.ffn, rmsnorm(blk.ln2, h, eps), cfg, dtype, rsb)[0]
    return rmsnorm(params.encoder.final_norm, h, eps)
