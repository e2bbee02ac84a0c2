"""Model factory: ArchConfig -> the callables that serve and train one
architecture.

Counterpart of ``repro/models/factory.py`` (``build_model``, ``Model``,
``chunked_ce_loss``) for every reference row:

* ``init_fn(generator) -> params``            (a :class:`Transformer`)
* ``loss_fn(params, batch) -> loss``          (the train step's objective)
* ``prefill_fn(params, batch) -> (logits, caches)``
* ``decode_fn(params, batch) -> (logits, caches)``  (one token)
* ``init_caches_fn(batch_size, seq_len, context_len=0) -> caches``

``batch["context"]`` ``[B, Lc, D]`` is a vision row's image-patch
embeddings (cast to the compute dtype) or an audio row's frame embeddings
(run through the encoder) for prefill and the loss; decode reads the
context's keys and values from the caches.  ``logits`` are the float32
``[B, V_pad]`` logits of each sequence's last position, as the reference
returns them.  ``decode_fn`` updates ``batch["caches"]`` in place and
returns them (the reference returns updated copies).  ``loss_fn`` runs the
train-mode forward under autograd, self-attention through
``chunked_attention`` (the reference trains through its XLA path, whose
flash kernel has no backward; without a gradient to take, as under
``torch.no_grad``, it goes through the flash kernel as serving does) and
``ShardingConfig.remat``; gradients come from ``torch.autograd`` on the
weights made trainable (``params.requires_grad_()``).  The sharding specs (``param_pspecs``,
``cache_pspecs``, ``input_specs``) wait for ROADMAP queue 1 item 17.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, ShardingConfig
from ..device import resolve_device
from .attention import CACHE_DTYPE
from .transformer import (
    _check_supported,
    cache_buffer_len,
    check_weights,
    encode,
    init_caches,
    init_params,
)

__all__ = ["Model", "build_model", "chunked_ce_loss", "context_len"]

#: tokens per chunk of :func:`chunked_ce_loss`
CE_CHUNK = 512


def _ce_chunk(hc: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              pad: Optional[torch.Tensor]) -> torch.Tensor:
    """Summed cross-entropy of one chunk: float32 logits ``[B, c, V_pad]``."""
    logits = hc.float() @ head.float()
    if pad is not None:
        logits = logits + pad
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_ce_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, *,
                    chunk: int = CE_CHUNK, vocab_size: int = 0) -> torch.Tensor:
    """Mean cross-entropy of ``h`` ``[B, S, D]`` (the final hidden state)
    through ``head`` ``[D, V_pad]`` against ``labels`` ``[B, S]``, with the
    ``[B, chunk, V_pad]`` float32 logits made one chunk of positions at a
    time; pad columns past ``vocab_size`` get ``-1e30``.

    Under autograd each chunk runs under ``torch.utils.checkpoint``, so its
    logits are recomputed in the backward rather than saved, as the
    reference's ``jax.checkpoint`` does.  The reference halves ``chunk``
    until it divides ``S`` (at ``S = 2047``, a train step's ``S - 1``, that
    is 1: 2047 one-token chunks); here the last chunk is ragged instead.
    That is the same sum in another order.
    """
    b, s, _ = h.shape
    v_pad = head.shape[1]
    pad = None
    if vocab_size and v_pad != vocab_size:
        pad = torch.where(torch.arange(v_pad, device=h.device) < vocab_size, 0.0, -1e30)
    grad = torch.is_grad_enabled() and (h.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0 : c0 + chunk], head, labels[:, c0 : c0 + chunk], pad)
        total = total + (checkpoint(_ce_chunk, *args, use_reentrant=False) if grad
                         else _ce_chunk(*args))
    return total / (b * s)


def context_len(cfg: ArchConfig) -> Tuple[int, bool]:
    """``(context positions, whether prefill needs a context)``: a vision
    row's image tokens, an audio row's encoder frames, else none."""
    if cfg.family == "vlm":
        return cfg.num_image_tokens, True
    if cfg.family == "audio":
        return cfg.encoder_context, True
    return 0, False


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    sharding: ShardingConfig
    device: torch.device
    dtype: torch.dtype
    cast_params: bool
    cache_dtype: torch.dtype
    init_fn: Callable
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_caches_fn: Callable


def build_model(
    cfg: ArchConfig,
    sharding: Optional[ShardingConfig] = None,
    mesh=None,
    *,
    dtype: torch.dtype = torch.bfloat16,
    cast_params: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    cache_dtype: torch.dtype = CACHE_DTYPE,
) -> Model:
    """The callables of ``cfg`` on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``; raises without a card).

    ``dtype`` is the compute dtype.  ``cast_params=True`` is the reference's
    ``cast_params`` for serving: ``init_fn`` stores weights of two or more
    dimensions in ``dtype`` as it draws them (1-D weights stay float32) and
    no float32 copy is kept.  Either way each weight is cast to ``dtype``
    where it is used, so both give the same logits; training keeps float32
    weights (the reference's masters), so a trainer refuses cast weights.
    The callables take only weights drawn for ``cfg`` (the weights carry
    their config).  ``cache_dtype`` stores the self-attention keys and
    values (the reference's bf16 by default, whatever ``dtype`` is).
    ``sharding`` gives the loss its ``remat`` and ``attn_chunk`` (the
    reference's defaults, ``"full"`` and 1024, without one); a ``mesh``
    waits for ROADMAP queue 1 item 17.
    """
    _check_supported(cfg)
    if mesh is not None:
        raise NotImplementedError("build_model on a mesh waits for the sharding specs "
                                  "(ROADMAP queue 1 item 17)")
    sh = sharding or ShardingConfig()
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the model on {dev}")
        return init_params(cfg, generator, device=dev, dtype=dtype if cast_params else None)

    def _context_of(params, batch):
        ctx = batch.get("context")
        if ctx is None:
            return None
        ctx = ctx.to(dev)
        if cfg.family == "audio":  # frame embeddings -> encoder -> the cross context
            return encode(params, cfg, ctx, dtype=dtype, attn_chunk=sh.attn_chunk)
        return ctx.to(dtype)

    def loss_fn(params, batch):
        """``CE(h[:, :-1] @ head, tokens[:, 1:]) + 0.01 * aux``: a float32
        scalar, differentiable in the weights that require a gradient."""
        check_weights(params, cfg)
        tokens = batch["tokens"].to(dev)
        h, _, aux = params(tokens, mode="train", context=_context_of(params, batch),
                           dtype=dtype, remat=sh.remat, attn_chunk=sh.attn_chunk,
                           return_hidden=True)
        head = params.embed.T if params.lm_head is None else params.lm_head
        loss = chunked_ce_loss(h[:, :-1], head, tokens[:, 1:], vocab_size=cfg.vocab_size)
        return loss + 0.01 * aux

    @torch.no_grad()
    def prefill_fn(params, batch):
        check_weights(params, cfg)
        tokens = batch["tokens"].to(dev)
        s_buf = cache_buffer_len(cfg, tokens.shape[1])
        logits, caches, _ = params(tokens, mode="prefill", context=_context_of(params, batch),
                                   dtype=dtype, s_buf=s_buf, cache_dtype=cache_dtype)
        return logits[:, -1].clone(), caches  # the clone lets the [B, L, V] logits go

    @torch.no_grad()
    def decode_fn(params, batch):
        check_weights(params, cfg)
        logits, caches, _ = params(batch["tokens"].to(dev), mode="decode",
                                   caches=batch["caches"], pos=batch["pos"], dtype=dtype)
        return logits[:, -1].clone(), caches

    def init_caches_fn(batch_size: int, seq_len: int, context_len: int = 0):
        return init_caches(cfg, batch_size, seq_len, context_len=context_len, device=dev,
                           cache_dtype=cache_dtype)

    return Model(cfg=cfg, sharding=sh, device=dev, dtype=dtype, cast_params=cast_params,
                 cache_dtype=cache_dtype, init_fn=init_fn, loss_fn=loss_fn,
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_caches_fn=init_caches_fn)
