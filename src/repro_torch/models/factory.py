"""Model factory: ArchConfig -> the callables that serve one architecture.

Counterpart of ``repro/models/factory.py`` (``build_model``, ``Model``) for
the serving path of every reference row:

* ``init_fn(generator) -> params``            (a :class:`Transformer`)
* ``prefill_fn(params, batch) -> (logits, caches)``
* ``decode_fn(params, batch) -> (logits, caches)``  (one token)
* ``init_caches_fn(batch_size, seq_len, context_len=0) -> caches``

``batch["context"]`` ``[B, Lc, d]`` is a vision row's image-patch
embeddings (cast to the compute dtype) or an audio row's frame embeddings
(run through the encoder) for prefill; decode reads the context's keys and
values from the caches.  ``logits`` are the float32 ``[B, V_pad]`` logits of
each sequence's last position, as the reference returns them.
``decode_fn`` updates ``batch["caches"]`` in place and returns them (the
reference returns updated copies).  ``loss_fn``, ``chunked_ce_loss`` and
the sharding specs wait for ROADMAP queue 1 items 16 and 17.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from ..configs.base import ArchConfig
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

__all__ = ["Model", "build_model", "context_len"]


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
    device: torch.device
    dtype: torch.dtype
    cast_params: bool
    cache_dtype: torch.dtype
    init_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_caches_fn: Callable


def build_model(
    cfg: ArchConfig,
    *,
    dtype: torch.dtype = torch.bfloat16,
    cast_params: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    cache_dtype: torch.dtype = CACHE_DTYPE,
) -> Model:
    """The serving callables of ``cfg`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; raises without a card).

    ``dtype`` is the compute dtype.  ``cast_params=True`` is the reference's
    ``cast_params``: ``init_fn`` stores weights of two or more dimensions in
    ``dtype`` as it draws them (1-D weights stay float32) and no float32
    copy is kept, since nothing here updates weights.  Either way each
    weight is cast to ``dtype`` where it is used, so both give the same
    logits.  ``prefill_fn`` and ``decode_fn`` take only weights drawn for
    ``cfg`` (the weights carry their config).  ``cache_dtype`` stores the
    self-attention keys and values (the reference's bf16 by default,
    whatever ``dtype`` is).
    """
    _check_supported(cfg)
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
            return encode(params, cfg, ctx, dtype=dtype)
        return ctx.to(dtype)

    @torch.no_grad()
    def prefill_fn(params, batch):
        check_weights(params, cfg)
        tokens = batch["tokens"].to(dev)
        s_buf = cache_buffer_len(cfg, tokens.shape[1])
        logits, caches = params(tokens, mode="prefill", context=_context_of(params, batch),
                                dtype=dtype, s_buf=s_buf, cache_dtype=cache_dtype)
        return logits[:, -1].clone(), caches  # the clone lets the [B, L, V] logits go

    @torch.no_grad()
    def decode_fn(params, batch):
        check_weights(params, cfg)
        logits, caches = params(batch["tokens"].to(dev), mode="decode", caches=batch["caches"],
                                pos=batch["pos"], dtype=dtype)
        return logits[:, -1].clone(), caches

    def init_caches_fn(batch_size: int, seq_len: int, context_len: int = 0):
        return init_caches(cfg, batch_size, seq_len, context_len=context_len, device=dev,
                           cache_dtype=cache_dtype)

    return Model(cfg=cfg, device=dev, dtype=dtype, cast_params=cast_params,
                 cache_dtype=cache_dtype, init_fn=init_fn,
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_caches_fn=init_caches_fn)
