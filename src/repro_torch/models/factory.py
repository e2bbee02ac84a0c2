"""Model factory: ArchConfig -> the callables that serve one architecture.

Counterpart of ``repro/models/factory.py`` (``build_model``, ``Model``) for
the serving path of the dense rows:

* ``init_fn(generator) -> params``            (a :class:`Transformer`)
* ``prefill_fn(params, batch) -> (logits, caches)``
* ``decode_fn(params, batch) -> (logits, caches)``  (one token)
* ``init_caches_fn(batch_size, seq_len) -> caches``

``logits`` are the float32 ``[B, V_pad]`` logits of each sequence's last
position, as the reference returns them.  ``decode_fn`` writes the new
token's key and value into ``batch["caches"]`` in place and returns them
(the reference returns updated copies).  ``loss_fn``, ``chunked_ce_loss``
and the sharding specs wait for ROADMAP queue 1 items 16 and 17.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .transformer import _check_supported, cache_buffer_len, init_caches, init_params

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    dtype: torch.dtype
    cast_params: bool
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
) -> Model:
    """The serving callables of ``cfg`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; raises without a card).

    ``dtype`` is the compute dtype.  ``cast_params=True`` is the reference's
    ``cast_params``: ``init_fn`` stores weights of two or more dimensions in
    ``dtype`` as it draws them (1-D weights stay float32) and no float32
    copy is kept, since nothing here updates weights.  Either way each
    weight is cast to ``dtype`` where it is used, so both give the same
    logits.
    """
    _check_supported(cfg)
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the model on {dev}")
        return init_params(cfg, generator, device=dev, dtype=dtype if cast_params else None)

    @torch.no_grad()
    def prefill_fn(params, batch):
        tokens = batch["tokens"].to(dev)
        s_buf = cache_buffer_len(cfg, tokens.shape[1])
        logits, caches = params(tokens, mode="prefill", dtype=dtype, s_buf=s_buf)
        return logits[:, -1].clone(), caches  # the clone lets the [B, L, V] logits go

    @torch.no_grad()
    def decode_fn(params, batch):
        logits, caches = params(batch["tokens"].to(dev), mode="decode", caches=batch["caches"],
                                pos=batch["pos"], dtype=dtype)
        return logits[:, -1].clone(), caches

    def init_caches_fn(batch_size: int, seq_len: int):
        return init_caches(cfg, batch_size, seq_len, device=dev)

    return Model(cfg=cfg, device=dev, dtype=dtype, cast_params=cast_params, init_fn=init_fn,
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_caches_fn=init_caches_fn)
