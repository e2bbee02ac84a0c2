"""AdamW with global-norm clipping and a cosine schedule.

Counterpart of ``repro/train/optimizer.py``: plain functions on dicts of
tensors (a weight's name -> tensor, as ``dict(model.named_parameters())``
gives them).  The state is ``{"m", "v", "step"}``: ``m`` and ``v`` float32
dicts mirroring the weights, ``step`` an int32 scalar on the CPU (the
schedule is host arithmetic, so a step needs no device sync for it).

``adamw_update`` updates the weights, ``m`` and ``v`` in place, as the
reference's jitted step donates them, with ``torch._foreach_*`` ops: a
step is a few multi-tensor launches, not one small launch per tensor.  It
keeps the reference's order of operations (clip, then ``m``, ``v``, the
bias corrections, ``m_hat / (sqrt(v_hat) + eps) + wd * p``, then ``p -
lr * delta``); ``torch.optim.AdamW`` rounds in another order and schedules
the learning rate apart.

On a mesh a rank holds the blocks of its weights and gradients that the
weights' specs give, and ``m`` and ``v`` as :func:`opt_state_pspecs` gives
them: with ZeRO-1 the state of a weight not already split over ``data``
splits its first free dimension that the data axis divides.  The train
step passes ``adamw_update`` the global gradient norm
(:func:`sharded_global_norm`) and the blocks it updates; AdamW is
elementwise, so a block's update equals the same block of the whole
update, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..comm.spec import PartitionSpec as P
from ..comm.spec import used_axes

__all__ = [
    "AdamWConfig",
    "init_opt_state",
    "adamw_update",
    "cosine_schedule",
    "opt_state_pspecs",
    "clip_by_global_norm",
    "sharded_global_norm",
]

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup to ``lr_peak``, then a
    cosine to 0 at ``total_steps``; a float32 scalar on the CPU, computed in
    float32 as the reference computes it."""
    step = _f32(step)
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    frac = torch.clamp((step - _f32(cfg.warmup_steps))
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    return _f32(cfg.lr_peak) * warm * _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * frac))


def init_opt_state(params: Tensors) -> dict:
    """Zero ``m`` and ``v`` (float32, on each weight's device) and step 0."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def sharded_global_norm(grads: Tensors, specs: Mapping[str, P], groups: Mapping) -> torch.Tensor:
    """The global L2 norm of gradients held as blocks (``specs``, ``groups``
    axis name -> this rank's group): each block's sum of squares, added over
    the axes its weight is split on, so a weight whole on an axis counts
    once, not once a rank.  Every rank gets the same value."""
    by_axes: Dict[tuple, list] = {}
    for k, g in grads.items():
        axes = tuple(sorted(a for a in used_axes(specs[k]) if a in groups))
        by_axes.setdefault(axes, []).append(g.float())
    total = None
    for axes, gs in sorted(by_axes.items()):
        sq = torch.stack(torch._foreach_norm(gs, 2)).square().sum()
        for a in axes:
            if groups[a].size > 1:
                sq = groups[a].all_reduce_sum(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float, norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``: float32 copies,
    and the global L2 norm as a device scalar (no sync).  ``norm``, where
    given, is the global norm (of gradients held as blocks)."""
    keys = list(grads)
    g32 = [grads[k].float() for k in keys]
    gn = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g32, 2)), 2) if norm is None
          else norm)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return dict(zip(keys, torch._foreach_mul(g32, scale))), gn


def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors, state: dict, *,
                 norm: Optional[torch.Tensor] = None):
    """One AdamW step: ``(params, state, {"lr", "grad_norm"})``, the first
    two updated in place.  ``params`` are float32 (the reference's masters);
    ``lr`` is a float32 CPU scalar, ``grad_norm`` a device scalar.  Beyond
    the weights, the gradients and the state it holds two float32 copies of
    the weights' size at once (the clipped gradients, reused for the
    update, and the denominator).  ``norm`` is the global gradient norm
    where the gradients given are blocks of the whole (a mesh's ZeRO-1)."""
    keys = list(params)
    if any(params[k].dtype != torch.float32 for k in keys):
        raise ValueError("adamw_update takes float32 weights (the reference's masters)")
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step).item()  # float32 values, exact as Python floats
    b1c = (_f32(1.0) - torch.pow(_f32(cfg.b1), step.float())).item()
    b2c = (_f32(1.0) - torch.pow(_f32(cfg.b2), step.float())).item()
    p = [params[k] for k in keys]
    m = [state["m"][k] for k in keys]
    v = [state["v"][k] for k in keys]
    with torch.no_grad():
        clipped, gnorm = clip_by_global_norm({k: grads[k] for k in keys}, cfg.clip_norm, norm)
        g = [clipped.pop(k) for k in keys]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        delta = g  # the clipped gradients' memory holds m_hat, then the update
        torch._foreach_copy_(delta, m)
        torch._foreach_div_(delta, b1c)
        denom = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(delta, denom)
        del denom
        torch._foreach_add_(delta, p, alpha=cfg.weight_decay)
        torch._foreach_add_(p, delta, alpha=-lr)
    state = {"m": state["m"], "v": state["v"], "step": step}
    return params, state, {"lr": torch.tensor(lr, dtype=torch.float32), "grad_norm": gnorm}


def opt_state_pspecs(param_specs: Mapping[str, P], param_shapes: Optional[Mapping] = None, *,
                     zero1: bool, data_axis: str = "data", data_size: int = 0) -> dict:
    """State specs ``{"m", "v", "step"}``: ``m`` and ``v`` inherit each
    weight's spec; with ``zero1`` those of a weight not split over
    ``data_axis`` split their first whole dimension whose size the data axis
    divides (``param_shapes``, name -> tensor or shape, and ``data_size``
    are needed for that check; the reference's ``opt_state_pspecs``)."""

    def shard_state(spec: P, shape=None) -> P:
        if not zero1 or shape is None or not data_size:
            return spec
        parts = list(spec) if spec else [None] * len(shape)
        if data_axis in used_axes(spec):
            return spec  # already sharded over data (fsdp)
        for i, (p, d) in enumerate(zip(parts, shape)):
            if p is None and d % data_size == 0 and d > 0:
                parts[i] = data_axis
                return P(*parts)
        return spec

    def shape_of(x):
        return tuple(getattr(x, "shape", x))

    mv = {k: shard_state(spec, None if param_shapes is None else shape_of(param_shapes[k]))
          for k, spec in param_specs.items()}
    return {"m": mv, "v": dict(mv), "step": P()}
