"""Shared layer primitives: norms, RoPE, dense layers, MLPs, init helpers.

Counterparts of ``repro/models/layers.py``.  Weights live in small
``nn.Module`` containers, drawn frozen (serving needs no gradient; the
train step makes them trainable with ``requires_grad_()``); every layer is
``*_apply(module, x, ...)``.  The compute dtype is bf16 by
default: a weight is cast to it where it is used, as the reference does, so
float32 weights and weights stored in the compute dtype give the same
result.  Weights of two or more dimensions may be stored in the compute
dtype once, when they are made (``Initializer(..., dtype=)``, the
reference's ``cast_params``); 1-D weights (norms, biases) stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Initializer",
    "Dense",
    "MLP",
    "weight",
    "rmsnorm",
    "rope",
    "dense_init",
    "dense_apply",
    "mlp_init",
    "mlp_apply",
]


class Initializer:
    """Weights drawn from one explicit ``torch.Generator`` on ``device``.

    The reference's distributions: ``normal(scale)`` is a float32 normal
    times ``scale``; zeros and ones are float32.  Where ``dtype`` is set, a
    drawn weight of two or more dimensions is cast to it at once, so no
    float32 copy of the model is ever whole.
    """

    def __init__(self, generator: torch.Generator, *, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        self.generator = generator
        self.device = device
        self.dtype = dtype

    def normal(self, shape: Sequence[int], scale: float = 0.02) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.generator, device=self.device,
                        dtype=torch.float32)
        x.mul_(scale)
        return x.to(self.dtype) if self.dtype is not None and x.dim() >= 2 else x

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=self.device)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=torch.float32, device=self.device)


def weight(x: torch.Tensor) -> nn.Parameter:
    """A weight, drawn frozen: serving takes no gradient, and the train step
    makes the weights trainable (``params.requires_grad_()``)."""
    return nn.Parameter(x, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` ``[d_in, d_out]``, the reference's layout."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = weight(w)
        self.b = None if b is None else weight(b)


class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_up``, ``w_down``)."""

    def __init__(self, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: Optional[torch.Tensor] = None):
        super().__init__()
        self.w_gate = None if w_gate is None else weight(w_gate)
        self.w_up = weight(w_up)
        self.w_down = weight(w_down)


def dense_init(init: Initializer, d_in: int, d_out: int, *, bias: bool = False) -> Dense:
    w = init.normal((d_in, d_out), scale=d_in ** -0.5)
    return Dense(w, init.zeros((d_out,)) if bias else None)


def dense_apply(p: Dense, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    y = x.to(dtype) @ p.w.to(dtype)
    if p.b is not None:
        y = y + p.b.to(dtype)
    return y


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Root-mean-square norm in float32; the output is in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings on split halves (``x[..., :D/2]``, ``x[..., D/2:]``),
    not interleaved.  ``x`` is ``[..., L, D]``, ``positions`` ``[L]``.  The
    angles are float32; ``x`` times them promotes to float32 and the result
    is cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # [L, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_init(init: Initializer, d: int, f: int, act: str) -> MLP:
    if act == "swiglu":
        return MLP(w_gate=init.normal((d, f), scale=d ** -0.5),
                   w_up=init.normal((d, f), scale=d ** -0.5),
                   w_down=init.normal((f, d), scale=f ** -0.5))
    return MLP(w_up=init.normal((d, f), scale=d ** -0.5),
               w_down=init.normal((f, d), scale=f ** -0.5))


def mlp_apply(p: MLP, x: torch.Tensor, act: str, dtype=torch.bfloat16) -> torch.Tensor:
    xb = x.to(dtype)
    if act == "swiglu":
        h = F.silu(xb @ p.w_gate.to(dtype)) * (xb @ p.w_up.to(dtype))
    else:  # jax.nn.gelu's default is the tanh form
        h = F.gelu(xb @ p.w_up.to(dtype), approximate="tanh")
    return h @ p.w_down.to(dtype)
