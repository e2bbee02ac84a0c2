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

On a ``data x model`` mesh a rank computes through its :class:`MeshShard`:
column-parallel projections on its block of output columns, row-parallel
ones summed over the model axis in float32, weights gathered over the data
axis where they are used under FSDP, and the vocab-parallel embedding;
with sequence parallelism the stream between blocks is this rank's block
of the sequence (or of the channels) and the entry and exit collectives an
all-gather and a reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import (
    Group,
    all_gather_cat,
    all_gather_cat_many,
    copy_to,
    gather_cat_replicated,
    reduce_from,
    reduce_scatter,
    split,
)

__all__ = [
    "Initializer",
    "MeshShard",
    "Dense",
    "MLP",
    "weight",
    "rmsnorm",
    "layernorm_params",
    "rope",
    "rope_tables",
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


def layernorm_params(init: Initializer, d: int) -> dict:
    """A norm's weights as the reference makes them: ``{"scale": ones(d)}``."""
    return {"scale": init.ones((d,))}


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 10_000.0):
    """``(cos, sin)`` ``[L, dim / 2]`` float32 of :func:`rope`'s angles."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=positions.device) / half)
    ang = positions.float()[..., None] * freqs  # [L, half]
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0,
         tables=None) -> torch.Tensor:
    """Rotary embeddings on split halves (``x[..., :D/2]``, ``x[..., D/2:]``),
    not interleaved.  ``x`` is ``[..., L, D]``, ``positions`` ``[L]``.  The
    angles are float32; ``x`` times them promotes to float32 and the result
    is cast back to ``x``'s dtype.  ``tables`` are :func:`rope_tables` of
    ``positions``, where the caller made them once for many layers."""
    half = x.shape[-1] // 2
    cos, sin = rope_tables(positions, x.shape[-1], theta) if tables is None else tables
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


@dataclasses.dataclass(frozen=True)
class MeshShard:
    """One rank's place on a ``data x model`` mesh, the port's counterpart
    of the reference's activation ``shard`` function (``factory.py``), for
    a rank program with explicit collectives (Megatron's pattern).

    ``data`` is FSDP's axis, ``model`` the tensor- and expert-parallel axis,
    and ``dp`` the groups the batch splits over (the batch axes the mesh
    has: ``data`` and, on the multi-pod mesh, ``pod``, the major first),
    over which the loss and the experts' aux loss are reduced.  Without sequence parallelism (``sp = 0``) the
    residual stream between blocks is replicated over ``model``: a block
    enters rank-specific compute through ``copy_to`` and leaves it through a
    float32 ``reduce_from``, so every model rank holds the same stream and,
    backward, the same gradient of it.

    With ``sp = 1`` (the reference's ``seq_axis`` with ``sp_dim=1``,
    Megatron's sequence parallelism) the stream is this rank's block of the
    sequence ``[B, Lp / model, D]``: :meth:`enter` all-gathers it (the
    gradient reduce-scattered back) and :meth:`leave` reduce-scatters the
    partial sums (the gradient all-gathered back).  ``L`` (``seq_len``) is
    padded to ``Lp``, the next multiple of ``model``, with zero rows that
    every block keeps at zero (norms of zero rows are zero, the partial sums
    are padded with zeros) and :meth:`enter` drops.  With ``sp = 2`` the
    stream is this rank's block of the channels ``[B, L, D / model]`` and
    :meth:`norm` all-reduces the sum of squares.  Decode (one token) keeps
    the stream replicated.  Weights replicated over ``model`` go through
    :meth:`rep` where a rank's own compute reads them and through
    :meth:`stream_weight` where they act on the stream, so their gradients
    are whole on every rank.

    ``anchor`` is the reference's ``attn_anchor``: where the heads divide
    the model axis and the KV heads do not, each rank attends only its own
    q heads with the KV heads they need (``attention_block_tp``).
    """

    data: Group
    model: Group
    fsdp: bool = False
    moe_pipeline: bool = False
    #: sequence parallelism: 0 off, 1 the sequence, 2 the channels
    sp: int = 0
    #: the unpadded sequence length of this call's stream (``sp = 1``)
    seq_len: Optional[int] = None
    anchor: bool = False
    #: this call's rope tables (``rope_tables``), made once for every layer
    rot: Optional[tuple] = None
    #: a block's FSDP weights gathered at its entry (:meth:`gather`), by id
    gathered: Optional[dict] = None
    #: the batch axes' groups (``factory.batch_groups``), the major first
    dp: Tuple[Group, ...] = ()

    @property
    def dp_size(self) -> int:
        """The data-parallel ranks the batch splits over."""
        return math.prod(g.size for g in self.dp)

    def unshard(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """Under FSDP the whole of ``w``'s dimension ``dim`` (sharded over
        ``data``), gathered where it is used; its gradient is reduce-scattered
        back to this rank's block.  Without FSDP ``w`` itself."""
        if not self.fsdp:
            return w
        if self.gathered is not None and id(w) in self.gathered:
            return self.gathered[id(w)]
        return all_gather_cat(w, self.data, dim)

    def gather(self, weights) -> "MeshShard":
        """Under FSDP, the shard with every ``(weight, dim)`` of ``weights``
        (one layer's) gathered over ``data`` in one collective, read by
        :meth:`unshard`; the gradients go back on one reduce-scatter."""
        if not self.fsdp or self.data.size == 1:
            return self
        ws = [w for w, _ in weights]
        got = all_gather_cat_many(ws, [d for _, d in weights], self.data)
        return dataclasses.replace(self, gathered={id(w): g for w, g in zip(ws, got)})

    @property
    def _split(self) -> bool:
        return self.sp != 0 and self.model.size > 1

    def padded_len(self, length: int) -> int:
        """The stream's padded sequence length under ``sp = 1``."""
        pm = self.model.size
        return -(-length // pm) * pm

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The stream entering this rank's own compute, whole: ``copy_to``
        (``f``), or under sequence parallelism the all-gather of the blocks
        (the padding dropped)."""
        if not self._split:
            return copy_to(x, self.model)
        if self.sp == 1:
            return all_gather_cat(x, self.model, 1)[:, : self.seq_len]
        return all_gather_cat(x, self.model, -1)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's partial sums back to the stream: the sum over
        ``model`` (``g``), or under sequence parallelism this rank's block
        of it (a reduce-scatter)."""
        if not self._split:
            return reduce_from(y, self.model)
        if self.sp == 1:
            pad = self.padded_len(y.shape[1]) - y.shape[1]
            if pad:
                y = F.pad(y, (0, 0, 0, pad))
            return reduce_scatter(y, self.model, 1)
        return reduce_scatter(y, self.model, -1)

    def enter_whole(self, x: torch.Tensor) -> torch.Tensor:
        """The stream made whole for a program that takes a replicated input
        and gives a replicated output (the experts): the gradient of each
        block is that block of the whole gradient."""
        if not self._split:
            return x
        if self.sp == 1:
            return gather_cat_replicated(x, self.model, 1)[:, : self.seq_len]
        return gather_cat_replicated(x, self.model, -1)

    def own(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of the stream of a replicated output (the
        experts'); without sequence parallelism ``y`` itself."""
        if not self._split:
            return y
        if self.sp == 1:
            pad = self.padded_len(y.shape[1]) - y.shape[1]
            if pad:
                y = F.pad(y, (0, 0, 0, pad))
            return split(y, self.model, 1)
        return split(y, self.model, -1)

    def rep(self, w: torch.Tensor) -> torch.Tensor:
        """A weight replicated over ``model`` used in this rank's own compute
        (on its heads or columns): its gradient summed over ``model``."""
        return copy_to(w, self.model)

    def stream_weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight replicated over ``model`` that acts on the stream itself
        (a norm's scale, a gate): its gradient summed over ``model`` where
        each rank holds its own part of the stream (sequence parallelism),
        else whole on every rank as the stream is."""
        return self.rep(w) if self._split else w

    def norm(self, w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
        """:func:`rmsnorm` of the stream: local rows without sequence
        parallelism or with ``sp = 1``; with ``sp = 2`` this rank's channels
        over the sum of squares of the whole row (all-reduced)."""
        if not self._split:
            return rmsnorm(w, x, eps)
        if self.sp == 1:
            return rmsnorm(self.stream_weight(w), x, eps)
        pm, m = self.model.size, self.model.rank
        d = x.shape[-1]
        xf = x.float()
        ss = copy_to(reduce_from(xf.square().sum(-1, keepdim=True), self.model), self.model)
        w_own = self.stream_weight(w)[m * d : (m + 1) * d]
        return (xf * torch.rsqrt(ss / (d * pm) + eps) * w_own.float()).to(x.dtype)

    def column(self, p: "Dense", x: torch.Tensor, dtype) -> torch.Tensor:
        """``x @ w + b`` on this rank's block of output columns (``w``
        ``(fsdp, model)``, ``b`` ``(model,)``); ``x`` has entered."""
        y = x.to(dtype) @ self.unshard(p.w, 0).to(dtype)
        if p.b is not None:
            y = y + p.b.to(dtype)
        return y

    def row(self, w: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
        """``x @ w`` with ``w``'s rows (``(model, fsdp)``) and ``x``'s columns
        this rank's block: the partial product in ``dtype``, summed over
        ``model`` in float32 (:meth:`leave`), then cast."""
        y = x.to(dtype) @ self.unshard(w, 1).to(dtype)
        return self.leave(y.float()).to(dtype)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The vocab-parallel lookup: ``table`` ``(model, fsdp)`` holds this
        rank's block of rows; it writes its own tokens' rows and zeros for
        the rest, and the sum over ``model`` (one nonzero term: exact) gives
        every rank the whole lookup (under sequence parallelism its block)."""
        t = self.unshard(table, 1)
        rows = t.shape[0]
        local = tokens.long() - self.model.rank * rows
        mine = (local >= 0) & (local < rows)
        got = torch.where(mine[..., None], t[local.clamp(0, rows - 1)].float(), 0.0)
        return self.leave(got).to(dtype)

    def mlp(self, p: "MLP", x: torch.Tensor, act: str, dtype) -> torch.Tensor:
        """:func:`mlp_apply` with ``w_gate`` and ``w_up`` column-parallel and
        ``w_down`` row-parallel, on the stream ``x``."""
        xb = self.enter(x).to(dtype)
        up = xb @ self.unshard(p.w_up, 0).to(dtype)
        if act == "swiglu":
            h = F.silu(xb @ self.unshard(p.w_gate, 0).to(dtype)) * up
        else:
            h = F.gelu(up, approximate="tanh")
        return self.row(p.w_down, h, dtype)
