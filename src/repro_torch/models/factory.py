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
weights made trainable (``params.requires_grad_()``).

The sharding specs are the reference's rules (DESIGN.md §7) keyed by the
port's weight names: :func:`param_pspecs` (TP over ``model`` on heads, FFN
hidden and vocab; FSDP over ``data``; experts over ``model``),
:func:`cache_pspecs` (KV caches batch over the data axes, sequence over
``model``) and ``Model.input_specs`` (``meta`` tensors in place of
``ShapeDtypeStruct``).  The port keeps one module per layer where the
reference stacks each pattern position over depth, so a port spec is the
reference's spec of the same leaf without the stacked dimension.  They are
pure functions of shapes, for all ten rows (``init_params`` runs on
``meta``).

``build_model(cfg, sharding, mesh)`` on a ``[pod x] data x model`` mesh
(``launch.mesh.make_local_mesh``, ``process_mesh``, or the dry-run's
``comm.AbstractMesh``) gives callables that run one rank's program when
called inside the mesh's rank function (``mesh.run``): the rank's weights
(``Model.shard_params``), its rows of the batch (``Model.rank_rows``) and
its blocks of the caches, with explicit collectives over the rank's groups
(:class:`~.layers.MeshShard`).  The batch splits over the batch axes the
mesh has (``ShardingConfig.batch_axes``, ``pod`` major); the ``pod`` axis
is data-parallel only, as the reference's: weights are whole across pods
(FSDP and ZeRO-1 split over ``data`` alone), so the loss and every
gradient are also summed over ``pod``.  ``loss_fn`` returns the global
loss on every rank, its gradient the rank's share (on CUDA run its
backward under ``torch.autograd.set_multithreading_enabled(False)``, as
``make_train_step`` does: autograd's one device thread would otherwise
block in one rank's collective); ``prefill_fn`` and ``decode_fn`` return
the rank's block of vocab columns of the last position's logits
``[B_loc, V_pad / model]``.  All ten rows run on a mesh, trained and
served, every block kind as one rank's program (``models/transformer.py``),
the context of a vision or audio row the rank's rows of it.
``seq_axis="model"`` is sequence parallelism (``MeshShard.sp``): with
``sp_dim=1`` the residual stream between blocks is the rank's block of the
sequence, a prompt whose length the model axis does not divide padded with
zero rows that every block keeps at zero; with ``sp_dim=2`` its block of
the channels.  Decode's one token keeps the stream replicated.  Sequence
parallelism runs over the model axis only (the reference's callers name
no other axis).  ``attn_anchor`` gives each rank its own q heads where the
heads divide the model axis and the KV heads do not
(``attention_block_tp``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..comm import current_rank, reduce_from
from ..comm.abstract import AbstractMesh
from ..comm.group import Group, LocalMesh, ProcessMesh
from ..comm.spec import PartitionSpec as P
from ..comm.spec import gather_whole, shard_of
from ..configs.base import ArchConfig, ShapeSpec, ShardingConfig
from ..device import resolve_device
from .attention import CACHE_DTYPE
from .layers import MeshShard, weight
from .transformer import (
    Transformer,
    _check_supported,
    cache_buffer_len,
    cast_weights,
    check_weights,
    encode,
    init_caches,
    init_params,
)

__all__ = ["Model", "build_model", "chunked_ce_loss", "context_len", "param_pspecs",
           "cache_pspecs", "mesh_axes", "rank_axes", "batch_groups", "row_block"]

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


def _ce_chunk_tp(hc: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 pad: Optional[torch.Tensor], rs: MeshShard) -> torch.Tensor:
    """:func:`_ce_chunk` on this rank's block of vocab columns: the max by
    an all-gather (no gradient: it cancels), the sum of exponentials and
    the gold logit (from its owning rank) summed over the model axis."""
    logits = hc.float() @ head.float()
    if pad is not None:
        logits = logits + pad
    mx = logits.detach().amax(-1)
    if rs.model.size > 1:
        mx = rs.model.all_gather(mx).amax(0)
    lse = mx + torch.log(reduce_from(torch.exp(logits - mx[..., None]).sum(-1), rs.model))
    cols = head.shape[1]
    local = labels.long() - rs.model.rank * cols
    mine = (local >= 0) & (local < cols)
    gold = torch.where(mine, logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0], 0.0)
    return (lse - reduce_from(gold, rs.model)).sum()


def chunked_ce_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, *,
                    chunk: int = CE_CHUNK, vocab_size: int = 0,
                    rs: Optional[MeshShard] = None) -> torch.Tensor:
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

    With ``rs`` (one rank of a mesh) ``h`` is the rank's rows, whole, as
    they entered the rank's compute (``MeshShard.enter``), and ``head`` its
    block of vocab columns: the logits are vocab-parallel and the result is
    the rank's share of the global mean, its sum over the batch axes divided
    by the global count.
    """
    b, s, _ = h.shape
    v_pad, lo, count = head.shape[1], 0, b * s
    if rs is not None:
        lo, count = rs.model.rank * v_pad, count * rs.dp_size
    pad = None
    if vocab_size and lo + v_pad > vocab_size:
        pad = torch.where(torch.arange(lo, lo + v_pad, device=h.device) < vocab_size, 0.0,
                          -1e30)
    grad = torch.is_grad_enabled() and (h.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0 : c0 + chunk], head, labels[:, c0 : c0 + chunk], pad)
        if rs is not None:
            fn, args = _ce_chunk_tp, args + (rs,)
        else:
            fn = _ce_chunk
        total = total + (checkpoint(fn, *args, use_reentrant=False) if grad else fn(*args))
    return total / count


def context_len(cfg: ArchConfig) -> Tuple[int, bool]:
    """``(context positions, whether prefill needs a context)``: a vision
    row's image tokens, an audio row's encoder frames, else none."""
    if cfg.family == "vlm":
        return cfg.num_image_tokens, True
    if cfg.family == "audio":
        return cfg.encoder_context, True
    return 0, False


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _named_shapes(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` of a :class:`Transformer` (its ``named_parameters``)
    or of a mapping of names to tensors (or anything with a ``shape``)."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    return list(tree.items())


def param_pspecs(params, cfg: ArchConfig, sh: ShardingConfig) -> Dict[str, P]:
    """``{weight name: PartitionSpec}`` for the port's weights (a
    :class:`Transformer`, on ``meta`` too, or a name -> tensor mapping): the
    reference's rules (``repro/models/factory.py:param_pspecs``) on the
    weight's path, ``blocks.3.attn.wq.w`` read as ``blocks/3/attn/wq/w``."""
    mdl = sh.model_axis
    fsdp = "data" if sh.fsdp else None

    def rule(path: str, ndim: int) -> P:
        def pad(spec):
            return P(*([None] * (ndim - len(spec)) + list(spec)))

        leaf = path.rsplit("/", 1)[-1]
        if leaf == "embed":
            return pad([mdl, fsdp])
        if leaf == "lm_head":
            return pad([fsdp, mdl])
        if leaf == "router":
            return pad([fsdp, None])
        if "ffn/" in path and leaf in ("w_gate", "w_up", "w_down") and cfg.num_experts:
            ep = cfg.moe_sharding == "ep"
            if leaf in ("w_gate", "w_up"):  # [E, D, F]
                return pad([mdl, fsdp, None] if ep else [None, fsdp, mdl])
            return pad([mdl, None, fsdp] if ep else [None, mdl, fsdp])  # [E, F, D]
        if leaf in ("w_gate", "w_up"):  # dense MLP [D, F]
            return pad([fsdp, mdl])
        if leaf == "w_down":  # [F, D]
            return pad([mdl, fsdp])
        if "channel/wv" in path:  # rwkv channel down-proj [F, D]
            return pad([mdl, fsdp])
        if path.endswith("wo/w") or path.endswith("w_out/w"):
            return pad([mdl, fsdp])
        if path.endswith("/w") and any(
            f"/{n}/" in path
            for n in ("wq", "wk", "wv", "wg", "wr", "w_in", "w_gate", "lru_a", "lru_x")
        ):  # [D_in, D_out]: TP on the output dim
            return pad([fsdp, mdl])
        if path.endswith("/b"):
            return pad([mdl])
        if leaf == "conv_w":  # [4, D]
            return pad([None, mdl])
        if leaf in ("lambda_raw", "conv_b"):
            return pad([mdl])
        if leaf in ("w_lora_a", "w_lora_b"):
            return pad([None, None])
        return P(*([None] * ndim))  # norms, mixes, gates, u_bonus: replicated

    return {name: rule(name.replace(".", "/"), len(leaf.shape))
            for name, leaf in _named_shapes(params)}


def cache_pspecs(caches, cfg: ArchConfig, sh: ShardingConfig) -> List[Dict[str, P]]:
    """One dict of specs per layer, shaped like ``caches``: KV caches batch
    over the data axes and sequence over ``model``, ``slot_pos`` whole,
    recurrent states channel over ``model`` (the reference's
    ``cache_pspecs``)."""
    mdl, dp = sh.model_axis, sh.batch_axes

    def rule(name: str, nd: int) -> P:
        def pad(spec):
            spec = list(spec)[:nd]
            return P(*(spec + [None] * (nd - len(spec))))

        if name in ("k", "v"):  # [B, Hkv, S, hd]
            return pad([dp, None, mdl, None])
        if name in ("xk", "xv"):
            return pad([dp, None, None, None])
        if name == "slot_pos":
            return pad([None])
        if name == "wkv":  # [B, H, dk, dv]
            return pad([dp, None, None, mdl])
        if name in ("x_prev_t", "x_prev_c", "h"):  # [B, D]
            return pad([dp, mdl])
        if name == "conv":  # [B, 3, D]
            return pad([dp, None, mdl])
        return P(*([None] * nd))

    return [{k: rule(k, len(v.shape)) for k, v in layer.items()} for layer in caches]


def mesh_axes(mesh, sh: ShardingConfig) -> Dict[str, int]:
    """The sizes of a ``[pod x] data x model`` mesh's axes, by the names the
    specs use."""
    return {"pod": getattr(mesh, "pod_size", 1), "data": mesh.data_size,
            sh.model_axis: mesh.iter_size}


def rank_axes(sh: ShardingConfig) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """This rank's groups and coordinates on the mesh's axes, by the names
    the specs use (inside ``mesh.run``)."""
    ctx = current_rank()
    groups = {"pod": ctx.pod, "data": ctx.data, sh.model_axis: ctx.model}
    return groups, {a: g.rank for a, g in groups.items()}


def batch_groups(sh: ShardingConfig) -> Tuple[Group, ...]:
    """This rank's groups on the batch axes the mesh has (``sh.batch_axes``
    in their order, the major first; axes of one rank left out), inside
    ``mesh.run``: the batch splits over them, and the loss and the
    gradients of whole weights are summed over them."""
    groups, _ = rank_axes(sh)
    return tuple(groups[a] for a in sh.batch_axes
                 if a in groups and a != sh.model_axis and groups[a].size > 1)


def row_block(rows: int, groups) -> Tuple[int, int]:
    """``(first row, rows)`` of this rank's block of ``rows`` split over
    ``groups`` (:func:`batch_groups`), the first group major."""
    n, j = 1, 0
    for g in groups:
        n, j = n * g.size, j * g.size + g.rank
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} data-parallel ranks")
    return j * (rows // n), rows // n


def _check_mesh(cfg: ArchConfig, sh: ShardingConfig, mesh) -> None:
    if not isinstance(mesh, (LocalMesh, ProcessMesh, AbstractMesh)):
        raise TypeError(f"a mesh is a LocalMesh, a ProcessMesh (launch.mesh) or an "
                        f"AbstractMesh, not {mesh!r}")
    if sh.seq_axis not in (None, sh.model_axis):
        raise ValueError(f"sequence parallelism runs over the model axis {sh.model_axis!r}, "
                         f"not {sh.seq_axis!r}")
    if sh.sp_dim not in (1, 2):
        raise ValueError(f"sp_dim is 1 (the sequence) or 2 (the channels), not {sh.sp_dim}")
    if sh.seq_axis is not None and sh.sp_dim == 2 and cfg.d_model % mesh.iter_size:
        raise ValueError(f"sp_dim=2 splits {cfg.d_model} channels over {mesh.iter_size} ranks")


# ---------------------------------------------------------------------------
# Model bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    sharding: ShardingConfig
    mesh: Optional[Any]
    device: torch.device
    dtype: torch.dtype
    cast_params: bool
    cache_dtype: torch.dtype
    init_fn: Callable
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_caches_fn: Callable

    def param_specs(self, params_or_shapes) -> Dict[str, P]:
        return param_pspecs(params_or_shapes, self.cfg, self.sharding)

    def cache_specs(self, cache_shapes) -> List[Dict[str, P]]:
        return cache_pspecs(cache_shapes, self.cfg, self.sharding)

    def abstract_params(self) -> Transformer:
        """The weights' shapes and dtypes on ``meta`` (no memory)."""
        return init_params(self.cfg, None, device=torch.device("meta"),
                           dtype=self.dtype if self.cast_params else None)

    def input_specs(self, shape: ShapeSpec):
        """``meta`` tensors standing in for one shape cell's inputs, and their
        PartitionSpecs (the reference's ``input_specs``)."""
        cfg = self.cfg
        dp = self.sharding.batch_axes
        meta = torch.device("meta")
        b, s = shape.global_batch, shape.seq_len
        structs: Dict[str, Any] = {}
        specs: Dict[str, Any] = {}
        ctx_len, ctx_needed = context_len(cfg)
        if shape.kind in ("train", "prefill"):
            structs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=meta)
            specs["tokens"] = P(dp, None)
        else:  # decode
            structs["tokens"] = torch.empty((b, 1), dtype=torch.int32, device=meta)
            specs["tokens"] = P(dp, None)
            structs["pos"] = torch.empty((), dtype=torch.int32, device=meta)
            specs["pos"] = P()
            structs["caches"] = init_caches(cfg, b, s, context_len=ctx_len, device=meta,
                                            cache_dtype=self.cache_dtype)
            specs["caches"] = self.cache_specs(structs["caches"])
        if ctx_needed and shape.kind != "decode":
            structs["context"] = torch.empty((b, ctx_len, cfg.d_model), dtype=torch.bfloat16,
                                             device=meta)
            specs["context"] = P(dp, None, None)
        return structs, specs

    # ---- one rank of the mesh ------------------------------------------
    def shard_params(self, params: Transformer) -> Transformer:
        """This rank's weights (call it inside the mesh's rank function):
        each weight's block under :meth:`param_specs` at the rank's
        coordinates, cut from the whole ``params`` and cloned, so the whole
        weights can be dropped."""
        check_weights(params, self.cfg)
        groups, index = rank_axes(self.sharding)
        sizes = {a: g.size for a, g in groups.items()}
        specs = self.param_specs(params)
        return _rebuild(self, {name: shard_of(w.detach(), specs[name], sizes, index).clone()
                               for name, w in params.named_parameters()})

    def gather_params(self, shard: Transformer) -> Transformer:
        """The whole weights from every rank's :meth:`shard_params` (a
        collective: every rank calls it)."""
        groups, _ = rank_axes(self.sharding)
        specs = self.param_specs(self.abstract_params())
        return _rebuild(self, {name: gather_whole(w.detach(), specs[name], groups)
                               for name, w in shard.named_parameters()})

    def rank_shard(self) -> MeshShard:
        """This rank's :class:`~.layers.MeshShard` (inside ``mesh.run``)."""
        groups, _ = rank_axes(self.sharding)
        sh = self.sharding
        return MeshShard(groups["data"], groups[sh.model_axis], fsdp=sh.fsdp,
                         moe_pipeline=sh.moe_pipeline,
                         sp=0 if sh.seq_axis is None else sh.sp_dim, anchor=sh.attn_anchor,
                         dp=batch_groups(sh))

    def rank_rows(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (inside ``mesh.run``): every
        entry's block of dimension 0 over the batch axes (views)."""
        dp = batch_groups(self.sharding)
        lo, n = row_block(batch["tokens"].shape[0], dp)
        return {k: v[lo : lo + n] for k, v in batch.items()}


def _rebuild(model: Model, tensors: Mapping[str, torch.Tensor]) -> Transformer:
    """A :class:`Transformer` of ``model``'s layout holding ``tensors`` by name."""
    out = model.abstract_params()
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(owner) if owner else out, leaf, weight(t))
    return out


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
    passes ``"cpu"``, or ``"meta"`` for a shape-only run; raises without a
    card).

    ``dtype`` is the compute dtype.  ``cast_params=True`` is the reference's
    ``cast_params``: the forward reads every float32 weight of two or more
    dimensions cast to ``dtype`` (:func:`~.transformer.cast_weights`; the
    gradients reach the float32 weights through the cast), so the weights read in float32
    elsewhere (the LM head's logits, the router, RG-LRU's gates, RWKV's
    decay LoRA) are read rounded, as the reference's cast rounds them; the
    loss reads its head as given, as the reference's does.  ``init_fn`` then
    stores those weights in ``dtype`` as it draws them (1-D weights stay
    float32): no float32 copy, the same forward, and a trainer refuses
    them.  Otherwise each weight is cast to ``dtype`` where it is used.  The
    default stays ``False`` with a mesh too, where the reference's ``None``
    casts iff a mesh is given: against the reference's own meshed bf16 run
    at that default, the port's uncast gradients come closer than its cast
    ones, whose bf16 gathers sum the gradients over the data axis in bf16
    (``tests/test_torch_mesh_lm.py``).
    The callables take only weights drawn for ``cfg`` (the weights carry
    their config).  ``cache_dtype`` stores the self-attention keys and
    values (the reference's bf16 by default, whatever ``dtype`` is).
    ``sharding`` gives the loss its ``remat`` and ``attn_chunk`` (the
    reference's defaults, ``"full"`` and 1024, without one), and a mesh its
    axes, FSDP and the experts' pipeline.

    With ``mesh`` (a ``LocalMesh``, ``ProcessMesh`` or ``AbstractMesh`` of
    ``[pod x] data x model`` ranks; its device is the model's) ``init_fn``
    still draws the whole weights, and the callables are one rank's
    program: call them inside ``mesh.run`` on the rank's weights
    (``Model.shard_params``) and rows (``Model.rank_rows``).
    """
    _check_supported(cfg)
    sh = sharding or ShardingConfig()
    if mesh is not None:
        _check_mesh(cfg, sh, mesh)
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"the mesh is on {mesh.device}, not {device}")
        dev = mesh.device
    else:
        # ``meta``: the dry-run's shape-only model (one device, nothing allocated)
        dev = (torch.device("meta") if device is not None and torch.device(device).type == "meta"
               else resolve_device(device))

    def rank() -> Optional[MeshShard]:
        return None if mesh is None else model.rank_shard()

    def weights(params):
        """The weights as the forward reads them."""
        return cast_weights(params, dtype) if cast_params else params

    def init_fn(generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the model on {dev}")
        return init_params(cfg, generator, device=dev, dtype=dtype if cast_params else None)

    def _context_of(params, batch, rs):
        ctx = batch.get("context")
        if ctx is None:
            return None
        ctx = ctx.to(dev)
        if cfg.family == "audio":  # frame embeddings -> encoder -> the cross context
            return encode(params, cfg, ctx, dtype=dtype, attn_chunk=sh.attn_chunk, rs=rs)
        return ctx.to(dtype)

    def loss_fn(params, batch):
        """``CE(h[:, :-1] @ head, tokens[:, 1:]) + 0.01 * aux``: a float32
        scalar, differentiable in the weights that require a gradient.  On
        a mesh ``batch`` holds the rank's rows; the value is the global
        loss, its gradient the rank's share (summed over the data axis, the
        gradient of the global loss)."""
        check_weights(params, cfg)
        rs = rank()
        tokens = batch["tokens"].to(dev)
        h, _, aux = weights(params)(tokens, mode="train",
                                    context=_context_of(params, batch, rs), dtype=dtype,
                                    remat=sh.remat, attn_chunk=sh.attn_chunk,
                                    return_hidden=True, rs=rs)
        head = params.embed.T if params.lm_head is None else params.lm_head
        if rs is None:
            loss = chunked_ce_loss(h[:, :-1], head, tokens[:, 1:], vocab_size=cfg.vocab_size)
            return loss + 0.01 * aux
        head = (rs.unshard(params.embed, 1).T if params.lm_head is None
                else rs.unshard(params.lm_head, 0))
        rs = dataclasses.replace(rs, seq_len=tokens.shape[1])
        loss = chunked_ce_loss(rs.enter(h)[:, :-1], head, tokens[:, 1:],
                               vocab_size=cfg.vocab_size, rs=rs)
        for g in rs.dp:
            loss = reduce_from(loss, g)
        return loss + 0.01 * aux

    @torch.no_grad()
    def prefill_fn(params, batch):
        check_weights(params, cfg)
        tokens = batch["tokens"].to(dev)
        s_buf = cache_buffer_len(cfg, tokens.shape[1])
        rs = rank()
        logits, caches, _ = weights(params)(tokens, mode="prefill",
                                            context=_context_of(params, batch, rs), dtype=dtype,
                                            s_buf=s_buf, cache_dtype=cache_dtype, rs=rs)
        return logits[:, -1].clone(), caches  # the clone lets the [B, L, V] logits go

    @torch.no_grad()
    def decode_fn(params, batch):
        check_weights(params, cfg)
        logits, caches, _ = weights(params)(batch["tokens"].to(dev), mode="decode",
                                            caches=batch["caches"], pos=batch["pos"],
                                            dtype=dtype, rs=rank())
        return logits[:, -1].clone(), caches

    def init_caches_fn(batch_size: int, seq_len: int, context_len: int = 0):
        """Empty caches for ``batch_size`` sequences; on a mesh this rank's
        blocks of them (``cache_pspecs``)."""
        pm = 0
        if mesh is not None:
            rs = rank()
            batch_size, pm = row_block(batch_size, rs.dp)[1], rs.model.size
        return init_caches(cfg, batch_size, seq_len, context_len=context_len, device=dev,
                           cache_dtype=cache_dtype, model_size=pm)

    model = Model(cfg=cfg, sharding=sh, device=dev, dtype=dtype, cast_params=cast_params,
                  cache_dtype=cache_dtype, init_fn=init_fn, loss_fn=loss_fn,
                  prefill_fn=prefill_fn, decode_fn=decode_fn, init_caches_fn=init_caches_fn,
                  mesh=mesh)
    return model
