"""Training loop: the train-step builder and the fault-tolerant driver.

Counterpart of ``repro/train/train_loop.py``.  ``make_train_step`` returns
``train_step(params, opt, batch) -> (params, opt, metrics)``: the loss and
its gradients by ``torch.autograd`` over ``Model.loss_fn``, then one
``adamw_update``, the weights and the state updated in place (the
reference's step donates them).  The step is eager: there is no ``jit``.
With ``microbatches > 1`` the batch's rows split into that many slices whose
float32 gradients and losses are summed and divided by their count, as the
reference's ``lax.scan`` accumulates them.  ``train`` adds init-or-restore,
periodic checkpoints (asynchronous), preemption handling (SIGTERM -> save
-> exit) and deterministic resume: the token stream is a function of the
step.

The int8 gradient ring (``comm.compress.compressed_ring_reduce_scatter``)
is a library function here as in the reference, whose step never calls it.

On a ``[pod x] data x model`` mesh (a model built with ``mesh=``) the
step is one rank's: call it inside ``mesh.run`` on the rank's weights
(``Model.shard_params``) and state (:func:`rank_opt_state`) with the
global batch, of which the rank takes its rows over the batch axes
(``Model.rank_rows``).  Gradients land in the weights' layout, the
reference's ``grad_constraint``: summed over ``data`` where a weight is
whole on it, reduce-scattered (by FSDP's gather) where it is split, and
summed over ``pod`` as well (the weights are whole across pods).  The norm
adds each block's squares over the axes its weight is split on.  ZeRO-1:
each data rank updates its block of ``m``, ``v`` and the weight, then the
updated blocks are all-gathered over ``data``; every pod does the same
update.  Each rank runs its backward on its own thread
(``torch.autograd.set_multithreading_enabled(False)``): on CUDA autograd
would otherwise run every rank's backward on one device thread, where a
rank waiting in a collective's backward blocks the others.  ``train(...,
mesh)`` runs the loop on every rank, saves checkpoints of the whole
weights and state from rank ``(0, 0, 0)``, restores each rank's blocks, and
returns the whole weights and state.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..comm.spec import Placement, gather_whole, used_axes
from ..models.factory import Model, batch_groups, rank_axes
from .checkpoint import CheckpointManager
from .data import DataConfig, synthetic_batch
from .optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    opt_state_pspecs,
    sharded_global_norm,
)

__all__ = ["TrainConfig", "make_train_step", "train", "rank_opt_state", "gather_opt_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    opt: AdamWConfig = AdamWConfig()
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0


def _mesh_of(model: Model, mesh):
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("build the model on the mesh it trains on: build_model(cfg, "
                         "sharding, mesh)")
    return model.mesh


def _specs(model: Model) -> Tuple[dict, dict]:
    """``(weight specs, state specs)`` of a model on its mesh."""
    shapes = dict(model.abstract_params().named_parameters())
    pspecs = model.param_specs(shapes)
    ospecs = opt_state_pspecs(pspecs, shapes, zero1=model.sharding.zero1,
                              data_size=model.mesh.data_size)
    return pspecs, ospecs


def _zero1_dims(pspecs: dict, ospecs: dict) -> Dict[str, Optional[int]]:
    """The dimension ZeRO-1 splits over ``data`` for each weight (None: none)."""
    out = {}
    for k, spec in pspecs.items():
        o = ospecs["m"][k]
        out[k] = next((d for d, (a, b) in enumerate(zip(spec, o)) if a != b), None)
    return out


def _zero1_block(x: torch.Tensor, dim: Optional[int], data) -> torch.Tensor:
    """This data rank's block of ``x`` along ZeRO-1's ``dim`` (a view)."""
    if dim is None or data.size == 1:
        return x
    n = x.shape[dim] // data.size
    return x.narrow(dim, data.rank * n, n)


def rank_opt_state(model: Model, params) -> dict:
    """This rank's zero AdamW state (inside ``mesh.run``), as
    :func:`~.optimizer.opt_state_pspecs` lays it out."""
    pspecs, ospecs = _specs(model)
    dims = _zero1_dims(pspecs, ospecs)
    data = rank_axes(model.sharding)[0]["data"]
    return init_opt_state({k: _zero1_block(p, dims[k], data)
                           for k, p in params.named_parameters()})


def gather_opt_state(model: Model, state: dict) -> dict:
    """The whole AdamW state from every rank's blocks (a collective)."""
    pspecs, ospecs = _specs(model)
    groups, _ = rank_axes(model.sharding)
    return {kind: {k: gather_whole(v, ospecs[kind][k], groups) for k, v in state[kind].items()}
            for kind in ("m", "v")} | {"step": state["step"].clone()}


#: bytes of one flat all-reduce of :func:`_sum_over` (the gradients go in buckets)
SUM_BUCKET_BYTES = 1 << 28


def _sum_over(group, tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over ``group`` in place, in flat all-reduces of at
    most :data:`SUM_BUCKET_BYTES` (a larger tensor alone)."""
    if group.size == 1 or not tensors:
        return
    bucket, nbytes = [], 0
    for t in tensors + [None]:
        if bucket and (t is None or nbytes + t.numel() * t.element_size() > SUM_BUCKET_BYTES):
            flat = group.all_reduce_sum(torch.cat([b.reshape(-1) for b in bucket]))
            torch._foreach_copy_(bucket, [f.view_as(b) for f, b in
                                          zip(flat.split([b.numel() for b in bucket]), bucket)])
            del flat
            bucket, nbytes = [], 0
        if t is not None:
            bucket.append(t)
            nbytes += t.numel() * t.element_size()


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None):
    """``(train_step, shardings)``: ``train_step(params, opt, batch) ->
    (params, opt, metrics)`` with ``metrics`` ``{"loss", "lr", "grad_norm"}`` (the
    loss and norm device scalars, read without a sync until the caller
    asks).  ``params`` is the model's :class:`~repro_torch.models.Transformer`,
    made trainable here; ``opt`` is :func:`init_opt_state` of its
    ``named_parameters()``.  The step is eager (the reference jits it).
    ``shardings`` is None on one device; on the model's mesh
    ``{"params": weight specs, "opt": state specs}``, and the step is one
    rank's (see the module docstring)."""
    mesh = _mesh_of(model, mesh)
    if model.cast_params:
        raise ValueError("train float32 weights: build the model with cast_params=False "
                         "(the reference's masters stay float32)")

    def grads_of(params, weights, batch):
        loss = model.loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, list(weights.values())))

    def loss_and_grads(params, weights, batch):
        if tcfg.microbatches == 1:
            return grads_of(params, weights, batch)
        gb = batch["tokens"].shape[0]
        if gb % tcfg.microbatches:
            raise ValueError(f"a batch of {gb} rows does not split into "
                             f"{tcfg.microbatches} microbatches")
        mb = gb // tcfg.microbatches
        loss_sum, grad_sum = None, None
        for i in range(tcfg.microbatches):
            micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
            loss, grads = grads_of(params, weights, micro)
            if grad_sum is None:  # float32, as the weights are
                loss_sum, grad_sum = loss, grads
            else:
                loss_sum = loss_sum + loss
                torch._foreach_add_(grad_sum, grads)
            del grads
        torch._foreach_div_(grad_sum, float(tcfg.microbatches))
        return loss_sum / tcfg.microbatches, grad_sum

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        weights = dict(params.named_parameters())
        loss, grads = loss_and_grads(params, weights, batch)
        _, opt_state, stats = adamw_update(tcfg.opt, weights, dict(zip(weights, grads)),
                                           opt_state)
        return params, opt_state, {"loss": loss, **stats}

    if mesh is None:
        return train_step, None

    pspecs, ospecs = _specs(model)
    dims = _zero1_dims(pspecs, ospecs)

    if mesh.data_size > 1 and "data" not in model.sharding.batch_axes:
        raise ValueError("a mesh trains with the batch split over its data axis: put 'data' "
                         "in ShardingConfig.batch_axes")

    def mesh_step(params, opt_state, batch):
        groups, _ = rank_axes(model.sharding)
        data = groups["data"]
        # the batch axes other than data: the gradients of every weight are
        # summed over them (the weights are whole across pods)
        others = [g for g in batch_groups(model.sharding) if g is not data]
        rows = model.rank_rows(batch)
        params.requires_grad_(True)
        weights = dict(params.named_parameters())
        with torch.autograd.set_multithreading_enabled(False):
            loss, grads = loss_and_grads(params, weights, rows)
        grads = dict(zip(weights, grads))
        _sum_over(data, [g for k, g in grads.items() if "data" not in used_axes(pspecs[k])])
        for g in others:
            _sum_over(g, list(grads.values()))
        norm = sharded_global_norm(grads, pspecs, groups)
        blocks = {k: _zero1_block(p, dims[k], data) for k, p in weights.items()}
        _, opt_state, stats = adamw_update(
            tcfg.opt, blocks, {k: _zero1_block(g, dims[k], data) for k, g in grads.items()},
            opt_state, norm=norm)
        with torch.no_grad():
            for k, d in dims.items():
                if d is not None and data.size > 1:
                    weights[k].copy_(torch.cat(list(data.all_gather(
                        blocks[k].contiguous()).unbind(0)), d))
        return params, opt_state, {"loss": loss, **stats}

    return mesh_step, {"params": pspecs, "opt": ospecs}


def train(model: Model, tcfg: TrainConfig, mesh=None, *, log: Callable[[str], None] = print,
          data: Optional[DataConfig] = None) -> Dict[str, Any]:
    """Driver: init-or-restore, the step loop, periodic and preemption
    checkpoints.  Returns ``{"params", "opt", "metrics"}`` (the last step's).

    Weights come from ``model.init_fn`` seeded with ``tcfg.seed`` on the
    model's device; a checkpoint in ``tcfg.checkpoint_dir`` overrides them
    and the step count.  ``data`` is the token stream (the reference's
    driver-scale default, 2 sequences of 128 tokens from ``tcfg.seed``,
    without one).  Every ``log_every`` steps it logs the loss, the learning
    rate and the gradient norm; every ``checkpoint_every`` steps, and after
    the step in which SIGTERM arrived, it saves ``{"params", "opt"}`` (the
    write runs on the checkpoint's writer thread), and after SIGTERM it
    stops.  The SIGTERM hook needs the main thread, as ``signal`` does.

    On the model's mesh every rank runs the loop on its blocks of the
    weights and state; the ranks agree after each step whether SIGTERM
    came, a checkpoint is gathered whole and saved by rank (0, 0, 0), a
    restore gives each rank its blocks, and the result is the whole
    weights and state.
    """
    mesh = _mesh_of(model, mesh)
    cfg = model.cfg
    dcfg = data or DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=128,
                              seed=tcfg.seed)
    train_step, _ = make_train_step(model, tcfg)
    whole = [model.init_fn(torch.Generator(device=model.device).manual_seed(tcfg.seed))]
    ckpt = latest = None
    if tcfg.checkpoint_dir:
        ckpt = CheckpointManager(tcfg.checkpoint_dir, async_save=True)
        latest = ckpt.latest_step()

    preempted = {"flag": False}

    def _on_sigterm(signum, frame):  # preemption hook
        preempted["flag"] = True

    def loop(params, opt, start, save, stop_now, writer: bool):
        metrics = {}
        for step_i in range(start, tcfg.steps):
            batch = synthetic_batch(dcfg, step_i, model.device)
            params, opt, metrics = train_step(params, opt, batch)
            if writer and (step_i + 1) % tcfg.log_every == 0:
                log(f"step {step_i + 1}: loss {float(metrics['loss']):.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}")
            stop = stop_now()
            if ckpt and ((step_i + 1) % tcfg.checkpoint_every == 0 or stop):
                save(step_i + 1, params, opt)
            if stop:
                if writer:
                    log(f"preemption: checkpoint saved at step {step_i + 1}; exiting")
                break
        return params, opt, metrics

    def single():
        params = whole.pop()
        params.requires_grad_(True)
        weights = dict(params.named_parameters())
        opt, start = init_opt_state(weights), 0
        if latest is not None:
            restored = ckpt.restore(latest, {"params": weights, "opt": opt})
            with torch.no_grad():
                torch._foreach_copy_(list(weights.values()),
                                     [restored["params"][k] for k in weights])
            opt, start = restored["opt"], latest
            log(f"restored checkpoint at step {latest}")

        def save(step, params, opt):
            ckpt.save(step, {"params": dict(params.named_parameters()), "opt": opt})

        params, opt, metrics = loop(params, opt, start, save, lambda: preempted["flag"], True)
        return {"params": params, "opt": opt, "metrics": metrics}

    def on_rank(ctx):
        params = model.shard_params(whole[0])
        ctx.data.barrier()
        ctx.model.barrier()
        ctx.pod.barrier()  # every rank holds its blocks: the whole weights may go
        writer = ctx.data.rank == 0 and ctx.model.rank == 0 and ctx.pod.rank == 0
        if writer:
            whole.clear()
        weights = dict(params.named_parameters())
        opt, start = rank_opt_state(model, params), 0
        if latest is not None:
            pspecs, ospecs = _specs(model)
            groups, index = rank_axes(model.sharding)
            sizes = {a: g.size for a, g in groups.items()}

            def place(specs):
                return {k: Placement(spec, sizes, index) for k, spec in specs.items()}

            restored = ckpt.restore(latest, {"params": weights, "opt": opt},
                                    shardings={"params": place(pspecs),
                                               "opt": {"m": place(ospecs["m"]),
                                                       "v": place(ospecs["v"])}})
            with torch.no_grad():
                torch._foreach_copy_(list(weights.values()),
                                     [restored["params"][k] for k in weights])
            opt, start = restored["opt"], latest
            if writer:
                log(f"restored checkpoint at step {latest}")

        def save(step, params, opt):
            p, o = model.gather_params(params), gather_opt_state(model, opt)
            if writer:
                ckpt.save(step, {"params": dict(p.named_parameters()), "opt": o})

        def stop_now() -> bool:  # every rank stops after the same step
            flag = torch.tensor([float(preempted["flag"])], device=model.device)
            for g in (ctx.data, ctx.model, ctx.pod):
                if g.size > 1:
                    flag = g.all_reduce_sum(flag)
            return bool(flag.item() > 0)

        params, opt, metrics = loop(params, opt, start, save, stop_now, writer)
        p, o = model.gather_params(params), gather_opt_state(model, opt)
        return {"params": p, "opt": o, "metrics": metrics} if writer else None

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        return single() if mesh is None else mesh.run(on_rank)[0]
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if ckpt:
            ckpt.wait()

