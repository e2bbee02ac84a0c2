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
A mesh (data-parallel replicas, sharded weights) waits for the sharding
specs (ROADMAP queue 1 item 17).
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Dict, Optional

import torch

from ..models.factory import Model
from .checkpoint import CheckpointManager
from .data import DataConfig, synthetic_batch
from .optimizer import AdamWConfig, adamw_update, init_opt_state

__all__ = ["TrainConfig", "make_train_step", "train"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    opt: AdamWConfig = AdamWConfig()
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("training on a mesh waits for the sharding specs "
                                  "(ROADMAP queue 1 item 17)")


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None):
    """``(train_step, None)``: ``train_step(params, opt, batch) -> (params,
    opt, metrics)`` with ``metrics`` ``{"loss", "lr", "grad_norm"}`` (the
    loss and norm device scalars, read without a sync until the caller
    asks).  ``params`` is the model's :class:`~repro_torch.models.Transformer`,
    made trainable here; ``opt`` is :func:`init_opt_state` of its
    ``named_parameters()``.  The step is eager (the reference jits it)."""
    _no_mesh(mesh)
    if model.cast_params:
        raise ValueError("train float32 weights: build the model with cast_params=False "
                         "(the reference's masters stay float32)")

    def grads_of(params, weights, batch):
        loss = model.loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, list(weights.values())))

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        weights = dict(params.named_parameters())
        if tcfg.microbatches > 1:
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
            loss = loss_sum / tcfg.microbatches
            torch._foreach_div_(grad_sum, float(tcfg.microbatches))
            grads = grad_sum
        else:
            loss, grads = grads_of(params, weights, batch)
        _, opt_state, stats = adamw_update(tcfg.opt, weights, dict(zip(weights, grads)),
                                           opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return train_step, None


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
    """
    _no_mesh(mesh)
    cfg = model.cfg
    dcfg = data or DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=128,
                              seed=tcfg.seed)
    train_step, _ = make_train_step(model, tcfg)
    params = model.init_fn(torch.Generator(device=model.device).manual_seed(tcfg.seed))
    params.requires_grad_(True)
    weights = dict(params.named_parameters())
    opt = init_opt_state(weights)
    start = 0

    ckpt = None
    if tcfg.checkpoint_dir:
        ckpt = CheckpointManager(tcfg.checkpoint_dir, async_save=True)
        latest = ckpt.latest_step()
        if latest is not None:
            restored = ckpt.restore(latest, {"params": weights, "opt": opt})
            with torch.no_grad():
                torch._foreach_copy_(list(weights.values()),
                                     [restored["params"][k] for k in weights])
            opt = restored["opt"]
            start = latest
            log(f"restored checkpoint at step {latest}")

    preempted = {"flag": False}

    def _on_sigterm(signum, frame):  # preemption hook
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    metrics = {}
    try:
        for step_i in range(start, tcfg.steps):
            batch = synthetic_batch(dcfg, step_i, model.device)
            params, opt, metrics = train_step(params, opt, batch)
            if (step_i + 1) % tcfg.log_every == 0:
                log(f"step {step_i + 1}: loss {float(metrics['loss']):.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}")
            if ckpt and ((step_i + 1) % tcfg.checkpoint_every == 0 or preempted["flag"]):
                ckpt.save(step_i + 1, {"params": weights, "opt": opt})
            if preempted["flag"]:
                log(f"preemption: checkpoint saved at step {step_i + 1}; exiting")
                break
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if ckpt:
            ckpt.wait()
    return {"params": params, "opt": opt, "metrics": metrics}
