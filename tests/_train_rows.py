"""The reduced rows' train-mode loss on both sides, shared by
tests/test_torch_train.py (float32) and tests/test_torch_train_bf16.py:
the reference's weights (random, from a key; biases and the cross gates,
zero at init, drawn from a seed), a batch of the training stream (and a
context for the vision and audio rows), the reference's loss and gradients
by ``jax.value_and_grad`` under ``remat="full"`` (once per row and dtype),
and the port's on the same weights (``from_reference_params``; gradients by
``torch.autograd``, named as ``from_reference_named`` names the
reference's).  The expert rows run at capacity factor 0.5, where every
expert's capacity (32 slots) is half its average load, so tokens drop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import ShardingConfig as RefShardingConfig
from repro.models import build_model as ref_build_model
from repro_torch.configs import ShardingConfig, get_arch
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_named, from_reference_params
from repro_torch.models.factory import context_len
from repro_torch.train.data import DataConfig, synthetic_batch

ROWS = ["smollm-360m", "qwen1.5-0.5b", "internlm2-1.8b", "granite-3-8b", "phi3.5-moe-42b-a6.6b",
        "mixtral-8x22b", "llama-3.2-vision-90b", "whisper-base", "rwkv6-3b", "recurrentgemma-2b"]
B, S = 2, 64
DROP_FACTOR = 0.5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the bf16 rule: a gradient leaf's distance from float32 at most LEAF_RATIO
#: times the reference's own bf16 distance, plus LEAF_FLOOR of the leaf's norm
LEAF_RATIO, LEAF_FLOOR = 2.0, 1e-3

_REF = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Run a test on one intra-op thread: these models' ops are small, so one
    thread is faster than many, and a test worker that shares the host's
    cores with other workers is not slowed by oversubscribed threads (the
    20-step resume test: 2.6 s on one thread, 4.0 s on eight alone, minutes
    on eight beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(name):
    rcfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    if cfg.num_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=DROP_FACTOR)
        cfg = dataclasses.replace(cfg, capacity_factor=DROP_FACTOR)
    return rcfg, cfg


def _batch(cfg):
    batch = {"tokens": synthetic_batch(DataConfig(cfg.vocab_size, B, S, seed=3), 1, "cpu")
             ["tokens"].numpy()}
    ctx_len, needed = context_len(cfg)
    if needed:
        rng = np.random.default_rng(5)
        batch["context"] = (rng.standard_normal((B, ctx_len, cfg.d_model)) * 0.1
                            ).astype(np.float32)
    return batch


def reference_params(name):
    """The reference's reduced weights, biases and ``xgate`` drawn nonzero."""
    if name not in _REF:
        rcfg, _ = cfgs(name)
        params = jax.tree.map(np.asarray, ref_build_model(rcfg).init_fn(jax.random.key(0)))
        rng = np.random.default_rng(7)

        def perturb(path, x):
            if path[-1].key in ("b", "xgate"):
                return (rng.standard_normal(x.shape) * 0.5).astype(x.dtype)
            return x

        _REF[name] = jax.tree_util.tree_map_with_path(perturb, params)
    return _REF[name]


def reference(name, dtype, excess_precision=True):
    """The reference's loss and gradients (by port weight name), once per
    (row, dtype, excess_precision).  ``excess_precision=False`` compiles it
    with ``xla_allow_excess_precision`` off: XLA then rounds every bf16
    operation's result, as eager torch does, where by default it keeps a
    fused chain of bf16 operations in float32."""
    key = (name, dtype, excess_precision)
    if key not in _REF:
        rcfg, cfg = cfgs(name)
        rmodel = ref_build_model(rcfg, RefShardingConfig(remat="full"), dtype=DTYPES[dtype][0])
        args = (reference_params(name), {k: jnp.asarray(v) for k, v in _batch(cfg).items()})
        step = jax.jit(jax.value_and_grad(rmodel.loss_fn)).lower(*args).compile(
            {"xla_allow_excess_precision": excess_precision})
        loss, grads = step(*args)
        _REF[key] = (float(loss), from_reference_named(jax.tree.map(np.asarray, grads), cfg))
    return _REF[key]


def port(name, dtype, remat="full", attn_chunk=1024):
    """The port's loss and ``{weight name: gradient}`` on the reference's
    weights and batch."""
    _, cfg = cfgs(name)
    params, batch = reference_params(name), _batch(cfg)
    model = build_model(cfg, ShardingConfig(remat=remat, attn_chunk=attn_chunk),
                        dtype=DTYPES[dtype][1], device="cpu")
    p = from_reference_params(params, cfg)
    p.requires_grad_(True)
    loss = model.loss_fn(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad(loss, [w for _, w in p.named_parameters()])
    return loss.item(), dict(zip(names, grads))


def leaf_distances(g32, *grads):
    """``{leaf: [distance from g32 in each of grads]}``, each relative to the
    leaf's norm in ``g32``."""
    return {k: [float((torch.as_tensor(g[k]).float() - w).norm() / w.norm().clamp_min(1e-30))
                for g in grads] for k, w in g32.items()}


if __name__ == "__main__":
    # PYTHONPATH=src python tests/_train_rows.py [row ...]: each row's three
    # bf16 gradient leaves farthest from float32 against the reference's,
    # compiled to round every bf16 operation and as it compiles by default
    import sys

    for row in sys.argv[1:] or ROWS:
        _, g32 = port(row, "float32")
        dist = leaf_distances(g32, port(row, "bfloat16")[1],
                              reference(row, "bfloat16", excess_precision=False)[1],
                              reference(row, "bfloat16")[1])
        worst = sorted(dist, key=lambda k: dist[k][0] / max(dist[k][1], 1e-30), reverse=True)
        print(row, "; ".join(f"{k}: port {d[0]:.4f}, rounding reference {d[1]:.4f}, default "
                             f"reference {d[2]:.4f}" for k in worst[:3] for d in [dist[k]]))
