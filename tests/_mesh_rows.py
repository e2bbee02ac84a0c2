"""The LM on a ``data x model`` mesh, shared by tests/test_torch_mesh_lm.py,
tests/test_torch_mesh_moe.py and tests/test_torch_mesh_train.py.

* :func:`reference_runs`: the reference's meshed runs (``build_model(cfg,
  sharding, mesh)`` on ``make_local_mesh(data, model)`` over 8 forced host
  devices, float32 compute, weights placed by its ``param_specs``): the
  loss and gradients of ``jax.value_and_grad(loss_fn)``, and with
  ``serve`` the prefill's last logits and each decode step's, in one
  subprocess for a list of jobs;
* :func:`port_mesh_run`: the port's same run on a ``LocalMesh`` of thread
  ranks on the CPU, the gradients summed over the data axis where a weight
  is whole on it and gathered whole, as the train step lands them;
* :func:`port_single_run`: the port on one device.

Tokens are ``B x S`` from a seed; prefill takes the first ``serve``
positions and decode the rest, one at a time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch.comm.spec import PartitionSpec as P
from repro_torch.comm.spec import gather_whole, used_axes
from repro_torch.configs import ShardingConfig, get_arch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_named, from_reference_params

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 24
SERVE = 20  # prefill positions; decode the other S - SERVE
DENSE = ["smollm-360m", "qwen1.5-0.5b", "internlm2-1.8b", "granite-3-8b"]
EXPERTS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"]


def tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (B, S)).astype(np.int32)


def config(row: str, heads=None, capacity_factor=None):
    """The port's reduced config of ``row`` (``heads``: ``(H, Hkv)`` in place
    of its own; ``capacity_factor`` in place of 1.25)."""
    cfg = get_arch(row).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0], num_kv_heads=heads[1])
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_arch
    from repro.configs.base import ShardingConfig
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model

    def flat(tree):
        return {"/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    jobs, out_dir = json.loads(sys.argv[1]), sys.argv[2]
    for job in jobs:
        cfg = get_arch(job["row"]).reduced()
        if job.get("heads"):
            cfg = dataclasses.replace(cfg, num_heads=job["heads"][0],
                                      num_kv_heads=job["heads"][1])
        if job.get("capacity_factor"):
            cfg = dataclasses.replace(cfg, capacity_factor=job["capacity_factor"])
        mesh = make_local_mesh(job["data"], job["model"])
        sh = ShardingConfig(batch_axes=("data",), fsdp=job["fsdp"],
                            moe_pipeline=job["pipeline"])
        model = build_model(cfg, sh, mesh, dtype=jnp.float32)
        params = jax.jit(model.init_fn)(jax.random.key(0))
        out = {"params/" + k: v for k, v in flat(params).items()}
        params = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                     model.param_specs(params)))
        tokens = np.asarray(job["tokens"], np.int32)
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, {"tokens": tokens})
        out["loss"] = np.asarray(loss)
        out.update({"grads/" + k: v for k, v in flat(grads).items()})
        if job.get("serve"):
            n = job["serve"]
            lg, caches = jax.jit(model.prefill_fn)(params, {"tokens": tokens[:, :n]})
            out["logits/0"] = np.asarray(lg)
            dec = jax.jit(model.decode_fn)
            for t in range(tokens.shape[1] - n):
                lg, caches = dec(params, {"tokens": tokens[:, n + t : n + t + 1],
                                          "pos": jnp.asarray(n + t, jnp.int32),
                                          "caches": caches})
                out[f"logits/{t + 1}"] = np.asarray(lg)
        np.savez(f"{out_dir}/{job['id']}.npz", **out)
""")


def job(jid, row, data, model, *, fsdp=False, pipeline=False, serve=False, heads=None,
        capacity_factor=None) -> dict:
    cfg = config(row, heads)
    return {"id": jid, "row": row, "data": data, "model": model, "fsdp": fsdp,
            "pipeline": pipeline, "serve": SERVE if serve else 0, "heads": heads,
            "capacity_factor": capacity_factor, "tokens": tokens(cfg.vocab_size).tolist()}


def reference_runs(jobs, tmp) -> dict:
    """``{job id: {"params", "loss", "grads", "logits"}}``: the reference's
    meshed runs, one subprocess on 8 forced host devices."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _WORKER, json.dumps(jobs), str(tmp)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for j in jobs:
        z = dict(np.load(Path(tmp) / f"{j['id']}.npz"))
        cfg = config(j["row"], j["heads"], j["capacity_factor"])
        out[j["id"]] = {
            "params": from_reference_params(_nest(z, "params/"), cfg),
            "loss": float(z["loss"]),
            "grads": from_reference_named(_nest(z, "grads/"), cfg),
            "logits": [torch.from_numpy(z[f"logits/{i}"]) for i in range(S - SERVE + 1)]
            if j["serve"] else [],
        }
    return out


def _nest(flat: dict, prefix: str) -> dict:
    """A reference pytree from its flattened leaves (``tail`` as a list)."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *parents, leaf = k[len(prefix):].split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    if "tail" in out:
        out["tail"] = [out["tail"][str(i)] for i in range(len(out["tail"]))]
    return out


def port_mesh_run(cfg, params, toks, data: int, model: int, *, fsdp=False, pipeline=False,
                  serve=False, cache_dtype=torch.bfloat16):
    """The port's meshed loss, gradients (whole, in the weights' layout) and,
    with ``serve``, logits (whole) on ``data x model`` thread ranks."""
    mesh = make_local_mesh(data, model, device="cpu")
    m = build_model(cfg, ShardingConfig(batch_axes=("data",), fsdp=fsdp, moe_pipeline=pipeline),
                    mesh, dtype=torch.float32, cache_dtype=cache_dtype)
    toks = torch.as_tensor(toks)
    names = [n for n, _ in params.named_parameters()]

    def rank(ctx):
        p = m.shard_params(params)
        b = toks.shape[0] // data
        rows = toks[ctx.data.rank * b : (ctx.data.rank + 1) * b]
        groups = {"data": ctx.data, "model": ctx.model}
        specs = m.param_specs(p)
        p.requires_grad_(True)
        loss = m.loss_fn(p, {"tokens": rows})
        grads = torch.autograd.grad(loss, list(p.parameters()))
        whole = {}
        for n, g in zip(names, grads):
            if "data" not in used_axes(specs[n]) and data > 1:
                g = ctx.data.all_reduce_sum(g)
            whole[n] = gather_whole(g, specs[n], groups)
        logits = []
        if serve:
            p.requires_grad_(False)
            lg, caches = m.prefill_fn(p, {"tokens": rows[:, :SERVE]})
            logits.append(gather_whole(lg, P("data", "model"), groups))
            for t in range(S - SERVE):
                lg, caches = m.decode_fn(p, {"tokens": rows[:, SERVE + t : SERVE + t + 1],
                                             "caches": caches, "pos": SERVE + t})
                logits.append(gather_whole(lg, P("data", "model"), groups))
        return float(loss.detach()), whole, logits

    out = mesh.run(rank)
    for other in out[1:]:  # every rank holds the same global values
        assert other[0] == out[0][0]
        for n in names:
            assert torch.equal(other[1][n], out[0][1][n]), n
    return out[0]


def port_single_run(cfg, params, toks, *, serve=False, cache_dtype=torch.bfloat16):
    """The port's loss, gradients and logits on one device."""
    m = build_model(cfg, device="cpu", dtype=torch.float32, cache_dtype=cache_dtype)
    toks = torch.as_tensor(toks)
    params.requires_grad_(True)
    loss = m.loss_fn(params, {"tokens": toks})
    grads = dict(zip([n for n, _ in params.named_parameters()],
                     torch.autograd.grad(loss, list(params.parameters()))))
    params.requires_grad_(False)
    logits = []
    if serve:
        lg, caches = m.prefill_fn(params, {"tokens": toks[:, :SERVE]})
        logits.append(lg)
        for t in range(S - SERVE):
            lg, caches = m.decode_fn(params, {"tokens": toks[:, SERVE + t : SERVE + t + 1],
                                              "caches": caches, "pos": SERVE + t})
            logits.append(lg)
    return float(loss.detach()), grads, logits


def assert_leaves_close(got: dict, want: dict, tol: float = 1e-4) -> None:
    """Each leaf within ``tol`` of its largest entry (a leaf of zeros: 0)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = torch.as_tensor(w)
        err = float((got[k] - w).abs().max())
        assert err <= tol * float(w.abs().max()), (k, err, float(w.abs().max()))


def assert_logits_close(got: list, want: list, tol: float = 1e-4) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), (i, err)
