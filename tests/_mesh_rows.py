"""The LM on a ``[pod x] data x model`` mesh, shared by tests/test_torch_mesh_lm.py,
tests/test_torch_mesh_moe.py, tests/test_torch_mesh_train.py and
tests/test_torch_mesh_pod.py.

* :func:`reference_runs`: the reference's meshed runs (``build_model(cfg,
  sharding, mesh)`` on ``make_local_mesh(data, model)``, or with ``pods`` on
  a ``(pod, data, model)`` mesh with the batch over ``pod`` and ``data``,
  over 8 forced host devices, float32 compute, weights placed by its ``param_specs``): the
  loss and gradients of ``jax.value_and_grad(loss_fn)``, and with
  ``serve`` the prefill's last logits and each decode step's, in one
  subprocess for a list of jobs.  A ``dtype="bfloat16"`` job builds the
  model at the reference's defaults (bf16 compute; on a mesh, the weights
  of two or more dimensions cast where the forward uses them), compiled
  with ``xla_allow_excess_precision`` off so that every bf16 operation is
  rounded as eager torch rounds it (tests/test_torch_train_bf16.py);
* :func:`port_mesh_run`: the port's same run on a ``LocalMesh`` of thread
  ranks on the CPU, the gradients summed over the data axis where a weight
  is whole on it and gathered whole, as the train step lands them;
* :func:`port_single_run`: the port on one device.

Tokens are ``B x S`` from a seed; prefill takes the first ``serve``
positions and decode the rest, one at a time.  A vision or audio row also
takes a context ``[B, Lc, d]`` from a seed (:func:`context`), for the loss
and the prefill.  A job's ``sharding`` holds the reference's
``ShardingConfig`` fields besides the batch axes, FSDP and the pipeline
(``seq_axis``, ``sp_dim``, ``attn_anchor``); with ``perturb`` the biases and
cross gates, zero at init, are drawn from a seed.
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
from repro_torch.models.factory import context_len

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 24
SERVE = 20  # prefill positions; decode the other S - SERVE
DENSE = ["smollm-360m", "qwen1.5-0.5b", "internlm2-1.8b", "granite-3-8b"]
EXPERTS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"]


def tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (B, S)).astype(np.int32)


def context(cfg):
    """A vision row's image embeddings or an audio row's frames ``[B, Lc,
    d]`` (float32, as the reference's tests draw them), else None."""
    ctx_len, needed = context_len(cfg)
    if not needed:
        return None
    rng = np.random.default_rng(6)
    return (rng.standard_normal((B, ctx_len, cfg.d_model)) * 0.1).astype(np.float32)


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
    from repro.launch.mesh import make_local_mesh, make_mesh
    from repro.models import build_model

    def flat(tree):
        return {"/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    jobs, out_dir = json.loads(open(sys.argv[1]).read()), sys.argv[2]
    for job in jobs:
        cfg = get_arch(job["row"]).reduced()
        if job.get("heads"):
            cfg = dataclasses.replace(cfg, num_heads=job["heads"][0],
                                      num_kv_heads=job["heads"][1])
        if job.get("capacity_factor"):
            cfg = dataclasses.replace(cfg, capacity_factor=job["capacity_factor"])
        pods = job.get("pods", 1)
        mesh = (make_local_mesh(job["data"], job["model"]) if pods == 1 else
                make_mesh((pods, job["data"], job["model"]), ("pod", "data", "model")))
        sh = ShardingConfig(batch_axes=("data",) if pods == 1 else ("pod", "data"),
                            fsdp=job["fsdp"],
                            moe_pipeline=job["pipeline"], **job.get("sharding", {}))
        # float32 compute, or bf16 at build_model's default, which casts the
        # weights of two or more dimensions where the forward uses them on a mesh
        bf16 = job.get("dtype", "float32") == "bfloat16"
        model = build_model(cfg, sh, mesh) if bf16 else build_model(cfg, sh, mesh,
                                                                    dtype=jnp.float32)
        params = jax.jit(model.init_fn)(jax.random.key(0))
        if job.get("perturb"):  # biases and the cross gates, zero at init, from a seed
            rng = np.random.default_rng(7)
            params = jax.tree_util.tree_map_with_path(
                lambda path, x: (rng.standard_normal(x.shape) * 0.5).astype(x.dtype)
                if path[-1].key in ("b", "xgate") else x, params)
        out = {"params/" + k: v for k, v in flat(params).items()}
        params = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                     model.param_specs(params)))
        tokens = np.asarray(job["tokens"], np.int32)
        ctx = {} if job.get("context") is None else {
            "context": np.asarray(job["context"], np.float32)}
        args = (params, {"tokens": tokens, **ctx})
        if bf16:  # every bf16 operation rounded, as eager torch rounds it
            loss, grads = jax.jit(jax.value_and_grad(model.loss_fn)).lower(*args).compile(
                {"xla_allow_excess_precision": False})(*args)
        else:
            loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(*args)
        out["loss"] = np.asarray(loss)
        out.update({"grads/" + k: v for k, v in flat(grads).items()})
        if job.get("serve"):
            n = job["serve"]
            lg, caches = jax.jit(model.prefill_fn)(params, {"tokens": tokens[:, :n], **ctx})
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
        capacity_factor=None, perturb=False, pods=1, dtype="float32", **sharding) -> dict:
    """A reference job (``perturb``: biases and cross gates drawn nonzero;
    ``pods``: a pod axis; ``dtype``: ``"bfloat16"`` runs the loss at the
    reference's default compute dtype and cast; ``sharding``: ``seq_axis``,
    ``sp_dim``, ``attn_anchor``)."""
    cfg = config(row, heads)
    ctx = context(cfg)
    return {"id": jid, "row": row, "data": data, "model": model, "pods": pods, "fsdp": fsdp,
            "pipeline": pipeline, "serve": SERVE if serve else 0, "heads": heads,
            "capacity_factor": capacity_factor, "tokens": tokens(cfg.vocab_size).tolist(),
            "context": None if ctx is None else ctx.tolist(), "sharding": sharding,
            "perturb": perturb, "dtype": dtype}


def reference_runs(jobs, tmp, procs: int = 1) -> dict:
    """``{job id: {"params", "loss", "grads", "logits"}}``: the reference's
    meshed runs on 8 forced host devices, in ``procs`` subprocesses at once
    (the jobs dealt out in turn; each job is mostly the reference's
    single-threaded compile)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    running = []
    for i in range(procs):
        spec = Path(tmp) / f"jobs{i}.json"  # the contexts are too long for an argument
        spec.write_text(json.dumps(jobs[i::procs]))
        running.append(subprocess.Popen([sys.executable, "-c", _WORKER, str(spec), str(tmp)],
                                        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True))
    for proc in running:
        try:
            _, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, err[-3000:]
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
    """A reference pytree from its flattened leaves (lists as lists)."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *parents, leaf = k[len(prefix):].split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return _lists(out)


def _lists(d):
    """Dicts keyed ``"0"``, ``"1"``, ... (a flattened list: ``tail``, the
    encoder's ``blocks``) back into lists."""
    if not isinstance(d, dict):
        return d
    d = {k: _lists(v) for k, v in d.items()}
    if d and all(k.isdigit() for k in d):
        return [d[str(i)] for i in range(len(d))]
    return d


def _batch(toks, ctx, lo=0, hi=None):
    """``{"tokens": rows lo:hi}`` and the context's same rows, if any."""
    out = {"tokens": toks[lo:hi]}
    if ctx is not None:
        out["context"] = ctx[lo:hi]
    return out


def port_mesh_run(cfg, params, toks, data: int, model: int, *, fsdp=False, pipeline=False,
                  serve=False, cache_dtype=torch.bfloat16, ctx=None, pods=1,
                  dtype=torch.float32, cast_params=None, **sharding):
    """The port's meshed loss, gradients (whole, in the weights' layout) and,
    with ``serve``, logits (whole) on ``[pods x] data x model`` thread ranks
    (the batch over ``pod`` and ``data``; ``sharding``: more
    ``ShardingConfig`` fields; ``ctx`` a context), in compute ``dtype`` and
    ``cast_params`` (``build_model``'s default where None)."""
    mesh = make_local_mesh(data, model, pods=pods, device="cpu")
    dp = ("data",) if pods == 1 else ("pod", "data")
    cast = {} if cast_params is None else {"cast_params": cast_params}
    m = build_model(cfg, ShardingConfig(batch_axes=dp, fsdp=fsdp, moe_pipeline=pipeline,
                                        **sharding),
                    mesh, dtype=dtype, cache_dtype=cache_dtype, **cast)
    toks = torch.as_tensor(toks)
    ctx_all = None if ctx is None else torch.as_tensor(ctx)
    names = [n for n, _ in params.named_parameters()]

    def rank(ctx):
        p = m.shard_params(params)
        batch = m.rank_rows(_batch(toks, ctx_all))
        rows = batch["tokens"]
        groups = {"pod": ctx.pod, "data": ctx.data, "model": ctx.model}
        specs = m.param_specs(p)
        p.requires_grad_(True)
        loss = m.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, list(p.parameters()))
        whole = {}
        for n, g in zip(names, grads):
            if "data" not in used_axes(specs[n]) and data > 1:
                g = ctx.data.all_reduce_sum(g)
            if pods > 1:
                g = ctx.pod.all_reduce_sum(g)
            whole[n] = gather_whole(g, specs[n], groups)
        logits = []
        if serve:
            p.requires_grad_(False)
            spec = P(dp, "model")
            lg, caches = m.prefill_fn(p, dict(batch, tokens=rows[:, :SERVE]))
            logits.append(gather_whole(lg, spec, groups))
            for t in range(S - SERVE):
                lg, caches = m.decode_fn(p, {"tokens": rows[:, SERVE + t : SERVE + t + 1],
                                             "caches": caches, "pos": SERVE + t})
                logits.append(gather_whole(lg, spec, groups))
        return float(loss.detach()), whole, logits

    out = mesh.run(rank)
    for other in out[1:]:  # every rank holds the same global values
        assert other[0] == out[0][0]
        for n in names:
            assert torch.equal(other[1][n], out[0][1][n]), n
    return out[0]


def port_single_run(cfg, params, toks, *, serve=False, cache_dtype=torch.bfloat16, ctx=None):
    """The port's loss, gradients and logits on one device."""
    m = build_model(cfg, device="cpu", dtype=torch.float32, cache_dtype=cache_dtype)
    toks = torch.as_tensor(toks)
    batch = _batch(toks, None if ctx is None else torch.as_tensor(ctx))
    params.requires_grad_(True)
    loss = m.loss_fn(params, batch)
    grads = dict(zip([n for n, _ in params.named_parameters()],
                     torch.autograd.grad(loss, list(params.parameters()))))
    params.requires_grad_(False)
    logits = []
    if serve:
        lg, caches = m.prefill_fn(params, dict(batch, tokens=toks[:, :SERVE]))
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
