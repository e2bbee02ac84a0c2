"""Training on a ``data x model`` mesh of thread ranks (float32, CPU).

* The meshed train step == the single-device step: loss and gradient norm
  within 1e-5 relative, AdamW's ``m`` and ``v`` (gathered whole) within
  1e-4 of each leaf's largest entry.  Weights after the step: AdamW's
  first step moves a weight by about ``lr * sign(g)``, so an entry whose
  gradient is tiny may move the other way when the gradient is summed in
  another order; each weight entry is within 1e-6 where its gradient is at
  least 1e-3 of its leaf's largest, and within ``2 lr`` plus 1e-6 elsewhere.
* Each rank holds the elements its weights' and its state's specs give it,
  exactly (FSDP and ZeRO-1).
* ``train(..., mesh)`` logs the single-device losses and returns the whole
  weights and state; a checkpoint of a 2 x 2 run restores on one device and
  on 1 x 4, and the resumed run equals an uninterrupted one.
* Four gloo processes (``process_mesh``) == the ``LocalMesh`` run bitwise,
  and a ``LocalMesh`` whose ranks take turns at host code == one whose
  ranks do not.
* ``launch/train.py`` runs ``--data 2 --model 2`` and ``--distributed``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from _mesh_rows import ROOT, config
from _train_rows import one_thread  # noqa: F401
from repro_torch.comm.spec import local_shape
from repro_torch.configs import ShardingConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.factory import mesh_axes
from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step, train
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.train_loop import gather_opt_state, rank_opt_state

ROW = "smollm-360m"
OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
DATA = DataConfig(256, 4, 32, seed=2)


def _single(cfg, steps, microbatches=1):
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init_fn(torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    opt = init_opt_state(dict(params.named_parameters()))
    step, _ = make_train_step(model, TrainConfig(opt=OPT, microbatches=microbatches))
    metrics = []
    for i in range(steps):
        params, opt, m = step(params, opt, synthetic_batch(DATA, i, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


def _meshed(cfg, shape, steps, *, fsdp, zero1=True, microbatches=1, turns=False):
    mesh = make_local_mesh(*shape, device="cpu", turns=turns)
    model = build_model(cfg, ShardingConfig(batch_axes=("data",), fsdp=fsdp, zero1=zero1),
                        mesh, dtype=torch.float32)
    whole = model.init_fn(torch.Generator().manual_seed(0))
    step, shardings = make_train_step(model, TrainConfig(opt=OPT, microbatches=microbatches),
                                      mesh)

    def rank(ctx):
        params = model.shard_params(whole)
        opt = rank_opt_state(model, params)
        sizes = mesh_axes(mesh, model.sharding)
        for k, p in params.named_parameters():  # the specs' arithmetic, exactly
            full = dict(whole.named_parameters())[k].shape
            assert tuple(p.shape) == local_shape(full, shardings["params"][k], sizes), k
            assert tuple(opt["m"][k].shape) == local_shape(full, shardings["opt"]["m"][k],
                                                           sizes), k
        metrics = []
        for i in range(steps):
            params, opt, m = step(params, opt, synthetic_batch(DATA, i, "cpu"))
            metrics.append({k: float(v) for k, v in m.items()})
        counts = (sum(p.numel() for p in params.parameters()),
                  sum(m.numel() for m in opt["m"].values()))
        return model.gather_params(params), gather_opt_state(model, opt), metrics, counts

    return mesh.run(rank)


CASES = [((2, 2), True, 1), ((1, 4), False, 1), ((4, 1), False, 1), ((2, 2), False, 2)]


@pytest.mark.parametrize("shape,fsdp,micro", CASES,
                         ids=["2x2-fsdp", "1x4", "4x1-zero1", "2x2-zero1-micro2"])
def test_meshed_step_equals_one_device(shape, fsdp, micro):
    cfg = config(ROW)
    p1, o1, m1 = _single(cfg, 1, micro)
    out = _meshed(cfg, shape, 1, fsdp=fsdp, microbatches=micro)
    p2, o2, m2, _ = out[0]
    for r in out[1:]:  # every rank reports the same step
        assert r[2] == m2
    assert abs(m2[0]["loss"] - m1[0]["loss"]) <= 1e-5 * abs(m1[0]["loss"])
    assert abs(m2[0]["grad_norm"] - m1[0]["grad_norm"]) <= 1e-5 * m1[0]["grad_norm"]
    assert m2[0]["lr"] == m1[0]["lr"]
    assert int(o2["step"]) == int(o1["step"]) == 1
    lr = m1[0]["lr"]
    w1, w2 = dict(p1.named_parameters()), dict(p2.named_parameters())
    for k in w1:
        for kind in ("m", "v"):
            ref = o1[kind][k]
            assert float((o2[kind][k] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), \
                (kind, k)
        g = o1["m"][k].abs()  # (1 - b1) * the clipped gradient
        tol = torch.where(g >= 1e-3 * g.max(), 1e-6, 2 * lr + 1e-6)
        assert bool(((w2[k] - w1[k]).abs() <= tol).all()), k


def test_taking_turns_changes_nothing_but_the_schedule():
    """``turns=True`` (one rank runs host code at a time) gives the same
    two steps, bitwise, on 2 x 2 with FSDP and ZeRO-1."""
    cfg = config(ROW)
    a = _meshed(cfg, (2, 2), 2, fsdp=True)
    b = _meshed(cfg, (2, 2), 2, fsdp=True, turns=True)
    for (pa, oa, ma, ca), (pb, ob, mb, cb) in zip(a, b):
        assert ma == mb and ca == cb
        for (k, wa), (_, wb) in zip(pa.named_parameters(), pb.named_parameters()):
            assert torch.equal(wa, wb) and torch.equal(oa["v"][k], ob["v"][k]), k


def test_a_failing_rank_fails_a_mesh_that_takes_turns():
    """A rank that raises while the others wait in a collective, or hold
    the turn, fails the whole mesh at once: no rank is left waiting."""
    from repro_torch.comm import LocalMesh

    def fn(ctx):
        if ctx.data.rank == 1:
            raise RuntimeError("rank 1 fails")
        ctx.data.all_reduce_sum(torch.ones(2))

    mesh = LocalMesh(4, device="cpu", timeout=30, turns=True)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        mesh.run(fn)
    assert time.perf_counter() - t0 < 10


def test_each_rank_holds_its_share():
    """smollm reduced on 2 x 2 with FSDP and ZeRO-1: the weights' blocks,
    and ``m``'s, add up to the whole model's element counts by the specs."""
    cfg = config(ROW)
    out = _meshed(cfg, (2, 2), 0, fsdp=True)
    whole = build_model(cfg, device="cpu").abstract_params()
    n = sum(p.numel() for p in whole.parameters())
    norms = sum(p.numel() for k, p in whole.named_parameters() if p.dim() == 1)
    # every weight is split over both axes but the 1-D norms (whole on both);
    # ZeRO-1 splits the norms' state over data
    assert [c for *_, c in out] == [((n - norms) // 4 + norms, (n - norms) // 4 + norms // 2)] * 4


def test_train_on_a_mesh_logs_the_single_device_losses(tmp_path):
    cfg = config(ROW)
    tcfg = TrainConfig(steps=3, log_every=1, opt=OPT)
    logs1, logs2 = [], []
    a = train(build_model(cfg, device="cpu", dtype=torch.float32), tcfg, log=logs1.append,
              data=DATA)
    mesh = make_local_mesh(2, 2, device="cpu")
    b = train(build_model(cfg, ShardingConfig(batch_axes=("data",), fsdp=True), mesh,
                          dtype=torch.float32), tcfg, mesh, log=logs2.append, data=DATA)
    assert len(logs1) == len(logs2) == 3
    for x, y in zip(_losses(logs1), _losses(logs2)):
        assert abs(x - y) <= 1e-5 * x
    wa, wb = dict(a["params"].named_parameters()), dict(b["params"].named_parameters())
    assert sorted(wa) == sorted(wb) and all(wa[k].shape == wb[k].shape for k in wa)
    assert int(b["opt"]["step"]) == 3
    assert all(b["opt"]["m"][k].shape == wa[k].shape for k in wa)


def _losses(logs):
    return [float(re.search(r"loss ([0-9.]+)", s).group(1)) for s in logs if "loss" in s]


def _run(cfg, mesh_shape, steps, ckpt_dir=None):
    tcfg = TrainConfig(steps=steps, log_every=1, opt=OPT, checkpoint_dir=ckpt_dir,
                       checkpoint_every=2)
    if mesh_shape is None:
        model, mesh = build_model(cfg, device="cpu", dtype=torch.float32), None
    else:
        mesh = make_local_mesh(*mesh_shape, device="cpu")
        model = build_model(cfg, ShardingConfig(batch_axes=("data",), fsdp=True), mesh,
                            dtype=torch.float32)
    logs = []
    out = train(model, tcfg, mesh, log=logs.append, data=DATA)
    return out, logs


@pytest.mark.parametrize("resume_on", [None, (1, 4), (2, 2)], ids=["one-device", "1x4", "2x2"])
def test_a_2x2_checkpoint_restores_on_another_mesh(tmp_path, resume_on):
    """Two steps on 2 x 2 save a checkpoint; two more on ``resume_on`` from
    it == four uninterrupted steps on 2 x 2 (bitwise on 2 x 2 itself)."""
    cfg = config(ROW)
    whole, _ = _run(cfg, (2, 2), 4)
    _run(cfg, (2, 2), 2, str(tmp_path))
    resumed, logs = _run(cfg, resume_on, 4, str(tmp_path))
    assert logs[0] == "restored checkpoint at step 2" and len(_losses(logs)) == 2
    assert int(resumed["opt"]["step"]) == 4
    wa, wb = dict(whole["params"].named_parameters()), dict(resumed["params"].named_parameters())
    for k in wa:
        if resume_on == (2, 2):
            assert torch.equal(wa[k], wb[k]), k
            assert torch.equal(whole["opt"]["v"][k], resumed["opt"]["v"][k]), k
        else:
            assert float((wa[k] - wb[k]).detach().abs().max()) <= 2e-5, k


_GLOO_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def work(rank, world, port, out_path):
        sys.path.insert(0, %r)
        sys.path.insert(0, %r)
        from _mesh_rows import config
        from repro_torch.configs import ShardingConfig
        from repro_torch.launch.mesh import process_mesh
        from repro_torch.models import build_model
        from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
        from repro_torch.train.data import DataConfig, synthetic_batch
        from repro_torch.train.train_loop import gather_opt_state, rank_opt_state

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        mesh = process_mesh(data=2, iters=2, device="cpu")
        out = {}
        for fsdp in (False, True):
            model = build_model(config("smollm-360m"),
                                ShardingConfig(batch_axes=("data",), fsdp=fsdp), mesh,
                                dtype=torch.float32)
            whole = model.init_fn(torch.Generator().manual_seed(0))
            step, _ = make_train_step(model, TrainConfig(opt=AdamWConfig(
                lr_peak=1e-3, warmup_steps=1, total_steps=10)), mesh)

            def rank_fn(ctx):
                params = model.shard_params(whole)
                opt = rank_opt_state(model, params)
                losses = []
                for i in range(2):
                    params, opt, m = step(params, opt,
                                          synthetic_batch(DataConfig(256, 4, 32, seed=2), i,
                                                          "cpu"))
                    losses.append([float(m["loss"]), float(m["grad_norm"])])
                p = {k: v.tolist() for k, v in model.gather_params(params).named_parameters()}
                v = {k: t.tolist() for k, t in gather_opt_state(model, opt)["v"].items()}
                return losses, p, v

            out[str(fsdp)] = mesh.run(rank_fn)[0]
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(work, args=(4, port, sys.argv[1]), nprocs=4, join=True)
""") % (str(ROOT / "src"), str(ROOT / "tests"))


def test_gloo_processes_equal_local_mesh(tmp_path):
    """Four gloo processes as a 2 x 2 ``process_mesh``, two steps with and
    without FSDP == the same on ``LocalMesh`` threads, bitwise."""
    script = tmp_path / "gloo_worker.py"
    script.write_text(_GLOO_WORKER)
    out_path = tmp_path / "out.json"
    proc = subprocess.run([sys.executable, str(script), str(out_path)], capture_output=True,
                          text=True, timeout=240, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(out_path.read_text())
    cfg = config(ROW)
    for fsdp in (False, True):
        p, o, metrics, _ = _meshed(cfg, (2, 2), 2, fsdp=fsdp)[0]
        losses, weights, v = got[str(fsdp)]
        assert losses == [[m["loss"], m["grad_norm"]] for m in metrics]
        for k, w in p.named_parameters():
            assert torch.equal(torch.tensor(weights[k], dtype=torch.float32), w), k
            assert torch.equal(torch.tensor(v[k], dtype=torch.float32), o["v"][k]), k


def test_launcher_on_a_2x2_mesh_logs_the_single_device_losses(capsys):
    """``--data 2 --model 2`` (bf16 compute, as the launcher's default) logs
    the losses of ``--data 1`` within the bf16 rule of 1e-3 relative."""
    args = ["--arch", ROW, "--steps", "10", "--device", "cpu"]
    launch_train.main(args)
    one = _losses(capsys.readouterr().out.splitlines())
    launch_train.main(args + ["--data", "2", "--model", "2"])
    mesh = _losses(capsys.readouterr().out.splitlines())
    assert len(one) == len(mesh) == 1
    assert all(abs(a - b) <= 1e-3 * a for a, b in zip(one, mesh))


def test_launcher_distributed_at_world_size_one(monkeypatch, capsys):
    """``--distributed`` joins the job through ``init_process_group`` (gloo
    here) as a 1 x 1 ``process_mesh``, and logs the losses of a 1 x 1
    ``LocalMesh`` run exactly."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_arch

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        out = launch_train.main(["--arch", ROW, "--steps", "10", "--device", "cpu",
                                 "--distributed"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    got = _losses(capsys.readouterr().out.splitlines())
    mesh = make_local_mesh(1, 1, device="cpu")
    logs = []
    train(build_model(get_arch(ROW).reduced(), ShardingConfig(batch_axes=("data",)), mesh),
          TrainConfig(steps=10, opt=AdamWConfig(total_steps=10)), mesh, log=logs.append)
    assert got == _losses(logs) and len(got) == 1 and int(out["opt"]["step"]) == 10
    assert math.isfinite(float(out["metrics"]["loss"]))
