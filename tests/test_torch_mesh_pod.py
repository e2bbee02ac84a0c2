"""The LM on a ``(pod, data, model)`` mesh: the reference's multi-pod layout.

The pod axis is data-parallel only, as in the reference: the batch splits
over ``pod x data``, FSDP and ZeRO-1 over ``data`` alone, the weights are
whole across pods and every gradient is summed over ``pod`` too.

* against the reference: a reduced row's loss and gradients (and a
  prefill plus decode) on a ``(2, 2, 2)`` ``LocalMesh`` == the reference's
  run on the same ``(pod, data, model)`` host mesh, float32 (three jobs in
  one subprocess on 8 forced host devices);
* against the port: the other rows on the pod mesh == one device; a
  2-step ``train`` on the pod mesh logs the single-device losses; a
  checkpoint saved on ``(2, 2, 2)`` restores on ``2 x 2``; the rank's
  weight and ZeRO-1 elements == the specs' arithmetic over ``data`` alone;
* the layouts: ``LocalMesh``'s groups, ``process_mesh``'s subgroups (a
  stand-in ``torch.distributed``), the counting engine's refusal;
* the launcher: ``--production-mesh --multi-pod`` (the shapes made small)
  builds the reference's ``ShardingConfig`` and trains; ``--distributed``
  on a world of another size raises, naming 256 and 512.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from _mesh_rows import (
    B,
    assert_leaves_close,
    assert_logits_close,
    config,
    context,
    job,
    port_mesh_run,
    port_single_run,
    reference_runs,
    tokens,
)
from repro.configs.base import ShardingConfig as RefShardingConfig
from repro_torch.comm import LocalMesh
from repro_torch.comm.spec import local_shape, used_axes
from repro_torch.configs import ShardingConfig, get_arch
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.factory import mesh_axes
from repro_torch.train import DataConfig, TrainConfig, train
from repro_torch.train.train_loop import _specs, rank_opt_state

POD = (2, 2, 2)  # pods, data, model
POD_SMALL = (2, 1, 2)  # the rows against one device
REF_TOL = 1e-5  # float32: the loss relative, each gradient leaf of its largest entry

#: the reference jobs: a train loss with sequence parallelism, an FSDP row,
#: a prefill and decode
REF_JOBS = [
    ("sp", "smollm-360m", dict(seq_axis="model")),
    ("fsdp", "qwen1.5-0.5b", dict(fsdp=True)),
    ("serve", "internlm2-1.8b", dict(serve=True)),
]


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    jobs = [job(jid, row, POD[1], POD[2], pods=POD[0], **kw) for jid, row, kw in REF_JOBS]
    return reference_runs(jobs, tmp_path_factory.mktemp("ref_pod"))


@pytest.mark.parametrize("jid,row,kw", REF_JOBS, ids=[j[0] for j in REF_JOBS])
def test_pod_mesh_equals_the_reference(ref_runs, jid, row, kw):
    ref = ref_runs[jid]
    cfg = config(row)
    loss, grads, logits = port_mesh_run(cfg, ref["params"], tokens(cfg.vocab_size), POD[1],
                                        POD[2], pods=POD[0], ctx=context(cfg), **kw)
    assert abs(loss - ref["loss"]) <= REF_TOL * abs(ref["loss"]), (loss, ref["loss"])
    assert_leaves_close(grads, ref["grads"], REF_TOL)
    if kw.get("serve"):  # bf16 caches, as the reference's: the meshed tests' 1e-4
        assert_logits_close(logits, ref["logits"])


#: the other rows against one device: (row, ShardingConfig fields)
OTHER_ROWS = [
    ("granite-3-8b", dict(fsdp=True, seq_axis="model")),
    ("rwkv6-3b", dict(seq_axis="model", sp_dim=2)),
    ("recurrentgemma-2b", dict(attn_anchor=True)),
    ("llama-3.2-vision-90b", dict(fsdp=True)),
    ("whisper-base", dict(seq_axis="model")),
]


def _params(cfg):
    return build_model(cfg, device="cpu", dtype=torch.float32).init_fn(
        torch.Generator().manual_seed(3))


@pytest.mark.parametrize("row,kw", OTHER_ROWS, ids=[r for r, _ in OTHER_ROWS])
def test_pod_mesh_equals_one_device(row, kw):
    cfg = config(row)
    params = _params(cfg)
    toks, ctx = tokens(cfg.vocab_size), context(cfg)
    loss, grads, logits = port_mesh_run(cfg, params, toks, POD_SMALL[1], POD_SMALL[2],
                                        pods=POD_SMALL[0], ctx=ctx, serve=True,
                                        cache_dtype=torch.float32, **kw)
    want_loss, want_grads, want_logits = port_single_run(cfg, params, toks, ctx=ctx, serve=True,
                                                         cache_dtype=torch.float32)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert_leaves_close(grads, want_grads, 1e-4)
    assert_logits_close(logits, want_logits, 1e-4)


def test_experts_on_pods_equal_a_data_axis_of_four():
    """The expert rows differ from one device by design (each data shard's
    capacity and aux loss); pods x data splits the batch as a data axis of
    their product does, so ``(2, 1, 2)`` == ``2 x 2``."""
    cfg = config("phi3.5-moe-42b-a6.6b")
    params = _params(cfg)
    toks = tokens(cfg.vocab_size)
    pods, data, model = POD_SMALL
    loss, grads, logits = port_mesh_run(cfg, params, toks, data, model, pods=pods,
                                        serve=True, cache_dtype=torch.float32)
    want_loss, want_grads, want_logits = port_mesh_run(cfg, params, toks, pods * data, model,
                                                       serve=True, cache_dtype=torch.float32)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    assert_leaves_close(grads, want_grads, 1e-5)
    assert_logits_close(logits, want_logits, 1e-5)


def _losses(lines):
    return [float(m.group(1)) for x in lines if (m := re.match(r"step \d+: loss (\S+)", x))]


def test_train_on_the_pod_mesh_logs_one_devices_losses_and_restores_on_2x2(tmp_path):
    """``train`` on ``(2, 1, 2)`` (FSDP over a data axis of one, the batch
    over the pods) logs the single-device losses; its checkpoint, saved by
    rank (0, 0, 0), restores on a ``2 x 2`` mesh, and on the pod mesh, to
    the same weights and state; a rank holds the specs' elements, ZeRO-1
    over ``data`` alone."""
    cfg = get_arch("smollm-360m").reduced()
    data = DataConfig(cfg.vocab_size, 4, 32, seed=0)
    tcfg = TrainConfig(steps=2, log_every=1, checkpoint_every=1,
                       checkpoint_dir=str(tmp_path / "ck"))
    one, meshed, log1, log2 = [], [], [], []
    single = build_model(cfg, device="cpu", dtype=torch.float32)
    train(single, dataclasses.replace(tcfg, checkpoint_dir=None), log=log1.append, data=data)
    mesh = launch_mesh.make_local_mesh(1, 2, pods=2, device="cpu", turns=True)
    model = build_model(cfg, ShardingConfig(batch_axes=("pod", "data"), fsdp=True), mesh,
                        dtype=torch.float32)
    out = train(model, tcfg, mesh, log=log2.append, data=data)
    one, meshed = _losses(log1), _losses(log2)
    assert len(one) == 2 and np.allclose(meshed, one, rtol=1e-5, atol=0), (meshed, one)
    # the restore onto 2 x 2: every step is done, so the result is the checkpoint
    mesh2 = launch_mesh.make_local_mesh(2, 2, device="cpu")
    model2 = build_model(cfg, ShardingConfig(batch_axes=("data",), fsdp=True), mesh2,
                         dtype=torch.float32)
    log3 = []
    back = train(model2, tcfg, mesh2, log=log3.append, data=data)
    assert "restored checkpoint at step 2" in log3
    for (k, a), (_, b) in zip(out["params"].named_parameters(),
                              back["params"].named_parameters()):
        assert torch.equal(a, b), k
    for kind in ("m", "v"):
        for k, v in out["opt"][kind].items():
            assert torch.equal(v, back["opt"][kind][k]), (kind, k)
    # and back onto the pod mesh: each rank's blocks restored
    log4 = []
    again = train(model, tcfg, mesh, log=log4.append, data=data)
    assert "restored checkpoint at step 2" in log4
    for (k, a), (_, b) in zip(out["params"].named_parameters(),
                              again["params"].named_parameters()):
        assert torch.equal(a, b), k
    # a rank's elements: FSDP and ZeRO-1 split over data alone
    pod = launch_mesh.make_local_mesh(2, 2, pods=2, device="cpu")
    model3 = build_model(cfg, ShardingConfig(batch_axes=("pod", "data"), fsdp=True), pod)
    whole = model3.init_fn(torch.Generator().manual_seed(0))
    counts = pod.run(lambda ctx: (sum(t.numel() for t in model3.shard_params(whole).parameters()),
                                  sum(t.numel() for t in rank_opt_state(
                                      model3, model3.shard_params(whole))["m"].values())))
    pspecs, ospecs = _specs(model3)
    sizes = mesh_axes(pod, model3.sharding)
    assert sizes == {"pod": 2, "data": 2, "model": 2}
    shapes = dict(model3.abstract_params().named_parameters())
    want = tuple(sum(math.prod(local_shape(t.shape, specs[k], sizes)) for k, t in shapes.items())
                 for specs in (pspecs, ospecs["m"]))
    assert set(counts) == {want}
    assert not any("pod" in used_axes(s) for s in [*pspecs.values(), *ospecs["m"].values()])


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------


def test_local_mesh_pod_groups():
    mesh = LocalMesh(2, 3, pods=2, device="cpu")
    assert mesh.size == 12 and repr(mesh).startswith("LocalMesh(pods=2, data=2, iters=3")

    def rank(ctx):
        me = torch.tensor([ctx.pod.rank, ctx.model.rank, ctx.data.rank])
        return (tuple(me.tolist()), ctx.pod.all_gather(me).tolist(),
                ctx.data.all_gather(me).tolist(), ctx.model.all_gather(me).tolist())

    out = mesh.run(rank)
    assert [o[0] for o in out] == [(o, i, p) for o in range(2) for i in range(3)
                                   for p in range(2)]
    for (o, i, p), pods, datas, models in out:
        assert pods == [[k, i, p] for k in range(2)]
        assert datas == [[o, i, q] for q in range(2)]
        assert models == [[o, j, p] for j in range(3)]


def test_process_mesh_lays_out_pods(monkeypatch):
    """``process_mesh(data, iters, pods=)`` on a stand-in world of 12: world
    rank ``(o * iters + i) * data + p``, every group made by every rank in
    one order."""
    import torch.distributed as dist

    made = []
    me = 7  # pod 1, slice 0, shard 1 of a 2 x 3 mesh
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 12 if group is None
                        else len(group))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: me if group is None
                        else group.index(me))
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(tuple(ranks)) or
                        tuple(ranks))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    mesh = launch_mesh.process_mesh(2, 3, pods=2)
    assert (mesh.pod_size, mesh.data_size, mesh.iter_size, mesh.size) == (2, 2, 3, 12)
    assert mesh.data.group == (6, 7) and mesh.iters.group == (7, 9, 11)
    assert mesh.pod.group == (1, 7)
    assert len(made) == 6 + 4 + 6 and len(set(made)) == len(made)
    assert (mesh.pod.rank, mesh.iters.rank, mesh.data.rank) == (1, 0, 1)
    with pytest.raises(ValueError, match="needs 8 ranks; the world has 12"):
        launch_mesh.process_mesh(2, 2, pods=2)


def test_counting_refuses_a_pod_mesh():
    from repro_torch.core.distributed import abstract_plan, make_count_fn
    from repro_torch.core.templates import template

    plan = abstract_plan(1024, 4096, template("u3-1"), 2)
    with pytest.raises(ValueError, match="iteration axis"):
        make_count_fn(plan, launch_mesh.make_local_mesh(2, 1, pods=2, device="cpu"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_multi_pod_builds_the_reference_sharding(monkeypatch):
    monkeypatch.setitem(launch_mesh.PRODUCTION_AXES, True, (("pod", 2), ("data", 1),
                                                            ("model", 2)))
    got = {}
    real_train = launch_train.train

    def spy(model, tcfg, mesh):
        got.update(model=model, mesh=mesh)
        return real_train(model, tcfg, mesh, data=DataConfig(model.cfg.vocab_size, 2, 32))

    monkeypatch.setattr(launch_train, "train", spy)
    out = launch_train.main(["--arch", "granite-3-8b", "--steps", "1", "--device", "cpu",
                             "--production-mesh", "--multi-pod"])
    assert int(out["opt"]["step"]) == 1 and np.isfinite(float(out["metrics"]["loss"]))
    mesh, model = got["mesh"], got["model"]
    assert (mesh.pod_size, mesh.data_size, mesh.iter_size) == (2, 1, 2) and mesh.turns
    want = RefShardingConfig(batch_axes=("pod", "data"),
                             fsdp=get_arch("granite-3-8b").reduced().params_count() >= 2e9,
                             seq_axis="model")
    assert dataclasses.asdict(model.sharding) == dataclasses.asdict(want)


@pytest.mark.parametrize("multi_pod,world", [(False, 512), (True, 256), (True, 4)])
def test_launcher_distributed_needs_the_production_world(monkeypatch, multi_pod, world):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(ValueError, match=r"256 ranks \(512 with --multi-pod\).* has "
                                         + str(world)):
        launch_train.main(["--arch", "smollm-360m", "--steps", "1", "--device", "cpu",
                           "--production-mesh", "--distributed"] + ["--multi-pod"] * multi_pod)


def test_batch_rows_split_over_pod_and_data():
    """A rank's rows of the batch: ``(pod.rank * data.size + data.rank) *
    b``, as the reference's ``P(("pod", "data"))`` places them."""
    cfg = get_arch("smollm-360m").reduced()
    mesh = launch_mesh.make_local_mesh(2, 1, pods=2, device="cpu")
    model = build_model(cfg, ShardingConfig(batch_axes=("pod", "data")), mesh)
    rows = torch.arange(B * 2)[:, None]
    got = mesh.run(lambda ctx: (ctx.pod.rank, ctx.data.rank,
                                model.rank_rows({"tokens": rows})["tokens"][:, 0].tolist()))
    assert got == [(o, p, [2 * (o * 2 + p), 2 * (o * 2 + p) + 1]) for o in range(2)
                   for p in range(2)]
    caches = mesh.run(lambda ctx: model.init_caches_fn(B * 2, 16)[0]["k"].shape[0])
    assert caches == [2] * 4
