"""The training substrate of the port against the JAX package's: the
token stream (``uniform`` bit for bit, the tokens ==), AdamW, the
cosine schedule and clipping (within 1e-6 relative), microbatches, the
asynchronous checkpoint and ``restore``, the driver (resume ==, SIGTERM,
the loss falls and tracks the reference's), and the launcher."""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_rows import one_thread  # noqa: F401
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import DataConfig as RefDataConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import adamw_update as ref_adamw_update
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro.train import synthetic_batch as ref_synthetic_batch
from repro.train.optimizer import clip_by_global_norm as ref_clip
from repro.train.optimizer import cosine_schedule as ref_cosine
from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_opt_state, from_reference_params
from repro_torch.train import (
    AdamWConfig,
    CheckpointManager,
    DataConfig,
    TrainConfig,
    adamw_update,
    data_iterator,
    init_opt_state,
    make_train_step,
    opt_state_pspecs,
    synthetic_batch,
    train,
)
from repro_torch.train import train_loop
from repro_torch.train.data import _xla_exp, _xla_log
from repro_torch.train.optimizer import clip_by_global_norm, cosine_schedule

SEEDS = [0, 1, 7, 2**31 + 5]


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1, 7), (4, 16), (3, 1000), (8, 2048)])
def test_uniform_is_jax_uniform_bitwise(seed, shape):
    for step in (0, 3, 1000):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.key(seed), step),
                                             shape, minval=1e-6))
        got = prng.uniform(prng.fold_in(prng.key(seed), step), shape, minval=1e-6).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for lo, hi in ((0.0, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=lo, maxval=hi))
        got = prng.uniform(prng.key(seed), shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log_and_exp_are_xla_cpus_bitwise():
    """The stream's ``log`` and ``exp`` == XLA's CPU ``jnp.log``/``jnp.exp``
    on every tested float32 (torch's own differ in about 14% and 9%),
    special values and flushed denormals included."""
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.random(1 << 18).astype(np.float32) + np.float32(1e-6),
                        np.float32(10) ** rng.uniform(-30, 30, 1 << 16).astype(np.float32),
                        np.array([0, 1, 2, np.inf, -np.inf, np.nan, -1, -0.0, 1e-45, 1.17e-38],
                                 np.float32)])
    got, want = _xla_log(torch.from_numpy(u)).numpy(), np.asarray(jnp.log(u))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)  # NaN payloads aside
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))
    x = np.concatenate([rng.uniform(-100, 100, 1 << 18), rng.uniform(-5, 80, 1 << 18)]
                       ).astype(np.float32)
    np.testing.assert_array_equal(_xla_exp(torch.from_numpy(x)).numpy().view(np.int32),
                                  np.asarray(jnp.exp(x)).view(np.int32))


@pytest.mark.parametrize("vocab,batch,length", [(49152, 8, 2048), (1000, 4, 16), (256, 2, 128),
                                                (32064, 4, 512)])
def test_synthetic_batch_equals_reference(vocab, batch, length):
    """Every token == the reference's, for several (seed, step): the
    saturated int32 cast included (a 49,152 vocabulary's stream is about
    11% token 2147483647 % 49152 = 32767)."""
    for seed in (0, 1, 7):
        for step in (0, 3, 17):
            want = np.asarray(ref_synthetic_batch(RefDataConfig(vocab, batch, length, seed),
                                                  step)["tokens"])
            got = synthetic_batch(DataConfig(vocab, batch, length, seed), step, "cpu")["tokens"]
            assert got.dtype == torch.int32 and got.shape == (batch, length)
            np.testing.assert_array_equal(got.numpy(), want)
            if vocab == 49152:
                assert 0.09 < float((want == 32767).mean()) < 0.14


def test_stream_is_deterministic_and_needs_a_card_unless_asked(monkeypatch):
    cfg = DataConfig(vocab_size=1000, global_batch=4, seq_len=16, seed=7)
    it = data_iterator(cfg, start_step=3, device="cpu")
    a, b = next(it)["tokens"], next(it)["tokens"]
    assert torch.equal(a, synthetic_batch(cfg, 3, "cpu")["tokens"])
    assert torch.equal(b, synthetic_batch(cfg, 4, "cpu")["tokens"]) and not torch.equal(a, b)
    assert int(a.max()) < 1000 and int(a.min()) >= 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(cfg, 0)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opts", [dict(), dict(warmup_steps=3, total_steps=10, lr_peak=1e-2),
                                  dict(clip_norm=100.0), dict(weight_decay=0.0, b2=0.999)])
def test_adamw_steps_equal_reference(opts):
    """Twelve steps (warmup, decay, every step clipped at the default norm,
    none at 100) == the reference's within 1e-6 relative: weights, m, v,
    step, lr and the gradient norm."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    rp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    rs = ref_init_opt_state(rp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    ts = init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and all(m.dtype == torch.float32
                                                    for m in ts["m"].values())
    for _ in range(12):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in shapes.items()}
        rp, rs, rstats = ref_adamw_update(RefAdamWConfig(**opts), rp,
                                          {k: jnp.asarray(v) for k, v in g.items()}, rs)
        tp2, ts, tstats = adamw_update(AdamWConfig(**opts), tp,
                                       {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert tp2 is tp  # in place, as the reference's step donates
        assert int(ts["step"]) == int(rs["step"])
        for name, got, want in (("lr", tstats["lr"], rstats["lr"]),
                                ("grad_norm", tstats["grad_norm"], rstats["grad_norm"])):
            assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)), name
        for k in shapes:
            for got, want in ((tp[k], rp[k]), (ts["m"][k], rs["m"][k]), (ts["v"][k], rs["v"][k])):
                want = np.asarray(want)
                assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_schedule_and_clip_equal_reference():
    cfg, rcfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100), \
        RefAdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(ref_cosine(rcfg, jnp.asarray(step)))
        got = float(cosine_schedule(cfg, step))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12
    assert float(cosine_schedule(cfg, 0)) == 0.0
    assert float(cosine_schedule(cfg, 10)) == pytest.approx(1e-3)
    g = {"a": np.full((4,), 10.0, np.float32), "b": np.arange(6, dtype=np.float32)}
    for norm in (1.0, 100.0):
        clipped, gn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, norm)
        rclipped, rgn = ref_clip({k: jnp.asarray(v) for k, v in g.items()}, norm)
        assert abs(float(gn) - float(rgn)) <= 1e-6 * float(rgn)
        for k in g:
            np.testing.assert_allclose(clipped[k].numpy(), np.asarray(rclipped[k]), rtol=1e-6)
    assert float(clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)[0]["a"].norm()) == \
        pytest.approx(1.0, rel=1e-5)


def test_adamw_reduces_quadratic_and_refuses_cast_weights():
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    for _ in range(150):
        params, state, _ = adamw_update(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.5
    with pytest.raises(ValueError, match="float32"):
        adamw_update(cfg, {"w": torch.zeros(2, dtype=torch.bfloat16)}, {"w": torch.zeros(2)},
                     init_opt_state({"w": torch.zeros(2)}))
    # ZeRO-1's state specs: the first whole dimension that data divides
    specs = opt_state_pspecs({"w": ("model", None), "b": (None,), "x": ("data",)},
                             {"w": torch.zeros(4, 6), "b": torch.zeros(3), "x": torch.zeros(4)},
                             zero1=True, data_size=2)
    assert specs["m"] == {"w": ("model", "data"), "b": (None,), "x": ("data",)}
    assert specs["v"] == specs["m"] and specs["step"] == ()


def test_reference_state_carries_across():
    """The reference's AdamW state after a train step maps onto the port's
    names, as its weights do."""
    rcfg, cfg = ref_get_arch("qwen1.5-0.5b").reduced(), get_arch("qwen1.5-0.5b").reduced()
    params = ref_build_model(rcfg).init_fn(jax.random.key(0))
    names = [n for n, _ in from_reference_params(jax.tree.map(np.asarray, params), cfg)
             .named_parameters()]
    opt = ref_init_opt_state(params)
    step, _ = ref_make_train_step(ref_build_model(rcfg), RefTrainConfig())
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)), jnp.int32)
    _, opt, _ = step(params, opt, {"tokens": tokens})  # donates params and opt
    state = from_reference_opt_state(jax.tree.map(np.asarray, opt), cfg)
    assert sorted(state["m"]) == sorted(state["v"]) == sorted(names)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert any(float(m.abs().max()) > 0 for m in state["m"].values())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_async_checkpoint_round_trips(tmp_path):
    """The writer thread (the train loop's manager) round-trips nested trees;
    a bare manager writes synchronously, as the counting path needs."""
    assert not CheckpointManager(str(tmp_path / "bare")).async_save
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = {"params": {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)},
            "opt": {"m": {"a": torch.full((2, 3), 0.5)},
                    "step": torch.tensor(7, dtype=torch.int32)}}
    mgr.save(10, tree)
    mgr.save(20, {"params": {k: v * 2 for k, v in tree["params"].items()}, "opt": tree["opt"]})
    mgr.wait()
    assert mgr.all_steps() == [10, 20]
    out = mgr.restore(20, tree)
    assert torch.equal(out["params"]["a"], torch.arange(6.0).reshape(2, 3) * 2)
    assert torch.equal(out["opt"]["m"]["a"], tree["opt"]["m"]["a"])
    assert out["opt"]["step"].dtype == torch.int32 and int(out["opt"]["step"]) == 7
    mgr.save(30, tree, block=True)
    assert mgr.all_steps() == [20, 30]  # keep=2, and save(block=True) has written
    # the writer works on copies: an in-place update right after save is not saved
    w = torch.zeros(1 << 20)
    mgr.save(40, {"params": {"w": w}})
    w.add_(1.0)
    mgr.wait()
    assert float(mgr.restore(40, {"params": {"w": w}})["params"]["w"].abs().max()) == 0.0
    step, raw = CheckpointManager(str(tmp_path)).load_latest()
    assert step == 40 and sorted(raw["params"]) == ["w"]


def test_restore_rejects_shape_mismatch_and_bad_checksum(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": {"a": torch.ones(8)}})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"params": {"a": torch.ones(4)}})
    path = os.path.join(str(tmp_path), "step_00000001", "params.npz")
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))  # a flipped byte
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(1, {"params": {"a": torch.ones(8)}})


def test_counting_callers_save_synchronously(tmp_path):
    """The counting API and service write before ``save`` returns, so a
    kill after a save leaves that checkpoint."""
    from repro_torch.api import Counter
    from repro_torch.core.graphs import erdos_renyi

    c = Counter.from_graph(erdos_renyi(60, 4.0, seed=1), "u3-1", backend="single", device="cpu")
    c.estimate(n_iter=4, batch=2, checkpoint=str(tmp_path), checkpoint_every=1)
    assert CheckpointManager(str(tmp_path)).latest_step() is not None


# ---------------------------------------------------------------------------
# the step and the driver
# ---------------------------------------------------------------------------


def _captured_grads(monkeypatch):
    seen = []
    real = train_loop.adamw_update

    def spy(cfg, params, grads, state):
        seen.append({k: g.clone() for k, g in grads.items()})
        return real(cfg, params, grads, state)

    monkeypatch.setattr(train_loop, "adamw_update", spy)
    return seen


def test_microbatch_equivalence(monkeypatch):
    """Microbatches 1 and 4 over the same 8 rows: the same loss and
    gradients within 1e-5 relative (float32 compute)."""
    seen = _captured_grads(monkeypatch)
    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32))}
    losses = []
    for mb in (1, 4):
        params = model.init_fn(torch.Generator().manual_seed(0))
        step, _ = make_train_step(model, TrainConfig(microbatches=mb))
        _, _, metrics = step(params, init_opt_state(dict(params.named_parameters())), batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    g1, g4 = seen
    num = sum(float((g1[k] - g4[k]).square().sum()) for k in g1)
    den = sum(float(g1[k].square().sum()) for k in g1)
    assert (num / den) ** 0.5 <= 1e-5
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, TrainConfig(microbatches=3))[0](
            params, init_opt_state(dict(params.named_parameters())), batch)


def test_twenty_steps_track_the_reference():
    """From the reference's weights, 20 steps of the port's train step on
    the port's stream == 20 of the reference's on its stream (the same
    tokens): every loss within 1e-3 relative (bf16 compute)."""
    rcfg, cfg = ref_get_arch("smollm-360m").reduced(), get_arch("smollm-360m").reduced()
    rmodel = ref_build_model(rcfg)
    params = rmodel.init_fn(jax.random.key(0))
    opt = ref_init_opt_state(params)
    ropts = RefAdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=20)
    rstep, _ = ref_make_train_step(rmodel, RefTrainConfig(opt=ropts))
    p = from_reference_params(jax.tree.map(np.asarray, params), cfg)
    topt = init_opt_state(dict(p.named_parameters()))
    tstep, _ = make_train_step(build_model(cfg, device="cpu"), TrainConfig(
        opt=AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=20)))
    for s in range(20):
        params, opt, rm = rstep(params, opt, ref_synthetic_batch(
            RefDataConfig(cfg.vocab_size, 2, 128, 0), s))
        p, topt, tm = tstep(p, topt, synthetic_batch(DataConfig(cfg.vocab_size, 2, 128, 0), s,
                                                     "cpu"))
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-3 * float(rm["loss"]), s


def _tcfg(**kw):
    return TrainConfig(steps=20, opt=AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=20),
                       log_every=1, **kw)


def test_loss_falls_and_resume_equals_an_uninterrupted_run(tmp_path):
    """20 steps of smollm-360m reduced: the last five losses average below
    the first five; 10 steps, a checkpoint, then a fresh ``train`` that
    resumes and takes 10 more == 20 uninterrupted steps, bitwise."""
    model = build_model(get_arch("smollm-360m").reduced(), device="cpu")
    logs = []
    full = train(model, _tcfg(), log=logs.append)
    losses = [float(s.split("loss ")[1].split()[0]) for s in logs]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert "lr" in logs[0] and "gnorm" in logs[0]
    d = str(tmp_path / "ck")
    train(model, dataclasses.replace(_tcfg(checkpoint_dir=d, checkpoint_every=10), steps=10),
          log=lambda s: None)
    logs = []
    resumed = train(model, _tcfg(checkpoint_dir=d, checkpoint_every=10), log=logs.append)
    assert logs[0] == "restored checkpoint at step 10" and len(logs) == 11
    for (k, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), k
    for k in full["opt"]["m"]:
        assert torch.equal(full["opt"]["m"][k], resumed["opt"]["m"][k])
        assert torch.equal(full["opt"]["v"][k], resumed["opt"]["v"][k])
    assert int(resumed["opt"]["step"]) == 20


def test_sigterm_saves_after_the_step_and_exits(tmp_path, monkeypatch):
    """SIGTERM during step k (0-based) saves at k + 1 and stops there."""
    real = train_loop.synthetic_batch
    k = 3

    def batch_then_signal(cfg, step, device=None):
        if step == k:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg, step, device)

    monkeypatch.setattr(train_loop, "synthetic_batch", batch_then_signal)
    model = build_model(get_arch("smollm-360m").reduced(), device="cpu")
    logs = []
    before = signal.getsignal(signal.SIGTERM)
    out = train(model, _tcfg(checkpoint_dir=str(tmp_path), checkpoint_every=100),
                log=logs.append)
    assert signal.getsignal(signal.SIGTERM) == before
    assert logs[-1] == f"preemption: checkpoint saved at step {k + 1}; exiting"
    assert CheckpointManager(str(tmp_path)).all_steps() == [k + 1]
    assert int(out["opt"]["step"]) == k + 1


def test_train_refuses_a_mesh_and_cast_weights():
    """A mesh trains the rows (the model built on it); a sequence axis other
    than the model axis is refused; cast weights cannot train."""
    from repro_torch.configs import ShardingConfig
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 2, device="cpu")
    model = build_model(get_arch("smollm-360m").reduced(), ShardingConfig(batch_axes=("data",)),
                        mesh)
    out = train(model, TrainConfig(steps=1), mesh)
    assert int(out["opt"]["step"]) == 1 and np.isfinite(float(out["metrics"]["loss"]))
    _, shardings = make_train_step(model, TrainConfig(), mesh)
    assert shardings["params"]["embed"] == ("model", None)
    with pytest.raises(ValueError, match="model axis"):
        build_model(get_arch("rwkv6-3b").reduced(), ShardingConfig(seq_axis="pod"), mesh=mesh,
                    device="cpu")
    with pytest.raises(ValueError, match="cast_params"):
        make_train_step(build_model(get_arch("smollm-360m").reduced(), cast_params=True,
                                    device="cpu"), TrainConfig())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_takes_three_steps_on_the_cpu(tmp_path):
    out = launch_train.main(["--arch", "qwen1.5-0.5b", "--steps", "3", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--microbatches", "2"])
    assert int(out["opt"]["step"]) == 3 and np.isfinite(float(out["metrics"]["loss"]))


@pytest.mark.parametrize("flags", [["--production-mesh"], ["--multi-pod"],
                                   ["--production-mesh", "--data", "2", "--arch", "rwkv6-3b"],
                                   ["--multi-pod", "--model", "2", "--arch",
                                    "recurrentgemma-2b"],
                                   ["--production-mesh", "--distributed", "--arch",
                                    "recurrentgemma-2b"]])
def test_launcher_refuses_every_mesh_flag(flags, monkeypatch):
    """The production meshes train (their shapes made small here: 2 x 2, and
    pods 2 x 1 x 2), whatever row and local mesh flags come with them, as
    the reference's branch: ``--production-mesh`` overrides ``--data`` and
    ``--model``, ``--multi-pod`` alone does nothing; under ``--distributed``
    a world of another size than the mesh's raises before joining it."""
    from repro_torch.launch import mesh as launch_mesh

    argv = ["--arch", "smollm-360m", "--steps", "1", "--device", "cpu"] + flags
    if "--distributed" in flags:  # the production shapes: a world of 1 is neither
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(ValueError, match=r"256 ranks \(512 with --multi-pod\)"):
            launch_train.main(argv)
        return
    monkeypatch.setitem(launch_mesh.PRODUCTION_AXES, False, (("data", 2), ("model", 2)))
    monkeypatch.setitem(launch_mesh.PRODUCTION_AXES, True,
                        (("pod", 2), ("data", 1), ("model", 2)))
    out = launch_train.main(argv)
    assert int(out["opt"]["step"]) == 1 and np.isfinite(float(out["metrics"]["loss"]))


@pytest.mark.parametrize("flags", [["--data", "2"], ["--model", "2"], ["--data", "2", "--model",
                                                                       "2"]])
def test_launcher_takes_the_local_mesh_flags(flags):
    out = launch_train.main(["--arch", "smollm-360m", "--steps", "1", "--device", "cpu"] + flags)
    assert int(out["opt"]["step"]) == 1 and np.isfinite(float(out["metrics"]["loss"]))


def test_launcher_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "smollm-360m", "--steps", "1"])
