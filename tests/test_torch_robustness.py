"""Resumable, fault-tolerant estimation in the port (DESIGN.md §16).

The reference's ``tests/test_robustness.py`` on the port's single backend
(CPU, plain versions): a killed estimate resumed from its checkpoint
returns the **bit-identical** result an uninterrupted run produces, at
every checkpoint boundary and when the kill lands inside a checkpoint
write; around it, the supervisor's retry/validate/quarantine taxonomy and
the checkpoint manager's corrupt-skip and crash-residue handling.  Every
failure is injected deterministically through the port's own
``repro_torch.testing.faults``.  The compaction variant (resume under an
overflow storm) is in ``test_torch_compaction.py``, the family one in
``test_torch_family.py``, the distributed one in
``test_torch_distributed.py``.
"""

import os

import numpy as np
import pytest

from repro_torch.api import Counter
from repro_torch.core import prng
from repro_torch.core.graphs import erdos_renyi
from repro_torch.core.estimator import (
    EstimationAborted,
    EstimatorState,
    ResumeMismatchError,
    estimate_counts,
)
from repro_torch.core.supervisor import (
    QuarantinedBatch,
    RetryPolicy,
    SampleValidationError,
    Supervisor,
    key_fingerprint,
)
from repro_torch.core.templates import path_tree
from repro_torch.testing import faults
from repro_torch.train.checkpoint import CheckpointManager


def _noop_sleep(_):
    pass


class FakeClock:
    """Virtual time: ``sleep`` advances the clock instead of waiting, so
    timeout/backoff paths run in zero wall time (the Supervisor's
    injected-clock mode judges timeouts from clock readings)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _mgr(tmp_path, sub="ckpt"):
    return CheckpointManager(str(tmp_path / sub))


# --------------------------------------------------------------------------
# kill-and-resume determinism
# --------------------------------------------------------------------------

BACKENDS = [
    ("single", {"device": "cpu"}),
    ("single", {"device": "cpu", "spmm_kind": "blocks", "fuse": True}),
]


class TestResumeDeterminism:
    """Bit-exact resume: the tentpole invariant, at every boundary."""

    def _counter(self, backend, opts, **extra):
        g = erdos_renyi(40, 4.0, seed=5)
        return Counter.from_graph(g, path_tree(3), backend=backend, **opts, **extra)

    @pytest.mark.parametrize("backend,opts", BACKENDS, ids=["edges", "blocks-fuse"])
    def test_kill_and_resume_every_boundary(self, backend, opts, tmp_path):
        """n_iter=12 / batch=4 => 3 calls, mid-run checkpoints after calls
        1 and 2.  Kill after each and resume: samples, estimate, and RSD
        must equal the uninterrupted run exactly (==, not approx)."""
        key = prng.key(0)
        base = self._counter(backend, opts).estimate(n_iter=12, key=key, batch=4)
        for kill_at in (0, 1):
            d = tmp_path / f"{backend}-{kill_at}"
            c = self._counter(backend, opts)
            with faults.active(faults.inject("estimator.kill", at=(kill_at,))):
                with pytest.raises(faults.InjectedCrash):
                    c.estimate(n_iter=12, key=key, batch=4, checkpoint=str(d), checkpoint_every=4)
            res = self._counter(backend, opts).estimate(n_iter=12, key=key, batch=4, resume=str(d))
            assert res.resumed_from == 4 * (kill_at + 1)
            np.testing.assert_array_equal(res.samples, base.samples)
            assert res.estimate == base.estimate
            assert res.mean == base.mean
            assert res.relative_sd == base.relative_sd
            assert res.quarantined == ()

    @pytest.mark.parametrize("backend,opts", BACKENDS, ids=["edges", "blocks-fuse"])
    def test_kill_inside_checkpoint_write(self, backend, opts, tmp_path):
        """The worst kill: inside ``_write``, after the tmp dir is full but
        before the atomic rename.  The ``step_*.tmp`` residue must be
        skipped/GCed and the run resumes from the last *renamed* step."""
        key = prng.key(1)
        base = self._counter(backend, opts).estimate(n_iter=12, key=key, batch=4)
        d = tmp_path / "midwrite"
        c = self._counter(backend, opts)
        # second checkpoint write (occurrence 1) dies mid-save: step 1 is
        # the newest *renamed* checkpoint, step 2 exists only as .tmp
        with faults.active(faults.inject("checkpoint.write_crash", at=(1,))):
            with pytest.raises(faults.InjectedCrash):
                c.estimate(n_iter=12, key=key, batch=4, checkpoint=str(d), checkpoint_every=4)
        left = sorted(os.listdir(d))
        assert "step_00000001" in left
        assert any(name.endswith(".tmp") for name in left)
        res = self._counter(backend, opts).estimate(n_iter=12, key=key, batch=4, resume=str(d))
        assert res.resumed_from == 4  # resumed from step 1, not the tmp
        np.testing.assert_array_equal(res.samples, base.samples)
        assert res.estimate == base.estimate
        # the residue is gone after load_latest's GC
        assert not any(n.endswith(".tmp") for n in os.listdir(d))

    def test_completed_run_resumes_as_noop(self, tmp_path):
        """A finished checkpoint directory restores to a no-op: zero new
        backend calls, same result."""
        calls = []

        def fn(key, b):
            calls.append(1)
            return np.full(b, 7.0)

        key = prng.key(4)
        mgr = _mgr(tmp_path)
        est = estimate_counts(fn, 12, key, batch=4, checkpoint=mgr, checkpoint_every=4)
        assert len(calls) == 3
        latest = mgr.load_latest()
        assert latest is not None and latest[0] == 3
        state = EstimatorState.from_arrays(latest[1]["estimator"])
        res = estimate_counts(fn, 12, key, batch=4, resume=state)
        assert len(calls) == 3  # no new sampling
        assert res.resumed_from == 12 and res.niter == 12
        np.testing.assert_array_equal(res.samples, est.samples)
        assert res.estimate == est.estimate

    def test_resume_signature_mismatch_is_fatal(self, tmp_path):
        """Splicing two different runs would silently bias the estimate —
        the signature check makes it a hard error, for every knob that
        changes the sample stream."""
        g = erdos_renyi(40, 4.0, seed=5)
        d = tmp_path / "sig"
        c = Counter.from_graph(g, path_tree(3), backend="single", device="cpu")
        c.estimate(n_iter=12, key=prng.key(0), batch=4, checkpoint=str(d), checkpoint_every=4)
        fresh = Counter.from_graph(g, path_tree(3), backend="single", device="cpu")
        for kw in (dict(n_iter=16, key=prng.key(0), batch=4),
                   dict(n_iter=12, key=prng.key(9), batch=4),
                   dict(n_iter=12, key=prng.key(0), batch=6),
                   dict(n_iter=12, key=prng.key(0), batch=4,
                        delta=0.05)):
            with pytest.raises(ResumeMismatchError):
                fresh.estimate(resume=str(d), **kw)
        # different template: also fatal (signature_extra carries it)
        other = Counter.from_graph(g, path_tree(4), backend="single", device="cpu")
        with pytest.raises(ResumeMismatchError):
            other.estimate(n_iter=12, key=prng.key(0), batch=4, resume=str(d))

    def test_resume_without_checkpoint_dir_raises(self):
        g = erdos_renyi(30, 4.0, seed=1)
        c = Counter.from_graph(g, path_tree(3), backend="single", device="cpu")
        with pytest.raises(ValueError, match="resume requires"):
            c.estimate(n_iter=4, key=prng.key(0), resume=True)

    def test_early_stop_counts_restored_samples(self, tmp_path):
        """The ``target_rsd`` early stop (and progress) start from the
        restored bank, not from zero: a resumed run whose banked samples
        already satisfy the target makes ZERO new backend calls."""
        calls = []

        def fn(key, b):
            calls.append(1)
            return np.full(b, 7.0)  # constant stream: rse == 0 at n >= 2

        key = prng.key(5)
        mgr = _mgr(tmp_path)
        with faults.active(faults.inject("estimator.kill", at=(0,))):
            with pytest.raises(faults.InjectedCrash):
                estimate_counts(fn, 12, key, batch=4, checkpoint=mgr, checkpoint_every=4)
        assert len(calls) == 1
        state = EstimatorState.from_arrays(mgr.load_latest()[1]["estimator"])
        assert state.done == 4
        res = estimate_counts(fn, 12, key, batch=4, resume=state, target_rsd=0.5)
        assert len(calls) == 1  # banked samples alone met the target
        assert res.niter == 4 and res.resumed_from == 4
        assert res.mean == 7.0


# --------------------------------------------------------------------------
# supervisor: retry / validate / quarantine
# --------------------------------------------------------------------------


class TestSupervisor:
    def _fn(self, value=3.0):
        def fn(key, b):
            return np.full(b, value)

        return fn

    def test_transient_fault_retried_same_key(self):
        """A raise on the first attempt retries with the SAME key, so the
        eventual success is bit-identical to a clean first try."""
        seen = []

        def fn(key, b):
            seen.append(key_fingerprint(key))
            return np.full(b, 3.0)

        sup = Supervisor(fn, RetryPolicy(max_retries=2), sleep=_noop_sleep)
        key = prng.key(0)
        with faults.active(faults.inject("sample.raise", at=(0,))):
            out = sup(key, 4)
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, np.full(4, 3.0))
        assert sup.quarantined == []
        assert len(seen) == 1  # the faulted attempt raised before fn ran

    def test_persistent_fault_quarantines_with_bounded_attempts(self):
        sleeps = []
        sup = Supervisor(
            self._fn(),
            RetryPolicy(max_retries=2, backoff_s=0.01),
            sleep=sleeps.append,
        )
        with faults.active(faults.inject("sample.raise", at=None)):
            out = sup(prng.key(0), 4, call_index=7)
        assert isinstance(out, QuarantinedBatch)
        assert out.attempts == 3  # 1 try + 2 retries, then give up
        assert out.call_index == 7
        assert "InjectedFault" in out.reason
        assert sup.quarantined == [out]
        # exponential backoff between attempts
        assert sleeps == [0.01, 0.02]

    @pytest.mark.parametrize("site,needle", [
        ("sample.nan", "non-finite"),
        ("sample.negative", "negative copy estimate"),
    ])
    def test_corrupt_payload_is_hard_fault(self, site, needle):
        """NaN/negative payloads are data corruption, not noise: exactly
        one attempt, no retry, immediate quarantine."""
        sleeps = []
        sup = Supervisor(self._fn(), RetryPolicy(max_retries=5), sleep=sleeps.append)
        with faults.active(faults.inject(site, at=None)):
            out = sup(prng.key(0), 4)
        assert isinstance(out, QuarantinedBatch)
        assert out.attempts == 1
        assert needle in out.reason
        assert sleeps == []  # never backed off: hard faults don't retry

    def test_shape_violation_is_hard_fault(self):
        sup = Supervisor(lambda key, b: np.zeros(b + 1),
                         RetryPolicy(max_retries=3), sleep=_noop_sleep)
        out = sup(prng.key(0), 4)
        assert isinstance(out, QuarantinedBatch) and out.attempts == 1
        assert "batch=4" in out.reason

    @pytest.mark.timeout(60)
    def test_timeout_then_retry(self):
        """A hung attempt surfaces as a timeout and the retry (same key)
        succeeds — on a virtual clock, so the 0.5s "hang" and the backoff
        cost zero wall time."""
        clk = FakeClock()
        sup = Supervisor(
            self._fn(9.0),
            RetryPolicy(max_retries=1, timeout_s=0.1, backoff_s=0.0),
            sleep=clk.sleep,
            clock=clk,
        )
        with faults.active(faults.inject("sample.timeout", at=(0,), payload=0.5)) as plan:
            out = sup(prng.key(0), 4)
        np.testing.assert_array_equal(out, np.full(4, 9.0))
        assert sup.quarantined == []
        assert plan.fired == [("sample.timeout", 0)]  # the hang really happened

    @pytest.mark.timeout(60)
    def test_timeout_real_thread(self):
        """With the default (real) clock the attempt runs on a worker
        thread and a genuine hang is detected in real time."""
        sup = Supervisor(
            self._fn(9.0),
            RetryPolicy(max_retries=1, timeout_s=0.05, backoff_s=0.0),
        )
        with faults.active(faults.inject("sample.timeout", at=(0,), payload=0.3)):
            out = sup(prng.key(0), 4)
        np.testing.assert_array_equal(out, np.full(4, 9.0))
        assert sup.quarantined == []

    def test_quarantine_excluded_from_estimate(self):
        """End to end through estimate_counts: the poisoned batch is
        excluded from the aggregates and surfaced on the result, and the
        healthy batches are exactly the unfaulted run's."""
        g = erdos_renyi(40, 4.0, seed=5)
        key = prng.key(0)
        c = Counter.from_graph(g, path_tree(3), backend="single", device="cpu")
        base = c.estimate(n_iter=12, key=key, batch=4)
        sup = Supervisor(c.sample_fn, RetryPolicy(max_retries=2), sleep=_noop_sleep)
        # the second batch fails on every attempt (occurrences count
        # attempts: batch 0 is occurrence 0, batch 1's three tries are 1-3)
        with faults.active(faults.inject("sample.raise", at=(1, 2, 3))):
            est = estimate_counts(sup, 12, key, batch=4)
        assert len(est.quarantined) == 1
        q = est.quarantined[0]
        assert q.call_index == 1 and q.attempts == 3
        assert est.niter == 8
        np.testing.assert_array_equal(
            est.samples, np.concatenate([base.samples[:4], base.samples[8:]])
        )
        assert np.isfinite(est.estimate)

    def test_all_quarantined_aborts(self):
        sup = Supervisor(self._fn(), RetryPolicy(max_retries=0), sleep=_noop_sleep)
        with faults.active(faults.inject("sample.raise", at=None)):
            with pytest.raises(EstimationAborted, match="quarantined"):
                estimate_counts(sup, 8, prng.key(0), batch=4)

    def test_validate_directly(self):
        with pytest.raises(SampleValidationError):
            Supervisor._validate(np.array([1.0, np.inf]), 2)
        with pytest.raises(SampleValidationError):
            Supervisor._validate(np.array([1.0, -2.0]), 2)
        Supervisor._validate(np.array([0.0, 2.0]), 2)  # clean: no raise


# --------------------------------------------------------------------------
# checkpoint manager hardening
# --------------------------------------------------------------------------


class TestCheckpointManager:
    def _save(self, mgr, step, value):
        mgr.save(step, {"estimator": {"x": np.full(3, float(value))}})

    def test_load_latest_skips_corrupt_step(self, tmp_path, capsys):
        mgr = _mgr(tmp_path)
        self._save(mgr, 1, 1.0)
        self._save(mgr, 2, 2.0)
        # flip bits in the newest step's payload: sha256 must catch it
        bad = tmp_path / "ckpt" / "step_00000002" / "estimator.npz"
        bad.write_bytes(b"garbage" + bad.read_bytes()[7:])
        step, data = mgr.load_latest()
        assert step == 1
        np.testing.assert_array_equal(data["estimator"]["x"], np.full(3, 1.0))
        assert "skipping unreadable step 2" in capsys.readouterr().out

    def test_load_latest_skips_missing_manifest(self, tmp_path):
        mgr = _mgr(tmp_path)
        self._save(mgr, 1, 1.0)
        self._save(mgr, 2, 2.0)
        os.remove(tmp_path / "ckpt" / "step_00000002" / "manifest.json")
        assert mgr.load_latest()[0] == 1

    def test_empty_dir_loads_none(self, tmp_path):
        assert _mgr(tmp_path).load_latest() is None

    def test_stale_tmp_gc_on_save_and_load(self, tmp_path):
        mgr = _mgr(tmp_path)
        residue = tmp_path / "ckpt" / "step_00000009.tmp"
        residue.mkdir()
        (residue / "junk.npz").write_bytes(b"\x00")
        self._save(mgr, 1, 1.0)  # save GCs residue before writing
        assert not residue.exists()
        residue.mkdir()
        assert mgr.load_latest()[0] == 1  # load GCs it too
        assert not residue.exists()

    def test_write_crash_leaves_previous_latest_intact(self, tmp_path):
        mgr = _mgr(tmp_path)
        self._save(mgr, 1, 1.0)
        with faults.active(faults.inject("checkpoint.write_crash")):
            with pytest.raises(faults.InjectedCrash):
                self._save(mgr, 2, 2.0)
        assert (tmp_path / "ckpt" / "step_00000002.tmp").exists()
        step, data = mgr.load_latest()
        assert step == 1
        np.testing.assert_array_equal(data["estimator"]["x"], np.full(3, 1.0))

    def test_keep_pruning_spares_restored_step(self, tmp_path):
        """The checkpoint a live run restored from is never pruned, even
        when ``keep`` new checkpoints land on top of it."""
        mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
        self._save(mgr, 1, 1.0)
        assert mgr.load_latest()[0] == 1  # a resume pins step 1
        for s in range(2, 6):
            self._save(mgr, s, float(s))
        assert mgr.all_steps() == [1, 4, 5]  # 2..3 pruned, 1 protected

    def test_estimator_state_roundtrip(self):
        q = (
            QuarantinedBatch(3, (7, 11), "InjectedFault: boom", 4),
            QuarantinedBatch(5, (13, 17), "non-finite (NaN/Inf)", 1),
        )
        state = EstimatorState(
            signature="g|V=10|E=20|p3|single|n_iter=12|batch=4|delta=0.1|key=1,2",
            n_iter=12,
            batch=4,
            delta=0.1,
            cursor=6,
            samples=np.arange(20, dtype=np.float64).reshape(10, 2),
            quarantined=q,
        )
        back = EstimatorState.from_arrays(state.to_arrays())
        assert back.signature == state.signature
        assert (back.n_iter, back.batch, back.delta, back.cursor) == (12, 4, 0.1, 6)
        np.testing.assert_array_equal(back.samples, state.samples)
        assert back.quarantined == q


# --------------------------------------------------------------------------
# fault-injection harness itself
# --------------------------------------------------------------------------


class TestFaultHarness:
    def test_occurrence_indexing(self):
        with faults.active(faults.inject("x", at=(1, 3))) as plan:
            hits = [faults.fire("x") is not None for _ in range(5)]
        assert hits == [False, True, False, True, False]
        assert plan.fired == [("x", 1), ("x", 3)]

    def test_at_none_fires_always(self):
        with faults.active(faults.inject("x", at=None)):
            assert all(faults.fire("x") is not None for _ in range(4))

    def test_inactive_site_is_silent(self):
        assert faults.fire("nonexistent.site") is None
        with faults.active(faults.inject("x")):
            assert faults.fire("y") is None

    def test_no_nesting(self):
        with faults.active(faults.inject("x")):
            with pytest.raises(RuntimeError, match="already active"):
                with faults.active(faults.inject("y")):
                    pass
        assert not faults.is_active()

    def test_payload_carried(self):
        with faults.active(faults.inject("x", payload=0.25)):
            assert faults.fire("x").payload == 0.25
