"""The counting service of the port (CPU, plain versions) against the JAX
reference's service, and against its own contract.

Parity: the reference's ``CountingService(backend="single")`` and the
port's run the ``smoke-service`` and ``bench-service`` scripts on one graph
from a numpy seed, and are held ``==`` in what the scheduler decides
(statuses, ``niter``, completion order, every stats counter) and within
``RTOL`` in what the passes compute, because the reference scales its maps
in float32 and the port in float64 (``tests/test_torch_family.py``).

Contract: every request that completes equals a solo ``Counter.estimate``
/ ``estimate_many`` of the port with the same ``(key, batch, n_colors,
n_iter, delta, target_rsd)``, bitwise — the classes below are the port's
counterparts of ``tests/test_service.py``'s, one for one.
"""

import dataclasses
import gc
import itertools
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro.api import CountRequest as RefCountRequest
from repro.api import Counter as RefCounter
from repro.api import run as ref_run
from repro.configs import SERVICE_WORKLOADS as REF_WORKLOADS
from repro.core.graphs import Graph as RefGraph
from repro.serve import CountingService as RefService
from repro.serve import ServiceConfig as RefConfig
from repro_torch import api
from repro_torch.api import Counter, CountRequest, run
from repro_torch.configs.subgraph import SERVICE_WORKLOADS
from repro_torch.core import prng
from repro_torch.core.distributed import global_coloring
from repro_torch.core.estimator import call_key, estimate_counts
from repro_torch.core.graphs import erdos_renyi
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    CountingService,
    PlanCache,
    QueueFullError,
    ServiceConfig,
    UnsatisfiableRequestError,
)
from repro_torch.testing import faults

#: two float32 ulps: the reference's scale and its product round in float32
RTOL = 2.4e-7
K = 5  # service-wide color budget for every test service
BATCH = 4
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The graphs here are tiny: one intra-op thread, so that the service's
    own threads do not wait on a pool contended by other test processes."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(60, 8.0, seed=1)


def _ref_graph(g):
    return RefGraph(g.n, g.indptr, g.indices, g.name)


def service(graph, **cfg_kw):
    cfg = ServiceConfig(batch=BATCH, **cfg_kw)
    return CountingService(graph, n_colors=K, backend="single", plan_opts=CPU, config=cfg)


class FakeClock:
    """Virtual time shared by service deadlines and the pass supervisor:
    ``sleep`` advances the clock instead of waiting, so timeout/expiry
    paths run in zero wall time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def vservice(graph, clock, **cfg_kw):
    """A service on a virtual clock (deadlines + supervisor timeouts)."""
    cfg = ServiceConfig(batch=BATCH, **cfg_kw)
    return CountingService(graph, n_colors=K, backend="single", plan_opts=CPU, config=cfg,
                           clock=clock, sleep=clock.sleep)


def counter(graph, template="u3-1"):
    return Counter.from_graph(graph, template, backend="single", n_colors=K, device="cpu")


def solo(graph, template, n_iter, key=None, **kw):
    key = prng.key(0) if key is None else key
    return counter(graph, template).estimate(n_iter, key=key, batch=BATCH, **kw)


def solo_many(graph, templates, n_iter, key=None, **kw):
    key = prng.key(0) if key is None else key
    return counter(graph, templates[0]).estimate_many(templates, n_iter, key=key, batch=BATCH,
                                                      **kw)


def _drop_quarantined(solo_samples, quarantined, batch):
    """Solo samples with a request's quarantined call rows excluded — what
    a surviving degraded result must equal bit for bit."""
    arr = np.asarray(solo_samples)
    drop = {q.call_index for q in quarantined}
    keep = [arr[i * batch:(i + 1) * batch] for i in range(arr.shape[0] // batch) if i not in drop]
    return np.concatenate(keep, axis=0) if keep else arr[:0]


# --------------------------------------------------------------------------
# parity with the reference's service
# --------------------------------------------------------------------------

SCRIPTS = ("smoke-service", "bench-service")
COUNTERS = ("submitted", "completed", "failed", "pass_calls", "request_calls",
            "backfill_calls", "history_rides", "quarantined", "result_hits", "result_misses")


def _run_script(svc, wl):
    tickets = [svc.submit(tenant, templates, **kw)
               for _ in range(wl.repeats) for tenant, templates, kw in wl.requests]
    svc.run_until_idle()
    return tickets


def _summary(svc, tickets):
    s = svc.stats()
    results = [t.result() for t in tickets]
    return {
        "status": [t.status for t in tickets],
        "niter": [r.niter for r in results],
        "order": [t.id for t in svc.completed],
        "stats": {k: s.get(k, 0) for k in COUNTERS}
        | {"cache": {k: s["cache"][k] for k in ("hits", "misses", "evictions")},
           "coalescing_factor": s["coalescing_factor"]},
        "estimates": [np.atleast_1d(r.estimates if hasattr(r, "estimates") else r.estimate)
                      for r in results],
        "samples": [np.asarray(r.samples) for r in results],
    }


@pytest.fixture(scope="module")
def reference_runs(graph):
    """Both scripts through the reference's service, once per module."""
    rg = _ref_graph(graph)
    out = {}
    for name in SCRIPTS:
        wl = REF_WORKLOADS[name]
        svc = RefService(rg, n_colors=wl.k, backend="single", config=RefConfig(batch=wl.batch))
        out[name] = _summary(svc, _run_script(svc, wl))
    return out


@pytest.mark.parametrize("workload", SCRIPTS)
def test_service_script_matches_reference(graph, reference_runs, workload):
    wl = SERVICE_WORKLOADS[workload]
    svc = CountingService(graph, n_colors=wl.k, backend="single", plan_opts=CPU,
                          config=ServiceConfig(batch=wl.batch))
    mine, ref = _summary(svc, _run_script(svc, wl)), reference_runs[workload]
    for field in ("status", "niter", "order", "stats"):
        assert mine[field] == ref[field], field
    assert mine["stats"]["coalescing_factor"] > 1.0
    for a, b in zip(mine["estimates"] + mine["samples"], ref["estimates"] + ref["samples"]):
        np.testing.assert_allclose(a, b, rtol=RTOL)


def test_service_workloads_are_the_references():
    assert set(SERVICE_WORKLOADS) == set(REF_WORKLOADS)
    for name, wl in SERVICE_WORKLOADS.items():
        assert dataclasses.asdict(wl) == dataclasses.asdict(REF_WORKLOADS[name])
        assert wl.counting_config().name == REF_WORKLOADS[name].counting_config().name


def test_sample_stream_matches_reference(graph):
    c = Counter.from_graph(graph, "u5-2", device="cpu")
    r = RefCounter.from_graph(_ref_graph(graph), "u5-2", backend="single", impl="xla")
    mine = list(itertools.islice(c.sample_stream(batch=BATCH), 3))
    theirs = list(itertools.islice(r.sample_stream(batch=BATCH), 3))
    for a, b in zip(mine, theirs):
        assert a.dtype == np.float64 and a.shape == (BATCH,)
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL)
    # reproducible from the key, and each step's key is its own
    again = list(itertools.islice(c.sample_stream(prng.key(0), batch=BATCH), 3))
    for a, b in zip(mine, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(mine[0], mine[1])


def test_run_matches_reference(graph):
    mine = run(CountRequest(graph, "u5-2", backend="single", n_iter=16, batch=BATCH,
                            plan_opts=CPU, target_rsd=0.5))
    theirs = ref_run(RefCountRequest(_ref_graph(graph), "u5-2", backend="single", n_iter=16,
                                     batch=BATCH, plan_opts={"impl": "xla"}, target_rsd=0.5))
    assert mine.niter == theirs.niter
    np.testing.assert_allclose(mine.samples, np.asarray(theirs.samples), rtol=RTOL)
    assert mine.estimate == pytest.approx(theirs.estimate, rel=RTOL)
    solo_run = counter(graph, "u5-2").estimate(16, key=prng.key(0), batch=BATCH, target_rsd=0.5)
    assert mine.niter == solo_run.niter  # n_colors = the template's own 5


def test_mixed_family_fails_as_reference(graph):
    """A family that mixes trees and treewidth-2 templates fails in the port
    where it fails in the reference: submit admits it, and the first
    scheduling step raises the same exception type (``family_signature``
    and the pass union sort tree and bag signatures together)."""
    ref = RefService(_ref_graph(graph), n_colors=K, backend="single",
                     config=RefConfig(batch=BATCH))
    mine = service(graph)
    errors = []
    for svc in (ref, mine):
        ticket = svc.submit("a", ("u3-1", "cycle4"), n_iter=4)
        assert ticket.status == "queued"
        with pytest.raises(Exception) as ei:
            svc.step()
        errors.append(ei.value)
    assert type(errors[1]) is type(errors[0]) is TypeError


# --------------------------------------------------------------------------
# the port's counterparts of tests/test_service.py
# --------------------------------------------------------------------------


class TestSoloEquivalence:
    def test_three_tenant_coalesced_bit_identical(self, graph):
        svc = service(graph)
        ta = svc.client("alice").submit("u3-1", n_iter=24)
        tb = svc.client("bob").submit(("u3-1", "u5-2"), n_iter=16)
        tc = svc.client("carol").submit("u5-2", n_iter=20)
        svc.run_until_idle()
        ra, rb, rc = ta.result(), tb.result(), tc.result()
        sa, sb, sc = solo(graph, "u3-1", 24), solo_many(graph, ("u3-1", "u5-2"), 16), \
            solo(graph, "u5-2", 20)
        np.testing.assert_array_equal(ra.samples, sa.samples)
        np.testing.assert_array_equal(rb.samples, sb.samples)
        np.testing.assert_array_equal(rc.samples, sc.samples)
        assert ra.estimate == sa.estimate and rc.estimate == sc.estimate
        assert np.array_equal(rb.estimates, sb.estimates)
        assert rb.unique_tables == sb.unique_tables and rb.chain_tables == sb.chain_tables
        stats = svc.stats()
        assert stats["coalescing_factor"] > 1.0
        assert stats["pass_calls"] < 24 // BATCH + 16 // BATCH + 20 // BATCH

    def test_early_stop_matches_solo(self, graph):
        svc = service(graph)
        t1 = svc.client("a").submit("u3-1", n_iter=60, target_rsd=0.25)
        t2 = svc.client("b").submit("u5-2", n_iter=60)
        svc.run_until_idle()
        s1 = solo(graph, "u3-1", 60, target_rsd=0.25)
        r1 = t1.result()
        assert r1.niter == s1.niter
        np.testing.assert_array_equal(r1.samples, s1.samples)
        assert r1.estimate == s1.estimate
        np.testing.assert_array_equal(t2.result().samples, solo(graph, "u5-2", 60).samples)

    def test_distinct_keys_distinct_streams(self, graph):
        svc = service(graph)
        t1 = svc.client("a").submit("u3-1", n_iter=12)
        t2 = svc.client("a").submit("u3-1", n_iter=12, key=prng.key(9))
        svc.run_until_idle()
        assert not np.array_equal(t1.result().samples, t2.result().samples)
        np.testing.assert_array_equal(t2.result().samples,
                                      solo(graph, "u3-1", 12, key=prng.key(9)).samples)


class TestMidStreamJoin:
    def test_join_rides_history(self, graph):
        svc = service(graph)
        ta = svc.client("a").submit(("u3-1", "u5-2"), n_iter=40)
        for _ in range(4):
            svc.step()
        tb = svc.client("b").submit("u3-1", n_iter=16)
        svc.run_until_idle()
        stats = svc.stats()
        assert stats.get("history_rides", 0) > 0 and stats.get("backfill_calls", 0) == 0
        np.testing.assert_array_equal(tb.result().samples, solo(graph, "u3-1", 16).samples)
        np.testing.assert_array_equal(ta.result().samples,
                                      solo_many(graph, ("u3-1", "u5-2"), 40).samples)

    def test_join_backfills_missing_columns(self, graph):
        svc = service(graph)
        svc.client("a").submit("u3-1", n_iter=40)
        for _ in range(4):
            svc.step()
        tb = svc.client("b").submit("u5-2", n_iter=16)
        svc.run_until_idle()
        assert svc.stats().get("backfill_calls", 0) > 0
        np.testing.assert_array_equal(tb.result().samples, solo(graph, "u5-2", 16).samples)

    def test_join_with_target_rsd_stops_consistently(self, graph):
        svc = service(graph)
        svc.client("a").submit("u3-1", n_iter=80)
        for _ in range(12):
            svc.step()
        tb = svc.client("b").submit("u3-1", n_iter=80, target_rsd=0.25)
        svc.run_until_idle()
        sb, rb = solo(graph, "u3-1", 80, target_rsd=0.25), tb.result()
        assert rb.niter == sb.niter
        np.testing.assert_array_equal(rb.samples, sb.samples)
        assert rb.estimate == sb.estimate


class TestPlanCache:
    def test_repeat_requests_hit(self, graph):
        svc = service(graph)
        svc.client("a").submit(("u3-1", "u5-2"), n_iter=8)
        svc.run_until_idle()
        svc.client("b").submit(("u5-2", "u3-1"), n_iter=8)  # order-insensitive
        svc.run_until_idle()
        assert svc.plan_cache.hits > 0 and svc.plan_cache.misses == 1
        assert svc.plan_cache.hit_rate > 0

    def test_lru_eviction_purges_family_state(self, graph):
        svc = service(graph, plan_cache_capacity=1)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        svc.client("a").submit("u5-2", n_iter=8)
        svc.run_until_idle()
        assert svc.plan_cache.evictions >= 1 and len(svc.plan_cache) == 1
        assert len(svc._counter._families) <= 1

    def test_unit_cache_standalone(self):
        calls = []
        cache = PlanCache(2, on_evict=lambda e: calls.append(e["trees"]))
        cache.get(("a",), lambda: {"trees": "A"})
        cache.get(("b",), lambda: {"trees": "B"})
        cache.get(("a",), lambda: {"trees": "A2"})  # hit; refreshes LRU slot
        cache.get(("c",), lambda: {"trees": "C"})  # evicts b, not a
        assert cache.hits == 1 and cache.misses == 3
        assert calls == ["B"]
        assert ("a",) in cache and ("b",) not in cache

    @pytest.mark.parametrize("backend", ["single", "distributed"])
    def test_evicted_plan_is_collected(self, graph, backend):
        """Nothing keeps an evicted family plan alive: not the cache entry,
        not the Counter's family state, not the sampler closures, and not
        the pass history, memo or tickets (numpy only)."""
        opts = CPU | ({"num_shards": 2} if backend == "distributed" else {})
        svc = CountingService(graph, n_colors=K, backend=backend, plan_opts=opts,
                              config=ServiceConfig(batch=BATCH, plan_cache_capacity=1))
        t1 = svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        (entry,) = svc.plan_cache._entries.values()
        plan = weakref.ref(svc._counter._families[entry["trees"]]["plan"])
        sampler = weakref.ref(entry["sample_fn"])
        del entry
        t2 = svc.client("a").submit("u5-2", n_iter=8)
        svc.run_until_idle()
        assert svc.plan_cache.evictions == 1
        gc.collect()
        assert plan() is None and sampler() is None
        for t in (t1, t2):
            assert t.status == "done" and isinstance(t.result().samples, np.ndarray)
        for snap in svc._result_cache.values():
            assert isinstance(snap["samples"], np.ndarray)
        assert not svc._passes  # idle: every pass and its history dropped


class TestResultMemo:
    def test_identical_resubmit_served_from_memo(self, graph):
        svc = service(graph)
        t1 = svc.client("a").submit("u3-1", n_iter=24)
        svc.run_until_idle()
        calls_before = svc.stats().get("pass_calls", 0)
        t2 = svc.client("b").submit("u3-1", n_iter=24)
        assert t2.done and svc.stats().get("pass_calls", 0) == calls_before
        np.testing.assert_array_equal(t1.result().samples, t2.result().samples)
        assert t2.result().estimate == t1.result().estimate
        s = svc.stats()["results"]
        assert s["hits"] == 1 and s["entries"] == 1 and 0 < s["hit_rate"] < 1
        st = t2.state()
        assert st.samples.shape[0] == st.cursor * BATCH

    def test_different_budget_or_key_misses(self, graph):
        svc = service(graph)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        assert not svc.client("a").submit("u3-1", n_iter=12).done
        assert not svc.client("a").submit("u3-1", n_iter=8, key=prng.key(7)).done
        svc.run_until_idle()
        assert svc.stats()["results"]["hits"] == 0

    def test_capacity_zero_disables(self, graph):
        svc = service(graph, result_cache_capacity=0)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        assert not svc.client("a").submit("u3-1", n_iter=8).done
        svc.run_until_idle()
        assert svc.stats()["results"]["entries"] == 0

    def test_lru_eviction_bounds_entries(self, graph):
        svc = service(graph, result_cache_capacity=1)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        svc.client("a").submit("u5-2", n_iter=8)  # evicts the u3-1 result
        svc.run_until_idle()
        t3 = svc.client("a").submit("u3-1", n_iter=8)
        assert not t3.done
        svc.run_until_idle()
        s = svc.stats()["results"]
        assert s["entries"] == 1 and s["evictions"] >= 1


class TestScheduling:
    def test_drr_weights_bias_service_rate(self, graph):
        svc = service(graph)
        svc.set_weight("heavy", 3.0)
        svc.client("light").submit("u3-1", n_iter=96, key=prng.key(1))
        svc.client("heavy").submit("u3-1", n_iter=96, key=prng.key(2))
        for _ in range(17):
            svc.step()
        ts = svc.stats()["tenants"]
        assert ts["heavy"]["charged"] >= 2 * ts["light"]["charged"]
        svc.run_until_idle()

    def test_coalesced_pass_charges_scheduler_once(self, graph):
        svc = service(graph)
        svc.client("a").submit("u3-1", n_iter=24)
        svc.client("b").submit("u3-1", n_iter=24)
        svc.run_until_idle()
        stats = svc.stats()
        assert stats["request_calls"] == 2 * stats["pass_calls"]
        assert sum(t["charged"] for t in stats["tenants"].values()) == stats["pass_calls"]

    def test_bounded_queue_rejects(self, graph):
        svc = service(graph, max_pending=2)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.client("a").submit("u3-1", n_iter=8)
        with pytest.raises(QueueFullError):
            svc.client("b").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        svc.client("b").submit("u3-1", n_iter=8)  # drained: admits again
        svc.run_until_idle()


class TestAdmissionErrors:
    @pytest.mark.parametrize("limit, template, kw", [
        (1000, "u5-2", {"eps": 0.01, "delta": 0.1}),
        (100, "u3-1", {"n_iter": 101}),
    ])
    def test_unsatisfiable_raises_at_submit(self, graph, limit, template, kw):
        svc = service(graph, max_iters=limit)
        with pytest.raises(UnsatisfiableRequestError) as ei:
            svc.client("a").submit(template, **kw)
        assert "max_iters" in str(ei.value) and next(iter(kw)) in str(ei.value)

    def test_oversized_template_rejected(self, graph):
        with pytest.raises(ValueError, match="color budget"):
            service(graph).client("a").submit("u7-2", n_iter=8)

    def test_satisfiable_eps_admits(self, graph):
        svc = service(graph, max_iters=10_000)
        t = svc.client("a").submit("u3-1", eps=2.0, delta=0.5)
        svc.run_until_idle()
        assert t.status == "done"

    def test_budget_required(self, graph):
        with pytest.raises(ValueError, match="pass n_iter, eps, or target_rsd"):
            service(graph).client("a").submit("u3-1")
        with pytest.raises(ValueError, match="at least one template"):
            service(graph).client("a").submit((), n_iter=4)


class TestStreamingAndState:
    def test_progress_updates_stream(self, graph):
        svc = service(graph)
        t = svc.client("a").submit("u3-1", n_iter=24)
        svc.run_until_idle()
        assert len(t.updates) == 24 // BATCH
        niters = [u.niter for u in t.updates]
        assert niters == sorted(niters) and niters[-1] == 24
        assert t.progress is t.updates[-1] and t.progress.estimates[0] == t.result().estimate
        assert t.latency_s is not None and t.latency_s >= 0

    def test_state_export_resumes_solo(self, graph):
        svc = service(graph)
        t = svc.client("a").submit("u5-2", n_iter=32)
        for _ in range(4):
            svc.step()
        st = t.state()
        assert 0 < st.cursor < 32 // BATCH and st.status == "active"
        c = counter(graph, "u5-2")
        full = c.estimate(32, key=prng.key(0), batch=BATCH)
        res = estimate_counts(c.sample_fn, 32, prng.key(0), batch=BATCH, resume=st,
                              signature_extra=c._signature_extra())
        assert res.resumed_from == st.cursor * BATCH
        np.testing.assert_array_equal(res.samples, full.samples)
        assert res.estimate == full.estimate

    def test_result_before_done_raises(self, graph):
        t = service(graph).client("a").submit("u3-1", n_iter=8)
        with pytest.raises(RuntimeError, match="queued"):
            t.result()


class TestQuarantine:
    def test_persistent_fault_quarantined_per_request(self, graph):
        svc = service(graph, max_retries=1)
        svc._sleep = lambda _: None
        t = svc.client("a").submit("u3-1", n_iter=12)
        with faults.active(faults.inject("sample.raise", at=(0, 1))):
            svc.run_until_idle()
        r = t.result()
        assert t.status == "done" and len(r.quarantined) == 1
        assert r.quarantined[0].call_index == 0 and r.niter == 8
        np.testing.assert_array_equal(r.samples, solo(graph, "u3-1", 12).samples[BATCH:])

    def test_all_quarantined_fails_clearly(self, graph):
        svc = service(graph, max_retries=0)
        svc._sleep = lambda _: None
        t = svc.client("a").submit("u3-1", n_iter=4)
        with faults.active(faults.inject("sample.raise", at=None)):
            svc.run_until_idle()
        assert t.status == "failed" and "quarantined" in t.error
        with pytest.raises(RuntimeError, match="failed"):
            t.result()

    def test_poisoned_pass_spares_other_passes(self, graph):
        """``service.pass_poison`` quarantines one call of one pass; the
        request on another key's pass is untouched."""
        svc = service(graph)
        ta = svc.client("a").submit("u3-1", n_iter=12)
        tb = svc.client("b").submit("u3-1", n_iter=12, key=prng.key(3))
        with faults.active(faults.inject("service.pass_poison", at=(0,))) as plan:
            svc.run_until_idle()
        assert plan.fired == [("service.pass_poison", 0)]
        ra, rb = ta.result(), tb.result()
        assert len(ra.quarantined) == 1 and "non-finite" in ra.quarantined[0].reason
        np.testing.assert_array_equal(
            ra.samples, _drop_quarantined(solo(graph, "u3-1", 12).samples, ra.quarantined, BATCH))
        assert rb.quarantined == ()
        np.testing.assert_array_equal(rb.samples,
                                      solo(graph, "u3-1", 12, key=prng.key(3)).samples)

    def test_slow_pass_retries_at_the_same_key(self, graph):
        """``service.slow_pass`` on the real clock: the supervisor's timeout
        fires, the retry runs the call at the same key, and the result is
        the solo one bitwise (the timed-out attempt's thread lingers until
        its sleep ends and its pass runs)."""
        svc = service(graph, timeout_s=0.3, max_retries=2, backoff_s=0.0)
        t = svc.client("a").submit("u3-1", n_iter=8)
        t0 = time.monotonic()
        with faults.active(faults.inject("service.slow_pass", at=(0,), payload=0.9)) as plan:
            svc.run_until_idle()
        # the lingering attempt ends before another test activates a plan
        time.sleep(max(0.0, 0.9 - (time.monotonic() - t0)) + 0.2)
        assert ("service.slow_pass", 0) in plan.fired
        r = t.result()
        assert r.quarantined == ()
        np.testing.assert_array_equal(r.samples, solo(graph, "u3-1", 8).samples)


class TestFacade:
    def test_counter_serve_roundtrip(self, graph):
        c = counter(graph, "u5-2")
        svc = c.serve(config=ServiceConfig(batch=BATCH))
        assert svc.k == K and svc.device == torch.device("cpu")
        t = svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until(t)
        np.testing.assert_array_equal(t.result().samples, solo(graph, "u3-1", 8).samples)

    def test_client_count_convenience(self, graph):
        assert service(graph).client("a").count("u3-1", n_iter=8).niter == 8

    def test_api_reexports(self):
        assert api.CountingService is CountingService
        assert api.ServiceConfig is ServiceConfig
        assert api.QueueFullError is QueueFullError
        assert "run" in api.__all__ and "CountingService" in api.__all__
        assert not hasattr(api, "_TODO")
        with pytest.raises(AttributeError):
            api.NoSuchName

    def test_counter_serve_config_kwargs_and_start(self, graph):
        c = counter(graph)
        svc = c.serve(batch=BATCH, max_pending=4, shed_oldest=True, start=True)
        try:
            assert svc.running
            assert svc.config.max_pending == 4 and svc.config.shed_oldest
            with pytest.raises(ValueError, match="not both"):
                c.serve(config=ServiceConfig(), batch=2)
        finally:
            svc.stop()

    def test_service_needs_a_card_unless_asked(self, graph, monkeypatch):
        """The service resolves its device once, at construction: ``cuda``
        unless the plan options say ``cpu``, and without a card it raises."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CountingService(graph, n_colors=K, backend="single")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Counter.from_graph(graph, "u3-1").serve()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_serve.run_workload(SERVICE_WORKLOADS["smoke-service"], verbose=False)


class TestErrorReprs:
    def test_queue_full_fields_and_repr(self, graph):
        svc = service(graph, max_pending=1)
        svc.client("a").submit("u3-1", n_iter=8)
        with pytest.raises(QueueFullError) as ei:
            svc.client("b").submit("u5-2", n_iter=8)
        e = ei.value
        assert e.tenant == "b" and e.scope == "service"
        assert e.depth == 1 and e.limit == 1 and e.retry_after_s > 0
        assert "'b'" in str(e) and "limit 1" in str(e)
        assert repr(e).startswith("QueueFullError(") and "tenant='b'" in repr(e)

    def test_per_tenant_bound_scopes_error(self, graph):
        svc = service(graph, max_pending=8, max_pending_per_tenant=1)
        svc.client("a").submit("u3-1", n_iter=8)
        with pytest.raises(QueueFullError) as ei:
            svc.client("a").submit("u5-2", n_iter=8)
        assert ei.value.scope == "tenant" and ei.value.tenant == "a"
        assert svc.client("b").submit("u5-2", n_iter=8).status == "queued"

    def test_unsatisfiable_fields_and_repr(self, graph):
        svc = service(graph, max_iters=100)
        with pytest.raises(UnsatisfiableRequestError) as ei:
            svc.client("a").submit("u3-1", n_iter=101)
        e = ei.value
        assert (e.tenant, e.parameter, e.value, e.limit) == ("a", "n_iter", 101, 100)
        assert "n_iter=101" in str(e) and "parameter='n_iter'" in repr(e)
        with pytest.raises(UnsatisfiableRequestError) as ei2:
            svc.client("bob").submit("u5-2", eps=1e-9)
        assert (ei2.value.tenant, ei2.value.parameter, ei2.value.value) == ("bob", "eps", 1e-9)


class TestDriverThread:
    def test_driver_drains_and_matches_solo(self, graph):
        svc = service(graph).start()
        try:
            assert svc.running and svc.stats()["driver"]["running"]
            t = svc.client("a").submit("u3-1", n_iter=8)
            assert t.wait(60) and svc.join_idle(60)
        finally:
            svc.stop()
        assert not svc.running and t.status == "done"
        np.testing.assert_array_equal(t.result().samples, solo(graph, "u3-1", 8).samples)

    def test_concurrent_submits_all_solo_exact(self, graph):
        """Client threads submit at once while the driver schedules."""
        svc = service(graph).start()
        tickets, start = [None] * 4, threading.Barrier(4)

        def client(i):
            start.wait()
            tickets[i] = svc.client(f"t{i}").submit("u3-1", n_iter=16)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert all(t.wait(60) for t in tickets)
        finally:
            svc.stop()
        s = solo(graph, "u3-1", 16)
        for t in tickets:
            np.testing.assert_array_equal(t.result().samples, s.samples)

    def test_run_until_idle_delegates_to_driver(self, graph):
        svc = service(graph).start()
        try:
            t = svc.client("a").submit("u3-1", n_iter=8)
            svc.run_until_idle()
            assert t.status == "done"
            svc.run_until(t)
        finally:
            svc.stop()

    def test_step_crash_recorded_and_survived(self, graph):
        svc = service(graph).start()
        try:
            with faults.active(faults.inject("service.step_crash", at=(0,))) as plan:
                t = svc.client("a").submit("u3-1", n_iter=8)
                assert t.wait(60) and plan.fired
        finally:
            svc.stop()
        assert t.status == "done" and svc.stats()["driver"]["errors"] >= 1
        assert any("InjectedFault" in e for e in svc.driver_errors)

    def test_fake_clock_driver(self, graph):
        """The driver thread on a virtual clock: a deadline passes while it
        runs, the request detaches, and its co-rider stays solo-exact."""
        clk = FakeClock()
        svc = vservice(graph, clk)
        ta = svc.client("a").submit("u3-1", n_iter=400, timeout_s=5.0)
        tb = svc.client("b").submit("u3-1", n_iter=24)
        for _ in range(2):
            svc.step()
        clk.t += 10.0
        svc.start()
        try:
            assert svc.join_idle(60)
        finally:
            svc.stop()
        assert ta.status == "deadline_exceeded" and tb.status == "done"
        np.testing.assert_array_equal(tb.result().samples, solo(graph, "u3-1", 24).samples)


class TestDeadlinesCancellation:
    def test_cancel_detaches_without_touching_corider(self, graph):
        svc = service(graph)
        ta = svc.client("a").submit("u3-1", n_iter=24)
        tb = svc.client("b").submit("u3-1", n_iter=24)
        for _ in range(3):
            svc.step()
        assert ta.cancel() is True
        assert ta.status == "cancelled" and ta.done and ta.cancel() is False
        svc.run_until_idle()
        np.testing.assert_array_equal(tb.result().samples, solo(graph, "u3-1", 24).samples)
        with pytest.raises(RuntimeError, match="cancelled"):
            ta.result()
        assert svc.stats()["cancelled"] == 1

    @pytest.mark.parametrize("family", [("u5-2",), ("u3-1", "u5-2")])
    def test_cancelled_state_resumes_solo(self, graph, tmp_path, family):
        """A cancelled ticket's partial state finishes under the solo
        estimator bit-exactly, in memory and through ``ticket.checkpoint``
        then ``resume=DIR``."""
        svc = service(graph)
        t = svc.client("a").submit(family, n_iter=32)
        for _ in range(3):
            svc.step()
        t.cancel()
        st = t.state()
        assert st.status == "cancelled" and 0 < st.cursor < 32 // BATCH
        c = counter(graph, family[0])
        ck = str(tmp_path / "ck")
        assert t.checkpoint(ck).cursor == st.cursor
        if len(family) == 1:
            full = c.estimate(32, key=prng.key(0), batch=BATCH)
            res = estimate_counts(c.sample_fn, 32, prng.key(0), batch=BATCH, resume=st,
                                  signature_extra=c._signature_extra())
            np.testing.assert_array_equal(res.samples, full.samples)
            assert res.estimate == full.estimate
            resumed = c.estimate(32, key=prng.key(0), batch=BATCH, resume=ck)
        else:
            full = c.estimate_many(family, 32, key=prng.key(0), batch=BATCH)
            resumed = c.estimate_many(family, 32, key=prng.key(0), batch=BATCH, resume=ck)
        assert resumed.resumed_from == st.cursor * BATCH
        np.testing.assert_array_equal(resumed.samples, full.samples)

    def test_deadline_expires_mid_stream(self, graph):
        clk = FakeClock()
        svc = vservice(graph, clk)
        t = svc.client("a").submit("u3-1", n_iter=40, timeout_s=10.0)
        for _ in range(3):
            svc.step()
        assert t.status == "active"
        clk.t += 11.0
        svc.run_until_idle()
        assert t.status == "deadline_exceeded" and "deadline" in t.error
        st = t.state()
        assert st.status == "deadline_exceeded" and 0 < st.cursor < 40 // BATCH
        assert svc.stats()["deadline_exceeded"] == 1
        with pytest.raises(RuntimeError, match="deadline_exceeded"):
            t.result()

    def test_dead_on_arrival_deadline(self, graph):
        clk = FakeClock()
        clk.t = 100.0
        svc = vservice(graph, clk)
        t = svc.client("a").submit("u3-1", n_iter=8, deadline_s=50.0)
        assert t.status == "deadline_exceeded" and "at submit" in t.error
        assert svc._pending() == 0


class TestMemoInterplay:
    def test_memo_hit_honors_expired_deadline(self, graph):
        clk = FakeClock()
        svc = vservice(graph, clk)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.run_until_idle()
        assert svc.client("a").submit("u3-1", n_iter=8).status == "done"
        assert svc.stats()["results"]["hits"] == 1
        clk.t = 100.0
        t3 = svc.client("a").submit("u3-1", n_iter=8, deadline_s=50.0)
        assert t3.status == "deadline_exceeded"
        assert svc.stats()["results"]["hits"] == 1

    def test_cancelled_never_seeds_memo(self, graph):
        svc = service(graph)
        t = svc.client("a").submit("u3-1", n_iter=24)
        svc.step()
        svc.step()
        t.cancel()
        svc.run_until_idle()
        assert svc.stats()["results"]["entries"] == 0
        t2 = svc.client("a").submit("u3-1", n_iter=24)
        assert t2.status == "queued"
        svc.run_until_idle()
        assert t2.status == "done" and svc.stats()["results"]["entries"] == 1

    def test_quarantined_never_seeds_memo(self, graph):
        svc = service(graph, max_retries=0)
        svc._sleep = lambda _: None
        t = svc.client("a").submit("u3-1", n_iter=8)
        with faults.active(faults.inject("sample.raise", at=(0,))):
            svc.run_until_idle()
        assert t.status == "done" and len(t.result().quarantined) == 1
        assert svc.stats()["results"]["entries"] == 0


class TestBackpressure:
    def test_shed_oldest_policy(self, graph):
        svc = service(graph, max_pending=2, shed_oldest=True)
        t1 = svc.client("a").submit("u3-1", n_iter=8)
        t2 = svc.client("a").submit("u5-2", n_iter=8)
        t3 = svc.client("b").submit("u3-1", n_iter=8)  # sheds t1, admits t3
        assert t1.status == "shed" and "shed" in t1.error
        with pytest.raises(RuntimeError, match="shed"):
            t1.result()
        svc.run_until_idle()
        assert t2.status == "done" and t3.status == "done"
        assert svc.stats()["shed"] == 1

    def test_backpressure_signals_in_stats(self, graph):
        svc = service(graph, max_pending=8, max_pending_per_tenant=2)
        svc.client("a").submit("u3-1", n_iter=8)
        svc.client("a").submit("u5-2", n_iter=8)
        ts = svc.stats()["tenants"]["a"]
        assert ts["depth"] == 2 and ts["limit"] == 2
        assert ts["saturation"] == pytest.approx(1.0) and ts["retry_after_s"] > 0

    def test_shed_oldest_per_tenant(self, graph):
        """Under the per-tenant bound, shedding stays inside the tenant."""
        svc = service(graph, max_pending=8, max_pending_per_tenant=1, shed_oldest=True)
        tb = svc.client("b").submit("u3-1", n_iter=8)
        ta1 = svc.client("a").submit("u3-1", n_iter=8)
        ta2 = svc.client("a").submit("u5-2", n_iter=8)
        assert ta1.status == "shed" and tb.status == "queued"
        svc.run_until_idle()
        assert ta2.status == "done" and tb.status == "done"


class TestServiceChaos:
    @pytest.mark.timeout(120)
    def test_chaos_soak_deterministic(self, graph):
        """>= 50 injected events across five fault sites plus mid-soak
        cancellations, on the synchronous core with a virtual clock: every
        request reaches a terminal state, and every completing request's
        samples equal the solo run's with its own quarantined calls
        excluded."""
        clk = FakeClock()
        svc = vservice(graph, clk, max_retries=1, timeout_s=0.1, max_active=6)
        tickets = [svc.client(f"t{i % 3}").submit("u3-1", n_iter=24, key=prng.key(10 + i))
                   for i in range(8)]
        tickets += [svc.client(f"t{i % 3}").submit(("u3-1", "u5-2"), n_iter=16,
                                                   key=prng.key(50 + i)) for i in range(4)]
        cancels = {15: tickets[2], 30: tickets[9]}
        crashes = 0
        with faults.active(
            faults.inject("sample.raise", at=tuple(range(0, 400, 3))),
            faults.inject("sample.timeout", at=tuple(range(3, 400, 7))),
            faults.inject("service.slow_pass", at=tuple(range(2, 400, 5))),
            faults.inject("service.pass_poison", at=tuple(range(1, 400, 4))),
            faults.inject("service.step_crash", at=tuple(range(4, 400, 6))),
        ) as plan:
            for step_no in range(4000):
                if step_no in cancels:
                    cancels[step_no].cancel()
                try:
                    busy = svc.step()
                except faults.InjectedFault:
                    crashes += 1
                    busy = True
                if not busy:
                    break
            fired = len(plan.fired)
        assert fired >= 50 and crashes >= 1
        assert all(t.done for t in tickets), [t.status for t in tickets]
        assert all(t.status in ("cancelled", "done") for t in cancels.values())
        c1 = counter(graph)
        for t in tickets:
            if t.status != "done":
                continue
            r, req = t.result(), t._request
            s = (c1.estimate(24, key=req.key, batch=BATCH) if len(req.trees) == 1 else
                 c1.estimate_many(("u3-1", "u5-2"), 16, key=req.key, batch=BATCH))
            np.testing.assert_array_equal(r.samples,
                                          _drop_quarantined(s.samples, r.quarantined, BATCH))

    @pytest.mark.timeout(120)
    def test_chaos_threaded_driver_survives(self, graph):
        clk = FakeClock()
        svc = vservice(graph, clk, max_retries=1, timeout_s=0.1)
        tickets = []
        with faults.active(
            faults.inject("service.step_crash", at=tuple(range(0, 60, 9))),
            faults.inject("service.pass_poison", at=(1, 5)),
            faults.inject("sample.timeout", at=(3,)),
        ) as plan:
            svc.start()
            try:
                for i in range(6):
                    tickets.append(svc.client(f"c{i % 2}").submit(
                        "u3-1", n_iter=16, key=prng.key(100 + i)))
                tickets[3].cancel()
                assert svc.join_idle(90), "driver failed to drain (deadlock?)"
            finally:
                svc.stop()
            assert ("service.step_crash", 0) in plan.fired
        assert all(t.done for t in tickets), [t.status for t in tickets]
        assert tickets[3].status in ("cancelled", "done")
        assert svc.stats()["driver"]["errors"] >= 1
        c = counter(graph)
        for t in tickets:
            if t.status != "done":
                continue
            r = t.result()
            s = c.estimate(16, key=t._request.key, batch=BATCH)
            np.testing.assert_array_equal(r.samples,
                                          _drop_quarantined(s.samples, r.quarantined, BATCH))


# --------------------------------------------------------------------------
# the distributed backend and the launcher
# --------------------------------------------------------------------------


def test_distributed_service_equals_solo_and_single(graph):
    """On a LocalMesh of 2 thread ranks: the service == the port's solo
    distributed estimates bitwise, and each sample within 1e-6 of the
    single-device count of the same coloring (the keyed backend draws each
    iteration's coloring from its own split key)."""
    opts = CPU | {"num_shards": 2, "mode": "pipeline"}
    svc = CountingService(graph, n_colors=K, backend="distributed", plan_opts=opts,
                          config=ServiceConfig(batch=BATCH))
    assert svc.device == torch.device("cpu") and svc._counter.mesh.data_size == 2
    ta = svc.client("alice").submit("u3-1", n_iter=16)
    tb = svc.client("bob").submit(("u3-1", "u5-2"), n_iter=8)
    svc.run_until_idle()
    assert svc.stats()["coalescing_factor"] > 1.0
    c = Counter.from_graph(graph, "u3-1", backend="distributed", n_colors=K, **opts)
    sa = c.estimate(16, key=prng.key(0), batch=BATCH)
    sb = c.estimate_many(("u3-1", "u5-2"), 8, key=prng.key(0), batch=BATCH)
    np.testing.assert_array_equal(ta.result().samples, sa.samples)
    np.testing.assert_array_equal(tb.result().samples, sb.samples)
    single = counter(graph)
    scales = np.asarray(single._family(("u3-1", "u5-2"))["plan"].scales)
    want = []
    for i in range(2):
        for key in prng.split(call_key(prng.key(0), i), BATCH):
            coloring = global_coloring(key, graph.n, K).numpy()
            want.append(single.count_coloring_many(("u3-1", "u5-2"), coloring) * scales)
    np.testing.assert_allclose(tb.result().samples, np.stack(want), rtol=1e-6)


def test_launcher_sync_and_threaded_identical():
    wl = SERVICE_WORKLOADS["smoke-service"]
    sync, _ = launch_serve.run_workload(wl, device="cpu", verbose=False)
    threaded, svc = launch_serve.run_workload(wl, device="cpu", verbose=False, threaded=True)
    assert not svc.running
    assert [t.status for t in sync] == [t.status for t in threaded] == ["done"] * 3
    for a, b in zip(sync, threaded):
        np.testing.assert_array_equal(a.result().samples, b.result().samples)


def test_launcher_main_prints_the_stats(capsys):
    launch_serve.main(["--workload", "smoke-service", "--device", "cpu", "--repeats", "1"])
    out = capsys.readouterr().out
    assert "workload smoke-service: graph=bench-small k=5" in out
    assert "served 3 (failed 0" in out and "coalescing x" in out
    assert out.count("[done]") == 3
