"""The port's ``Counter`` against the reference's: the same key gives the same
colorings, the same maps and, within float32 rounding of the reference's
scaled estimates, the same samples and aggregates."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import Counter as RefCounter
from repro.configs import COUNTING_CONFIGS as REF_CONFIGS
from repro.core import build_counting_plan as ref_build_plan
from repro.core import count_fn as ref_count_fn
from repro.core.graphs import Graph as RefGraph
from repro_torch.api import Counter, CountRequest
from repro_torch.configs.subgraph import COUNTING_CONFIGS
from repro_torch.core import prng
from repro_torch.core.count_engine import build_counting_plan, count_fn, draw_colorings
from repro_torch.core.graphs import erdos_renyi, rmat
from repro_torch.core.templates import template

#: the reference sums the root table and scales it in float32
#: (table_program.py:262-263, count_engine.py:549); the port keeps float64.
#: With maps below 2^24 the sum is exact in both, and the scaling rounds
#: twice in float32 (the scale, then the product): two float32 ulps
RTOL = 2.4e-7


def _ref_graph(g):
    return RefGraph(g.n, g.indptr, g.indices, g.name)


def _graph():
    return erdos_renyi(60, 4.0, seed=15)


@pytest.mark.parametrize("name", ["u3-1", "u5-2", "u7-2"])
@pytest.mark.parametrize("seed", [0, 3])
def test_count_fn_maps_equal_reference(name, seed):
    g = _graph()
    plan = build_counting_plan(g, template(name), device="cpu")
    rplan = ref_build_plan(_ref_graph(g), template(name), impl="xla")
    want_cols = jax.random.randint(jax.random.key(seed), (8, rplan.n_pad), 0, rplan.k,
                                   dtype=np.int32)
    np.testing.assert_array_equal(draw_colorings(plan, 8, prng.key(seed)).numpy(),
                                  np.asarray(want_cols))
    maps, ests = count_fn(plan, 8)(prng.key(seed))
    rmaps, rests = ref_count_fn(rplan, batch=8)(jax.random.key(seed))
    assert maps.max() < 2**24
    np.testing.assert_array_equal(maps.numpy(), np.asarray(rmaps, np.float64))
    np.testing.assert_allclose(ests.numpy(), np.asarray(rests, np.float64), rtol=RTOL)


@pytest.mark.parametrize("name,kind", [("u5-2", "edges"), ("u5-2", "blocks"),
                                       ("u7-2", "auto"), ("u3-1", "edges")])
def test_estimate_equals_reference(name, kind):
    g = _graph()
    res = Counter.from_graph(g, name, backend="single", spmm_kind=kind, device="cpu").estimate(
        n_iter=24, batch=8, key=prng.key(3))
    ref = RefCounter.from_graph(_ref_graph(g), name, backend="single", impl="xla").estimate(
        n_iter=24, batch=8, key=jax.random.key(3))
    assert res.niter == ref.niter == 24
    np.testing.assert_allclose(res.samples, ref.samples, rtol=RTOL)
    assert res.estimate == pytest.approx(ref.estimate, rel=RTOL)
    assert res.mean == pytest.approx(ref.mean, rel=RTOL)
    assert (res.backend, res.template, res.graph, res.delta) == (
        ref.backend, ref.template, ref.graph, ref.delta)


def test_signature_extra_equals_reference():
    g = rmat(64, 300, skew=3, seed=5, name="r64")
    c = Counter.from_graph(g, "u5-2", backend="single", device="cpu")
    r = RefCounter.from_graph(_ref_graph(g), "u5-2", backend="single", impl="xla")
    assert c._signature_extra() == r._signature_extra()


def test_blocks_and_edges_give_equal_samples():
    g = rmat(512, 30_000, skew=3, seed=1)  # 'auto' picks blocks
    runs = {}
    for kind in ("auto", "edges"):
        c = Counter.from_graph(g, "u5-2", backend="single", spmm_kind=kind, device="cpu")
        runs[kind] = c.estimate(n_iter=4, batch=2, key=prng.key(5))
        assert c.plan.spmm_plan.kind == {"auto": "blocks", "edges": "edges"}[kind]
    np.testing.assert_array_equal(runs["auto"].samples, runs["edges"].samples)


def test_count_one_and_count_coloring():
    g = _graph()
    c = Counter.from_graph(g, "u5-2", device="cpu")
    r = RefCounter.from_graph(_ref_graph(g), "u5-2", backend="single", impl="xla")
    assert c.count_one(prng.key(2)) == pytest.approx(r.count_one(jax.random.key(2)), rel=RTOL)
    coloring = np.random.default_rng(0).integers(0, 5, g.n)
    assert c.count_coloring(coloring) == r.count_coloring(coloring)
    assert c.scale == pytest.approx(r.scale)
    with pytest.raises(ValueError, match="entries"):
        c.count_coloring(coloring[:-1])


def test_backends_and_unported_surfaces():
    g = _graph()
    c = Counter.from_graph(g, "u5-2", backend="auto", device="cpu", num_shards=8, mode="ring")
    assert c.backend == "single" and c.plan_opts == {"device": "cpu"}
    dist_compact = Counter.from_graph(g, "u5-2", backend="distributed", device="cpu",
                                      compact=True, density_threshold=0.5, wire_dtype="int16")
    assert dist_compact.plan.compaction.threshold == 0.5  # the compacted exchange is ported
    with pytest.raises(ValueError, match="unknown backend"):
        Counter.from_graph(g, "u5-2", backend="tpu", device="cpu")
    with pytest.raises(TypeError, match="unknown plan_opts"):
        Counter.from_graph(g, "u5-2", device="cpu", lanes=4)
    compact = Counter.from_graph(g, "u5-2", device="cpu", compact=True)
    assert compact.plan_opts == {"device": "cpu", "compact": True}
    assert compact.plan.compaction is not None and compact.plan.compaction.probes == 2
    assert Counter.from_graph(g, "u5-2", device="cpu", n_colors=7).plan.k == 7
    assert c.estimate_many(["u3-1"], n_iter=2).samples.shape == (2, 1)
    # sample_stream and serve are ported: a stream batch and a served
    # request are the solo estimate's samples
    first = next(c.sample_stream(prng.key(0), batch=2))
    assert first.shape == (2,) and first.dtype == np.float64
    svc = c.serve(batch=2)
    assert svc.k == 5 and svc.device == torch.device("cpu")
    served = svc.client("a").count("u3-1", n_iter=4)
    solo = Counter.from_graph(g, "u3-1", device="cpu", n_colors=5).estimate(
        4, key=prng.key(0), batch=2)
    np.testing.assert_array_equal(served.samples, solo.samples)
    with pytest.raises(ValueError, match="pass n_iter or eps"):
        c.estimate()


def test_counter_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = Counter.from_graph(_graph(), "u3-1")  # building is lazy
    with pytest.raises(RuntimeError, match="device='cpu'"):
        c.plan


def test_config_to_request_matches_reference():
    g = _graph()
    for name in ("bench-small", "rmat500-u12-2"):
        req = COUNTING_CONFIGS[name].to_request(g, backend="single", n_iter=8, batch=4,
                                                fuse=True, device="cpu")
        rreq = REF_CONFIGS[name].to_request(_ref_graph(g), backend="single", n_iter=8,
                                            batch=4, fuse=True)
        mine = dataclasses.asdict(dataclasses.replace(req, graph=None))
        theirs = dataclasses.asdict(dataclasses.replace(rreq, graph=None))
        assert mine.pop("plan_opts") == dict(theirs.pop("plan_opts"), device="cpu")
        assert mine == theirs
        c = Counter.from_request(req)
        # the single backend keeps the row's compaction knobs (it reads them now)
        assert isinstance(req, CountRequest) and c.plan_opts == {
            "fuse": True, "device": "cpu", "compact": False, "density_threshold": 0.25,
            "capacity_factor": 1.5}
