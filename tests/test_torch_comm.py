"""The port's communication layer on the CPU: ``LocalMesh`` collectives, the
ring and grouped exchanges against the numpy semantics the reference's
worker checks (``tests/_dist_worker.py``), the Hockney router against
``repro.comm.adaptive`` on a grid of inputs, ``calibrate``, and a failing
or hanging rank failing the mesh within its timeout."""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from repro.comm import adaptive as ref_adaptive
from repro_torch.comm import (
    V5E_DCI,
    V5E_ICI,
    HockneyModel,
    LocalMesh,
    MeshAborted,
    SoloGroup,
    adaptive,
    calibrate,
    fused_exchange,
    grouped_exchange,
    ring_allgather,
    ring_allgather_overlap,
    ring_reduce_scatter,
)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh


def _mesh(P, I=1, **kw):
    return LocalMesh(P, I, device="cpu", **kw)


@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_local_mesh_collectives(P):
    rng = np.random.default_rng(P)
    x = rng.standard_normal((P, P, 3, 5)).astype(np.float32)  # x[p, q]: p's chunk for q

    def fn(ctx):
        g = ctx.data
        p = g.rank
        mine = torch.from_numpy(x[p])
        out = {"a2a": g.all_to_all(mine), "sum": g.all_reduce_sum(mine[0]),
               "gather": g.all_gather(mine[0]),
               "shifts": [g.shift(mine[0], s) for s in range(-1, P + 1)]}
        g.barrier()
        return p, out

    for p, out in _mesh(P).run(fn):
        np.testing.assert_array_equal(out["a2a"].numpy(), x[:, p])
        np.testing.assert_allclose(out["sum"].numpy(), x[:, 0].sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["gather"].numpy(), x[:, 0])
        for s, got in zip(range(-1, P + 1), out["shifts"]):
            np.testing.assert_array_equal(got.numpy(), x[(p - s) % P, 0])


def test_local_mesh_ranks_and_groups():
    """Rank (i, p): data group = the P ranks of slice i, iteration group the
    I ranks of shard p; every result comes back in rank order."""

    def fn(ctx):
        ids = torch.tensor([ctx.iters.rank, ctx.data.rank])
        return (ids.tolist(), ctx.data.all_gather(ids).tolist(), ctx.iters.all_gather(ids).tolist())

    mesh = make_local_mesh(4, 3, device="cpu")
    assert (mesh.data_size, mesh.iter_size, mesh.size) == (4, 3, 12)
    for r, (ids, data, iters) in enumerate(mesh.run(fn)):
        i, p = divmod(r, 4)
        assert ids == [i, p]
        assert data == [[i, q] for q in range(4)]
        assert iters == [[j, p] for j in range(3)]


def test_all_reduce_is_bitwise_replicated():
    """Every rank adds in rank order, so all get the same bits."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((5, 64)).astype(np.float32) * 1e3

    outs = _mesh(5).run(lambda ctx: ctx.data.all_reduce_sum(torch.from_numpy(vals[ctx.data.rank])))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_shift_is_a_copy():
    """What a rank shifts is copied at the send: a later write to it does
    not reach the receiver (the wire holds its own bytes)."""

    def fn(ctx):
        x = torch.full((4,), float(ctx.data.rank))
        work = ctx.data.shift_start(x, 1)
        x.fill_(-1.0)
        return work.wait()

    outs = _mesh(3).run(fn)
    assert [float(o[0]) for o in outs] == [2.0, 0.0, 1.0]


def test_solo_group():
    g = SoloGroup()
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert torch.equal(g.all_to_all(x), x) and torch.equal(g.shift(x[0], 5), x[0])
    assert torch.equal(g.all_reduce_sum(x), x) and g.all_gather(x[0]).shape == (1, 2, 3)
    with pytest.raises(ValueError, match="chunks"):
        g.all_to_all(torch.zeros(2, 3))


def test_ring_collectives_match_numpy():
    """As ``_dist_worker.test_ring_collectives``: the ring all-gather equals
    gather, the overlapped consume ``acc += chunk * (src + 1)`` equals
    ``sum_q (q + 1) x_q``, and the reduce-scatter equals a sum then slice."""
    P = 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((P, 4, 16)).astype(np.float32)
    xs = rng.standard_normal((P, P, 4, 16)).astype(np.float32)

    def fn(ctx):
        p = ctx.data.rank
        mine = torch.from_numpy(x[p])
        gathered = ring_allgather(ctx.data, mine)
        tiled = ring_allgather(ctx.data, mine, tiled=True)
        overlap = ring_allgather_overlap(ctx.data, mine,
                                         lambda acc, chunk, src: acc + chunk * (src + 1),
                                         torch.zeros_like(mine))
        no_init = ring_allgather_overlap(
            ctx.data, mine, lambda acc, chunk, src: chunk * (src + 1) if acc is None
            else acc + chunk * (src + 1), None)
        rs = ring_reduce_scatter(ctx.data, torch.from_numpy(xs[p]))
        return gathered, tiled, overlap, no_init, rs

    want_overlap = sum((q + 1) * x[q] for q in range(P))
    for p, (gathered, tiled, overlap, no_init, rs) in enumerate(_mesh(P).run(fn)):
        np.testing.assert_array_equal(gathered.numpy(), x)
        np.testing.assert_array_equal(tiled.numpy(), x.reshape(P * 4, 16))
        np.testing.assert_allclose(overlap.numpy(), want_overlap, atol=1e-5)
        np.testing.assert_allclose(no_init.numpy(), want_overlap, atol=1e-5)
        np.testing.assert_allclose(rs.numpy(), xs[:, p].sum(0), atol=1e-4)


def _consume_weighted(acc, chunk, src):
    return acc + chunk * (src + 1)


@pytest.mark.parametrize("g", [1, 2, 3, 7])
def test_grouped_exchange_matches_numpy(g):
    """As ``_dist_worker.test_grouped_exchange``: chunks[p, q] is what rank p
    holds for q; every rank gets sum_q (q + 1) chunks[q, p], also with
    chunks made on demand and with the cold start left out."""
    P = 8
    rng = np.random.default_rng(1)
    chunks = rng.standard_normal((P, P, 4)).astype(np.float32)

    def fn(ctx):
        p = ctx.data.rank
        mine = torch.from_numpy(chunks[p])
        init = torch.zeros(4)
        made = []

        def lazy(q):
            made.append(q)
            return mine[q]

        return (grouped_exchange(ctx.data, mine, _consume_weighted, init, group_factor=g),
                grouped_exchange(ctx.data, lazy, _consume_weighted, init, group_factor=g),
                grouped_exchange(ctx.data, mine, _consume_weighted, init, group_factor=g,
                                 include_local=False),
                fused_exchange(ctx.data, mine, _consume_weighted, init), made)

    for p, (got, got_lazy, remote, fused, made) in enumerate(_mesh(P).run(fn)):
        want = sum((q + 1) * chunks[q, p] for q in range(P))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_array_equal(got_lazy.numpy(), got.numpy())
        np.testing.assert_allclose(remote.numpy(), want - (p + 1) * chunks[p, p], atol=1e-5)
        np.testing.assert_allclose(fused.numpy(), want, atol=1e-5)
        assert sorted(made) == list(range(P))


@pytest.mark.parametrize("P,g", [(8, 1), (8, 3), (5, 2), (2, 1)])
def test_grouped_exchange_order(P, g):
    """The reference's order: the cold start consumes the own chunk, then
    step w's g chunks from ranks p - s while step w + 1 is in flight."""
    def fn(ctx):
        order = []

        def consume(acc, chunk, src):
            order.append((int(chunk), src))
            return acc

        grouped_exchange(ctx.data, lambda q: torch.tensor(ctx.data.rank), consume, None,
                         group_factor=g)
        return order

    for p, order in enumerate(_mesh(P).run(fn)):
        want = [(p, p)] + [((p - s) % P, (p - s) % P) for s in range(1, P)]
        assert order == want


def test_router_equals_reference_on_a_grid():
    """Every cost function and both choosers == ``repro.comm.adaptive``'s on
    equal inputs."""
    models = [V5E_ICI, V5E_DCI, HockneyModel(1e-5, 1 / 3e11, 5e13), HockneyModel(3e-6, 1e-9, 1e12)]
    ref_models = [ref_adaptive.HockneyModel(m.alpha, m.beta, m.flops_per_s) for m in models]
    assert (V5E_ICI.alpha, V5E_ICI.beta, V5E_ICI.flops_per_s) == (
        ref_adaptive.V5E_ICI.alpha, ref_adaptive.V5E_ICI.beta, ref_adaptive.V5E_ICI.flops_per_s)
    assert (V5E_DCI.alpha, V5E_DCI.beta, V5E_DCI.flops_per_s) == (
        ref_adaptive.V5E_DCI.alpha, ref_adaptive.V5E_DCI.beta, ref_adaptive.V5E_DCI.flops_per_s)
    grid = itertools.product([0.0, 1e3, 2.7e6, 4e9], [0.0, 5e5, 3e9, 8e12], [1, 2, 4, 8, 256],
                             [1, 3, 7], range(len(models)))
    n = 0
    for nbytes, flops, P, gf, m in grid:
        mine, ref = models[m], ref_models[m]
        assert adaptive.pipeline_cost(nbytes, flops, P, mine, gf) == \
            ref_adaptive.pipeline_cost(nbytes, flops, P, ref, gf)
        assert adaptive.fused_cost(nbytes, flops, mine) == ref_adaptive.fused_cost(nbytes, flops, ref)
        assert adaptive.overlap_ratio(flops * 1e-12, nbytes * 1e-9) == \
            ref_adaptive.overlap_ratio(flops * 1e-12, nbytes * 1e-9)
        assert adaptive.choose_mode(nbytes, flops, P, mine, gf) == \
            ref_adaptive.choose_mode(nbytes, flops, P, ref, gf)
        assert adaptive.choose_mode_full(nbytes, 1.3 * nbytes, flops, P, mine, gf) == \
            ref_adaptive.choose_mode_full(nbytes, 1.3 * nbytes, flops, P, ref, gf)
        n += 1
    assert n == 4 * 4 * 5 * 3 * 4


def test_calibrate_on_a_local_mesh():
    """A one-rank mesh returns the base model; a wider one fits a clamped
    alpha and beta, agreed by every rank, and caches it."""
    base = HockneyModel(1e-6, 1e-10, 1e12)
    assert calibrate(_mesh(1), base=base) is base
    mesh = _mesh(2)
    got = calibrate(mesh, payload_bytes=(1 << 10, 1 << 12, 1 << 14), repeats=1, base=base)
    assert 1e-8 <= got.alpha <= 1.0 and 1e-13 <= got.beta <= 1e-3
    assert 1e9 <= got.flops_per_s <= 1e16
    assert calibrate(mesh, payload_bytes=(1 << 10, 1 << 12, 1 << 14), repeats=1) is got


def test_fit_equals_reference_least_squares():
    sizes = (1 << 16, 1 << 19, 1 << 22)
    times = [2e-5, 6e-5, 3.1e-4]
    beta = ((3 * sum(s * t for s, t in zip(sizes, times)) - sum(sizes) * sum(times))
            / (3 * sum(s * s for s in sizes) - sum(sizes) ** 2))
    alpha = (sum(times) - beta * sum(sizes)) / 3
    assert adaptive._fit(sizes, times, V5E_ICI) == (alpha, beta)


def test_raising_rank_aborts_the_mesh():
    """A rank that raises while the others wait at a collective fails the
    whole call at once with its own error, long before the timeout."""

    def fn(ctx):
        if ctx.data.rank == 2:
            raise ValueError("rank 2 failed")
        return ctx.data.all_reduce_sum(torch.ones(3))

    mesh = _mesh(4, timeout=60.0)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 failed"):
        mesh.run(fn)
    assert time.monotonic() - t0 < 10.0
    # the mesh runs again after a failure
    assert all(torch.equal(o, torch.full((3,), 4.0)) for o in
               mesh.run(lambda ctx: ctx.data.all_reduce_sum(torch.ones(3))))


def test_hanging_rank_times_out():
    """A rank that never reaches the collective fails the mesh after the
    timeout: the call raises, and no thread is left waiting."""
    before = threading.active_count()

    def fn(ctx):
        if ctx.data.rank == 1:
            return None  # skips the collective the others wait at
        return ctx.data.all_gather(torch.ones(2))

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="waited more than"):
        _mesh(3, timeout=0.5).run(fn)
    assert time.monotonic() - t0 < 10.0
    assert threading.active_count() == before


def test_aborted_waits_raise_mesh_aborted():
    seen = []

    def fn(ctx):
        if ctx.data.rank == 0:
            raise KeyError("first")
        try:
            ctx.data.barrier()
        except MeshAborted as e:
            seen.append(e)
            raise

    with pytest.raises(KeyError):
        _mesh(3, timeout=30.0).run(fn)
    assert len(seen) == 2


def test_mesh_arguments():
    with pytest.raises(ValueError, match="data >= 1"):
        LocalMesh(0, device="cpu")
    mesh = make_production_mesh()
    assert (mesh.axis_names, mesh.shape, mesh.device.type) == (("data", "model"), (16, 16), "meta")
    assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)
    assert repr(make_local_mesh(2, device="cpu")) == "LocalMesh(data=2, iters=1, device=cpu)"


def test_launch_counts_survive_threads():
    """The kernels' launch counts are shared by a LocalMesh's threads: with a
    short switch interval and more threads than cores, none is lost."""
    import os
    import sys

    from repro_torch.kernels import _build

    def fn():
        pass

    fn.launches = 0
    threads_n, per = 4 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(fn) for _ in range(per)])
                   for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == threads_n * per


def test_local_mesh_stress():
    """More ranks than cores exchanging many times at a short switch
    interval: every all-reduce and shift returns the exact total."""
    import os
    import sys

    P = max(8, 2 * (os.cpu_count() or 4))

    def fn(ctx):
        x = torch.full((3,), float(ctx.data.rank + 1))
        sums, shifted = [], []
        for r in range(25):
            sums.append(float(ctx.data.all_reduce_sum(x)[0]))
            shifted.append(float(ctx.data.shift(x, r % P)[0]))
        return sums, shifted

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outs = _mesh(P, timeout=120.0).run(fn)
    finally:
        sys.setswitchinterval(old)
    for p, (sums, shifted) in enumerate(outs):
        assert sums == [P * (P + 1) / 2] * 25
        assert shifted == [float((p - r % P) % P + 1) for r in range(25)]
