"""The port's estimator against the reference's aggregation math, and its
prefix-stable per-call keys."""

import jax
import numpy as np
import pytest

from repro.core import estimator as ref_est
from repro_torch.core import estimator as est
from repro_torch.core import prng
from repro_torch.core.count_engine import build_counting_plan
from repro_torch.core.graphs import erdos_renyi
from repro_torch.core.templates import path_tree


@pytest.mark.parametrize("n,groups", [(1, 2), (7, 2), (16, 3), (300, 2), (31, 5)])
def test_aggregates_match_reference(n, groups):
    samples = np.random.default_rng(n).gamma(2.0, 50.0, n)
    assert est.median_of_means(samples, groups) == ref_est.median_of_means(samples, groups)
    two = np.stack([samples, samples * 3], axis=1)
    np.testing.assert_array_equal(est.median_of_means(two, groups),
                                  ref_est.median_of_means(two, groups))
    assert est.relative_se(samples) == ref_est.relative_se(samples)
    for delta in (0.1, 0.01, 0.5):
        assert est.num_groups_for(delta, n) == ref_est.num_groups_for(delta, n)
        a, b = est.aggregate_single(samples, n - n // 3, delta), ref_est.aggregate_single(
            samples, n - n // 3, delta)
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])
    assert est.niter_bound(5, 0.1, 0.1) == ref_est.niter_bound(5, 0.1, 0.1)


def test_call_keys_prefix_stable():
    plan = build_counting_plan(erdos_renyi(30, 4.0, seed=11), path_tree(3), device="cpu")
    key = prng.key(9)
    short = est.estimate_counts(plan, 6, key, batch=2)
    long = est.estimate_counts(plan, 20, key, batch=2)
    np.testing.assert_array_equal(long.samples[:6], short.samples)
    assert len({prng.key_data(est.call_key(key, i)) for i in range(100)}) == 100
    assert prng.key_data(est.call_key(key, 3)) != prng.key_data(est.call_key(prng.key(10), 3))
    again = est.estimate_counts(plan, 6, key, batch=2)
    np.testing.assert_array_equal(again.samples, short.samples)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5])
def test_call_key_matches_reference(seed):
    for i in (0, 1, 5, 1000, 2**32 - 1):
        want = jax.random.key_data(ref_est.call_key(jax.random.key(seed), i))
        assert prng.key_data(est.call_key(prng.key(seed), i)) == tuple(int(w) for w in want)


def test_run_signature_matches_reference():
    for seed, extra in [(0, ""), (3, "g|V=10|E=20|u5-2|single"), (2**31 + 5, "x")]:
        assert est.run_signature(24, 8, 0.1, prng.key(seed), extra=extra) == \
            ref_est.run_signature(24, 8, 0.1, jax.random.key(seed), extra=extra)


def test_estimate_unbiased_small():
    from repro_torch.core.brute_force import count_copies

    g = erdos_renyi(30, 4.0, seed=11)
    tree = path_tree(3)
    truth = count_copies(g, tree)
    res = est.estimate_counts(build_counting_plan(g, tree, fuse=True, device="cpu"), 300,
                              prng.key(1), batch=32)
    assert res.niter == 300 and res.samples.shape == (300,)
    assert res.mean == pytest.approx(truth, rel=0.15)
    assert res.estimate == pytest.approx(truth, rel=0.25)
