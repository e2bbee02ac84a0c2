"""(epsilon, delta)-estimation over the single-device backend.

Counterpart of ``repro/core/estimator.py`` without checkpoint, resume and
supervision (ROADMAP queue 1 item 2).  Each coloring iteration yields an
unbiased estimate ``X_j = maps_j * scale`` of the copy count; following the
paper (Algorithm 1 line 14), ``Niter`` estimates are split into
``t = O(log 1/delta)`` groups and the output is the median of the group
means.

Backends plug in through one protocol: ``sample_fn(seed, batch)`` returns
``batch`` independent per-coloring copy estimates (float64 ``[batch]``)
drawn from a generator seeded with ``seed``.  Backend call ``i`` of a run
keyed by ``seed`` gets :func:`call_seed` ``(seed, i)``, which depends only
on ``(seed, i)``: the per-call stream is prefix-stable, so the first ``c``
calls of a run of ``n`` see the same colorings as a run of ``c``.  (The
reference draws from JAX's threefry keys; bit-for-bit agreement with its
colorings is ROADMAP queue 1 item 2.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np

from .count_engine import CountingPlan, plan_sample_fn

__all__ = [
    "SampleFn",
    "niter_bound",
    "num_groups_for",
    "median_of_means",
    "call_seed",
    "relative_se",
    "aggregate_single",
    "CountEstimate",
    "estimate_counts",
]

#: The backend protocol: ``sample_fn(seed, batch) -> float64 [batch]``.
SampleFn = Callable[[int, int], np.ndarray]


def niter_bound(k: int, eps: float, delta: float) -> int:
    """Worst-case iteration count from Alon et al. (reported, not enforced)."""
    return int(math.ceil(math.e ** k * math.log(1.0 / delta) / (eps ** 2)))


def num_groups_for(delta: float, n_iter: int) -> int:
    """Median-of-means group count: ``t = O(log 1/delta)``, clamped to n_iter."""
    return max(1, min(int(round(math.log(1.0 / delta))), n_iter))


def call_seed(seed: int, index: int) -> int:
    """Generator seed for backend call ``index`` of a run keyed by ``seed``.

    A hash of the pair (numpy's ``SeedSequence``), never a split of a
    budget-sized stream, so call ``i``'s colorings depend only on
    ``(seed, i)``: the prefix stability the reference's ``call_key``
    (``fold_in``) gives.
    """
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def median_of_means(samples: np.ndarray, num_groups: int):
    """Median of group means along axis 0 (``[n]`` -> float; ``[n, T]`` ->
    float64 ``[T]``)."""
    samples = np.asarray(samples, np.float64)
    num_groups = max(1, min(num_groups, samples.shape[0]))
    usable = (samples.shape[0] // num_groups) * num_groups
    groups = samples[:usable].reshape(num_groups, -1, *samples.shape[1:])
    med = np.median(groups.mean(axis=1), axis=0)
    return float(med) if np.ndim(med) == 0 else med


@dataclasses.dataclass(frozen=True)
class CountEstimate:
    estimate: float  # median-of-means copy estimate
    mean: float  # plain mean estimate
    relative_sd: float  # empirical RSD of the per-iteration estimates
    samples: np.ndarray  # per-iteration estimates
    niter: int  # iterations actually aggregated
    delta: float = 0.1  # the run's failure probability (sets the group count)


def relative_se(samples: np.ndarray) -> float:
    """Relative standard error of the running mean (the early-stop signal)."""
    n = samples.shape[0]
    if n < 2:
        return float("inf")
    means = np.atleast_1d(samples.mean(axis=0))
    sds = np.atleast_1d(samples.std(axis=0))
    with np.errstate(divide="ignore", invalid="ignore"):
        rse = np.where(means != 0, sds / np.abs(means) / math.sqrt(n), np.inf)
    return float(rse.max())


def aggregate_single(samples: np.ndarray, n_iter: int, delta: float):
    """``(mom, mean, rsd, used, ests)`` over ``samples`` truncated to the
    ``n_iter`` budget (the reference's tail aggregate, same arithmetic)."""
    ests = np.asarray(samples, np.float64).reshape(-1)[:n_iter]
    used = int(ests.shape[0])
    mom = median_of_means(ests, num_groups_for(delta, used))
    mean = float(ests.mean())
    rsd = float(ests.std() / mean) if mean != 0 else float("inf")
    return mom, mean, rsd, used, ests


def estimate_counts(
    source: Union[CountingPlan, SampleFn],
    n_iter: int,
    seed: int = 0,
    *,
    delta: float = 0.1,
    batch: Optional[int] = None,
) -> CountEstimate:
    """Run ``n_iter`` independent colorings and aggregate (Algorithm 1 l.14).

    ``source`` is a :class:`CountingPlan` (it runs on the plan's device) or
    any ``sample_fn(seed, batch)``.  ``batch=B`` evaluates ``B`` colorings
    per backend call; the last call may overshoot ``n_iter``, and the
    aggregate uses the first ``n_iter`` samples.
    """
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    sample = source if callable(source) else plan_sample_fn(source)
    b = batch if batch is not None and batch > 1 else 1
    n_calls = -(-n_iter // b)
    chunks = [np.asarray(sample(call_seed(seed, i), b), np.float64).reshape(-1)
              for i in range(n_calls)]
    mom, mean, rsd, used, ests = aggregate_single(np.concatenate(chunks), n_iter, delta)
    return CountEstimate(mom, mean, rsd, ests, used, delta)
