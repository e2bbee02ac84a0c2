"""(epsilon, delta)-estimation over the single-device backend.

Counterpart of ``repro/core/estimator.py``.  Each coloring iteration yields
an unbiased estimate ``X_j = maps_j * scale`` of the copy count
(``scale = k^t (k-t)!/k!/|Aut|``).  Following the paper (Algorithm 1 line
14), ``Niter`` estimates are split into ``t = O(log 1/delta)`` groups; the
output is the median of the group means.

Backends plug in through one protocol: ``sample_fn(key, batch)`` returns
``batch`` independent per-coloring copy estimates (float64 ``[batch]``)
derived from a threefry key (:mod:`.prng`, the reference's keys bit for
bit).  :func:`estimate_counts` accepts a :class:`CountingPlan` (adapted via
:func:`~.count_engine.plan_sample_fn`) or any callable with that signature.

Resumability (DESIGN.md §16): backend call ``i`` of a run keyed by ``key``
uses :func:`call_key` ``(key, i)`` = ``fold_in(key, i)``, a prefix-stable
stream whose ``i``-th key depends only on ``(key, i)``.
:class:`EstimatorState` banks the per-iteration estimates and the cursor
(backend calls completed); a resumed run re-derives the same per-call keys,
skips the first ``cursor`` and continues, so every aggregate is
bit-identical to an uninterrupted run's.  A
:class:`~.supervisor.Supervisor` (or ``retry=RetryPolicy(...)``) retries
transient sample faults and quarantines persistently failing batches,
which are reported on the returned estimate.  The family variant,
:func:`estimate_counts_many`, banks ``[done, T]`` per-template estimates
from one shared-coloring pass and aggregates them column-wise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np

from ..testing import faults
from . import prng
from .count_engine import CountingPlan, plan_sample_fn
from .supervisor import QuarantinedBatch, RetryPolicy, Supervisor

__all__ = [
    "SampleFn",
    "niter_bound",
    "num_groups_for",
    "median_of_means",
    "call_key",
    "relative_se",
    "aggregate_single",
    "CountEstimate",
    "MultiCountEstimate",
    "EstimatorState",
    "ResumeMismatchError",
    "EstimationAborted",
    "run_signature",
    "estimate_counts",
    "estimate_counts_many",
]

#: The backend protocol: ``sample_fn(key, batch) -> float64 [batch]`` copy
#: estimates for ``batch`` independent colorings derived from ``key``.
SampleFn = Callable[[prng.Key, int], np.ndarray]


def niter_bound(k: int, eps: float, delta: float) -> int:
    """Worst-case iteration count from Alon et al. (reported, not enforced)."""
    return int(math.ceil(math.e ** k * math.log(1.0 / delta) / (eps ** 2)))


def num_groups_for(delta: float, n_iter: int) -> int:
    """Median-of-means group count: ``t = O(log 1/delta)``, clamped to n_iter."""
    return max(1, min(int(round(math.log(1.0 / delta))), n_iter))


def call_key(key: prng.Key, index: int) -> prng.Key:
    """PRNG key for backend call ``index`` of a run keyed by ``key``.

    ``fold_in`` rather than a pre-split: the per-call key stream is
    *prefix-stable* — call ``i``'s key depends only on ``(key, i)``, never
    on the total call count (``jax.random.split(key, n)`` pairs counters as
    ``(i, n+i)``, so its streams differ across budgets).  Prefix stability
    is what makes a banked sample prefix valid under a different remaining
    budget: resume, per-request early exit inside a coalesced family pass,
    and mid-stream joins all rely on it.
    """
    return prng.fold_in(key, index)


def median_of_means(samples: np.ndarray, num_groups: int):
    """Median of group means along axis 0.

    ``samples`` is ``[n]`` (returns a float, the original contract) or
    ``[n, T]`` (returns a float64 ``[T]`` array, one value per template) —
    the grouping is identical, applied column-wise.
    """
    samples = np.asarray(samples, np.float64)
    num_groups = max(1, min(num_groups, samples.shape[0]))
    usable = (samples.shape[0] // num_groups) * num_groups
    groups = samples[:usable].reshape(num_groups, -1, *samples.shape[1:])
    med = np.median(groups.mean(axis=1), axis=0)
    return float(med) if np.ndim(med) == 0 else med


class ResumeMismatchError(ValueError):
    """A checkpoint does not belong to this run (fatal, never silent).

    Resuming under a different key, budget, batch size, graph, or template
    would splice two *different* sample streams and silently bias the
    estimate; the signature check turns that into a hard error.
    """


class EstimationAborted(RuntimeError):
    """Every batch was quarantined — there is no data to estimate from."""


@dataclasses.dataclass(frozen=True)
class CountEstimate:
    estimate: float  # median-of-means copy estimate
    mean: float  # plain mean estimate
    relative_sd: float  # empirical RSD of the per-iteration estimates
    samples: np.ndarray  # per-iteration estimates
    niter: int  # iterations actually aggregated
    quarantined: tuple = ()  # QuarantinedBatch records (excluded batches)
    resumed_from: int = 0  # iterations restored from checkpoint, if any


@dataclasses.dataclass(frozen=True)
class MultiCountEstimate:
    """Per-template aggregates of one family run (axis order [iter, T])."""

    estimates: np.ndarray  # [T] median-of-means copy estimates
    means: np.ndarray  # [T] plain means
    relative_sds: np.ndarray  # [T] empirical RSDs
    samples: np.ndarray  # [niter, T] per-iteration estimates
    niter: int
    quarantined: tuple = ()
    resumed_from: int = 0


def run_signature(n_iter: int, batch: int, delta: float, key: prng.Key, *, extra: str = "") -> str:
    """The identity of one estimation run, for resume safety.

    Two runs with equal signatures draw the identical per-call key sequence
    over the identical budget, so banked samples from one are a valid prefix
    of the other.  ``extra`` carries caller context (graph, template,
    backend — see ``Counter``) so a checkpoint can't cross workloads.
    """
    from .supervisor import key_fingerprint

    kd = ",".join(str(w) for w in key_fingerprint(key))
    base = f"n_iter={n_iter}|batch={batch}|delta={delta:g}|key={kd}"
    return f"{extra}|{base}" if extra else base


@dataclasses.dataclass(frozen=True)
class EstimatorState:
    """Everything needed to continue an interrupted estimate bit-exactly.

    ``samples`` banks the raw per-iteration estimates (``[done]``, or
    ``[done, T]`` for a family) — one float64 per coloring and template, so even a 10^6-iteration budget checkpoints in
    megabytes.  The raw array is kept because the final grouping depends
    on the total iteration count, and bit-exact resume must reproduce the
    exact ``median(group means)`` an uninterrupted run computes.

    ``cursor`` is the PRNG position: how many backend calls of the
    per-call key sequence completed (including quarantined ones — their
    keys are consumed, their records kept, so a resumed run neither replays
    nor double-counts them).

    ``status`` is provenance, not identity: the terminal status of the run
    that exported this state (``""`` for a plain checkpoint, or a service
    ticket's such as ``"cancelled"``/``"deadline_exceeded"``).  Resume
    ignores it, and it rides ``to_arrays`` so a checkpoint directory
    records why the banked work stopped where it did.
    """

    signature: str  # run_signature() — checked on resume
    n_iter: int  # total planned iterations
    batch: int  # iterations per backend call
    delta: float
    cursor: int  # backend calls completed (PRNG key cursor)
    samples: np.ndarray  # [done] or [done, T] banked estimates
    quarantined: tuple = ()  # QuarantinedBatch records
    status: str = ""  # exporting run's terminal status (provenance only)

    @property
    def done(self) -> int:
        """Iterations banked so far."""
        return int(self.samples.shape[0])

    @property
    def n_calls(self) -> int:
        return -(-self.n_iter // self.batch)

    def group_sums(self, num_groups: Optional[int] = None):
        """Per-group partial sums (and counts) of the banked samples.

        The associative form of the median-of-means aggregate: group ``g``
        of the final estimate owns a contiguous slice of the sample stream,
        so its running sum/count is exact at any prefix.
        """
        g = num_groups_for(self.delta, self.n_iter) if num_groups is None else num_groups
        per = max(1, self.n_iter // g)
        done = self.done
        sums, counts = [], []
        for i in range(g):
            part = self.samples[i * per: min((i + 1) * per, done)]
            sums.append(part.sum(axis=0))
            counts.append(part.shape[0])
        return np.asarray(sums, np.float64), np.asarray(counts, np.int64)

    # ------------------------------------------------- checkpoint adapters
    def to_arrays(self) -> dict:
        """Flatten to named numpy arrays (the CheckpointManager payload)."""
        q = self.quarantined
        keys = np.asarray([r.key_data for r in q], np.uint32) if q else np.zeros((0, 0), np.uint32)
        reasons = "\n".join(r.reason.replace("\n", " ") for r in q)
        return {
            "signature": np.frombuffer(self.signature.encode("utf-8"), np.uint8).copy(),
            "n_iter": np.int64(self.n_iter),
            "batch": np.int64(self.batch),
            "delta": np.float64(self.delta),
            "cursor": np.int64(self.cursor),
            "samples": np.asarray(self.samples, np.float64),
            "q_call": np.asarray([r.call_index for r in q], np.int64),
            "q_attempts": np.asarray([r.attempts for r in q], np.int64),
            "q_keys": keys,
            "q_reasons": np.frombuffer(reasons.encode("utf-8"), np.uint8).copy(),
            "status": np.frombuffer(self.status.encode("utf-8"), np.uint8).copy(),
        }

    @classmethod
    def from_arrays(cls, flat: dict) -> "EstimatorState":
        reasons = bytes(np.asarray(flat["q_reasons"], np.uint8)).decode("utf-8")
        reason_list = reasons.split("\n") if reasons else []
        q = tuple(
            QuarantinedBatch(
                call_index=int(c),
                key_data=tuple(int(w) for w in np.atleast_1d(k)),
                reason=reason_list[i] if i < len(reason_list) else "",
                attempts=int(a),
            )
            for i, (c, a, k) in enumerate(
                zip(flat["q_call"], flat["q_attempts"], flat["q_keys"])
            )
        )
        return cls(
            signature=bytes(np.asarray(flat["signature"], np.uint8)).decode("utf-8"),
            n_iter=int(flat["n_iter"]),
            batch=int(flat["batch"]),
            delta=float(flat["delta"]),
            cursor=int(flat["cursor"]),
            samples=np.asarray(flat["samples"], np.float64),
            quarantined=q,
            status=(bytes(np.asarray(flat["status"], np.uint8)).decode("utf-8")
                    if "status" in flat else ""),
        )


def relative_se(samples: np.ndarray) -> float:
    """Relative standard error of the running mean — the early-stop signal.

    Unlike the per-iteration RSD (which converges to the sampling noise
    level, not zero), this shrinks ~1/sqrt(n), so "stop at target" is
    meaningful.
    """
    n = samples.shape[0]
    if n < 2:
        return float("inf")
    means = np.atleast_1d(samples.mean(axis=0))
    sds = np.atleast_1d(samples.std(axis=0))
    with np.errstate(divide="ignore", invalid="ignore"):
        rse = np.where(means != 0, sds / np.abs(means) / math.sqrt(n), np.inf)
    return float(rse.max())


def aggregate_single(samples: np.ndarray, n_iter: int, delta: float):
    """The scalar tail aggregate of :func:`estimate_counts`, factored out.

    Returns ``(mom, mean, rsd, used, ests)`` over ``samples`` truncated to
    the ``n_iter`` budget.  ``samples`` must be non-empty.
    """
    ests = np.asarray(samples, np.float64).reshape(-1)[:n_iter]
    used = int(ests.shape[0])
    mom = median_of_means(ests, num_groups_for(delta, used))
    mean = float(ests.mean())
    rsd = float(ests.std() / mean) if mean != 0 else float("inf")
    return mom, mean, rsd, used, ests


def _append(bank: np.ndarray, chunk: np.ndarray) -> np.ndarray:
    if bank.shape[0] == 0:
        return chunk.copy()
    return np.concatenate([bank, chunk], axis=0)


def _collect_samples(
    sample: Union[SampleFn, Supervisor],
    key: prng.Key,
    state: EstimatorState,
    *,
    progress: bool,
    checkpoint=None,
    checkpoint_every: int = 0,
    target_rsd: Optional[float] = None,
    multi: bool = False,
) -> EstimatorState:
    """The shared sampling loop, resumable at any call boundary.

    Walks the :func:`call_key` sequence from ``state.cursor``, banking each
    batch into ``state``; saves the state to ``checkpoint`` every
    ``checkpoint_every`` iterations (rounded up to call boundaries) and
    once more on completion, so a finished directory restores to a no-op
    resume.  When ``sample`` is a :class:`Supervisor`, quarantined batches
    advance the cursor without contributing samples.  ``multi=True`` banks
    the family protocol's ``[batch, T]`` estimates as rows.
    """
    b, n_iter, n_calls = state.batch, state.n_iter, state.n_calls
    supervised = isinstance(sample, Supervisor)
    stride = max(1, n_calls // 10)
    ckpt_calls = max(1, -(-checkpoint_every // b)) if checkpoint_every else 0
    last_saved = state.cursor
    for i in range(state.cursor, n_calls):
        # the early-stop check sees banked + fresh samples alike, so a
        # resumed run stops exactly where the uninterrupted run would
        if target_rsd is not None and relative_se(state.samples) <= target_rsd:
            break
        ki = call_key(key, i)
        if supervised:
            out = sample(ki, b, call_index=i)
        else:
            out = np.asarray(sample(ki, b), np.float64)
        if isinstance(out, QuarantinedBatch):
            state = dataclasses.replace(state, cursor=i + 1, quarantined=state.quarantined + (out,))
        else:
            if multi:
                if out.ndim != 2:
                    raise ValueError(
                        f"family sample_fn must return [batch, T] estimates; got shape {out.shape}"
                    )
            else:
                out = out.reshape(-1)
            state = dataclasses.replace(state, cursor=i + 1, samples=_append(state.samples, out))
        if progress and (i + 1) % stride == 0:
            cur = state.samples
            mean = np.array2string(
                np.atleast_1d(cur.mean(axis=0)) if cur.size else np.zeros(1),
                precision=6,
                separator=", ",
            )
            print(f"  iter {min(state.done, n_iter)}/{n_iter}: "
                  f"running mean {mean}")
        if checkpoint is not None and ckpt_calls \
                and i + 1 - last_saved >= ckpt_calls and i + 1 < n_calls:
            checkpoint.save(i + 1, {"estimator": state.to_arrays()})
            last_saved = i + 1
            spec = faults.fire("estimator.kill")
            if spec is not None:
                raise faults.InjectedCrash(f"injected kill after checkpoint at call {i + 1}")
    if checkpoint is not None and state.cursor != last_saved:
        checkpoint.save(state.cursor, {"estimator": state.to_arrays()})
    return state


def _prepare(
    n_iter: int,
    key: prng.Key,
    delta: float,
    batch: Optional[int],
    resume: Optional[EstimatorState],
    signature_extra: str,
) -> EstimatorState:
    b = batch if batch is not None and batch > 1 else 1
    sig = run_signature(n_iter, b, delta, key, extra=signature_extra)
    if resume is not None:
        if resume.signature != sig:
            raise ResumeMismatchError(
                f"checkpoint does not match this run:\n"
                f"  checkpoint: {resume.signature}\n"
                f"  run:        {sig}\n"
                f"resume needs the same graph/template/backend, key, n_iter, "
                f"batch, and delta as the interrupted run"
            )
        return resume
    return EstimatorState(
        signature=sig,
        n_iter=n_iter,
        batch=b,
        delta=delta,
        cursor=0,
        samples=np.zeros((0,), np.float64),
    )


def _supervise(sample: SampleFn, retry: Optional[RetryPolicy]) -> Union[SampleFn, Supervisor]:
    if isinstance(sample, Supervisor) or retry is None:
        return sample
    return Supervisor(sample, retry)


def estimate_counts(
    source: Union[CountingPlan, SampleFn],
    n_iter: int,
    key: prng.Key,
    *,
    delta: float = 0.1,
    batch: Optional[int] = None,
    progress: bool = False,
    retry: Optional[RetryPolicy] = None,
    checkpoint=None,
    checkpoint_every: int = 0,
    resume: Optional[EstimatorState] = None,
    target_rsd: Optional[float] = None,
    signature_extra: str = "",
) -> CountEstimate:
    """Run ``n_iter`` independent colorings and aggregate (Algorithm 1 l.14).

    ``source`` is a :class:`CountingPlan` (it runs on the plan's device) or
    any ``sample_fn(key, batch)`` callable (the backend protocol above).  ``batch=B`` evaluates B colorings per
    backend call, amortizing dispatch overhead over the embarrassingly
    parallel outer loop; the estimate is identical in distribution to the
    one-at-a-time loop.

    Robustness (all optional, see module docstring / DESIGN.md §16):
    ``retry`` supervises the backend (bounded retry, timeout, validation,
    quarantine); ``checkpoint``/``checkpoint_every`` persist the
    :class:`EstimatorState` every N iterations via a
    :class:`~repro_torch.train.checkpoint.CheckpointManager`; ``resume`` continues
    from a restored state (bit-exact — same aggregates as uninterrupted);
    ``target_rsd`` stops early once the running relative standard error of
    the mean reaches the target (banked iterations count).
    """
    sample = source if callable(source) else plan_sample_fn(source)
    state = _prepare(n_iter, key, delta, batch, resume, signature_extra)
    resumed_from = state.done
    state = _collect_samples(
        _supervise(sample, retry),
        key,
        state,
        progress=progress,
        checkpoint=checkpoint,
        checkpoint_every=checkpoint_every,
        target_rsd=target_rsd,
    )
    if state.samples.reshape(-1)[:n_iter].shape[0] == 0:
        raise EstimationAborted(
            f"all {len(state.quarantined)} batches were quarantined: "
            + "; ".join(str(q) for q in state.quarantined)
        )
    mom, mean, rsd, used, ests = aggregate_single(state.samples, n_iter, delta)
    return CountEstimate(
        mom,
        mean,
        rsd,
        ests,
        used,
        quarantined=state.quarantined,
        resumed_from=resumed_from,
    )


def estimate_counts_many(
    sample_fn: SampleFn,
    n_iter: int,
    key: prng.Key,
    *,
    delta: float = 0.1,
    batch: Optional[int] = None,
    progress: bool = False,
    retry: Optional[RetryPolicy] = None,
    checkpoint=None,
    checkpoint_every: int = 0,
    resume: Optional[EstimatorState] = None,
    target_rsd: Optional[float] = None,
    signature_extra: str = "",
) -> MultiCountEstimate:
    """The family variant: one shared-coloring pass, per-template aggregates.

    ``sample_fn(key, batch)`` must return ``[batch, T]`` per-template copy
    estimates (e.g. :func:`~.count_engine.multi_sample_fn`); the
    median-of-means and RSD math is the scalar path applied column-wise, so
    a family run and ``T`` independent runs report identical statistics on
    identical samples.  The robustness keywords behave exactly as on
    :func:`estimate_counts`; ``target_rsd`` gates on the worst template.
    """
    state = _prepare(n_iter, key, delta, batch, resume, signature_extra)
    resumed_from = state.done
    state = _collect_samples(
        _supervise(sample_fn, retry),
        key,
        state,
        progress=progress,
        checkpoint=checkpoint,
        checkpoint_every=checkpoint_every,
        target_rsd=target_rsd,
        multi=True,
    )
    ests = state.samples[:n_iter]
    if ests.shape[0] == 0:
        raise EstimationAborted(
            f"all {len(state.quarantined)} batches were quarantined: "
            + "; ".join(str(q) for q in state.quarantined)
        )
    if ests.ndim != 2:
        raise ValueError(f"family sample_fn must return [batch, T] estimates; got shape {ests.shape}")
    used = int(ests.shape[0])
    mom = np.atleast_1d(median_of_means(ests, num_groups_for(delta, used)))
    means = ests.mean(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rsds = np.where(means != 0, ests.std(axis=0) / np.abs(means), np.inf)
    return MultiCountEstimate(
        mom,
        means,
        rsds,
        ests,
        used,
        quarantined=state.quarantined,
        resumed_from=resumed_from,
    )
