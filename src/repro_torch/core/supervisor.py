"""Supervision layer for the ``sample_fn(key, batch)`` backend protocol.

Long estimates on real clusters see flaky shards: a batch dispatch can
raise (preempted worker, OOM, transport error), hang, or return garbage.
The estimator's contract with its backends is exactly one function, so one
wrapper hardens every backend at once: :class:`Supervisor` wraps any
``sample_fn`` with

* a **per-attempt timeout** (the attempt runs on a worker thread; a hung
  dispatch surfaces as :class:`SampleTimeout` instead of wedging the run);
* **bounded retry with exponential backoff** for transient faults
  (exceptions, timeouts) — the retried attempt re-uses the *same* PRNG key,
  so a retry that succeeds is bit-identical to a first try that succeeded;
* **payload validation**: per-coloring copy estimates are nonnegative and
  finite *by construction* (they are scaled colorful-map counts), so a
  NaN/Inf or negative entry is data corruption, not noise — a **hard
  fault** that is never retried;
* **graceful degradation**: a batch that keeps failing (or hard-faults) is
  *quarantined* — recorded as a :class:`QuarantinedBatch` and excluded from
  the estimate — rather than silently dropped or allowed to kill the run.
  The estimator surfaces the quarantine records in ``CountResult``.

Failure taxonomy and which layer handles what: DESIGN.md §16.  The port's
counterpart of ``repro/core/supervisor.py``; keys are the port's threefry
key data (:mod:`.prng`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..testing import faults

#: a threefry key (``prng.key``): int64 ``[2]`` holding two uint32 words
Key = torch.Tensor

__all__ = [
    "RetryPolicy",
    "SampleFault",
    "SampleTimeout",
    "SampleValidationError",
    "QuarantinedBatch",
    "Supervisor",
    "key_fingerprint",
]


class SampleFault(RuntimeError):
    """A supervised sample attempt failed."""


class SampleTimeout(SampleFault):
    """An attempt exceeded the policy's per-batch timeout (transient)."""


class SampleValidationError(SampleFault):
    """The returned payload violates the protocol invariants (hard fault).

    Copy estimates are nonnegative finite floats by construction; NaN/Inf
    or negative entries mean the backend computed garbage — retrying the
    same deterministic computation would return the same garbage, so the
    batch is quarantined immediately.
    """


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for transient sample faults.

    ``max_retries`` counts *re*-tries: a batch gets ``1 + max_retries``
    attempts before quarantine.  ``timeout_s=None`` disables the worker
    thread entirely (attempts run inline — zero overhead, no timeout).
    """

    max_retries: int = 3
    backoff_s: float = 0.05  # first retry delay
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    timeout_s: Optional[float] = None  # per-attempt wall clock


@dataclasses.dataclass(frozen=True)
class QuarantinedBatch:
    """Provenance of one excluded batch: which keys, why, how hard we tried."""

    call_index: int  # index into the run's per-call key sequence
    key_data: Tuple[int, ...]  # PRNG key words (uint32) — replayable
    reason: str
    attempts: int

    def __str__(self) -> str:
        return (
            f"batch #{self.call_index} quarantined after {self.attempts} "
            f"attempt(s): {self.reason}"
        )


def key_fingerprint(key) -> Tuple[int, ...]:
    """The raw uint32 words of a PRNG key — a replayable, hashable id."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    data = np.asarray(key, np.int64).reshape(-1)
    return tuple(int(w) & 0xFFFFFFFF for w in data)


class Supervisor:
    """Wrap a ``sample_fn`` with retry, timeout, validation, quarantine.

    The wrapped object speaks a superset of the protocol:
    ``supervisor(key, batch, call_index=i)`` returns the float64 samples on
    success, or the :class:`QuarantinedBatch` record when the batch was
    given up on.  All quarantine records also accumulate on
    :attr:`quarantined`.

    ``sleep`` and ``clock`` are injectable seams so retry- and timeout-path
    tests never wait on the wall clock: with the default ``clock``
    (``time.monotonic``) a timeout attempt runs on a worker thread and a
    genuinely hung dispatch is detected in real time; with an injected
    clock the attempt runs inline and "exceeded the timeout" is judged by
    comparing injected-clock readings around it (fault-site sleeps route
    through ``sleep``, so a virtual clock whose ``sleep`` advances it
    exercises the full timeout->retry path in zero wall time).
    """

    def __init__(
        self,
        sample_fn: Callable[[Key, int], np.ndarray],
        policy: Optional[RetryPolicy] = None,
        *,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.fn = sample_fn
        self.policy = policy or RetryPolicy()
        self.quarantined: List[QuarantinedBatch] = []
        self._sleep = sleep
        self._clock = clock
        self._virtual_clock = clock is not time.monotonic

    # ---------------------------------------------------------- one attempt
    def _raw_attempt(self, key: Key, batch: int) -> np.ndarray:
        spec = faults.fire("sample.raise")
        if spec is not None:
            raise faults.InjectedFault("injected sample failure")
        spec = faults.fire("sample.timeout")
        if spec is not None:
            t = self.policy.timeout_s
            self._sleep(spec.payload if spec.payload is not None else (4.0 * t if t else 0.5))
        out = np.asarray(self.fn(key, batch), np.float64)
        spec = faults.fire("sample.nan")
        if spec is not None:
            out = out.copy()
            out.reshape(-1)[0] = np.nan
        spec = faults.fire("sample.negative")
        if spec is not None:
            out = out.copy()
            out.reshape(-1)[0] = -1.0
        return out

    def _timed_attempt(self, key: Key, batch: int) -> np.ndarray:
        t = self.policy.timeout_s
        if t is None:
            return self._raw_attempt(key, batch)
        if self._virtual_clock:
            # injected clock: run inline and judge the timeout from clock
            # readings — the deterministic test path (no worker thread, no
            # wall waiting); real hang detection needs the real clock below
            t0 = self._clock()
            out = self._raw_attempt(key, batch)
            if self._clock() - t0 > t:
                raise SampleTimeout(f"sample batch exceeded the {t}s timeout")
            return out
        box: dict = {}

        def work():
            try:
                box["out"] = self._raw_attempt(key, batch)
            except BaseException as e:  # propagated below
                box["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(t)
        if th.is_alive():
            # the attempt's thread lingers until its dispatch returns (python
            # threads are not killable); the *run* moves on and retries
            raise SampleTimeout(f"sample batch exceeded the {t}s timeout")
        if "err" in box:
            raise box["err"]
        return box["out"]

    @staticmethod
    def _validate(out: np.ndarray, batch: int) -> None:
        if out.ndim < 1 or out.shape[0] != batch:
            raise SampleValidationError(
                f"payload shape {out.shape} does not lead with batch={batch}"
            )
        if not np.all(np.isfinite(out)):
            raise SampleValidationError("non-finite (NaN/Inf) sample payload")
        if np.any(out < 0):
            raise SampleValidationError(
                "negative copy estimate — counts are nonnegative by "
                "construction, so this is data corruption, not noise"
            )

    # ------------------------------------------------------------- the loop
    def __call__(
        self, key: Key, batch: int, call_index: int = 0
    ) -> Union[np.ndarray, QuarantinedBatch]:
        delay = self.policy.backoff_s
        attempts = 0
        while True:
            attempts += 1
            try:
                out = self._timed_attempt(key, batch)
                self._validate(out, batch)
                return out
            except SampleValidationError as e:
                reason = str(e)  # hard fault: never retried
                break
            except Exception as e:
                reason = f"{type(e).__name__}: {e}"
                if attempts > self.policy.max_retries:
                    break
                self._sleep(delay)
                delay = min(
                    delay * self.policy.backoff_factor,
                    self.policy.max_backoff_s,
                )
        record = QuarantinedBatch(
            call_index=call_index,
            key_data=key_fingerprint(key),
            reason=reason,
            attempts=attempts,
        )
        self.quarantined.append(record)
        return record
