"""Deterministic fault injection at named sites (DESIGN.md §16).

The port's own copy of ``repro/testing/faults.py`` (the port imports
nothing of the reference package), with the same sites.

Recovery paths are only trustworthy if they are *exercised*: this module
lets tier-1 tests make a specific failure happen at a specific, repeatable
point — the second sample batch raises, the first checkpoint write dies
between the tmp write and the rename, every compact dispatch overflows —
without monkeypatching internals or relying on timing races.

Instrumented sites (grep ``faults.fire`` for the authoritative list):

=========================  ====================================================
``sample.raise``           a supervised sample attempt raises :class:`InjectedFault`
``sample.timeout``         a supervised sample attempt sleeps past the policy
                           timeout (``payload`` seconds; default 4x the policy)
``sample.nan``             the returned sample payload is poisoned with NaN
``sample.negative``        the returned payload contains a negative count
``checkpoint.write_crash``  :meth:`CheckpointManager.save` raises
                           :class:`InjectedCrash` after writing ``step_*.tmp``
                           but before the atomic rename (kill mid-save)
``estimator.kill``         the estimation loop raises :class:`InjectedCrash`
                           immediately after a checkpoint save (kill between
                           checkpoints)
``compaction.overflow``    the §15 speculate-check wrapper treats the batch as
                           overflowed and re-runs it on the dense twin (the
                           single-device counter and the distributed count
                           function of a compacted plan)
``compression.saturate``   a narrow-wire distributed count function treats the
                           batch as saturated and re-runs it one rung wider
                           (int8 -> int16 -> float32), DESIGN.md §18
``service.step_crash``     :meth:`CountingService.step` raises
                           :class:`InjectedFault` before scheduling anything
                           (the §20 driver thread must record it and survive)
``service.pass_poison``    one coalesced pass call's backend payload is
                           poisoned with NaN — a §16 hard fault: the call
                           quarantines without killing co-riding requests
``service.slow_pass``      one coalesced pass call sleeps ``payload`` seconds
                           (default 4x the service timeout) so the service
                           supervisor's per-batch timeout fires and retries
=========================  ====================================================

Usage::

    from repro_torch.testing import faults

    with faults.active(faults.inject("sample.raise", at=(0, 1))):
        ...  # the first two occurrences of the site raise; the third runs

``at`` indexes *occurrences* of the site (0-based, counted per activation);
``at=None`` fires every occurrence (persistent failure).  Activation is
process-global and re-entrant-unsafe by design — tests activate exactly one
plan at a time; occurrence counters reset on each activation.  When no plan
is active every hook is a single ``is None`` check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

__all__ = [
    "FaultSpec",
    "FaultPlan",
    "InjectedFault",
    "InjectedCrash",
    "inject",
    "active",
    "fire",
    "is_active",
]


class InjectedFault(RuntimeError):
    """A *transient* injected failure (retryable — e.g. a sample raise)."""


class InjectedCrash(RuntimeError):
    """A *fatal* injected failure simulating a process kill.

    Raised by the ``checkpoint.write_crash`` and ``estimator.kill`` sites;
    product code never catches it, so it unwinds like SIGKILL would (minus
    the actual process exit), leaving on-disk state exactly as a real kill
    at that point leaves it.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``site`` at the given occurrence indices."""

    site: str
    at: Optional[frozenset] = frozenset({0})  # None = every occurrence
    payload: Any = None  # site-specific (e.g. sleep seconds for a timeout)

    def fires(self, occurrence: int) -> bool:
        return self.at is None or occurrence in self.at


def inject(
    site: str,
    at: Optional[Iterable[int]] = (0,),
    payload: Any = None,
) -> FaultSpec:
    """Schedule ``site`` to fault at the given occurrence indices."""
    return FaultSpec(site, None if at is None else frozenset(at), payload)


class FaultPlan:
    """A set of :class:`FaultSpec` plus per-site occurrence counters."""

    def __init__(self, *specs: FaultSpec):
        self._specs: Dict[str, Tuple[FaultSpec, ...]] = {}
        for s in specs:
            self._specs[s.site] = self._specs.get(s.site, ()) + (s,)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()  # timed sample attempts fire from their thread
        self.fired: list = []  # (site, occurrence) log, for test assertions

    def fire(self, site: str) -> Optional[FaultSpec]:
        if site not in self._specs:
            return None
        with self._lock:
            occ = self._counts.get(site, 0)
            self._counts[site] = occ + 1
            for spec in self._specs[site]:
                if spec.fires(occ):
                    self.fired.append((site, occ))
                    return spec
        return None


_ACTIVE: Optional[FaultPlan] = None


def is_active() -> bool:
    return _ACTIVE is not None


def fire(site: str) -> Optional[FaultSpec]:
    """The hook product code calls at a named site.

    Returns the matching :class:`FaultSpec` when the active plan schedules a
    fault for this occurrence, else ``None``.  A single ``is None`` check
    when no plan is active — the instrumented hot paths pay nothing.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site)


@contextlib.contextmanager
def active(*specs: FaultSpec):
    """Activate a fault plan for the duration of the block.

    Yields the :class:`FaultPlan` (its ``fired`` log is useful for asserting
    that a site was actually reached).  Occurrence counters start at zero.
    """
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a fault plan is already active (no nesting)")
    plan = FaultPlan(*specs)
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None
