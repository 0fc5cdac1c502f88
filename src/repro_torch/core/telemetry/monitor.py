"""Online runtime verification of the admission analyses.

Every admission test the scheduling core runs (EDF processor-demand,
fixed-priority response-time, server supply-bound — ``sched/admission``)
proves the same promise when it passes: *the item's worst-case response
time fits inside its deadline*. The :class:`BoundMonitor` replays each
completion against that promise, turning the analytic guarantee into a
checked one (cf. RTGPU's measured-vs-modelled validation):

* **bound_violation** — an ADMITTED item finished after its deadline.
  The analysis said R ≤ D and reality disagreed; either an input
  assumption broke (see ``wcet_overrun``) or the analysis is wrong.
  This is the alarm that must stay at zero for the bounds to be trusted.
* **deadline_miss** — an item with a deadline but WITHOUT an admission
  promise (``admission=False``) finished late. Expected under overload;
  recorded so per-class miss statistics are exact, but it impeaches no
  analysis. (An item admitted THROUGH shedding holds a full promise —
  the dry-run analysis passed once its victims were cancelled.)
* **wcet_overrun** — an admitted item's observed service exceeded the
  WCET estimate admission charged for it. The usual ROOT CAUSE of a
  bound violation: the analysis was sound, its input was not.

Entries land in a bounded ledger (newest kept) with exact running
counters, and registered alert callbacks fire synchronously per
violation — a raising callback is captured on ``callback_errors``, never
propagated into the dispatcher's retirement path.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["BoundMonitor", "Violation",
           "BOUND_VIOLATION", "DEADLINE_MISS", "WCET_OVERRUN"]

BOUND_VIOLATION = "bound_violation"
DEADLINE_MISS = "deadline_miss"
WCET_OVERRUN = "wcet_overrun"

# submissions the monitor may track before it starts dropping the oldest
# promise records (a leak guard for cancelled-and-never-resolved floods;
# a dropped record degrades a bound_violation into a deadline_miss, it
# never invents one)
_MAX_PENDING = 65536


@dataclass(frozen=True)
class Violation:
    """One ledger entry: what was promised, what happened instead."""

    kind: str                 # BOUND_VIOLATION / DEADLINE_MISS / WCET_OVERRUN
    request_id: int
    opcode: int
    cluster: int
    t_us: int                 # when the violation was detected
    deadline_us: int = 0
    lateness_us: float = 0.0  # end − deadline (or service − estimate)
    detail: str = ""


@dataclass
class _Promise:
    deadline_us: int
    admitted: bool
    est_us: Optional[float] = None
    violations: list = field(default_factory=list)


class BoundMonitor:
    """Replays completions against the admission-time response bound."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.ledger: deque[Violation] = deque(maxlen=capacity)
        self._pending: dict[int, _Promise] = {}
        self._callbacks: list[Callable[[Violation], None]] = []
        self.callback_errors: list[BaseException] = []
        self.checked = 0
        self.admitted_checked = 0
        self.bound_violations = 0
        self.deadline_misses = 0
        self.wcet_overruns = 0

    # -- registration ---------------------------------------------------
    def on_violation(self, fn: Callable[[Violation], None]) -> None:
        """Alert callback, fired synchronously per violation record."""
        self._callbacks.append(fn)

    # -- dispatcher-side hooks ------------------------------------------
    def note_submit(self, request_id: int, opcode: int, deadline_us: int,
                    admitted: bool, est_us: Optional[float],
                    t_us: int) -> None:
        """Record the promise attached to one submission: ``admitted``
        means an admission analysis PASSED for it (its response-time
        bound is the deadline); ``est_us`` is the WCET estimate the
        analysis charged (for overrun attribution)."""
        if len(self._pending) >= _MAX_PENDING:
            self._pending.pop(next(iter(self._pending)))
        self._pending[request_id] = _Promise(
            deadline_us=deadline_us, admitted=admitted, est_us=est_us)

    def note_withdrawn(self, request_id: int) -> None:
        """The submission was cancelled/shed — its promise dissolves."""
        self._pending.pop(request_id, None)

    def note_resolve(self, request_id: int, opcode: int, cluster: int,
                     end_us: int, deadline_us: int,
                     service_us: float) -> list[Violation]:
        """Check one completed item; returns the violations it produced
        (empty list = the bound held)."""
        promise = self._pending.pop(request_id, None)
        if promise is not None and promise.deadline_us:
            deadline_us = promise.deadline_us
        admitted = promise is not None and promise.admitted
        self.checked += 1
        if admitted:
            self.admitted_checked += 1
        out: list[Violation] = []
        if deadline_us and end_us > deadline_us:
            late = float(end_us - deadline_us)
            if admitted:
                self.bound_violations += 1
                out.append(Violation(
                    BOUND_VIOLATION, request_id, opcode, cluster, end_us,
                    deadline_us=deadline_us, lateness_us=late,
                    detail="admitted response-time bound exceeded"))
            else:
                self.deadline_misses += 1
                out.append(Violation(
                    DEADLINE_MISS, request_id, opcode, cluster, end_us,
                    deadline_us=deadline_us, lateness_us=late,
                    detail="deadline missed (no admission promise)"))
        if admitted and promise.est_us is not None \
                and service_us > promise.est_us:
            self.wcet_overruns += 1
            out.append(Violation(
                WCET_OVERRUN, request_id, opcode, cluster, end_us,
                deadline_us=deadline_us,
                lateness_us=float(service_us - promise.est_us),
                detail=f"service {service_us:.0f}µs > admitted estimate "
                       f"{promise.est_us:.0f}µs"))
        for v in out:
            self.ledger.append(v)
            for fn in self._callbacks:
                try:
                    fn(v)
                except Exception as e:   # alerts must not lose completions
                    self.callback_errors.append(e)
        return out

    # -- reporting ------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._pending)

    def counts(self) -> dict:
        """Exact running counters (not limited to the ledger window)."""
        return {
            "checked": self.checked,
            "admitted_checked": self.admitted_checked,
            "bound_violations": self.bound_violations,
            "deadline_misses": self.deadline_misses,
            "wcet_overruns": self.wcet_overruns,
            "ledger": len(self.ledger),
            "alert_errors": len(self.callback_errors),
        }

    def clear(self) -> None:
        self.ledger.clear()
        self._pending.clear()
        self.checked = self.admitted_checked = 0
        self.bound_violations = self.deadline_misses = 0
        self.wcet_overruns = 0
