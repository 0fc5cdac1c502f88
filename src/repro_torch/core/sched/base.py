"""Scheduling-policy interface for the persistent dispatcher.

Every queueing decision the :class:`~repro_torch.core.dispatcher.Dispatcher` makes
— which item triggers next, whether a new item is admitted, what happens to
a cancelled or retired item — goes through a :class:`SchedPolicy`. The
dispatcher owns the *mechanism* (mailboxes, pipelines, tickets, failure
replay); the policy owns the *decisions*. Three implementations ship:

* :class:`~repro_torch.core.sched.edf.EdfPolicy` — earliest-deadline-first with a
  processor-demand admission test (the pre-refactor behaviour, default);
* :class:`~repro_torch.core.sched.fixed_priority.FixedPriorityPolicy` —
  rate-monotonic-style static priorities with response-time admission;
* :class:`~repro_torch.core.sched.server.BudgetedServerPolicy` — per-class
  bandwidth servers giving hard temporal isolation between work classes.

Policies are single-threaded (the dispatcher is a single-host-thread event
pump) and keep their per-cluster state internally: the dispatcher calls
``add_cluster``/``drop_cluster`` as clusters register, fail, or retire.

Cancellation uses the dispatcher's lazy-tombstone discipline: a cancelled
item stays physically enqueued (``note_cancelled`` keeps the live-depth
accounting exact in O(1)) and is discarded when it reaches the front in
``pop_next``. ``live_items`` snapshots never include tombstones.
"""
from __future__ import annotations

import abc
import heapq
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence

from repro_torch.core.mailbox import NO_DEADLINE, WorkDescriptor
from repro_torch.core.sched import admission

__all__ = [
    "NO_DEADLINE", "CRIT_LOW", "CRIT_HIGH", "CRITICALITIES", "crit_rank",
    "ClassSpec", "QueueItem", "SchedPolicy",
]

# Criticality levels for overload shedding: when admission of a HIGH item
# fails, the dispatcher may cancel queued LOW items (via the normal ticket
# cancel path) to make room. Two levels keep the lattice obvious; rank is
# positional, so inserting intermediate levels later stays cheap.
CRIT_LOW = "low"
CRIT_HIGH = "high"
CRITICALITIES = (CRIT_LOW, CRIT_HIGH)


def crit_rank(criticality: str) -> int:
    """Numeric rank of a criticality level (higher = more critical)."""
    return CRITICALITIES.index(criticality)


@dataclass(frozen=True)
class ClassSpec:
    """Per-opcode scheduling parameters, declared once at registration.

    opcode      — the runtime work-table index this spec describes.
    name        — human-readable class name (diagnostics, ticket.server).
    priority    — static priority for fixed-priority scheduling; SMALLER is
                  more urgent (0 = highest). None = derive rate-monotonic
                  from ``period_us`` (shorter period → higher priority).
    budget_us   — replenishing execution budget per ``period_us`` for the
                  budgeted-server policy. None = unbudgeted (best effort,
                  always eligible, no isolation guarantee).
    period_us   — replenishment period / rate-monotonic period.
    criticality — overload-shedding level (``CRIT_LOW`` / ``CRIT_HIGH``).
    chunk_us    — declared worst-case length of ONE resumable chunk when
                  this class submits chunked work (``n_chunks > 1``).
                  Under a preemptive policy this replaces the class's full
                  WCET in every BLOCKING term of the admission analyses —
                  the refactor's whole point: a long item no longer blocks
                  higher-urgency work for its WCET, only for one chunk.
                  None = unknown (falls back to observed per-chunk worsts,
                  then to the full WCET estimate).
    """

    opcode: int
    name: str = ""
    priority: Optional[int] = None
    budget_us: Optional[float] = None
    period_us: Optional[float] = None
    criticality: str = CRIT_LOW
    chunk_us: Optional[float] = None

    def __post_init__(self):
        if self.criticality not in CRITICALITIES:
            raise ValueError(
                f"criticality must be one of {CRITICALITIES}, "
                f"got {self.criticality!r}")
        if self.budget_us is not None:
            if self.period_us is None:
                raise ValueError(
                    f"class {self.name or self.opcode}: budget_us requires "
                    "period_us (a budget replenishes once per period)")
            if self.budget_us <= 0 or self.period_us <= 0:
                raise ValueError("budget_us and period_us must be > 0")
        if self.chunk_us is not None and self.chunk_us <= 0:
            raise ValueError("chunk_us must be > 0")


@dataclass
class QueueItem:
    """One queued unit of work, policy-agnostic.

    ``deadline_us`` is normalized (``NO_DEADLINE`` when the descriptor has
    none) so every policy can compare deadlines without re-checking the
    zero sentinel. Ordering is the POLICY's business — this dataclass is
    deliberately unordered; policies build explicit sort keys.

    A chunked item's REMAINDER re-enters the queue as a new ``QueueItem``
    that keeps the original ``seq`` (so it sorts exactly where the running
    item stood), ``submitted_us`` (queueing delay is measured from the
    ORIGINAL submission) and ``ticket`` (resolved once, at the final
    chunk); ``started_us``/``service_accum_us`` thread the first-trigger
    time and the accumulated per-chunk service across the requeues.
    """

    deadline_us: int
    seq: int
    desc: WorkDescriptor
    submitted_us: int = 0
    ticket: Any = None
    started_us: Optional[int] = None
    service_accum_us: float = 0.0

    def cancelled(self) -> bool:
        return self.ticket is not None and self.ticket.cancelled()


class _HeapLane:
    """A lazy-deletion min-heap of queue items under one sort key.

    Entries are ``(key, seq, item)`` — ``seq`` breaks ties without ever
    comparing items. ``dead`` counts cancelled-but-still-enqueued
    tombstones so live depth is O(1); tombstones are physically discarded
    when they surface at the heap top.
    """

    __slots__ = ("heap", "dead")

    def __init__(self):
        self.heap: list = []
        self.dead = 0

    def push(self, key, item: QueueItem) -> None:
        heapq.heappush(self.heap, (key, item.seq, item))

    def tombstone(self) -> None:
        """Account one cancelled-but-enqueued item; when the whole lane is
        tombstones, free it eagerly (an idle dispatcher after a
        mass-cancel storm must not retain the cancelled items forever)."""
        self.dead += 1
        self._compact()

    def _compact(self) -> None:
        if self.dead and self.dead >= len(self.heap):
            self.heap.clear()
            self.dead = 0

    def pop_live(self) -> Optional[QueueItem]:
        while self.heap:
            _, _, item = heapq.heappop(self.heap)
            if item.cancelled():
                if self.dead > 0:
                    self.dead -= 1
                continue
            self._compact()      # remainder may be all tombstones
            return item
        return None

    def peek_live(self) -> Optional[QueueItem]:
        while self.heap:
            _, _, item = self.heap[0]
            if item.cancelled():
                heapq.heappop(self.heap)
                if self.dead > 0:
                    self.dead -= 1
                continue
            return item
        return None

    def depth(self) -> int:
        return max(0, len(self.heap) - self.dead)

    def live_items(self) -> list[QueueItem]:
        return [it for _, _, it in self.heap if not it.cancelled()]


class SchedPolicy(abc.ABC):
    """Pluggable scheduling core: queueing + admission for one dispatcher.

    One policy instance serves ALL of a dispatcher's clusters (per-cluster
    state lives inside the policy, keyed by cluster id) so policies that
    need cross-class bookkeeping — e.g. bandwidth servers — have one home.
    """

    name = "abstract"

    def __init__(self, classes: Sequence[ClassSpec] = (), *,
                 preemptive: bool = True):
        self._specs: dict[int, ClassSpec] = {}
        # resolved priorities, memoized — priority_of runs per queued
        # item in admission scans, and the ranks only change at
        # set_class time
        self._prio_cache: dict[int, int] = {}
        # preemptive=True lets chunked work be displaced at chunk
        # boundaries (``should_preempt``) and lets admission credit the
        # collapsed one-chunk blocking term. False pins the pre-chunking
        # behaviour: a popped item runs all its chunks back to back and
        # blocks for its full remaining WCET (the configuration the EDF
        # observational-equivalence property is stated for). Atomic work
        # is never preempted either way.
        self.preemptive = bool(preemptive)
        for spec in classes:
            self.set_class(spec)

    # -- class registry -------------------------------------------------
    def set_class(self, spec: ClassSpec) -> None:
        """Declare (or re-declare) the scheduling parameters of one
        opcode. Policies may validate the whole table here."""
        self._specs[spec.opcode] = spec
        self._prio_cache.clear()

    def spec(self, opcode: int) -> Optional[ClassSpec]:
        return self._specs.get(opcode)

    def specs(self) -> tuple[ClassSpec, ...]:
        """Every declared class spec (telemetry naming, diagnostics)."""
        return tuple(self._specs.values())

    def criticality_of(self, opcode: int) -> str:
        s = self._specs.get(opcode)
        return s.criticality if s is not None else CRIT_LOW

    def priority_of(self, opcode: int) -> int:
        """Resolved static priority (smaller = more urgent). Base rule:
        explicit priority wins; else rate-monotonic rank from the period
        table; else a large best-effort priority. Memoized until the
        class table changes."""
        cached = self._prio_cache.get(opcode)
        if cached is not None:
            return cached
        s = self._specs.get(opcode)
        if s is not None and s.priority is not None:
            prio = s.priority
        elif s is not None and s.period_us is not None:
            periods = sorted({c.period_us for c in self._specs.values()
                              if c.period_us is not None
                              and c.priority is None})
            prio = periods.index(s.period_us)
        else:
            prio = 10_000
        self._prio_cache[opcode] = prio
        return prio

    # -- cluster lifecycle ----------------------------------------------
    @abc.abstractmethod
    def add_cluster(self, cluster: int) -> None:
        """A cluster registered; create its queue state."""

    @abc.abstractmethod
    def drop_cluster(self, cluster: int) -> list[QueueItem]:
        """Remove a cluster's queue state; return its LIVE items (for
        failure replay). Unknown clusters return []."""

    # -- queueing --------------------------------------------------------
    @abc.abstractmethod
    def enqueue(self, cluster: int, item: QueueItem) -> None:
        """Accept one item into the cluster's queue."""

    @abc.abstractmethod
    def pop_next(self, cluster: int, now_us: int) -> Optional[QueueItem]:
        """The next item this cluster should trigger, or None when nothing
        is ELIGIBLE right now (empty, or budget-deferred)."""

    @abc.abstractmethod
    def depth(self, cluster: int) -> int:
        """Live queued items (tombstones excluded); 0 for unknown ids."""

    @abc.abstractmethod
    def live_items(self, cluster: int) -> list[QueueItem]:
        """Snapshot of live queued items (arbitrary order)."""

    def has_queued(self, cluster: int) -> bool:
        return self.depth(cluster) > 0

    def note_cancelled(self, cluster: int, ticket) -> None:
        """A queued ticket was cancelled: account the tombstone in O(1).
        Default is a no-op for policies without tombstone counters."""

    def next_eligible_us(self, cluster: int,
                         now_us: int) -> Optional[int]:
        """Earliest time a currently-deferred item becomes eligible, or
        None when nothing is deferred (work-conserving policies)."""
        return None

    # -- preemption ------------------------------------------------------
    def should_preempt(self, cluster: int, item: QueueItem,
                       now_us: int) -> bool:
        """The dispatcher's preemption point: a chunk of ``item`` just
        retired and more chunks remain — should the remainder go back
        through the queue (letting a more urgent head run first), or
        continue immediately on the cluster? Base policy: never preempt
        (chunks run back to back, the pre-chunking behaviour)."""
        return False

    def _inflight_demand_us(self, d: WorkDescriptor, qualifies: bool,
                            estimate: Callable[[int], float],
                            chunk_estimate: Callable[[int], float]) -> float:
        """Carry-in demand of ONE in-flight descriptor: its full remaining
        work when it must run before the incoming item (``qualifies``) or
        when the policy cannot preempt it; one chunk otherwise — the
        collapsed blocking term a preempted item leaves behind."""
        if qualifies or not self.preemptive or not d.chunked:
            return admission.remaining_us(d, estimate, chunk_estimate)
        return chunk_estimate(d.opcode)

    # -- admission / accounting -----------------------------------------
    @abc.abstractmethod
    def admit(self, cluster: int, desc: WorkDescriptor, *,
              estimate: Callable[[int], float],
              inflight: Sequence[WorkDescriptor], now_us: int,
              ignore: Iterable[QueueItem] = (),
              chunk_estimate: Optional[Callable[[int], float]] = None
              ) -> None:
        """Analytic admission test for ``desc`` on ``cluster``; raises
        :class:`~repro_torch.core.sched.admission.AdmissionError` (carrying the
        failing term) when the item cannot make its deadline under
        worst-case estimates. ``ignore`` items are treated as cancelled —
        the dispatcher uses this to dry-run criticality shedding before
        actually cancelling anything. ``chunk_estimate`` gives the
        worst-case length of ONE chunk of an opcode (defaults to the full
        ``estimate`` for atomic classes)."""

    def on_retire(self, cluster: int, item: QueueItem, service_us: float,
                  now_us: int) -> None:
        """An item finished after ``service_us``; charge budgets etc."""
