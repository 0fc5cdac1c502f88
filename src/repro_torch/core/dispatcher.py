"""Host-side dispatcher: pluggable per-cluster scheduling, analytic
admission control, straggler detection, failure handling — over a
pipelined trigger/wait split.

Real-time semantics follow the paper's design goals (§II-A): worst-case
driven admission (WCET estimates, not averages), spatial pinning of work
classes to clusters, and accounting of the avg↔worst gap.

Every scheduling DECISION lives in a :class:`repro_torch.core.sched.SchedPolicy`
(EDF by default; fixed-priority and budgeted-server ship too — see
``repro/core/sched/``): the policy owns the per-cluster queues, the
trigger order, the admission analysis, and budget accounting. The
dispatcher owns the MECHANISM: mailboxes, pipeline capacity, tickets,
WCET observation, straggler flagging, and failure replay. Criticality
shedding bridges the two: when a HIGH-criticality submission fails
admission, queued LOW-criticality work is cancelled (through the normal
ticket ``cancel()`` path, after a dry-run proves it suffices) to make
room.

Dispatch is asynchronous end to end: ``drain()`` runs an event loop that
triggers the next eligible item on EVERY cluster with pipeline capacity
before waiting on any completion (trigger-all → ``wait_any`` → refill), so
the host keeps feeding mailboxes while devices run. A kick pass COALESCES
its same-cluster triggers into one batched doorbell when the runtime
offers ``trigger_many`` (one transfer + one compiled multi-step call for
the whole pass); batch items still retire one at a time, with the block's
wall time split evenly across them for WCET observation. WCET observation,
straggler flagging, and failure replay all happen at completion-retirement
time; the ``Mailbox`` keeps the per-cluster in-flight descriptor record, so
a cluster that dies mid-flight has both its queued AND in-flight work
replayed on the survivors.

Chunked execution: an item submitted with ``n_chunks > 1`` runs as a
sequence of resumable chunks, one trigger each. Every chunk retirement is
a PREEMPTION POINT: the dispatcher asks the policy's ``should_preempt()``
whether a more urgent head is waiting — if so the remainder descriptor
(``WorkDescriptor.advance()``) re-enters the NORMAL scheduling lane
(keeping its original ticket, sequence number and submission time) and
the urgent work triggers first; otherwise the remainder re-triggers
immediately, back to back. Tickets stay resolved-once (at the final
chunk); per-chunk service accumulates into the item, so ``service_us``
and WCET observation still describe whole items, while a separate
per-chunk observation stream feeds the collapsed blocking terms in
admission. A cluster failure replays REMAINDERS, not whole items: the
mailbox record holds the current-chunk descriptor, so completed chunks
are never re-run (but note the runtime carry is cluster-local — see
``PersistentRuntime`` on what chunk fns may keep there).

Submission is ticket-based: ``submit()`` returns a :class:`Ticket` future
that resolves at retirement time. Callers hold the ticket for exactly their
request — there is no shared completion list to scan. ``completions`` and
``stragglers`` are bounded rolling windows (recent history for debugging);
``deadline_stats()`` stays exact across any number of served requests via
running counters.
"""
from __future__ import annotations

import itertools
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core import mailbox as mb
from repro_torch.core.mailbox import NO_DEADLINE
from repro_torch.core.persistent import RuntimeProtocol
from repro_torch.core.sched import (
    AdmissionError, ClassSpec, QueueItem, SchedPolicy, crit_rank,
    make_policy,
)
from repro_torch.core.sched import admission as sched_admission
from repro_torch.core.telemetry import (
    EV_ADMIT, EV_CANCEL, EV_CHUNK_RETIRE, EV_FAIL, EV_PREEMPT, EV_REJECT,
    EV_REQUEUE, EV_RESOLVE, EV_SHED, EV_SUBMIT, EV_TRIGGER, TraceCollector,
)
# one clock stamps the whole timeline: dispatcher-side events and
# collector-default-stamped events (heal, rt_*) must never drift apart
from repro_torch.core.telemetry.events import now_us

__all__ = [
    "AdmissionError", "AllClustersFailed", "Completion", "Dispatcher",
    "NO_DEADLINE", "Ticket", "TicketCancelled", "now_us",
]


class AllClustersFailed(RuntimeError):
    """Every cluster is gone — nothing left to replay onto."""


class TicketCancelled(RuntimeError):
    """result() was called on a ticket whose work was cancelled."""


def _require_runtime(runtime) -> None:
    """Enforce the runtime protocol: an explicit integer ``max_inflight``
    pipeline capacity plus trigger/ready/wait. No duck-typed defaults — a
    runtime that forgets to declare its capacity is a registration error,
    not a silently serialized cluster."""
    cap = getattr(runtime, "max_inflight", None)
    if not isinstance(cap, int) or cap < 1:
        raise TypeError(
            f"{type(runtime).__name__} does not satisfy RuntimeProtocol: "
            "it must declare an integer max_inflight >= 1")
    for meth in ("trigger", "ready", "wait"):
        if not callable(getattr(runtime, meth, None)):
            raise TypeError(
                f"{type(runtime).__name__} does not satisfy RuntimeProtocol:"
                f" missing {meth}()")


class Ticket:
    """Future for one submitted work item.

    Resolved by the dispatcher inside ``_retire()`` when the item's step is
    retired from the pipeline. ``cluster`` tracks the item's CURRENT
    placement — it is rewritten when a failed cluster's work replays onto a
    survivor. ``priority`` is the static priority the scheduling policy
    resolved for this item's class (smaller = more urgent); ``server`` is
    the name of the bandwidth server the item is charged to, or None for
    unbudgeted classes.

    ``result(timeout)`` DRIVES the dispatcher (kick + wait_any) from the
    calling thread until this ticket resolves; the dispatcher is a
    single-host-thread design, so whoever blocks on a ticket does the
    pumping. ``done()``/``completion`` never block. ``cancel()`` withdraws
    work that is still queued (never-triggered); in-flight work cannot be
    cancelled. ``on_complete`` callbacks fire at resolve time — a raising
    callback never loses the completion (every error is kept on
    ``callback_errors``).
    """

    __slots__ = ("_dispatcher", "desc", "request_id", "cluster",
                 "priority", "server",
                 "_completion", "_cancelled", "_triggered", "_callbacks",
                 "callback_errors")

    def __init__(self, dispatcher: "Dispatcher", desc: mb.WorkDescriptor,
                 cluster: int):
        self._dispatcher = dispatcher
        self.desc = desc
        self.request_id = desc.request_id
        self.cluster = cluster
        self.priority: Optional[int] = None
        self.server: Optional[str] = None
        self._completion: Optional[Completion] = None
        self._cancelled = False
        self._triggered = False
        self._callbacks: list[Callable[["Completion"], None]] = []
        self.callback_errors: list[BaseException] = []

    # -- inspection ----------------------------------------------------
    def done(self) -> bool:
        return self._completion is not None

    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def completion(self) -> Optional["Completion"]:
        return self._completion

    # -- lifecycle -----------------------------------------------------
    @property
    def callback_error(self) -> Optional[BaseException]:
        """First error raised by an on_complete callback, if any."""
        return self.callback_errors[0] if self.callback_errors else None

    def cancel(self) -> bool:
        """Withdraw still-queued work. Returns True when the cancellation
        took (the item will never trigger); False once the item is in
        flight, already resolved, or already cancelled (idempotent)."""
        if self._completion is not None or self._triggered or \
                self._cancelled:
            return False
        self._cancelled = True
        self._dispatcher.cancelled_total += 1
        # the queued item becomes a tombstone, discarded lazily at pop
        # time; the policy's counter keeps load/admission exact in O(1)
        self._dispatcher._note_cancelled(self)
        return True

    def on_complete(self, fn: Callable[["Completion"], None]) -> None:
        """Register a resolve-time callback; fires immediately if the
        ticket already resolved."""
        if self._completion is not None:
            self._run_callback(fn, self._completion)
        else:
            self._callbacks.append(fn)

    def result(self, timeout: Optional[float] = None) -> Any:
        """The step's device result; drives the dispatcher until resolved.
        Raises TicketCancelled / TimeoutError / AllClustersFailed."""
        return self._dispatcher.wait_for(self, timeout).result

    def wait(self, timeout: Optional[float] = None) -> "Completion":
        """Like ``result`` but returns the full Completion record."""
        return self._dispatcher.wait_for(self, timeout)

    # -- dispatcher side -----------------------------------------------
    def _run_callback(self, fn, comp) -> None:
        try:
            fn(comp)
        except Exception as e:      # a raising callback must not lose work
            self.callback_errors.append(e)

    def _resolve(self, comp: "Completion") -> None:
        self._completion = comp
        for fn in self._callbacks:
            self._run_callback(fn, comp)
        self._callbacks.clear()


# Back-compat alias: the queue item now lives with the policies.
_Item = QueueItem


@dataclass
class Completion:
    request_id: int
    cluster: int
    result: Any
    queued_us: int
    service_us: int
    deadline_us: int
    met_deadline: bool
    chunks: int = 1        # steps the item took (1 = atomic)


class Dispatcher:
    """Policy-driven dispatcher over persistent per-cluster runtimes."""

    def __init__(self, runtimes: dict[int, RuntimeProtocol],
                 wcet_us: Optional[dict[int, float]] = None,
                 straggler_factor: float = 4.0,
                 on_failure: Optional[Callable[[int], None]] = None,
                 completion_window: int = 1024,
                 policy: Union[str, SchedPolicy, None] = None,
                 classes: Sequence[ClassSpec] = (),
                 default_wcet_us: float = 1000.0,
                 wcet_sigma: float = 1.0,
                 clock: Optional[Callable[[], int]] = None,
                 preemptive: Optional[bool] = None,
                 telemetry: Optional[TraceCollector] = None,
                 wcet_quantile: Optional[float] = None):
        for rt in runtimes.values():
            _require_runtime(rt)
        self.runtimes = dict(runtimes)
        # ALL queueing/admission decisions live in the policy;
        # ``preemptive`` (chunk-boundary preemption of chunked work) is a
        # policy setting — None keeps the policy's own default/instance
        # configuration
        self.policy: SchedPolicy = make_policy(policy, classes, preemptive)
        for c in self.runtimes:
            self.policy.add_cluster(c)
        self.mailbox = mb.Mailbox(max(runtimes) + 1 if runtimes else 0)
        # FIFO of (item, trigger_us, batch) per cluster — mirrors
        # mailbox.pending. ``batch`` is None for a solo trigger, or a
        # shared {"n", "share_us"} record for every item of one coalesced
        # doorbell (service attribution: the block's wall time is split
        # evenly instead of the first item absorbing it all)
        self._inflight: dict[int, deque] = {c: deque() for c in runtimes}
        # when the cluster's previous step retired — service time under
        # pipelining starts at max(trigger, predecessor retirement), else a
        # step queued behind its in-flight predecessor double-counts the
        # predecessor's execution into its own observed WCET
        self._last_retire_us: dict[int, int] = {}
        # WCET estimate per opcode (µs) — seeded by caller, refined online
        self.wcet_us = dict(wcet_us or {})
        self._observed: dict[int, list[float]] = {}
        # per-CHUNK observations of chunked classes — feeds the collapsed
        # blocking term (one chunk, not one WCET) in admission
        self._observed_chunk: dict[int, list[float]] = {}
        self._chunk_estimate_cache: dict[int, float] = {}
        # unknown-opcode fallback: explicit knob, warned once per opcode
        # (a silent magic constant is how admission lies to you)
        self.default_wcet_us = float(default_wcet_us)
        self.wcet_sigma = float(wcet_sigma)
        # percentile-WCET estimator: when set, observed estimates are the
        # window's q-quantile instead of worst + σ·jitter (soft real-time
        # admission — trade the absolute worst for a stated percentile)
        if wcet_quantile is not None and not 0.0 < wcet_quantile <= 1.0:
            raise ValueError("wcet_quantile must be in (0, 1]")
        self.wcet_quantile = wcet_quantile
        # inflated estimate per opcode, invalidated when a retirement
        # adds an observation — admission sums estimates over whole
        # queues, so recomputing the window statistic per item is O(n·w)
        self._estimate_cache: dict[int, float] = {}
        self._default_warned: set[int] = set()
        self.straggler_factor = straggler_factor
        self.on_failure = on_failure
        self._clock = clock if clock is not None else now_us
        # rolling debug windows — memory stays O(completion_window) no
        # matter how many requests the dispatcher serves
        if completion_window < 1:
            raise ValueError("completion_window must be >= 1")
        self.completion_window = int(completion_window)
        self.completions: deque[Completion] = deque(maxlen=completion_window)
        self.stragglers: deque[tuple[int, int, float]] = deque(
            maxlen=completion_window)
        # exact running counters behind deadline_stats()
        self.rejected = 0
        self.cancelled_total = 0
        self.shed_total = 0
        self.preemptions = 0       # remainders requeued past a chunk
        self.chunks_total = 0      # non-final chunk retirements
        self.doorbells = 0         # coalesced trigger_many calls issued
        self.coalesced_triggers = 0  # items that rode a batched doorbell
        self.chunk_protocol_errors = 0   # chunked work on a runtime
        #                                  whose from_gpu can't say so
        self._n_completed = 0
        self._n_met = 0
        self._n_stragglers = 0
        self._service_sum_us = 0.0
        self._service_worst_us = 0.0
        self._seq = itertools.count()
        # request-class → tuple of clusters: placement picks the least-
        # loaded member of the pinned SET (a 1-tuple is the classic fixed
        # pin). The elastic controller rewrites these as carves shift.
        self._pins: dict[str, tuple[int, ...]] = {}
        # elastic repartition counters (bumped by LkSystem/Elastic-
        # Controller, surfaced in deadline_stats like every other
        # decision counter)
        self.recarves = 0
        self.recarve_rejected = 0
        # clusters draining toward retirement: excluded from auto-placement
        # and replay targeting (explicit cluster= submits still reach them)
        self._draining: set[int] = set()
        # on_failure callbacks that raised: drain()/wait_for() absorb the
        # deferred exception to keep retiring work, so the error is kept
        # here for the operator (pump() callers still see it re-raised)
        self.failure_callback_errors: list[BaseException] = []
        # telemetry: structured event timeline + latency histograms +
        # runtime verification; every emission is gated on attachment so
        # an untraced dispatcher pays nothing
        self.telemetry: Optional[TraceCollector] = None
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    # ------------------------------------------------------------------
    @property
    def queues(self) -> dict[int, list[QueueItem]]:
        """Per-cluster snapshots of live queued items (compat view; the
        authoritative queues live inside ``self.policy``)."""
        return {c: self.policy.live_items(c) for c in self.runtimes}

    def set_class(self, spec: ClassSpec) -> None:
        """Declare one opcode's scheduling parameters (priority, budget,
        criticality) to the active policy."""
        self.policy.set_class(spec)
        if self.telemetry is not None:
            self.telemetry.set_name(spec.opcode, spec.name)

    # ------------------------------------------------------------------
    def attach_telemetry(self, telemetry: TraceCollector) -> None:
        """Attach a trace collector: events, histograms, and the
        runtime-verification monitor all flow into it from here on, and
        the dispatcher's counters join its unified ``counters()``
        surface. One collector per dispatcher (idempotent re-attach)."""
        if self.telemetry is telemetry:
            return
        if self.telemetry is not None:
            raise RuntimeError("a TraceCollector is already attached")
        self.telemetry = telemetry
        telemetry.register_source("dispatcher", self._counter_snapshot)
        for spec in self.policy.specs():
            telemetry.set_name(spec.opcode, spec.name)

    def _staged_counters(self) -> tuple[int, int]:
        """(hits, misses) of the registered runtimes' next-chunk double
        buffers — how often a mid-item re-trigger was served device-side
        vs forced back onto a fresh host transfer. Runtimes without a
        staging buffer (test doubles, MegaRuntime) contribute zeros."""
        hits = misses = 0
        for rt in self.runtimes.values():
            hits += getattr(rt, "staged_hits", 0)
            misses += getattr(rt, "staged_misses", 0)
        return hits, misses

    def _counter_snapshot(self) -> dict:
        """The dispatcher's scattered warn-once/error counters as one
        dict — the ``counters()`` source (and the audit surface: every
        counter here also appears in ``deadline_stats()``)."""
        staged_hits, staged_misses = self._staged_counters()
        return {
            "completed": self._n_completed,
            "met": self._n_met,
            "rejected": self.rejected,
            "cancelled": self.cancelled_total,
            "shed": self.shed_total,
            "preemptions": self.preemptions,
            "chunks": self.chunks_total,
            "doorbells": self.doorbells,
            "coalesced_triggers": self.coalesced_triggers,
            "staged_hits": staged_hits,
            "staged_misses": staged_misses,
            "stragglers": self._n_stragglers,
            "ack_mismatches": self.mailbox.ack_mismatches,
            "chunk_protocol_errors": self.chunk_protocol_errors,
            "failure_callback_errors": len(self.failure_callback_errors),
            "recarves": self.recarves,
            "recarve_rejected": self.recarve_rejected,
        }

    def counters(self) -> dict:
        """Unified counter surface: with telemetry attached, the
        collector's merged view (events + monitor + every registered
        source); without, this dispatcher's own snapshot."""
        if self.telemetry is not None:
            return self.telemetry.counters()
        return {f"dispatcher.{k}": v
                for k, v in self._counter_snapshot().items()}

    def register(self, cluster: int, runtime: RuntimeProtocol) -> None:
        """Attach a runtime as a new cluster (shared-dispatcher clients)."""
        if cluster in self.runtimes:
            raise KeyError(f"cluster {cluster} already registered")
        _require_runtime(runtime)
        self.runtimes[cluster] = runtime
        self.policy.add_cluster(cluster)
        self._inflight[cluster] = deque()
        self._draining.discard(cluster)       # a reused id starts fresh
        self.mailbox.grow(cluster + 1)

    def unregister(self, cluster: int) -> None:
        """Detach an idle cluster (e.g. its engine is disposing). Refuses
        while the cluster still holds queued or in-flight work."""
        if cluster not in self.runtimes:
            raise KeyError(cluster)
        if self.queue_depth(cluster) or self._inflight[cluster]:
            raise RuntimeError(
                f"cluster {cluster} still has queued/in-flight work")
        del self.runtimes[cluster]
        self.policy.drop_cluster(cluster)   # tombstones go with it
        del self._inflight[cluster]
        self._last_retire_us.pop(cluster, None)
        self._draining.discard(cluster)
        self.mailbox.clear(cluster)

    def pin(self, request_class: str, cluster) -> None:
        """Pin a request class to one cluster (int) or a SET of clusters
        (any iterable of ints): auto-placement for the class picks the
        least-loaded member of the set. An empty iterable unpins."""
        if isinstance(cluster, int):
            self._pins[request_class] = (cluster,)
            return
        members = tuple(dict.fromkeys(int(c) for c in cluster))
        if not members:
            self._pins.pop(request_class, None)
        else:
            self._pins[request_class] = members

    def pins(self) -> dict[str, tuple[int, ...]]:
        """Snapshot of the current class → cluster-set pin map."""
        return dict(self._pins)

    def quiesce(self, cluster: int) -> None:
        """Stop routing NEW work to a cluster (lame-duck retirement): it
        is excluded from least-loaded auto-placement and from failure
        replay, so its backlog can actually drain. Explicit ``cluster=``
        submissions still reach it."""
        if cluster not in self.runtimes:
            raise KeyError(cluster)
        self._draining.add(cluster)

    def resume(self, cluster: int) -> None:
        self._draining.discard(cluster)

    def _placement_pool(self) -> list[int]:
        """Clusters eligible for auto-placement/replay; falls back to all
        registered clusters when everything is draining."""
        pool = [c for c in self.runtimes if c not in self._draining]
        return pool or list(self.runtimes)

    def _note_cancelled(self, ticket: Ticket) -> None:
        """Forward a cancelled-but-still-enqueued tombstone to the policy
        so queue_depth, least-loaded placement, and admission exclude it
        without paying a heap rebuild per cancellation (mass-cancel storms
        stay O(1) each; the item itself is discarded when it surfaces)."""
        if ticket.cluster in self.runtimes:
            self.policy.note_cancelled(ticket.cluster, ticket)
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_CANCEL, t_us=self._clock(), cluster=ticket.cluster,
                request_id=ticket.request_id, opcode=ticket.desc.opcode)
            self.telemetry.monitor.note_withdrawn(ticket.request_id)

    def _inflated_estimate(self, opcode: int, obs_map: dict,
                           cache: dict) -> Optional[float]:
        """Memoized estimate over one observation stream (whole-item or
        per-chunk): ``worst + wcet_sigma·σ`` by default, or the window's
        ``wcet_quantile`` percentile when that estimator is selected;
        None when nothing was observed yet."""
        obs = obs_map.get(opcode)
        if not obs:
            return None
        cached = cache.get(opcode)
        if cached is None:
            if self.wcet_quantile is not None:
                cached = sched_admission.quantile_wcet(
                    obs, self.wcet_quantile)
            else:
                cached = sched_admission.inflated_wcet(obs, self.wcet_sigma)
            cache[opcode] = cached
        return cached

    @staticmethod
    def _observe(obs_map: dict, cache: dict, opcode: int,
                 service_us: float) -> list:
        """Record one observation into a stream (bounded window) and
        invalidate its memoized estimate; returns the window."""
        obs = obs_map.setdefault(opcode, [])
        obs.append(service_us)
        if len(obs) > 256:
            del obs[0]
        cache.pop(opcode, None)
        return obs

    def _estimate_us(self, opcode: int) -> float:
        """Worst-case service estimate: observed worst inflated by
        ``wcet_sigma`` standard deviations of observed jitter; falls back
        to the seeded value, then to ``default_wcet_us`` (warned once)."""
        est = self._inflated_estimate(opcode, self._observed,
                                      self._estimate_cache)
        if est is not None:
            return est
        if opcode in self.wcet_us:
            return float(self.wcet_us[opcode])
        if opcode not in self._default_warned:
            self._default_warned.add(opcode)
            warnings.warn(
                f"no WCET estimate for opcode {opcode}: admission falls "
                f"back to default_wcet_us={self.default_wcet_us:.0f}µs — "
                "seed wcet_us or let the dispatcher observe this class",
                RuntimeWarning, stacklevel=3)
        return self.default_wcet_us

    def _chunk_estimate_us(self, opcode: int) -> float:
        """Worst-case length of ONE chunk of an opcode: the class's
        declared ``chunk_us`` wins, else the jitter-inflated observed
        per-chunk worst, else the full item estimate (atomic classes —
        their "chunk" IS the whole item)."""
        spec = self.policy.spec(opcode)
        if spec is not None and spec.chunk_us is not None:
            return float(spec.chunk_us)
        est = self._inflated_estimate(opcode, self._observed_chunk,
                                      self._chunk_estimate_cache)
        return est if est is not None else self._estimate_us(opcode)

    def _load(self, cluster: int) -> int:
        return self.queue_depth(cluster) + len(self._inflight[cluster])

    def inflight_depth(self, cluster: int) -> int:
        return len(self._inflight.get(cluster, ()))

    def queue_depth(self, cluster: int) -> int:
        """LIVE queued items (cancelled tombstones excluded)."""
        return self.policy.depth(cluster)

    @property
    def busy(self) -> bool:
        return any(self.policy.has_queued(c) for c in self.runtimes) \
            or any(self._inflight.values())

    # ------------------------------------------------------------------
    def submit(self, desc: mb.WorkDescriptor, cluster: Optional[int] = None,
               request_class: Optional[str] = None,
               admission: bool = True) -> Ticket:
        """Policy-enqueue; returns a Ticket future resolved at retirement.
        Raises AdmissionError when the deadline cannot be met under
        worst-case estimates AND criticality shedding cannot make room."""
        if cluster is None and request_class is not None:
            pinned = self._pins.get(request_class)
            if pinned is not None:
                # least-loaded member of the pinned set that is still
                # registered and not draining (a mid-recarve pin may
                # briefly name a lame-duck or departed cluster)
                pool = [c for c in pinned if c in self.runtimes
                        and c not in self._draining] or \
                       [c for c in pinned if c in self.runtimes]
                if pool:
                    cluster = min(pool, key=self._load)
        if cluster is None:
            cluster = min(self._placement_pool(), key=self._load)
        if cluster not in self.runtimes:
            raise KeyError(cluster)

        admitted = False
        if admission and desc.deadline_us:
            try:
                self._admit(cluster, desc)
                admitted = True
            except AdmissionError as e:
                if not self._shed_to_admit(cluster, desc):
                    self.rejected += 1
                    if self.telemetry is not None:
                        self.telemetry.emit(
                            EV_REJECT, t_us=self._clock(), cluster=cluster,
                            request_id=desc.request_id, opcode=desc.opcode,
                            test=e.test, term=e.term, bound=e.bound)
                    raise
                admitted = True
        ticket = Ticket(self, desc, cluster)
        spec = self.policy.spec(desc.opcode)
        ticket.priority = self.policy.priority_of(desc.opcode)
        ticket.server = spec.name if spec is not None \
            and spec.budget_us is not None else None
        item = QueueItem(deadline_us=desc.effective_deadline_us,
                         seq=next(self._seq), desc=desc,
                         submitted_us=self._clock(), ticket=ticket)
        self.policy.enqueue(cluster, item)
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_SUBMIT, t_us=item.submitted_us, cluster=cluster,
                request_id=desc.request_id, opcode=desc.opcode,
                chunk=desc.chunk, deadline_us=desc.deadline_us,
                n_chunks=desc.n_chunks, admitted=admitted)
            if admitted:
                self.telemetry.emit(
                    EV_ADMIT, t_us=item.submitted_us, cluster=cluster,
                    request_id=desc.request_id, opcode=desc.opcode,
                    deadline_us=desc.deadline_us)
            # the monitor's promise record: an admitted item's response
            # time is BOUND by its deadline (every analysis passes only
            # when R ≤ D); est is what admission charged — already
            # computed inside _admit, so re-reading it triggers no
            # default-WCET warning
            self.telemetry.monitor.note_submit(
                request_id=desc.request_id, opcode=desc.opcode,
                deadline_us=desc.deadline_us, admitted=admitted,
                est_us=self._estimate_us(desc.opcode) if admitted else None,
                t_us=item.submitted_us)
        return ticket

    def _admit(self, cluster: int, desc: mb.WorkDescriptor,
               ignore: Sequence[QueueItem] = ()) -> None:
        self.policy.admit(
            cluster, desc, estimate=self._estimate_us,
            inflight=[it.desc for it, _t, _b in self._inflight[cluster]],
            now_us=self._clock(), ignore=ignore,
            chunk_estimate=self._chunk_estimate_us)

    def _shed_to_admit(self, cluster: int, desc: mb.WorkDescriptor) -> bool:
        """Overload shedding: try to admit a HIGHER-criticality item by
        cancelling queued LOWER-criticality work on the same cluster.
        Dry-runs admission with candidates ignored (lowest criticality,
        latest deadline first) and only cancels — through the normal
        ticket ``cancel()`` path — once a sufficient prefix is found, so a
        hopeless admission never destroys queued work. Deadline-free
        items are never victims: they contribute nothing to any
        deadline's demand term, and callers blocking on them (e.g. a
        serving engine's insert handoff) must not lose work to a tenant's
        deadline."""
        my_rank = crit_rank(self.policy.criticality_of(desc.opcode))
        cands = [it for it in self.policy.live_items(cluster)
                 if it.ticket is not None and not it.ticket._triggered
                 and it.deadline_us != NO_DEADLINE
                 and crit_rank(self.policy.criticality_of(it.desc.opcode))
                 < my_rank]
        if not cands:
            return False
        cands.sort(key=lambda it: (
            crit_rank(self.policy.criticality_of(it.desc.opcode)),
            -it.deadline_us))
        shed: list[QueueItem] = []
        for it in cands:
            shed.append(it)
            try:
                self._admit(cluster, desc, ignore=shed)
            except AdmissionError:
                continue
            # prune victims the admission doesn't actually need (e.g. a
            # far-deadline item outside the failing demand window) — only
            # work whose cancellation changes the verdict may be destroyed
            for victim in list(shed):
                trial = [v for v in shed if v is not victim]
                try:
                    self._admit(cluster, desc, ignore=trial)
                except AdmissionError:
                    continue
                shed = trial
            for victim in shed:       # dry run passed: cancel for real
                victim.ticket.cancel()
                if self.telemetry is not None:
                    self.telemetry.emit(
                        EV_SHED, t_us=self._clock(), cluster=cluster,
                        request_id=victim.desc.request_id,
                        opcode=victim.desc.opcode,
                        for_request=desc.request_id)
            self.shed_total += len(shed)
            return True
        return False

    # ------------------------------------------------------------------
    # pipeline internals: trigger / retire / fail
    # ------------------------------------------------------------------
    def _trigger_next(self, cluster: int) -> bool:
        """Trigger the policy's next eligible item if the cluster has
        pipeline capacity. Returns True when a trigger happened (False
        when the queue is empty, the pipeline is full, or everything
        queued is budget-deferred). On trigger failure the cluster is
        retired and its work replayed (re-raises)."""
        rt = self.runtimes[cluster]
        if not self.policy.has_queued(cluster):
            return False
        if len(self._inflight[cluster]) >= rt.max_inflight:
            return False
        item = self.policy.pop_next(cluster, self._clock())
        if item is None:
            return False              # deferred: budget exhausted
        self._trigger_item(cluster, item)
        return True

    def _trigger_item(self, cluster: int, item: QueueItem) -> None:
        """Post + trigger one (possibly mid-item) chunk descriptor. On
        trigger failure the cluster is retired and its work — this item
        included, with its ticket attached — replayed (re-raises)."""
        rt = self.runtimes[cluster]
        t = item.ticket
        if t is not None:
            t._triggered = True
        self.mailbox.post(cluster, item.desc.encode())
        # stamp BEFORE the trigger call: on synchronous backends the
        # compute runs inside trigger(), and the stamp is what service /
        # budget accounting measures cluster occupancy from — stamping
        # after would hide that work from WCET and bandwidth servers
        t_trig = self._clock()
        try:
            rt.trigger(item.desc)
        except Exception:
            # the descriptor is already in the mailbox record: append
            # the item so the replay keeps its ticket attached
            self._inflight[cluster].append((item, t_trig, None))
            self._fail_cluster(cluster)
            raise
        self._inflight[cluster].append((item, t_trig, None))
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_TRIGGER, t_us=t_trig, cluster=cluster,
                request_id=item.desc.request_id, opcode=item.desc.opcode,
                chunk=item.desc.chunk)
        assert self.mailbox.depth(cluster) == \
            len(self._inflight[cluster]), \
            "mailbox / dispatcher in-flight records desynced"

    def _trigger_batch(self, cluster: int, items: list) -> None:
        """Coalesce a kick pass's same-cluster triggers into ONE batched
        doorbell (``rt.trigger_many``): one mailbox record pass, one
        device transfer, one compiled multi-step call. Retirement stays
        per item; the shared ``batch`` record splits the block's wall
        time evenly across its items at retire time. On trigger failure
        every item is appended to the in-flight record first, so the
        replay keeps all tickets attached (re-raises)."""
        rt = self.runtimes[cluster]
        for item in items:
            if item.ticket is not None:
                item.ticket._triggered = True
        self.mailbox.post_many(cluster, [it.desc for it in items])
        batch = {"n": len(items), "share_us": None}
        t_trig = self._clock()
        try:
            rt.trigger_many([it.desc for it in items])
        except Exception:
            for item in items:
                self._inflight[cluster].append((item, t_trig, batch))
            self._fail_cluster(cluster)
            raise
        for item in items:
            self._inflight[cluster].append((item, t_trig, batch))
        self.doorbells += 1
        self.coalesced_triggers += len(items)
        if self.telemetry is not None:
            for item in items:
                self.telemetry.emit(
                    EV_TRIGGER, t_us=t_trig, cluster=cluster,
                    request_id=item.desc.request_id,
                    opcode=item.desc.opcode, chunk=item.desc.chunk,
                    batch=len(items))
        assert self.mailbox.depth(cluster) == \
            len(self._inflight[cluster]), \
            "mailbox / dispatcher in-flight records desynced"

    def _step_done(self, item: QueueItem, from_gpu) -> bool:
        """Did this step FINISH its item? Atomic items and final chunks
        are always done (the host caps runaway chunk counts); a mid-item
        chunk reports ``THREAD_PREEMPTED`` from the device, but a chunk
        fn may also finish early by returning done=True. A runtime whose
        from_gpu cannot carry the chunk protocol is counted and warned
        (once) — its chunked items resolve after one step, which would
        otherwise be silent wrong output."""
        desc = item.desc
        if not desc.chunked or desc.chunk + 1 >= desc.n_chunks:
            return True
        try:
            return int(np.asarray(from_gpu)[mb.W_STATUS]) != \
                mb.THREAD_PREEMPTED
        except (TypeError, ValueError, IndexError):
            self.chunk_protocol_errors += 1
            if self.chunk_protocol_errors == 1:
                warnings.warn(
                    "runtime returned a from_gpu without chunk-protocol "
                    "statuses for a chunked item: treating the step as "
                    "done — remaining chunks will NOT run (submit "
                    "n_chunks=1 to such runtimes)", RuntimeWarning,
                    stacklevel=3)
            return True

    def _retire(self, cluster: int) -> Optional[Completion]:
        """Block on the cluster's OLDEST in-flight step; observe WCET,
        flag stragglers, ack the mailbox, charge the policy. A finished
        ITEM resolves its ticket and returns its Completion. A finished
        mid-item CHUNK returns None — this is the PREEMPTION POINT: the
        remainder either requeues through the normal lane (when the
        policy's ``should_preempt`` sees a more urgent head) or triggers
        again immediately. On wait failure the cluster is retired and
        queued + in-flight work replayed (re-raises)."""
        assert self.mailbox.depth(cluster) == len(self._inflight[cluster]), \
            "mailbox / dispatcher in-flight records desynced"
        item, t0, batch = self._inflight[cluster][0]
        rt = self.runtimes[cluster]
        try:
            result, from_gpu = rt.wait()
        except Exception:
            self._fail_cluster(cluster)
            raise
        self._inflight[cluster].popleft()
        done = self._step_done(item, from_gpu)
        self.mailbox.ack(
            cluster, mb.THREAD_FINISHED if done else mb.THREAD_PREEMPTED,
            item.desc.request_id, chunk=item.desc.chunk)
        start = max(t0, self._last_retire_us.get(cluster, 0))
        end = self._clock()
        self._last_retire_us[cluster] = end
        service = end - start
        if batch is not None and batch["n"] > 1:
            # one doorbell ran the whole block: split its wall time evenly
            # across the items instead of letting the first retirement
            # absorb the block's service into one item's observed WCET
            if batch["share_us"] is None:
                batch["share_us"] = service / batch["n"]
            service = batch["share_us"]
        if item.started_us is None:
            item.started_us = start
        item.service_accum_us += service
        chunked = item.desc.chunked
        # chunked steps feed the per-CHUNK observation stream (admission's
        # blocking term); whole-item WCET is observed at the final chunk
        # from the accumulated service
        if chunked:
            obs = self._observe(self._observed_chunk,
                                self._chunk_estimate_cache,
                                item.desc.opcode, service)
        else:
            obs = self._observe(self._observed, self._estimate_cache,
                                item.desc.opcode, service)
        avg = float(np.mean(obs))
        if len(obs) >= 8 and service > self.straggler_factor * avg:
            self.stragglers.append((cluster, item.desc.request_id, service))
            self._n_stragglers += 1
        self.policy.on_retire(cluster, item, service, end)
        if not done:
            self.chunks_total += 1
            if self.telemetry is not None:
                self.telemetry.emit(
                    EV_CHUNK_RETIRE, t_us=end, cluster=cluster,
                    request_id=item.desc.request_id,
                    opcode=item.desc.opcode, chunk=item.desc.chunk,
                    start_us=start, dur_us=service)
                self.telemetry.observe("chunk_us", item.desc.opcode,
                                       service)
            remainder = QueueItem(
                deadline_us=item.deadline_us, seq=item.seq,
                desc=item.desc.advance(), submitted_us=item.submitted_us,
                ticket=item.ticket, started_us=item.started_us,
                service_accum_us=item.service_accum_us)
            if self.policy.should_preempt(cluster, remainder, end):
                # a more urgent head is waiting: the remainder goes back
                # through the normal lane (same seq → it resumes exactly
                # where the running item stood once the urgent work ran)
                self.preemptions += 1
                self.policy.enqueue(cluster, remainder)
                if self.telemetry is not None:
                    self.telemetry.emit(
                        EV_PREEMPT, t_us=end, cluster=cluster,
                        request_id=item.desc.request_id,
                        opcode=item.desc.opcode,
                        chunk=remainder.desc.chunk)
            else:
                self._trigger_item(cluster, remainder)
            return None
        if chunked:
            self._observe(self._observed, self._estimate_cache,
                          item.desc.opcode, item.service_accum_us)
        comp = Completion(
            request_id=item.desc.request_id, cluster=cluster, result=result,
            queued_us=item.started_us - item.submitted_us,
            service_us=item.service_accum_us,
            deadline_us=item.desc.deadline_us,
            met_deadline=(not item.desc.deadline_us
                          or end <= item.desc.deadline_us),
            chunks=item.desc.chunk + 1)
        self.completions.append(comp)
        self._n_completed += 1
        self._n_met += int(comp.met_deadline)
        self._service_sum_us += item.service_accum_us
        self._service_worst_us = max(self._service_worst_us,
                                     item.service_accum_us)
        if self.telemetry is not None:
            op = item.desc.opcode
            self.telemetry.emit(
                EV_RESOLVE, t_us=end, cluster=cluster,
                request_id=comp.request_id, opcode=op,
                chunk=item.desc.chunk, start_us=start, dur_us=service,
                met_deadline=comp.met_deadline, chunks=comp.chunks,
                service_us=comp.service_us, queued_us=comp.queued_us)
            # the three distribution views of one completion: device
            # occupancy, queueing delay, and end-to-end response
            self.telemetry.observe("service_us", op, item.service_accum_us)
            self.telemetry.observe("queue_us", op, comp.queued_us)
            self.telemetry.observe("response_us", op,
                                   end - item.submitted_us)
            self.telemetry.monitor.note_resolve(
                request_id=comp.request_id, opcode=op, cluster=cluster,
                end_us=end, deadline_us=item.desc.deadline_us,
                service_us=item.service_accum_us)
        if item.ticket is not None:
            item.ticket._resolve(comp)
        return comp

    def _fail_cluster(self, cluster: int) -> None:
        """Retire a failed cluster and replay its queued AND in-flight work
        on the survivors. The mailbox's in-flight record is the replay
        source for mid-flight descriptors — they are pure functions of
        request state, so replay is idempotent. ``on_failure`` fires BEFORE
        the replay so a self-healing callback (LkSystem) can register
        replacement clusters that the replay immediately lands on; a
        raising callback is deferred — its exception only propagates after
        the replay landed, so no work is lost either way."""
        inflight_descs = self.mailbox.pending(cluster)
        inflight_meta = list(self._inflight.pop(cluster, ()))
        queued = self.policy.drop_cluster(cluster)
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_FAIL, t_us=self._clock(), cluster=cluster,
                queued=len(queued), inflight=len(inflight_descs))
        del self.runtimes[cluster]
        self._last_retire_us.pop(cluster, None)
        self._draining.discard(cluster)
        self.mailbox.clear(cluster)
        cb_exc: Optional[BaseException] = None
        if self.on_failure:
            try:
                self.on_failure(cluster)
            except Exception as e:
                cb_exc = e
                self.failure_callback_errors.append(e)
        if not self.runtimes:
            raise AllClustersFailed("all clusters failed") from cb_exc
        replay = []
        for i, desc in enumerate(inflight_descs):
            meta = inflight_meta[i][0] if i < len(inflight_meta) else None
            sub = meta.submitted_us if meta is not None else self._clock()
            ticket = meta.ticket if meta is not None else None
            if ticket is not None and desc.chunk == 0:
                # queued again → cancellable; mid-item remainders keep
                # _triggered (the invariant "partial work is never
                # cancelled" holds through replay too)
                ticket._triggered = False
            # a chunked in-flight desc IS the remainder: completed chunks
            # never re-run, only the current chunk onward replays (the
            # accumulated service travels with it)
            replay.append(QueueItem(
                deadline_us=desc.effective_deadline_us,
                seq=next(self._seq), desc=desc, submitted_us=sub,
                ticket=ticket,
                started_us=meta.started_us if meta is not None else None,
                service_accum_us=meta.service_accum_us
                if meta is not None else 0.0))
        replay.extend(queued)
        for it in replay:
            if it.ticket is not None and it.ticket.cancelled():
                continue
            tgt = min(self._placement_pool(), key=self._load)
            self.policy.enqueue(tgt, it)
            if it.ticket is not None:
                it.ticket.cluster = tgt
            if self.telemetry is not None:
                self.telemetry.emit(
                    EV_REQUEUE, t_us=self._clock(), cluster=tgt,
                    request_id=it.desc.request_id, opcode=it.desc.opcode,
                    chunk=it.desc.chunk, from_cluster=cluster)
        if cb_exc is not None:
            raise cb_exc

    # ------------------------------------------------------------------
    def kick(self, cluster: int) -> int:
        """Trigger queued work up to the cluster's pipeline capacity without
        waiting. Returns the number of steps entered into flight.

        When the runtime supports batched doorbells (``trigger_many``),
        every eligible item of this pass is coalesced into ONE doorbell;
        runtimes without it (test doubles, legacy) get per-item triggers.
        Coalescing happens at kick granularity, so each pump pass stays a
        preemption opportunity: work submitted after this pass can still
        beat the NEXT pass's batch."""
        rt = self.runtimes[cluster]
        if getattr(rt, "trigger_many", None) is None:
            n = 0
            while self._trigger_next(cluster):
                n += 1
            return n
        items = []
        while self.policy.has_queued(cluster) and \
                len(self._inflight[cluster]) + len(items) < rt.max_inflight:
            item = self.policy.pop_next(cluster, self._clock())
            if item is None:
                break              # deferred: budget exhausted
            items.append(item)
        if not items:
            return 0
        if len(items) == 1:
            self._trigger_item(cluster, items[0])
        else:
            self._trigger_batch(cluster, items)
        return len(items)

    def poll(self) -> list[Completion]:
        """Retire every already-completed in-flight step (non-blocking).
        Mid-item chunk retirements progress the pump but produce no
        Completion (the item is still running)."""
        done = []
        progressed = True
        while progressed:
            progressed = False
            for c in list(self.runtimes):
                if self._inflight.get(c) and self.runtimes[c].ready():
                    comp = self._retire(c)
                    if comp is not None:
                        done.append(comp)
                    progressed = True
        return done

    def wait_any(self) -> Optional[Completion]:
        """Retire ONE completion: any already-finished step if available,
        else block on the cluster with the oldest in-flight trigger.
        Returns None when nothing is in flight.

        With in-flight work on MORE than one cluster, committing a
        blocking wait to the oldest trigger gambles on finish order — so
        the pump first polls ``ready()`` across clusters under an
        exponential-backoff sleep (20µs → 2ms, bounded ~50ms) instead of
        burning host CPU in a tight re-poll or blocking on the wrong
        cluster. The bounded budget guarantees the blocking fallback is
        reached even against runtimes whose ``ready()`` never fires."""
        for c in list(self.runtimes):
            if self._inflight.get(c) and self.runtimes[c].ready():
                return self._retire(c)
        cands = [(infl[0][1], c) for c, infl in self._inflight.items()
                 if infl]
        if not cands:
            return None
        if len(cands) > 1:
            delay, budget = 20e-6, 0.05
            while budget > 0:
                time.sleep(delay)
                budget -= delay
                delay = min(delay * 2, 2e-3)
                for c in list(self.runtimes):
                    if self._inflight.get(c) and self.runtimes[c].ready():
                        return self._retire(c)
        _, c = min(cands)
        return self._retire(c)

    def _sleep_until_eligible(self) -> None:
        """Nothing in flight and nothing triggerable, but queues hold
        budget-DEFERRED work: sleep toward the earliest replenishment.
        With an injected clock, real sleeping can never make the deferred
        work eligible — raise instead of livelocking the pump."""
        now = self._clock()
        nxts = [t for c in list(self.runtimes)
                for t in (self.policy.next_eligible_us(c, now),)
                if t is not None]
        if not nxts:
            return
        if self._clock is not now_us:
            raise RuntimeError(
                "budget-deferred work cannot progress: the injected clock "
                f"never advances past {min(nxts)} inside the pump — "
                "advance it between pumps, or use a work-conserving "
                "server policy")
        time.sleep(min(max((min(nxts) - now) / 1e6, 0.0), 0.005))

    def _pump_once(self) -> tuple[int, Optional[Completion]]:
        """One event-pump round: fill every cluster's pipeline, retire one
        completion. Cluster failures are absorbed (their work is already
        replayed by ``_fail_cluster``); ``AllClustersFailed`` propagates.
        Returns (steps entered into flight, retired completion or None)."""
        progressed = 0
        for c in list(self.runtimes):
            try:
                progressed += self.kick(c)
            except AllClustersFailed:
                raise
            except Exception:
                progressed += 1   # cluster retired; work already replayed
        chunks_before = self.chunks_total
        try:
            comp = self.wait_any()
        except AllClustersFailed:
            raise
        except Exception:
            return progressed, None  # cluster retired; work replayed
        # a retired mid-item CHUNK yields no Completion but IS progress
        # (its remainder was re-triggered or requeued) — without counting
        # it the pump would mistake a preemption for an idle round and
        # sleep toward a budget replenishment that the next kick makes
        # irrelevant
        if comp is None and not progressed \
                and self.chunks_total == chunks_before \
                and not any(self._inflight.values()):
            self._sleep_until_eligible()
        return progressed, comp

    def wait_for(self, ticket: Ticket,
                 timeout: Optional[float] = None) -> Completion:
        """Drive the dispatcher (fill pipelines, retire completions) until
        ``ticket`` resolves; returns its Completion. Other tickets retired
        along the way resolve too — this is the single-host-thread event
        pump. The timeout is checked between retirements (a step already
        blocking on device is not interrupted)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ticket._completion is not None:
                return ticket._completion
            if ticket._cancelled:
                raise TicketCancelled(
                    f"request {ticket.request_id} was cancelled")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"request {ticket.request_id} unresolved after "
                    f"{timeout}s")
            progressed, comp = self._pump_once()
            if comp is None and not progressed and not self.busy \
                    and ticket._completion is None and not ticket._cancelled:
                raise RuntimeError(
                    f"request {ticket.request_id} cannot resolve: "
                    "dispatcher is idle and the ticket is not queued")

    def pump(self, cluster: int) -> Optional[Completion]:
        """Synchronous single step on `cluster`: trigger the next eligible
        item (if any), then retire its oldest in-flight step."""
        if cluster not in self.runtimes:
            raise KeyError(cluster)
        triggered = self._trigger_next(cluster)
        if self._inflight[cluster]:
            return self._retire(cluster)
        if not triggered:
            self._sleep_until_eligible()   # budget-deferred backlog
        return None

    def drain(self) -> list[Completion]:
        """Event loop until all queues and pipelines are empty: fill every
        cluster's pipeline, retire one completion, refill. Mid-flight
        cluster failures are absorbed — their work replays on survivors —
        unless every cluster is gone. Budget-deferred work is waited out
        (the pump sleeps toward the next replenishment)."""
        done = []
        while self.busy:
            _, comp = self._pump_once()
            if comp is not None:
                done.append(comp)
        return done

    # ------------------------------------------------------------------
    def deadline_stats(self) -> dict:
        """Exact lifetime statistics from running counters — NOT limited
        to the rolling ``completions`` window. The key set is stable from
        construction (idle dispatchers report zeros)."""
        staged_hits, staged_misses = self._staged_counters()
        return {
            "n": self._n_completed,
            "met": self._n_met,
            "rejected": self.rejected,
            "cancelled": self.cancelled_total,
            "shed": self.shed_total,
            "preemptions": self.preemptions,
            "chunks": self.chunks_total,
            "doorbells": self.doorbells,
            "coalesced_triggers": self.coalesced_triggers,
            # next-chunk double-buffer effectiveness across live runtimes
            "staged_hits": staged_hits,
            "staged_misses": staged_misses,
            "policy": self.policy.name,
            "avg_service_us": (self._service_sum_us / self._n_completed
                               if self._n_completed else 0.0),
            "worst_service_us": self._service_worst_us,
            "stragglers": self._n_stragglers,
            "window": len(self.completions),
            "failure_callback_errors": len(self.failure_callback_errors),
            # previously only greppable from logs / buried attributes:
            # protocol discrepancies the operator must see in one place
            "ack_mismatches": self.mailbox.ack_mismatches,
            "chunk_protocol_errors": self.chunk_protocol_errors,
            # elastic repartition outcomes (applied / refused-by-admission)
            "recarves": self.recarves,
            "recarve_rejected": self.recarve_rejected,
        }
