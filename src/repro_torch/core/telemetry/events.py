"""Structured event timeline: the TraceCollector.

One bounded ring buffer of :class:`Event` records is the subsystem's
spine. The dispatcher, the persistent runtimes, the serving engine, and
``LkSystem``'s heal loop all emit into the same collector, each event
stamped with monotonic microseconds and the ticket/opcode/cluster/chunk
ids that let exporters reconstruct per-ticket execution spans (a chunked
item's timeline is its ``chunk_retire`` events; a preemption is a more
urgent ``trigger`` landing between two of them).

The collector also owns:

* per-opcode log-spaced latency histograms (``observe``/``quantiles`` —
  service, queueing, and response distributions with p50/p95/p99/worst);
* the :class:`~repro_torch.core.telemetry.monitor.BoundMonitor` that replays
  completions against the admission analyses' response-time bounds;
* the unified ``counters()`` surface: per-kind event counts plus every
  registered component's counter snapshot (the dispatcher registers its
  previously scattered ``ack_mismatches`` / ``chunk_protocol_errors`` /
  ``preemptions`` / ``shed`` / … here), one flat dict behind one call.

Memory is bounded everywhere: the ring drops oldest events (counted on
``dropped_events`` — exact counters never lose anything), histograms are
O(log range), the monitor ledger is a deque.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.telemetry.histogram import LogHistogram
from repro_torch.core.telemetry.monitor import BoundMonitor

__all__ = ["Event", "TraceCollector", "EVENT_KINDS",
           "EV_SUBMIT", "EV_ADMIT", "EV_REJECT", "EV_SHED", "EV_TRIGGER",
           "EV_CHUNK_RETIRE", "EV_PREEMPT", "EV_REQUEUE", "EV_RESOLVE",
           "EV_CANCEL", "EV_FAIL", "EV_HEAL", "EV_RECARVE",
           "EV_RT_TRIGGER", "EV_RT_RETIRE", "EV_ENGINE", "EV_STREAM"]

# -- event kinds (the wire vocabulary of the timeline) ---------------------
EV_SUBMIT = "submit"            # a descriptor entered a policy queue
EV_ADMIT = "admit"              # an admission analysis PASSED for it
EV_REJECT = "reject"            # admission failed and shedding couldn't help
EV_SHED = "shed"                # a queued victim cancelled to admit another
EV_TRIGGER = "trigger"          # one (possibly mid-item) chunk entered flight
EV_CHUNK_RETIRE = "chunk_retire"  # a non-final chunk retired (span)
EV_PREEMPT = "preempt"          # a remainder requeued past a more urgent head
EV_REQUEUE = "requeue"          # failure replay re-enqueued an item
EV_RESOLVE = "resolve"          # final chunk retired; ticket resolved (span)
EV_CANCEL = "cancel"            # a queued ticket was withdrawn
EV_FAIL = "fail"                # a cluster died
EV_HEAL = "heal"                # LkSystem rebuilt capacity after a failure
EV_RECARVE = "recarve"          # elastic repartition: proposed carve applied
#                                 (or rejected=True when the admission
#                                 re-check refused it)
EV_RT_TRIGGER = "rt_trigger"    # runtime-level: step enqueued (depth sample)
EV_RT_RETIRE = "rt_retire"      # runtime-level: oldest step retired
EV_ENGINE = "engine"            # serving-engine lifecycle (add_request, …)
EV_STREAM = "stream"            # request-stream lifecycle (open/slot-bind/
#                                 prefill-chunk/first-token/decode/shed/close)

EVENT_KINDS = (
    EV_SUBMIT, EV_ADMIT, EV_REJECT, EV_SHED, EV_TRIGGER, EV_CHUNK_RETIRE,
    EV_PREEMPT, EV_REQUEUE, EV_RESOLVE, EV_CANCEL, EV_FAIL, EV_HEAL,
    EV_RECARVE, EV_RT_TRIGGER, EV_RT_RETIRE, EV_ENGINE, EV_STREAM,
)


def now_us() -> int:
    return time.perf_counter_ns() // 1000


@dataclass(frozen=True)
class Event:
    """One timeline record. ``-1`` marks a field that does not apply
    (e.g. a heal event has no request); ``extra`` carries kind-specific
    payload (span start/duration, admission terms, victim counts)."""

    kind: str
    t_us: int
    cluster: int = -1
    request_id: int = -1
    opcode: int = -1
    chunk: int = -1
    extra: dict = field(default_factory=dict)


class TraceCollector:
    """Bounded ring of structured events + histograms + monitor."""

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], int]] = None,
                 monitor: Optional[BoundMonitor] = None,
                 histogram_growth: Optional[float] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._events: deque[Event] = deque(maxlen=capacity)
        self._clock = clock if clock is not None else now_us
        self.monitor = monitor if monitor is not None else BoundMonitor()
        self._growth = histogram_growth
        self.dropped_events = 0
        self._kind_counts: dict[str, int] = {}
        self._hists: dict[tuple[str, int], LogHistogram] = {}
        self._names: dict[int, str] = {}
        self._sources: dict[str, Callable[[], dict]] = {}
        self._subscribers: list[Callable[[Event], None]] = []
        # subscriber exceptions: exact count + a bounded rolling window
        # (a persistently-raising observer on a hot emit path must not
        # grow memory without limit); warn ONCE per collector each.
        self.subscriber_errors: deque[BaseException] = deque(
            maxlen=self.SUBSCRIBER_ERROR_WINDOW)
        self.subscriber_error_count = 0
        self._warned_subscriber = False
        self._warned_overflow = False

    SUBSCRIBER_ERROR_WINDOW = 64

    # -- events ---------------------------------------------------------
    def emit(self, kind: str, *, t_us: Optional[int] = None,
             cluster: int = -1, request_id: int = -1, opcode: int = -1,
             chunk: int = -1, **extra) -> Event:
        """Append one event; oldest events drop (counted) past capacity."""
        if len(self._events) == self.capacity:
            self.dropped_events += 1
            if not self._warned_overflow:
                self._warned_overflow = True
                warnings.warn(
                    f"TraceCollector ring overflowed (capacity="
                    f"{self.capacity}): oldest events are dropping — "
                    "counted on dropped_events; raise capacity= to keep "
                    "the full window", RuntimeWarning, stacklevel=2)
        ev = Event(kind=kind,
                   t_us=t_us if t_us is not None else self._clock(),
                   cluster=cluster, request_id=request_id, opcode=opcode,
                   chunk=chunk, extra=extra)
        self._events.append(ev)
        self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
        for fn in self._subscribers:
            try:
                fn(ev)
            except Exception as e:   # a raising observer must not lose work
                self.subscriber_error_count += 1
                self.subscriber_errors.append(e)
                if not self._warned_subscriber:
                    self._warned_subscriber = True
                    warnings.warn(
                        f"TraceCollector subscriber raised {e!r}; further "
                        "errors are counted (subscriber_error_count) and "
                        f"only the last {self.SUBSCRIBER_ERROR_WINDOW} "
                        "are retained", RuntimeWarning, stacklevel=2)
        return ev

    def subscribe(self, fn: Callable[[Event], None]) -> None:
        """Register a live event observer, fired synchronously inside
        ``emit`` for every event (after it is appended to the ring). An
        observer MAY emit further events (the stream frontend reacts to
        ``chunk_retire`` by emitting a ``stream`` span); it must guard its
        own recursion. A raising observer is captured on
        ``subscriber_errors`` and never propagated into the emitter."""
        self._subscribers.append(fn)

    @property
    def events(self) -> list[Event]:
        """Snapshot of the retained window, oldest first."""
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def events_of(self, kind: str, request_id: Optional[int] = None
                  ) -> list[Event]:
        return [e for e in self._events if e.kind == kind
                and (request_id is None or e.request_id == request_id)]

    # -- opcode names ----------------------------------------------------
    def set_name(self, opcode: int, name: str) -> None:
        if name:
            self._names[opcode] = name

    def name_of(self, opcode: int) -> str:
        return self._names.get(opcode, f"op{opcode}")

    # -- latency histograms ----------------------------------------------
    def observe(self, metric: str, opcode: int, us: float) -> None:
        """Record one latency into the (metric, opcode) histogram."""
        key = (metric, opcode)
        h = self._hists.get(key)
        if h is None:
            h = LogHistogram() if self._growth is None \
                else LogHistogram(self._growth)
            self._hists[key] = h
        h.record(us)

    def hist(self, metric: str, opcode: int) -> Optional[LogHistogram]:
        return self._hists.get((metric, opcode))

    def quantiles(self, metric: Optional[str] = None) -> dict:
        """``{metric: {opcode_name: summary}}`` over every histogram (or
        one metric's slice) — the per-opcode p50/p95/p99/worst table."""
        out: dict[str, dict] = {}
        for (m, op), h in sorted(self._hists.items()):
            if metric is not None and m != metric:
                continue
            out.setdefault(m, {})[self.name_of(op)] = h.summary()
        return out if metric is None else out.get(metric, {})

    def format_table(self, metric: str = "response_us") -> list[str]:
        """Human-readable per-opcode quantile table (one string per row)."""
        rows = [f"{'class':<12} {'n':>6} {'avg':>10} {'p50':>10} "
                f"{'p95':>10} {'p99':>10} {'worst':>10}  (µs, {metric})"]
        for name, s in self.quantiles(metric).items():
            rows.append(
                f"{name:<12} {s['count']:>6} {s['avg_us']:>10.1f} "
                f"{s['p50_us']:>10.1f} {s['p95_us']:>10.1f} "
                f"{s['p99_us']:>10.1f} {s['worst_us']:>10.1f}")
        return rows

    # -- unified counters -------------------------------------------------
    def register_source(self, label: str, snapshot: Callable[[], dict]
                        ) -> None:
        """Attach a component's counter snapshot to ``counters()``.
        Re-registering a label replaces it; a second component wanting the
        same label gets a numeric suffix (shared-collector fleets)."""
        if label in self._sources and self._sources[label] is not snapshot:
            i = 2
            while f"{label}{i}" in self._sources:
                i += 1
            label = f"{label}{i}"
        self._sources[label] = snapshot

    def counters(self) -> dict:
        """One flat dict: per-kind event counts (``events.<kind>``), the
        ring's drop count, the monitor's verification counters
        (``monitor.<k>``), and every registered component snapshot
        (``<label>.<k>``) — the single surface replacing counter-grepping
        across dispatcher/mailbox/monitor attributes."""
        out = {"dropped_events": self.dropped_events,
               "subscriber_error_count": self.subscriber_error_count}
        for kind in sorted(self._kind_counts):
            out[f"events.{kind}"] = self._kind_counts[kind]
        for k, v in self.monitor.counts().items():
            out[f"monitor.{k}"] = v
        for label, snap in self._sources.items():
            try:
                for k, v in snap().items():
                    out[f"{label}.{k}"] = v
            except Exception as e:   # a dead component must not kill stats
                out[f"{label}.error"] = repr(e)
        return out

    # -- exporters (delegation keeps this module dependency-free) --------
    def export_chrome(self, path: Optional[str] = None):
        from repro_torch.core.telemetry.export import chrome_trace, write_chrome
        if path is None:
            return chrome_trace(self.events, self.name_of)
        return write_chrome(self.events, path, self.name_of)

    def export_csv(self, path: str) -> int:
        from repro_torch.core.telemetry.export import write_csv
        return write_csv(self.events, path, self.name_of)
