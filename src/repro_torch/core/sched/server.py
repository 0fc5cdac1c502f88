"""Budgeted bandwidth-server policy — hard temporal isolation per class.

Every :class:`~repro_torch.core.sched.base.ClassSpec` with a ``budget_us`` /
``period_us`` pair becomes a replenishing execution server per cluster
(cf. server-based GPU management, arXiv:1709.06613): the class may consume
at most ``budget_us`` of service time per ``period_us`` window. Retired
steps are charged against their class's remaining budget; an exhausted
class is DEFERRED — its queue stays intact but ``pop_next`` skips it until
the next replenishment boundary — so a misbehaving background class can
never starve a latency-critical one, and vice versa. Classes without a
budget are best-effort: always eligible, no guarantee.

Among eligible classes, selection is EDF across the class heads (priority
rank breaks deadline ties), so within its budget each class still sees
deadline-ordered service.

Admission for a budgeted class checks the server's *supply-bound
function*: the same-class demand due by the deadline (queued + in-flight
+ the incoming item) must fit in what the server can supply in that
window. The total budgeted bandwidth Σ budget/period is validated ≤ 1 at
class-registration time — an infeasible server table is a configuration
error, not a per-request rejection.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from repro_torch.core.mailbox import WorkDescriptor
from repro_torch.core.sched import admission
from repro_torch.core.sched.admission import AdmissionError
from repro_torch.core.sched.base import ClassSpec, QueueItem, SchedPolicy, \
    _HeapLane


class _Server:
    """One class's lane + replenishing budget on one cluster."""

    __slots__ = ("lane", "budget_us", "period_us", "remaining_us",
                 "next_replenish_us")

    def __init__(self, budget_us: Optional[float],
                 period_us: Optional[float]):
        self.lane = _HeapLane()
        self.budget_us = budget_us
        self.period_us = period_us
        self.remaining_us = budget_us if budget_us is not None else 0.0
        self.next_replenish_us: Optional[int] = None

    def replenish(self, now_us: int) -> None:
        if self.budget_us is None:
            return
        if self.next_replenish_us is None:      # clock starts at first use
            self.next_replenish_us = int(now_us + self.period_us)
            return
        if now_us >= self.next_replenish_us:
            periods = 1 + int(
                (now_us - self.next_replenish_us) // self.period_us)
            self.remaining_us = self.budget_us
            self.next_replenish_us = int(
                self.next_replenish_us + periods * self.period_us)

    def eligible(self, now_us: int) -> bool:
        self.replenish(now_us)
        return self.budget_us is None or self.remaining_us > 0.0

    def charge(self, service_us: float) -> None:
        if self.budget_us is not None:
            self.remaining_us = max(self.remaining_us - service_us, 0.0)


class BudgetedServerPolicy(SchedPolicy):
    """``work_conserving=False`` (default) is the hard-reservation
    contract: an exhausted class never runs before its replenishment,
    even if the cluster would otherwise idle — interference seen by every
    other class is bounded regardless of future arrivals.
    ``work_conserving=True`` softens that: when NO eligible class has
    work, an exhausted class may run opportunistically (isolation between
    competing classes is unchanged; idle capacity is never wasted —
    the right mode when one class dominates the cluster, e.g. a serving
    engine's decode)."""

    name = "server"

    def __init__(self, classes=(), *, work_conserving: bool = False,
                 preemptive: bool = True):
        self._servers: dict[int, dict[int, _Server]] = {}
        self.work_conserving = bool(work_conserving)
        super().__init__(classes, preemptive=preemptive)

    # -- class registry --------------------------------------------------
    def set_class(self, spec: ClassSpec) -> None:
        prev = self._specs.get(spec.opcode)
        super().set_class(spec)
        total = sum(s.budget_us / s.period_us
                    for s in self._specs.values()
                    if s.budget_us is not None)
        if total > 1.0 + 1e-9:
            self._specs[spec.opcode] = prev  # reject: restore old table
            if prev is None:
                del self._specs[spec.opcode]
            raise ValueError(
                f"budgeted bandwidth over-committed: Σ budget/period = "
                f"{total:.3f} > 1 after class {spec.name or spec.opcode}")
        for servers in self._servers.values():   # re-spec live clusters
            srv = servers.get(spec.opcode)
            if srv is not None:
                srv.budget_us = spec.budget_us
                srv.period_us = spec.period_us
                if spec.budget_us is not None:
                    srv.remaining_us = min(srv.remaining_us,
                                           spec.budget_us) \
                        if prev is not None and prev.budget_us is not None \
                        else spec.budget_us

    def _server(self, cluster: int, opcode: int) -> _Server:
        servers = self._servers[cluster]
        srv = servers.get(opcode)
        if srv is None:
            spec = self.spec(opcode)
            srv = _Server(spec.budget_us if spec else None,
                          spec.period_us if spec else None)
            servers[opcode] = srv
        return srv

    # -- cluster lifecycle ----------------------------------------------
    def add_cluster(self, cluster: int) -> None:
        self._servers[cluster] = {}

    def drop_cluster(self, cluster: int) -> list[QueueItem]:
        servers = self._servers.pop(cluster, None)
        if not servers:
            return []
        out: list[QueueItem] = []
        for srv in servers.values():
            out.extend(srv.lane.live_items())
        return out

    # -- queueing --------------------------------------------------------
    def enqueue(self, cluster: int, item: QueueItem) -> None:
        srv = self._server(cluster, item.desc.opcode)
        srv.lane.push((item.deadline_us,), item)

    def pop_next(self, cluster: int, now_us: int) -> Optional[QueueItem]:
        best_srv, best_key = None, None
        spare_srv, spare_key = None, None
        for opcode, srv in self._servers[cluster].items():
            head = srv.lane.peek_live()
            if head is None:
                continue
            key = (head.deadline_us, self.priority_of(opcode), head.seq)
            if srv.eligible(now_us):
                if best_key is None or key < best_key:
                    best_srv, best_key = srv, key
            elif spare_key is None or key < spare_key:
                spare_srv, spare_key = srv, key
        if best_srv is None and self.work_conserving:
            best_srv = spare_srv     # idle capacity: run exhausted class
        return best_srv.lane.pop_live() if best_srv is not None else None

    def depth(self, cluster: int) -> int:
        servers = self._servers.get(cluster)
        if not servers:
            return 0
        return sum(srv.lane.depth() for srv in servers.values())

    def live_items(self, cluster: int) -> list[QueueItem]:
        servers = self._servers.get(cluster)
        if not servers:
            return []
        out: list[QueueItem] = []
        for srv in servers.values():
            out.extend(srv.lane.live_items())
        return out

    def note_cancelled(self, cluster: int, ticket) -> None:
        servers = self._servers.get(cluster)
        if servers is not None:
            srv = servers.get(ticket.desc.opcode)
            if srv is not None:
                srv.lane.tombstone()

    def should_preempt(self, cluster: int, item: QueueItem,
                       now_us: int) -> bool:
        """Preempt a chunked item when its own server's budget ran dry
        (the remainder must defer to the replenishment — the hard-
        reservation contract now binds WITHIN an item, not only between
        items) or when an eligible head of another class is more urgent
        under the cross-server (deadline, priority, seq) key. Work-
        conserving mode relaxes the budget rule only while the cluster
        would otherwise idle: the moment ANY eligible class has queued
        work, an exhausted item's remainder must yield to it."""
        if not self.preemptive:
            return False
        servers = self._servers.get(cluster)
        if servers is None:
            return False
        own = servers.get(item.desc.opcode)
        own_exhausted = own is not None and not own.eligible(now_us)
        my_key = (item.deadline_us, self.priority_of(item.desc.opcode),
                  item.seq)
        for opcode, srv in servers.items():
            head = srv.lane.peek_live()
            if head is None or not srv.eligible(now_us):
                continue
            if own_exhausted:
                return True      # eligible work exists: zero-budget yields
            if (head.deadline_us, self.priority_of(opcode),
                    head.seq) < my_key:
                return True
        return own_exhausted and not self.work_conserving

    def next_eligible_us(self, cluster: int,
                         now_us: int) -> Optional[int]:
        """Earliest replenishment among exhausted servers that still hold
        live work — when every queued class is deferred, this is when the
        cluster can run again."""
        nxt = None
        for srv in self._servers.get(cluster, {}).values():
            if srv.lane.peek_live() is None or srv.eligible(now_us):
                continue
            if srv.next_replenish_us is not None and \
                    (nxt is None or srv.next_replenish_us < nxt):
                nxt = srv.next_replenish_us
        return nxt

    # -- accounting ------------------------------------------------------
    def on_retire(self, cluster: int, item: QueueItem, service_us: float,
                  now_us: int) -> None:
        servers = self._servers.get(cluster)
        if servers is not None:
            srv = servers.get(item.desc.opcode)
            if srv is not None:
                srv.replenish(now_us)
                srv.charge(service_us)

    def budget_remaining_us(self, cluster: int,
                            opcode: int) -> Optional[float]:
        """Diagnostic: the class server's remaining budget (None when the
        class is unbudgeted or unknown on this cluster)."""
        srv = self._servers.get(cluster, {}).get(opcode)
        if srv is None or srv.budget_us is None:
            return None
        return srv.remaining_us

    # -- admission -------------------------------------------------------
    def admit(self, cluster: int, desc: WorkDescriptor, *,
              estimate: Callable[[int], float],
              inflight: Sequence[WorkDescriptor], now_us: int,
              ignore: Iterable[QueueItem] = (),
              chunk_estimate: Optional[Callable[[int], float]] = None
              ) -> None:
        chunk_est = chunk_estimate or estimate
        self_us = lambda d: admission.remaining_us(d, estimate, chunk_est)  # noqa: E731
        item_us = lambda it: admission.remaining_us(                        # noqa: E731
            it.desc, estimate, chunk_est)
        spec = self.spec(desc.opcode)
        if spec is None or spec.budget_us is None:
            # best-effort class: conservative global demand test (no
            # server guarantees anything to it)
            demand = admission.backlog_demand_us(
                desc, estimate, inflight, self.live_items(cluster), ignore,
                item_counts=lambda it: it.deadline_us <= desc.deadline_us,
                self_us=self_us, item_us=item_us,
                inflight_us=lambda d: self._inflight_demand_us(
                    d, d.effective_deadline_us <= desc.effective_deadline_us,
                    estimate, chunk_est))
            admission.edf_demand_test(now_us, desc.deadline_us, demand)
            return
        # budgeted class: same-class demand due by the deadline must fit
        # the server's supply-bound over [now, deadline]. In-flight work
        # of ANY class counts — a non-preemptible step occupies the
        # cluster and eats the window, exactly like the blocking term in
        # fixed-priority analysis; a preemptible CHUNKED step of another
        # class eats only one chunk of it
        srv = self._server(cluster, desc.opcode)
        demand = admission.backlog_demand_us(
            desc, estimate, inflight, srv.lane.live_items(), ignore,
            item_counts=lambda it: it.deadline_us <= desc.deadline_us,
            self_us=self_us, item_us=item_us,
            inflight_us=lambda d: self._inflight_demand_us(
                d, d.opcode == desc.opcode, estimate, chunk_est))
        srv.replenish(now_us)
        supply = admission.server_supply_us(
            srv.remaining_us, spec.budget_us, spec.period_us,
            srv.next_replenish_us, now_us, desc.deadline_us)
        if demand > supply:
            raise AdmissionError(
                f"class {spec.name or desc.opcode} demand {demand:.0f}µs "
                f"exceeds server supply {supply:.0f}µs before deadline "
                f"{desc.deadline_us}",
                test="supply", term=demand, bound=supply)
