"""Fixed-priority (rate-monotonic-style) policy.

Items order by (static class priority, deadline, sequence): the priority
comes from the :class:`~repro_torch.core.sched.base.ClassSpec` (explicit
``priority``, else rate-monotonic rank derived from ``period_us`` —
shorter period → higher priority; classes with neither sort last as best
effort). Equal-priority items tie-break by deadline — and because an
in-flight step is never preempted, the admission analysis carries a
priority-ceiling-style blocking term: the longest lower-priority step
that may already occupy the cluster.

Admission layers three analyses (see ``sched/admission.py``):

1. priority-filtered demand — current backlog at or above the incoming
   priority (plus ALL in-flight carry-in) must fit before the deadline;
2. Liu–Layland utilization — a quick sufficient accept when every
   involved class declares a period;
3. iterative response-time analysis — the exact test, run only when the
   utilization shortcut is inconclusive.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from repro_torch.core.mailbox import WorkDescriptor
from repro_torch.core.sched import admission
from repro_torch.core.sched.admission import AdmissionError
from repro_torch.core.sched.base import QueueItem, SchedPolicy, _HeapLane


class FixedPriorityPolicy(SchedPolicy):
    name = "fp"

    def __init__(self, classes=(), *, preemptive: bool = True):
        self._lanes: dict[int, _HeapLane] = {}
        super().__init__(classes, preemptive=preemptive)

    # -- class registry --------------------------------------------------
    def set_class(self, spec) -> None:
        """Re-declaring a class can change resolved priorities; re-key
        every queued item so dispatch order and admission analysis agree
        on the NEW priorities (stale heap keys would serve re-prioritized
        work in the old order)."""
        super().set_class(spec)
        for lane in self._lanes.values():
            items = lane.live_items()
            if not items:
                continue
            lane.heap.clear()
            lane.dead = 0
            for it in items:
                lane.push((self.priority_of(it.desc.opcode),
                           it.deadline_us), it)

    # -- cluster lifecycle ----------------------------------------------
    def add_cluster(self, cluster: int) -> None:
        self._lanes[cluster] = _HeapLane()

    def drop_cluster(self, cluster: int) -> list[QueueItem]:
        lane = self._lanes.pop(cluster, None)
        return lane.live_items() if lane is not None else []

    # -- queueing --------------------------------------------------------
    def enqueue(self, cluster: int, item: QueueItem) -> None:
        key = (self.priority_of(item.desc.opcode), item.deadline_us)
        self._lanes[cluster].push(key, item)

    def pop_next(self, cluster: int, now_us: int) -> Optional[QueueItem]:
        return self._lanes[cluster].pop_live()

    def depth(self, cluster: int) -> int:
        lane = self._lanes.get(cluster)
        return lane.depth() if lane is not None else 0

    def live_items(self, cluster: int) -> list[QueueItem]:
        lane = self._lanes.get(cluster)
        return lane.live_items() if lane is not None else []

    def note_cancelled(self, cluster: int, ticket) -> None:
        lane = self._lanes.get(cluster)
        if lane is not None:
            lane.tombstone()

    # -- preemption ------------------------------------------------------
    def should_preempt(self, cluster: int, item: QueueItem,
                       now_us: int) -> bool:
        """Preempt a chunked item when a strictly higher-priority head is
        queued (equal priority continues — FIFO within a band, matching
        the (priority, deadline) lane key)."""
        if not self.preemptive:
            return False
        lane = self._lanes.get(cluster)
        head = lane.peek_live() if lane is not None else None
        if head is None:
            return False
        return self.priority_of(head.desc.opcode) < \
            self.priority_of(item.desc.opcode)

    # -- admission -------------------------------------------------------
    def admit(self, cluster: int, desc: WorkDescriptor, *,
              estimate: Callable[[int], float],
              inflight: Sequence[WorkDescriptor], now_us: int,
              ignore: Iterable[QueueItem] = (),
              chunk_estimate: Optional[Callable[[int], float]] = None
              ) -> None:
        my_prio = self.priority_of(desc.opcode)
        chunk_est = chunk_estimate or estimate

        # 1. backlog demand: queued work at my priority or above runs
        # before me (charged for its REMAINING chunks); an in-flight
        # lower-priority step carries in its full remainder only when it
        # cannot be preempted — one chunk otherwise
        demand = admission.backlog_demand_us(
            desc, estimate, inflight, self.live_items(cluster), ignore,
            item_counts=lambda it:
                self.priority_of(it.desc.opcode) <= my_prio,
            self_us=lambda d: admission.remaining_us(d, estimate, chunk_est),
            inflight_us=lambda d: self._inflight_demand_us(
                d, self.priority_of(d.opcode) <= my_prio,
                estimate, chunk_est),
            item_us=lambda it: admission.remaining_us(
                it.desc, estimate, chunk_est))
        admission.edf_demand_test(now_us, desc.deadline_us, demand)

        # 2./3. steady-state analysis over the declared class table —
        # sound only when every class that can interfere with this one
        # (higher or equal priority) is periodic; lower-priority classes
        # need no period, they enter only through the blocking term
        spec = self.spec(desc.opcode)
        if spec is None or spec.period_us is None:
            return
        interferers = [s for s in self._specs.values()
                       if s.opcode != desc.opcode
                       and self.priority_of(s.opcode) <= my_prio]
        if any(s.period_us is None for s in interferers):
            return          # aperiodic interferer: no closed analysis
        higher = [(estimate(s.opcode), float(s.period_us))
                  for s in interferers]
        utils = [c / t for c, t in higher] \
            + [estimate(desc.opcode) / float(spec.period_us)]
        rel_deadline = float(max(desc.deadline_us - now_us, 0))
        # Liu–Layland guarantees deadlines only at or beyond the period —
        # a tighter deadline must take the exact response-time path
        if rel_deadline >= float(spec.period_us) \
                and admission.utilization_test(utils):
            return          # within the Liu–Layland bound: feasible
        # priority-ceiling-style blocking: the longest lower-priority
        # critical section. Chunked execution is what shrinks it — a
        # class that declares chunk_us can only hold the cluster for ONE
        # chunk before the preemption point hands it back
        blocking = max((admission.chunk_blocking_us(
                            s, estimate(s.opcode), self.preemptive)
                        for s in self._specs.values()
                        if self.priority_of(s.opcode) > my_prio),
                       default=0.0)
        r = admission.response_time(
            estimate(desc.opcode), higher, blocking_us=blocking,
            limit_us=max(rel_deadline, float(spec.period_us)))
        if r > rel_deadline:
            raise AdmissionError(
                f"response time {r:.0f}µs exceeds relative deadline "
                f"{rel_deadline:.0f}µs for class "
                f"{spec.name or desc.opcode}",
                test="response_time", term=r, bound=rel_deadline)
