"""Earliest-deadline-first policy — the dispatcher's default.

Observationally equivalent to the pre-refactor in-dispatcher heap in
ordering and admission STRUCTURE: items order by (deadline, submission
sequence), deadline-free items sort last via ``NO_DEADLINE``, and
admission is the processor-demand test over earlier-or-equal-deadline
queued work plus in-flight carry-in — exactly the load sum the old
ad-hoc loop computed, now named and term-carrying. The WCET inputs are
one deliberate departure: observed estimates are jitter-inflated
(worst + ``Dispatcher.wcet_sigma``·σ); set ``wcet_sigma=0`` to restore
the historical plain observed worst.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from repro_torch.core.mailbox import WorkDescriptor
from repro_torch.core.sched import admission
from repro_torch.core.sched.base import QueueItem, SchedPolicy, _HeapLane


class EdfPolicy(SchedPolicy):
    name = "edf"

    def __init__(self, classes=(), *, preemptive: bool = True):
        super().__init__(classes, preemptive=preemptive)
        self._lanes: dict[int, _HeapLane] = {}

    # -- cluster lifecycle ----------------------------------------------
    def add_cluster(self, cluster: int) -> None:
        self._lanes[cluster] = _HeapLane()

    def drop_cluster(self, cluster: int) -> list[QueueItem]:
        lane = self._lanes.pop(cluster, None)
        return lane.live_items() if lane is not None else []

    # -- queueing --------------------------------------------------------
    def enqueue(self, cluster: int, item: QueueItem) -> None:
        self._lanes[cluster].push((item.deadline_us,), item)

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
        """Preempt a chunked item when the queue head is strictly more
        urgent under EDF order — (deadline, seq), the same key the lane
        sorts by, so a requeued remainder pops exactly after every item
        that would have preempted it."""
        if not self.preemptive:
            return False
        lane = self._lanes.get(cluster)
        head = lane.peek_live() if lane is not None else None
        return head is not None and \
            (head.deadline_us, head.seq) < (item.deadline_us, item.seq)

    # -- admission -------------------------------------------------------
    def admit(self, cluster: int, desc: WorkDescriptor, *,
              estimate: Callable[[int], float],
              inflight: Sequence[WorkDescriptor], now_us: int,
              ignore: Iterable[QueueItem] = (),
              chunk_estimate: Optional[Callable[[int], float]] = None
              ) -> None:
        # queued work counts its REMAINING demand when its deadline is
        # earlier or equal; in-flight work with a later deadline occupies
        # the cluster for its full remainder only when it cannot be
        # preempted — one chunk otherwise (the collapsed blocking term)
        chunk_est = chunk_estimate or estimate
        demand = admission.backlog_demand_us(
            desc, estimate, inflight, self.live_items(cluster), ignore,
            item_counts=lambda it: it.deadline_us <= desc.deadline_us,
            self_us=lambda d: admission.remaining_us(d, estimate, chunk_est),
            inflight_us=lambda d: self._inflight_demand_us(
                d, d.effective_deadline_us <= desc.effective_deadline_us,
                estimate, chunk_est),
            item_us=lambda it: admission.remaining_us(
                it.desc, estimate, chunk_est))
        admission.edf_demand_test(now_us, desc.deadline_us, demand)
