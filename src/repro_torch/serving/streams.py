"""Continuous-batching stream frontend: admission-governed stream serving —
the port of ``repro.serving.streams`` (host policy code over the port's
engine: the reference's code with the port's imports).

The engine (``serving/engine.py``) gives us the mechanism — per-slot
prefill staging, non-blocking ``add_request``, chunked device prefills
that decode steps preempt at chunk boundaries, and device-side slot
release. This module is the POLICY layer on top: each request *stream*
(prompt in, token stream out) is admitted as a work class of its own,
carrying a criticality level and a response-time promise, and the
frontend multiplexes any number of streams over the engine's fixed
``max_batch`` slots.

Admission (paper §III applied to whole streams, not single kernels): a
stream's exclusive-occupancy demand is ``n_chunks·chunk_us + insert_us``
(decode is shared lockstep across slots, charged once as an allowance),
its response deadline is ``now + safety·(demand + decode_allowance) +
slack``, and a HIGH stream is admitted only if the EDF processor-demand
criterion (:func:`repro_torch.core.sched.admission.edf_demand_test`) holds for
every live HIGH deadline with the candidate's demand added. The promise
is registered with the shared :class:`BoundMonitor` under the stream's
own request-id, so a HIGH stream finishing past its admitted bound is a
``BOUND_VIOLATION`` in the same ledger that checks kernel-level bounds.

Overload policy: when a HIGH stream is pending and either no slot is
free or its demand test fails, the frontend sheds whole LOW streams
(latest deadline first — the ones holding the loosest promises), NEVER
HIGH ones. A shed stream's slot is released device-side (OP_RELEASE,
ordered after any in-flight insert so a ghost row can never reactivate)
and the stream re-queues for admission with a fresh request-id; nothing
is silently dropped.

Every lifecycle edge — open, slot-bind, prefill-chunk, first-token,
decode, shed, close — is an ``EV_STREAM`` event on the shared
:class:`TraceCollector`; first tokens and closes also feed its
``stream_ttft_us`` / ``stream_response_us`` histograms, per class.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.sched import CRIT_HIGH, CRIT_LOW
from repro_torch.core.sched.admission import AdmissionError, edf_demand_test
from repro_torch.core.system import WorkClass
from repro_torch.core.telemetry import EV_CHUNK_RETIRE, EV_STREAM, TraceCollector
from repro_torch.core.telemetry.events import now_us
from repro_torch.serving.engine import OP_DECODE, OP_INSERT, OP_PREFILL
from repro_torch.serving.kv_cache import PH_DECODING, PH_FINISHED

__all__ = ["StreamFrontend", "StreamRequest", "OP_STREAM_HIGH",
           "OP_STREAM_LOW", "STREAM_ID_BASE", "PROMISE_ID_BASE",
           "ST_PENDING", "ST_PREFILL", "ST_DECODING", "ST_SHED",
           "ST_CLOSED"]

# Virtual opcodes for the stream-level work classes. They never enter a
# runtime work table (fn=None) — they exist so stream promises, events,
# and histograms carry a named class through the shared telemetry, and
# so ``set_class`` records their criticality/priority declaratively.
OP_STREAM_HIGH = 100
OP_STREAM_LOW = 101

# Engine-level work submitted on behalf of streams uses request-ids from
# this namespace (one fresh id per admission attempt); the stream's OWN
# response-time promise lives under PROMISE_ID_BASE + stream_id. The two
# ranges are disjoint because the dispatcher auto-registers promises for
# every submission it sees — a collision would pop the stream's bound.
# Both fit int32 (the mailbox W_REQID word).
STREAM_ID_BASE = 1_000_000_000
PROMISE_ID_BASE = 1_500_000_000

# -- stream lifecycle states ----------------------------------------------
ST_PENDING = "pending"      # opened, awaiting slot + admission
ST_PREFILL = "prefill"      # slot bound, prefill staging in progress
ST_DECODING = "decoding"    # insert resolved; producing tokens
ST_SHED = "shed"            # overload victim; awaiting slot release
ST_CLOSED = "closed"        # response complete (terminal)

_STREAM_CLASSES = (
    WorkClass(name="stream_high", fn=None, priority=1,
              criticality=CRIT_HIGH),
    WorkClass(name="stream_low", fn=None, priority=6,
              criticality=CRIT_LOW),
)


@dataclass
class StreamRequest:
    """Host-side record of one request stream."""

    stream_id: int
    prompt: np.ndarray
    max_new_tokens: int
    criticality: str
    state: str = ST_PENDING
    slot: Optional[int] = None
    slot_obj: Optional[object] = None
    work_rid: int = -1            # engine-level rid of the CURRENT attempt
    demand_us: float = 0.0        # exclusive demand charged at admission
    deadline_us: int = 0          # admitted response-time bound (absolute)
    opened_us: int = 0
    admitted_us: int = 0
    first_token_us: int = 0
    closed_us: int = 0
    sheds: int = 0                # times this stream was an overload victim
    tokens: list = field(default_factory=list)

    @property
    def opcode(self) -> int:
        return OP_STREAM_HIGH if self.criticality == CRIT_HIGH \
            else OP_STREAM_LOW

    @property
    def promise_rid(self) -> int:
        return PROMISE_ID_BASE + self.stream_id


class StreamFrontend:
    """Admission-governed continuous-batching server over one engine.

    ``open_stream`` registers a stream (non-blocking, any number may be
    open at once); ``poll`` runs one serve iteration (admit → decode →
    harvest transitions); ``serve`` loops ``poll`` until every open
    stream closed. The engine must be exclusively driven through the
    frontend while it is serving (the frontend owns ``step`` pacing and
    slot frees).
    """

    def __init__(self, engine, *, collector: Optional[TraceCollector] = None,
                 safety: float = 12.0, slack_us: float = 250_000.0,
                 decode_deadline_factor: float = 4.0):
        self.engine = engine
        self.dispatcher = engine.dispatcher
        if collector is not None and self.dispatcher.telemetry is None:
            self.dispatcher.attach_telemetry(collector)
        self.collector = self.dispatcher.telemetry
        if self.collector is None:
            self.collector = TraceCollector()
            self.dispatcher.attach_telemetry(self.collector)
        self.monitor = self.collector.monitor
        if safety < 1.0:
            raise ValueError("safety must be >= 1.0")
        self.safety = float(safety)
        self.slack_us = float(slack_us)
        self.decode_deadline_factor = float(decode_deadline_factor)

        self.streams: dict[int, StreamRequest] = {}
        self._pending: deque[int] = deque()          # stream_ids, FIFO
        self._by_slot: dict[int, StreamRequest] = {}
        self._work_rids: dict[int, StreamRequest] = {}
        self._deferred_sheds: list[StreamRequest] = []
        self._releases_inflight = 0
        self._next_stream = 0
        self._next_work_rid = STREAM_ID_BASE

        # counters (auditable via collector.counters() as "streams.<k>")
        self.opened = 0
        self.admitted = 0
        self.shed_count = 0
        self.readmitted = 0
        self.closed = 0
        self.admission_failures = 0

        for wc, op in zip(_STREAM_CLASSES, (OP_STREAM_HIGH, OP_STREAM_LOW)):
            if self.dispatcher.policy.spec(op) is None:
                self.dispatcher.set_class(wc.spec(op))
        self.collector.register_source("streams", self._counter_snapshot)
        self.collector.subscribe(self._on_event)

    def _counter_snapshot(self) -> dict:
        return {"opened": self.opened, "admitted": self.admitted,
                "shed": self.shed_count, "readmitted": self.readmitted,
                "closed": self.closed,
                "admission_failures": self.admission_failures,
                "live": sum(1 for s in self.streams.values()
                            if s.state not in (ST_CLOSED,))}

    # -- collector observer: per-chunk prefill spans --------------------
    def _on_event(self, ev) -> None:
        # translate engine-level chunk retirements of OUR prefills into
        # stream-level spans (nested emit; non-chunk kinds fall through,
        # and the emitted EV_STREAM itself fails the kind check — no
        # recursion)
        if ev.kind != EV_CHUNK_RETIRE:
            return
        st = self._work_rids.get(ev.request_id)
        if st is None or st.state != ST_PREFILL:
            return
        self.collector.emit(
            EV_STREAM, cluster=self.engine.cluster,
            request_id=st.stream_id, opcode=st.opcode, chunk=ev.chunk,
            phase="prefill_chunk", slot=st.slot)

    # -- public API ------------------------------------------------------
    def open_stream(self, prompt, max_new_tokens: int = 16,
                    criticality: str = CRIT_LOW) -> int:
        """Register one request stream; returns its stream id. Admission
        (slot binding + prefill submission) happens inside ``poll``."""
        if criticality not in (CRIT_HIGH, CRIT_LOW):
            raise ValueError(f"unknown criticality {criticality!r}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if prompt.shape[0] + max_new_tokens > self.engine.max_seq:
            raise ValueError(
                f"prompt({prompt.shape[0]}) + max_new({max_new_tokens}) "
                f"exceeds max_seq({self.engine.max_seq})")
        sid = self._next_stream
        self._next_stream += 1
        st = StreamRequest(stream_id=sid, prompt=prompt,
                           max_new_tokens=int(max_new_tokens),
                           criticality=criticality, opened_us=now_us())
        self.streams[sid] = st
        self._pending.append(sid)
        self.opened += 1
        self.collector.emit(
            EV_STREAM, cluster=self.engine.cluster, request_id=sid,
            opcode=st.opcode, phase="open", criticality=criticality,
            prompt_tokens=int(prompt.shape[0]),
            max_new_tokens=st.max_new_tokens)
        return sid

    @property
    def done(self) -> bool:
        return all(s.state == ST_CLOSED for s in self.streams.values())

    def result(self, stream_id: int) -> list[int]:
        return list(self.streams[stream_id].tokens)

    # -- admission -------------------------------------------------------
    def _estimates(self) -> tuple[float, float, float]:
        d = self.dispatcher
        step_us = d._estimate_us(OP_DECODE)
        insert_us = d._estimate_us(OP_INSERT)
        chunk_us = d._chunk_estimate_us(OP_PREFILL) \
            if self.engine.chunked_prefill else 0.0
        return step_us, insert_us, chunk_us

    def _stream_demand_us(self, st: StreamRequest) -> float:
        """Exclusive-occupancy demand of one stream: its prefill chunks
        plus its insert. Decode is lockstep across every slot so it is
        charged once per stream as an allowance, not per-slot work."""
        step_us, insert_us, chunk_us = self._estimates()
        if self.engine.chunked_prefill:
            n_chunks = -(-int(st.prompt.shape[0])
                         // self.engine.prefill_chunk_tokens)
            prefill_us = n_chunks * chunk_us
        else:
            prefill_us = 0.0        # host path: prefill burns host time
        return prefill_us + insert_us + st.max_new_tokens * step_us

    def _remaining_demand_us(self, st: StreamRequest) -> float:
        if st.state == ST_DECODING and st.slot_obj is not None:
            step_us, _, _ = self._estimates()
            left = st.max_new_tokens - len(st.slot_obj.generated)
            return max(left, 0) * step_us
        return st.demand_us

    def _live_streams(self) -> list[StreamRequest]:
        return [s for s in self.streams.values()
                if s.state in (ST_PREFILL, ST_DECODING)]

    def _demand_test(self, candidate: StreamRequest,
                     cand_deadline: int, cand_demand: float) -> None:
        """EDF processor-demand criterion over every live HIGH deadline
        (and the candidate's own, when HIGH): all stream work due by that
        deadline — live streams with earlier-or-equal deadlines plus the
        candidate — must fit in the time remaining. Raises
        :class:`AdmissionError` on the first infeasible deadline."""
        now = now_us()
        live = self._live_streams()
        checks = [s.deadline_us for s in live
                  if s.criticality == CRIT_HIGH]
        if candidate.criticality == CRIT_HIGH:
            checks.append(cand_deadline)
        for dl in sorted(set(checks)):
            demand = cand_demand if cand_deadline <= dl else 0.0
            demand += sum(self._remaining_demand_us(s) for s in live
                          if s.deadline_us <= dl)
            edf_demand_test(now, dl, demand)

    def _try_admit(self, st: StreamRequest) -> bool:
        """Bind a slot and submit the prefill for one pending stream.
        Returns False when no slot is free or the demand test fails
        (HIGH callers then consider shedding)."""
        if self.engine.slots.free_count == 0:
            return False
        now = now_us()
        demand = self._stream_demand_us(st)
        deadline = int(now + self.safety * demand + self.slack_us)
        try:
            self._demand_test(st, deadline, demand)
        except AdmissionError:
            self.admission_failures += 1
            return False
        rid = self._next_work_rid
        self._next_work_rid += 1
        slot = self.engine.add_request(rid, st.prompt, st.max_new_tokens)
        if slot is None:            # raced: treat as no-slot
            return False
        readmit = st.sheds > 0
        st.state = ST_PREFILL
        st.slot = slot
        st.slot_obj = self.engine.slots.slots[slot]
        st.work_rid = rid
        st.demand_us = demand
        st.deadline_us = deadline
        st.admitted_us = now
        st.tokens = []
        self._by_slot[slot] = st
        self._work_rids[rid] = st
        self.admitted += 1
        if readmit:
            self.readmitted += 1
        # the stream's response-time promise: HIGH deadlines are admitted
        # bounds (late ⇒ BOUND_VIOLATION), LOW deadlines are best-effort
        # targets (late ⇒ DEADLINE_MISS) — same ledger, different verdicts
        self.monitor.note_submit(
            st.promise_rid, st.opcode, deadline,
            admitted=(st.criticality == CRIT_HIGH), est_us=None, t_us=now)
        self.collector.emit(
            EV_STREAM, cluster=self.engine.cluster, request_id=st.stream_id,
            opcode=st.opcode, phase="slot_bind", slot=slot,
            deadline_us=deadline, demand_us=demand,
            path="chunked" if self.engine.chunked_prefill else "host",
            readmit=readmit)
        return True

    # -- overload shedding ------------------------------------------------
    def _shed_victim(self) -> bool:
        """Shed ONE live LOW stream (latest deadline first — the loosest
        promise) to make room for a pending HIGH. Never sheds HIGH. At
        most one shed is in flight at a time: the freed slot must come
        back through its release ticket before the next victim is chosen,
        so a single HIGH admission cannot cascade-evict the whole LOW
        population."""
        if self._releases_inflight > 0:
            return False
        victims = [s for s in self._live_streams()
                   if s.criticality == CRIT_LOW]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.deadline_us)
        self._shed(victim)
        return True

    def _shed(self, st: StreamRequest) -> None:
        self.shed_count += 1
        st.sheds += 1
        st.state = ST_SHED
        self.monitor.note_withdrawn(st.promise_rid)
        self.collector.emit(
            EV_STREAM, cluster=self.engine.cluster, request_id=st.stream_id,
            opcode=st.opcode, phase="shed", slot=st.slot,
            tokens_discarded=len(st.slot_obj.generated)
            if st.slot_obj is not None else 0)
        # Release ordering: OP_RELEASE must never execute before the
        # stream's OP_INSERT does, or the insert would re-activate the
        # slot afterward (a ghost row decode keeps writing). Three cases:
        ticket = self.engine.prefill_tickets.get(st.slot)
        if ticket is not None and ticket.cancel():
            # 1. prefill still queued and the cancel took: the chained
            #    insert will never be submitted — release immediately
            #    (device-side the slot was never activated; the release
            #    is a harmless explicit deactivation)
            self.engine.prefill_tickets.pop(st.slot, None)
            self._submit_release(st, evict=True)
        elif st.slot_obj is not None and st.slot_obj.phase in (
                PH_DECODING, PH_FINISHED):
            # 2. insert already resolved: release now
            self._submit_release(st, evict=True)
        else:
            # 3. prefill (or its chained insert) in flight: defer until
            #    the insert resolves and flips the phase — re-checked
            #    every poll
            self._deferred_sheds.append(st)

    def _flush_deferred_sheds(self) -> None:
        still = []
        for st in self._deferred_sheds:
            if st.slot_obj is not None and st.slot_obj.phase in (
                    PH_DECODING, PH_FINISHED):
                self._submit_release(st, evict=True)
            else:
                still.append(st)
        self._deferred_sheds = still

    def _submit_release(self, st: StreamRequest, *, evict: bool) -> None:
        """Release the stream's slot device-side; the host record returns
        to the free list only when the release ticket resolves (FIFO
        retirement: every decode step submitted before it has retired by
        then, so the index can never be reallocated under an in-flight
        step that still writes it)."""
        self._releases_inflight += 1
        slot = st.slot
        ticket = self.engine.release_slot(slot, request_id=st.work_rid)

        def _done(_comp, st=st, slot=slot, evict=evict):
            self._releases_inflight -= 1
            self._by_slot.pop(slot, None)
            self._work_rids.pop(st.work_rid, None)
            if evict:
                self.engine.slots.evict(slot)
            else:
                self.engine.slots.free(slot)
            st.slot = None
            st.slot_obj = None
            if st.state == ST_SHED:
                # re-queue for admission with a fresh attempt
                st.state = ST_PENDING
                self._pending.append(st.stream_id)

        ticket.on_complete(_done)

    # -- serve loop -------------------------------------------------------
    def _admit_pending(self) -> None:
        # HIGH first (stable within a class): a pending HIGH must not sit
        # behind a LOW that arrived earlier
        order = sorted(self._pending,
                       key=lambda sid:
                       0 if self.streams[sid].criticality == CRIT_HIGH
                       else 1)
        admitted = set()
        for sid in order:
            st = self.streams[sid]
            if st.state != ST_PENDING:
                admitted.add(sid)     # stale entry (already re-admitted)
                continue
            if self._try_admit(st):
                admitted.add(sid)
            elif st.criticality == CRIT_HIGH:
                # overload: shed one LOW and retry on a later poll (the
                # victim's slot returns via its release ticket)
                self._shed_victim()
        if admitted:
            self._pending = deque(s for s in self._pending
                                  if s not in admitted)

    def _poll_transitions(self) -> None:
        now = now_us()
        for st in list(self._by_slot.values()):
            if st.state == ST_PREFILL and st.slot_obj.phase in (
                    PH_DECODING, PH_FINISHED):
                st.state = ST_DECODING
                st.first_token_us = now
                st.tokens = list(st.slot_obj.generated)
                ttft = now - st.opened_us
                self.collector.observe("stream_ttft_us", st.opcode,
                                       float(ttft))
                self.collector.emit(
                    EV_STREAM, cluster=self.engine.cluster,
                    request_id=st.stream_id, opcode=st.opcode,
                    phase="first_token", slot=st.slot, ttft_us=ttft)
            if st.state == ST_DECODING:
                new = st.slot_obj.generated[len(st.tokens):]
                for tok in new:
                    self.collector.emit(
                        EV_STREAM, cluster=self.engine.cluster,
                        request_id=st.stream_id, opcode=st.opcode,
                        phase="decode", slot=st.slot, token=int(tok))
                st.tokens.extend(int(t) for t in new)
                if st.slot_obj.phase == PH_FINISHED or \
                        len(st.tokens) >= st.max_new_tokens:
                    self._close(st, now)

    def _close(self, st: StreamRequest, now: int) -> None:
        st.state = ST_CLOSED
        st.closed_us = now
        self.closed += 1
        response = now - st.opened_us
        self.collector.observe("stream_response_us", st.opcode,
                               float(response))
        # replay the stream's promise against its admitted bound: a HIGH
        # stream past its deadline is a BOUND_VIOLATION in the ledger
        self.monitor.note_resolve(
            st.promise_rid, st.opcode, self.engine.cluster,
            end_us=now, deadline_us=st.deadline_us, service_us=0.0)
        self.collector.emit(
            EV_STREAM, cluster=self.engine.cluster, request_id=st.stream_id,
            opcode=st.opcode, phase="close", slot=st.slot,
            response_us=response, tokens=len(st.tokens), sheds=st.sheds)
        self._submit_release(st, evict=False)

    def poll(self) -> None:
        """One serve iteration: flush deferred sheds, admit pending
        streams, run one decode step (or drive queued prefill work when
        nothing is decoding yet), then harvest stream transitions."""
        self._flush_deferred_sheds()
        self._admit_pending()
        if self.engine.slots.decoding_indices():
            # the decode step carries a REAL deadline so EDF lets it cut
            # in ahead of deadline-free prefill chunks — this is the
            # decode/prefill interleave
            step_us, _, chunk_us = self._estimates()
            deadline = int(now_us() + self.decode_deadline_factor
                           * (step_us + chunk_us) + self.slack_us)
            self.engine.step(deadline_us=deadline, auto_free=False)
        elif self.dispatcher.queue_depth(self.engine.cluster) or \
                self.dispatcher.inflight_depth(self.engine.cluster):
            # nothing decoding yet: drive prefill/insert/release work so
            # first inserts can land
            self.dispatcher.pump(self.engine.cluster)
        self._poll_transitions()

    def serve(self, max_polls: int = 1_000_000) -> None:
        """Poll until every opened stream has closed."""
        polls = 0
        while not self.done:
            if polls >= max_polls:
                raise RuntimeError(
                    f"serve() did not drain within {max_polls} polls "
                    f"({self._counter_snapshot()})")
            self.poll()
            polls += 1
