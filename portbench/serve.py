"""The system under test and the loop that drives it.

The port is built as ``repro_torch.launch.serve --streams`` builds it: a
``ServingEngine`` (its own ``Dispatcher`` under EDF, a
``PersistentRuntime``, host prefill) under a ``StreamFrontend`` with its
own collector. The harness hands the engine the weights it drew
(``weights.params``), opens each request with ``open_stream`` when it is
due and paces ``poll``; after each poll it notes every token the
frontend delivered, with the host clock.

Spans (``torch.profiler.record_function``) are the harness's own, around
its calls into each layer: ``portbench.poll``, and on the engine and model
instances it wrapped ``portbench.add_request``, ``portbench.step``,
``portbench.prefill`` and ``portbench.decode_step``; ``portbench.window``
covers the measured window.
"""
from __future__ import annotations

import math
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from portbench import traffic as traffic_mod
from portbench import weights

DRAIN_S = 60.0          # how long answers due in the window are waited for
TRACE_LEAD_S = 2.0      # the profiler starts this long before the window


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=config["name"], **config["model"])


@dataclass
class StreamRec:
    req: traffic_mod.Request
    sid: int
    due: float                      # host time the request was due
    times: list = field(default_factory=list)   # (host time, attempt)
    first: Optional[float] = None   # first token of the first attempt
    shed: bool = False
    failed: bool = False
    closed: Optional[float] = None
    attempt: int = 0
    ntok: int = 0                   # tokens of this attempt noted so far
    tokens: list = field(default_factory=list)  # served, once all is done
    logits: object = None           # the prefill's last-position logits


@dataclass
class Run:
    """What one run served and measured; the metric readers read it."""
    cell: object
    seed: int
    seconds: float
    t0: float = 0.0                  # window start (host clock)
    t_end: float = 0.0
    streams: list = field(default_factory=list)      # StreamRec
    counters0: dict = field(default_factory=dict)    # frontend, at t0
    counters1: dict = field(default_factory=dict)    # frontend, at t_end
    violations: set = field(default_factory=set)     # HIGH stream ids
    late_s: float = 0.0              # how late the generator opened
    t_stop: float = 0.0              # when the run stopped waiting
    live: dict = field(default_factory=dict)        # sid -> open StreamRec
    harvest: object = None           # notes the tokens delivered so far
    steps: list = field(default_factory=list)   # (t, active valid lengths)
    prefills: list = field(default_factory=list)    # (t, prompt length)
    trace: Optional[dict] = None     # trace.reduce(...) of a traced run
    device_kind: str = ""
    model: dict = field(default_factory=dict)       # config "model"

    def in_window(self, t: float) -> bool:
        return self.t0 <= t < self.t_end


class System:
    """The port's serving stack for one cell, with the harness's hooks."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.core.wcet import WcetTracker
        from repro_torch.distributed import ShardCtx
        from repro_torch.models import build
        from repro_torch.serving import ServingEngine, StreamFrontend
        self.cell = cell
        tr = cell.traffic
        self.cfg = model_config(cell.config)
        self.device = torch.device(device)
        self.model = build(self.cfg, ShardCtx.single(kind="decode"),
                           device=self.device)
        self.engine = ServingEngine(
            self.model, weights.params(cell.config["model"], seed,
                                       self.device),
            max_batch=int(tr["slots"]), max_seq=int(tr["max_seq"]),
            tracker=WcetTracker("serve"), completion_window=1024,
            policy="edf", max_steps=8, device=self.device)
        self.fe = StreamFrontend(self.engine)
        self.tracing = False
        self.on_step = None
        self.on_prefill = None
        self.prefill_logits: dict = {}   # engine request id -> logits
        self._last_logits = None
        self._wrap()

    def _span(self, name):
        if not self.tracing:
            return nullcontext()
        return torch.profiler.record_function(name)

    def _wrap(self):
        model, engine = self.model, self.engine
        decode, prefill = model.decode_step, model.prefill
        add, step = engine.add_request, engine.step
        self._state = engine.rt.state

        def decode_step(params, caches, tokens, positions):
            with self._span("portbench.decode_step"):
                return decode(params, caches, tokens, positions)

        def prefill_(params, batch, max_seq):
            if self.on_prefill is not None:
                self.on_prefill(int(batch["tokens"].shape[1]))
            with self._span("portbench.prefill"):
                logits, caches = prefill(params, batch, max_seq=max_seq)
            # the first token's logits, kept on the card (no sync) for the
            # check after the window
            self._last_logits = logits[0, -1].detach().clone()
            return logits, caches

        def add_request(request_id, *a, **k):
            self._last_logits = None
            with self._span("portbench.add_request"):
                slot = add(request_id, *a, **k)
            if self._last_logits is not None:
                self.prefill_logits[request_id] = self._last_logits
            return slot

        def step_(*a, **k):
            if self.on_step is not None:
                self.on_step()
            with self._span("portbench.step"):
                return step(*a, **k)

        model.decode_step = decode_step
        model.prefill = prefill_
        engine.add_request = add_request
        engine.step = step_

    def counters(self) -> dict:
        fe = self.fe
        return {"opened": fe.opened, "admitted": fe.admitted,
                "shed": fe.shed_count, "readmitted": fe.readmitted,
                "closed": fe.closed, "steps": self.engine._step_counter}

    def poll(self):
        with self._span("portbench.poll"):
            self.fe.poll()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self, seed: int):
        """Serve the traffic's warm-up prompts (2 tokens each) to the end:
        kernels loaded and built, the allocator grown to the longest
        prompt, the dispatcher's estimates seeded."""
        tr = self.cell.traffic
        rng = np.random.default_rng([int(seed), 1])
        for L in tr["warm_prompts"]:
            self.fe.open_stream(
                rng.integers(0, self.cfg.vocab_size, int(L), dtype=np.int32),
                max_new_tokens=2)
            self.fe.serve()
        self.sync()

    def dispose(self):
        """Release the engine's state: weights, caches, staging."""
        from repro_torch.core.persistent import reap_deferred
        self.engine.dispose()
        reap_deferred()
        self._state.clear()
        self.model = self.engine = self.fe = self._state = None


def serve_window(system: System, reqs: list, run: Run,
                 clock=time.perf_counter, on_window=None) -> None:
    """Drive the frontend through the lead-in (the requests due before the
    window) and then for ``run.seconds``: open each request when it is
    due, poll, note delivered tokens. ``on_window()`` is called
    ``TRACE_LEAD_S`` (at most the lead-in) before the window opens: a
    traced run starts its profiler there, so that the profiler's start
    stalls the lead-in and not the window."""
    from repro_torch.core.sched import CRIT_HIGH, CRIT_LOW
    from repro_torch.core.telemetry import BOUND_VIOLATION
    from repro_torch.serving.streams import PROMISE_ID_BASE, ST_CLOSED
    fe = system.fe
    live: dict[int, StreamRec] = {}

    def on_violation(v):
        if v.kind == BOUND_VIOLATION:
            run.violations.add(v.request_id - PROMISE_ID_BASE)

    fe.monitor.on_violation(on_violation)

    def open_(req, due):
        now = clock()
        try:
            sid = fe.open_stream(req.prompt, max_new_tokens=req.max_new,
                                 criticality=CRIT_HIGH if req.high
                                 else CRIT_LOW)
        except ValueError:
            rec = StreamRec(req, -1, due, failed=True)
            run.streams.append(rec)
            return
        rec = StreamRec(req, sid, due)
        run.late_s = max(run.late_s, now - due)
        run.streams.append(rec)
        live[sid] = rec

    def harvest(t):
        done = []
        for sid, rec in live.items():
            st = fe.streams[sid]
            if st.sheds > rec.attempt:
                rec.shed = True
                rec.attempt = st.sheds
                rec.ntok = 0
            n = len(st.tokens)
            if n < rec.ntok:
                rec.ntok = 0
            for _ in range(n - rec.ntok):
                rec.times.append((t, rec.attempt))
            if n > rec.ntok and rec.first is None:
                rec.first = t
            rec.ntok = n
            if st.state == ST_CLOSED:
                rec.closed = t
                done.append(sid)
        for sid in done:
            live.pop(sid)

    queue = sorted(reqs, key=lambda r: r.arrival_s)
    qi = 0

    def serve_until(t_stop):
        nonlocal qi
        while True:
            now = clock()
            if now >= t_stop:
                return
            while qi < len(queue) and run.t0 + queue[qi].arrival_s <= now:
                open_(queue[qi], run.t0 + queue[qi].arrival_s)
                qi += 1
            if not live:
                if qi >= len(queue):
                    return
                time.sleep(min(1e-3, max(0.0, run.t0 + queue[qi].arrival_s
                                         - clock())))
                continue
            system.poll()
            harvest(clock())

    # the lead-in: requests due before the window (arrivals below 0)
    lead = max([0.0] + [-r.arrival_s for r in queue])
    run.t0 = clock() + lead
    run.t_end = run.t0 + run.seconds
    if on_window is not None:
        serve_until(run.t0 - min(lead, TRACE_LEAD_S))
        on_window()
        if system.tracing:
            system.on_step = lambda: run.steps.append((clock(), [
                int(s.slot_obj.length) + 1 for s in fe._by_slot.values()
                if s.state == "decoding" and s.slot_obj is not None]))
            system.on_prefill = lambda L: run.prefills.append((clock(), L))
    serve_until(run.t0)
    run.counters0 = system.counters()
    with system._span("portbench.window"):
        serve_until(run.t_end)
        system.sync()
    run.counters1 = system.counters()
    system.on_step = system.on_prefill = None
    run.live = live
    run.harvest = harvest


def drain(system: System, run: Run, clock=time.perf_counter) -> None:
    """After the window nothing new is due: poll until every request due
    in it has its first token (shed ones aside), for ``DRAIN_S`` at most."""
    deadline = clock() + DRAIN_S
    while clock() < deadline and any(
            r.first is None and not r.shed for r in run.live.values()):
        system.poll()
        run.harvest(clock())
    run.t_stop = clock()


def prefill_logits(system: System, work_rid: int):
    """The logits the prefill of an engine request gave its first token
    (on the host), or None."""
    t = system.prefill_logits.get(work_rid)
    return t.float().cpu() if t is not None else None


def collect(system: System, run: Run) -> None:
    """Every stream's served tokens and its prefill's logits (of the
    attempt that served them), once serving is over."""
    for r in run.streams:
        if r.sid >= 0:
            st = system.fe.streams[r.sid]
            r.tokens = list(st.tokens)
            r.logits = prefill_logits(system, st.work_rid)


def finish(system: System, run: Run) -> None:
    """Everything after the window: wait for the answers due in it, note
    what every stream was served, free the program's state."""
    drain(system, run)
    collect(system, run)
    system.dispose()


def pctl(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (inf counts as the largest)."""
    v = sorted(values)
    if not v:
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def itl_gaps(run: Run) -> list:
    """Every gap between consecutive delivered tokens of one attempt of a
    stream, whose later token came in the window."""
    out = []
    for r in run.streams:
        for (a, na), (b, nb) in zip(r.times, r.times[1:]):
            if na == nb and run.in_window(b):
                out.append(b - a)
    return out


def ttfts(run: Run) -> list:
    """Time from due to first token of every request due in the window;
    shed, failed or not answered when the run stopped waiting: the time
    from due to then (the knee sweep reads it)."""
    out = []
    for r in run.streams:
        if not run.in_window(r.due):
            continue
        ok = r.first is not None and not r.shed and not r.failed
        out.append(r.first - r.due if ok else run.t_stop - r.due)
    return out


