"""Persistent runtime — the paper's persistent-worker execution model, ported
to PyTorch (counterpart of ``repro.core.persistent``).

Boot once (heavy state lives on the device), then each work item is
dispatched by handing the runtime ONLY a DESC_WIDTH-int32 mailbox row; the
step switches on the opcode and updates the device state in place. Trigger
= enqueue the step's kernels on the current CUDA stream and record a
``torch.cuda.Event``; Wait = synchronize on that event — the paper's phase
split.

What changed from the reference, and why:

* The opcode switch runs on the HOST. The descriptor stays a host
  ``int32`` row (``desc[mb.W_ARG0]`` and friends are numpy ints), so a
  work function reads its arguments without any device sync and enqueues
  only tensor work. The ``from_gpu`` ack row is therefore built host-side
  at trigger time from the descriptor and the work fn's ``done`` flag; it
  is byte-identical to the reference's device-built row.
* The ring variant of a batched doorbell (``trigger_many``) is a Python
  loop over the NOP-padded descriptor ring, one ``_lk_step`` per row —
  token-identical to sequential triggers by construction, exactly as the
  reference's ``lax.scan`` body is ``_lk_step``.
* There is no compilation, donation or executable cache: PyTorch runs
  eagerly, and state is updated in place (work fns may mutate ``state``
  and return the same dict). Steps are ordered by the one CUDA stream they
  are enqueued on, so host-side staging done between steps on the same
  stream (the engine's host prefill) lands after every in-flight step.
* ``_Block.materialize`` synchronizes on the block's event and reads the
  block back with one ``.cpu()`` per leaf: results, and the acks and
  flight-recorder rows where a device kernel wrote them (``MegaRuntime``);
  this runtime builds its acks and profile rows in host memory.
* ``ExecutableCache`` keeps the reference's API and counters; what a
  runtime caches in it is the prepared launch state of a boot (see
  ``repro_torch.core.mega``). ``PersistentRuntime`` has nothing to prepare
  and takes no cache.

Chunked (resumable) work keeps the reference's contract

    fn(state, carry, desc) -> (state, carry, result, done)

where ``done`` must be a HOST bool (a Python/numpy bool — typically
computed from the descriptor's ``chunk``/``n_chunks`` words): the ack row
is built without reading the device. Legacy two-argument fns
``fn(state, desc) -> (state, result)`` are wrapped as always-done atomic
work. The carry is cluster-local scratch, as in the reference.
"""
from __future__ import annotations

import inspect
from collections import deque
from typing import Any, Callable, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core import mailbox as mb
from repro_torch.core.telemetry import (EV_CHUNK_RETIRE, EV_RT_RETIRE,
                                        EV_RT_TRIGGER, TraceCollector, span)
from repro_torch.core.telemetry.events import now_us
from repro_torch.core.wcet import WcetTracker


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts/lists/tuples
    (``None`` leaves pass through) — the port's ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Tensor leaves of a nested dict/list/tuple tree, in order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but CUDA is not available; pass "
            "device='cpu' explicitly to run on the CPU")
    return device


class ExecutableCache:
    """Shared cache of prepared launch state, keyed by a fingerprint of
    everything the launch depends on (the reference keys its compiled
    executables the same way). A recarve boots fresh runtimes whose launch
    state is identical to the ones just disposed; one cache shared across a
    fleet turns every post-first boot into a dictionary hit.

    Not thread-safe; callers share it from one dispatch loop
    (``LkSystem`` passes one instance to every runtime it boots).
    """

    def __init__(self):
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get_or_compile(self, key: tuple, compile_fn: Callable):
        exe = self._entries.get(key)
        if exe is not None:
            self.hits += 1
            return exe
        self.misses += 1
        exe = compile_fn()
        self._entries[key] = exe
        return exe

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


# Teardown work handed off by ``dispose()`` — each entry is the list of
# in-flight blocks plus the state trees they may still be writing; the
# blocking half (waiting for those steps) runs in ``reap_deferred()``.
_DEFERRED_TEARDOWN: list = []
_DEFERRED_CAP = 16


def reap_deferred() -> int:
    """Finalize every teardown deferred by ``dispose()``: wait until the
    disposed runtimes' in-flight steps finish, then drop their device
    state. Returns the number of runtimes finalized; idempotent."""
    n = 0
    while _DEFERRED_TEARDOWN:
        blocks, _trees = _DEFERRED_TEARDOWN.pop()
        for blk in blocks:
            blk.synchronize()
        n += 1
    return n


def _normalize_work_fn(fn: Callable) -> Callable:
    """Accept both work-fn generations: the chunk-aware
    ``fn(state, carry, desc) -> (state, carry, result, done)`` passes
    through; a legacy ``fn(state, desc) -> (state, result)`` is wrapped as
    atomic always-done work with a pass-through carry. Classification
    counts REQUIRED positional parameters, so a legacy fn with defaulted
    extras (``fn(state, desc, cfg=CFG)``) stays legacy."""
    try:
        required = sum(
            1 for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty)
    except (TypeError, ValueError):     # builtins/partials without sigs
        required = 2
    if required >= 3:
        return fn

    def atomic(state, carry, desc):
        state, result = fn(state, desc)
        return state, carry, result, True

    return atomic


@runtime_checkable
class RuntimeProtocol(Protocol):
    """The contract the Dispatcher requires of a per-cluster runtime.

    ``max_inflight`` is the EXPLICIT pipeline-capacity attribute every
    runtime must declare — the dispatcher reads it directly, so a runtime
    that forgets it fails loudly at registration instead of silently
    serializing its cluster.
    """

    max_inflight: int

    def trigger(self, desc) -> None: ...        # async enqueue

    def ready(self) -> bool: ...                # oldest step finished?

    def wait(self) -> tuple: ...                # block; (result, from_gpu)


def _to_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class _Block:
    """One in-flight pipeline entry: a single step (``n == 1``,
    ``stacked=False``) or a batched ring whose stacked results and ack
    block retire item by item (``idx`` walks the block). ``event`` is the
    CUDA event recorded after the block's work was enqueued (None on the
    CPU, where eager work is complete at enqueue). The device results are
    swapped for host copies at materialization — one ``.cpu()`` per result
    leaf, however many items the block holds.

    ``acks`` (``(n, DESC_WIDTH)`` or ``(DESC_WIDTH,)``) and ``prof``
    (flight-recorder rows, see ``core.mailbox``) are int32 arrays: host
    arrays built at trigger time, or tensors a device kernel writes, read
    back at materialization. ``held`` keeps host buffers alive until the
    block's device work is done (the pinned staging its copies read from).
    ``t_trigger_us`` anchors the launch's host window for tick
    calibration. ``descs`` holds the descriptors as triggered (one, or a
    ring's list), whose opcodes name the wait spans; None where the runtime
    keeps none."""

    __slots__ = ("results", "acks", "n", "idx", "stacked", "host_acks",
                 "prof", "host_prof", "t_trigger_us", "event", "held",
                 "descs")

    def __init__(self, results, acks, n: int, stacked: bool,
                 prof=None, t_trigger_us: int = 0, event=None, held=None,
                 descs=None):
        self.results = results
        self.acks = acks
        self.n = n
        self.idx = 0
        self.stacked = stacked
        self.host_acks = None      # set at materialization
        self.prof = prof
        self.host_prof = None
        self.t_trigger_us = t_trigger_us
        self.event = event
        self.held = held
        self.descs = descs

    @property
    def remaining(self) -> int:
        return self.n - self.idx

    def done(self) -> bool:
        """Non-blocking: has the block's device work finished?"""
        return self.event is None or self.event.query()

    def synchronize(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def materialize(self) -> None:
        """Block until the whole block finished; ONE readback per leaf."""
        if self.host_acks is not None:
            return
        self.synchronize()
        self.results = tree_map(lambda t: t.cpu(), self.results)
        self.host_acks = _to_host(self.acks)
        if self.prof is not None:
            self.host_prof = np.atleast_2d(_to_host(self.prof))
        self.held = None

    def pop_item(self) -> tuple:
        """(result, from_gpu) of the next unretired item (materialized)."""
        i = self.idx
        self.idx += 1
        if not self.stacked:
            return self.results, self.host_acks
        return (tree_map(lambda a: a[i], self.results),
                self.host_acks[i])


class _PipelinedRuntime:
    """Pipeline mechanics shared by every device-backed runtime: the
    bounded in-flight deque of ``_Block``s, memoized oldest-ready polling,
    strict-FIFO ``wait()``/``poll()``/``wait_all()`` retirement with ONE
    bulk readback per block, and retire-time telemetry. Subclasses own the
    TRIGGER side, the ``booted`` predicate and ``_on_block_retired``."""

    def __init__(self, tracker: Optional[WcetTracker] = None,
                 max_inflight: int = 2,
                 telemetry: Optional[TraceCollector] = None,
                 name: str = "lk"):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.tracker = tracker or WcetTracker(name)
        self.max_inflight = int(max_inflight)
        self._inflight: deque[_Block] = deque()
        self._oldest_ready = False     # memoized ready() of the oldest block
        self.status = mb.THREAD_INIT
        self.steps = 0
        # runtime-level telemetry: step enqueue/retire instants with the
        # in-flight depth; the cluster id is assigned by whoever registers
        # this runtime
        self.telemetry = telemetry
        self.telemetry_cluster = -1
        # flight-recorder anchor: host end of the previously retired block
        self._last_block_end_us = 0.0
        self.device_spans = 0          # device-stamped spans re-emitted

    @property
    def booted(self) -> bool:
        raise NotImplementedError

    @property
    def inflight(self) -> int:
        """Number of enqueued-but-unretired steps (batch items counted)."""
        return sum(blk.remaining for blk in self._inflight)

    @property
    def can_trigger(self) -> bool:
        return self.booted and self.inflight < self.max_inflight

    def _on_block_retired(self, blk: _Block) -> None:
        """Hook: the oldest block fully retired (subclass bookkeeping)."""

    def _span_name(self, phase: str, descs) -> str:
        """``repro_torch.rt.<phase>.<work>``: the work table's names of
        ``descs``' opcodes (clamped into the table, as the step clamps
        them), joined by ``+`` in ring order where they differ."""
        last = len(self.work_names) - 1
        works = dict.fromkeys(self.work_names[min(max(
            PersistentRuntime._desc_fields(d)[1], 0), last)] for d in descs)
        return f"repro_torch.rt.{phase}." + "+".join(works)

    def _wait_span_name(self, blk: _Block) -> str:
        """The wait span of ``blk``'s next item to retire."""
        if blk.descs is None:
            return "repro_torch.rt.wait"
        return self._span_name("wait", (blk.descs[blk.idx] if blk.stacked
                                        else blk.descs,))

    def ready(self) -> bool:
        """Non-blocking: has the OLDEST in-flight step finished on device?
        ``event.query()`` on CUDA; memoized until the block retires."""
        if not self._inflight:
            return False
        if self._oldest_ready:
            return True
        blk = self._inflight[0]
        self._oldest_ready = blk.host_acks is not None or blk.done()
        return self._oldest_ready

    def _retire_block_profile(self, blk: _Block) -> None:
        """Decode a just-materialized block's flight-recorder rows and
        re-emit them as ``chunk_retire`` spans with ``source=device``.

        Ticks are LOGICAL; the per-launch anchor maps them affinely into
        the block's host window ``[max(trigger, previous block end),
        materialize]``, which keeps every cluster's timeline monotone."""
        end = float(now_us())
        start = max(float(blk.t_trigger_us), self._last_block_end_us)
        if end < start + 1.0:
            end = start + 1.0
        self._last_block_end_us = end
        prof = blk.host_prof
        if prof is None or self.telemetry is None:
            return
        idxs = np.nonzero(prof[:, mb.P_ACTIVE])[0]
        if idxs.size == 0:
            return
        acks = np.atleast_2d(blk.host_acks)
        t0s = prof[idxs, mb.P_TICK0].astype(np.float64)
        t1s = prof[idxs, mb.P_TICK1].astype(np.float64)
        lo = float(t0s.min())
        scale = (end - start) / max(float(t1s.max()) - lo, 1.0)
        for j, i in enumerate(idxs):
            s = float(start + (t0s[j] - lo) * scale)
            d = float(max((t1s[j] - t0s[j]) * scale, 1.0))
            self.telemetry.emit(
                EV_CHUNK_RETIRE, cluster=self.telemetry_cluster,
                request_id=int(prof[i, mb.P_REQID]),
                opcode=int(prof[i, mb.P_OPCODE]),
                chunk=int(acks[i, mb.W_CHUNK]),
                source="device", start_us=s, dur_us=d,
                tick=int(prof[i, mb.P_TICK0]),
                row=int(prof[i, mb.P_ROW]),
                qdepth=int(prof[i, mb.P_QDEPTH]))
            self.device_spans += 1

    def wait(self):
        """Block until the oldest in-flight step completes; returns
        (result, from_gpu). Steps retire strictly in trigger order. The
        first wait on a batched block materializes the WHOLE block (one
        readback); its remaining items then retire host-side."""
        assert self._inflight, "nothing in flight"
        blk = self._inflight[0]
        with self.tracker.phase("wait"), \
                span(lambda: self._wait_span_name(blk)):
            first = blk.host_acks is None
            blk.materialize()
            if first:
                self._retire_block_profile(blk)
            result, from_gpu = blk.pop_item()
            if blk.remaining == 0:
                self._inflight.popleft()
                self._oldest_ready = False
                self._on_block_retired(blk)
        self.status = (mb.THREAD_WORKING if self._inflight
                       else int(from_gpu[mb.W_STATUS]))
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_RT_RETIRE, cluster=self.telemetry_cluster,
                request_id=int(from_gpu[mb.W_REQID]),
                chunk=int(from_gpu[mb.W_CHUNK]),
                status=int(from_gpu[mb.W_STATUS]),
                depth=self.inflight)
        return result, from_gpu

    def poll(self):
        """Retire the oldest in-flight step iff it already completed;
        returns (result, from_gpu) or None."""
        if not self.ready():
            return None
        return self.wait()

    def wait_all(self) -> list:
        """Drain the pipeline; returns retired (result, from_gpu) in order."""
        out = []
        while self._inflight:
            out.append(self.wait())
        return out

    def run_sync(self, desc):
        self.trigger(desc)
        return self.wait()


def _place(state, shardings):
    """``state``'s leaves with a Sharding in ``shardings`` (same structure;
    None leaves stay plain) as DTensors on its placements, each rank
    keeping its block (no collective)."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, sh):
        if sh is None:
            return t
        return distribute_tensor(t, sh.mesh, tuple(sh.placements),
                                 src_data_rank=None)
    return tree_map(put, state, shardings)


class PersistentRuntime(_PipelinedRuntime):
    """One persistent worker (paper: one SM / one cluster).

    work_fns: list of ``(name, fn)`` or ``(name, fn, carry_template)``.
    ``fn`` is either chunk-aware ``fn(state, carry, desc) -> (state, carry,
    result, done)`` or legacy ``fn(state, desc) -> (state, result)``
    (auto-wrapped as atomic). Every fn returns a result with the structure
    of ``result_template`` (NOP steps return its zeros); each opcode's
    carry is private (a clone of ``carry_template``, a scalar int32 zero
    when omitted) and lives on ``device`` across steps.

    ``max_inflight`` bounds the in-flight pipeline: ``trigger()`` returns
    at enqueue, ``wait()`` (blocking) / ``poll()`` (non-blocking) retire
    the oldest step, ``wait_all()`` drains. ``trigger()`` on a full
    pipeline raises — callers gate on ``can_trigger``. ``trigger_many()``
    issues up to ``max_steps`` descriptors as ONE batched doorbell (one
    ring, one event); its items still retire one at a time, but the whole
    block materializes with a single readback.

    ``staged_cap`` bounds the next-chunk double buffer, with the
    reference's eviction rules: entries whose item is no longer live go
    first; ``staged_hits`` counts re-triggers served from the buffer,
    ``staged_misses`` mid-item re-triggers whose entry was evicted (or
    staging is off). ``device`` is where state, carries and results live;
    it defaults to ``"cuda"`` and raises when CUDA is absent.

    ``mesh`` and ``state_shardings`` (a tree of the state's structure whose
    leaves are ``Sharding``s on ``mesh``, or None): ``boot`` places each
    leaf with a Sharding as a DTensor on its placements, every rank of the
    mesh keeping its block (the reference's ``jax.device_put(state,
    shardings)``), and the work fns run on them; every rank of the mesh
    drives the runtime with the same descriptors (SPMD), and a DTensor
    result comes back as its full value on each (``full_tensor``: a
    collective of the mesh's ranks). ``device`` is then the mesh's device
    (the rank's card, or the CPU). The scan runtime compiles nothing, so
    there is no executable cache to bypass.
    """

    def __init__(self, work_fns: Sequence[tuple],
                 result_template: Any,
                 tracker: Optional[WcetTracker] = None,
                 mesh=None,
                 state_shardings=None,
                 max_inflight: int = 2,
                 max_steps: int = 8,
                 telemetry: Optional[TraceCollector] = None,
                 staged_cap: int = 4,
                 profile: Optional[bool] = None,
                 device="cuda"):
        super().__init__(tracker=tracker, max_inflight=max_inflight,
                         telemetry=telemetry, name="lk")
        if max_steps < 1:
            raise ValueError("max_steps must be >= 1")
        if staged_cap < 0:
            raise ValueError("staged_cap must be >= 0")
        if (mesh is None) != (state_shardings is None):
            raise ValueError("mesh and state_shardings go together")
        self.mesh = mesh
        self._state_shardings = state_shardings
        if mesh is not None:
            device = mesh.device_type
        self.device = check_device(device)
        self.work_names = [entry[0] for entry in work_fns]
        self._fns = [_normalize_work_fn(entry[1]) for entry in work_fns]
        self._carry_templates = [
            entry[2] if len(entry) > 2 else torch.zeros((), dtype=torch.int32)
            for entry in work_fns]
        self._result_template = result_template
        self._state = None
        self._carries = None
        self._booted = False
        self.max_steps = int(max_steps)
        # flight recorder (None = auto: on exactly when telemetry is
        # attached): every step also stamps a PROF_WIDTH row and advances
        # the logical tick; the ack rows are untouched either way
        self._profile = profile
        self._tick = None
        # staged next-chunk descriptors (double buffer): key -> host row
        self._staged: dict[tuple[int, int], np.ndarray] = {}
        self._staged_cap = int(staged_cap)
        # request ids with a LIVE mid-item chunk sequence: their staged
        # entries are evicted LAST
        self._live_rids: set[int] = set()
        self.staged_hits = 0           # re-triggers served from the buffer
        self.staged_misses = 0         # evicted/unstaged mid-item re-triggers
        self.doorbells = 0             # batched trigger_many rings
        self.batched_steps = 0         # steps issued through doorbells

    # ------------------------------------------------------------------
    def _lk_step(self, state, carries, desc):
        """One step: the host-side opcode switch. ``desc`` is a host int32
        row; the work fn enqueues its tensor work and returns a host
        ``done``. Returns (state, carries, result, from_gpu)."""
        status = int(desc[mb.W_STATUS])
        opcode = min(max(int(desc[mb.W_OPCODE]), 0), len(self._fns) - 1)
        is_work = status >= mb.THREAD_WORK
        if is_work:
            state, carry, result, done = self._fns[opcode](
                state, carries[opcode], desc)
            carries = [carry if j == opcode else c
                       for j, c in enumerate(carries)]
            done = bool(done)
            if self.mesh is not None:
                from repro_torch.distributed.sharding import full_value
                result = tree_map(full_value, result)
        else:
            result = tree_map(torch.zeros_like, self._result_template)
            done = True
        from_gpu = np.zeros((mb.DESC_WIDTH,), np.int32)
        from_gpu[mb.W_STATUS] = (
            (mb.THREAD_FINISHED if done else mb.THREAD_PREEMPTED)
            if is_work else mb.THREAD_NOP)
        from_gpu[mb.W_REQID] = desc[mb.W_REQID]
        from_gpu[mb.W_CHUNK] = desc[mb.W_CHUNK]
        from_gpu[mb.W_NCHUNKS] = desc[mb.W_NCHUNKS]
        return state, carries, result, from_gpu

    def _lk_multi_step(self, state, carries, ring):
        """The multi-step persistent loop over a NOP-padded descriptor ring
        (``(max_steps, DESC_WIDTH)``): each row is one ``_lk_step``, so the
        block is token-identical to sequential triggers. Returns the
        stacked results and the ack block."""
        results, acks = [], []
        for desc in ring:
            state, carries, result, from_gpu = self._lk_step(
                state, carries, desc)
            results.append(result)
            acks.append(from_gpu)
        stacked = tree_map(lambda *xs: torch.stack(xs), *results)
        return state, carries, stacked, np.stack(acks)

    def _lk_step_prof(self, state, carries, tick, desc,
                      row_idx=0, qdepth=1):
        """``_lk_step`` plus the flight-recorder words: a PROF_WIDTH row
        (begin/end logical tick, per-launch row counter, queue occupancy
        at pop) and the tick advanced by one per work step. The ack record
        is byte-identical to the bare step's."""
        state, carries, result, from_gpu = self._lk_step(
            state, carries, desc)
        act = int(int(desc[mb.W_STATUS]) >= mb.THREAD_WORK)
        prof = np.zeros((mb.PROF_WIDTH,), np.int32)
        prof[mb.P_TICK0] = act * tick
        prof[mb.P_TICK1] = act * (tick + 1)
        prof[mb.P_ROW] = act * row_idx
        prof[mb.P_QDEPTH] = act * qdepth
        prof[mb.P_OPCODE] = act * int(desc[mb.W_OPCODE])
        prof[mb.P_REQID] = act * int(desc[mb.W_REQID])
        prof[mb.P_ACTIVE] = act
        return state, carries, tick + act, result, from_gpu, prof

    def _lk_multi_step_prof(self, state, carries, tick, ring):
        """Profiled twin of ``_lk_multi_step``: each row's profile record
        gets its launch-row index and the ring occupancy at pop (total
        work rows minus work already consumed)."""
        total = int(np.sum(ring[:, mb.W_STATUS] >= mb.THREAD_WORK))
        results, acks, profs = [], [], []
        seen = 0
        for desc in ring:
            state, carries, tick, result, from_gpu, prof = \
                self._lk_step_prof(state, carries, tick, desc,
                                   row_idx=seen, qdepth=total - seen)
            seen += int(int(desc[mb.W_STATUS]) >= mb.THREAD_WORK)
            results.append(result)
            acks.append(from_gpu)
            profs.append(prof)
        stacked = tree_map(lambda *xs: torch.stack(xs), *results)
        return state, carries, tick, stacked, np.stack(acks), np.stack(profs)

    # ------------------------------------------------------------------
    def boot(self, state) -> None:
        """Init phase: make the state and per-opcode carries resident on
        ``device``. Tensors already there are adopted, not copied (the
        serving engine's weights are never duplicated); carry templates
        are cloned so runtimes booted from one template never share it."""
        with self.tracker.phase("init"):
            dev = self.device
            self._state = tree_map(lambda t: t.to(dev), state)
            if self.mesh is not None:
                self._state = _place(self._state, self._state_shardings)
            self._carries = [tree_map(lambda x: x.to(dev).clone(), tmpl)
                             for tmpl in self._carry_templates]
            self._result_template = tree_map(lambda t: t.to(dev),
                                             self._result_template)
            if self._profile is None:
                self._profile = self.telemetry is not None
            self._tick = 0 if self._profile else None
            self._booted = True
        self.status = mb.THREAD_NOP

    # ------------------------------------------------------------------
    @property
    def booted(self) -> bool:
        return self._booted

    def _record_event(self):
        """Mark the end of the work just enqueued (CUDA only)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def _desc_fields(desc) -> tuple:
        """(request_id, opcode, chunk, n_chunks, encoded) from either a
        WorkDescriptor or an encoded vector — host-side ints, read once."""
        if isinstance(desc, mb.WorkDescriptor):
            return (desc.request_id, desc.opcode, desc.chunk,
                    desc.n_chunks, None)
        enc = np.asarray(desc, np.int32)
        return (int(enc[mb.W_REQID]), int(enc[mb.W_OPCODE]),
                int(enc[mb.W_CHUNK]), int(enc[mb.W_NCHUNKS]), enc)

    def _stage_next(self, rid: int, chunk: int, n_chunks: int,
                    dvec) -> None:
        """Double buffer: stage the NEXT chunk's descriptor while the
        current chunk runs. Bounded by ``staged_cap``; eviction takes
        non-live entries first and only then the oldest LIVE entry — never
        the one just staged."""
        if n_chunks <= chunk + 1 or self._staged_cap <= 0:
            return
        just_staged = (rid, chunk + 1)
        nxt = np.array(dvec, np.int32)
        nxt[mb.W_CHUNK] += 1
        self._staged[just_staged] = nxt
        self._live_rids.add(rid)
        while len(self._staged) > self._staged_cap:
            keys = [k for k in self._staged if k != just_staged]
            if not keys:
                break
            stale = [k for k in keys if k[0] not in self._live_rids]
            self._staged.pop(stale[0] if stale else keys[0])

    def trigger(self, desc) -> None:
        """Send one mailbox descriptor (async — returns at enqueue)."""
        if not self._booted:
            raise RuntimeError("boot() first")
        if self.inflight >= self.max_inflight:
            raise RuntimeError(
                f"in-flight pipeline full (max_inflight={self.max_inflight});"
                " retire with wait()/poll() first")
        rid, opcode, chunk, n_chunks, enc = self._desc_fields(desc)
        with self.tracker.phase("trigger"), \
                span(lambda: self._span_name("trigger", (desc,))):
            dvec = self._staged.pop((rid, chunk), None)
            if dvec is not None:
                self.staged_hits += 1          # served from the buffer
            else:
                if chunk > 0:
                    # a mid-item re-trigger whose staged entry was evicted
                    # (or staging is capped off)
                    self.staged_misses += 1
                dvec = enc if enc is not None else desc.encode()
            self._stage_next(rid, chunk, n_chunks, dvec)
            prof = None
            if self._profile:
                (self._state, self._carries, self._tick, result, from_gpu,
                 prof) = self._lk_step_prof(
                    self._state, self._carries, self._tick, dvec)
            else:
                self._state, self._carries, result, from_gpu = \
                    self._lk_step(self._state, self._carries, dvec)
            self._inflight.append(_Block(result, from_gpu, 1, False,
                                         prof=prof,
                                         t_trigger_us=now_us(),
                                         event=self._record_event(),
                                         descs=desc))
        self.tracker.record_depth(self.inflight)
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_RT_TRIGGER, cluster=self.telemetry_cluster,
                request_id=rid, opcode=opcode, chunk=chunk,
                depth=self.inflight)
        self.status = mb.THREAD_WORKING
        self.steps += 1

    def trigger_many(self, descs) -> int:
        """Batched doorbell: issue N descriptors as ``ceil(N/max_steps)``
        rings (ONE when ``N <= max_steps``), each one multi-step loop and
        one recorded event. Items retire through ``wait()``/``poll()`` in
        issue order, exactly as N sequential ``trigger()`` calls would;
        returns N."""
        if not self._booted:
            raise RuntimeError("boot() first")
        descs = list(descs)
        if not descs:
            return 0
        if self.inflight + len(descs) > self.max_inflight:
            raise RuntimeError(
                f"batch of {len(descs)} exceeds pipeline capacity "
                f"(max_inflight={self.max_inflight}, "
                f"inflight={self.inflight})")
        for base in range(0, len(descs), self.max_steps):
            block = descs[base:base + self.max_steps]
            ring = mb.descriptor_ring(block, self.max_steps)
            with self.tracker.phase("trigger"), \
                    span(lambda: self._span_name("trigger", block)):
                profs = None
                if self._profile:
                    (self._state, self._carries, self._tick, results, acks,
                     profs) = self._lk_multi_step_prof(
                        self._state, self._carries, self._tick, ring)
                else:
                    self._state, self._carries, results, acks = \
                        self._lk_multi_step(self._state, self._carries, ring)
                self._inflight.append(
                    _Block(results, acks, len(block), True, prof=profs,
                           t_trigger_us=now_us(),
                           event=self._record_event(), descs=block))
            self.doorbells += 1
            self.batched_steps += len(block)
            self.steps += len(block)
            self.tracker.record_depth(self.inflight)
            if self.telemetry is not None:
                # one batch-stamped event per doorbell
                rid, opcode, chunk, _, _ = self._desc_fields(block[0])
                self.telemetry.emit(
                    EV_RT_TRIGGER, cluster=self.telemetry_cluster,
                    request_id=rid, opcode=opcode, chunk=chunk,
                    depth=self.inflight, batch=len(block))
        self.status = mb.THREAD_WORKING
        return len(descs)

    def wait(self):
        result, from_gpu = super().wait()
        if self._live_rids and \
                int(from_gpu[mb.W_STATUS]) == mb.THREAD_FINISHED:
            # the item is done: its rid leaves the live set and any
            # still-staged next-chunk entries become eviction fodder
            rid = int(from_gpu[mb.W_REQID])
            if rid in self._live_rids:
                self._live_rids.discard(rid)
                for k in [k for k in self._staged if k[0] == rid]:
                    del self._staged[k]
        return result, from_gpu

    # ------------------------------------------------------------------
    @property
    def state(self):
        return self._state

    def update_state(self, new_state) -> None:
        """Public state replacement. In-place updates of ``self.state``
        made on the runtime's stream need no call: they are ordered after
        every step already enqueued there."""
        if not self._booted:
            raise RuntimeError("boot() first")
        self._state = new_state

    def dispose(self) -> None:
        """Release device state (paper: Dispose phase). Waiting for the
        in-flight steps is deferred to :func:`reap_deferred` (run inline
        past ``_DEFERRED_CAP`` pending teardowns)."""
        with self.tracker.phase("dispose"):
            if self._inflight or self._state is not None:
                _DEFERRED_TEARDOWN.append(
                    (list(self._inflight), (self._state, self._carries)))
            self._inflight.clear()
            self._oldest_ready = False
            self._staged.clear()
            self._live_rids.clear()
            self._state = None
            self._carries = None
            self._tick = None
            self._booted = False
        self.status = mb.THREAD_EXIT
        if len(_DEFERRED_TEARDOWN) > _DEFERRED_CAP:
            reap_deferred()


class TraditionalRuntime:
    """The paper's baseline: every work item pays full launch cost.

    Mirrors a per-call CUDA kernel launch: the state lives on the HOST and
    is re-staged host→device on every call (the 'CUDA Alloc/Spawn/Wait/
    Dispose' arm), then the result waits for the device and the new state
    is copied back. Work fns are legacy two-argument ``fn(state, desc) ->
    (state, result)`` (a carry template entry is ignored: the per-call
    baseline has nothing persistent to thread); ``desc`` is a host int32
    row, as for ``PersistentRuntime``. ``device`` defaults to ``"cuda"`` and
    raises when CUDA is absent.
    """

    def __init__(self, work_fns, result_template,
                 tracker: Optional[WcetTracker] = None, device="cuda"):
        self.device = check_device(device)
        self._fns = {entry[0]: entry[1] for entry in work_fns}
        self._result_template = result_template
        self.tracker = tracker or WcetTracker("traditional")
        self._host_state = None

    def boot(self, state) -> None:
        with self.tracker.phase("init"):
            # keep state HOST-side, re-staged per call like kernel arguments
            self._host_state = tree_map(lambda t: t.detach().cpu().clone(),
                                        state)

    def launch(self, name: str, desc):
        desc = mb.encode_any(desc)
        with self.tracker.phase("trigger"):
            dstate = tree_map(lambda t: t.to(self.device, copy=True),
                              self._host_state)             # full re-staging
            new_state, result = self._fns[name](dstate, desc)
        with self.tracker.phase("wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._host_state = tree_map(lambda t: t.cpu(), new_state)
        return result

    def dispose(self) -> None:
        with self.tracker.phase("dispose"):
            self._host_state = None
