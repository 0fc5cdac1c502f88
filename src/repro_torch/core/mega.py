"""MegaRuntime — the dispatcher's megakernel fast path, ported to PyTorch
(counterpart of ``repro.core.mega``).

Where ``PersistentRuntime`` runs the work table step by step from the host,
the MegaRuntime hands the device a whole descriptor queue per launch: the
drain megakernel of ``repro_torch.kernels.persistent`` (K1, or K2 with the
flight recorder) loops over the device-resident queue under a
``QCTRL_WIDTH`` control vector (head / tail / stop — see ``core.mailbox``),
executes every row for exactly ONE chunk (the per-descriptor quantum),
threads the resumable reduce carry across rows AND launches, and stamps
per-row ``from_gpu`` words (FINISHED / PREEMPTED / NOP + request id + chunk
progress) that the host's zero-readback retire path — and the dispatcher's
chunk-boundary preemption on top of it — consume without any per-chunk
host round trip. The drained-work count rides the control output's
``QC_DRAINED`` word (``work_drained``), keeping the ack rows byte-identical
to the scan path's.

The work table is FIXED: the drain kernel's tile-op opcodes
(``TILE_OP_NAMES`` order) over ``{"ws": (nbuf, TILE, TILE) f32}``.
``LkSystem(runtime="mega")`` validates registered class names against that
order at boot; ``trigger()`` is the one-row fallback.

What changed from the reference, and why:

* Each runtime owns a CUDA stream. Its workspace, carry and tick are
  allocated under that stream; its copies, its launches and the event that
  ``ready()`` queries go on it, so clusters carved on one card overlap as
  the reference's clusters on separate devices do.
* ``trigger_many`` writes each block's ring and control vector into ONE
  pinned host buffer and copies it host→device asynchronously on the
  runtime's stream. A fresh buffer per launch, held by the block until it
  retires, so no later launch can overwrite descriptors whose copy has not
  run yet.
* Workspace, carry and tick are updated in place by the kernel (the
  reference aliases them input→output). The prepared launch state of a
  boot — the kernel entry point, with its library built and loaded on
  CUDA — is what the shared ``ExecutableCache`` holds.
* On the CPU (``device="cpu"``, as the tests run it) the same wrappers take
  the kernels' plain versions; the default device is ``"cuda"``, and it
  raises where CUDA is absent.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Optional

import torch

from repro_torch.core import mailbox as mb
from repro_torch.core import persistent as P
from repro_torch.core.persistent import (ExecutableCache, _Block,
                                         _PipelinedRuntime, check_device)
from repro_torch.core.telemetry import EV_RT_TRIGGER, TraceCollector
from repro_torch.core.telemetry.events import now_us
from repro_torch.core.wcet import WcetTracker
from repro_torch.kernels.persistent import kernel as K
from repro_torch.kernels.persistent.ops import TILE_OP_NAMES, tile_work_table

__all__ = ["MegaRuntime", "mega_work_classes", "TILE_OP_NAMES"]


class MegaRuntime(_PipelinedRuntime):
    """One persistent megakernel worker (paper: one block per SM).

    Satisfies ``RuntimeProtocol``: ``trigger``/``trigger_many`` enqueue
    drain launches (async — one launch per ``max_steps``-row queue),
    ``ready``/``wait``/``poll`` retire items strictly in issue order with
    one bulk readback per launch. ``max_steps`` is the device queue
    capacity Q; ``boot(state)`` takes the tile state tree ``{"ws": (nbuf,
    TILE, TILE) f32}`` (``tile_state()``) and prepares the drain launch
    once (a shared ``exec_cache`` turns recarve reboots into dictionary
    hits). ``device`` is where the workspace lives and the kernels run.
    """

    def __init__(self, *, tracker: Optional[WcetTracker] = None,
                 max_inflight: int = 2,
                 max_steps: int = 8,
                 telemetry: Optional[TraceCollector] = None,
                 exec_cache: Optional[ExecutableCache] = None,
                 profile: Optional[bool] = None,
                 device="cuda"):
        super().__init__(tracker=tracker, max_inflight=max_inflight,
                         telemetry=telemetry, name="mega")
        if max_steps < 1:
            raise ValueError("max_steps must be >= 1")
        self.device = check_device(device)
        self.work_names = list(TILE_OP_NAMES)
        self.max_steps = int(max_steps)
        self._exec_cache = exec_cache
        # flight recorder (None = auto: on exactly when telemetry is
        # attached): boots the profiled drain kernel, whose profile rows and
        # persistent tick join the bulk readback; acks stay byte-identical
        self._profile = profile
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._drain = None
        self._ws = None                # (1, NBUF, TILE, TILE) f32
        self._carry = None             # (1, 1) f32 — device-resident
        self._tick = None              # (1, 1) i32 — logical-tick counter
        # control outputs pending readback, FIFO-aligned with _inflight:
        # QC_DRAINED accumulates into work_drained at block retirement
        self._ctrl_pending: deque = deque()
        self.doorbells = 0             # drain launches issued
        self.batched_steps = 0         # descriptors issued through them
        self.work_drained = 0          # device-stamped QC_DRAINED total

    # ------------------------------------------------------------------
    @property
    def booted(self) -> bool:
        return self._drain is not None

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    def boot(self, state) -> None:
        """Init phase: prepare the drain launch and make the tile
        workspace, the reduce carry and the tick device-resident."""
        with self.tracker.phase("init"):
            ws = torch.as_tensor(state["ws"])
            if ws.dim() != 3 or tuple(ws.shape[1:]) != (K.TILE, K.TILE):
                raise ValueError(
                    "MegaRuntime state must be {'ws': (nbuf, "
                    f"{K.TILE}, {K.TILE}) f32}}, got ws{tuple(ws.shape)}")
            if self._profile is None:
                self._profile = self.telemetry is not None
            dev = self.device
            if self._stream is not None:
                # the copy below may read a tensor made on the caller's stream
                self._stream.wait_stream(torch.cuda.current_stream(dev))
            with self._on_stream():
                # a copy: the kernel writes the workspace in place
                ws = ws.to(dev, torch.float32, copy=True)[None].contiguous()
                carry = torch.zeros((1, 1), dtype=torch.float32, device=dev)
                tick = torch.zeros((1, 1), dtype=torch.int32, device=dev) \
                    if self._profile else None
            Q = self.max_steps

            def prepare():
                if dev.type == "cuda":
                    K.library()            # build and load before any launch
                return K.persistent_drain_prof if self._profile \
                    else K.persistent_drain

            key = ("mega_drain_prof" if self._profile else "mega_drain",
                   (tuple(ws.shape), str(ws.dtype)), Q, dev.type,
                   mb.DESC_WIDTH, mb.QCTRL_WIDTH)
            if self._exec_cache is not None:
                self._drain = self._exec_cache.get_or_compile(key, prepare)
            else:
                self._drain = prepare()
            self._ws = ws
            self._carry = carry
            self._tick = tick
        self.status = mb.THREAD_NOP

    # ------------------------------------------------------------------
    def trigger(self, desc) -> None:
        """Per-item fallback: a one-row queue through the same drain
        launch (async — returns at enqueue)."""
        self.trigger_many([desc])

    def _stage(self, block) -> tuple:
        """Ring + control vector of one launch in ONE host buffer (pinned
        on CUDA), copied to the device in one transfer on the runtime's
        stream. Returns (host buffer, device ring, device ctrl)."""
        Q, W = self.max_steps, mb.DESC_WIDTH
        host = torch.empty((Q * W + mb.QCTRL_WIDTH,), dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        mb.descriptor_ring(block, Q, out=buf[:Q * W].reshape(Q, W))
        buf[Q * W:] = mb.queue_control(tail=len(block))
        dev = host.to(self.device, non_blocking=True) \
            if self.device.type == "cuda" else host
        return (host, dev[:Q * W].view(1, Q, W),
                dev[Q * W:].view(1, mb.QCTRL_WIDTH))

    def _record_event(self):
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def trigger_many(self, descs) -> int:
        """Append a coalesced batch into the device queue: ONE ring +
        control transfer and ONE drain launch per ``max_steps`` rows — the
        device loops the descriptors without any per-chunk host round
        trip. Items retire through ``wait()``/``poll()`` in issue order;
        returns the number of descriptors issued."""
        if self._drain is None:
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
            with self.tracker.phase("trigger"), self._on_stream():
                host, ring, ctrl = self._stage(block)
                prof = None
                if self._profile:
                    (_, _, acks, results, ctrl_out, prof, _) = self._drain(
                        ctrl, ring, self._ws, self._carry, self._tick)
                    prof = prof[0]
                else:
                    _, _, acks, results, ctrl_out = self._drain(
                        ctrl, ring, self._ws, self._carry)
                # async dispatch: return as soon as the drain is enqueued
                blk = _Block(results[0], acks[0], len(block), True,
                             prof=prof, t_trigger_us=now_us(),
                             event=self._record_event(), held=host)
                self._inflight.append(blk)
                self._ctrl_pending.append((blk, ctrl_out))
            self.doorbells += 1
            self.batched_steps += len(block)
            self.steps += len(block)
            self.tracker.record_depth(self.inflight)
            if self.telemetry is not None:
                # one batch-stamped event per drain launch — nothing is
                # read back from the device on the trigger path
                rid, opcode, chunk, _, _ = \
                    P.PersistentRuntime._desc_fields(block[0])
                self.telemetry.emit(
                    EV_RT_TRIGGER, cluster=self.telemetry_cluster,
                    request_id=rid, opcode=opcode, chunk=chunk,
                    depth=self.inflight, batch=len(block))
        self.status = mb.THREAD_WORKING
        return len(descs)

    def _on_block_retired(self, blk: _Block) -> None:
        """A drain launch fully retired: fold its device-stamped
        QC_DRAINED work count into ``work_drained`` (the launch is done,
        so this readback waits for nothing)."""
        if self._ctrl_pending and self._ctrl_pending[0][0] is blk:
            _, ctrl_out = self._ctrl_pending.popleft()
            self.work_drained += int(ctrl_out[0, mb.QC_DRAINED])

    # ------------------------------------------------------------------
    @property
    def state(self):
        return self._ws

    def dispose(self) -> None:
        """Release device state — O(µs); waiting for in-flight launches is
        deferred to ``reap_deferred()`` exactly like ``PersistentRuntime``."""
        with self.tracker.phase("dispose"):
            if self._inflight or self._ws is not None:
                P._DEFERRED_TEARDOWN.append(
                    (list(self._inflight),
                     (self._ws, self._carry, self._tick)))
            self._inflight.clear()
            self._oldest_ready = False
            self._ctrl_pending.clear()
            self._ws = None
            self._carry = None
            self._tick = None
            self._drain = None
        self.status = mb.THREAD_EXIT
        if len(P._DEFERRED_TEARDOWN) > P._DEFERRED_CAP:
            P.reap_deferred()


def mega_work_classes(**overrides) -> list:
    """``WorkClass`` declarations matching the drain kernel's opcode
    table, in registration order — boot ``LkSystem(runtime="mega")`` from
    these, or the default scan runtime from the SAME list (the fns are
    ``tile_work_table()``'s scan-path twins) for an apples-to-apples
    comparison. ``overrides`` maps a class name to WorkClass field
    overrides, e.g. ``reduce={"chunk_us": 50.0}``."""
    from repro_torch.core.system import WorkClass   # local: import cycle
    unknown = set(overrides) - set(TILE_OP_NAMES)
    if unknown:
        raise KeyError(f"unknown tile op(s): {sorted(unknown)}")
    out = []
    for entry in tile_work_table():
        name, fn = entry[0], entry[1]
        carry = entry[2] if len(entry) > 2 else None
        out.append(WorkClass(name, fn=fn, carry=carry,
                             **overrides.get(name, {})))
    return out
