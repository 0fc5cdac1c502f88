"""LightKernel dual-mailbox protocol (paper Table I) — the PyTorch port.

A copy of ``repro.core.mailbox``: every constant, the descriptor layout and
the ``Mailbox`` bookkeeping are identical (a test holds them equal); only
``Mailbox.device_view`` differs, returning a torch tensor.

Each cluster owns a mailbox pair:
  * ``to_gpu``   — host → device: NOP / EXIT / WORK(+work id)
  * ``from_gpu`` — device → host: INIT / FINISHED / WORKING

Statuses keep the paper's exact values. On the device the mailbox is a small int32
descriptor vector transferred once per step (the paper was likewise forced to
transfer the full mailbox to dodge the PCIe small-transfer pathology, §II-D).

Descriptor layout (DESC_WIDTH int32 words per cluster):
  [0] status word        (THREAD_NOP / THREAD_EXIT / THREAD_WORK + work_id)
  [1] opcode             (index into the runtime's registered work table)
  [2] arg0  [3] arg1     (work-specific, e.g. slot index / token count)
  [4] seq_len
  [5] request_id
  [6] deadline_lo  [7] deadline_hi   (u64 microseconds, split)
  [8] chunk  [9] n_chunks            (resumable-chunk progress words)

Chunked work: an item with ``n_chunks > 1`` is a SEQUENCE of resumable
chunks — each chunk is one mailbox trigger, and the device answers
``THREAD_PREEMPTED`` (instead of ``THREAD_FINISHED``) when the chunk
completed but the item has more chunks to run. The host requeues the
remainder (``WorkDescriptor.advance()``) through the normal scheduling
lane, which is what lets a HIGH-criticality arrival slot in between two
chunks of a long LOW item instead of waiting out its full WCET.

Descriptor ring (batched doorbells): ``descriptor_ring(descs, capacity)``
stacks up to ``capacity`` descriptors into ONE ``(capacity, DESC_WIDTH)``
int32 block — the single transfer unit of a batched doorbell. Rows past
``len(descs)`` are NOP-padded, so one compiled multi-step program serves
every batch size 1..capacity without reshapes or recompiles. The device
answers with an ACK BLOCK of the same shape: row *i* is the ``from_gpu``
vector of step *i* (``W_STATUS`` = FINISHED/PREEMPTED per row, NOP for
padding rows), which the host materializes with one readback and retires
row by row. ``post_many`` records a whole ring's work rows in the
in-flight FIFO in one call, keeping failure-replay ordering identical to
sequential posts.

Queue control (megakernel dispatch): the mega runtime goes one step
further and hands the device the WHOLE ring plus a small control vector
(``QCTRL_WIDTH`` int32 words) so the drain loop itself runs device-side:
  [QC_HEAD]    first descriptor row to execute (inclusive)
  [QC_TAIL]    one past the last row to execute (exclusive)
  [QC_STOP]    nonzero = drain nothing this launch (quiesce/EXIT path)
  [QC_DRAINED] device-stamped: number of work rows actually executed
The worker loops rows ``[head, tail)``, executes each work row for ONE
chunk (the per-descriptor quantum), and stamps a per-row from_gpu ack
(status / request id / chunk progress) that the zero-readback retire
path consumes. ``QC_DRAINED`` carries the aggregate work count so ack
rows stay byte-identical to the scan path's per-step from_gpu records.

Flight-recorder profile rows (device-side instrumentation): the profiled
kernel variants append a PARALLEL ``(Q, PROF_WIDTH)`` int32 buffer — the
ack rows stay byte-identical to the bare path — where row *i* records the
device-side view of descriptor *i*'s chunk:
  [P_TICK0]  begin tick (monotone per-cluster logical quantum counter,
             threaded launch-to-launch through ``input_output_aliases``
             like the carry; +1 per executed row)
  [P_TICK1]  end tick (== begin + 1 for one chunk quantum)
  [P_ROW]    per-launch row counter: how many work rows this launch had
             already executed when this one began (0, 1, 2, ...)
  [P_QDEPTH] queue occupancy at pop: work rows still waiting (inclusive
             of this one) when the worker picked the row up
  [P_OPCODE] the executed opcode    [P_REQID] the request id
  [P_ACTIVE] 1 = this row executed, 0 = padding/skipped (other words
             are undefined when 0)                      [P_PAD] reserved
Ticks are LOGICAL (no wall clock exists device-side): the host maps them
affinely into each launch's host window via a per-launch anchor
(trigger -> materialize) and re-emits ``chunk_retire`` spans with
``source=device`` (see repro_torch.core.telemetry).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace

import numpy as np
import torch

# --- paper Table I: persistent thread statuses --------------------------------
THREAD_INIT = 0        # from_GPU
THREAD_FINISHED = 1    # from_GPU
THREAD_WORKING = 2     # from_GPU
THREAD_PREEMPTED = 3   # from_GPU: chunk done, item has chunks left
THREAD_NOP = 4         # both directions
THREAD_EXIT = 8        # to_GPU
THREAD_WORK = 16       # to_GPU: values >= 16 encode 16 + work_id

DESC_WIDTH = 10

# descriptor word indices
(W_STATUS, W_OPCODE, W_ARG0, W_ARG1, W_SEQLEN, W_REQID, W_DL_LO, W_DL_HI,
 W_CHUNK, W_NCHUNKS) = range(10)

# --- megakernel queue-control words (module docstring, "Queue control") ------
QCTRL_WIDTH = 4
QC_HEAD, QC_TAIL, QC_STOP, QC_DRAINED = range(QCTRL_WIDTH)

# --- flight-recorder profile words (module docstring, "Flight-recorder") -----
PROF_WIDTH = 8
(P_TICK0, P_TICK1, P_ROW, P_QDEPTH, P_OPCODE, P_REQID, P_ACTIVE,
 P_PAD) = range(PROF_WIDTH)


def queue_control(tail: int, head: int = 0, stop: int = 0) -> np.ndarray:
    """The ``(QCTRL_WIDTH,)`` int32 control vector of one drain launch."""
    ctrl = np.zeros(QCTRL_WIDTH, np.int32)
    ctrl[QC_HEAD] = head
    ctrl[QC_TAIL] = tail
    ctrl[QC_STOP] = stop
    return ctrl


# Effective deadline of deadline-free work. Descriptors encode "no deadline"
# as deadline_us == 0 (the wire format's natural zero); every host-side
# ordering comparison instead uses this named sentinel so deadline-free items
# sort after ANY real deadline. Shared by the dispatcher, the sched policies,
# and descriptor decoding — never compare against a bare 2**62 again.
NO_DEADLINE = 2**62


@dataclass(frozen=True)
class WorkDescriptor:
    work_id: int = 0
    opcode: int = 0
    arg0: int = 0
    arg1: int = 0
    seq_len: int = 0
    request_id: int = 0
    deadline_us: int = 0           # absolute deadline, microseconds
    chunk: int = 0                 # resume point: next chunk to execute
    n_chunks: int = 1              # 1 = atomic (the pre-chunking behaviour)

    @property
    def effective_deadline_us(self) -> int:
        """The deadline as an ordering key: ``NO_DEADLINE`` when unset."""
        return self.deadline_us or NO_DEADLINE

    @property
    def chunked(self) -> bool:
        return self.n_chunks > 1

    @property
    def remaining_chunks(self) -> int:
        """Chunks left to run, this one included (>= 1 for atomic work)."""
        return max(self.n_chunks - self.chunk, 1)

    def advance(self) -> "WorkDescriptor":
        """The remainder descriptor after this chunk completes — what the
        dispatcher requeues (or re-triggers) at the preemption point."""
        return replace(self, chunk=self.chunk + 1)

    def encode(self) -> np.ndarray:
        d = np.zeros(DESC_WIDTH, np.int32)
        d[W_STATUS] = THREAD_WORK + self.work_id
        d[W_OPCODE] = self.opcode
        d[W_ARG0] = self.arg0
        d[W_ARG1] = self.arg1
        d[W_SEQLEN] = self.seq_len
        d[W_REQID] = self.request_id
        d[W_DL_LO] = np.uint32(self.deadline_us & 0xFFFFFFFF).view(np.int32)
        d[W_DL_HI] = np.uint32((self.deadline_us >> 32) & 0xFFFFFFFF).view(np.int32)
        d[W_CHUNK] = self.chunk
        d[W_NCHUNKS] = self.n_chunks
        return d


def nop_descriptor() -> np.ndarray:
    d = np.zeros(DESC_WIDTH, np.int32)
    d[W_STATUS] = THREAD_NOP
    return d


def encode_any(desc) -> np.ndarray:
    """Encoded ``(DESC_WIDTH,)`` int32 vector from either form."""
    if isinstance(desc, WorkDescriptor):
        return desc.encode()
    return np.asarray(desc, np.int32)


def descriptor_ring(descs, capacity: int, out=None) -> np.ndarray:
    """Stack descriptors into one ``(capacity, DESC_WIDTH)`` NOP-padded
    ring — the transfer unit of a batched doorbell (module docstring).
    ``out`` reuses a previously allocated ring buffer."""
    n = len(descs)
    if n > capacity:
        raise ValueError(f"{n} descriptors exceed ring capacity {capacity}")
    if out is None or out.shape != (capacity, DESC_WIDTH):
        out = np.empty((capacity, DESC_WIDTH), np.int32)
    for i, d in enumerate(descs):
        out[i] = encode_any(d)
    if n < capacity:
        out[n:] = nop_descriptor()
    return out


def exit_descriptor() -> np.ndarray:
    d = np.zeros(DESC_WIDTH, np.int32)
    d[W_STATUS] = THREAD_EXIT
    return d


def decode(desc) -> WorkDescriptor:
    d = np.asarray(desc)
    status = int(d[W_STATUS])
    work_id = status - THREAD_WORK if status >= THREAD_WORK else 0
    dl = (np.uint64(np.uint32(d[W_DL_HI])) << np.uint64(32)) | \
        np.uint64(np.uint32(d[W_DL_LO]))
    return WorkDescriptor(
        work_id=work_id, opcode=int(d[W_OPCODE]), arg0=int(d[W_ARG0]),
        arg1=int(d[W_ARG1]), seq_len=int(d[W_SEQLEN]),
        request_id=int(d[W_REQID]), deadline_us=int(dl),
        chunk=int(d[W_CHUNK]), n_chunks=max(int(d[W_NCHUNKS]), 1))


def status_of(desc) -> int:
    s = int(np.asarray(desc)[W_STATUS])
    return s if s < THREAD_WORK else THREAD_WORK


def is_work(desc) -> bool:
    return int(np.asarray(desc)[W_STATUS]) >= THREAD_WORK


class Mailbox:
    """Host-side dual mailbox for ``n_clusters`` persistent workers.

    Besides the latest posted/acked descriptor pair per cluster, the mailbox
    keeps the FIFO of *in-flight* work descriptors (posted WORK, not yet
    acked). This is the host's authoritative record of what a cluster is
    holding mid-pipeline: on cluster failure the dispatcher replays exactly
    ``pending(cluster)`` elsewhere (descriptors are pure functions of request
    state — idempotent replay).
    """

    def __init__(self, n_clusters: int):
        self.n = n_clusters
        self.to_gpu = np.tile(nop_descriptor(), (n_clusters, 1))
        self.from_gpu = np.zeros((n_clusters, DESC_WIDTH), np.int32)
        self.from_gpu[:, W_STATUS] = THREAD_INIT
        self.inflight: list[deque] = [deque() for _ in range(n_clusters)]
        # acks whose request_id did not match the oldest pending
        # descriptor (or that had no pending record at all): the replay
        # record is left untouched and the discrepancy is counted here
        # instead of silently corrupting what a failure replay would use
        self.ack_mismatches = 0

    def grow(self, n_clusters: int) -> None:
        """Extend capacity to ``n_clusters`` rows (late cluster register,
        recarve generation bump). THE invariant every resize path leans
        on — heal-loop and elastic recarve alike — is checked here, in
        the one place capacity changes: existing clusters' in-flight
        replay records (and their order) survive the bump untouched.
        Losing one would turn the next failure replay into a lost
        ticket."""
        extra = n_clusters - self.n
        if extra <= 0:
            return
        before = [list(q) for q in self.inflight]
        self.to_gpu = np.vstack([self.to_gpu,
                                 np.tile(nop_descriptor(), (extra, 1))])
        fg = np.zeros((extra, DESC_WIDTH), np.int32)
        fg[:, W_STATUS] = THREAD_INIT
        self.from_gpu = np.vstack([self.from_gpu, fg])
        self.inflight.extend(deque() for _ in range(extra))
        self.n = n_clusters
        assert all(len(q) == len(b) and
                   all(d is e for d, e in zip(q, b))
                   for q, b in zip(self.inflight, before)), \
            "Mailbox.grow() must preserve in-flight replay records"

    def post(self, cluster: int, desc: np.ndarray) -> None:
        self.to_gpu[cluster] = desc
        if is_work(desc):
            self.inflight[cluster].append(np.array(desc, np.int32))

    def post_many(self, cluster: int, descs) -> int:
        """Record one batched doorbell: every work row enters the cluster's
        in-flight FIFO in ring order (identical replay semantics to N
        sequential ``post`` calls); ``to_gpu`` holds the LAST row, matching
        what a sequence of posts would leave visible. Returns the number of
        work rows recorded."""
        posted = 0
        for d in descs:
            d = encode_any(d)
            self.to_gpu[cluster] = d
            if is_work(d):
                self.inflight[cluster].append(np.array(d, np.int32))
                posted += 1
        return posted

    def post_all(self, desc: np.ndarray) -> None:
        desc = np.asarray(desc)
        for c in range(self.n):
            self.post(c, desc)

    def ack(self, cluster: int, status: int, request_id: int = 0,
            chunk: int = 0) -> None:
        """Record a device answer and retire the oldest in-flight record.

        Preemption-aware: ``THREAD_PREEMPTED`` retires the CHUNK's record
        exactly like ``THREAD_FINISHED`` retires an atomic item's — the
        remainder is a fresh descriptor the dispatcher posts separately.
        The acked ``request_id`` is validated against the oldest pending
        descriptor; a mismatch leaves the replay record untouched and is
        counted on ``ack_mismatches``.
        """
        self.from_gpu[cluster, W_STATUS] = status
        self.from_gpu[cluster, W_REQID] = request_id
        self.from_gpu[cluster, W_CHUNK] = chunk
        q = self.inflight[cluster]
        if q and int(q[0][W_REQID]) == request_id:
            q.popleft()
        else:
            self.ack_mismatches += 1
        if not q:
            self.to_gpu[cluster] = nop_descriptor()

    def pending(self, cluster: int) -> list[WorkDescriptor]:
        """Decoded in-flight descriptors of one cluster, oldest first."""
        return [decode(d) for d in self.inflight[cluster]]

    def depth(self, cluster: int) -> int:
        return len(self.inflight[cluster])

    def clear(self, cluster: int) -> None:
        """Drop a failed cluster's record (after the replay is captured)."""
        self.inflight[cluster].clear()
        self.to_gpu[cluster] = nop_descriptor()
        self.from_gpu[cluster, W_STATUS] = THREAD_EXIT

    def cluster_status(self, cluster: int) -> int:
        return int(self.from_gpu[cluster, W_STATUS])

    def device_view(self, cluster: int, device="cuda") -> torch.Tensor:
        """The (coalesced, full-width) transfer unit for one trigger, as an
        int32 tensor on ``device``."""
        return torch.tensor(self.to_gpu[cluster], dtype=torch.int32,
                            device=device)
