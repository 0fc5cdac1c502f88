"""Persistent tile-op workers — the drain megakernel (K1), its flight-recorder
variant (K2) and the legacy work-queue executor (K3): the Hopper kernels'
wrappers and their plain PyTorch versions.

Port of ``repro.kernels.persistent.kernel`` (``_drain_kernel``,
``_drain_kernel_prof``, ``_executor_kernel``). ``persistent_drain``,
``persistent_drain_prof`` and ``persistent_execute`` launch the CUDA kernels
in ``csrc/persistent.cu`` for CUDA tensors and use the plain versions
(``drain_plain``, ``execute_plain``) for CPU tensors — the only case in which
they do. On a CUDA tensor they launch the kernel or raise.

Where the reference's numpy oracle and its Pallas kernel differ, both
versions here follow the kernel: a tile index ``i`` (``dst``, ``a`` or
``b``) becomes ``i + nbuf`` when negative and is then clamped to
``[0, nbuf - 1]``; ``dst``/``a`` unpack with floor division. The reference
aliases workspace, carry and tick input -> output; here they are updated in
place and returned.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.mailbox import (DESC_WIDTH, P_ACTIVE, P_OPCODE,
                                      P_QDEPTH, P_REQID, P_ROW, P_TICK0,
                                      P_TICK1, PROF_WIDTH, QC_DRAINED,
                                      QC_HEAD, QC_STOP, QC_TAIL, QCTRL_WIDTH,
                                      THREAD_FINISHED, THREAD_NOP,
                                      THREAD_PREEMPTED, THREAD_WORK, W_ARG0,
                                      W_ARG1, W_CHUNK, W_NCHUNKS, W_OPCODE,
                                      W_REQID, W_STATUS)
from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "persistent.cu"

TILE = 128

OP_NOP = 0
OP_MATMUL = 1
OP_ADD = 2
OP_SCALE = 3
OP_RELU = 4
OP_COPY = 5
NUM_OPS = 6

# drain-path extension: a chunk-carrying reduction (carry += sum(ws[a]),
# result = carry); the legacy executor keeps its 6-op table
OP_REDUCE = 6
NUM_DRAIN_OPS = 7

# descriptor arg packing for tile ops: arg0 = dst*256 + a, arg1 = b or
# fixed-point scale (<<16)
SCALE_SHIFT = 16


def pack_args(dst: int, a: int, b: int = 0) -> tuple[int, int]:
    return dst * 256 + a, b


def pack_scale(dst: int, a: int, scale: float) -> tuple[int, int]:
    return dst * 256 + a, int(scale * (1 << SCALE_SHIFT))


_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.persistent_drain.argtypes = [vp] * 9 + [ci, ci, ci, ci, vp]
        lib.persistent_drain.restype = ci
        lib.persistent_execute.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.persistent_execute.restype = ci
        lib.persistent_error_string.argtypes = [ci]
        lib.persistent_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions (every cluster at once, queue rows in order)
# ---------------------------------------------------------------------------

def _tile_index(i, nbuf: int):
    """The Pallas kernel's dynamic tile index: negative counts from the
    end, then clamp into ``[0, nbuf - 1]``."""
    return torch.where(i < 0, i + nbuf, i).clamp(0, nbuf - 1)


def _row(ws, cidx, desc, live, n_ops: int):
    """Run queue row ``desc`` (``(C, DESC_WIDTH)``, one per cluster) on the
    clusters where ``live`` holds, with opcodes clipped to ``[0, n_ops)``.
    Writes the workspace in place; returns, per cluster, the clipped
    opcode, whether the row wrote a tile, the sum of that tile and the sum
    of ws[a]."""
    nbuf = ws.shape[1]
    op = desc[:, W_OPCODE].clamp(0, n_ops - 1)
    packed = desc[:, W_ARG0]
    dst = _tile_index(packed >> 8, nbuf)
    a = _tile_index(packed & 255, nbuf)
    b = _tile_index(desc[:, W_ARG1], nbuf)
    A, B, D = ws[cidx, a], ws[cidx, b], ws[cidx, dst]
    scale = (desc[:, W_ARG1].float() / (1 << SCALE_SHIFT))[:, None, None]
    # candidates in opcode order MATMUL, ADD, SCALE, RELU, COPY
    cand = torch.stack([D + torch.bmm(A, B), A + B, A * scale,
                        torch.clamp(A, min=0.0), A])
    new = cand[(op - 1).clamp(0, 4), cidx]
    writes = live & (op >= OP_MATMUL) & (op <= OP_COPY)
    ws[cidx, dst] = torch.where(writes[:, None, None], new, D)
    return op, writes, new.sum(dim=(1, 2)), A.sum(dim=(1, 2))


def drain_plain(ctrl, queue, ws, carry, tick=None):
    """Plain version of K1 (``tick is None``) and K2: the drain of one
    launch. ctrl (C, QCTRL_WIDTH) i32, queue (C, Q, DESC_WIDTH) i32, ws
    (C, nbuf, TILE, TILE) f32, carry (C, 1) f32, tick (C, 1) i32; ws, carry
    and tick are updated in place. Returns (ws, carry, acks (C, Q,
    DESC_WIDTH), results (C, Q, 1), ctrl') and, with a tick, also (prof
    (C, Q, PROF_WIDTH), tick). Every cluster runs at once, row by row; the
    opcode switch is a select on the device (no host readback)."""
    C, Q, _ = queue.shape
    dev = ws.device
    i32 = dict(dtype=torch.int32, device=dev)
    acks = torch.zeros((C, Q, DESC_WIDTH), **i32)
    results = torch.zeros((C, Q, 1), dtype=torch.float32, device=dev)
    prof = torch.zeros((C, Q, PROF_WIDTH), **i32) if tick is not None \
        else None
    cidx = torch.arange(C, device=dev)
    head, tail = ctrl[:, QC_HEAD], ctrl[:, QC_TAIL]
    stop = ctrl[:, QC_STOP]
    drained = torch.zeros((C,), **i32)
    for i in range(Q):
        desc = queue[:, i]
        active = (head <= i) & (tail > i) & (stop == 0) & \
            (desc[:, W_STATUS] >= THREAD_WORK)
        op, writes, tile_sum, a_sum = _row(ws, cidx, desc, active,
                                           NUM_DRAIN_OPS)
        reduce = active & (op == OP_REDUCE)
        acc = carry[:, 0] + a_sum
        carry[:, 0] = torch.where(reduce, acc, carry[:, 0])
        results[:, i, 0] = torch.where(
            writes, tile_sum, torch.where(reduce, acc, 0.0))
        done = desc[:, W_CHUNK] + 1 >= desc[:, W_NCHUNKS].clamp(min=1)
        acks[:, i, W_STATUS] = torch.where(
            active, torch.where(done, THREAD_FINISHED, THREAD_PREEMPTED),
            THREAD_NOP).to(torch.int32)
        for w in (W_REQID, W_CHUNK, W_NCHUNKS):
            acks[:, i, w] = desc[:, w]
        act = active.to(torch.int32)
        if tick is not None:
            t0 = tick[:, 0].clone()
            prof[:, i, P_TICK0] = act * t0
            prof[:, i, P_TICK1] = act * (t0 + 1)
            prof[:, i, P_ROW] = act * drained
            prof[:, i, P_QDEPTH] = act * (tail - i)
            prof[:, i, P_OPCODE] = act * desc[:, W_OPCODE]
            prof[:, i, P_REQID] = act * desc[:, W_REQID]
            prof[:, i, P_ACTIVE] = act
            tick[:, 0] = t0 + act
        drained += act
    ctrl_out = ctrl.clone()
    ctrl_out[:, QC_DRAINED] = drained
    if tick is None:
        return ws, carry, acks, results, ctrl_out
    return ws, carry, acks, results, ctrl_out, prof, tick


def execute_plain(queue, ws):
    """Plain version of K3: every ``status >= THREAD_WORK`` row through
    the 6-op table, ws updated in place. Returns (ws, from_gpu (C,
    DESC_WIDTH)) with FINISHED and the work-row count in W_ARG0."""
    C, Q, _ = queue.shape
    cidx = torch.arange(C, device=ws.device)
    done = torch.zeros((C,), dtype=torch.int32, device=ws.device)
    for i in range(Q):
        desc = queue[:, i]
        work = desc[:, W_STATUS] >= THREAD_WORK
        _row(ws, cidx, desc, work, NUM_OPS)
        done += work.to(torch.int32)
    fromgpu = torch.zeros((C, DESC_WIDTH), dtype=torch.int32,
                          device=ws.device)
    fromgpu[:, W_STATUS] = THREAD_FINISHED
    fromgpu[:, W_ARG0] = done
    return ws, fromgpu


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(queue, ws, **small) -> None:
    dev = ws.device
    if not ws.is_cuda or queue.device != dev or \
            any(t.device != dev for t in small.values()):
        raise ValueError("queue, workspace and control tensors must lie on "
                         "one CUDA device")
    if queue.dim() != 3 or queue.shape[2] != DESC_WIDTH or \
            queue.dtype != torch.int32:
        raise ValueError(f"queue must be (C, Q, {DESC_WIDTH}) int32, got "
                         f"{tuple(queue.shape)} {queue.dtype}")
    C = queue.shape[0]
    if ws.dtype != torch.float32 or ws.dim() != 4 or ws.shape[0] != C or \
            ws.shape[2:] != (TILE, TILE) or ws.shape[1] < 1:
        raise ValueError(f"workspace must be (C, nbuf, {TILE}, {TILE}) "
                         f"float32 with C={C}, got {tuple(ws.shape)} "
                         f"{ws.dtype}")
    shapes = {"ctrl": ((C, QCTRL_WIDTH), torch.int32),
              "carry": ((C, 1), torch.float32),
              "tick": ((C, 1), torch.int32)}
    for name, t in small.items():
        shape, dtype = shapes[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("queue", queue), ("workspace", ws), *small.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = library().persistent_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _drain_launch(ctrl, queue, ws, carry, tick):
    C, Q, _ = queue.shape
    dev = ws.device
    acks = torch.empty((C, Q, DESC_WIDTH), dtype=torch.int32, device=dev)
    results = torch.empty((C, Q, 1), dtype=torch.float32, device=dev)
    ctrl_out = torch.empty((C, QCTRL_WIDTH), dtype=torch.int32, device=dev)
    prof = None if tick is None else torch.empty(
        (C, Q, PROF_WIDTH), dtype=torch.int32, device=dev)
    err = library().persistent_drain(
        ctrl.data_ptr(), queue.data_ptr(), ws.data_ptr(), carry.data_ptr(),
        None if tick is None else tick.data_ptr(), acks.data_ptr(),
        results.data_ptr(), ctrl_out.data_ptr(),
        None if prof is None else prof.data_ptr(), C, Q, ws.shape[1],
        int(tick is not None), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "persistent_drain")
    return acks, results, ctrl_out, prof


def persistent_drain(ctrl, queue, ws, carry):
    """K1: one drain launch — rows ``[head, tail)`` of each cluster's queue
    for one chunk each. Shapes as ``drain_plain``; ws and carry are updated
    in place. Returns (ws, carry, acks, results, ctrl'). CUDA tensors launch
    the kernel on the current stream (no synchronization); CPU tensors take
    the plain version. ``persistent_drain.launches`` counts launches."""
    if ws.device.type == "cpu":
        return drain_plain(ctrl, queue, ws, carry)
    _check(queue, ws, ctrl=ctrl, carry=carry)
    acks, results, ctrl_out, _ = _drain_launch(ctrl, queue, ws, carry, None)
    persistent_drain.launches += 1
    return ws, carry, acks, results, ctrl_out


def persistent_drain_prof(ctrl, queue, ws, carry, tick):
    """K2: K1 plus the flight recorder — a ``(C, Q, PROF_WIDTH)`` profile
    row per queue row and the ``(C, 1)`` logical tick, advanced in place by
    one per active row; acks byte-identical to K1's. Returns (ws, carry,
    acks, results, ctrl', prof, tick). ``persistent_drain_prof.launches``
    counts launches."""
    if ws.device.type == "cpu":
        return drain_plain(ctrl, queue, ws, carry, tick)
    _check(queue, ws, ctrl=ctrl, carry=carry, tick=tick)
    acks, results, ctrl_out, prof = _drain_launch(ctrl, queue, ws, carry,
                                                  tick)
    persistent_drain_prof.launches += 1
    return ws, carry, acks, results, ctrl_out, prof, tick


def persistent_execute(queue, ws):
    """K3: the legacy executor — drains every work row of each cluster's
    queue through the 6-op table; ws updated in place. Returns (ws,
    from_gpu (C, DESC_WIDTH)). ``persistent_execute.launches`` counts
    launches."""
    if ws.device.type == "cpu":
        return execute_plain(queue, ws)
    _check(queue, ws)
    C, Q, _ = queue.shape
    fromgpu = torch.empty((C, DESC_WIDTH), dtype=torch.int32,
                          device=ws.device)
    err = library().persistent_execute(
        queue.data_ptr(), ws.data_ptr(), fromgpu.data_ptr(), C, Q,
        ws.shape[1], torch.cuda.current_stream(ws.device).cuda_stream)
    _raise_on(err, "persistent_execute")
    persistent_execute.launches += 1
    return ws, fromgpu


persistent_drain.launches = 0
persistent_drain_prof.launches = 0
persistent_execute.launches = 0
