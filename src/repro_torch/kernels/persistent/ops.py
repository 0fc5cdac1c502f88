"""Queue-building helpers for the persistent executors, the launch entry
points, and ``tile_work_table()`` — the SCAN-path twin of the drain
megakernel's opcode table (same op semantics, chunk contract and result
values), which is what makes megakernel/scan equivalence testable token for
token. Port of ``repro.kernels.persistent.ops``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mailbox as mb
from repro_torch.core.mailbox import (DESC_WIDTH, THREAD_NOP, THREAD_WORK,
                                      W_ARG0, W_ARG1, W_OPCODE, W_STATUS)
from repro_torch.kernels.persistent import kernel as K
from repro_torch.kernels.persistent.kernel import (persistent_drain,
                                                   persistent_drain_prof,
                                                   persistent_execute)

__all__ = ["build_queue", "mlp_program", "persistent_drain",
           "persistent_drain_prof", "persistent_execute", "TILE_OP_NAMES",
           "TILE_RESULT_TEMPLATE", "tile_state", "tile_work_table"]


def build_queue(programs: list[list[tuple]], queue_len: int) -> np.ndarray:
    """programs[c] = list of (opcode, arg0, arg1) for cluster c; padded with
    NOP descriptors to queue_len."""
    C = len(programs)
    q = np.zeros((C, queue_len, DESC_WIDTH), np.int32)
    q[:, :, W_STATUS] = THREAD_NOP
    for c, prog in enumerate(programs):
        assert len(prog) <= queue_len
        for i, (op, a0, a1) in enumerate(prog):
            q[c, i, W_STATUS] = THREAD_WORK + i
            q[c, i, W_OPCODE] = op
            q[c, i, W_ARG0] = a0
            q[c, i, W_ARG1] = a1
    return q


def mlp_program() -> list[tuple]:
    """A two-layer tile-MLP as a descriptor program:
    t3 += t0@t1; relu t3; t4 += t3@t2 — the 'finer-grained kernels' demo."""
    return [
        (K.OP_MATMUL, *K.pack_args(3, 0, 1)),
        (K.OP_RELU, K.pack_args(3, 3)[0], 0),
        (K.OP_MATMUL, *K.pack_args(4, 3, 2)),
    ]


# -- scan-path twin of the drain kernel's opcode table ----------------------

TILE_OP_NAMES = ("nop", "matmul", "add", "scale", "relu", "copy", "reduce")

TILE_RESULT_TEMPLATE = torch.zeros((1,), dtype=torch.float32)


def tile_state(nbuf: int = 8, seed: int | None = None) -> dict:
    """The tile-op state tree: ``{"ws": (nbuf, TILE, TILE) f32}`` on the
    CPU — zeros, or small random normals when ``seed`` is given (the same
    numpy draw as the reference's, so both packages start from one
    workspace)."""
    if seed is None:
        ws = np.zeros((nbuf, K.TILE, K.TILE), np.float32)
    else:
        rng = np.random.default_rng(seed)
        ws = rng.standard_normal((nbuf, K.TILE, K.TILE)).astype(np.float32)
        ws *= 0.1        # keep repeated matmul chains numerically tame
    return {"ws": torch.from_numpy(ws)}


def tile_work_table() -> list[tuple]:
    """The drain megakernel's opcode table as chunk-aware SCAN-path work
    fns ``fn(state, carry, desc) -> (state, carry, result, done)`` over
    ``state = {"ws": (nbuf, TILE, TILE) f32}``, in kernel opcode order
    (``TILE_OP_NAMES``), for the port's ``PersistentRuntime``: ``desc`` is
    a host int32 row, so tile indices and ``done`` are host values and only
    the tile math is enqueued. The workspace is written in place.

    Op semantics, result values ([sum of the written tile], [carry] for
    reduce, [0] for nop) and the per-chunk done test match the reference's
    ``tile_work_table`` — including its indexing, which is jnp's: a tile is
    read at ``i + nbuf`` when ``i`` is negative, clamped into range, and a
    write whose index lies outside the workspace after that is dropped."""

    def _read(i: int, nbuf: int) -> int:
        i = i + nbuf if i < 0 else i
        return min(max(i, 0), nbuf - 1)

    def _done(desc) -> bool:
        return int(desc[mb.W_CHUNK]) + 1 >= max(int(desc[mb.W_NCHUNKS]), 1)

    def nop_fn(state, carry, desc):
        return (state, carry,
                torch.zeros((1,), dtype=torch.float32,
                            device=state["ws"].device), _done(desc))

    def _tile_fn(compute):
        def fn(state, carry, desc):
            ws = state["ws"]
            nbuf = ws.shape[0]
            packed = int(desc[W_ARG0])
            dst = (packed >> 8) + nbuf if packed >> 8 < 0 else packed >> 8
            new = compute(ws, _read(packed & 255, nbuf), desc)
            if 0 <= dst < nbuf:
                ws[dst] = new
            return state, carry, new.sum()[None], _done(desc)
        return fn

    def _b(ws, desc):
        return ws[_read(int(desc[W_ARG1]), ws.shape[0])]

    def _scale(desc) -> float:
        # arg1 as f32, over 2^16: the kernel's fixed-point scale
        return float(np.float32(desc[W_ARG1]) / np.float32(1 << K.SCALE_SHIFT))

    def _matmul(ws, a, desc):
        dst = int(desc[W_ARG0]) >> 8
        return ws[_read(dst, ws.shape[0])] + ws[a] @ _b(ws, desc)

    matmul_fn = _tile_fn(_matmul)
    add_fn = _tile_fn(lambda ws, a, desc: ws[a] + _b(ws, desc))
    scale_fn = _tile_fn(lambda ws, a, desc: ws[a] * _scale(desc))
    relu_fn = _tile_fn(lambda ws, a, desc: torch.clamp(ws[a], min=0.0))
    copy_fn = _tile_fn(lambda ws, a, desc: ws[a].clone())

    def reduce_fn(state, carry, desc):
        ws = state["ws"]
        a = _read(int(desc[W_ARG0]) & 255, ws.shape[0])
        acc = carry + ws[a].sum()
        return state, acc, acc[None], _done(desc)

    return [
        ("nop", nop_fn),
        ("matmul", matmul_fn),
        ("add", add_fn),
        ("scale", scale_fn),
        ("relu", relu_fn),
        ("copy", copy_fn),
        ("reduce", reduce_fn, torch.zeros((), dtype=torch.float32)),
    ]
