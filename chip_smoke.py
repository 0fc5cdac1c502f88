#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints its own lines; any failure raises and exits nonzero):

1. device: torch/CUDA versions and the card's name and power limit;
2. build: compiles every hand-written kernel from ``src/repro_torch`` (one
   ``nvcc`` per source, all at once) and prints the seconds and the ptxas
   register report;
3. kernel checks: each kernel against its plain PyTorch version on the card
   (max abs error within the stated tolerance), with the kernel's, the plain
   version's and a library call's time, and the least time the card could
   take for the same work;
4. serve: ``repro_torch.launch.serve.main`` on llama3-8b at full width
   (32 layers, d=4096, vocab 128256, bf16, random weights from the seed),
   4 requests x 8 new tokens, once with host prefill and once with chunked
   prefill; kernel launch counters are zeroed just before each run and read
   just after. Then one prefill + one decode step through the kernel path
   and through the plain-attention path on the same weights: logits agree
   within a stated bf16 tolerance;
5. tile kernels: the drain megakernel (K1), its flight-recorder variant
   (K2) and the legacy executor (K3) against their plain versions at
   C = 132 clusters (one worker per SM), Q = 64 rows, nbuf = 8 tiles, on a
   matmul-only queue and a mixed queue (every opcode, a 3-chunk REDUCE, a
   [head, tail) window, a stopped cluster, out-of-range tile indices); and
   K1/K2 at C = 1, the shape of every ``MegaRuntime`` launch (a full
   matmul queue, a mixed queue with a window, a one-row launch): acks,
   control words, profile rows and ticks exact, workspaces, results and
   carries within 1e-4; kernel time (CUDA-graph replay), plain time,
   ``torch.bmm`` over the same products, and the bound;
6. K3's own path: the tile-MLP demo program on 132 clusters, one launch,
   then K3 against its plain version at that shape;
7. mega vs scan: 512 tile ops with chunked reduces through
   ``LkSystem(runtime="mega")`` and ``runtime="scan"`` on one cluster;
   ticket results and final workspaces agree, no ack mismatches,
   ``work_drained`` equals the chunks submitted, and each runtime's wall
   time per item;
8. the full-width system: ``LkSystem(runtime="mega")`` with 132 clusters on
   the card and a ``TraceCollector`` (so K2 runs), 132 x 64 items with
   admitted deadlines of 3x the whole backlog's host time (measured by a
   warm-up round): every ticket resolves with ``met == n``, zero bound
   violations, device spans = drained rows = chunks submitted;
9. a preemption probe: a HIGH arrival's first trigger lands between the
   chunk retirements of an 8-chunk LOW item under ``MegaRuntime``;
10. a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name/power-limit
   line, and last ``{"ok": true, "device": {...}}``.

Kernel launch counters are zeroed just before each path's run and read just
after; a kernel that its path never launched fails the run.

Imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import mailbox as mb  # noqa: E402
from repro_torch.core.dispatcher import Dispatcher  # noqa: E402
from repro_torch.core.mega import MegaRuntime, mega_work_classes  # noqa: E402
from repro_torch.core.persistent import reap_deferred  # noqa: E402
from repro_torch.core.sched import EdfPolicy  # noqa: E402
from repro_torch.core.telemetry import (EV_CHUNK_RETIRE,  # noqa: E402
                                        EV_TRIGGER, TraceCollector)
from repro_torch.core.telemetry.events import now_us  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import persistent as PK  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.system import LkSystem  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak operation rates by
# input type; the FFMA kernels' f32 inputs are held to the non-tensor rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # summation order
LOGITS_ATOL = 0.25    # kernel vs plain attention through 32 bf16 layers
TILE_TOL = 1e-4      # rtol and atol: f32 sums in another order
TILE_C, TILE_Q, TILE_NBUF = 132, 64, 8   # one worker per SM of the H100
DEVICE = torch.device("cuda")
SERVE_ARGS = ["--arch", "llama3-8b", "--requests", "4", "--max-new", "8",
              "--max-batch", "4", "--max-seq", "128", "--seed", "0"]

KERNELS = {
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:23",
        wrapper=flash_attention),
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:23",
        wrapper=decode_attention),
    "persistent_drain": dict(
        route="cuda",
        source="src/repro_torch/kernels/persistent/csrc/persistent.cu",
        replaces="src/repro/kernels/persistent/kernel.py:276",
        wrapper=PK.persistent_drain, plain=PK.drain_plain),
    "persistent_drain_prof": dict(
        route="cuda",
        source="src/repro_torch/kernels/persistent/csrc/persistent.cu",
        replaces="src/repro/kernels/persistent/kernel.py:289",
        wrapper=PK.persistent_drain_prof, plain=PK.drain_plain),
    "persistent_execute": dict(
        route="cuda",
        source="src/repro_torch/kernels/persistent/csrc/persistent.cu",
        replaces="src/repro/kernels/persistent/kernel.py:77",
        wrapper=PK.persistent_execute, plain=PK.execute_plain),
}
ATTENTION = ("flash_attention", "decode_attention")
TILE_KERNELS = ("persistent_drain", "persistent_drain_prof",
                "persistent_execute")


def zero_launches() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launches() -> dict:
    return {n: s["wrapper"].launches for n, s in KERNELS.items()}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's
    per-call launch cost (Python, allocation, ctypes) is not in the
    number. Warm-up calls on a side stream come first, so libraries that
    plan or allocate on their first call (cuDNN) do it outside capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def host_ms(fn, iters: int = 20) -> float:
    """Wall time of one eager ``fn`` call, launch cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time for the work: the larger of its bytes over the HBM
    rate and its operations over the peak rate for its input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops)


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _sdpa_gqa(q, k, v, **kw):
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def flash_case(name, B, S, dtype, gen, causal=True, window=0, softcap=0.0,
               Hq=32, Hkv=8, D=128) -> dict:
    q = _randn((B, S, Hq, D), dtype, gen)
    k = _randn((B, S, Hkv, D), dtype, gen)
    v = _randn((B, S, Hkv, D), dtype, gen)
    kw = dict(causal=causal, window=window, attn_softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    eager_ms = host_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=5)
    lib_ms = None
    if softcap == 0.0:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window:
            qp = torch.arange(S, device="cuda")[:, None]
            kp = torch.arange(S, device="cuda")[None, :]
            mask = (kp <= qp) & (qp - kp < window)
        sdpa_kw = dict(attn_mask=mask) if mask is not None else \
            dict(is_causal=causal)
        lib_ms = time_ms(lambda: _sdpa_gqa(qt, kt, vt, **sdpa_kw))
    # useful (q, k) pairs of this mask, each 4*D operations per head
    qpos = np.arange(S)
    hi = qpos if causal else np.full(S, S - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, int)
    pairs = float(np.maximum(hi - lo + 1, 0).sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dict(kernel="flash_attention", case=name, max_abs_err=err,
                tol=ATOL[dtype], ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                **bound(nbytes, 4.0 * D * Hq * B * pairs, dtype))


def decode_case(name, B, S, valid, dtype, gen, window=0, softcap=0.0,
                Hq=32, Hkv=8, D=128) -> dict:
    q = _randn((B, 1, Hq, D), dtype, gen)
    k = _randn((B, S, Hkv, D), dtype, gen)
    v = _randn((B, S, Hkv, D), dtype, gen)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    kw = dict(attn_softcap=softcap, window=window)
    got = decode_attention(q, k, v, vl, **kw)
    want = decode_attention_plain(q, k, v, vl, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ms = time_ms(lambda: decode_attention(q, k, v, vl, **kw))
    eager_ms = host_ms(lambda: decode_attention(q, k, v, vl, **kw))
    plain_ms = time_ms(lambda: decode_attention_plain(q, k, v, vl, **kw),
                       iters=5)
    pos = torch.arange(S, device="cuda")[None, :]
    live = pos < vl[:, None]
    if window:
        live &= pos >= (vl[:, None] - window)
    lib_ms = None
    if softcap == 0.0:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = live[:, None, None, :]
        lib_ms = time_ms(lambda: _sdpa_gqa(qt, kt, vt, attn_mask=mask))
    rows = float(live.sum())          # live cache rows this data needs
    nbytes = (2 * q.numel() + 2 * rows * Hkv * D) * q.element_size() + \
        vl.numel() * 4
    return dict(kernel="decode_attention", case=name, max_abs_err=err,
                tol=ATOL[dtype], ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=lib_ms, **bound(nbytes, 4.0 * D * Hq * rows, dtype))


def kernel_checks() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [
        flash_case("B1_S17_causal_bf16", 1, 17, bf16, gen),
        flash_case("B1_S128_causal_bf16", 1, 128, bf16, gen),
        flash_case("B1_S2048_causal_bf16", 1, 2048, bf16, gen),
        flash_case("B1_S512_window128_softcap50_bf16", 1, 512, bf16, gen,
                   window=128, softcap=50.0),
        flash_case("B1_S128_causal_f32", 1, 128, f32, gen),
        decode_case("B4_S128_ragged_bf16", 4, 128, [128, 1, 77, 64], bf16,
                    gen),
        decode_case("B4_S4096_ragged_bf16", 4, 4096, [4096, 3000, 1025, 17],
                    bf16, gen),
        decode_case("B4_S4096_window1024_bf16", 4, 4096,
                    [4096, 2048, 1000, 300], bf16, gen, window=1024),
    ]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"check {r['kernel']:16s} {r['case']:34s} "
            f"max_abs_err={r['max_abs_err']:.3e} tol={r['tol']:.0e} "
            f"kernel_ms={r['ms']:.4f} eager_call_ms={r['eager_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} "
            f"sdpa_ms={lib} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}; "
            f"bytes {r['bytes_ms']:.5f}, ops {r['ops_ms']:.5f})")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    # the main path's shapes: a 17-token prompt (serve draws 4..23) and a
    # 4-slot decode over the 128-position cache
    return {"flash_attention": rows[0], "decode_attention": rows[5],
            "cases": rows}


# ---------------------------------------------------------------------------
# phase 4: serve + logits check
# ---------------------------------------------------------------------------

def serve_run(label: str, extra: list) -> dict:
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(SERVE_ARGS + extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ds = report.deadline_stats
    outs = report.outputs
    log(f"serve[{label}] wall={wall:.1f}s peak_mem={peak:.2f}GiB "
        f"launches={launches} n={ds['n']} met={ds['met']} "
        f"tokens={sum(len(o) for o in outs)}")
    if len(outs) != 4 or any(len(o) != 8 for o in outs):
        raise SystemExit(f"serve[{label}]: not every request completed: {outs}")
    if ds["met"] != ds["n"]:
        raise SystemExit(f"serve[{label}]: met={ds['met']} != n={ds['n']}")
    del report
    reap_deferred()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def logits_check() -> float:
    cfg = get_config("llama3-8b")
    model = build(cfg, device="cuda")
    plain = build(cfg, device="cuda", plain_attention=True)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 17)).astype(np.int32)).cuda()
    out = {}
    for name, m in (("kernel", model), ("plain", plain)):
        logits0, caches = m.prefill(params, {"tokens": prompt}, 128)
        nxt = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)[:, None]
        logits1, _ = m.decode_step(params, caches, nxt,
                                   torch.tensor([17], dtype=torch.int32,
                                                device="cuda"))
        out[name] = (logits0.float(), logits1.float())
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max())
            for a, b in zip(out["kernel"], out["plain"])]
    scale = float(out["plain"][0].abs().max())
    same = [bool((a.argmax(-1) == b.argmax(-1)).all())
            for a, b in zip(out["kernel"], out["plain"])]
    log(f"logits kernel vs plain attention: prefill max_abs_err={errs[0]:.3e} "
        f"decode max_abs_err={errs[1]:.3e} (|logits| max {scale:.2f}, "
        f"tol {LOGITS_ATOL}) argmax_equal={same}")
    if max(errs) > LOGITS_ATOL or not all(math.isfinite(e) for e in errs):
        raise SystemExit("kernel-path logits disagree with the plain path")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return max(errs)


# ---------------------------------------------------------------------------
# phase 5: tile kernels vs plain at 132 clusters
# ---------------------------------------------------------------------------

def _ring(programs, windows):
    """(ctrl, queue) int32 tensors on the card from per-cluster descriptor
    lists and (head, tail, stop) windows."""
    ring = np.stack([mb.descriptor_ring(p, TILE_Q) for p in programs])
    ctrl = np.stack([mb.queue_control(tail=t, head=h, stop=s)
                     for h, t, s in windows])
    return (torch.from_numpy(ctrl).to(DEVICE),
            torch.from_numpy(ring).to(DEVICE))


def matmul_queue():
    """Every row a matmul of tiles 0 and 1 (never written) into tiles
    2..7: 8448 tile products, all active."""
    WD = mb.WorkDescriptor
    progs = [[WD(opcode=PK.OP_MATMUL, request_id=c * TILE_Q + i,
                 arg0=PK.pack_args(2 + (i + c) % 6, (i + c) % 2)[0],
                 arg1=(i + c + 1) % 2) for i in range(TILE_Q)]
             for c in range(TILE_C)]
    return _ring(progs, [(0, TILE_Q, 0)] * TILE_C)


def mixed_queue(rng):
    """Every opcode (and -1 / 9, which clip), random tiles with aliasing
    and out-of-range indices (-1, 9, 300: tile 7), a 3-chunk REDUCE at rows
    30-32, per-cluster [head, tail) windows and one stopped cluster. Tiles
    0 and 1 are never written and give one operand of every product and
    sum, so the values stay near 1; rows 10 and 40 are products whose dst
    is their first operand."""
    WD = mb.WorkDescriptor
    progs = []
    for c in range(TILE_C):
        prog = []
        for i in range(TILE_Q):
            rid = c * TILE_Q + i
            if 30 <= i <= 32:
                prog.append(WD(opcode=PK.OP_REDUCE, request_id=c * TILE_Q + 30,
                               arg0=PK.pack_args(0, 1)[0], chunk=i - 30,
                               n_chunks=3))
                continue
            if i in (10, 40):
                d = 2 + c % 6
                prog.append(WD(opcode=PK.OP_MATMUL, request_id=rid,
                               arg0=PK.pack_args(d, d)[0], arg1=c % 2))
                continue
            op = int(rng.choice([-1, 0, 1, 2, 3, 4, 5, 9]))
            dst = int(rng.choice([-1, 9, 300])) if rng.random() < 0.1 \
                else int(rng.integers(2, TILE_NBUF))
            a, b = int(rng.integers(0, TILE_NBUF)), int(rng.integers(0, 2))
            if op == PK.OP_MATMUL:
                a = int(rng.integers(0, 2))
            a0, a1 = (PK.pack_scale(dst, a, float(rng.uniform(-1, 1)))
                      if op == PK.OP_SCALE else PK.pack_args(dst, a, b))
            prog.append(WD(opcode=op, arg0=a0, arg1=a1, request_id=rid))
        progs.append(prog)
    windows = [(c % 4, TILE_Q - c % 7, int(c == TILE_C - 1))
               for c in range(TILE_C)]
    return _ring(progs, windows)


def _tile_args(name, ctrl, ring, ws, carry, tick):
    """Fresh copies of the state the kernel updates in place."""
    if name == "persistent_execute":
        return ring, ws.clone()
    if name == "persistent_drain":
        return ctrl, ring, ws.clone(), carry.clone()
    return ctrl, ring, ws.clone(), carry.clone(), tick.clone()


def _tile_work(name, ctrl, ring, nbuf) -> tuple[float, float]:
    """(bytes, operations) the launch needs on this data: each input read
    and each output written once; 2*T^3 + 2*T^2 per active matmul row,
    2*T^2 per active elementwise or reduce row (the op and the row's sum),
    nothing for NOP rows."""
    q = ring.cpu().numpy()
    C, Q, _ = q.shape
    T = PK.TILE
    work = q[:, :, mb.W_STATUS] >= mb.THREAD_WORK
    n_ops = PK.NUM_OPS
    if name != "persistent_execute":
        c = ctrl.cpu().numpy()
        i = np.arange(Q)[None, :]
        work &= (i >= c[:, mb.QC_HEAD:mb.QC_HEAD + 1]) & \
            (i < c[:, mb.QC_TAIL:mb.QC_TAIL + 1]) & \
            (c[:, mb.QC_STOP:mb.QC_STOP + 1] == 0)
        n_ops = PK.NUM_DRAIN_OPS
    op = np.clip(q[:, :, mb.W_OPCODE], 0, n_ops - 1)
    ops = float(((op == PK.OP_MATMUL) & work).sum()) * (2 * T**3 + 2 * T**2)
    ops += float(((op > PK.OP_MATMUL) & work).sum()) * 2 * T**2
    ws_bytes = C * nbuf * T * T * 4
    nbytes = 2 * ws_bytes + q.nbytes
    if name == "persistent_execute":
        nbytes += C * mb.DESC_WIDTH * 4
    else:
        nbytes += 2 * C * mb.QCTRL_WIDTH * 4 + 2 * C * 4          # ctrl, carry
        nbytes += C * Q * (mb.DESC_WIDTH + 1) * 4                 # acks, res
        if name == "persistent_drain_prof":
            nbytes += C * Q * mb.PROF_WIDTH * 4 + 2 * C * 4       # prof, tick
    return nbytes, ops


def tile_case(name, label, ctrl, ring, ws, carry, tick, time_it,
              library_ms=None) -> dict:
    spec = KERNELS[name]
    got = spec["wrapper"](*_tile_args(name, ctrl, ring, ws, carry, tick))
    want = spec["plain"](*_tile_args(name, ctrl, ring, ws, carry, tick))
    torch.cuda.synchronize()
    err, exact = 0.0, True
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            exact &= bool(torch.equal(g, w))
        else:
            err = max(err, float((g - w).abs().max()))
            exact &= bool(torch.allclose(g, w, rtol=TILE_TOL, atol=TILE_TOL))
    scale = max(float(t.abs().max()) for t in want
                if t.dtype == torch.float32)
    row = dict(kernel=name, case=label, max_abs_err=err, ok=exact,
               scale=scale, library_ms=library_ms)
    nbytes, ops = _tile_work(name, ctrl, ring, ws.shape[1])
    row.update(bound(nbytes, ops, torch.float32))
    if time_it:
        args = _tile_args(name, ctrl, ring, ws, carry, tick)
        row["ms"] = time_ms(lambda: spec["wrapper"](*args))
        plain = _tile_args(name, ctrl, ring, ws, carry, tick)
        row["plain_ms"] = host_ms(lambda: spec["plain"](*plain), iters=3)
    return row


def log_tile_row(r) -> None:
    t = "" if "ms" not in r else (
        f"kernel_ms={r['ms']:.4f} plain_eager_ms={r['plain_ms']:.3f} ")
    if r["library_ms"] is not None:
        t += f"bmm_same_products_no_queue_order_ms={r['library_ms']:.4f} "
    log(f"check {r['kernel']:22s} {r['case']:28s} "
        f"max_abs_err={r['max_abs_err']:.3e} exact_ints_and_tol={r['ok']} "
        f"max|value|={r['scale']:.3g} {t}bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']}; bytes {r['bytes_ms']:.4f}, ops {r['ops_ms']:.4f})")


def bmm_ms(ring, ws) -> float:
    """``torch.bmm`` (TF32 off) over the tile products of a matmul-only
    queue: the same arithmetic without the queue's order."""
    q = ring.cpu().numpy()
    C, Q, _ = q.shape
    cl = np.repeat(np.arange(C), Q) * ws.shape[1]
    flat = ws.reshape(-1, PK.TILE, PK.TILE)
    ia = torch.from_numpy(cl + (q[:, :, mb.W_ARG0] & 255).ravel())
    ib = torch.from_numpy(cl + q[:, :, mb.W_ARG1].ravel())
    A, B = flat[ia.to(DEVICE)], flat[ib.to(DEVICE)]
    out = torch.empty_like(A)
    return time_ms(lambda: torch.bmm(A, B, out=out))


def one_cluster(ctrl, ring, c, window=None):
    """Cluster ``c`` of a queue as a launch of its own, the shape every
    ``MegaRuntime`` launch has, optionally with another (head, tail)."""
    ctrl1 = ctrl[c:c + 1].clone()
    if window is not None:
        ctrl1[0, mb.QC_HEAD], ctrl1[0, mb.QC_TAIL] = window
    return ctrl1, ring[c:c + 1].contiguous()


def tile_kernel_checks() -> dict:
    """K1-K3 against their plain versions at C = 132 (one worker per SM),
    and K1/K2 at C = 1: each ``MegaRuntime`` is one cluster, so every
    launch of the mega paths has that shape (a full matmul queue, a mixed
    queue with a window, a one-row launch as the reduce remainders are)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.standard_normal(
        (TILE_C, TILE_NBUF, PK.TILE, PK.TILE)) * 0.1).astype(
            np.float32)).to(DEVICE)
    carry = torch.from_numpy(rng.uniform(-1, 1, (TILE_C, 1)).astype(
        np.float32)).to(DEVICE)
    tick = torch.from_numpy(rng.integers(0, 100, (TILE_C, 1)).astype(
        np.int32)).to(DEVICE)
    mm, mixed = matmul_queue(), mixed_queue(rng)
    mm1 = one_cluster(*mm, 0)
    st1 = (ws[:1], carry[:1], tick[:1])
    lib, lib1 = bmm_ms(mm[1], ws), bmm_ms(mm1[1], ws[:1])
    big = f"C{TILE_C}_Q{TILE_Q}_nbuf{TILE_NBUF}"
    one = f"C1_Q{TILE_Q}_nbuf{TILE_NBUF}"
    out = {}
    for name in TILE_KERNELS:
        rows = [tile_case(name, f"matmul_{big}", *mm, ws, carry, tick,
                          time_it=True, library_ms=lib),
                tile_case(name, f"mixed_{big}", *mixed, ws, carry, tick,
                          time_it=False)]
        if name != "persistent_execute":      # K3's path: phase 6
            rows += [
                tile_case(name, f"matmul_{one}", *mm1, *st1, time_it=True,
                          library_ms=lib1),
                tile_case(name, f"mixed_{one}_window", *one_cluster(
                    *mixed, min(5, TILE_C - 1)), *st1, time_it=False),
                tile_case(name, f"mixed_{one}_one_row", *one_cluster(
                    *mixed, 0, (0, 1)), *st1, time_it=False)]
        for r in rows:
            log_tile_row(r)
        bad = [r for r in rows if not r["ok"]]
        if bad:
            raise SystemExit(
                f"tile kernel disagrees with its plain version: {bad}")
        out[name] = dict(c132=rows[0], path=rows[2] if len(rows) > 2
                         else None,
                         max_abs_err=max(r["max_abs_err"] for r in rows))
    k1 = out["persistent_drain"]["path"]["ms"]
    log(f"one cluster (C=1): 64 tile products in {k1:.4f} ms = "
        f"{k1 * 1e3 / TILE_Q:.2f} us each; one CTA per cluster caps a C=1 "
        f"launch at one SM's share of the f32 rate, "
        f"{2 * PK.TILE**3 / (PEAK_OPS[torch.float32] / 132) * 1e6:.2f} us "
        f"per product")
    return out


# ---------------------------------------------------------------------------
# phase 6: K3's path — the tile-MLP demo on every cluster
# ---------------------------------------------------------------------------

def mlp_demo_run() -> tuple[dict, dict]:
    """``mlp_program`` (t3 += t0@t1; relu t3; t4 += t3@t2) on 132 clusters
    through ``persistent_execute``, held to torch.matmul (TF32 off); then
    K3 against its plain version at this shape. Returns the path's
    launches and the check's row."""
    rng = np.random.default_rng(1)
    ws = np.zeros((TILE_C, 5, PK.TILE, PK.TILE), np.float32)
    ws[:, :3] = rng.standard_normal((TILE_C, 3, PK.TILE, PK.TILE)) * 0.1
    ws = torch.from_numpy(ws).to(DEVICE)
    queue = torch.from_numpy(PK.build_queue(
        [PK.mlp_program()] * TILE_C, 4)).to(DEVICE)
    want = torch.relu(ws[:, 0] @ ws[:, 1]) @ ws[:, 2]
    run = ws.clone()
    zero_launches()
    _, fromgpu = PK.persistent_execute(queue, run)
    torch.cuda.synchronize()
    launches = read_launches()
    err = float((run[:, 4] - want).abs().max())
    done = fromgpu[:, mb.W_ARG0].cpu().tolist()
    log(f"mlp demo (K3 path): {TILE_C} clusters max_abs_err={err:.3e} "
        f"work rows per cluster={set(done)} launches={launches}")
    if err > TILE_TOL or set(done) != {3}:
        raise SystemExit("tile-MLP demo through K3 is wrong")
    row = tile_case("persistent_execute", f"mlp_demo_C{TILE_C}_Q4_nbuf5",
                    None, queue, ws, None, None, time_it=True)
    log_tile_row(row)
    if not row["ok"]:
        raise SystemExit(f"K3 disagrees with its plain version: {row}")
    return launches, row


# ---------------------------------------------------------------------------
# phase 7: mega vs scan on one cluster
# ---------------------------------------------------------------------------

def tile_items(rng, n: int) -> list:
    """(class, arg0, arg1, n_chunks): every 16th a 3-chunk reduce of tile 1;
    the rest random tile ops writing tiles 2..7 from tiles 0..7 (products
    and sums take an operand from the never-written tiles 0 and 1)."""
    items = []
    for i in range(n):
        if i % 16 == 5:
            items.append(("reduce", PK.pack_args(0, 1)[0], 0, 3))
            continue
        name = ("matmul", "add", "scale", "relu", "copy",
                "nop")[int(rng.integers(0, 6))]
        dst, a = int(rng.integers(2, TILE_NBUF)), int(rng.integers(0, 8))
        b = int(rng.integers(0, 2))
        if name == "matmul":
            a = int(rng.integers(0, 2))
        a0, a1 = (PK.pack_scale(dst, a, float(rng.uniform(-1, 1)))
                  if name == "scale" else PK.pack_args(dst, a, b))
        items.append((name, a0, a1, 1))
    return items


def mega_vs_scan_run(around=contextlib.nullcontext) -> dict:
    """512 tile items through ``LkSystem(runtime="mega")`` and then
    ``runtime="scan"`` on one cluster. ``around(label)`` wraps each timed
    submit-and-drain (``scripts/profile_mega.py`` traces it)."""
    items = tile_items(np.random.default_rng(2), 512)
    out = {}
    for runtime in ("mega", "scan"):
        sys_ = LkSystem(
            devices=[DEVICE], n_clusters=1, runtime=runtime,
            state_factory=lambda cl: PK.tile_state(TILE_NBUF, seed=11),
            result_template=PK.TILE_RESULT_TEMPLATE,
            work_classes=mega_work_classes(), max_steps=TILE_Q,
            max_inflight=len(items) + 1).boot()
        sys_.submit("relu", arg0=PK.pack_args(2, 0)[0])
        sys_.drain()                              # warm-up, counted below
        zero_launches()
        with around(f"mega_vs_scan[{runtime}]"):
            t0 = time.perf_counter()
            tickets = [sys_.submit(n, arg0=a0, arg1=a1, n_chunks=k)
                       for n, a0, a1, k in items]
            sys_.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        rt = list(sys_.runtimes.values())[0]
        ws = rt.state["ws"] if isinstance(rt.state, dict) else rt.state[0]
        out[runtime] = dict(
            results=np.array([float(t.result()[0]) for t in tickets]),
            ws=ws.cpu().clone(),
            us_per_item=wall / len(items) * 1e6, launches=launches,
            drained=getattr(rt, "work_drained", None),
            doorbells=rt.doorbells, stats=sys_.stats())
        sys_.dispose()
    chunks = 1 + sum(k for *_, k in items)
    m, s = out["mega"], out["scan"]
    err = float(np.abs(m["results"] - s["results"]).max())
    ws_err = float((m["ws"] - s["ws"]).abs().max())
    ok = bool(np.allclose(m["results"], s["results"], rtol=TILE_TOL,
                          atol=TILE_TOL)) and np.isfinite(m["results"]).all()
    ok &= bool(torch.allclose(m["ws"], s["ws"], rtol=TILE_TOL, atol=TILE_TOL))
    acks = [o["stats"]["ack_mismatches"] for o in (m, s)]
    log(f"mega vs scan (1 cluster, {len(items)} items, {chunks} chunks incl. "
        f"warm-up): results max_abs_err={err:.3e} final workspace "
        f"max_abs_err={ws_err:.3e} agree={ok} ack_mismatches={acks} "
        f"work_drained={m['drained']} mega_doorbells={m['doorbells']} "
        f"scan_doorbells={s['doorbells']} launches={m['launches']} "
        f"wall_us_per_item mega={m['us_per_item']:.1f} "
        f"scan={s['us_per_item']:.1f} met={m['stats']['met']}/"
        f"{m['stats']['n']} chunks={m['stats']['chunks']}")
    if not ok or m["drained"] != chunks or any(acks):
        raise SystemExit("mega and scan disagree, or work_drained != chunks")
    return m["launches"]


# ---------------------------------------------------------------------------
# phase 8: the full-width system, 132 clusters, flight recorder on
# ---------------------------------------------------------------------------

def full_width_system_run(around=contextlib.nullcontext) -> dict:
    """132 x 64 items through ``LkSystem(runtime="mega")`` on 132 clusters
    of the card with the flight recorder (K2) and admitted deadlines.
    ``around(label)`` wraps the timed submit-and-drain."""
    # class WCETs as launch/trace.py calibrates them: the worst of 3
    # synchronous items on a runtime of the same shape, doubled
    rt = MegaRuntime(max_steps=TILE_Q, device=DEVICE)
    rt.boot(PK.tile_state(TILE_NBUF, seed=0))
    worst_us = 0.0
    for i in range(4):
        t1 = time.perf_counter_ns()
        rt.run_sync(mb.WorkDescriptor(
            opcode=PK.OP_MATMUL, arg0=PK.pack_args(3, 0, 1)[0], arg1=1,
            request_id=900 + i))
        if i:                                    # the first call warms up
            worst_us = max(worst_us, (time.perf_counter_ns() - t1) / 1e3)
    rt.dispose()
    tc = TraceCollector()
    t0 = time.perf_counter()
    sys_ = LkSystem(
        devices=[DEVICE] * TILE_C, n_clusters=TILE_C,
        runtime="mega", telemetry=tc, max_steps=TILE_Q, max_inflight=TILE_Q,
        state_factory=lambda cl: PK.tile_state(TILE_NBUF, seed=cl.cid),
        result_template=PK.TILE_RESULT_TEMPLATE,
        work_classes=mega_work_classes(
            matmul={"wcet_us": 2 * worst_us},
            reduce={"wcet_us": 4 * worst_us, "chunk_us": 2 * worst_us}))
    sys_.boot()
    boot_s = time.perf_counter() - t0
    rts = list(sys_.runtimes.values())
    # the deadline: one host thread pumps every cluster and retires one
    # item per round, so an item's response time is bound by the host time
    # of the whole backlog, not of its own cluster's queue. A warm-up round
    # of one matmul per cluster measures that host time per item on this
    # system; each item's deadline is 3x it for every item submitted, which
    # a run 3x slower than the warm-up misses
    t0 = time.perf_counter()
    for i in range(TILE_C):
        sys_.submit("matmul", arg0=PK.pack_args(2, 0)[0], arg1=1)
    sys_.drain()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / TILE_C * 1e6
    n = TILE_C * TILE_Q
    slack = int(3 * n * host_us)
    before = dict(sys_.stats(), drained=sum(r.work_drained for r in rts),
                  spans=sum(r.device_spans for r in rts))
    zero_launches()
    with around("system_132_clusters"):
        t0 = time.perf_counter()
        tickets = []
        for i in range(n):
            if i % 8 == 7:
                tickets.append(sys_.submit(
                    "reduce", arg0=PK.pack_args(0, 1)[0], n_chunks=2,
                    deadline_us=now_us() + slack))
            else:
                tickets.append(sys_.submit(
                    "matmul", arg0=PK.pack_args(2 + i % 6, i % 2)[0],
                    arg1=(i + 1) % 2, deadline_us=now_us() + slack))
        sys_.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    chunks = sum(2 if i % 8 == 7 else 1 for i in range(n))
    stats = sys_.stats()
    done, met = stats["n"] - before["n"], stats["met"] - before["met"]
    drained = sum(rt.work_drained for rt in rts) - before["drained"]
    spans = sum(rt.device_spans for rt in rts) - before["spans"]
    mon = tc.monitor.counts()
    worst_resp = max(q["worst_us"] for q in tc.quantiles("response_us")
                     .values())
    finite = all(math.isfinite(float(t.result()[0])) for t in tickets)
    log(f"system {TILE_C} clusters: boot {boot_s:.2f}s class WCET 2x "
        f"{worst_us:.0f}us | warm-up {host_us:.1f} us/item, slack "
        f"3x{n}x that = {slack / 1e6:.2f}s | {n} items, {chunks} chunks in "
        f"{wall:.2f}s ({wall / n * 1e6:.1f} us/item) worst response "
        f"{worst_resp / 1e6:.2f}s | n={done} met={met} "
        f"rejected={stats['rejected']} bound_violations="
        f"{mon['bound_violations']} admitted_checked={mon['admitted_checked']}"
        f" device_spans={spans} work_drained={drained} clusters="
        f"{stats['clusters']} launches={launches} finite={finite}")
    ok = (all(t.done() for t in tickets) and met == done == n
          and mon["bound_violations"] == 0 and spans == drained == chunks
          and finite)
    sys_.dispose()
    if not ok:
        raise SystemExit("full-width mega system run failed its checks")
    return launches


# ---------------------------------------------------------------------------
# phase 9: preemption probe under MegaRuntime
# ---------------------------------------------------------------------------

def preemption_probe() -> int:
    """bench_kernels' probe: an 8-chunk LOW matmul in flight one chunk at a
    time, a HIGH relu arriving mid-item; its first trigger must land
    between LOW chunk retirements. Returns K1's launches in the probe."""
    LO, HI = 40_000, 30_000
    rt = MegaRuntime(max_inflight=1, max_steps=4, device=DEVICE)
    rt.boot(PK.tile_state(4, seed=0))
    WD = mb.WorkDescriptor
    mm = dict(opcode=PK.OP_MATMUL, arg0=PK.pack_args(3, 0, 1)[0], arg1=1)
    relu = dict(opcode=PK.OP_RELU, arg0=PK.pack_args(2, 0)[0])
    rt.run_sync(WD(request_id=990, **mm))
    rt.run_sync(WD(request_id=991, **relu))
    tc = TraceCollector()
    disp = Dispatcher({0: rt}, policy=EdfPolicy(preemptive=True),
                      telemetry=tc)
    zero_launches()
    disp.submit(WD(request_id=LO, deadline_us=now_us() + 60_000_000,
                   n_chunks=8, **mm), admission=False)
    disp.kick(0)                      # LOW's first chunk enters the device
    disp.submit(WD(request_id=HI, deadline_us=now_us() + 2_000_000, **relu),
                admission=False)
    disp.drain()
    torch.cuda.synchronize()
    launches = read_launches()["persistent_drain"]
    lo = [e.t_us for e in tc.events_of(EV_CHUNK_RETIRE, LO)]
    hi = tc.events_of(EV_TRIGGER, HI)[0].t_us
    between = any(t <= hi for t in lo) and any(t > hi for t in lo)
    log(f"preemption probe: LOW chunk retirements {len(lo)}, HIGH first "
        f"trigger between them: {between} (LOW retired before it: "
        f"{sum(t <= hi for t in lo)}), preemptions={disp.preemptions} "
        f"bound_violations={tc.monitor.counts()['bound_violations']} "
        f"K1 launches={launches}")
    rt.dispose()
    reap_deferred()
    if not between or launches == 0:
        raise SystemExit("HIGH did not land between LOW chunk retirements")
    return launches


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = smi_line()
    log(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"build {len(took)} sources in {time.perf_counter() - t0:.1f}s "
        + " ".join(f"{s.name}={t:.1f}s" for s, t in took.items()))
    for src in _build.sources():
        logf = _build.library_path(src).with_name(
            _build.library_path(src).name + ".log")
        fn = "?"
        for line in logf.read_text().splitlines() if logf.exists() else ():
            if "Compiling entry function" in line:
                # the kernel's name and its mangled template arguments
                m = re.search(r"([a-z_]+kernel)(I\w+?EE)?", line)
                fn = "".join(g or "" for g in m.groups()) if m else "?"
            elif "registers" in line or "spill stores" in line:
                log(f"ptxas {src.stem} {fn}: {line.split(':', 1)[-1].strip()}")

    checks = kernel_checks()
    host = serve_run("host_prefill", [])
    chunked = serve_run("chunked_prefill", ["--chunked-prefill",
                                            "--prefill-chunk", "8"])
    missing = [n for n in ATTENTION if host[n] == 0]
    if chunked["decode_attention"] == 0:
        missing.append("decode_attention (chunked prefill)")
    if missing:
        raise SystemExit(f"main path never launched: {missing}")
    logits_check()

    tiles = tile_kernel_checks()
    paths = {}
    paths["persistent_execute"], tiles["persistent_execute"]["path"] = \
        mlp_demo_run()
    paths["persistent_drain"] = mega_vs_scan_run()
    paths["persistent_drain_prof"] = full_width_system_run()
    probe = preemption_probe()
    missing = [n for n in TILE_KERNELS if paths[n][n] == 0]
    if missing:
        raise SystemExit(f"tile path never launched: {missing}")

    kernels = []
    for name, spec in KERNELS.items():
        extra = {}
        if name in ATTENTION:
            row, launches = checks[name], host[name]
            extra["launches_chunked_prefill"] = chunked[name]
        else:
            # times at the shape the path launches; the 132-cluster
            # launch of the same kernel beside them
            row, launches = tiles[name]["path"], paths[name][name]
            big = tiles[name]["c132"]
            extra["shape"] = row["case"]
            extra["at_" + big["case"]] = {
                k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
            row = dict(row, max_abs_err=max(row["max_abs_err"],
                                            tiles[name]["max_abs_err"]))
        if name == "persistent_drain":
            extra["launches_preemption_probe"] = probe
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **extra})
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
