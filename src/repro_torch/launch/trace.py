"""Traced-workload CLI of the PyTorch port: run a synthetic persistent-
dispatch workload with the telemetry subsystem attached, export the
timeline, and VERIFY it (the port of ``repro.launch.trace``).

    PYTHONPATH=src python -m repro_torch.launch.trace --out trace.json
    PYTHONPATH=src python -m repro_torch.launch.trace --smoke --device cpu

Two phases, both on one dispatcher + TraceCollector:

1. **Preemption timeline** — one long LOW item sliced into resumable
   chunks, a HIGH arrival mid-item. The HIGH ticket's trigger must land
   BETWEEN two of the LOW ticket's chunk retirements (verified from the
   collector's events before the trace is written).
2. **Admitted workload** — hi/lo items submitted with real deadlines
   through admission control. The runtime-verification monitor replays
   every completion against the admission analysis' response-time bound;
   an admitted workload must finish with ZERO bound violations.

Exit status is non-zero when either check fails, unless ``--no-check``.
``--csv`` additionally writes the flat per-event CSV; ``--wcet-quantile``
switches admission to the percentile-WCET estimator. The work functions
are the reference's in PyTorch on the port's ``PersistentRuntime``: the
LOW function's ``done`` is a host bool from the descriptor's chunk words,
as the runtime's contract asks. ``--device`` defaults to ``cuda`` and
raises when CUDA is absent.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import mailbox as mb
from repro_torch.core.dispatcher import Dispatcher, now_us
from repro_torch.core.persistent import PersistentRuntime
from repro_torch.core.sched import ClassSpec, CRIT_HIGH, CRIT_LOW, make_policy
from repro_torch.core.telemetry import (
    EV_CHUNK_RETIRE, EV_TRIGGER, TraceCollector,
)

LO_ID, HI_BASE = 1, 100


def _lo_fn(state, carry, desc):
    # one block of heavy matmuls per chunk; arg0 scales the block count
    x = state["lo_x"]
    for _ in range(int(desc[mb.W_ARG0])):
        for _ in range(4):
            x = torch.tanh(x @ state["lo_w"])
    state["lo_x"] = x
    done = int(desc[mb.W_CHUNK]) + 1 >= int(desc[mb.W_NCHUNKS])
    return state, carry, x.sum().reshape(1), done


def _hi_fn(state, desc):
    x = torch.tanh(state["hi_x"] @ state["hi_w"])
    state["hi_x"] = x
    return state, x.sum().reshape(1)


def _make_state(lo_dim: int) -> dict:
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return {
        "hi_w": f32(rng.normal(size=(64, 64)) * 0.05),
        "hi_x": f32(rng.normal(size=(4, 64))),
        "lo_w": f32(rng.normal(size=(lo_dim, lo_dim)) * 0.05),
        "lo_x": f32(rng.normal(size=(32, lo_dim))),
    }


def _calibrate_us(rt, opcode: int, reps: int = 3) -> float:
    worst = 0.0
    for i in range(reps):
        t0 = time.perf_counter_ns()
        rt.run_sync(mb.WorkDescriptor(opcode=opcode, arg0=1,
                                      request_id=900 + i))
        worst = max(worst, (time.perf_counter_ns() - t0) / 1e3)
    return worst


def _verify_timeline(tc: TraceCollector, hi_id: int) -> bool:
    """Does the HIGH ticket's first trigger land between two LOW chunk
    retirements? (The preemption picture, read back from the events.)"""
    lo_chunks = [e.t_us for e in tc.events_of(EV_CHUNK_RETIRE, LO_ID)]
    hi_trigs = [e.t_us for e in tc.events_of(EV_TRIGGER, hi_id)]
    if not lo_chunks or not hi_trigs:
        return False
    t_hi = hi_trigs[0]
    return any(c <= t_hi for c in lo_chunks) and \
        any(c > t_hi for c in lo_chunks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="trace.json",
                    help="Chrome/Perfetto trace JSON path")
    ap.add_argument("--csv", default=None,
                    help="also write the flat per-event CSV here")
    ap.add_argument("--policy", choices=("edf", "fp"), default="edf",
                    help="scheduling policy for both phases")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the runtime's state lives (cuda raises when "
                         "CUDA is absent; nothing falls back to the CPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced work sizes (CI fast path)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunks of the long LOW item (default 6, smoke 4)")
    ap.add_argument("--items", type=int, default=None,
                    help="admitted-phase items (default 12, smoke 6)")
    ap.add_argument("--wcet-quantile", type=float, default=None,
                    help="use the percentile-WCET admission estimator "
                         "instead of worst + sigma inflation")
    ap.add_argument("--no-check", action="store_true",
                    help="report but do not fail on verification errors")
    args = ap.parse_args(argv)
    n_chunks = args.chunks or (4 if args.smoke else 6)
    n_items = args.items or (6 if args.smoke else 12)
    lo_dim = 128 if args.smoke else 384

    tc = TraceCollector()
    # telemetry attached at construction so boot() turns the flight
    # recorder on: chunk spans in the export are stamped from its rows
    rt = PersistentRuntime(
        [("lo", _lo_fn, torch.zeros((), dtype=torch.int32)), ("hi", _hi_fn)],
        result_template=torch.zeros((1,), dtype=torch.float32),
        max_inflight=1, telemetry=tc, device=args.device)
    rt.boot(_make_state(lo_dim))
    for op in (0, 1):          # first-use costs out of the timing
        rt.run_sync(mb.WorkDescriptor(opcode=op, arg0=1, request_id=990))
    chunk_us = _calibrate_us(rt, 0)
    hi_us = _calibrate_us(rt, 1)
    classes = (
        ClassSpec(0, "lo", priority=5, criticality=CRIT_LOW,
                  chunk_us=chunk_us * 2),
        ClassSpec(1, "hi", priority=0, criticality=CRIT_HIGH),
    )
    disp = Dispatcher(
        {0: rt}, policy=make_policy(args.policy, preemptive=True),
        classes=classes, telemetry=tc,
        wcet_us={0: chunk_us * n_chunks * 2, 1: hi_us * 2},
        wcet_quantile=args.wcet_quantile)

    # -- phase 1: the preemption timeline -------------------------------
    print(f"[trace] device {rt.device}; phase 1: LOW x{n_chunks} chunks "
          f"(~{chunk_us:.0f}us each) + mid-item HIGH arrival "
          f"({args.policy}, preemptive)")
    disp.submit(
        mb.WorkDescriptor(opcode=0, arg0=1, request_id=LO_ID,
                          deadline_us=now_us() + 60_000_000,
                          n_chunks=n_chunks), admission=False)
    disp.kick(0)                 # LOW's first chunk enters flight
    hi = disp.submit(
        mb.WorkDescriptor(opcode=1, request_id=HI_BASE,
                          deadline_us=now_us() + 1_000_000),
        admission=False)
    disp.drain()
    timeline_ok = _verify_timeline(tc, HI_BASE)
    print(f"[trace]   HIGH trigger between LOW chunk retirements: "
          f"{timeline_ok} (preemptions={disp.preemptions}, "
          f"hi_queued_us={hi.completion.queued_us})")

    # -- phase 2: admitted workload, bounds checked online ---------------
    print(f"[trace] phase 2: {n_items} admitted items "
          f"(deadline slack ~50x worst case)")
    slack = int((chunk_us * n_chunks + hi_us) * n_items * 50)
    for i in range(n_items):
        op = 1 if i % 2 == 0 else 0
        disp.submit(mb.WorkDescriptor(
            opcode=op, arg0=1, request_id=HI_BASE + 1 + i,
            deadline_us=now_us() + slack))
    disp.drain()
    mc = tc.monitor.counts()
    bounds_ok = mc["bound_violations"] == 0 and mc["admitted_checked"] > 0
    print(f"[trace]   runtime verification: {mc['admitted_checked']} "
          f"admitted completions checked, "
          f"{mc['bound_violations']} bound violations, "
          f"{mc['deadline_misses']} unpromised misses, "
          f"{mc['wcet_overruns']} WCET overruns")

    # -- report + export --------------------------------------------------
    for line in tc.format_table("response_us"):
        print(f"[trace] {line}")
    cnt = tc.counters()
    print(f"[trace]   collector health: {len(tc)} events retained, "
          f"{cnt['dropped_events']} dropped (ring overflow), "
          f"{cnt['subscriber_error_count']} subscriber errors")
    n_ev = tc.export_chrome(args.out)
    print(f"[trace] wrote {n_ev} trace events to {args.out} "
          f"(load in chrome://tracing or ui.perfetto.dev)")
    if args.csv:
        n_rows = tc.export_csv(args.csv)
        print(f"[trace] wrote {n_rows} event rows to {args.csv}")
    for v in tc.monitor.ledger:
        print(f"[trace] ledger: {v.kind} req={v.request_id} "
              f"late={v.lateness_us:.0f}us {v.detail}")
    rt.dispose()
    if args.no_check:
        return 0
    if not timeline_ok:
        print("[trace] FAIL: preemption timeline not reconstructed",
              file=sys.stderr)
        return 1
    if not bounds_ok:
        print("[trace] FAIL: admitted workload violated its response-time "
              "bounds", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
