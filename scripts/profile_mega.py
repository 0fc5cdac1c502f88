#!/usr/bin/env python3
"""Where the megakernel dispatch path of the PyTorch port spends its time.

    python3 scripts/profile_mega.py

Runs two phases of ``chip_smoke.py`` on one GPU, each once on the host
clock and once under ``torch.profiler``: mega vs scan through ``LkSystem``
on one cluster (512 tile items), and ``LkSystem(runtime="mega")`` on 132
clusters of the card with the flight recorder (8448 items). For each
profiled submit-and-drain window it prints the window's wall time, the
device's busy time (the union of every kernel, copy and memset interval on
the card, so work that overlaps on several streams counts once), the summed
kernel time, and the kernels and copies by device time. Last, an overlap
probe: 132 ``MegaRuntime`` workers, each on its own stream, take one full
matmul queue each, twice (the first round allocates each launch's pinned
staging buffer, the second finds them cached); if their launches overlap on
the card, the busy union is far below the summed kernel time. Needs one
CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import mailbox as mb  # noqa: E402
from repro_torch.core.mega import MegaRuntime  # noqa: E402
from repro_torch.core.persistent import reap_deferred  # noqa: E402
from repro_torch.kernels import persistent as PK  # noqa: E402


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def report(label: str, prof, window_ms: float, top: int = 8) -> None:
    dev = [e for e in prof.events()
           if e.device_type.name == "CUDA" and e.time_range.end
           > e.time_range.start]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy = busy_us(spans) / 1e3
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    print(f"[profile] {label}: window={window_ms:.3f}ms device busy "
          f"(union)={busy:.3f}ms ({100 * busy / window_ms:.2f}% of the "
          f"window, idle {100 * (1 - busy / window_ms):.2f}%); "
          f"{len(kern)} kernels summing "
          f"{sum(e.time_range.end - e.time_range.start for e in kern) / 1e3:.3f}"
          f"ms, {len(dev) - len(kern)} copies/memsets", flush=True)
    if not dev:
        print(f"[profile] {label}: the profiler recorded no device time")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :top]:
        print(f"[profile] {label}: {ms:9.3f} ms  x{n:5d}  "
              f"{ms / n * 1e3:8.2f} us each  {name[:80]}")


def overlap_probe(around) -> None:
    rts = []
    for c in range(cs.TILE_C):
        rt = MegaRuntime(max_steps=cs.TILE_Q, max_inflight=cs.TILE_Q,
                         device=cs.DEVICE)
        rt.boot(PK.tile_state(cs.TILE_NBUF, seed=c))
        rts.append(rt)
    descs = [mb.WorkDescriptor(opcode=PK.OP_MATMUL, request_id=i,
                               arg0=PK.pack_args(2 + i % 6, i % 2)[0],
                               arg1=(i + 1) % 2) for i in range(cs.TILE_Q)]
    torch.cuda.synchronize()
    for label in ("cold_pinned_cache", "warm_pinned_cache"):
        with around(f"overlap[{label}]"):
            for rt in rts:
                rt.trigger_many(descs)
            for rt in rts:
                rt.wait_all()
    t0 = time.perf_counter()           # once more, on the host clock alone
    for rt in rts:
        rt.trigger_many(descs)
    t1 = time.perf_counter()
    for rt in rts:
        rt.wait_all()
    t2 = time.perf_counter()
    print(f"[profile] overlap[warm_unprofiled]: {cs.TILE_C} full queues "
          f"in {(t2 - t0) * 1e3:.3f}ms wall: issuing them took "
          f"{(t1 - t0) * 1e3:.3f}ms ({(t1 - t0) / cs.TILE_C * 1e6:.1f} us "
          f"a launch of {cs.TILE_Q} rows), retiring them "
          f"{(t2 - t1) * 1e3:.3f}ms", flush=True)
    for rt in rts:
        rt.dispose()
    reap_deferred()


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("profile_mega: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[profile] {cs.smi_line()} | CUDA_DEVICE_MAX_CONNECTIONS="
          f"{os.environ.get('CUDA_DEVICE_MAX_CONNECTIONS', 'unset')}",
          flush=True)
    cs._build.build_all()

    @contextlib.contextmanager
    def traced(label):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        report(label, prof, window_ms)

    for phase in (cs.mega_vs_scan_run, cs.full_width_system_run):
        phase()                          # host clock, unprofiled
        phase(around=traced)
    overlap_probe(traced)
    return 0


if __name__ == "__main__":
    sys.exit(main())
