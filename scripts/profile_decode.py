#!/usr/bin/env python3
"""Where a full-width decode step of the PyTorch port spends its time.

    python3 scripts/profile_decode.py [--arch llama3-8b] [--steps 8]
                                      [--trace PATH] [--root DIR]

Serves ``--arch`` (llama3-8b or mamba2-780m) at full width (random
weights from seed 0) through
``repro_torch.serving.ServingEngine`` on one GPU: 4 slots, 128-position
cache, 4 host-prefilled requests. After warm-up it times ``--steps`` decode
steps on the host clock (each ``engine.step()`` ends with the step's
readback, so it is synchronized), then records the same number of steps
with ``torch.profiler`` and prints the device's busy share of the window
and the kernels by device time. ``--root`` runs another checkout's
``src/repro_torch`` (an unpacked earlier commit), so two trees' steps can
be timed in turns in one call. Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace of the profiled steps")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="checkout whose src/repro_torch to run")
    args = ap.parse_args(argv)
    src = str(args.root.resolve() / "src")
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import build
    from repro_torch.serving import ServingEngine
    if not str(Path(sys.modules["repro_torch"].__file__).resolve()).startswith(
            src):
        raise SystemExit(f"imported {sys.modules['repro_torch'].__file__}, "
                         f"not {src}")
    print(f"[profile] root={args.root.resolve()}")
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    model = build(cfg, device="cuda")
    params = model.init(0)
    engine = ServingEngine(model, params, max_batch=4, max_seq=128,
                           device="cuda")
    rng = np.random.default_rng(0)
    for rid in range(4):
        engine.add_request(rid, rng.integers(0, cfg.vocab_size, 16),
                           max_new_tokens=2 * args.steps + 8)
    for _ in range(4):                       # inserts land, warm-up
        engine.step()
    torch.cuda.synchronize()

    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        engine.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] decode step wall (host clock, synchronized): "
          f"mean={np.mean(walls):.3f}ms min={np.min(walls):.3f}ms "
          f"max={np.max(walls):.3f}ms n={len(walls)}")

    launches0 = decode_attention.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    per_step = (decode_attention.launches - launches0) / args.steps
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile] window={window_ms:.3f}ms over {args.steps} steps; "
          f"device busy={busy_ms:.3f}ms ({100 * busy_ms / window_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / window_ms):.1f}%; "
          f"{n_kernels / args.steps:.0f} kernels per step, "
          f"{per_step:.0f} decode_attention launches per step")
    if not kernels:
        print("[profile] the profiler recorded no device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile] {e.self_device_time_total / 1e3 / args.steps:9.4f} "
              f"ms/step  {100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}%"
              f"  x{e.count // args.steps:4d}/step  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"[profile] wrote {args.trace}")
    engine.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
