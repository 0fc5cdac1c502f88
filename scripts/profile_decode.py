#!/usr/bin/env python3
"""Where a full-width decode step (or prefill) of the PyTorch port spends
its time.

    python3 scripts/profile_decode.py [--arch llama3-8b] [--steps 8]
                                      [--trace PATH] [--root DIR]
    python3 scripts/profile_decode.py --arch mamba2-780m --prefill 2048
                                      [--root DIR]

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

``--prefill N`` instead runs one N-token ``model.prefill`` of one prompt
(random tokens from seed 0) after a warm-up: it prints the host-clock wall
of ``--steps`` synchronized prefills, then profiles one and prints the
device's busy share of its window, the device time under each named part
of the model (ranges wrapped around the port's functions, where the tree
has them: the SSD's PyTorch part, its inter-chunk loop and ``y_inter``
einsum in ``kernels/ssd_scan/ops.py``, ``_causal_conv``'s loop and the
in-projections of ``models/ssm.py``; the hand-written K6 and K5 by kernel
name) and the device kernels by time.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace of the profiled steps")
    ap.add_argument("--prefill", type=int, default=0, metavar="N",
                    help="profile one N-token prefill instead of decode "
                    "steps")
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
    if args.prefill:
        return prefill_profile(args, cfg, model, params)
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


# (module, function, label): ranges put around the port's functions for
# --prefill; a module or function the tree lacks is left out. ssm.ssd is
# the name models/ssm.py calls. A range counts the device time of the
# PyTorch operators launched inside it; the hand-written kernels (K5, K6),
# launched through ctypes, are counted by name (HAND_WRITTEN).
PARTS = [
    ("repro_torch.models.ssm", "ssd",
     "SSD's PyTorch kernels (kernels/ssd_scan/ops.py ssd, K6 aside)"),
    ("repro_torch.kernels.ssd_scan.ops", "_chunk_states_in",
     "inter-chunk loop (ops.py _chunk_states_in)"),
    ("repro_torch.kernels.ssd_scan.ops", "_y_inter",
     "y_inter einsum (ops.py _y_inter)"),
    ("repro_torch.models.ssm", "_causal_conv",
     "causal conv loop (models/ssm.py _causal_conv)"),
    ("repro_torch.models.ssm", "_project",
     "in-projections (models/ssm.py _project)"),
]
HAND_WRITTEN = [("K6 ssd_chunk", r"ssd_\w*_kernel"),
                ("K5 flash_attention", r"flash_\w*kernel")]


def _ranged(fn, label):
    @functools.wraps(fn)
    def run(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)
    return run


def _device_us(e) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def prefill_profile(args, cfg, model, params) -> int:
    """--prefill: host wall of synchronized N-token prefills, then one
    profiled, broken down by the named parts (the device time of the
    kernels launched inside each range) and by kernel."""
    S = args.prefill
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)).cuda()
    batch = {"tokens": tokens}
    model.prefill(params, batch, S + 1)                    # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        model.prefill(params, batch, S + 1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] {args.arch} {S}-token prefill wall (host clock, "
          f"synchronized): mean={np.mean(walls):.3f}ms "
          f"min={np.min(walls):.3f}ms max={np.max(walls):.3f}ms "
          f"n={len(walls)} all={[round(w, 3) for w in walls]}")
    patched = []
    for mod_name, attr, label in PARTS:
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        if hasattr(mod, attr):
            patched.append((mod, attr, getattr(mod, attr), label))
            setattr(mod, attr, _ranged(getattr(mod, attr), label))
    try:
        model.prefill(params, batch, S + 1)                # ranges warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, batch, S + 1)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, fn, _ in patched:
            setattr(mod, attr, fn)
    # the ranges also show on the device's timeline, spanning their kernels
    labels = {label for *_, label in patched}
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0
               and e.key not in labels]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile] profiled prefill window={window_ms:.3f}ms; device "
          f"busy={busy_ms:.3f}ms ({100 * busy_ms / window_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / window_ms):.1f}%; {n_kernels} kernels")
    if not kernels:
        print("[profile] the profiler recorded no device time")
    events = prof.events()
    for _, _, _, label in patched:
        hits = [e for e in events
                if e.name == label and e.device_type.name == "CPU"]
        us = sum(_device_us(e) for e in hits)
        print(f"[profile] part {us / 1e3:9.4f} ms  "
              f"{100 * us / 1e3 / max(busy_ms, 1e-9):5.1f}%  x{len(hits):4d}  "
              f"{label}")
    for label, pattern in HAND_WRITTEN:
        hits = [e for e in kernels if re.search(pattern, e.key)]
        us = sum(e.self_device_time_total for e in hits)
        print(f"[profile] part {us / 1e3:9.4f} ms  "
              f"{100 * us / 1e3 / max(busy_ms, 1e-9):5.1f}%  "
              f"x{sum(e.count for e in hits):4d}  {label} (kernels by name)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile] kernel {e.self_device_time_total / 1e3:9.4f} ms  "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}%  "
              f"x{e.count:5d}  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"[profile] wrote {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
