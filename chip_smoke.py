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
5. a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name/power-limit
   line, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.persistent import reap_deferred  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak operation rates by
# input type; the FFMA kernels' f32 inputs are held to the non-tensor rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # summation order
LOGITS_ATOL = 0.25    # kernel vs plain attention through 32 bf16 layers
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
}


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
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(SERVE_ARGS + extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: s["wrapper"].launches for n, s in KERNELS.items()}
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
                # the mangled name's template arguments: D and the dtype
                fn = line.split("kernel", 1)[-1].split("EEvP")[0]
            elif "registers" in line or "spill stores" in line:
                log(f"ptxas {src.stem} {fn}: {line.split(':', 1)[-1].strip()}")

    checks = kernel_checks()
    host = serve_run("host_prefill", [])
    chunked = serve_run("chunked_prefill", ["--chunked-prefill",
                                            "--prefill-chunk", "8"])
    missing = [n for n, c in host.items() if c == 0]
    if chunked["decode_attention"] == 0:
        missing.append("decode_attention (chunked prefill)")
    if missing:
        raise SystemExit(f"main path never launched: {missing}")
    logits_check()

    kernels = []
    for name, spec in KERNELS.items():
        row = checks[name]
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"], "launches": host[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "launches_chunked_prefill": chunked[name]})
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
