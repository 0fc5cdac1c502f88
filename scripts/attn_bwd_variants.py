#!/usr/bin/env python3
"""Where K5-bwd's time goes: it builds variants of ``flash_attention.cu``
with one choice of the bf16 backward changed, prints each variant's ptxas
report for the backward's kernels (registers, spills), and times each at
``chip_smoke.py``'s training rows (llama3-8b 32/8 x 128 bf16 causal at B=1
S=4096 and S=2048, whisper-tiny's 17 x 1500 cross-attention), every variant
twice, in turns, with the device time of each of its launches from a
``torch.profiler`` pass.

    python3 scripts/attn_bwd_variants.py            # needs one CUDA device
    python3 scripts/attn_bwd_variants.py --check    # the edits apply (no card)

Every variant computes the same gradients (checked against the plain
backward at 2e-2 x the largest |want|). Variants:

- ``as_is``: the kernel as committed;
- ``hold_both``: at D = 128 each consumer warpgroup owns 64 keys of a
  128-key block and holds both its dK and its dV, as D <= 64 does, instead
  of the split by product over a 64-key block;
- ``no_dq_split``: dQ's key tiles are never split over several CTAs.

Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

SPLIT = "static constexpr bool SPLIT = DC >= 128;"
DQ_SPLIT = "  if (items >= sms) return 1;"
CASES = (("llama3_8b_B1_S4096", 1, 4096, 4096, 32, 8, 128, True),
         ("llama3_8b_B1_S2048", 1, 2048, 2048, 32, 8, 128, True),
         ("whisper_cross_17x1500", 1, 17, 1500, 6, 6, 64, False))


def variants(src: str) -> dict:
    for part in (SPLIT, DQ_SPLIT):
        if part not in src:
            raise SystemExit(f"flash_attention.cu no longer holds:\n{part}")
    return {
        "as_is": src,
        "hold_both": src.replace(SPLIT, SPLIT.replace("128", "256")),
        "no_dq_split": src.replace(DQ_SPLIT, "  return 1;"),
    }


def build(name: str, text: str, out: Path) -> subprocess.Popen:
    src = out / f"{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [cs._build._nvcc(), *cs._build.NVCC_FLAGS, "-o",
         str(out / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(name: str, log: str) -> None:
    """Registers and spills of the bf16 backward's kernels."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_bwd_\w+?kernel)(ILi(\d+)E)?", line)
            kernel = None
            if m and ("wgmma" in m.group(1) or "sum" in m.group(1)
                      or "prep" in m.group(1)):
                kernel = m.group(1) + (f"<{m.group(3)}>" if m.group(3)
                                       else "")
        elif kernel and ("registers" in line or "spill stores" in line):
            print(f"[attn_bwd_variants] ptxas {name} {kernel}: "
                  f"{line.split(':', 1)[-1].strip()}", flush=True)


def launches_ms(args, kw, calls: int = 5) -> dict:
    """Device ms a call of each of K5-bwd's launches, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    FK.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            FK.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            m = re.search(r"flash_bwd_(\w+?)_(wgmma_)?kernel", e.name)
            key = m.group(1) if m else e.name[:24]
            out[key] = out.get(key, 0.0) + e.device_time_total / calls / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="only check that every edit applies")
    args = ap.parse_args(argv)
    vs = variants(FK.SOURCE.read_text())
    if args.check:
        print(f"[attn_bwd_variants] {len(vs)} variants: {', '.join(vs)}")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("attn_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[attn_bwd_variants] {cs.smi_line()}", flush=True)
    out = cs._build.BUILD_DIR / "attn_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: build(n, t, out) for n, t in vs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} did not build:\n{log}")
        ptxas_report(name, log)
    own_lib, own_load = FK._lib, FK._build.load
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inputs = {}
    for case, B, Sq, Skv, Hq, Hkv, D, causal in CASES:
        q = cs._randn((B, Sq, Hq, D), torch.bfloat16, gen)
        k = cs._randn((B, Skv, Hkv, D), torch.bfloat16, gen)
        v = cs._randn((B, Skv, Hkv, D), torch.bfloat16, gen)
        do = cs._randn((B, Sq, Hq, D), torch.bfloat16, gen)
        kw = dict(causal=causal)
        o, lse = FK.flash_attention_lse_plain(q, k, v, **kw)
        o = o.contiguous()
        want = FK.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        inputs[case] = ((q, k, v, o, lse, do), kw, want)
    for rnd in range(2):                   # every variant twice, in turns
        for name in vs:
            FK._lib = None
            FK._build.load = lambda _src, n=name: ctypes.CDLL(
                str(out / f"{n}.so"))
            FK.library()
            for case, (a, kw, want) in inputs.items():
                got = FK.flash_attention_bwd(*a, **kw)
                torch.cuda.synchronize()
                err = max(float((g.float() - w.float()).abs().max()) /
                          float(w.float().abs().max())
                          for g, w in zip(got, want))
                ms = cs.time_ms(lambda: FK.flash_attention_bwd(*a, **kw),
                                iters=5)
                parts = launches_ms(a, kw) if rnd == 0 else {}
                print(f"[attn_bwd_variants] round {rnd} {name:11s} "
                      f"{case:22s} kernel_ms={ms:.4f} worst_err/max|want|="
                      f"{err:.3e} (tolerance 2e-2)" + "".join(
                          f" {k}={x:.4f}" for k, x in parts.items()),
                      flush=True)
                if err > 2e-2:
                    raise SystemExit(f"{name} {case}: gradients off")
    FK._build.load = own_load
    FK._lib = own_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
