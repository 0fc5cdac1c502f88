#!/usr/bin/env python3
"""Where the drain kernel's (K1's) time goes: it builds variants of
``persistent.cu`` with one part taken out or changed, times each on the
smoke's matmul queue at C = 1 and C = 132 (``chip_smoke.py``'s tile checks),
and measures the card's ``mma.sync`` m16n8k8 TF32 rate alone.

    python3 scripts/drain_variants.py            # needs one CUDA device
    python3 scripts/drain_variants.py --check    # the edits apply (no card)

A variant with a part taken out computes wrong results: only its time
means something (the difference to ``as_is`` is that part's cost, where the
parts do not overlap). Variants:

- ``as_is``: the kernel as committed;
- ``no_math``: no fragment reads or tensor-core math (loads, splits,
  epilogue, row overhead);
- ``no_split``: the stages are not split (loads, math, epilogue);
- ``row_only``: neither (loads, epilogue, row overhead);
- ``no_d_read``: the epilogue writes D without reading it;
- ``grid_2x4``: 8 warps in a 2 x 4 grid (64 accumulators a thread);
- ``int_round``: tf32 rounding by integer arithmetic instead of
  ``cvt.rna.tf32.f32`` (the same rounding).

Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.persistent import kernel as K  # noqa: E402

MATH = """        mma_tf32(p, as, bx[nt], nullptr);
        mma_tf32(p, ax, bs[nt], p);
        mma_tf32(p, ab, bb[nt], p);"""
NO_MATH = """        p[0] = p[1] = p[2] = p[3] = 0.f;"""
SPLITS = (
    "nonfinite |= split_part(next, next_small, k8 / 8 * STEP_PARTS + q);",
    "nonfinite |= split_part(ring, small, r);")
D_READ = "float2 v = *p;"
GRID = "constexpr int DRAIN_WARPS_M = 4;\nconstexpr int DRAIN_WARPS_N = 4;"
RNA = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;             // tf32 in f32's layout, low bits clear"""
RNA_INT = """  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) == 0x7f800000u ? u : (u + 0x1000u) & 0xffffe000u;"""

# one HMMA into each of NCH long-lived accumulators per step: the
# accumulator chain keeps every instruction, so the rate is the card's
HMMA_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NCH>
__global__ void hmma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i) & 0xffffe000u;
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  float acc[NCH][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  float s = 0.f;
  for (int c = 0; c < NCH; ++c)
    for (int r = 0; r < 4; ++r) s += acc[c][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int hmma_run(int blocks, int threads, int iters, void* out) {
  hmma_rate<16><<<blocks, threads>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def _without_splits(src: str) -> str:
    for part in SPLITS:
        src = src.replace(part, "{}")
    return src


def variants(src: str) -> dict:
    for part in (MATH, *SPLITS, D_READ, GRID, RNA):
        if part not in src:
            raise SystemExit(f"persistent.cu no longer holds:\n{part}")
    no_math = src.replace(MATH, NO_MATH)
    return {
        "as_is": src,
        "no_math": no_math,
        "no_split": _without_splits(src),
        "row_only": _without_splits(no_math),
        "no_d_read": src.replace(D_READ, "float2 v = make_float2(0.f, 0.f);"),
        "grid_2x4": src.replace(GRID, GRID.replace("M = 4", "M = 2")),
        "int_round": src.replace(RNA, RNA_INT),
    }


def build(name: str, text: str, out: Path) -> subprocess.Popen:
    src = out / f"{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [cs._build._nvcc(), *cs._build.NVCC_FLAGS, "-o",
         str(out / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_drain(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.persistent_drain.argtypes = [vp] * 9 + [ci, ci, ci, ci, vp]
    lib.persistent_drain.restype = ci
    lib.persistent_error_string.argtypes = [ci]
    lib.persistent_error_string.restype = ctypes.c_char_p
    return lib


def hmma_rate(lib: ctypes.CDLL) -> None:
    import torch
    lib.hmma_run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty(132 * 512, device="cuda")
    for blocks in (1, 132):
        for threads in (256, 512):
            lib.hmma_run(blocks, threads, 16, out.data_ptr())
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            iters = 2048
            start.record()
            err = lib.hmma_run(blocks, threads, iters, out.data_ptr())
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            per_sm = threads // 32 * iters * 16
            print(f"[drain_variants] hmma m16n8k8 tf32: blocks={blocks} "
                  f"threads={threads} err={err} {ms * 1e6 / per_sm:.3f} ns "
                  f"an HMMA an SM = "
                  f"{per_sm * 2048 * blocks / ms / 1e9:.1f} TFLOP/s",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="only check that every edit applies")
    args = ap.parse_args(argv)
    vs = variants(K.SOURCE.read_text())
    if args.check:
        print(f"[drain_variants] {len(vs)} variants: {', '.join(vs)}")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("drain_variants: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[drain_variants] {cs.smi_line()}", flush=True)
    out = cs._build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "hmma.cu").write_text(HMMA_SRC)
    procs = {n: build(n, t, out) for n, t in vs.items()}
    hmma = subprocess.run(
        [cs._build._nvcc(), *cs._build.NVCC_FLAGS, "-o",
         str(out / "hmma.so"), str(out / "hmma.cu")],
        capture_output=True, text=True)
    if hmma.returncode:
        raise SystemExit(hmma.stdout + hmma.stderr)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} did not build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill stores" in line:
                print(f"[drain_variants] ptxas {name}: {line.strip()}")
    hmma_rate(ctypes.CDLL(str(out / "hmma.so")))
    inp = cs.tile_inputs()
    ws, carry, tick, (ctrl, ring) = (inp["ws"], inp["carry"], inp["tick"],
                                     inp["matmul"])
    one = cs.one_cluster(ctrl, ring, 0)
    for rnd in range(2):                   # every variant twice, in turns
        for name in vs:
            K._lib = load_drain(out / f"{name}.so")
            for label, args in (
                    ("C1", (*one, ws[:1], carry[:1], tick[:1])),
                    (f"C{cs.TILE_C}", (ctrl, ring, ws, carry, tick))):
                r = cs.tile_case("persistent_drain", f"{name}_{label}",
                                 *args, time_it=True)
                print(f"[drain_variants] round {rnd} {name:10s} {label:5s} "
                      f"kernel_ms={r['ms']:.4f} "
                      f"us_per_row={r['ms'] * 1e3 / cs.TILE_Q:.2f} "
                      f"agrees_with_plain={r['ok']}", flush=True)
    K._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
