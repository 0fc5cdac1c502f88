#!/usr/bin/env python3
"""K6 (``ssd_chunk``) in turns with an earlier tree's kernel, and by parts:
it builds this checkout's source, the other tree's and variants of this
tree's with one part taken out or changed, all at once (one ``nvcc``
each), then times every version on the same inputs with CUDA-graph replay
(``chip_smoke.time_ms``).

    python3 scripts/ssd_turns.py --parent DIR   # needs one CUDA device
    python3 scripts/ssd_turns.py --check        # the edits apply (no card)

``--parent`` is a checkout of the earlier commit (``git archive`` unpacked
into ``scratch_tree/parent``): its ``kernel.py`` wrapper is loaded under
another name, with its own source. Every version is timed in the order
parent, this tree, this tree, parent, so drift shows; the first two rounds
also hold each against the plain version (1e-4). A variant with a part
taken out computes wrong results: only its time means something.

Shapes: mamba2-780m's widths (48 heads x 64, state 128) at the serve
shape (one 17-row chunk), at B=1 S=2048 (8 chunks of 256) and at B=4
S=256. Variants:

- ``no_ring``: the next stage's load is waited for as soon as it is issued
  (no load in flight while a stage is multiplied);
- ``no_products``: every tensor-core instruction replaced by an xor of
  its operands (loads,
  splits, exponentials and epilogue stay);
- ``one_tf32``: one TF32 product (big halves) in place of three (the
  small halves unused: the 3xTF32 products' cost);
- ``no_split_pass``: the landed stage is not split (nor x transposed) for
  the products, which read stale halves;
- ``cvt_split``: tf32 rounding by ``cvt.rna.tf32.f32`` in place of the
  integer add-and-mask (the first draft's split);
- ``y_only`` / ``state_only``: the CTAs of the other kind return at once
  (each kind's share of the launch);
- ``no_g``: no G = C_i B_j^T products (W from zeros);
- ``no_w_exp``: W without the decay's exponential and mask (G + cum + dt);
- ``no_loads``: only the first stage is loaded (the later ones reuse it);
- ``trunc_split``: big halves by truncation and small halves unrounded
  (the tensor cores read their top 19 bits): 2 instructions a split, not 5;
- ``phases``: clock64 spans of each warp's stage, by phase and block kind
  (split pass, next load issued, G, products, load wait and barrier; A
  fragments, products issued and waited for), printed as shares;
- ``heads1`` / ``heads2`` / ``heads4``: the instance forced (heads a CTA)
  where the shape rule picks its own.

It also times an eager call on the host clock (launch included) for both
trees and prints each version's ptxas registers and spills. Imports no
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

K6_REL = Path("src/repro_torch/kernels/ssd_scan")

RING = """    cp_commit();
    const int j0 = kb * BJ;"""
NO_RING = """    cp_commit();
    cp_wait_all();
    const int j0 = kb * BJ;"""
WGMMA = "                                          uint64_t db) {\n  asm volatile("
NO_WGMMA = ("                                          uint64_t db) {\n"
            "  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ "
            "(uint32_t)db);\n  if (false) asm volatile(")
CROSS_WG = """      wgmma_n64(p, as[s], kmajor_sw128_desc(big + k));
      wgmma_n64(p, ab[s], kmajor_sw128_desc(big + 4 * XT_FLOATS + k));
"""
CROSS_G = """      wgmma_n32(p, as[k], kmajor_sw128_desc(bbig + blk + 32 * k));
      wgmma_n32(p, ab[k], kmajor_sw128_desc(bsmall + blk + 32 * k));
"""
SPLIT_A = "  for (int r = 0; r < 4; ++r) split(a[r], ab[r], as[r]);"
ONE_A = "  for (int r = 0; r < 4; ++r) { ab[r] = tf32_rna(a[r]); as[r] = 0u; }"
SPLIT_PASS = "    split_stage<HB>(smem, lo, state_blk, s4);"
RNA = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;"
BLOCK_KIND = "  const bool state_blk = order >= 1 && order <= nsb;"
Y_ONLY = BLOCK_KIND + "\n  if (state_blk) return;"
STATE_ONLY = BLOCK_KIND + "\n  if (!state_blk) return;"
G_PART = "      product_g(gacc, smem + lo.c"
NO_G = ("      for (int i = 0; i < 16; ++i) gacc[i] = 0.f;\n"
        "      if (false) product_g(gacc, smem + lo.c")
W_EXP = """                         return live ? gv *
                                           ex2(fminf(c_i - cj[l], 0.f) * LOG2E) *
                                           dj[l]
                                     : 0.f;"""
NO_W_EXP = "                         return gv + c_i + cj[l] + dj[l];"
NEXT_LOAD = "      fill_stage<HB>(smem, lo, xc, dtc, cumc, Bc, (kb + 1) * BJ,"
NO_LOADS = "      if (false) fill_stage<HB>(smem, lo, xc, dtc, cumc, Bc, (kb + 1) * BJ,"
SMALL_RNA = "  small = tf32_rna(v - __uint_as_float(big));"
SMALL_RAW = "  small = __float_as_uint(v - __uint_as_float(big));"
TRUNC = "  return __float_as_uint(v) & 0xffffe000u;"
# the phases variant: clock64 spans per warp, summed into g_phase[kind * 8
# + phase] (kind 1: state blocks): 0 split pass, 1 next load issued, 2 G,
# 3 products, 4 wait for the load and the barrier; 5 A fragments formed,
# 6 products issued and waited for (both kinds)
PH_HEAD = "#include <stdint.h>\n"
PH_DEFS = """#include <stdint.h>
__device__ unsigned long long g_phase[16];
__device__ __forceinline__ void phase_add(int i, unsigned long long& t) {
  const unsigned long long n = clock64();
  if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase[i], n - t);
  t = n;
}
extern "C" int k6_phases(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (e == cudaSuccess && reset) {
    unsigned long long z[16] = {0};
    e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)e;
}
"""
PH_EDITS = [
    ("  for (int kb = 0; kb < nkb; ++kb) {\n    split_stage<HB>(smem, lo, state_blk, s4);",
     "  unsigned long long _t = clock64();\n  for (int kb = 0; kb < nkb; ++kb) {\n"
     "    split_stage<HB>(smem, lo, state_blk, s4);"),
    ("    __syncthreads();                        // split; the raw stage is free",
     "    __syncthreads();                        // split; the raw stage is free\n"
     "    phase_add(8 * state_blk + 0, _t);"),
    ("    cp_commit();\n    const int j0 = kb * BJ;",
     "    cp_commit();\n    phase_add(8 * state_blk + 1, _t);\n    const int j0 = kb * BJ;"),
    ("      // W = G * exp(cum_i - cum_j) * dt_j (j > i masked), A of W xT",
     "      phase_add(2, _t);\n      // W = G * exp(cum_i - cum_j) * dt_j (j > i masked), A of W xT"),
    ("    cp_wait_all();                          // stage kb + 1 landed (this thread)",
     "    phase_add(8 * state_blk + 3, _t);\n"
     "    cp_wait_all();                          // stage kb + 1 landed (this thread)"),
    ("    __syncthreads();                        // ... for all; xT, B_j halves free",
     "    __syncthreads();                        // ... for all; xT, B_j halves free\n"
     "    phase_add(8 * state_blk + 4, _t);"),
    ("    uint32_t ab[BJ / 8][4], as[BJ / 8][4];\n#pragma unroll\n    for (int s = 0; s < BJ / 8; ++s) {\n      if (s >= nsteps) break;\n      float a[4];",
     "    uint32_t ab[BJ / 8][4], as[BJ / 8][4];\n    unsigned long long _a = clock64();\n"
     "#pragma unroll\n    for (int s = 0; s < BJ / 8; ++s) {\n      if (s >= nsteps) break;\n      float a[4];"),
    ("    float p[32];\n#pragma unroll\n    for (int i = 0; i < 32; ++i) p[i] = 0.f;\n    wgmma_fence();",
     "    phase_add(5, _a);\n    float p[32];\n#pragma unroll\n    for (int i = 0; i < 32; ++i) p[i] = 0.f;\n    wgmma_fence();"),
    ("    fence_regs(p);\n#pragma unroll\n    for (int i = 0; i < 32; ++i) acc[hh][i] += p[i];",
     "    fence_regs(p);\n    phase_add(6, _a);\n#pragma unroll\n"
     "    for (int i = 0; i < 32; ++i) acc[hh][i] += p[i];"),
]
PHASE_NAMES = ["split pass", "next load issued", "G", "products",
               "load wait + barrier", "A fragments", "wgmma issue + wait"]
CVT = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;"""

CASES = {
    "B1_C1_L17_serve": (1, 1, 17),
    "B1_S2048_C8_L256": (1, 8, 256),
    "B4_S256_C1_L256": (4, 1, 256),
}
H, P, N = 48, 64, 128


def variants(src: str) -> dict:
    for part in (RING, WGMMA, CROSS_WG, CROSS_G, SPLIT_A,
                 SPLIT_PASS, RNA, BLOCK_KIND, G_PART, W_EXP, NEXT_LOAD,
                 SMALL_RNA, PH_HEAD, *(old for old, _ in PH_EDITS)):
        if part not in src:
            raise SystemExit(f"ssd_scan.cu no longer holds:\n{part}")
    phases = src.replace(PH_HEAD, PH_DEFS, 1)
    for old, new in PH_EDITS:
        phases = phases.replace(old, new)
    return {
        "no_ring": src.replace(RING, NO_RING),
        "no_products": src.replace(WGMMA, NO_WGMMA),
        "one_tf32": src.replace(CROSS_WG, "").replace(CROSS_G, "").replace(
            SPLIT_A, ONE_A),
        "no_split_pass": src.replace(SPLIT_PASS, ""),
        "cvt_split": src.replace(RNA, CVT),
        "y_only": src.replace(BLOCK_KIND, Y_ONLY),
        "state_only": src.replace(BLOCK_KIND, STATE_ONLY),
        "no_g": src.replace(G_PART, NO_G),
        "no_w_exp": src.replace(W_EXP, NO_W_EXP),
        "no_loads": src.replace(NEXT_LOAD, NO_LOADS),
        "trunc_split": src.replace(RNA, TRUNC).replace(SMALL_RNA, SMALL_RAW),
        "phases": phases,
    }


def load_wrapper(name: str, kernel_py: Path, source: Path | None = None):
    """A fresh copy of a wrapper module (``kernel.py``), bound to its own
    library: ``source`` replaces the module's CUDA source."""
    spec = importlib.util.spec_from_file_location(name, kernel_py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if source is not None:
        mod.SOURCE = Path(source)
    mod._lib = None
    return mod


def log(msg: str) -> None:
    print(f"[ssd_turns] {msg}", flush=True)


def time_version(mod, args, check: bool):
    import torch
    err = None
    if check:
        got = mod.ssd_chunk(*args)
        want = mod.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.allclose(g, w, rtol=cs.SSD_TOL, atol=cs.SSD_TOL)
                   for g, w in zip(got, want)):
            raise SystemExit(f"{mod.__name__}: K6 disagrees ({err})")
    return cs.time_ms(lambda: mod.ssd_chunk(*args)), err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="checkout of the earlier commit to time in turns")
    ap.add_argument("--check", action="store_true",
                    help="only check that every edit applies")
    args = ap.parse_args(argv)
    src = (ROOT / K6_REL / "csrc" / "ssd_scan.cu").read_text()
    var = variants(src)
    if args.check:
        log(f"K6 variants {', '.join(var)}")
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ssd_turns: needs a CUDA device", file=sys.stderr)
        return 2
    if args.parent is None:
        raise SystemExit("--parent DIR is needed")
    parent = args.parent.resolve()
    log(f"{cs.smi_line()} | parent={parent}")
    out = _build.BUILD_DIR / "turns"
    out.mkdir(parents=True, exist_ok=True)
    mods = {"parent": load_wrapper("k6_parent", parent / K6_REL / "kernel.py"),
            "as_is": load_wrapper("k6_as_is", ROOT / K6_REL / "kernel.py")}
    for name, text in var.items():
        path = out / f"ssd_scan_{name}.cu"
        path.write_text(text)
        mods[name] = load_wrapper(f"k6_{name}", ROOT / K6_REL / "kernel.py",
                                  path)
    took = _build.build_all([m.SOURCE for m in mods.values()])
    log(f"built {len(took)} sources in {max(took.values(), default=0):.1f}s")
    for name, m in mods.items():
        logf = _build.library_path(m.SOURCE)
        logf = logf.with_name(logf.name + ".log")
        fn = "?"
        for line in logf.read_text().splitlines() if logf.exists() else ():
            if "Compiling entry function" in line:
                fn = line.split("'")[1][-40:]
            if "registers" in line or "spill stores" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    inputs = {case: cs.ssd_chunk_args(B, C, L, H, P, N, rng)
              for case, (B, C, L) in CASES.items()}
    lib = mods["as_is"].library()
    for case, a in inputs.items():
        B, C, L = CASES[case]
        log(f"K6 {case} shape rule: {lib.k6_heads_for(B, C, L, H, N)} heads "
            f"a CTA")
        for rnd, who in enumerate(("parent", "as_is", "as_is", "parent")):
            m = mods[who]
            ms, err = time_version(m, a, check=rnd < 2)
            host = cs.host_ms(lambda: m.ssd_chunk(*a), iters=200)
            log(f"K6 {case} {who:8s} kernel_ms={ms:.4f} eager_call_ms="
                f"{host:.4f}" + ("" if err is None else
                                 f" max_abs_err={err:.3e}"))
    ph = mods["phases"].library()
    ph.k6_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 16)()
    for case, a in inputs.items():
        ph.k6_phases(ctypes.addressof(buf), 1)
        mods["phases"].ssd_chunk(*a)
        torch.cuda.synchronize()
        ph.k6_phases(ctypes.addressof(buf), 1)
        for kind, base in (("y", 0), ("state", 8)):
            tot = sum(buf[base + i] for i in range(5)) or 1
            log(f"K6 phases {case} {kind} blocks: " + ", ".join(
                f"{PHASE_NAMES[i]} {100 * buf[base + i] / tot:.1f}%"
                for i in range(5)) + f" (warp-cycles {tot})")
        tot = buf[5] + buf[6] or 1
        log(f"K6 phases {case} products: " + ", ".join(
            f"{PHASE_NAMES[i]} {100 * buf[i] / tot:.1f}%" for i in (5, 6)))
    for rnd in range(2):
        for case, a in inputs.items():
            for name in ("as_is", *var):
                if name == "phases":
                    continue
                ms, _ = time_version(mods[name], a, check=False)
                log(f"K6 variants round {rnd} {case} {name:12s} "
                    f"kernel_ms={ms:.4f}")
            for hb in (1, 2, 4):
                lib.k6_force_heads(hb)
                try:
                    ms, err = time_version(mods["as_is"], a, check=rnd == 0)
                finally:
                    lib.k6_force_heads(0)
                log(f"K6 variants round {rnd} {case} heads{hb:<7d} "
                    f"kernel_ms={ms:.4f}"
                    + ("" if err is None else f" max_abs_err={err:.3e}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
