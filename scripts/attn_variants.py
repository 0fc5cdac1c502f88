#!/usr/bin/env python3
"""Where K5's time goes: it builds variants of ``flash_attention.cu`` with
one part of the bf16 kernel taken out or changed, and times each at the
shapes ``chip_smoke.py`` checks (llama3-8b heads 32/8, D=128, bf16: B=1
S=2048 causal, B=1 S=17 causal), every variant twice, in turns.

    python3 scripts/attn_variants.py            # needs one CUDA device
    python3 scripts/attn_variants.py --check    # the edits apply (no card)

A variant with a part taken out computes wrong results: only its time
means something (the difference to ``as_is`` is that part's cost, where the
parts do not overlap). Variants:

- ``as_is``: the kernel as committed;
- ``serial``: a tile's softmax waits for the previous tile's P·V (no
  overlap of softmax and tensor cores inside a warpgroup);
- ``no_mask``: no tile is masked (the diagonal's included);
- ``no_exp``: the softmax without its exponentials (a subtraction);
- ``no_pv``: no P·V products (Q·Kᵀ, softmax, loads, epilogue);
- ``stages3``: a 3-stage ring at D=128 (230,656 bytes of shared memory);
- ``no_pingpong``: the consumer warpgroups issue their products without
  taking turns;
- ``no_short``: S <= 64 takes the 128-key instance, not the 64-key one;
- ``grid_per_item``: one CTA a work item (a grid of every item) instead
  of a persistent grid of one CTA an SM;
- ``exp2f``: the softmax's exponentials by ``exp2f`` instead of
  ``ex2.approx.ftz``.

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
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

WAIT_QK = "wgmma_wait<1>();                              // Q·Kᵀ done"
EDGE = "      if (edge) {"
EXP = "sc[i] = ex2(sc[i] - m[r]);"
EX2 = "ex2(m[r] - m_new);"
PINGPONG = "const bool pingpong = active == CONSUMERS;"
PV = "Wgmma<DC>::rs(oacc, p[kk], dv, 1);"
STAGES = "constexpr int STAGES_D128 = 2;"
SHORT = "const bool short_s = S <= WG_ROWS;"
GRID = "const int grid = (int)(items < sms ? items : sms);"
CASES = (("B1_S2048_causal", 1, 2048), ("B1_S17_causal", 1, 17))


def variants(src: str) -> dict:
    for part in (WAIT_QK, EDGE, EXP, EX2, PV, STAGES, PINGPONG, SHORT, GRID):
        if part not in src:
            raise SystemExit(f"flash_attention.cu no longer holds:\n{part}")
    return {
        "as_is": src,
        "serial": src.replace(WAIT_QK, WAIT_QK.replace("<1>", "<0>")),
        "no_mask": src.replace(EDGE, "      if (false) {"),
        "no_exp": src.replace(EXP, "sc[i] = sc[i] - m[r];"),
        "no_pv": src.replace(PV, ""),
        "stages3": src.replace(STAGES, STAGES.replace("2;", "3;")),
        "no_pingpong": src.replace(PINGPONG,
                                   "const bool pingpong = false;"),
        "no_short": src.replace(SHORT, "const bool short_s = false;"),
        "grid_per_item": src.replace(GRID, "const int grid = (int)items;"),
        "exp2f": src.replace(EXP, EXP.replace("ex2", "exp2f")).replace(
            EX2, EX2.replace("ex2", "exp2f")),
    }


def build(name: str, text: str, out: Path) -> subprocess.Popen:
    src = out / f"{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [cs._build._nvcc(), *cs._build.NVCC_FLAGS, "-o",
         str(out / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k5_flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci, cf, vp]
    lib.k5_flash_attention_fwd.restype = ci
    lib.k5_error_string.argtypes = [ci]
    lib.k5_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="only check that every edit applies")
    args = ap.parse_args(argv)
    vs = variants(FK.SOURCE.read_text())
    if args.check:
        print(f"[attn_variants] {len(vs)} variants: {', '.join(vs)}")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("attn_variants: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[attn_variants] {cs.smi_line()}", flush=True)
    out = cs._build.BUILD_DIR / "attn_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: build(n, t, out) for n, t in vs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} did not build:\n{log}")
        for line in log.splitlines():
            if "C75" in line or ("wgmma_kernelILi128" in line
                                 and "Compiling" in line):
                print(f"[attn_variants] ptxas {name}: {line.strip()[:160]}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inputs = {}
    for case, B, S in CASES:
        q = cs._randn((B, S, 32, 128), torch.bfloat16, gen)
        k = cs._randn((B, S, 8, 128), torch.bfloat16, gen)
        v = cs._randn((B, S, 8, 128), torch.bfloat16, gen)
        inputs[case] = (q, k, v, FK.flash_attention_plain(q, k, v).float())
    for rnd in range(2):                   # every variant twice, in turns
        for name in vs:
            FK._lib = load(out / f"{name}.so")
            for case, (q, k, v, want) in inputs.items():
                got = FK.flash_attention(q, k, v)
                torch.cuda.synchronize()
                err = float((got.float() - want).abs().max())
                ms = cs.time_ms(lambda: FK.flash_attention(q, k, v))
                print(f"[attn_variants] round {rnd} {name:8s} {case:16s} "
                      f"kernel_ms={ms:.4f} max_abs_err={err:.3e}",
                      flush=True)
    FK._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
