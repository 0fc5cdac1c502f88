#!/usr/bin/env python3
"""K3 (``persistent_execute``) and K4 (``decode_attention``) in turns with
an earlier tree's kernels, and by parts: it builds this checkout's two
sources, the other tree's and variants of this tree's with one part taken
out or changed, all at once (one ``nvcc`` each), then times every version
on the same inputs with CUDA-graph replay (``chip_smoke.time_ms``), each
twice, in turns.

    python3 scripts/exec_decode_turns.py --parent DIR   # needs one CUDA device
    python3 scripts/exec_decode_turns.py --check        # the edits apply (no card)

``--parent`` is a checkout of the earlier commit (``git archive`` unpacked
into ``scratch_tree/parent``): its ``kernel.py`` wrappers are loaded under
other names, with their own sources. Every version is timed in the order
parent, this tree, this tree, parent, so drift shows. A variant with a
part taken out computes wrong results: only its time means something.

K3 on ``chip_smoke.py``'s matmul queue (C = 132, Q = 64, nbuf = 8) and its
tile-MLP demo shape (C = 132, Q = 4, nbuf = 5); variants:

- ``fresh8``: an 8-deep fresh accumulator (``EXEC_FRESH_K = 8``: each
  8-deep step's three products summed from 0, then added to the row's
  sum) instead of one a 32-deep k-block;
- ``stages3``: a ring of three raw k-blocks instead of two;
- ``no_math``: no tensor-core products (loads, splits, epilogue);
- ``no_split``: the landed k-blocks are not split (loads, products);
- ``no_math_split``: neither (loads, handshakes, epilogue);
- ``no_loads``: the producer copies nothing (the stages hold stale data);
- ``no_d_read``: D is not read (acc starts from 0);
- ``no_row_fence``: no proxy fence after a row's global writes;
- ``l2_evict_last``: the operands' copies ask L2 to keep their lines
  (``evict_last`` policy).

The variants run at C = 132 and at C = 1 (the queue's first cluster).

K4 at the serve shape (B=4, S=128, lengths [128, 1, 77, 64]), at B=4
S=4096 with ragged lengths [4096, 3000, 1025, 17] and with a 1024 window
(llama3-8b heads 32/8, D=128, bf16); variants:

- ``no_ring``: each tile loaded and waited for before it is used (no load
  in flight while a tile is scored and summed);
- ``two_launches``: an empty second kernel on the merge's grid after each
  launch (the cost of a second launch, not the parent's merge);
- ``no_math``: no Q·Kᵀ or P·V products, and so none of their fragment
  reads from shared memory (loads, softmax, merge);
- ``ffma``: the FFMA kernel (one warp a query head, as f32 takes) in
  place of the tensor-core one for bf16 at D=128;
- ``splits1`` ... ``splits8``: the cluster size forced.

It also times an eager K4 call on the host clock (launch included) for
both trees. Imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

K3_REL = Path("src/repro_torch/kernels/persistent")
K4_REL = Path("src/repro_torch/kernels/decode_attention")

FRESH = "constexpr int EXEC_FRESH_K = 32;"
STAGES = "constexpr int EXEC_STAGES = 2;"
CROSS = "    if (cross) {"
BIGBIG = "    if (bigbig) {"
SPLIT = "  bool nonfinite = false;\n#pragma unroll\n  for (int i = 0; i < PER; ++i) {"
COPIES = """          tma_load_2d(raw, tm_ws, sm.full(n), kb * EXEC_KB, a_row);
          bulk_load(raw + EXEC_KBLOCK_BYTES, B + kb * EXEC_KB * TILE,
                    EXEC_KBLOCK_BYTES, sm.full(n));"""
EXPECT = "          mbar_expect_tx(sm.full(n), EXEC_RAW_BYTES);"
D_READ = "      const float2 v = *reinterpret_cast<const float2*>(d0 + 8 * h * TILE + 8 * j);"
ROW_FENCE = "      fence_proxy_async_global();        // this row's writes, then the"
TMA_ASM = """  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");"""
TMA_HINT = """  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "l"(pol) : "memory");"""
BULK_ASM = """  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");"""
BULK_HINT = """  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\\n" ::"r"(dst), "l"(src),
      "r"(bytes), "r"(bar), "l"(pol) : "memory");"""

PROLOGUE = "    if (j < ntiles) issue(j);"
RING = """    cp_async_wait<STAGES - 2>();      // tile j has landed for this thread
    __syncthreads();                  // ... for every thread; tile j-1 consumed
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_async_commit();"""
NO_RING = """    __syncthreads();
    issue(j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();"""
ENTRY = 'extern "C" int k4_decode_attention('
SECOND = """
__global__ void second_kernel() {}

extern "C" int k4_decode_attention(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* out, int B, int S, int Hq, int Hkv,
                                   int D, int is_bf16, int n_split,
                                   float softcap, int window, float scale,
                                   void* stream) {
  const int err = k4_one_launch(q, k, v, valid_len, out, B, S, Hq, Hkv, D,
                                is_bf16, n_split, softcap, window, scale,
                                stream);
  if (err) return err;
  second_kernel<<<dim3(Hq, B), D, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
QK = """      ldmatrix_x4(kb, sK + (key0 + kr) * ST + ks * 16 + kc);
      mma_bf16(s[0], qf[ks], kb[0], kb[1]);
      mma_bf16(s[1], qf[ks], kb[2], kb[3]);"""
PV = """      ldmatrix_x4_trans(vb, sV + (key0 + vr) * ST + np * 16 + vc);
      mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);"""
MMA128 = "    case 128: return launch_mma<128>("
CFG = "template <> struct Cfg<256, __nv_bfloat16>"


def _need(src: str, parts, name: str) -> None:
    for part in parts:
        if part not in src:
            raise SystemExit(f"{name} no longer holds:\n{part}")


def k3_variants(src: str) -> dict:
    _need(src, (FRESH, STAGES, CROSS, BIGBIG, SPLIT, COPIES, EXPECT, D_READ,
                ROW_FENCE, TMA_ASM, BULK_ASM), "persistent.cu")
    no_math = src.replace(CROSS, "    if (false) {").replace(
        BIGBIG, "    if (false) {")
    return {
        "fresh8": src.replace(FRESH, FRESH.replace("32", "8")),
        "stages3": src.replace(STAGES, STAGES.replace("2", "3")),
        "no_math": no_math,
        "no_split": src.replace(
            SPLIT, SPLIT.replace("bool nonfinite = false;",
                                 "bool nonfinite = false;\n"
                                 "  if (PER > 0) return nonfinite;")),
        "no_math_split": no_math.replace(
            SPLIT, SPLIT.replace("bool nonfinite = false;",
                                 "bool nonfinite = false;\n"
                                 "  if (PER > 0) return nonfinite;")),
        "no_loads": src.replace(COPIES, "          (void)raw; (void)B; "
                                "(void)a_row;").replace(
            EXPECT, "          mbar_arrive(sm.full(n));"),
        "no_d_read": src.replace(D_READ, "      const float2 v = make_float2(0.f, 0.f);"),
        "no_row_fence": src.replace(ROW_FENCE, ""),
        "l2_evict_last": src.replace(TMA_ASM, TMA_HINT).replace(
            BULK_ASM, BULK_HINT),
    }


def k4_variants(src: str) -> dict:
    _need(src, (PROLOGUE, RING, ENTRY, QK, PV, MMA128, CFG),
          "decode_attention.cu")
    return {
        "no_ring": src.replace(PROLOGUE, "    (void)ntiles;").replace(
            RING, NO_RING),
        "two_launches": src.replace(ENTRY, "int k4_one_launch(") + SECOND,
        "no_math": src.replace(
            QK, "      s[0][0] += __uint_as_float(qf[ks][0]);").replace(
            PV, "      acc[2 * np][0] += __uint_as_float(pa[0]);"),
        "ffma": src.replace(
            CFG, "template <> struct Cfg<128, __nv_bfloat16> { static "
            "constexpr int BK = 64, STAGES = 3; };\n" + CFG).replace(
            MMA128, "    case 128: return launch_ffma<128, bf16>("),
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
    print(f"[turns] {msg}", flush=True)


def k3_inputs():
    import numpy as np
    import torch
    inp = cs.tile_inputs()
    rng = np.random.default_rng(1)
    ws = np.zeros((cs.TILE_C, 5, cs.PK.TILE, cs.PK.TILE), np.float32)
    ws[:, :3] = rng.standard_normal((cs.TILE_C, 3, cs.PK.TILE,
                                     cs.PK.TILE)) * 0.1
    demo = torch.from_numpy(cs.PK.build_queue(
        [cs.PK.mlp_program()] * cs.TILE_C, 4)).to(cs.DEVICE)
    return {"matmul_C132_Q64_nbuf8": (inp["matmul"][1], inp["ws"]),
            "mlp_demo_C132_Q4_nbuf5": (demo, torch.from_numpy(ws).to(
                cs.DEVICE))}


def k3_time(mod, ring, ws, check: bool) -> tuple[float, float | None]:
    import torch
    err = None
    if check:
        got = mod.persistent_execute(ring, ws.clone())
        want = mod.execute_plain(ring, ws.clone())
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        if not (torch.allclose(got[0], want[0], rtol=cs.TILE_TOL,
                               atol=cs.TILE_TOL)
                and torch.equal(got[1], want[1])):
            raise SystemExit(f"{mod.__name__}: K3 disagrees ({err})")
    w = ws.clone()
    return cs.time_ms(lambda: mod.persistent_execute(ring, w)), err


K4_CASES = {
    "B4_S128_ragged_bf16": (4, 128, [128, 1, 77, 64], 0),
    "B4_S4096_ragged_bf16": (4, 4096, [4096, 3000, 1025, 17], 0),
    "B4_S4096_window1024_bf16": (4, 4096, [4096, 2048, 1000, 300], 1024),
}


def k4_inputs() -> dict:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for name, (B, S, valid, window) in K4_CASES.items():
        q, k, v = (cs._randn(shape, torch.bfloat16, gen) for shape in (
            (B, 1, 32, 128), (B, S, 8, 128), (B, S, 8, 128)))
        vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        out[name] = (q, k, v, vl, window)
    return out


def k4_time(mod, args, check: bool, eager: bool = False):
    import torch
    q, k, v, vl, window = args
    err = None
    if check:
        got = mod.decode_attention(q, k, v, vl, window=window)
        want = mod.decode_attention_plain(q, k, v, vl, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= cs.ATOL[torch.bfloat16]:
            raise SystemExit(f"{mod.__name__}: K4 disagrees ({err})")
    ms = cs.time_ms(lambda: mod.decode_attention(q, k, v, vl, window=window))
    host = cs.host_ms(lambda: mod.decode_attention(q, k, v, vl,
                                                   window=window),
                      iters=200) if eager else None
    return ms, err, host


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="checkout of the earlier commit to time in turns")
    ap.add_argument("--check", action="store_true",
                    help="only check that every edit applies")
    ap.add_argument("--only", choices=("k3", "k4"),
                    help="time one kernel's versions only")
    args = ap.parse_args(argv)
    k3_src = (ROOT / K3_REL / "csrc" / "persistent.cu").read_text()
    k4_src = (ROOT / K4_REL / "csrc" / "decode_attention.cu").read_text()
    v3, v4 = k3_variants(k3_src), k4_variants(k4_src)
    if args.check:
        log(f"K3 variants {', '.join(v3)}; K4 variants {', '.join(v4)}")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("exec_decode_turns: needs a CUDA device", file=sys.stderr)
        return 2
    if args.parent is None:
        raise SystemExit("--parent DIR is needed")
    parent = args.parent.resolve()
    log(f"{cs.smi_line()} | parent={parent}")
    out = _build.BUILD_DIR / "turns"
    out.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for tag, variants, stem in (("k3", v3, "persistent"),
                                ("k4", v4, "decode_attention")):
        for name, text in variants.items():
            path = out / f"{stem}_{name}.cu"
            path.write_text(text)
            srcs[(tag, name)] = path
    mods = {
        ("k3", "parent"): load_wrapper("k3_parent",
                                       parent / K3_REL / "kernel.py"),
        ("k3", "as_is"): load_wrapper("k3_as_is", ROOT / K3_REL / "kernel.py"),
        ("k4", "parent"): load_wrapper("k4_parent",
                                       parent / K4_REL / "kernel.py"),
        ("k4", "as_is"): load_wrapper("k4_as_is", ROOT / K4_REL / "kernel.py"),
    }
    for (tag, name), path in srcs.items():
        rel = K3_REL if tag == "k3" else K4_REL
        mods[(tag, name)] = load_wrapper(f"{tag}_{name}",
                                         ROOT / rel / "kernel.py", path)
    took = _build.build_all([m.SOURCE for m in mods.values()])
    log(f"built {len(took)} sources in {max(took.values(), default=0):.1f}s")
    for (tag, name), m in mods.items():
        logf = _build.library_path(m.SOURCE)
        logf = logf.with_name(logf.name + ".log")
        for line in logf.read_text().splitlines() if logf.exists() else ():
            if "registers" in line or "spill stores" in line:
                log(f"ptxas {tag} {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.only != "k4":
        k3_runs(mods, v3)
    if args.only != "k3":
        k4_runs(mods, v4)
    return 0


def k3_runs(mods, v3) -> None:
    k3 = k3_inputs()
    for case, (ring, ws) in k3.items():
        for rnd, who in enumerate(("parent", "as_is", "as_is", "parent")):
            ms, err = k3_time(mods[("k3", who)], ring, ws, check=rnd < 2)
            log(f"K3 {case} {who:8s} kernel_ms={ms:.4f}"
                + ("" if err is None else f" max_abs_err={err:.3e}"))
    ring, ws = k3["matmul_C132_Q64_nbuf8"]
    shapes = {"C132": (ring, ws), "C1": (ring[:1].contiguous(), ws[:1])}
    for rnd in range(2):
        for label, (r, w) in shapes.items():
            for name in ("as_is", *v3):
                ms, _ = k3_time(mods[("k3", name)], r, w, check=False)
                log(f"K3 variants round {rnd} {name:13s} matmul_{label:4s} "
                    f"kernel_ms={ms:.4f} "
                    f"us_per_row={ms * 1e3 / cs.TILE_Q:.2f}")


def k4_runs(mods, v4) -> None:
    k4 = k4_inputs()
    for case, a in k4.items():
        for rnd, who in enumerate(("parent", "as_is", "as_is", "parent")):
            ms, err, host = k4_time(mods[("k4", who)], a, check=rnd < 2,
                                    eager=case.startswith("B4_S128"))
            log(f"K4 {case} {who:8s} kernel_ms={ms:.4f}"
                + ("" if err is None else f" max_abs_err={err:.3e}")
                + ("" if host is None else f" eager_call_ms={host:.4f}"))
    for rnd in range(2):
        for case, a in k4.items():
            for name in ("as_is", *v4):
                ms, _, _ = k4_time(mods[("k4", name)], a, check=False)
                log(f"K4 variants round {rnd} {case} {name:12s} "
                    f"kernel_ms={ms:.4f}")
            m = mods[("k4", "as_is")]
            base = m.split_count
            for n in (1, 2, 4, 8):
                m.split_count = lambda *shape, n=n: n
                ms, _, _ = k4_time(m, a, check=rnd == 0)
                log(f"K4 variants round {rnd} {case} splits{n:<6d} "
                    f"kernel_ms={ms:.4f}")
            m.split_count = base


if __name__ == "__main__":
    sys.exit(main())
