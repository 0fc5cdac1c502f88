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

K4 (bf16) at llama3-8b's shapes (heads 32/8, D=128): the serve shape
(B=4, S=128, lengths [128, 1, 77, 64]), B=4 S=4096 with ragged lengths
[4096, 3000, 1025, 17] and with a 1024 window; at the other D <= 128
rows of chip_smoke.py (zamba2-7b D=112, whisper-tiny's cross-attention
D=64, internvl2-76b G=8, a reduced config's D=32); and at gemma2-2b's
(heads 8/4, D=256, softcap 50, window 4096): the 4-slot decode, B=1 and
B=4 over 4609 positions, and the B=1 cache in 2, 4 and 16 shards through
the shard mode (the shard with the most live keys timed). Variants:

- ``no_ring``: each tile loaded and waited for before it is used (no load
  in flight while a tile is scored and summed);
- ``two_launches``: an empty second kernel on the merge's grid after each
  launch (the cost of a second launch, not the parent's merge);
- ``no_math``: no Q·Kᵀ or P·V products, and so none of their fragment
  reads from shared memory (loads, softmax, merge);
- ``ffma``: the FFMA kernel (one warp a query head, as f32 takes) in
  place of the tensor-core one for bf16 at D=128;
- ``ffma256``: the same for bf16 at D=256 (the route before the
  tensor-core design, with its 32-key tiles and 3 stages; the new split);
- ``smid``: as is, each CTA also records the SM it ran on
  (``%smid``), read after one call: the distinct SMs and the most CTAs
  on one SM; the parent's kernel likewise (``parent_smid``);
- ``timeline``: as is, each CTA also records its SM, its start and end on
  the global timer and, on its own SM's clock, when its first two tiles
  had landed and its key loop ended, when its partial was stored and
  counted (past one cluster; else when its cluster's merge ended), and
  (the last CTA) when the weights were made, when the partials (copied
  in meanwhile) had landed in shared memory and when the merge over the
  splits ended; read after one call (twice over the cases): the spread
  of start times (a second wave starts late), the launch's span and each
  phase's median and largest share;
- ``splits1`` ... ``splits8``: the split count forced (one cluster); at
  D=256 also ``one_cluster`` (the wrapper's count capped at one cluster
  of 8), ``clusters1`` (the wrapper's count in clusters of one, merged
  through scratch) and ``clusters4`` (in clusters of 4 where the count
  is a multiple of 4 past 4, merged through scratch: the kernel's check
  of the cluster size relaxed, ``any_cluster``).

It also times an eager K4 call on the host clock (launch included) for
both trees. Imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
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
CLUSTER_CHECK = "      (cluster != n_split && cluster != 1) ||"
ENTRY = 'extern "C" int k4_decode_attention('
SECOND = """
__global__ void second_kernel() {}

extern "C" int k4_decode_attention(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* out, void* scratch, void* counters,
                                   int B, int S, int Hq, int Hkv, int D,
                                   int is_bf16, int n_split, int cluster,
                                   float softcap, int window, float scale,
                                   void* stream) {
  const int err = k4_one_launch(q, k, v, valid_len, out, scratch, counters,
                                B, S, Hq, Hkv, D, is_bf16, n_split, cluster,
                                softcap, window, scale, stream);
  if (err) return err;
  second_kernel<<<dim3(Hq, B), D, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
QK = """      ldmatrix_x4(kb, sK + (key0 + kr) * ST + ks * 16 + kc);
      mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma_bf16(sc[1], qa, kb[2], kb[3]);"""
PV = """      ldmatrix_x4_trans(vb, sV + (key0 + vr) * ST + dim0 + np * 16 + vc);
      mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);"""
MMA128 = "    case 128: return launch_mma<128>("
MMA256 = "    case 256: return launch_mma<256>("
CFG = "template <> struct Cfg<32, float>"
NAMESPACE = "namespace {\n"
CLUSTER = "  cg::cluster_group cluster = cg::this_cluster();\n"
SMID = """__device__ int k4_smid[1 << 16];   // the SM of each CTA of a launch
"""
SMID_WRITE = """  if (threadIdx.x == 0) {
    int smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    k4_smid[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        smid;
  }
"""
SMID_READ = """
extern "C" int k4_read_smid(int* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k4_smid, n * sizeof(int));
}
"""
TL = """__device__ long long k4_tl[13 << 14];   // 13 words a CTA (timeline)
__device__ __forceinline__ long long k4_gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K4_TL (k4_tl + 13 * ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x))
"""
TL_START = """  if (threadIdx.x == 0) {
    int smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    K4_TL[0] = k4_gtime();
    K4_TL[1] = clock64();
    K4_TL[4] = 0;
    K4_TL[6] = smid;
    K4_TL[7] = 0;
    K4_TL[10] = K4_TL[11] = K4_TL[12] = 0;
  }
"""
FINISH_MMA = "  finish<T>(cluster, cM, cL, cAcc,"
ONE_END = """    cluster.sync();                   // no CTA leaves while others read it
    return;
"""
ARRIVED = "  if (!last) return;\n"
MERGED = ("    store_merged(hm[g], hl[g], o.w, 4 * q4 + 3, D, out, lse);"
          "\n  }\n}\n")
WEIGHTED = ("  cp_async_wait<0>();\n  __syncthreads();\n"
            "  for (int t = threadIdx.x; t < nq * parts; t += blockDim.x) {")
LOOP_END = "  cp_async_wait<0>();                 // no copy outlives the ring\n"
TL_READ = """
extern "C" int k4_read_timeline(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k4_tl, 13 * n * sizeof(long long));
}
"""


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
    _need(src, (PROLOGUE, RING, CLUSTER_CHECK, ENTRY, QK, PV, MMA128,
                MMA256, CFG, NAMESPACE, CLUSTER, FINISH_MMA, ONE_END,
                ARRIVED, MERGED, WEIGHTED, LOOP_END), "decode_attention.cu")
    return {
        "no_ring": src.replace(PROLOGUE, "    (void)ntiles;").replace(
            RING, NO_RING),
        "two_launches": src.replace(ENTRY, "int k4_one_launch(") + SECOND,
        "no_math": src.replace(
            QK, "      sc[0][0] += __uint_as_float(qa[0]);").replace(
            PV, "      acc[2 * np][0] += __uint_as_float(pa[0]);"),
        "ffma": src.replace(
            CFG, "template <> struct Cfg<128, __nv_bfloat16> { static "
            "constexpr int BK = 64, STAGES = 3; };\n" + CFG).replace(
            MMA128, "    case 128: return launch_ffma<128, __nv_bfloat16>("),
        "ffma256": src.replace(
            CFG, "template <> struct Cfg<256, __nv_bfloat16> { static "
            "constexpr int BK = 32, STAGES = 3; };\n" + CFG).replace(
            MMA256, "    case 256: return launch_ffma<256, __nv_bfloat16>("),
        "any_cluster": src.replace(CLUSTER_CHECK,
                                   "      n_split % cluster != 0 ||"),
        "smid": smid_variant(src),
        "timeline": src.replace(NAMESPACE, NAMESPACE + TL, 1).replace(
            CLUSTER, CLUSTER + TL_START).replace(
            FINISH_MMA, "  if (threadIdx.x == 0) K4_TL[2] = clock64();\n"
            + FINISH_MMA).replace(
            ONE_END, ONE_END.replace("    return;", "    if (threadIdx.x == "
                                     "0) { K4_TL[3] = clock64(); K4_TL[5] = "
                                     "k4_gtime(); }\n    return;")).replace(
            ARRIVED, "  if (threadIdx.x == 0) { K4_TL[3] = clock64(); "
            "K4_TL[5] = k4_gtime(); K4_TL[7] = last; }\n" + ARRIVED).replace(
            MERGED, MERGED[:-2] + "  __syncthreads();\n  if (threadIdx.x == "
            "0) { K4_TL[4] = clock64(); K4_TL[5] = k4_gtime(); }\n}\n").replace(
            WEIGHTED, WEIGHTED.replace(
                "  cp_async_wait", "  if (threadIdx.x == 0) K4_TL[8] = "
                "clock64();\n  cp_async_wait").replace(
                "__syncthreads();\n", "__syncthreads();\n  if (threadIdx.x "
                "== 0) K4_TL[9] = clock64();\n")).replace(
            RING, RING + "\n    if (threadIdx.x == 0 && j < 2) "
            "K4_TL[10 + j] = clock64();").replace(
            LOOP_END, "  if (threadIdx.x == 0) K4_TL[12] = clock64();\n" +
            LOOP_END)
        + TL_READ,
    }


def smid_variant(src: str) -> str:
    """``src`` with each CTA recording its SM (this tree's or the
    parent's source)."""
    _need(src, (NAMESPACE, CLUSTER), "decode_attention.cu")
    return src.replace(NAMESPACE, NAMESPACE + SMID, 1).replace(
        CLUSTER, CLUSTER + SMID_WRITE) + SMID_READ


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


GEMMA = dict(Hq=8, Hkv=4, D=256, window=4096, softcap=50.0)
# name: (B, S, valid, window, shards) and head layout (llama3-8b's unless
# given); shards None is the whole-cache mode
K4_CASES = {
    "B4_S128_ragged_bf16": (4, 128, [128, 1, 77, 64], 0, None, {}),
    "B4_S4096_ragged_bf16": (4, 4096, [4096, 3000, 1025, 17], 0, None, {}),
    "B4_S4096_window1024_bf16": (4, 4096, [4096, 2048, 1000, 300], 1024,
                                 None, {}),
    "zamba2_B4_S128_D112": (4, 128, [128, 1, 77, 64], 0, None,
                            dict(Hq=32, Hkv=32, D=112)),
    "whisper_cross_B4_S1500_D64": (4, 1500, [1500] * 4, 0, None,
                                   dict(Hq=6, Hkv=6, D=64)),
    "internvl_B4_S512_G8": (4, 512, [262, 270, 279, 290], 0, None,
                            dict(Hq=64, Hkv=8)),
    "reduced_B4_S128_D32": (4, 128, [128, 1, 77, 64], 0, None,
                            dict(Hq=4, Hkv=2, D=32)),
    "gemma_B4_S128_D256": (4, 128, [128, 1, 77, 64], 4096, None, GEMMA),
    "gemma_B1_S4609_D256": (1, 4609, [4609], 4096, None, GEMMA),
    "gemma_B4_S4609_D256": (4, 4609, [4609] * 4, 4096, None, GEMMA),
    "gemma_B1_S4609_D256_n2": (1, 4609, [4609], 4096, 2, GEMMA),
    "gemma_B1_S4609_D256_n4": (1, 4609, [4609], 4096, 4, GEMMA),
    "gemma_B1_S4609_D256_n16": (1, 4609, [4609], 4096, 16, GEMMA),
}


def k4_inputs() -> dict:
    """Each case's (q, k, v, valid_len, kwargs, shard): shard None, or the
    (off, seq_len) of the shard with the most live keys, whose k and v
    are that shard's. Softcap cases scale q so the cap bites."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for name, (B, S, valid, window, shards, heads) in K4_CASES.items():
        Hq, Hkv, D = (heads.get(x, d) for x, d in (("Hq", 32), ("Hkv", 8),
                                                   ("D", 128)))
        softcap = heads.get("softcap", 0.0)
        q = cs._softcap_q(cs._randn((B, 1, Hq, D), torch.bfloat16, gen),
                          softcap)
        k, v = (cs._randn((B, S, Hkv, D), torch.bfloat16, gen)
                for _ in range(2))
        vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        kw = dict(window=window, attn_softcap=softcap)
        shard = None
        if shards:
            lo = max(0, min(valid) - window) if window else 0
            hi = max(valid)
            bounds = cs._shard_bounds(S, shards)
            o, L = max(bounds, key=lambda b: min(hi, b[0] + b[1])
                       - max(lo, b[0]))
            k, v = k[:, o:o + L].contiguous(), v[:, o:o + L].contiguous()
            shard = (o, S)
        out[name] = (q, k, v, vl, kw, shard)
    return out


def k4_call(mod, args):
    """One K4 call of a case through ``mod``'s wrapper, and its plain
    version (the output; in the shard mode the partial's o)."""
    q, k, v, vl, kw, shard = args
    if shard is None:
        return (lambda: mod.decode_attention(q, k, v, vl, **kw),
                lambda: mod.decode_attention_plain(q, k, v, vl, **kw))
    off, seq_len = shard
    return (lambda: mod.decode_attention_partial(
                q, k, v, vl, off=off, seq_len=seq_len, **kw)[0],
            lambda: mod.decode_attention_partial_plain(
                q, k, v, vl, off=off, seq_len=seq_len, **kw)[0])


def k4_time(mod, args, check: bool, eager: bool = False):
    import torch
    call, plain = k4_call(mod, args)
    err = None
    if check:
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= cs.ATOL[torch.bfloat16]:
            raise SystemExit(f"{mod.__name__}: K4 disagrees ({err})")
    ms = cs.time_ms(call)
    host = cs.host_ms(call, iters=200) if eager else None
    return ms, err, host


def k4_sms(mod, args) -> str:
    """The SMs one call's CTAs ran on (the ``smid`` variant): distinct SMs,
    the most CTAs on one SM, and the grid's CTAs."""
    import ctypes
    import torch
    B, _, Hkv, _ = args[1].shape
    n_split = k4_splits(mod, args)
    n = n_split * Hkv * B
    k4_call(mod, args)[0]()
    torch.cuda.synchronize()
    host = (ctypes.c_int * n)()
    err = mod.library().k4_read_smid(host, n)
    if err:
        raise SystemExit(f"k4_read_smid: {err}")
    sms = list(host)
    most = max(sms.count(x) for x in set(sms))
    return (f"ctas={n} clusters={n // k4_cluster(mod, args, n_split)} "
            f"distinct_sms={len(set(sms))} most_ctas_on_one_sm={most}")


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
    path = out / "decode_attention_parent_smid.cu"
    path.write_text(smid_variant(
        (parent / K4_REL / "csrc" / "decode_attention.cu").read_text()))
    mods[("k4", "parent_smid")] = load_wrapper(
        "k4_parent_smid", parent / K4_REL / "kernel.py", path)
    if args.only:
        mods = {key: m for key, m in mods.items() if key[0] == args.only}
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
    m = mods[("k4", "as_is")]
    for case, a in k4.items():
        log(f"K4 {case} as_is {k4_sms(mods[('k4', 'smid')], a)} | parent "
            f"{k4_sms(mods[('k4', 'parent_smid')], a)}")
    tl = mods[("k4", "timeline")]
    for rnd in range(2):
        for case, a in k4.items():
            log(f"K4 timeline round {rnd} {case} {k4_timeline(tl, a)}")
    anyc = mods[("k4", "any_cluster")]
    for rnd in range(2):
        for case, a in k4.items():
            wide = a[1].shape[-1] == 256
            for name in ("as_is", *v4):
                if name in ("smid", "timeline", "any_cluster") or \
                        name == "ffma256" and not wide:
                    continue
                ms, _, _ = k4_time(mods[("k4", name)], a,
                                   check=rnd == 0 and name.startswith("ffma"))
                log(f"K4 variants round {rnd} {case} {name:12s} "
                    f"kernel_ms={ms:.4f}")
            base, base_cluster = m.split_count, m.cluster_size
            n = k4_splits(m, a)
            forced = {f"splits{k}": (m, lambda *s, k=k: k, base_cluster)
                      for k in (1, 2, 4, 8)}
            if wide:
                forced["one_cluster"] = (m, lambda *s: min(8, base(*s)),
                                         lambda k, *s: k)
                forced["clusters1"] = (m, base, lambda *s: 1)
                if n > 4 and n % 4 == 0:
                    forced["clusters4"] = (anyc, base, lambda *s: 4)
            for name, (mod, split, cluster) in forced.items():
                own = mod.split_count, mod.cluster_size
                mod.split_count, mod.cluster_size = split, cluster
                ms, _, _ = k4_time(mod, a, check=rnd == 0)
                mod.split_count, mod.cluster_size = own
                log(f"K4 variants round {rnd} {case} {name:12s} "
                    f"kernel_ms={ms:.4f}")


def k4_timeline(mod, args) -> str:
    """One call's timeline (the ``timeline`` variant): CTAs, distinct SMs,
    CTAs that started over 1 us after the first (a later wave), the span
    from the first start to the last end (global timer), and the median
    and largest of each CTA's key loop, of its cluster merge and arrival,
    and of the last cluster's merge over clusters, in us (each SM's clock
    over the global timer gives its rate)."""
    import ctypes
    import statistics
    import torch
    B, _, Hkv, _ = args[1].shape
    n_split = k4_splits(mod, args)
    n = n_split * Hkv * B
    k4_call(mod, args)[0]()
    torch.cuda.synchronize()
    host = (ctypes.c_longlong * (13 * n))()
    err = mod.library().k4_read_timeline(host, n)
    if err:
        raise SystemExit(f"k4_read_timeline: {err}")
    r = [list(host[13 * i:13 * i + 13]) for i in range(n)]
    t0 = min(x[0] for x in r)
    ghz = statistics.median((x[3] - x[1]) / max(1, x[5] - x[0]) for x in r
                            if x[4] == 0)

    def us(cycles):
        return cycles / ghz / 1e3

    def stat(vals):
        return (f"{statistics.median(vals):.2f}/{max(vals):.2f}"
                if vals else "-")
    late = sum(1 for x in r if x[0] - t0 > 1000)
    loop = [us(x[2] - x[1]) for x in r]
    tile0 = [us(x[10] - x[1]) for x in r if x[10] > x[1]]
    tile1 = [us(x[11] - x[1]) for x in r if x[11] > x[1]]
    loop_end = [us(x[12] - x[1]) for x in r if x[12] > x[1]]
    arrive = [us(x[3] - x[2]) for x in r]
    final = [us(x[4] - x[3]) for x in r if x[4]]
    weights = [us(x[8] - x[3]) for x in r if x[4]]
    staging = [us(x[9] - x[8]) for x in r if x[4]]
    return (f"ctas={n} clusters={n // k4_cluster(mod, args, n_split)} "
            f"distinct_sms={len({x[6] for x in r})} late_starts={late} "
            f"span_us={(max(x[5] for x in r) - t0) / 1e3:.2f} "
            f"start_spread_us={(max(x[0] for x in r) - t0) / 1e3:.2f} "
            f"loop_us={stat(loop)} (tile 0 landed {stat(tile0)}, tile 1 "
            f"{stat(tile1)}, keys done {stat(loop_end)}) "
            f"merge_arrive_us={stat(arrive)} "
            f"final_merge_us={stat(final)} (weights {stat(weights)}, then "
            f"staging {stat(staging)}) (median/max; {ghz:.2f} GHz)")


def k4_splits(mod, a) -> int:
    """The split count ``mod``'s wrapper picks for a case (the parent's
    ``split_count`` takes fewer arguments)."""
    q, k, v, vl, kw, shard = a
    B, S, Hkv, D = k.shape
    args = (B, S, Hkv, kw["window"], D, True)
    n = len(inspect.signature(mod.split_count).parameters)
    return mod.split_count(*args[:n])


def k4_cluster(mod, a, n_split: int) -> int:
    """CTAs a cluster at ``n_split`` (the parent's: all of them)."""
    if not hasattr(mod, "cluster_size"):
        return n_split
    B, _, Hkv, D = a[1].shape
    return mod.cluster_size(n_split, B, Hkv, D, True)


if __name__ == "__main__":
    sys.exit(main())
