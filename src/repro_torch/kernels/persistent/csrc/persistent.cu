// Persistent tile-op workers: the drain megakernel (K1), its flight-recorder
// variant (K2) and the legacy work-queue executor (K3) — Hopper (sm_90a),
// CUDA C++.
//
// Replaces: src/repro/kernels/persistent/kernel.py::_drain_kernel (K1) and
// ::_drain_kernel_prof (K2), which share _drain_body, and ::_executor_kernel
// (K3). Same functions: one persistent worker per cluster (the reference's
// grid is (C,); here one CTA per cluster) walks its queue rows in order.
//
//   K1/K2: a row is active when head <= i < tail, stop == 0 and
//   status >= THREAD_WORK; an active row runs its opcode (clipped to
//   [0, NUM_DRAIN_OPS)) for one chunk on the cluster's (nbuf, 128, 128) f32
//   workspace: NOP, MATMUL ws[dst] += ws[a] @ ws[b], ADD, SCALE by
//   arg1 / 2^16, RELU, COPY, REDUCE carry += sum(ws[a]). Its result is the
//   sum of the written tile (the carry for REDUCE, 0 for NOP or an inactive
//   row). Every row, active or not, gets an ack (FINISHED when
//   chunk + 1 >= max(n_chunks, 1), PREEMPTED otherwise, NOP when inactive,
//   with the request id and chunk words copied); ctrl_out[QC_DRAINED] counts
//   active rows. K2 adds one PROF_WIDTH profile row per queue row and a
//   logical tick that grows by one per active row.
//   K3: every row with status >= THREAD_WORK runs through the 6-op table
//   (no REDUCE); one from_gpu row per cluster: FINISHED, W_ARG0 = the count
//   of work rows (NOP opcodes included).
//
// Semantics taken from the Pallas kernel (interpret mode), not from its
// numpy oracle: dst = arg0 >> 8 and a = arg0 & 255 (JAX's floor // and %),
// and a tile index i is first made i + nbuf when negative, then clamped to
// [0, nbuf - 1] — what the reference's dynamic ref indexing does with an
// out-of-range index (the oracle raises instead). Workspace, carry and tick
// are updated in place, as the reference aliases them in -> out.
//
// What bounds it on the H100. K1/K2: for matmul rows, operations. A 128^3
// tile product is 4.2 MFLOP that must stay exact to 1e-4 against f32 math,
// which plain TF32 (10-bit mantissa) misses; 3xTF32 does not: each f32
// operand x is split into big = tf32(x) and small = tf32(x - big), and
// a_small*b_big + a_big*b_small + a_big*b_big is accumulated in f32 on the
// tensor cores (mma.sync m16n8k8 tf32), dropping small*small (~2^-22
// relative). That is 3 x 4.2 MFLOP a product at the TF32 rate (495 TFLOP/s
// over 132 SMs): a floor of 3.35 us a product on one SM, against 8.26 us
// for FFMA at the f32 rate; mma.sync reaches about two thirds of that rate
// (scripts/drain_variants.py). The rows of one cluster are sequential by
// definition (row i + 1 reads row i's writes) and a cluster is one worker
// on one SM, so a C = 1 launch can use one SM's share of the card at best;
// C = 132 clusters fill it. In practice the kernel is held by shared
// memory: the ring's fills, the splits and every warp's fragment reads
// pass through it, at ~17 us a product (PERF.md).
//
// What the design does about it. The workspace (512 KiB a cluster at
// nbuf = 8) exceeds shared memory, so it stays in global memory (L2 holds
// most of it). A product streams its operands through a ring of
// RING_STAGES 32-deep k-blocks in dynamic shared memory, filled with
// 16-byte cp.async copies: A stored [m][k] (row stride 36 floats), B
// [k][n] (stride 136), so every fragment read is free of bank conflicts
// and no element is transposed on the way in. The ring holds one whole
// product. Once a stage lands, all threads split it in place (each value
// once, where every warp that reads it would split it again): the stage
// keeps the big halves, one of two small-half buffers the small ones; a
// phase splits k-block kb + 1 in parts between the 8-deep steps of kb's
// math, with one barrier a phase. When the next active row is a MATMUL
// that reads neither operand from this row's dst, its k-blocks are issued
// into the stages this row frees and its first is split in this row's
// last phase; otherwise the next row starts its own fills (it never
// prefetches across a write it could see). 16 warps in a 4 x 4 grid each own
// a 32 x 32 block of the product, 8 m16n8 tiles, 32 f32 accumulators a
// thread (a 2 x 4 grid of 8 warps with 64 needs 255 registers, spills and
// runs slower), held in registers until every read of A and B from global
// memory has ended (the last stage's split); only then is D + acc written,
// so dst may alias a or b. A row's descriptor words are read a row ahead.
// Elementwise rows are safe in place: a thread reads element e of its inputs
// before it writes element e of dst. __syncthreads() ends every row, so row
// i + 1 sees row i's global writes. ptxas (sm_90a, CUDA 12.9; the build's
// build/kernels/persistent-*.so.log): drain_kernel<false> and <true> 128
// registers, 72 and 80 bytes of spill stores, 64 bytes of static shared
// memory plus DRAIN_SMEM_BYTES = 215040 dynamic.
//
// K3 forms its tile products in 3xTF32 too, on wgmma (m64n128k8, two
// consumer warpgroups) with a producer warp streaming k-blocks by TMA and
// cp.async.bulk: the design is described above execute_kernel. Its tile
// product is a set of device functions (exec_split, exec_products,
// exec_matmul_row) that take the ring's state as arguments, so the drain
// kernels could call them; K1/K2 keep their mma.sync product for now.
// Its ptxas report is in PERF.md. Elementwise rows compute no tile sum
// (K3 has no result words). K3 is bound like K1/K2: by the TF32 rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Layout constants, one per line: tests/test_torch_kernels_persistent.py
// holds each of them equal to the Python package's.
constexpr int TILE = 128;
constexpr int DESC_WIDTH = 10;
constexpr int W_STATUS = 0;
constexpr int W_OPCODE = 1;
constexpr int W_ARG0 = 2;
constexpr int W_ARG1 = 3;
constexpr int W_REQID = 5;
constexpr int W_CHUNK = 8;
constexpr int W_NCHUNKS = 9;
constexpr int QCTRL_WIDTH = 4;
constexpr int QC_HEAD = 0;
constexpr int QC_TAIL = 1;
constexpr int QC_STOP = 2;
constexpr int QC_DRAINED = 3;
constexpr int PROF_WIDTH = 8;
constexpr int P_TICK0 = 0;
constexpr int P_TICK1 = 1;
constexpr int P_ROW = 2;
constexpr int P_QDEPTH = 3;
constexpr int P_OPCODE = 4;
constexpr int P_REQID = 5;
constexpr int P_ACTIVE = 6;
constexpr int THREAD_FINISHED = 1;
constexpr int THREAD_PREEMPTED = 3;
constexpr int THREAD_NOP = 4;
constexpr int THREAD_WORK = 16;
constexpr int OP_MATMUL = 1;
constexpr int OP_ADD = 2;
constexpr int OP_SCALE = 3;
constexpr int OP_RELU = 4;
constexpr int OP_COPY = 5;
constexpr int OP_REDUCE = 6;
constexpr int NUM_OPS = 6;
constexpr int NUM_DRAIN_OPS = 7;
constexpr int SCALE_SHIFT = 16;
static_assert(OP_COPY == OP_RELU + 1 && OP_REDUCE == OP_COPY + 1,
              "tile_op writes every opcode from MATMUL to COPY");

constexpr int TT = TILE * TILE;

// K1/K2: a warp grid over the 128 x 128 product; warp (wm, wn) owns rows
// 16 WARP_MT wm + [0, 16 WARP_MT) and columns 8 WARP_NT wn + [0, 8 WARP_NT)
constexpr int DRAIN_WARPS_M = 4;
constexpr int DRAIN_WARPS_N = 4;
constexpr int DRAIN_NT = 32 * DRAIN_WARPS_M * DRAIN_WARPS_N;
constexpr int WARP_MT = TILE / 16 / DRAIN_WARPS_M;   // m16 tiles a warp
constexpr int WARP_NT = TILE / 8 / DRAIN_WARPS_N;    // n8 tiles a warp

// K1/K2's operand ring: one stage per 32-deep k-block of a product, so the
// ring holds a whole product. A k-block of A is stored [m][k] with rows of
// RING_A_LD floats, one of B [k][n] with rows of RING_B_LD: 16-byte aligned
// rows for cp.async, and strides of 4 and 8 banks mod 32, so the lanes of
// a fragment read (row g = lane / 4, column t = lane % 4 of A; row t,
// column g of B) hit 32 distinct banks.
constexpr int RING_STAGES = 4;
constexpr int RING_KB = 32;
constexpr int RING_A_LD = 36;
constexpr int RING_B_LD = 136;
constexpr int KBLOCK_FLOATS = TILE * RING_KB;   // a k-block of A (or B)
constexpr int STAGE_FLOATS = TILE * RING_A_LD + RING_KB * RING_B_LD;
// A stage is split in place once it lands: its floats become their tf32
// big halves and the small halves go to one of two buffers of the stage's
// layout, so one k-block is split while the one before is multiplied.
constexpr int SMALL_BUFFERS = 2;
constexpr int DRAIN_SMEM_BYTES =
    (RING_STAGES + SMALL_BUFFERS) * STAGE_FLOATS * 4;
static_assert(RING_STAGES * RING_KB == TILE, "the ring holds one product");

// The reference's ref[...] with a dynamic index: negative indices count
// from the end, then the index is clamped into range.
__device__ __forceinline__ int tile_index(int i, int nbuf) {
  if (i < 0) i += nbuf;
  return min(max(i, 0), nbuf - 1);
}

// int32 arithmetic that wraps, as JAX's does (no signed-overflow UB).
__device__ __forceinline__ int wrap_add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}

// Sum of v over a CTA of WARPS warps; the total is valid on thread 0 only.
// Callers end the row with __syncthreads() before the next call reuses red.
template <int WARPS>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

// This thread's part of an elementwise row (ADD, SCALE, RELU, COPY) or of
// REDUCE's sum(ws[a]) on a CTA of THREADS threads: the sum of the elements
// it wrote (read, for REDUCE).
template <int THREADS>
__device__ float elementwise_part(int op, float* ws, int dst, int a, int arg1,
                                  int nbuf) {
  const float4* A4 = reinterpret_cast<const float4*>(ws + (size_t)a * TT);
  const float4* B4 = reinterpret_cast<const float4*>(
      ws + (size_t)tile_index(arg1, nbuf) * TT);
  float4* D4 = reinterpret_cast<float4*>(ws + (size_t)dst * TT);
  const float scale = __int2float_rn(arg1) * (1.0f / (1 << SCALE_SHIFT));
  float part = 0.f;
  for (int f = threadIdx.x; f < TT / 4; f += THREADS) {
    float4 x = A4[f];
    if (op == OP_ADD) {
      const float4 y = B4[f];
      x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
    } else if (op == OP_SCALE) {
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    } else if (op == OP_RELU) {            // NaN passes, as jnp.maximum
      x.x = x.x < 0.f ? 0.f : x.x; x.y = x.y < 0.f ? 0.f : x.y;
      x.z = x.z < 0.f ? 0.f : x.z; x.w = x.w < 0.f ? 0.f : x.w;
    }
    if (op != OP_REDUCE) D4[f] = x;        // COPY writes x unchanged
    part += (x.x + x.y) + (x.z + x.w);
  }
  return part;
}

// ---- K1/K2's tile product: 3xTF32 mma.sync fed by the cp.async ring ----

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue this thread's copies of k-block kb of A and B into stage kb (the
// caller commits them as one group).
__device__ __forceinline__ void fill_stage(float* ring, const float* A,
                                           const float* B, int kb) {
  float* sa = ring + kb * STAGE_FLOATS;
  float* sb = sa + TILE * RING_A_LD;
  const int k0 = kb * RING_KB;
#pragma unroll
  for (int r = 0; r < KBLOCK_FLOATS / 4 / DRAIN_NT; ++r) {
    const int f = threadIdx.x + DRAIN_NT * r;    // 16-byte chunk
    const int m = f / (RING_KB / 4), kq = (f % (RING_KB / 4)) * 4;
    cp_async16(sa + m * RING_A_LD + kq, A + m * TILE + k0 + kq);
    const int kk = f / (TILE / 4), nq = (f % (TILE / 4)) * 4;
    cp_async16(sb + kk * RING_B_LD + nq, B + (k0 + kk) * TILE + nq);
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;             // tf32 in f32's layout, low bits clear
}

__device__ __forceinline__ bool finite_bits(uint32_t x) {
  return (x & 0x7f800000u) != 0x7f800000u;
}

// x = big + small in tf32, both rounded to nearest (ties away from zero).
// Where big is not finite (x is inf or NaN, or rounds to inf), small is 0,
// since x - big would be NaN. Returns whether big is finite.
__device__ __forceinline__ bool split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  const bool finite = finite_bits(big);
  small = finite ? tf32_rna(x - __uint_as_float(big)) : 0u;
  return finite;
}

// A thread's share of splitting a ring stage: SPLIT_PARTS float4s, spread
// evenly over the 8-deep steps of the math, so the split of the next
// k-block can run between the tensor-core instructions of this one.
constexpr int SPLIT_PARTS = 2 * KBLOCK_FLOATS / 4 / DRAIN_NT;
constexpr int STEP_PARTS = SPLIT_PARTS / (RING_KB / 8);
static_assert(STEP_PARTS * (RING_KB / 8) == SPLIT_PARTS,
              "the split parts spread evenly over the math steps");

// Split part r of ring stage `stage` (a k-block of A and B) in place into
// its big halves, the small halves into `small`; returns whether this
// thread met a big that is not finite. Each value is split once, where
// every warp that multiplies it would split it again.
__device__ __forceinline__ bool split_part(float* stage, float* small,
                                           int r) {
  const int f = threadIdx.x + DRAIN_NT * r;      // float4 of the stage
  const int off = f < KBLOCK_FLOATS / 4
      ? (f / (RING_KB / 4)) * RING_A_LD + (f % (RING_KB / 4)) * 4
      : TILE * RING_A_LD +
            ((f - KBLOCK_FLOATS / 4) / (TILE / 4)) * RING_B_LD +
            ((f - KBLOCK_FLOATS / 4) % (TILE / 4)) * 4;
  const float4 x = *reinterpret_cast<const float4*>(stage + off);
  uint4 big, sml;
  bool finite = split_tf32(x.x, big.x, sml.x);
  finite &= split_tf32(x.y, big.y, sml.y);
  finite &= split_tf32(x.z, big.z, sml.z);
  finite &= split_tf32(x.w, big.w, sml.w);
  *reinterpret_cast<uint4*>(stage + off) = big;
  *reinterpret_cast<uint4*>(small + off) = sml;
  return !finite;
}

// d = a * b + c (c = 0 when null): m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b, const float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c ? c[0] : 0.f), "f"(c ? c[1] : 0.f), "f"(c ? c[2] : 0.f),
        "f"(c ? c[3] : 0.f));
}

__device__ __forceinline__ uint32_t finite_or_0(uint32_t x) {
  return finite_bits(x) ? x : 0u;
}

// acc += this warp's block of A @ B over one split k-block (big halves in
// `big`, small halves in `small`, both in the stage layout), in 3xTF32:
// a_small b_big + a_big b_small + a_big b_big, small * small dropped. Each
// 8-deep step forms its three products in a fresh accumulator p, small
// terms first, and adds p to acc in f32 with rounding to nearest: the
// tensor cores sum with truncation, and summing every step's terms into the
// full-size acc truncates them at acc's magnitude (4x FFMA's error on the
// smoke's tile sums, past 1e-4), where p is a fraction of acc and starts
// from 0. MASK (the k-block holds a big that is not finite): the cross
// terms take such a big as 0, since inf * small is NaN where small is 0
// and the wrong infinity where small has the other sign; inf and NaN then
// propagate through a_big b_big alone, as they do in FFMA (up to an f32
// value that rounds up to tf32 inf, and a denormal that rounds to 0).
// Fragment reads: lane (g, t) = (lane / 4, lane % 4) reads A rows g, g + 8
// and columns t, t + 4 of an m16 tile, B rows t, t + 4 and column g of an
// n8 tile.
template <bool MASK>
__device__ __forceinline__ bool mma_kblock(const float* big,
                                           const float* small,
                                           float (&acc)[WARP_MT][WARP_NT][4],
                                           float* next, float* next_small) {
  bool nonfinite = false;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a0 = ((warp / DRAIN_WARPS_N) * 16 * WARP_MT + g) * RING_A_LD + t;
  const int b0 = TILE * RING_A_LD + t * RING_B_LD +
                 (warp % DRAIN_WARPS_N) * 8 * WARP_NT + g;
#pragma unroll
  for (int k8 = 0; k8 < RING_KB; k8 += 8) {
#pragma unroll
    for (int q = 0; q < STEP_PARTS; ++q)
      if (next != nullptr)
        nonfinite |= split_part(next, next_small, k8 / 8 * STEP_PARTS + q);
    uint32_t bb[WARP_NT][2], bs[WARP_NT][2], bx[WARP_NT][2];
#pragma unroll
    for (int nt = 0; nt < WARP_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = b0 + (k8 + 4 * r) * RING_B_LD + 8 * nt;
        bb[nt][r] = __float_as_uint(big[o]);
        bs[nt][r] = __float_as_uint(small[o]);
        bx[nt][r] = MASK ? finite_or_0(bb[nt][r]) : bb[nt][r];
      }
#pragma unroll
    for (int mt = 0; mt < WARP_MT; ++mt) {
      uint32_t ab[4], as[4], ax[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {     // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
        const int o = a0 + (16 * mt + 8 * (r & 1)) * RING_A_LD + k8 +
                      4 * (r >> 1);
        ab[r] = __float_as_uint(big[o]);
        as[r] = __float_as_uint(small[o]);
        ax[r] = MASK ? finite_or_0(ab[r]) : ab[r];
      }
#pragma unroll
      for (int nt = 0; nt < WARP_NT; ++nt) {
        float p[4];
        mma_tf32(p, as, bx[nt], nullptr);
        mma_tf32(p, ax, bs[nt], p);
        mma_tf32(p, ab, bb[nt], p);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] += p[r];
      }
    }
  }
  return nonfinite;
}

// One MATMUL row: D += A @ B, with D + (A @ B) formed as the reference
// forms it. Every phase kb has one barrier; after it, k-block kb is split
// (its non-finite flag is the barrier's OR) and every warp is done with
// k-block kb - 1, whose stage is refilled; k-block kb + 1 is then split
// while kb is multiplied. `ready`: the row before issued this row's
// k-blocks 0-2 and split k-block 0 (its flag in `nonfinite`), and this row
// issues its k-block 3 into the stage the row before's k-block 3 frees.
// An/Bn, when not null, are the operands of the next active row, which
// reads neither from D: its k-blocks 0-2 are issued here as stages free up
// and its k-block 0 is split in the last phase. Each k-block is waited on
// through the commit-group count: at most one group (real or empty) is
// committed after it when it is split. Returns the sum of the tile written,
// valid on thread 0.
__device__ float matmul_row(const float* A, const float* B, float* D,
                            bool ready, const float* An, const float* Bn,
                            float* ring, float* small, float* red,
                            bool& nonfinite) {
  if (!ready) {
#pragma unroll
    for (int kb = 0; kb < RING_STAGES; ++kb) {
      fill_stage(ring, A, B, kb);
      cp_async_commit();
    }
    cp_async_wait<RING_STAGES - 1>();
    __syncthreads();                  // k-block 0 landed
    nonfinite = false;
#pragma unroll
    for (int r = 0; r < SPLIT_PARTS; ++r)
      nonfinite |= split_part(ring, small, r);
  }
  float acc[WARP_MT][WARP_NT][4];
#pragma unroll
  for (int mt = 0; mt < WARP_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WARP_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < RING_STAGES; ++kb) {
    cp_async_wait<1>();               // the k-block split in this phase
    const bool mask = __syncthreads_or(nonfinite);
    if (kb == 0) {
      if (ready) fill_stage(ring, A, B, RING_STAGES - 1);
    } else if (An != nullptr) {
      fill_stage(ring, An, Bn, kb - 1);
    }
    cp_async_commit();
    // the next k-block to split: this row's kb + 1, or the next row's 0
    float *next = nullptr, *next_small = nullptr;
    if (kb + 1 < RING_STAGES) {
      next = ring + (kb + 1) * STAGE_FLOATS;
      next_small = small + ((kb + 1) & 1) * STAGE_FLOATS;
    } else if (An != nullptr) {
      next = ring;
      next_small = small;
    }
    const float* bg = ring + kb * STAGE_FLOATS;
    const float* sm = small + (kb & 1) * STAGE_FLOATS;
    nonfinite = mask ? mma_kblock<true>(bg, sm, acc, next, next_small)
                     : mma_kblock<false>(bg, sm, acc, next, next_small);
  }
  // every read of A and B from global memory ended before its split
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / DRAIN_WARPS_N) * 16 * WARP_MT + (lane >> 2);
  const int c0 = (warp % DRAIN_WARPS_N) * 8 * WARP_NT + 2 * (lane & 3);
  float part = 0.f;
#pragma unroll
  for (int mt = 0; mt < WARP_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WARP_NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(
            D + (r0 + 16 * mt + 8 * h) * TILE + c0 + 8 * nt);
        float2 v = *p;
        v.x = v.x + acc[mt][nt][2 * h];
        v.y = v.y + acc[mt][nt][2 * h + 1];
        *p = v;
        part += v.x + v.y;
      }
  return block_sum<DRAIN_NT / 32>(part, red);
}

// The words of a queue row that decide what the drain does with it (a NOP
// row past the end).
struct RowWords {
  int status, opcode, arg0, arg1;
};

__device__ __forceinline__ RowWords row_words(const int* qc, int i, int Q) {
  if (i >= Q) return {THREAD_NOP, 0, 0, 0};
  const int* d = qc + (size_t)i * DESC_WIDTH;
  return {d[W_STATUS], d[W_OPCODE], d[W_ARG0], d[W_ARG1]};
}

// The first row at or after i with a work status below `end`, or Q.
__device__ __forceinline__ int next_work(const int* qc, int i, int end,
                                         int Q) {
  while (i < end && qc[(size_t)i * DESC_WIDTH + W_STATUS] < THREAD_WORK) ++i;
  return i < end ? i : Q;
}

template <bool PROFILE>
__global__ void __launch_bounds__(DRAIN_NT, 1)
drain_kernel(const int* ctrl, const int* queue, float* ws, float* carry,
             int* tick, int* acks, float* results, int* ctrl_out, int* prof,
             int Q, int nbuf) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float red[DRAIN_NT / 32];
  float* small = ring + RING_STAGES * STAGE_FLOATS;
  const int c = blockIdx.x;
  const int* cc = ctrl + c * QCTRL_WIDTH;
  const int head = cc[QC_HEAD], tail = cc[QC_TAIL], stop = cc[QC_STOP];
  const int end = min(tail, Q);
  const int* qc = queue + (size_t)c * Q * DESC_WIDTH;
  float* wsc = ws + (size_t)c * nbuf * TT;
  float carry_c = carry[c];           // threads other than 0 never use it
  int tick_c = PROFILE ? tick[c] : 0;
  int drained = 0;
  bool ready = false;      // the row before issued this row's k-blocks
  bool nonfinite = false;  // this thread's last split met a non-finite big
  // rows i and i + 1 are read a row ahead, so a row's decisions (and the
  // prefetch of the next) wait on no load
  RowWords cur = row_words(qc, 0, Q), nxt = row_words(qc, 1, Q);
  for (int i = 0; i < Q; ++i) {
    const RowWords later = row_words(qc, i + 2, Q);
    const int* d = qc + (size_t)i * DESC_WIDTH;
    int reqid = 0, chunk = 0, n_chunks = 0;
    if (threadIdx.x == 0) {
      reqid = d[W_REQID];
      chunk = d[W_CHUNK];
      n_chunks = d[W_NCHUNKS];
    }
    const bool active = i >= head && i < tail && stop == 0 &&
                        cur.status >= THREAD_WORK;
    float res = 0.f;
    if (active) {
      const int op = min(max(cur.opcode, 0), NUM_DRAIN_OPS - 1);
      const int dst = tile_index(cur.arg0 >> 8, nbuf);
      const int a = tile_index(cur.arg0 & 255, nbuf);
      if (op == OP_MATMUL) {
        const int b = tile_index(cur.arg1, nbuf);
        // the next row the drain runs (i is active, so head <= i and
        // stop == 0); prefetch it only if it is a product that does not
        // read this row's dst
        RowWords dn = nxt;
        if (!(i + 1 < end && nxt.status >= THREAD_WORK))
          dn = row_words(qc, next_work(qc, i + 2, end, Q), Q);
        const float *An = nullptr, *Bn = nullptr;
        const int an = tile_index(dn.arg0 & 255, nbuf);
        const int bn = tile_index(dn.arg1, nbuf);
        if (dn.status >= THREAD_WORK &&
            min(max(dn.opcode, 0), NUM_DRAIN_OPS - 1) == OP_MATMUL &&
            an != dst && bn != dst) {
          An = wsc + (size_t)an * TT;
          Bn = wsc + (size_t)bn * TT;
        }
        res = matmul_row(wsc + (size_t)a * TT, wsc + (size_t)b * TT,
                         wsc + (size_t)dst * TT, ready, An, Bn, ring, small,
                         red, nonfinite);
        ready = An != nullptr;
      } else if (op != 0) {
        const float s = block_sum<DRAIN_NT / 32>(
            elementwise_part<DRAIN_NT>(op, wsc, dst, a, cur.arg1, nbuf), red);
        if (op == OP_REDUCE) {
          carry_c = carry_c + s;
          res = carry_c;
        } else {
          res = s;
        }
      }
    }
    if (threadIdx.x == 0) {
      const size_t row = (size_t)c * Q + i;
      const bool done = wrap_add(chunk, 1) >= max(n_chunks, 1);
      int* ack = acks + row * DESC_WIDTH;
      for (int w = 0; w < DESC_WIDTH; ++w) ack[w] = 0;
      ack[W_STATUS] = active ? (done ? THREAD_FINISHED : THREAD_PREEMPTED)
                             : THREAD_NOP;
      ack[W_REQID] = reqid;
      ack[W_CHUNK] = chunk;
      ack[W_NCHUNKS] = n_chunks;
      results[row] = res;
      if (PROFILE) {
        int* p = prof + row * PROF_WIDTH;
        for (int w = 0; w < PROF_WIDTH; ++w) p[w] = 0;
        if (active) {
          p[P_TICK0] = tick_c;
          p[P_TICK1] = wrap_add(tick_c, 1);
          p[P_ROW] = drained;
          p[P_QDEPTH] = wrap_add(tail, -i);
          p[P_OPCODE] = cur.opcode;
          p[P_REQID] = reqid;
          p[P_ACTIVE] = 1;
        }
      }
    }
    if (active) {
      ++drained;
      if (PROFILE) tick_c = wrap_add(tick_c, 1);
    }
    cur = nxt;
    nxt = later;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    carry[c] = carry_c;
    if (PROFILE) tick[c] = tick_c;
    int* co = ctrl_out + c * QCTRL_WIDTH;
    for (int w = 0; w < QCTRL_WIDTH; ++w) co[w] = cc[w];
    co[QC_DRAINED] = drained;
  }
}

// ---- K3's tile product: 3xTF32 on wgmma, fed by a producer warp ----------
//
// A CTA of EXEC_THREADS threads: two consumer warpgroups, each owning 64
// rows of the 128 x 128 product (wgmma m64n128k8, tf32 in, f32 out), and a
// producer warp. The producer walks the queue ahead of the consumers and
// streams every MATMUL row's operands as 32-deep k-blocks into a ring of
// EXEC_STAGES raw stages, two copies a k-block: A's 128 rows x 128 bytes as
// one TMA box of a 2-D tensor map over the whole workspace (landing in the
// 128-byte swizzle), B's 32 rows x 512 bytes, contiguous, as one 16 KB
// cp.async.bulk: two requests a k-block, where a first draft issued 129
// (A's rows as 128-byte bulk copies). Each stage is guarded by a full
// mbarrier (the copies' byte count) and an empty one (the consumers'
// release). tf32 wgmma reads its operands K-major, B from shared memory,
// A from shared memory or registers; here both come from shared memory.
// The consumers split each landed k-block into tf32 big and small halves
// and write them in the 128-byte-swizzled K-major layout wgmma's
// descriptors read: A at the offsets it landed at ([m][k], 128 bytes a
// row: one swizzle row), B transposed to [n][k]. The split of k-block
// kb + 1 runs while k-block kb's products are on the tensor cores, into
// the other of two split buffers. Each 8-deep step issues three products,
// small·big, big·small, big·big (small·small dropped, ~2^-22 relative). A
// from registers (no A split in shared memory) was tried: a 288-thread
// CTA gets at most 168 registers a thread, and two 64-register
// accumulators plus 48 of A fragments spilled and serialized the products
// (1.14 against 0.85 ms at C = 132; with a producer warpgroup and
// setmaxnreg ptxas still allocated 168 and spilled: 0.93; PERF.md).
//
// A row's operands are loaded under the previous row's math unless that
// row writes one of them (the rule K1/K2 use): the producer may issue row
// i's copies once every work row before the previous one is done, and,
// when the previous row writes a or b, once that row is done too (the
// consumers publish a count of done rows in shared memory; their global
// writes go through a proxy fence first, since the bulk copies read
// through the async proxy). When the next work row is a MATMUL the
// producer may load under this one, the consumers split its first k-block
// under this row's last products. D + acc is written only after every
// k-block of A and B has landed, so dst may alias a or b.

constexpr int EXEC_CONSUMERS = 2;      // warpgroups, 64 rows of the product each
constexpr int EXEC_CONSUMER_THREADS = 128 * EXEC_CONSUMERS;
constexpr int EXEC_THREADS = EXEC_CONSUMER_THREADS + 32;   // + the producer warp
constexpr int EXEC_KB = 32;            // k-block: 32 f32 = one 128-byte swizzle row
constexpr int EXEC_STAGES = 2;         // raw k-blocks in flight
constexpr int EXEC_FRESH_K = 32;       // depth summed in one fresh accumulator
constexpr int EXEC_KBLOCK_BYTES = TILE * EXEC_KB * 4;   // a k-block of A (or B)
constexpr int EXEC_RAW_BYTES = 2 * EXEC_KBLOCK_BYTES;   // A and B as they land
constexpr int EXEC_SPLIT_BYTES = 4 * EXEC_KBLOCK_BYTES; // big, small of A and Bᵀ
constexpr int EXEC_SMEM_ALIGN = 1024;  // the 128-byte swizzle repeats every 8 rows
constexpr int EXEC_BAR_BYTES = 64;     // 2 x EXEC_STAGES mbarriers, the done count
constexpr int EXEC_SMEM_BYTES =
    EXEC_SMEM_ALIGN + EXEC_STAGES * EXEC_RAW_BYTES + 2 * EXEC_SPLIT_BYTES + EXEC_BAR_BYTES;
constexpr int EXEC_GROUPS = EXEC_KB / EXEC_FRESH_K;   // fresh accumulators a k-block
constexpr int EXEC_UNITS = 2 * TILE * EXEC_KB / 4 / EXEC_CONSUMER_THREADS;
static_assert(EXEC_KB * 4 == 128 && TILE % EXEC_KB == 0, "one swizzle row a k-block row");
static_assert(EXEC_GROUPS * EXEC_FRESH_K == EXEC_KB && EXEC_FRESH_K % 8 == 0,
              "fresh accumulators cover whole 8-deep steps of a k-block");
static_assert(EXEC_UNITS % (2 * EXEC_GROUPS) == 0, "the split spreads over the groups");
static_assert(2 * EXEC_STAGES * 8 + 4 <= EXEC_BAR_BYTES, "barriers fit");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Returns once the phase of parity `parity` has completed. A wait that
// outlasts ~2^30 polls (seconds) traps: a lost arrival or copy then fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++polls == (1u << 30)) __trap();
  } while (!done);
}

// one box of the 2-D tensor map (columns, rows) into shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// `bytes` contiguous bytes global -> shared through the async proxy,
// counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(EXEC_CONSUMER_THREADS) : "memory");
}
// consumers_sync that also returns whether any consumer passed `pred`
__device__ __forceinline__ bool consumers_sync_or(bool pred) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, 1, %2, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r) : "r"((uint32_t)pred), "n"(EXEC_CONSUMER_THREADS)
      : "memory");
  return r != 0;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulator
// registers across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, stride of 1024 bytes between groups of 8 rows
// (both in 16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (+)= a * b: m64n128k8, tf32 in from shared memory (both K-major), f32
// accumulate; scale_d = 0 starts from 0
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-row operand tile
// of 128-byte rows in the 128-byte swizzle (chunk index XOR row % 8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4);
}

// Part `part` of PARTS of this consumer thread's share of splitting a
// landed k-block (raw: A [m][k], rows of 128 bytes in the 128-byte swizzle;
// then B [k][n], rows of 512 bytes) into `split`: A's big and small halves, then Bᵀ's ([n][k]),
// each in the swizzled K-major layout. Returns whether this thread met a
// big that is not finite. A: lanes take neighbouring 16-byte chunks of a
// row; B: lanes take neighbouring columns n, read one float of 4
// consecutive k rows and write one chunk of row n (8 lanes, 8 distinct
// swizzled chunks: no bank conflict).
template <int PARTS>
__device__ __forceinline__ bool exec_split(const unsigned char* raw,
                                           unsigned char* split, int part) {
  constexpr int PER = EXEC_UNITS / PARTS;
  bool nonfinite = false;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = part * PER + i;
    const int f = threadIdx.x + EXEC_CONSUMER_THREADS * (u % (EXEC_UNITS / 2));
    float4 x;
    uint32_t off;
    unsigned char* dst = split;
    if (u < EXEC_UNITS / 2) {            // A: row m = f / 8, chunk c = f % 8
      off = sw128_offset(f >> 3, f & 7);
      x = *reinterpret_cast<const float4*>(raw + off);
    } else {                             // Bᵀ: row n = f % 128, chunk c = f / 128
      const int n = f & (TILE - 1), c = f >> 7;
      const float* rb = reinterpret_cast<const float*>(
          raw + EXEC_KBLOCK_BYTES) + 4 * c * TILE + n;
      x = make_float4(rb[0], rb[TILE], rb[2 * TILE], rb[3 * TILE]);
      off = sw128_offset(n, c);
      dst += 2 * EXEC_KBLOCK_BYTES;
    }
    uint4 big, sml;
    bool finite = split_tf32(x.x, big.x, sml.x);
    finite &= split_tf32(x.y, big.y, sml.y);
    finite &= split_tf32(x.z, big.z, sml.z);
    finite &= split_tf32(x.w, big.w, sml.w);
    *reinterpret_cast<uint4*>(dst + off) = big;
    *reinterpret_cast<uint4*>(dst + EXEC_KBLOCK_BYTES + off) = sml;
    nonfinite |= !finite;
  }
  return nonfinite;
}

// A k-block that holds a big that is not finite: its big halves (A's and
// Bᵀ's) with every such value set to 0, in place, for the cross terms
__device__ __forceinline__ void exec_mask_bigs(unsigned char* split) {
#pragma unroll
  for (int i = 0; i < EXEC_UNITS; ++i) {
    const int f = threadIdx.x + EXEC_CONSUMER_THREADS * (i % (EXEC_UNITS / 2));
    uint4* p = reinterpret_cast<uint4*>(
        split + (i < EXEC_UNITS / 2 ? 0 : 2 * EXEC_KBLOCK_BYTES) + f * 16);
    uint4 w = *p;
    w.x = finite_or_0(w.x); w.y = finite_or_0(w.y);
    w.z = finite_or_0(w.z); w.w = finite_or_0(w.w);
    *p = w;
  }
}

// p (+)= this warpgroup's 64 rows of A·B over the 8-deep steps [t0, t1) of
// the split k-block at shared address `sp`: per step small·big (cross),
// big·small (cross), big·big (bigbig); scale_d = 0 starts p from 0.
__device__ __forceinline__ void exec_products(float (&p)[64], uint32_t sp,
                                              int t0, int t1, int scale_d,
                                              bool cross, bool bigbig) {
  const uint32_t rows = (threadIdx.x >> 7) * (64 * 128);   // this warpgroup's A
  const uint32_t a_big = sp + rows, a_small = a_big + EXEC_KBLOCK_BYTES;
  const uint32_t b_big = sp + 2 * EXEC_KBLOCK_BYTES;
  const uint32_t b_small = b_big + EXEC_KBLOCK_BYTES;
#pragma unroll
  for (int t = t0; t < t1; ++t) {
    const uint32_t k = 32 * t;           // 8 tf32 = 32 bytes a step
    if (cross) {
      wgmma_tf32_n128(p, kmajor_sw128_desc(a_small + k),
                      kmajor_sw128_desc(b_big + k), scale_d);
      wgmma_tf32_n128(p, kmajor_sw128_desc(a_big + k),
                      kmajor_sw128_desc(b_small + k), 1);
      scale_d = 1;
    }
    if (bigbig) {
      wgmma_tf32_n128(p, kmajor_sw128_desc(a_big + k),
                      kmajor_sw128_desc(b_big + k), scale_d);
      scale_d = 1;
    }
  }
}

// The shared state of an executor CTA: the ring's raw stages, the two
// split buffers and the barriers, from a 1024-byte-aligned base.
struct ExecSmem {
  unsigned char* base;
  __device__ unsigned char* raw(int n) const {
    return base + (n % EXEC_STAGES) * EXEC_RAW_BYTES;
  }
  __device__ unsigned char* split(int n) const {
    return base + EXEC_STAGES * EXEC_RAW_BYTES + (n & 1) * EXEC_SPLIT_BYTES;
  }
  __device__ uint64_t* bars() const {
    return reinterpret_cast<uint64_t*>(
        base + EXEC_STAGES * EXEC_RAW_BYTES + 2 * EXEC_SPLIT_BYTES);
  }
  __device__ uint32_t full(int n) const { return smem_u32(bars() + n % EXEC_STAGES); }
  __device__ uint32_t empty(int n) const {
    return smem_u32(bars() + EXEC_STAGES + n % EXEC_STAGES);
  }
  __device__ volatile int* rows_done() const {
    return reinterpret_cast<volatile int*>(bars() + 2 * EXEC_STAGES);
  }
};

// The consumers' split of k-block n of the stream once it has landed, with
// the barrier that makes it visible to both warpgroups' products and frees
// its raw stage; returns whether the k-block holds a big that is not
// finite.
__device__ __forceinline__ bool exec_split_whole(const ExecSmem& sm, int n) {
  mbar_wait(sm.full(n), (n / EXEC_STAGES) & 1);
  const bool nf = exec_split<1>(sm.raw(n), sm.split(n), 0);
  fence_proxy_async_shared();
  const bool any = consumers_sync_or(nf);
  if (threadIdx.x == 0) mbar_arrive(sm.empty(n));
  return any;
}

// One MATMUL row on the consumer warpgroups, D += A @ B over k-blocks n0,
// n0 + 1, ... of the stream. `ready`: the row before split k-block n0 (its
// non-finite flag in `mask`). `prefetch`: the next work row is a MATMUL
// that reads neither operand from D; its first k-block is split here,
// under this row's last products (its flag left in `mask`). acc starts as
// this thread's 64 elements of D, loaded before the first products so that
// their latency hides under them (read after the end of the row before,
// the last to write D, and before this row writes it: the old D, as the
// reference reads it). Each k-block is summed in EXEC_GROUPS fresh
// accumulators p (EXEC_FRESH_K deep, from 0), each added to acc in f32
// with rounding to nearest: the tensor cores sum with truncation, and p
// starts from 0 at a fraction of acc's size. Measured on the card, one
// fresh accumulator a 32-deep k-block keeps the smoke's matmul, mixed and
// chained queues within 6.7e-6, 1.7e-6 and 9.5e-6 of the f32 plain
// version (rtol/atol 1e-4) and is ~10% faster than one an 8-deep step
// (EXEC_FRESH_K = 8), which must wait for the tensor cores four times a
// k-block. A coarser one (the whole 128-deep product) would wait no less,
// as the split buffers turn over every k-block, and would sum with
// truncation at the product's full size, which mma_kblock's note above
// finds past 1e-4. Accumulator register i of
// thread t: row 16 (warp % 4) + t % 32 / 4 + 8 (i % 4 / 2) of this
// warpgroup's 64, column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ void exec_matmul_row(const ExecSmem& sm, float* D, int n0,
                                bool ready, bool prefetch, bool& mask) {
  constexpr int KBLOCKS = TILE / EXEC_KB;
  constexpr int STEPS = EXEC_FRESH_K / 8;
  const int lane = threadIdx.x & 31;
  float* d0 = D + ((threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                   (lane >> 2)) * TILE + 2 * (lane & 3);
  float acc[64], p[64];
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(d0 + 8 * h * TILE + 8 * j);
      acc[4 * j + 2 * h] = v.x;
      acc[4 * j + 2 * h + 1] = v.y;
    }
  if (!ready) mask = exec_split_whole(sm, n0);
#pragma unroll 1
  for (int kb = 0; kb < KBLOCKS; ++kb) {
    const int n = n0 + kb;
    const uint32_t sp = smem_u32(sm.split(n));
    const bool has_next = kb + 1 < KBLOCKS || prefetch;
    bool nf = false;
    if (!mask) {
#pragma unroll
      for (int g = 0; g < EXEC_GROUPS; ++g) {
        wgmma_fence();
        exec_products(p, sp, g * STEPS, (g + 1) * STEPS, 0, true, true);
        wgmma_commit();
        fence_regs(p);
        if (has_next) {                  // the next k-block's split, in parts
          if (g == 0) mbar_wait(sm.full(n + 1), ((n + 1) / EXEC_STAGES) & 1);
          nf |= exec_split<EXEC_GROUPS>(sm.raw(n + 1), sm.split(n + 1), g);
        }
        wgmma_wait_all();
        fence_regs(p);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += p[i];
      }
    } else {
      // a big that is not finite: big·big first, then the cross terms with
      // such bigs taken as 0 (inf * small is NaN where small is 0, and the
      // wrong infinity where it has the other sign); inf and NaN then
      // propagate through big·big alone, as they do in FFMA
      wgmma_fence();
      exec_products(p, sp, 0, EXEC_KB / 8, 0, false, true);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(p);
      consumers_sync();                  // both warpgroups done with the bigs
      exec_mask_bigs(sm.split(n));
      fence_proxy_async_shared();
      consumers_sync();
      wgmma_fence();
      exec_products(p, sp, 0, EXEC_KB / 8, 1, true, false);
      wgmma_commit();
      fence_regs(p);
      if (has_next) {
        mbar_wait(sm.full(n + 1), ((n + 1) / EXEC_STAGES) & 1);
        nf = exec_split<1>(sm.raw(n + 1), sm.split(n + 1), 0);
      }
      wgmma_wait_all();
      fence_regs(p);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += p[i];
    }
    // the next k-block's split is visible to both warpgroups, and both are
    // done reading this one's buffer (the split after next overwrites it)
    fence_proxy_async_shared();
    const bool any = consumers_sync_or(nf);
    if (has_next) {
      mask = any;
      if (threadIdx.x == 0) mbar_arrive(sm.empty(n + 1));
    }
  }
  // every k-block of A and B has landed: D may alias either
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(d0 + 8 * h * TILE + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ int exec_op(const int* d) {
  return min(max(d[W_OPCODE], 0), NUM_OPS - 1);
}

// Whether the first work row after row i is a MATMUL that reads neither
// operand from tile `dst` (the row i writes).
__device__ __forceinline__ bool exec_prefetch(const int* qc, int i, int Q,
                                              int nbuf, int dst) {
  int j = i + 1;
  while (j < Q && qc[(size_t)j * DESC_WIDTH + W_STATUS] < THREAD_WORK) ++j;
  if (j >= Q) return false;
  const int* d = qc + (size_t)j * DESC_WIDTH;
  return exec_op(d) == OP_MATMUL &&
         tile_index(d[W_ARG0] & 255, nbuf) != dst &&
         tile_index(d[W_ARG1], nbuf) != dst;
}

// The producer warp: every MATMUL row's k-blocks into the ring, in queue
// order, each row as soon as the rows before it allow (above).
__device__ void exec_produce(const ExecSmem& sm, const CUtensorMap* tm_ws,
                             const int* qc, const float* wsc, int c, int Q,
                             int nbuf) {
  const int lane = threadIdx.x & 31;
  int n = 0;                  // k-blocks issued
  int ord = 0;                // work rows seen
  int prev_dst = -1;          // the tile the previous work row writes, or -1
  for (int i = 0; i < Q; ++i) {
    const int* d = qc + (size_t)i * DESC_WIDTH;
    if (d[W_STATUS] < THREAD_WORK) continue;
    const int op = exec_op(d);
    const int dst = tile_index(d[W_ARG0] >> 8, nbuf);
    if (op == OP_MATMUL) {
      const int a = tile_index(d[W_ARG0] & 255, nbuf);
      const int b = tile_index(d[W_ARG1], nbuf);
      const int need = prev_dst == a || prev_dst == b ? ord : ord - 1;
      if (lane == 0) {
        uint32_t polls = 0;
        while (*sm.rows_done() < need) {
          __nanosleep(64);
          if (++polls == (1u << 28)) __trap();
        }
      }
      __syncwarp();
      __threadfence_block();
      fence_proxy_async_global();        // the done rows' writes, then our reads
      const int a_row = (c * nbuf + a) * TILE;   // A's first row in the map
      const float* B = wsc + (size_t)b * TT;
      for (int kb = 0; kb < TILE / EXEC_KB; ++kb, ++n) {
        if (lane == 0) {
          mbar_wait(sm.empty(n), ((n / EXEC_STAGES) & 1) ^ 1);
          mbar_expect_tx(sm.full(n), EXEC_RAW_BYTES);
        }
        if (lane == 0) {
          const uint32_t raw = smem_u32(sm.raw(n));
          tma_load_2d(raw, tm_ws, sm.full(n), kb * EXEC_KB, a_row);
          bulk_load(raw + EXEC_KBLOCK_BYTES, B + kb * EXEC_KB * TILE,
                    EXEC_KBLOCK_BYTES, sm.full(n));
        }
      }
    }
    prev_dst = op >= OP_MATMUL && op <= OP_COPY ? dst : -1;
    ++ord;
  }
}

// K3: one CTA a cluster runs its whole queue in order (rows with a work
// status, opcodes clipped to the 6-op table) and writes one from_gpu row.
__global__ void __launch_bounds__(EXEC_THREADS, 1)
execute_kernel(const __grid_constant__ CUtensorMap tm_ws, const int* queue,
               float* ws, int* fromgpu, int Q, int nbuf) {
  extern __shared__ __align__(16) unsigned char exec_smem[];
  const uint32_t s0 = smem_u32(exec_smem);
  ExecSmem sm{exec_smem + (((s0 + EXEC_SMEM_ALIGN - 1) &
                            ~(uint32_t)(EXEC_SMEM_ALIGN - 1)) - s0)};
  const int c = blockIdx.x;
  const int* qc = queue + (size_t)c * Q * DESC_WIDTH;
  float* wsc = ws + (size_t)c * nbuf * TT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EXEC_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 1);
    }
    *sm.rows_done() = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= EXEC_CONSUMER_THREADS) {
    exec_produce(sm, &tm_ws, qc, wsc, c, Q, nbuf);
  } else {
    int n = 0, done = 0;
    bool ready = false;      // the row before split this row's first k-block
    bool mask = false;       // ... and it holds a big that is not finite
    for (int i = 0; i < Q; ++i) {
      const int* d = qc + (size_t)i * DESC_WIDTH;
      if (d[W_STATUS] < THREAD_WORK) continue;     // uniform over the CTA
      const int op = exec_op(d);
      const int dst = tile_index(d[W_ARG0] >> 8, nbuf);
      if (op == OP_MATMUL) {
        const bool prefetch = exec_prefetch(qc, i, Q, nbuf, dst);
        exec_matmul_row(sm, wsc + (size_t)dst * TT, n, ready, prefetch, mask);
        n += TILE / EXEC_KB;
        ready = prefetch;
      } else if (op != 0) {
        elementwise_part<EXEC_CONSUMER_THREADS>(
            op, wsc, dst, tile_index(d[W_ARG0] & 255, nbuf), d[W_ARG1], nbuf);
      }
      fence_proxy_async_global();        // this row's writes, then the
      consumers_sync();                  // producer's reads of them
      ++done;
      if (threadIdx.x == 0) {
        __threadfence_block();
        *sm.rows_done() = done;
      }
    }
    if (threadIdx.x == 0) {
      int* fg = fromgpu + (size_t)c * DESC_WIDTH;
      for (int w = 0; w < DESC_WIDTH; ++w) fg[w] = 0;
      fg[W_STATUS] = THREAD_FINISHED;
      fg[W_ARG0] = done;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Error codes of this file besides cudaError_t (persistent_error_string).
constexpr int ERR_NO_ENCODER = -2;
constexpr int ERR_ENCODE = -3;

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
    else
      cudaGetLastError();
  }
  return fn;
}

// The workspace (C, nbuf, 128, 128) f32 as a 2-D tensor (128 columns,
// C * nbuf * 128 rows), boxes of EXEC_KB columns x 128 rows (one k-block
// of a tile) in the 128-byte swizzle.
int encode_ws(CUtensorMap* map, void* ws, int C, int nbuf) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)TILE,
                              (cuuint64_t)C * nbuf * TILE};
  const cuuint64_t strides[1] = {(cuuint64_t)TILE * 4};
  const cuuint32_t box[2] = {EXEC_KB, TILE};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ws, dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// The dynamic shared memory a drain launch asks for: DRAIN_SMEM_BYTES, or
// what persistent_drain_request_smem set (a fault-injection hook: a size
// above the card's opt-in limit makes the attribute call fail, which the
// launcher must report).
int g_smem_request = 0;

// Allow both drain instances `bytes` of dynamic shared memory. Set before
// every launch, as the flash-attention launcher does, so it holds on
// whichever device is current.
int set_drain_smem(int bytes) {
  auto bare = drain_kernel<false>;
  auto profiled = drain_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      bare, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        profiled, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess)
    cudaGetLastError();    // reported here; the next launch must not see it
  return static_cast<int>(err);
}

}  // namespace

// K1 (profile = 0) and K2 (profile = 1): one drain launch of C clusters.
// ctrl (C, QCTRL_WIDTH) i32, queue (C, Q, DESC_WIDTH) i32, ws
// (C, nbuf, 128, 128) f32, carry (C, 1) f32, tick (C, 1) i32 (K2 only; ws,
// carry and tick updated in place); out: acks (C, Q, DESC_WIDTH) i32,
// results (C, Q) f32, ctrl_out (C, QCTRL_WIDTH) i32, prof
// (C, Q, PROF_WIDTH) i32 (K2 only). Returns the cudaError_t of the shared
// memory attribute call or of the launch; nothing runs if the first fails.
extern "C" int persistent_drain(const void* ctrl, const void* queue, void* ws,
                                void* carry, void* tick, void* acks,
                                void* results, void* ctrl_out, void* prof,
                                int C, int Q, int nbuf, int profile,
                                void* stream) {
  if (C < 1) return 0;
  const int smem = g_smem_request > 0 ? g_smem_request : DRAIN_SMEM_BYTES;
  const int err = set_drain_smem(smem);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ct = static_cast<const int*>(ctrl);
  const int* qu = static_cast<const int*>(queue);
  float* w = static_cast<float*>(ws);
  float* ca = static_cast<float*>(carry);
  int* ti = static_cast<int*>(tick);
  int* ac = static_cast<int*>(acks);
  float* re = static_cast<float*>(results);
  int* co = static_cast<int*>(ctrl_out);
  int* pr = static_cast<int*>(prof);
  if (profile)
    drain_kernel<true><<<C, DRAIN_NT, smem, st>>>(ct, qu, w, ca, ti, ac, re,
                                                  co, pr, Q, nbuf);
  else
    drain_kernel<false><<<C, DRAIN_NT, smem, st>>>(ct, qu, w, ca, ti, ac, re,
                                                   co, pr, Q, nbuf);
  return static_cast<int>(cudaGetLastError());
}

// Fault injection for the tests: the drain launches that follow ask for
// `bytes` of dynamic shared memory instead of DRAIN_SMEM_BYTES (0 restores
// it). A size the card cannot give makes persistent_drain return the
// attribute call's error without launching.
extern "C" void persistent_drain_request_smem(int bytes) {
  g_smem_request = bytes;
}

// K3: queue (C, Q, DESC_WIDTH) i32, ws (C, nbuf, 128, 128) f32 (in place)
// -> fromgpu (C, DESC_WIDTH) i32. Returns the cudaError_t of the attribute
// call or of the launch, or a negative code of this file (no tensor-map
// encoder, a refused tensor map); nothing runs if either of the first fail.
extern "C" int persistent_execute(const void* queue, void* ws, void* fromgpu,
                                  int C, int Q, int nbuf, void* stream) {
  if (C < 1) return 0;
  auto kern = execute_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, EXEC_SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  CUtensorMap tm;
  const int e = encode_ws(&tm, ws, C, nbuf);
  if (e) return e;
  execute_kernel<<<C, EXEC_THREADS, EXEC_SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      tm, static_cast<const int*>(queue), static_cast<float*>(ws),
      static_cast<int*>(fromgpu), Q, nbuf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* persistent_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found in the driver";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused the tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
