// Blockwise causal flash attention, forward (K5) and backward (K5-bwd, at the
// end of the file) — Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (flash_attention_pallas). Same function: q (B,S,Hq,D) against k/v
// (B,Skv,Hkv,D), GQA head h -> kv head h / (Hq/Hkv), scale 1/sqrt(D),
// optional tanh softcap, causal and sliding-window masks, keys at or past
// `kv_len` (the reference's seq_len) masked, online softmax with f32 (m, l,
// acc), masked scores at -1e30 exactly as the reference. Unlike the Pallas
// kernel (which asserts S % block == 0) it masks ragged edges itself: any
// S >= 1. The query and key lengths may differ (cross-attention: a prompt
// against encoder frames) where there is no causal mask and no window; the
// key tiles, their addresses and the kv_len mask then follow Skv (the
// Pallas kernel takes its key blocks from q's length, so it reads only the
// first S keys there: the port holds the reference's flash_xla function).
// Head dims 32, 64, 112, 128 and 256; D = 112 (zamba2-7b) runs the bf16
// kernel at a compute width of 128: its tensor maps are 112 wide, so the
// TMA zero-fills columns 112-127 of each row's second 64-column box, which
// leaves Q·Kᵀ unchanged and P·V's extra columns 0, and only 112 columns
// are stored (the scale stays 1/sqrt(112), from the wrapper). D = 32 (every
// reduced config) computes at 64 the same way, over 32-wide tensor maps.
//
// What bounds it on the H100: at prefill lengths (S >= ~300 per head) the
// useful operations, 4*S^2*D*Hq/2 for causal, outweigh the bytes (q, k, v, o
// each once), so it is operation-bound; short prompts are bound by launch
// and memory latency. What the design does about the bound:
// * bf16 (the serving path) is FlashAttention-3's shape, written by hand:
//   both products on wgmma (the only route to the tensor cores' full
//   rate), S = Q·Kᵀ from shared memory, O += P·V with P converted in place
//   from the S accumulator to bf16 A fragments in registers; K/V tiles
//   stream by TMA through a ring of mbarrier-guarded stages while the two
//   consumer warpgroups compute, a producer warpgroup (its registers given
//   to the consumers with setmaxnreg) issuing the copies; the two
//   consumers take turns to issue their products (pingpong), and inside
//   a warpgroup tile j's softmax runs while tile j-1's P·V is on the
//   tensor cores; scale·log2(e) folded into one multiply before ex2; the
//   mask only on tiles that cross the causal diagonal, the window's lower
//   edge or kv_len, tiles outside the band never loaded; a persistent
//   grid (one CTA an SM) walks the query blocks heaviest first, each
//   CTA's next Q and K/V loading while it finishes the block before;
//   prompts of at most 64 tokens (the serve
//   path's) take an instance with 64-key stages, the idle consumer
//   warpgroup leaving at once. ptxas (sm_90a, CUDA 12.9): PERF.md, PR 15.
// * f32 runs an exact FFMA kernel (bounded by the 67 TFLOP/s f32 rate): one
//   (query block, head) per CTA, D/32 dims per thread with D/32 threads per
//   query row finishing each dot product with xor-shuffles; it loads a K/V
//   tile once per query block and skips tiles outside the band.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). The tensor
//        maps' encoder comes from the driver through the runtime
//        (cudaGetDriverEntryPoint), so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;           // keys per shared-memory tile
constexpr float NEG = -1e30f;    // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// ---- 16-byte vector loads/stores (the f32 path) ---------------------------
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int EPW = 4 / sizeof(T);     // elements per 32-bit word
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack(u.x, out + 0 * EPW, T());
  unpack(u.y, out + 1 * EPW, T());
  unpack(u.z, out + 2 * EPW, T());
  unpack(u.w, out + 3 * EPW, T());
}

__device__ __forceinline__ uint32_t pack(const float* in, float) {
  return __float_as_uint(in[0]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  constexpr int EPW = 4 / sizeof(T);
  uint4 u;
  u.x = pack(in + 0 * EPW, T());
  u.y = pack(in + 1 * EPW, T());
  u.z = pack(in + 2 * EPW, T());
  u.w = pack(in + 3 * EPW, T());
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- FFMA path (f32) --------------------------------------------------------
// grid (ceil(S/BQ), Hq, B); THREADS threads; TPR = ceil(D/32) threads per
// query row (a power of two; 4 at D = 32, so a CTA takes 64 rows, not
// 256), BQ = THREADS/TPR rows per CTA, DPT = D/TPR dims a thread (32; 28
// at D = 112, 8 at D = 32). Thread `part` of a row owns the dims
// (c*TPR + part)*VN + [0, VN) for c in [0, DPT/VN): neighbouring threads
// read neighbouring 16-byte chunks of a shared K/V row (no bank conflicts),
// and a row's dot product is finished with log2(TPR) xor-shuffles.
__host__ __device__ constexpr int threads_per_row(int D) {
  return D <= 32 ? 4 : (D + 31) / 32;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Skv, int Hq, int Hkv,
                 int causal, int window, float softcap, int kv_len,
                 float scale) {
  constexpr int TPR = threads_per_row(D);
  constexpr int BQ = THREADS / TPR;
  constexpr int VN = Vec<T>::N;
  constexpr int DPT = D / TPR;         // dims a thread
  constexpr int NV = DPT / VN;         // 16-byte vectors per thread per row
  constexpr int VPR = D / VN;          // 16-byte vectors per K/V row
  static_assert((TPR & (TPR - 1)) == 0 && NV * VN * TPR == D,
                "head dim must split into 16-byte vectors over TPR threads");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BK * D;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + row;

  float qr[DPT];
  float acc[DPT];
  if (qpos < S) {
    const T* qp = q + ((size_t)(b * S + qpos) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) load16(qp + (c * TPR + part) * VN, qr + c * VN);
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] *= scale;
    acc[i] = 0.f;
  }
  float m = NEG;
  float l = 0.f;

  // the live key range of this query block: [k_begin, k_end)
  const int q_hi = min(q0 + BQ - 1, S - 1);
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                   // the previous tile is consumed
    for (int idx = tid; idx < BK * VPR; idx += THREADS) {
      const int j = idx / VPR;
      const int c = idx % VPR;
      const int kp = k0 + j;
      uint4 kk = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (kp < Skv) {
        const size_t off = ((size_t)(b * Skv + kp) * Hkv + hk) * D + c * VN;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + j * D + c * VN) = kk;
      *reinterpret_cast<uint4*>(sV + j * D + c * VN) = vv;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float kf[VN];
        load16(sK + j * D + (c * TPR + part) * VN, kf);
#pragma unroll
        for (int e = 0; e < VN; ++e) dot = fmaf(qr[c * VN + e], kf[e], dot);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[j] = dot;
    }

    float m_blk = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float x = s[j];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const int kp = k0 + j;
      bool ok = kp < kv_len;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && (qpos - kp) < window;
      x = ok ? x : NEG;
      s[j] = x;
      m_blk = fmaxf(m_blk, x);
    }
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float vf[VN];
        load16(sV + j * D + (c * TPR + part) * VN, vf);
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[c * VN + e] = fmaf(p, vf[e], acc[c * VN + e]);
      }
    }
    m = m_new;
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= inv;
    T* op = o + ((size_t)(b * S + qpos) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) store16(op + (c * TPR + part) * VN, acc + c * VN);
    // the reference's lse: m + log(max(l, 1e-30)); a row with no live key
    // keeps m = -1e30, which the log does not move in f32
    if (lse != nullptr && part == 0)
      lse[((size_t)b * Hq + h) * S + qpos] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Skv, int Hq, int Hkv, int causal, int window,
           float softcap, int kv_len, float scale, cudaStream_t stream) {
  constexpr int BQ = THREADS / threads_per_row(D);
  const int smem = 2 * BK * D * (int)sizeof(T);
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Skv, Hq, Hkv,
      causal, window, softcap, kv_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int Skv, int Hq, int Hkv, int causal,
             int window, float softcap, int kv_len, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 64: return launch<64, T>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 112: return launch<112, T>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 128: return launch<128, T>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 256: return launch<256, T>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    default: return -1;
  }
}

// ---- tensor-core path (bf16): wgmma fed by a TMA/mbarrier ring -------------
//
// A work item is BQ = 128 query rows of one (batch, head): warpgroups 0
// and 1 are consumers (64 rows each: Q·Kᵀ and P·V by wgmma, the online
// softmax in registers), warpgroup 2 the producer (one thread issues every
// TMA copy). Q arrives once an item; K and V stream through rings of
// STAGES stages, each
// stage with a full barrier (the TMA's transaction count) and an empty
// barrier (one arrival per consumer warp: a K stage once its Q·Kᵀ is done,
// a V stage once its P·V is done, so K of the next tile loads while the
// softmax runs).
// Every tile is stored as 64-column slabs of 128-byte rows in the TMA's
// 128-byte swizzle, which is the layout wgmma's B128 descriptors read:
// Q and K K-major (head dim contiguous), V MN-major for B (transposed).
// A head dim that is not a multiple of 64 (32, 112) fills its last slab
// partly: the TMA writes zeros past D, Q·Kᵀ skips the all-zero k16 steps,
// and P·V's columns past D are computed as 0 and never stored.
// A persistent grid of at most one CTA an SM walks the (query block,
// head, sequence) items; Q is released (q_empty) once both consumers'
// last Q·Kᵀ of an item is done, so the next item's Q loads meanwhile.

constexpr int BQ = 128;           // query rows a CTA
constexpr int WG_ROWS = 64;       // query rows a consumer warpgroup
constexpr int CONSUMERS = BQ / WG_ROWS;
constexpr int TC_THREADS = 128 * (CONSUMERS + 1);
constexpr int TMA_BOX = 64;       // inner box: 64 bf16 = 128 bytes, one swizzle row
constexpr int SLAB_ROW_BYTES = 2 * TMA_BOX;
constexpr int SMEM_ALIGN = 1024;  // the 128-byte swizzle repeats every 8 rows
constexpr int BAR_BYTES = 256;    // mbarriers (8 bytes each), after the tiles
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// per head dim: keys a stage and ring depth, and the dynamic shared memory
// (alignment slack + Q + STAGES x (K + V) + barriers)
constexpr int BK_D64 = 128;
constexpr int STAGES_D64 = 4;
constexpr int SMEM_D64 = SMEM_ALIGN + BQ * 64 * 2 + STAGES_D64 * 2 * BK_D64 * 64 * 2 + BAR_BYTES;
constexpr int BK_D128 = 128;
constexpr int STAGES_D128 = 2;
constexpr int SMEM_D128 = SMEM_ALIGN + BQ * 128 * 2 + STAGES_D128 * 2 * BK_D128 * 128 * 2 + BAR_BYTES;
// D = 112 computes at the D = 128 instance's width (two 64-column slabs)
constexpr int BK_D112 = BK_D128;
constexpr int STAGES_D112 = STAGES_D128;
constexpr int SMEM_D112 = SMEM_D128;
// D = 32 computes at the D = 64 instance's width (one 64-column slab)
constexpr int BK_D32 = BK_D64;
constexpr int STAGES_D32 = STAGES_D64;
constexpr int SMEM_D32 = SMEM_D64;
constexpr int BK_D256 = 64;
constexpr int STAGES_D256 = 2;
constexpr int SMEM_D256 = SMEM_ALIGN + BQ * 256 * 2 + STAGES_D256 * 2 * BK_D256 * 256 * 2 + BAR_BYTES;
// S <= 64 (the serve path's short prompts): 64-key stages, half the
// products and exponentials of a 128-key stage, in the same ring
constexpr int BK_SHORT = 64;

template <int D> struct TcCfg;
template <> struct TcCfg<32> {
  static constexpr int STAGES = STAGES_D32, SMEM = SMEM_D32;
};
template <> struct TcCfg<64> {
  static constexpr int STAGES = STAGES_D64, SMEM = SMEM_D64;
};
template <> struct TcCfg<112> {
  static constexpr int STAGES = STAGES_D112, SMEM = SMEM_D112;
};
template <> struct TcCfg<128> {
  static constexpr int STAGES = STAGES_D128, SMEM = SMEM_D128;
};
template <> struct TcCfg<256> {
  static constexpr int STAGES = STAGES_D256, SMEM = SMEM_D256;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------
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
// Returns once the barrier's phase differs from `parity`. A wait that
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

// `bytes` (a multiple of 16) of 16-byte-aligned global memory into shared
// memory, completing on `bar` as the tensor copies do
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// one box of the 4-D tensor map (D, H, S, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// ---- wgmma --------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: between 64-element slabs), stride byte offset
// (between groups of 8 rows of 128 bytes), all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((8 * SLAB_ROW_BYTES) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// 2^x on the special-function unit; results below 2^-126 flush to 0 (a
// weight that small beside the row's largest, 1, changes no sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The products, operand lists written out: m64nNk16, f32 += bf16 x bf16.
// SS: A and B from shared memory, both K-major. RS: A from registers (the
// m16n8k16 A-fragment layout per warp), B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int s) { wgmma_ss_n32(d, a, b, s); }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int s) { wgmma_ss_n64(d, a, b, s); }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int s) { wgmma_rs_n64(d, a, b, s); }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int s) { wgmma_ss_n128(d, a, b, s); }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int s) { wgmma_rs_n128(d, a, b, s); }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int s) { wgmma_rs_n256(d, a, b, s); }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// Scores enter the softmax already in log2 units: without a softcap
// x = s * scale * log2(e) (one multiply); with one,
// x = tanh(s * scale / softcap) * softcap * log2(e). Masked scores are NEG.
struct TcArgs {
  __nv_bfloat16* o;
  float* lse;          // (B, Hq, S) log-sum-exp of each row, or null
  int B, S, Hq, Hkv, causal, window, kv_len;
  int n_qb;            // query blocks a (sequence, head): ceil(S / BQ)
  float softcap;       // > 0: apply the tanh softcap
  float scale_log2;    // scale * log2(e)
  float cap_in;        // scale / softcap
  float cap_out;       // softcap * log2(e)
};

// The key tiles [j_begin, j_end) a query block [q0, q0 + BQ) reads: keys
// before the window's lower edge and after the causal diagonal or kv_len
// are never loaded.
template <int BKT>
__device__ __forceinline__ void tile_range(const TcArgs& a, int q0,
                                           int& j_begin, int& j_end) {
  const int q_hi = min(q0 + BQ - 1, a.S - 1);
  int k_end = a.kv_len;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  j_begin = k_begin / BKT;
  j_end = k_end > k_begin ? (k_end + BKT - 1) / BKT : j_begin;
}

// The grid is persistent: G = gridDim.x CTAs (at most one an SM) walk the
// work items, query block x head x sequence, heaviest first: item i is
// query block n_qb - 1 - i / (B Hq) of head i % Hq of sequence
// (i / Hq) % B. CTA c takes items c, 2G - 1 - c, 2G + c, 4G - 1 - c, ...
// (a snake over rounds of G items), which evens out the causal work; a
// CTA's next Q and K/V tiles load while it finishes the item before.
struct Item {
  int q0, h, b;
};
__device__ __forceinline__ int snake_item(int round) {
  const int G = gridDim.x;
  return round * G + ((round & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}
__device__ __forceinline__ Item item_of(int i, const TcArgs& a) {
  const int per_block = a.B * a.Hq;
  Item it;
  it.q0 = (a.n_qb - 1 - i / per_block) * BQ;
  it.b = (i % per_block) / a.Hq;
  it.h = i % a.Hq;
  return it;
}

template <int D, int BKT>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const TcArgs a) {
  constexpr int STAGES = TcCfg<D>::STAGES;
  constexpr int DC = (D + TMA_BOX - 1) / TMA_BOX * TMA_BOX;   // compute width
  constexpr int SLABS = DC / TMA_BOX;
  constexpr int Q_SLAB = BQ * SLAB_ROW_BYTES;        // bytes of one Q slab
  constexpr int KV_SLAB = BKT * SLAB_ROW_BYTES;      // bytes of one K/V slab
  constexpr int KV_TILE = SLABS * KV_SLAB;
  constexpr int Q_TILE = SLABS * Q_SLAB;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + SMEM_ALIGN - 1) &
                        ~uint32_t(SMEM_ALIGN - 1);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + Q_TILE;                   // STAGES K tiles
  const uint32_t sV = sK + STAGES * KV_TILE;         // STAGES V tiles
  const uint32_t bars = sV + STAGES * KV_TILE;
  const uint32_t q_full = bars;
  const uint32_t q_empty = bars + 8u;
  // after q_full, q_empty: full_k, full_v, empty_k, empty_v, STAGES each
  auto full_k = [&](int s) { return bars + 8u * (2 + s); };
  auto full_v = [&](int s) { return bars + 8u * (2 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (2 + 3 * STAGES + s); };

  const int n_items = a.n_qb * a.B * a.Hq;
  // consumer warpgroups in use: both, unless one holds all of S
  const int active = a.S > WG_ROWS ? CONSUMERS : 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * active);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * active);
      mbar_init(empty_v(s), 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, and no return before either
  // setmaxnreg: otherwise ptxas cannot tell each role's register count and
  // keeps the whole kernel at the launch's 168 (spills, serialized wgmma).
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ===== producer: one thread issues every copy =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      int stage = 0, phase = 0;                      // the next ring slot
      for (int n = 0;; ++n) {
        const int i = snake_item(n);
        if (i >= n_items) break;
        const Item it = item_of(i, a);
        const int hk = it.h / (a.Hq / a.Hkv);
        int j_begin, j_end;
        tile_range<BKT>(a, it.q0, j_begin, j_end);
        mbar_wait(q_empty, (n & 1) ^ 1);             // the last Q is read
        mbar_expect_tx(q_full, Q_TILE);
        for (int s = 0; s < SLABS; ++s)
          tma_load(sQ + s * Q_SLAB, &tm_q, q_full, s * TMA_BOX, it.h, it.q0,
                   it.b);
        for (int j = j_begin; j < j_end; ++j) {
          mbar_wait(empty_k(stage), phase ^ 1);
          mbar_expect_tx(full_k(stage), KV_TILE);
          for (int s = 0; s < SLABS; ++s)
            tma_load(sK + stage * KV_TILE + s * KV_SLAB, &tm_k,
                     full_k(stage), s * TMA_BOX, hk, j * BKT, it.b);
          mbar_wait(empty_v(stage), phase ^ 1);
          mbar_expect_tx(full_v(stage), KV_TILE);
          for (int s = 0; s < SLABS; ++s)
            tma_load(sV + stage * KV_TILE + s * KV_SLAB, &tm_v,
                     full_v(stage), s * TMA_BOX, hk, j * BKT, it.b);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ===== consumers: 64 query rows each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg >= active) return;                        // S fits warpgroup 0
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool has_cap = a.softcap > 0.f;
    int w0 = 0;                                      // this item's rows:
    int r0 = 0;                                      // w0.., r0 and r0 + 8

    float oacc[DC / 2];
    float m[2], l[2];

    // S = Q Kᵀ of the tile in `st`: 64 rows x BKT keys, D / 16 steps
    auto issue_qk = [&](float (&sc)[BKT / 2], int st) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;   // 16 columns a step
        const uint64_t dq = sw128_desc(
            sQ + (ks / 4) * Q_SLAB + wg * WG_ROWS * SLAB_ROW_BYTES + off, 0);
        const uint64_t dk =
            sw128_desc(sK + st * KV_TILE + (ks / 4) * KV_SLAB + off, 0);
        Wgmma<BKT>::ss(sc, dq, dk, ks > 0);
      }
      wgmma_commit();
    };
    // O += P V: V's tile is [key][d], MN-major for B; 16 keys a step
    auto issue_pv = [&](const uint32_t (&p)[BKT / 16][4], int st) {
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        const uint64_t dv = sw128_desc(
            sV + st * KV_TILE + kk * 16 * SLAB_ROW_BYTES, KV_SLAB);
        Wgmma<DC>::rs(oacc, p[kk], dv, 1);
      }
      wgmma_commit();
    };
    // scores -> exp2(x - m) in place, in log2 units: without a softcap
    // x = s * scale * log2(e), with one tanh(s * scale / softcap) * softcap
    // * log2(e); masked to NEG only on tiles that cross the causal
    // diagonal, the window's lower edge or kv_len for some row here. m and
    // l are updated; corr is what O must be scaled by.
    auto softmax = [&](float (&sc)[BKT / 2], int k0, float (&corr)[2]) {
      if (has_cap) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i)
          sc[i] = tanhf(sc[i] * a.cap_in) * a.cap_out;
      } else {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) sc[i] *= a.scale_log2;
      }
      const bool edge = k0 + BKT > a.kv_len ||
                        (a.causal && k0 + BKT - 1 > w0) ||
                        (a.window > 0 && k0 < w0 + WG_ROWS - a.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int row = r0 + 8 * ((i >> 1) & 1);
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          bool ok = col < a.kv_len;
          if (a.causal) ok = ok && col <= row;
          if (a.window > 0) ok = ok && (row - col) < a.window;
          if (!ok) sc[i] = NEG;
        }
      }
      // row maxima over the quad that shares a row
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(sc[i] - m[r]);
        l[r] += sc[i];
      }
    };
    // P in bf16, converted in place into A fragments of P·V (the m16n8k16
    // layout: rows r0 / r0 + 8, keys 2t.. and 2t + 8.. of each 16)
    auto to_bf16 = [&](const float (&sc)[BKT / 2],
                       uint32_t (&p)[BKT / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };

    // Pingpong: the two warpgroups take turns to issue their products, so
    // one's softmax runs while the other's products use the tensor cores
    // (named barrier 1 + w is warpgroup w's turn; warpgroup 0 goes first).
    const bool pingpong = active == CONSUMERS;
    auto my_turn = [&]() {
      if (pingpong) named_bar_sync(1 + wg, 2 * 128);
    };
    auto your_turn = [&]() {
      if (pingpong) named_bar_arrive(2 - wg, 2 * 128);
    };
    if (pingpong && wg == 1) named_bar_arrive(1, 2 * 128);

    int stage = 0, phase = 0;                        // the next ring slot
    for (int n = 0;; ++n) {
      const int i = snake_item(n);
      if (i >= n_items) break;
      const Item it = item_of(i, a);
      w0 = it.q0 + wg * WG_ROWS;
      r0 = w0 + warp * 16 + g;
      int j_begin, j_end;
      tile_range<BKT>(a, it.q0, j_begin, j_end);
#pragma unroll
      for (int x = 0; x < DC / 2; ++x) oacc[x] = 0.f;
      m[0] = m[1] = NEG;
      l[0] = l[1] = 0.f;

      // Tile j's Q·Kᵀ and softmax run while tile j - 1's P·V is in
      // flight; Q is released once the item's last Q·Kᵀ is done.
      mbar_wait(q_full, n & 1);
      if (j_begin < j_end) {
        float s[BKT / 2];
        uint32_t pa[BKT / 16][4];
        float corr[2];
        int cs = stage, cp = phase;                  // tile j's slot
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
        mbar_wait(full_k(cs), cp);
        my_turn();
        wgmma_fence();
        issue_qk(s, cs);
        your_turn();
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(empty_k(cs));
          if (j_begin + 1 == j_end) mbar_arrive(q_empty);
        }
        softmax(s, j_begin * BKT, corr);                // O is still 0
        to_bf16(s, pa);
        for (int j = j_begin + 1; j < j_end; ++j) {
          const int ps = cs, pp = cp;                   // tile j - 1's slot
          cs = stage;
          cp = phase;
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
          mbar_wait(full_k(cs), cp);
          mbar_wait(full_v(ps), pp);
          my_turn();
          wgmma_fence();
          issue_qk(s, cs);
          issue_pv(pa, ps);
          your_turn();
          wgmma_wait<1>();                              // Q·Kᵀ done
          fence_regs(s);
          if (lane == 0) {
            mbar_arrive(empty_k(cs));
            if (j + 1 == j_end) mbar_arrive(q_empty);
          }
          softmax(s, j * BKT, corr);
          wgmma_wait<0>();                              // P·V done
          fence_regs(oacc);
          if (lane == 0) mbar_arrive(empty_v(ps));
#pragma unroll
          for (int x = 0; x < DC / 2; ++x) oacc[x] *= corr[(x >> 1) & 1];
          to_bf16(s, pa);
        }
        mbar_wait(full_v(cs), cp);
        fence_regs(oacc);
        my_turn();
        wgmma_fence();
        issue_pv(pa, cs);
        your_turn();
        wgmma_wait<0>();
        fence_regs(oacc);
        if (lane == 0) mbar_arrive(empty_v(cs));
      } else if (lane == 0) {
        mbar_arrive(q_empty);
      }

      // the quad's partial row sums -> full row sums; the log-sum-exp
      // in natural units (m is a log2 maximum: ln(2) m + ln(l); a row with
      // no live key keeps the reference's -1e30); normalize and store
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = r0 + 8 * r;
        if (a.lse != nullptr && t == 0 && row < a.S)
          a.lse[((size_t)it.b * a.Hq + it.h) * a.S + row] =
              m[r] <= NEG ? NEG
                          : m[r] * 0.6931471805599453f + logf(fmaxf(l[r], 1e-30f));
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < a.S) {
          __nv_bfloat16* op =
              a.o + ((size_t)(it.b * a.S + row) * a.Hq + it.h) * D + 2 * t;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<uint32_t*>(op + 8 * c) =
                pack_bf16(oacc[4 * c + 2 * r] * l[r],
                          oacc[4 * c + 2 * r + 1] * l[r]);
        }
      }
    }
    if (pingpong && wg == 0) named_bar_sync(1, 2 * 128);  // the last turn
  }
}

// ---- host: tensor maps and launch ------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Error codes of this file besides cudaError_t (see k5_error_string).
constexpr int ERR_HEAD_DIM = -1;
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

// The 4-D view (D, H, S, B) of a contiguous (B, S, H, D) bf16 tensor, boxes
// of 64 head-dim columns x `rows` positions of one head and one sequence:
// rows past S, and columns past D, are zero-filled on load, never read from
// the next sequence or head.
int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
                int rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {TMA_BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// A kernel's opt-in shared memory; an error is reported here and cleared,
// so the next launch does not see it
template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// The dynamic shared memory a launch asks for: the instance's own size, or
// what k5_request_smem set (a fault-injection hook: a size above the card's
// opt-in limit makes the attribute call fail, which the launcher reports).
int g_smem_request = 0;

template <int D, int BKT>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int Skv, int Hq, int Hkv, int causal,
              int window, float softcap, int kv_len, float scale,
              cudaStream_t stream) {
  const int smem = g_smem_request > 0 ? g_smem_request : TcCfg<D>::SMEM;
  auto kern = flash_fwd_wgmma_kernel<D, BKT>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  int e = encode_bshd(&tq, q, B, S, Hq, D, BQ);
  if (!e) e = encode_bshd(&tk, k, B, Skv, Hkv, D, BKT);
  if (!e) e = encode_bshd(&tv, v, B, Skv, Hkv, D, BKT);
  if (e) return e;
  TcArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.causal = causal; a.window = window;
  a.kv_len = kv_len; a.softcap = softcap;
  a.scale_log2 = scale * LOG2E;
  a.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  a.cap_out = softcap * LOG2E;
  a.B = B;
  a.n_qb = (S + BQ - 1) / BQ;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)a.n_qb * B * Hq;
  const int grid = (int)(items < sms ? items : sms);   // one CTA an SM
  kern<<<grid, TC_THREADS, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

int launch_bf16(int D, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Skv, int Hq, int Hkv, int causal,
                int window, float softcap, int kv_len, float scale,
                cudaStream_t stream) {
  // a prompt that one consumer warpgroup holds takes 64-key stages (chosen
  // on the query length: a short prompt against 1500 encoder frames too)
  const bool short_s = S <= WG_ROWS;
  switch (D) {
    case 32: return short_s ? launch_tc<32, BK_SHORT>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream)
                            : launch_tc<32, BK_D32>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 64: return short_s ? launch_tc<64, BK_SHORT>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream)
                            : launch_tc<64, BK_D64>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 112: return short_s ? launch_tc<112, BK_SHORT>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream)
                             : launch_tc<112, BK_D112>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 128: return short_s ? launch_tc<128, BK_SHORT>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream)
                             : launch_tc<128, BK_D128>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 256: return launch_tc<256, BK_D256>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    default: return ERR_HEAD_DIM;
  }
}

// ---- K5-bwd: the backward ---------------------------------------------------
//
// Replaces: src/repro/models/attention.py::_flash_bwd_impl, the backward of
// flash_xla's custom VJP (XLA in the reference; no Pallas kernel). Same
// function: with z = q·k·scale, s = softcap(z), -1e30 where masked, and
// p = exp(s - lse) from the forward's lse: delta = rowsum(dO∘o),
// dV = Σ pᵀ dO, dS = p∘(dO Vᵀ - delta) times the softcap's 1 - tanh²(z/cap),
// 0 where masked, times scale; dQ = dS K, dK = dSᵀ Q, the G query heads of
// a kv head summed into its dK and dV. Not its block-by-block schedule. p
// is 0 on every masked key: exp(-1e30 - lse) is 0 on a row with a live
// key, and a row with none (only with kv_len; its lse is -1e30) gives no
// key a gradient. No atomics: every output element has one writer, or a
// sum over the G query heads in a fixed order, so a run repeats bit for bit.
//
// What bounds it on the H100: the function needs five products of the
// forward's shape (S and dP recomputed, dV, dK, dQ: 2.5x its operations), so
// operations at training lengths. Without atomics into dQ this design runs
// seven: S and dP once beside dK/dV and once beside dQ.
//
// bf16 (every training config) is FlashAttention-3's backward, written by
// hand from the forward's parts: TMA copies into 128-byte-swizzled 64-column
// slabs, mbarrier rings, one producer warpgroup (one thread issuing, its
// registers given to the consumers with setmaxnreg), two consumer
// warpgroups on wgmma. It replaces an FFMA kernel that ran every product
// from f32 tiles in shared memory (bf16 widened on load, two shared loads
// an FMA pair), 17x slower at llama3-8b S = 4096. Four launches:
// (a) prep, one warp a row: delta and lse·log2(e) into scratch rows padded
//     to 128 (0 past S), so a stage copies its rows of each with one bulk
//     copy.
// (b) dK/dV, one CTA a (kv block, query head, sequence), the first kv
//     block (the most causal work) first: K and V load once; 64-row tiles of
//     Q and dO stream through a ring with their lse and delta. The
//     transposed form, so no operand is transposed in registers: Sᵀ = K·Qᵀ
//     and dPᵀ = V·dOᵀ from shared memory (Q and dO read K-major, as the
//     forward reads K), Pᵀ = exp2(x - lse·log2 e) and dSᵀ =
//     Pᵀ∘(dPᵀ - delta)·dcap·scale in registers, then dV += Pᵀ·dO and dK +=
//     dSᵀ·Q with Pᵀ and dSᵀ as bf16 A fragments (dO and Q read MN-major, as
//     the forward reads V): one copy of a Q and a dO tile feeds all four
//     products, and the stage is released when both consumers' last product
//     is done. A tile with no live pair for the consumer's keys is skipped;
//     only tiles that cross a mask edge are masked. How the two consumers
//     share the work follows the registers: a 64-row f32 accumulator of
//     width D is D/2 registers a thread, beside 64 for Sᵀ and dPᵀ and 32
//     for the fragments, so
//     * D <= 64: each consumer owns 64 keys of a 128-key block and holds
//       both its dK and its dV (32 + 32 registers);
//     * D >= 112 splits by product over a 64-key block: consumer 0 computes
//       Sᵀ, writes Pᵀ·dcap·scale (f32, in its fragment order) to shared
//       memory between two named barriers and accumulates dV; consumer 1
//       computes dPᵀ, reads it, forms dSᵀ and accumulates dK. Holding both
//       at D = 128 spills ~940 bytes a thread, and this launch then takes
//       3.2 ms at llama3-8b S = 4096 against 1.0 split
//       (scripts/attn_bwd_variants.py). D = 256: K, V 64 KB, two Q/dO stages
//       128 KB, 16 KB for Pᵀ; it still spills ~400 bytes.
//     Grid: one CTA a query head, not a kv head as the FFMA kernel had it
//     (16 x 8 = 128 CTAs at llama3-8b S = 2048, half the card idle behind
//     the first block's 16x causal work): llama3-8b (32/8 heads, 64-key
//     blocks) runs 32 x 32 = 1,024 CTAs at S = 2048 and 2,048 at S = 4096
//     on 132 SMs; the heaviest holds 32 of 16,896 and 64 of 66,560 Q/dO
//     tiles, and the grid's order starts it first. With G > 1 query heads a
//     kv head, (b) writes each query head's dK and dV in f32 to a scratch
//     (B, Skv, Hq, D) x 2 that the wrapper allocates (134 MB at S = 4096);
//     G = 1 (zamba2-7b, whisper) writes them straight out.
// (c) dQ, one CTA a (query block of 128 rows, head, sequence), the last
//     block (the most causal work) first: Q and dO load once, K and V tiles
//     (64 keys; 32 at D = 256, so that Q, dO and two stages fit) stream
//     through a ring; each consumer owns 64 query rows: S = Q·Kᵀ and dP =
//     dO·Vᵀ from shared memory, dS in registers as bf16 A fragments, dQ +=
//     dS·K (K read MN-major). Where the items are fewer than the SMs
//     (whisper's 17 x 1500 cross-attention: 6), each block's key tiles are
//     split over up to 16 CTAs that write f32 partials.
// (d) the sums, one launch: dK and dV over the G query heads, dQ over its
//     key splits, each in a fixed order, cast to bf16 (none where G = 1 and
//     dQ is not split).
// D = 112 and D = 32 compute at widths 128 and 64, as the forward does: the
// tensor maps are D wide, so the TMA zero-fills the last slab's columns past
// D, the products' extra columns come out 0, and only D columns are
// stored. Rows past S or Skv are zero-filled on load, masked, never stored.
// Rounding: P and dS enter their products as bf16 (as P does in the
// forward); every sum is f32.
//
// f32 (the reduced configs, and the card-against-CPU train check, which
// holds the card to 1e-5 where TF32 would not) runs exact FFMA kernels from
// f32 tiles in shared memory, three launches: (a) delta, one warp a row;
// (b) dK/dV, one CTA a (kv block, kv head, sequence) walking the G query
// heads and, for each, the query blocks whose causal/window band reaches
// its keys, recomputing S, P and dS; (c) dQ, one CTA a (query block, head,
// sequence) over its band's kv blocks. Layout: a 16 x 16 thread grid; a
// thread holds a strided micro-tile of S and dP (rows ty + 16a, keys tx +
// 16b) and strided columns tx + 16c of its accumulator rows; tiles are rows
// of D + 1 floats (an odd stride: the 16 rows a warp reads lie in 16 banks).
// D = 256 takes 32-row tiles (shared memory).

constexpr int BWD_THREADS = 256;
template <int D> struct BwdCfg { static constexpr int BQ = 64, BKV = 64; };
template <> struct BwdCfg<256> { static constexpr int BQ = 32, BKV = 32; };

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;    // (B, Hq, S)
  float* delta;        // (B, Hq, S), written by launch (a)
  void *dq, *dk, *dv;
  int B, S, Skv, Hq, Hkv, causal, window, kv_len;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// rows [r0, r0 + R) of head h of a contiguous (B, L, H, D) tensor into an
// f32 tile of rows of D + 1; rows at or past L are zeros
template <int D, int R, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int L, int H, int h) {
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = D / VN;
  for (int idx = threadIdx.x; idx < R * VPR; idx += BWD_THREADS) {
    const int r = idx / VPR;
    const int c = idx % VPR;
    float f[VN];
    if (r0 + r < L) {
      load16(src + ((size_t)(b * L + r0 + r) * H + h) * D + c * VN, f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * (D + 1) + c * VN + e] = f[e];
  }
}

// S = Q Kᵀ and dP = dO Vᵀ of a (query block q0, kv block k0) pair on the
// thread's micro-tile, then P (into sP unless null) and the masked, scaled
// dS (into sdS), rows of BKV + 1. Masked keys and rows at or past S get
// p = dS = 0.
template <int D, int BQ, int BKV>
__device__ __forceinline__ void bwd_scores(
    const BwdArgs& a, const float* sQ, const float* sdO, const float* sK,
    const float* sV, const float* sL, const float* sDl, float* sP, float* sdS,
    int q0, int k0) {
  constexpr int LD = D + 1, LP = BKV + 1, MI = BQ / 16, NJ = BKV / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float sc[MI][NJ], dp[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[MI], oa[MI], kb[NJ], vb[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      qa[i] = sQ[(ty + 16 * i) * LD + d];
      oa[i] = sdO[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kb[j] = sK[(tx + 16 * j) * LD + d];
      vb[j] = sV[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = ty + 16 * i;
    const int qp = q0 + row;
    const float lse = sL[row];
    const float dlt = sDl[row];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      const int kp = k0 + col;
      const float z = sc[i][j] * a.scale;
      float x = z, dcap = 1.f;
      if (a.softcap > 0.f) {
        const float t = tanhf(z / a.softcap);
        x = t * a.softcap;
        dcap = 1.f - t * t;
      }
      bool ok = kp < a.kv_len;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && (qp - kp) < a.window;
      // p = 0 on masked keys: exp(-1e30 - lse) is 0 on a row with a live
      // key, and a row without one (lse = -1e30) gives no key a gradient
      const bool live = ok && qp < a.S;
      const float p = live ? expf(x - lse) : 0.f;
      const float ds = live ? p * (dp[i][j] - dlt) * dcap * a.scale : 0.f;
      if (sP != nullptr) sP[row * LP + col] = p;
      sdS[row * LP + col] = ds;
    }
  }
}

// (a) delta[b, h, s] = Σ_d dO[b, s, h, d] o[b, s, h, d], one warp a row
template <int D, typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_delta_kernel(const BwdArgs a) {
  const long long row =
      ((long long)blockIdx.x * BWD_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.S * a.Hq) return;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* dO = static_cast<const T*>(a.dO) + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dO[d]), to_f32(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % a.Hq);
    const long long bs = row / a.Hq;            // b * S + s
    const int s = (int)(bs % a.S);
    const int b = (int)(bs / a.S);
    a.delta[((size_t)b * a.Hq + h) * a.S + s] = acc;
  }
}

// (b) dK and dV of one kv block of one kv head of one sequence
template <int D, typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int BQ = BwdCfg<D>::BQ, BKV = BwdCfg<D>::BKV;
  constexpr int LD = D + 1, LP = BKV + 1, NA = BKV / 16, NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sdS = sP + BQ * LP;
  float* sL = sdS + BQ * LP;
  float* sDl = sL + BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const T* q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dO);
  load_tile<D, BKV>(sK, static_cast<const T*>(a.k), b, k0, a.Skv, a.Hkv, hk);
  load_tile<D, BKV>(sV, static_cast<const T*>(a.v), b, k0, a.Skv, a.Hkv, hk);
  float dk[NA][NC], dv[NA][NC];
#pragma unroll
  for (int x = 0; x < NA; ++x)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[x][c] = dv[x][c] = 0.f;

  // the query rows whose band reaches keys [k0, k0 + BKV): [q_begin, q_end)
  const int q_begin = a.causal ? k0 : 0;
  int q_end = a.S;
  if (a.window > 0) q_end = min(q_end, k0 + BKV - 1 + a.window);
  if (k0 >= a.kv_len) q_end = q_begin;       // every key here is masked
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = (q_begin / BQ) * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();                       // the last block is consumed
      load_tile<D, BQ>(sQ, q, b, q0, a.S, a.Hq, h);
      load_tile<D, BQ>(sdO, dO, b, q0, a.S, a.Hq, h);
      for (int r = threadIdx.x; r < BQ; r += BWD_THREADS) {
        const bool in = q0 + r < a.S;
        const size_t at = ((size_t)b * a.Hq + h) * a.S + q0 + r;
        sL[r] = in ? a.lse[at] : 0.f;
        sDl[r] = in ? a.delta[at] : 0.f;
      }
      __syncthreads();
      bwd_scores<D, BQ, BKV>(a, sQ, sdO, sK, sV, sL, sDl, sP, sdS, q0, k0);
      __syncthreads();
      // dV += Pᵀ dO, dK += dSᵀ Q over the block's rows
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pj[NA], sj[NA], od[NC], qd[NC];
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          pj[x] = sP[i * LP + ty + 16 * x];
          sj[x] = sdS[i * LP + ty + 16 * x];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          od[c] = sdO[i * LD + tx + 16 * c];
          qd[c] = sQ[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int x = 0; x < NA; ++x)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[x][c] = fmaf(pj[x], od[c], dv[x][c]);
            dk[x][c] = fmaf(sj[x], qd[c], dk[x][c]);
          }
      }
    }
  }
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    const int kp = k0 + ty + 16 * x;
    if (kp >= a.Skv) continue;
    const size_t base = ((size_t)(b * a.Skv + kp) * a.Hkv + hk) * D + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkp[base + 16 * c] = from_f32<T>(dk[x][c]);
      dvp[base + 16 * c] = from_f32<T>(dv[x][c]);
    }
  }
}

// (c) dQ of one query block of one head of one sequence
template <int D, typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int BQ = BwdCfg<D>::BQ, BKV = BwdCfg<D>::BKV;
  constexpr int LD = D + 1, LP = BKV + 1, MI = BQ / 16, NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sdS = sV + BKV * LD;
  float* sL = sdS + BQ * LP;
  float* sDl = sL + BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  load_tile<D, BQ>(sQ, static_cast<const T*>(a.q), b, q0, a.S, a.Hq, h);
  load_tile<D, BQ>(sdO, static_cast<const T*>(a.dO), b, q0, a.S, a.Hq, h);
  for (int r = threadIdx.x; r < BQ; r += BWD_THREADS) {
    const bool in = q0 + r < a.S;
    const size_t at = ((size_t)b * a.Hq + h) * a.S + q0 + r;
    sL[r] = in ? a.lse[at] : 0.f;
    sDl[r] = in ? a.delta[at] : 0.f;
  }
  float dq[MI][NC];
#pragma unroll
  for (int x = 0; x < MI; ++x)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[x][c] = 0.f;

  // the live key range of this query block: [k_begin, k_end)
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  int k_end = a.kv_len;
  if (a.causal) k_end = min(k_end, min(q0 + BQ, a.S));
  for (int k0 = (k_begin / BKV) * BKV; k0 < k_end; k0 += BKV) {
    __syncthreads();                         // the last tile is consumed
    load_tile<D, BKV>(sK, k, b, k0, a.Skv, a.Hkv, hk);
    load_tile<D, BKV>(sV, v, b, k0, a.Skv, a.Hkv, hk);
    __syncthreads();
    bwd_scores<D, BQ, BKV>(a, sQ, sdO, sK, sV, sL, sDl, nullptr, sdS, q0, k0);
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float si[MI], kd[NC];
#pragma unroll
      for (int x = 0; x < MI; ++x) si[x] = sdS[(ty + 16 * x) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kd[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int x = 0; x < MI; ++x)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[x][c] = fmaf(si[x], kd[c], dq[x][c]);
    }
  }
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int x = 0; x < MI; ++x) {
    const int qp = q0 + ty + 16 * x;
    if (qp >= a.S) continue;
    const size_t base = ((size_t)(b * a.S + qp) * a.Hq + h) * D + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqp[base + 16 * c] = from_f32<T>(dq[x][c]);
  }
}

template <int D, typename T>
int bwd_launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr int BQ = BwdCfg<D>::BQ, BKV = BwdCfg<D>::BKV;
  constexpr int LD = D + 1, LP = BKV + 1;
  constexpr int SMEM_KV = (2 * BKV * LD + 2 * BQ * LD + 2 * BQ * LP + 2 * BQ) * 4;
  constexpr int SMEM_Q = (2 * BQ * LD + 2 * BKV * LD + BQ * LP + 2 * BQ) * 4;
  const long long rows = (long long)a.B * a.S * a.Hq;
  const int warps = BWD_THREADS / 32;
  flash_bwd_delta_kernel<D, T>
      <<<(unsigned)((rows + warps - 1) / warps), BWD_THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kkv = flash_bwd_dkdv_kernel<D, T>;
  err = set_smem(kkv, SMEM_KV);
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((a.Skv + BKV - 1) / BKV, a.Hkv, a.B), BWD_THREADS, SMEM_KV,
        stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kq = flash_bwd_dq_kernel<D, T>;
  err = set_smem(kq, SMEM_Q);
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3((a.S + BQ - 1) / BQ, a.Hq, a.B), BWD_THREADS, SMEM_Q, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_d(int D, const BwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32: return bwd_launch<32, T>(a, stream);
    case 64: return bwd_launch<64, T>(a, stream);
    case 112: return bwd_launch<112, T>(a, stream);
    case 128: return bwd_launch<128, T>(a, stream);
    case 256: return bwd_launch<256, T>(a, stream);
    default: return ERR_HEAD_DIM;
  }
}


// ---- K5-bwd, bf16: wgmma fed by TMA/mbarrier rings (see the note above) ----

constexpr int BWD_ROWS = 64;      // query rows a dK/dV stage, and a dQ consumer's
constexpr int BWD_PAD = BQ;       // scratch rows padded to a dQ block
constexpr int BAR_W_FULL = 1;     // named barriers of the split by product
constexpr int BAR_W_EMPTY = 2;

template <int D> struct BwdTc {
  static constexpr int DC = (D + TMA_BOX - 1) / TMA_BOX * TMA_BOX;  // compute width
  static constexpr int SLABS = DC / TMA_BOX;
  static constexpr bool SPLIT = DC >= 128;     // one consumer a product
  // (b) dK/dV: keys a CTA, Q/dO ring depth; K, V, STAGES x (Q, dO), lse and
  // delta, and with SPLIT the 64 x 64 f32 Pᵀ·dcap·scale
  static constexpr int BKV = SPLIT ? 64 : 128;
  static constexpr int KV_STAGES = DC == 256 ? 2 : 4;
  static constexpr int KV_SLAB = BKV * SLAB_ROW_BYTES;
  static constexpr int KV_TILE = SLABS * KV_SLAB;
  static constexpr int R_SLAB = BWD_ROWS * SLAB_ROW_BYTES;
  static constexpr int R_TILE = SLABS * R_SLAB;
  static constexpr int W_BYTES = SPLIT ? 64 * 64 * 4 : 0;
  static constexpr int KV_SMEM = SMEM_ALIGN + 2 * KV_TILE +
                                 2 * KV_STAGES * R_TILE +
                                 2 * KV_STAGES * BWD_ROWS * 4 + W_BYTES +
                                 BAR_BYTES;
  // (c) dQ: keys a stage, K/V ring depth; Q, dO, STAGES x (K, V), lse, delta
  static constexpr int BKT = DC == 256 ? 32 : 64;
  static constexpr int Q_STAGES = DC == 256 ? 2 : 4;
  static constexpr int T_SLAB = BKT * SLAB_ROW_BYTES;
  static constexpr int T_TILE = SLABS * T_SLAB;
  static constexpr int Q_SLAB = BQ * SLAB_ROW_BYTES;
  static constexpr int Q_TILE = SLABS * Q_SLAB;
  static constexpr int Q_SMEM = SMEM_ALIGN + 2 * Q_TILE +
                                2 * Q_STAGES * T_TILE + 2 * BQ * 4 + BAR_BYTES;
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
                "more shared memory than a block can have");
};

struct BwdTcArgs {
  const float* lse2;       // (B, Hq, S_pad): lse·log2(e), 0 past S
  const float* delta;      // (B, Hq, S_pad): rowsum(dO∘o), 0 past S
  __nv_bfloat16 *dq, *dk, *dv;
  float* part;             // G > 1: (B, Skv, Hq, D) f32 dK partials, then dV's
  float* dq_part;          // dq_split > 1: (dq_split, B, S, Hq, D) f32
  int dq_split;            // key ranges a dQ block is split over
  int B, S, Skv, Hq, Hkv, causal, window, kv_len, S_pad;
  int n_kb, n_qb;          // kv blocks of BKV, query blocks of BQ
  float softcap;           // > 0: the tanh softcap
  float scale;             // 1/sqrt(D)
  float scale_log2;        // scale·log2(e)
  float cap_in;            // scale / softcap
  float cap_out;           // softcap·log2(e)
};

// A raw score s = q·k in log2 units, and dcap = the softcap's chain rule
// times scale: x = s·scale·log2(e) without a softcap; with one, t =
// tanh(s·scale/cap), x = t·cap·log2(e), dcap = (1 - t²)·scale.
__device__ __forceinline__ float bwd_logit(const BwdTcArgs& a, float s,
                                           float& dcap) {
  if (a.softcap > 0.f) {
    const float th = tanhf(s * a.cap_in);
    dcap = (1.f - th * th) * a.scale;
    return th * a.cap_out;
  }
  dcap = a.scale;
  return s * a.scale_log2;
}
__device__ __forceinline__ bool bwd_live(const BwdTcArgs& a, int q, int k) {
  bool ok = k < a.kv_len && q < a.S;
  if (a.causal) ok = ok && k <= q;
  if (a.window > 0) ok = ok && q - k < a.window;
  return ok;
}
// queries [q0, q0 + nq) against keys [k0, k0 + nk): no pair live ...
__device__ __forceinline__ bool bwd_dead(const BwdTcArgs& a, int q0, int nq,
                                         int k0, int nk) {
  return q0 >= a.S || k0 >= a.kv_len || (a.causal && k0 > q0 + nq - 1) ||
         (a.window > 0 && q0 - (k0 + nk - 1) >= a.window);
}
// ... or every pair live (no mask needed)
__device__ __forceinline__ bool bwd_all_live(const BwdTcArgs& a, int q0,
                                             int nq, int k0, int nk) {
  return q0 + nq <= a.S && k0 + nk <= a.kv_len &&
         (!a.causal || k0 + nk - 1 <= q0) &&
         (a.window == 0 || q0 + nq - 1 - k0 < a.window);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// (a) each row of (B, Hq, S_pad): delta = Σ_d dO·o and lse·log2(e), both 0
// past S; one warp a row, 4 columns a lane
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dO,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int B, int S, int Hq, int D,
                      int S_pad) {
  const long long row =
      ((long long)blockIdx.x * BWD_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Hq * S_pad) return;
  const int s = (int)(row % S_pad);
  const long long bh = row / S_pad;            // b * Hq + h
  float acc = 0.f;
  if (s < S) {
    const long long b = bh / Hq;
    const int h = (int)(bh % Hq);
    const size_t at = ((size_t)(b * S + s) * Hq + h) * D;
    for (int d = 4 * lane; d < D; d += 128) {
      const uint2 x = *reinterpret_cast<const uint2*>(o + at + d);
      const uint2 y = *reinterpret_cast<const uint2*>(dO + at + d);
      acc = fmaf(bf16_lo(x.x), bf16_lo(y.x), acc);
      acc = fmaf(bf16_hi(x.x), bf16_hi(y.x), acc);
      acc = fmaf(bf16_lo(x.y), bf16_lo(y.y), acc);
      acc = fmaf(bf16_hi(x.y), bf16_hi(y.y), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = s < S ? lse[bh * S + s] * LOG2E : 0.f;
  }
}

// Rows `kr` and `kr + 8` of a consumer's 64 x DC accumulator (columns 8c +
// 2t, 8c + 2t + 1) to keys kr.. of head `head`: bf16 into `out` (B, Skv,
// Hkv, D), or, where `part` is not null, f32 into part (B, Skv, Hq, D).
template <int D, int N>
__device__ __forceinline__ void bwd_store_rows(const BwdTcArgs& a,
                                               const float (&acc)[N], int kr,
                                               int t, int b, int h, int hk,
                                               __nv_bfloat16* out,
                                               float* part) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    if (key >= a.Skv) continue;
    if (part == nullptr) {
      __nv_bfloat16* dst =
          out + ((size_t)(b * a.Skv + key) * a.Hkv + hk) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c) =
            pack_bf16(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    } else {
      float* dst = part + ((size_t)(b * a.Skv + key) * a.Hq + h) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(dst + 8 * c) =
            make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

// (b) dK and dV of one kv block for one query head of one sequence
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const BwdTcArgs a) {
  using C = BwdTc<D>;
  constexpr int STAGES = C::KV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const uint32_t sK = base;
  const uint32_t sV = sK + C::KV_TILE;
  const uint32_t sQ = sV + C::KV_TILE;                   // STAGES Q tiles
  const uint32_t sdO = sQ + STAGES * C::R_TILE;          // STAGES dO tiles
  const uint32_t sL = sdO + STAGES * C::R_TILE;          // STAGES x 64 floats
  const uint32_t sDl = sL + STAGES * BWD_ROWS * 4;       // STAGES x 64 floats
  const uint32_t sW = sDl + STAGES * BWD_ROWS * 4;       // SPLIT: 64 x 64 f32
  const uint32_t bars = sW + C::W_BYTES;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto f32_at = [&](uint32_t addr) {
    return reinterpret_cast<float*>(smem_raw + (addr - raw));
  };

  // the item: kv block (the first, with the most causal work, first), then
  // sequence and query head
  const int per_block = a.B * a.Hq;
  const int k0 = (int)(blockIdx.x / per_block) * C::BKV;
  const int b = (int)(blockIdx.x % per_block) / a.Hq;
  const int h = (int)(blockIdx.x % a.Hq);
  const int hk = h / (a.Hq / a.Hkv);
  // the 64-row query tiles whose band reaches keys [k0, k0 + BKV)
  const int q_begin = a.causal ? k0 : 0;
  int q_end = a.S;
  if (a.window > 0) q_end = min(q_end, k0 + C::BKV - 1 + a.window);
  if (k0 >= a.kv_len) q_end = q_begin;
  const int t_begin = q_begin / BWD_ROWS;
  const int t_end =
      q_end > q_begin ? (q_end + BWD_ROWS - 1) / BWD_ROWS : t_begin;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ===== producer: one thread issues every copy =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * C::KV_TILE);
      for (int s = 0; s < C::SLABS; ++s) {
        tma_load(sK + s * C::KV_SLAB, &tm_k, kv_full, s * TMA_BOX, hk, k0, b);
        tma_load(sV + s * C::KV_SLAB, &tm_v, kv_full, s * TMA_BOX, hk, k0, b);
      }
      const size_t lrow = ((size_t)b * a.Hq + h) * a.S_pad;
      int stage = 0, phase = 0;
      for (int tq = t_begin; tq < t_end; ++tq) {
        const int q0 = tq * BWD_ROWS;
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * C::R_TILE + 2 * BWD_ROWS * 4);
        for (int s = 0; s < C::SLABS; ++s) {
          tma_load(sQ + stage * C::R_TILE + s * C::R_SLAB, &tm_q, full(stage),
                   s * TMA_BOX, h, q0, b);
          tma_load(sdO + stage * C::R_TILE + s * C::R_SLAB, &tm_do,
                   full(stage), s * TMA_BOX, h, q0, b);
        }
        bulk_load(sL + stage * BWD_ROWS * 4, a.lse2 + lrow + q0,
                  BWD_ROWS * 4, full(stage));
        bulk_load(sDl + stage * BWD_ROWS * 4, a.delta + lrow + q0,
                  BWD_ROWS * 4, full(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ===== consumers =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this consumer's keys: its own 64 of the block, or (SPLIT) all 64
    const uint32_t koff = C::SPLIT ? 0u : wg * 64u * SLAB_ROW_BYTES;
    const int kw0 = k0 + (C::SPLIT ? 0 : wg * 64);
    const int kr = kw0 + warp * 16 + g;              // its rows kr, kr + 8
    float* const part = a.part;                      // dK's, then dV's
    float* const part_v =
        part == nullptr ? nullptr : part + (size_t)a.B * a.Skv * a.Hq * D;

    // Xᵀ = rows·colsᵀ: this consumer's 64 K (or V) rows against the 64-row
    // Q (or dO) tile at `cols`, both K-major, D / 16 steps
    auto issue_t = [&](float (&x)[32], uint32_t rows, uint32_t cols) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        Wgmma<64>::ss(x,
                      sw128_desc(rows + (ks / 4) * C::KV_SLAB + koff + off, 0),
                      sw128_desc(cols + (ks / 4) * C::R_SLAB + off, 0),
                      ks > 0);
      }
    };
    // acc += Xᵀ·M: A the bf16 fragments of a 64-key x 64-query tile, B the
    // 64-row tile at `mn` (dO or Q) read MN-major, 16 queries a step
    auto issue_rs = [&](float (&acc)[C::DC / 2], const uint32_t (&x)[4][4],
                        uint32_t mn) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<C::DC>::rs(acc, x[kk],
                         sw128_desc(mn + kk * 16 * SLAB_ROW_BYTES, C::R_SLAB),
                         1);
    };
    auto to_frags = [&](const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
    };
    // Pᵀ in place of Sᵀ, 0 on masked pairs, and each(i, Pᵀ·dcap·scale,
    // delta) per element (element i's query is q0 + 8 (i >> 2) + 2t + (i &
    // 1), its key kr + 8 ((i >> 1) & 1))
    auto probs = [&](float (&x)[32], int q0, int stage, auto&& each) {
      const float2* L =
          reinterpret_cast<const float2*>(f32_at(sL + stage * BWD_ROWS * 4));
      const float2* Dl =
          reinterpret_cast<const float2*>(f32_at(sDl + stage * BWD_ROWS * 4));
      const bool edge = !bwd_all_live(a, q0, BWD_ROWS, kw0, 64);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 l2 = L[4 * c + t];
        const float2 dl = Dl[4 * c + t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          float dcap;
          const float lg = bwd_logit(a, x[i], dcap);
          const bool ok = !edge || bwd_live(a, q0 + 8 * c + 2 * t + (e & 1),
                                            kr + 8 * ((e >> 1) & 1));
          const float p = ok ? ex2(lg - ((e & 1) ? l2.y : l2.x)) : 0.f;
          x[i] = p;
          each(i, p * dcap, (e & 1) ? dl.y : dl.x);
        }
      }
    };

    mbar_wait(kv_full, 0);
    int stage = 0, phase = 0;
    if constexpr (!C::SPLIT) {
      float dv[C::DC / 2], dk[C::DC / 2];
#pragma unroll
      for (int x = 0; x < C::DC / 2; ++x) dv[x] = dk[x] = 0.f;
      for (int tq = t_begin; tq < t_end; ++tq) {
        const int q0 = tq * BWD_ROWS;
        mbar_wait(full(stage), phase);
        if (!bwd_dead(a, q0, BWD_ROWS, kw0, 64)) {
          const uint32_t q_at = sQ + stage * C::R_TILE;
          const uint32_t do_at = sdO + stage * C::R_TILE;
          float s[32], dp[32];
          wgmma_fence();
          issue_t(s, sK, q_at);
          issue_t(dp, sV, do_at);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          // Pᵀ, and dSᵀ = Pᵀ∘(dPᵀ - delta)·dcap·scale in place of dPᵀ
          probs(s, q0, stage, [&](int i, float pd, float dl) {
            dp[i] = pd * (dp[i] - dl);
          });
          uint32_t pa[4][4], da[4][4];
          to_frags(s, pa);
          to_frags(dp, da);
          wgmma_fence();
          issue_rs(dv, pa, do_at);
          issue_rs(dk, da, q_at);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
        }
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      bwd_store_rows<D>(a, dk, kr, t, b, h, hk, a.dk, part);
      bwd_store_rows<D>(a, dv, kr, t, b, h, hk, a.dv, part_v);
    } else {
      // consumer 0: Sᵀ, Pᵀ, dV; consumer 1: dPᵀ, dSᵀ, dK. Pᵀ·dcap·scale
      // passes through sW (fragment order: element i of thread tw at
      // i * 128 + tw) between BAR_W_FULL (written) and BAR_W_EMPTY (read).
      float acc[C::DC / 2];
#pragma unroll
      for (int x = 0; x < C::DC / 2; ++x) acc[x] = 0.f;
      float* W = f32_at(sW);
      if (wg == 1) named_bar_arrive(BAR_W_EMPTY, 2 * 128);
      for (int tq = t_begin; tq < t_end; ++tq) {
        const int q0 = tq * BWD_ROWS;
        mbar_wait(full(stage), phase);
        if (!bwd_dead(a, q0, BWD_ROWS, kw0, 64)) {
          const uint32_t q_at = sQ + stage * C::R_TILE;
          const uint32_t do_at = sdO + stage * C::R_TILE;
          float x[32];
          uint32_t fa[4][4];
          wgmma_fence();
          issue_t(x, wg == 0 ? sK : sV, wg == 0 ? q_at : do_at);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(x);
          if (wg == 0) {
            named_bar_sync(BAR_W_EMPTY, 2 * 128);
            probs(x, q0, stage, [&](int i, float pd, float) {
              W[i * 128 + tw] = pd;
            });
            __threadfence_block();
            named_bar_arrive(BAR_W_FULL, 2 * 128);
            to_frags(x, fa);
            wgmma_fence();
            issue_rs(acc, fa, do_at);
          } else {
            const float2* Dl = reinterpret_cast<const float2*>(
                f32_at(sDl + stage * BWD_ROWS * 4));
            named_bar_sync(BAR_W_FULL, 2 * 128);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float2 dl = Dl[4 * c + t];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * c + e;
                x[i] = W[i * 128 + tw] * (x[i] - ((e & 1) ? dl.y : dl.x));
              }
            }
            __threadfence_block();
            named_bar_arrive(BAR_W_EMPTY, 2 * 128);
            to_frags(x, fa);
            wgmma_fence();
            issue_rs(acc, fa, q_at);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      if (wg == 0) named_bar_sync(BAR_W_EMPTY, 2 * 128);  // the last arrival
      if (wg == 0)
        bwd_store_rows<D>(a, acc, kr, t, b, h, hk, a.dv, part_v);
      else
        bwd_store_rows<D>(a, acc, kr, t, b, h, hk, a.dk, part);
    }
  }
}

// (d) the fixed-order sums, one launch for every job: output element e (bf16)
// of a job = Σ_{g < n} src[(e / D) outer + e % D + g step], g = 0, 1, ...
// in order; 4 elements a thread. The jobs: dK and dV over the G query heads
// of a kv head (outer G·D, step D), dQ over its key splits (outer D, step
// one partial).
struct SumJob {
  const float* src;
  __nv_bfloat16* dst;
  long long n4;         // output elements / 4
  long long outer;      // partials' offset of one D-row of the output
  long long step;       // from one partial to the next
  int n;                // partials summed
  int blocks;           // this job's thread blocks
};
struct SumJobs {
  SumJob job[3];
  int count;
};

__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_sum_kernel(const SumJobs jobs, int D) {
  int j = 0;
  int blk = blockIdx.x;
  while (j + 1 < jobs.count && blk >= jobs.job[j].blocks) {
    blk -= jobs.job[j].blocks;
    ++j;
  }
  const SumJob& job = jobs.job[j];
  const long long i = (long long)blk * BWD_THREADS + threadIdx.x;
  if (i >= job.n4) return;
  const long long e = 4 * i;
  const float* p = job.src + (e / D) * job.outer + e % D;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int g = 1; g < job.n; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(p + g * job.step);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  uint2 o;
  o.x = pack_bf16(acc.x, acc.y);
  o.y = pack_bf16(acc.z, acc.w);
  *reinterpret_cast<uint2*>(job.dst + e) = o;
}

// (c) dQ of one query block of one head of one sequence, over one of the
// block's `dq_split` contiguous ranges of key tiles (f32 partials into
// a.dq_part where dq_split > 1)
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const BwdTcArgs a) {
  using C = BwdTc<D>;
  constexpr int STAGES = C::Q_STAGES;
  constexpr int BKT = C::BKT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const uint32_t sQ = base;
  const uint32_t sdO = sQ + C::Q_TILE;
  const uint32_t sK = sdO + C::Q_TILE;                   // STAGES K tiles
  const uint32_t sV = sK + STAGES * C::T_TILE;           // STAGES V tiles
  const uint32_t sL = sV + STAGES * C::T_TILE;           // BQ floats
  const uint32_t sDl = sL + BQ * 4;                      // BQ floats
  const uint32_t bars = sDl + BQ * 4;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto f32_at = [&](uint32_t addr) {
    return reinterpret_cast<const float*>(smem_raw + (addr - raw));
  };

  // the item: query block (the last, with the most causal work, first),
  // then sequence, head and key split
  const int item = (int)blockIdx.x / a.dq_split;
  const int split = (int)blockIdx.x % a.dq_split;
  const int per_block = a.B * a.Hq;
  const int q0 = (a.n_qb - 1 - item / per_block) * BQ;
  const int b = (item % per_block) / a.Hq;
  const int h = item % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  // the key tiles the block's band reaches, and this split's share of them
  int k_end = a.kv_len;
  if (a.causal) k_end = min(k_end, min(q0 + BQ, a.S));
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int jb = k_begin / BKT;
  const int n_tiles = k_end > k_begin ? (k_end + BKT - 1) / BKT - jb : 0;
  const int j_begin = jb + n_tiles * split / a.dq_split;
  const int j_end = jb + n_tiles * (split + 1) / a.dq_split;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ===== producer: one thread issues every copy =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      const size_t lrow = ((size_t)b * a.Hq + h) * a.S_pad;
      mbar_expect_tx(q_full, 2 * C::Q_TILE + 2 * BQ * 4);
      for (int s = 0; s < C::SLABS; ++s) {
        tma_load(sQ + s * C::Q_SLAB, &tm_q, q_full, s * TMA_BOX, h, q0, b);
        tma_load(sdO + s * C::Q_SLAB, &tm_do, q_full, s * TMA_BOX, h, q0, b);
      }
      bulk_load(sL, a.lse2 + lrow + q0, BQ * 4, q_full);
      bulk_load(sDl, a.delta + lrow + q0, BQ * 4, q_full);
      int stage = 0, phase = 0;
      for (int j = j_begin; j < j_end; ++j) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * C::T_TILE);
        for (int s = 0; s < C::SLABS; ++s) {
          tma_load(sK + stage * C::T_TILE + s * C::T_SLAB, &tm_k, full(stage),
                   s * TMA_BOX, hk, j * BKT, b);
          tma_load(sV + stage * C::T_TILE + s * C::T_SLAB, &tm_v, full(stage),
                   s * TMA_BOX, hk, j * BKT, b);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ===== consumers: 64 query rows each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int w0 = q0 + wg * WG_ROWS;
    const int rq = w0 + warp * 16 + g;               // its rows rq, rq + 8
    const uint32_t qoff = wg * WG_ROWS * SLAB_ROW_BYTES;
    float dq[C::DC / 2];
#pragma unroll
    for (int x = 0; x < C::DC / 2; ++x) dq[x] = 0.f;

    mbar_wait(q_full, 0);
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l2[r] = f32_at(sL)[rq - q0 + 8 * r];
      dl[r] = f32_at(sDl)[rq - q0 + 8 * r];
    }
    int stage = 0, phase = 0;
    for (int j = j_begin; j < j_end; ++j) {
      const int k0 = j * BKT;
      mbar_wait(full(stage), phase);
      if (!bwd_dead(a, w0, WG_ROWS, k0, BKT)) {
        const uint32_t k_at = sK + stage * C::T_TILE;
        const uint32_t v_at = sV + stage * C::T_TILE;
        float s[BKT / 2], dp[BKT / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          Wgmma<BKT>::ss(s,
                         sw128_desc(sQ + (ks / 4) * C::Q_SLAB + qoff + off, 0),
                         sw128_desc(k_at + (ks / 4) * C::T_SLAB + off, 0),
                         ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          Wgmma<BKT>::ss(dp,
                         sw128_desc(sdO + (ks / 4) * C::Q_SLAB + qoff + off, 0),
                         sw128_desc(v_at + (ks / 4) * C::T_SLAB + off, 0),
                         ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // dS = P∘(dP - delta)·dcap·scale, 0 on masked pairs (row rq + 8r,
        // key k0 + 8 (i >> 2) + 2t + (i & 1))
        const bool edge = !bwd_all_live(a, w0, WG_ROWS, k0, BKT);
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int r = (i >> 1) & 1;
          float dcap;
          const float p = ex2(bwd_logit(a, s[i], dcap) - l2[r]);
          const bool ok =
              !edge || bwd_live(a, rq + 8 * r, k0 + 8 * (i >> 2) + 2 * t + (i & 1));
          s[i] = ok ? p * (dp[i] - dl[r]) * dcap : 0.f;
        }
        uint32_t da[BKT / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            da[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        // dQ += dS·K: K's tile is [key][d], MN-major for B; 16 keys a step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk)
          Wgmma<C::DC>::rs(dq, da[kk],
                           sw128_desc(k_at + kk * 16 * SLAB_ROW_BYTES, C::T_SLAB),
                           1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      if (lane == 0) mbar_arrive(empty(stage));
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 8 * r;
      if (row >= a.S) continue;
      const size_t at = ((size_t)(b * a.S + row) * a.Hq + h) * D + 2 * t;
      if (a.dq_split == 1) {
        __nv_bfloat16* dst = a.dq + at;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<uint32_t*>(dst + 8 * c) =
              pack_bf16(dq[4 * c + 2 * r], dq[4 * c + 2 * r + 1]);
      } else {
        float* dst = a.dq_part + (size_t)split * a.B * a.S * a.Hq * D + at;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<float2*>(dst + 8 * c) =
              make_float2(dq[4 * c + 2 * r], dq[4 * c + 2 * r + 1]);
      }
    }
  }
}

// dQ's key splits: one unless the (query block, head, sequence) items are
// fewer than the SMs (whisper's 17 x 1500 cross-attention: 6 items), then
// enough to fill them, at least two key tiles a split, at most 16
int dq_splits(int B, int S, int Skv, int Hq, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    sms = 132;
  }
  const int bkt = D > 128 ? 32 : 64;
  const long long items = (long long)((S + BQ - 1) / BQ) * B * Hq;
  if (items >= sms) return 1;
  const int by_sms = (int)((sms + items - 1) / items);
  const int by_tiles = max(1, (Skv + bkt - 1) / bkt / 2);
  return min(16, min(by_sms, by_tiles));
}

// The bf16 backward's scratch, in floats: lse·log2(e) and delta, (B, Hq,
// S_pad) each; with G > 1 the f32 partials of dK and dV, (B, Skv, Hq, D)
// each; with dQ split, its f32 partials, (splits, B, S, Hq, D).
long long bwd_tc_scratch(int B, int S, int Skv, int Hq, int Hkv, int D) {
  const long long s_pad = (S + BWD_PAD - 1) / BWD_PAD * BWD_PAD;
  long long n = 2LL * B * Hq * s_pad;
  if (Hq != Hkv) n += 2LL * B * Skv * Hq * D;
  const int splits = dq_splits(B, S, Skv, Hq, D);
  if (splits > 1) n += (long long)splits * B * S * Hq * D;
  return n;
}

template <int D>
int bwd_tc(const BwdArgs& a, float* scratch, cudaStream_t stream) {
  using C = BwdTc<D>;
  static_assert(C::BKT == (D > 128 ? 32 : 64), "dq_splits' key tile");
  BwdTcArgs t;
  t.S_pad = (a.S + BWD_PAD - 1) / BWD_PAD * BWD_PAD;
  const size_t rows = (size_t)a.B * a.Hq * t.S_pad;
  const size_t kv_part = (size_t)a.B * a.Skv * a.Hq * D;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  float* rest = scratch + 2 * rows;
  t.lse2 = lse2;
  t.delta = delta;
  t.part = nullptr;
  if (a.Hq != a.Hkv) {
    t.part = rest;
    rest += 2 * kv_part;
  }
  t.dq_split = dq_splits(a.B, a.S, a.Skv, a.Hq, D);
  t.dq_part = t.dq_split > 1 ? rest : nullptr;
  t.dq = static_cast<__nv_bfloat16*>(a.dq);
  t.dk = static_cast<__nv_bfloat16*>(a.dk);
  t.dv = static_cast<__nv_bfloat16*>(a.dv);
  t.B = a.B; t.S = a.S; t.Skv = a.Skv; t.Hq = a.Hq; t.Hkv = a.Hkv;
  t.causal = a.causal; t.window = a.window; t.kv_len = a.kv_len;
  t.n_kb = (a.Skv + C::BKV - 1) / C::BKV;
  t.n_qb = (a.S + BQ - 1) / BQ;
  t.softcap = a.softcap;
  t.scale = a.scale;
  t.scale_log2 = a.scale * LOG2E;
  t.cap_in = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
  t.cap_out = a.softcap * LOG2E;

  // (a) delta and lse·log2(e)
  const int warps = BWD_THREADS / 32;
  flash_bwd_prep_kernel<<<(unsigned)((rows + warps - 1) / warps), BWD_THREADS,
                          0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dO), a.lse, lse2, delta, a.B, a.S,
      a.Hq, D, t.S_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (b) dK/dV, 64-row Q/dO tiles against BKV-row K/V blocks
  CUtensorMap tq, tdo, tk, tv;
  int e = encode_bshd(&tq, a.q, a.B, a.S, a.Hq, D, BWD_ROWS);
  if (!e) e = encode_bshd(&tdo, a.dO, a.B, a.S, a.Hq, D, BWD_ROWS);
  if (!e) e = encode_bshd(&tk, a.k, a.B, a.Skv, a.Hkv, D, C::BKV);
  if (!e) e = encode_bshd(&tv, a.v, a.B, a.Skv, a.Hkv, D, C::BKV);
  if (e) return e;
  auto kkv = flash_bwd_dkdv_wgmma_kernel<D>;
  err = set_smem(kkv, C::KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  kkv<<<(unsigned)(t.n_kb * a.B * a.Hq), TC_THREADS, C::KV_SMEM, stream>>>(
      tq, tdo, tk, tv, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (c) dQ, 128-row Q/dO blocks against BKT-row K/V tiles
  e = encode_bshd(&tq, a.q, a.B, a.S, a.Hq, D, BQ);
  if (!e) e = encode_bshd(&tdo, a.dO, a.B, a.S, a.Hq, D, BQ);
  if (!e) e = encode_bshd(&tk, a.k, a.B, a.Skv, a.Hkv, D, C::BKT);
  if (!e) e = encode_bshd(&tv, a.v, a.B, a.Skv, a.Hkv, D, C::BKT);
  if (e) return e;
  auto kq = flash_bwd_dq_wgmma_kernel<D>;
  err = set_smem(kq, C::Q_SMEM);
  if (err != cudaSuccess) return (int)err;
  kq<<<(unsigned)(t.n_qb * a.B * a.Hq * t.dq_split), TC_THREADS, C::Q_SMEM,
       stream>>>(tq, tdo, tk, tv, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (d) the sums: dK and dV over the G query heads, dQ over its splits
  SumJobs jobs;
  jobs.count = 0;
  auto add = [&](const float* src, __nv_bfloat16* dst, long long n_out,
                 long long outer, long long step, int n) {
    SumJob& j = jobs.job[jobs.count++];
    j.src = src; j.dst = dst; j.n4 = n_out / 4;
    j.outer = outer; j.step = step; j.n = n;
    j.blocks = (int)((j.n4 + BWD_THREADS - 1) / BWD_THREADS);
  };
  const long long kv_out = (long long)a.B * a.Skv * a.Hkv * D;
  const long long q_out = (long long)a.B * a.S * a.Hq * D;
  const int G = a.Hq / a.Hkv;
  if (t.part != nullptr) {
    add(t.part, t.dk, kv_out, (long long)G * D, D, G);
    add(t.part + kv_part, t.dv, kv_out, (long long)G * D, D, G);
  }
  if (t.dq_part != nullptr) add(t.dq_part, t.dq, q_out, D, q_out, t.dq_split);
  if (jobs.count == 0) return 0;
  long long blocks = 0;
  for (int j = 0; j < jobs.count; ++j) blocks += jobs.job[j].blocks;
  flash_bwd_sum_kernel<<<(unsigned)blocks, BWD_THREADS, 0, stream>>>(jobs, D);
  return (int)cudaGetLastError();
}

int bwd_bf16(int D, const BwdArgs& a, float* scratch, cudaStream_t stream) {
  switch (D) {
    case 32: return bwd_tc<32>(a, scratch, stream);
    case 64: return bwd_tc<64>(a, scratch, stream);
    case 112: return bwd_tc<112>(a, scratch, stream);
    case 128: return bwd_tc<128>(a, scratch, stream);
    case 256: return bwd_tc<256>(a, scratch, stream);
    default: return ERR_HEAD_DIM;
  }
}

}  // namespace

// q (B,S,Hq,D), k/v (B,Skv,Hkv,D) -> o (B,S,Hq,D) and, where `lse` is
// not null, each row's log-sum-exp into lse (B,Hq,S) f32 (the training
// forward; serving passes null); Skv != S only without a causal mask or a
// window (the wrapper checks). Returns 0, a cudaError_t code, or a negative
// code of this file (an unsupported head dim, no tensor-map encoder, a
// refused tensor map).
extern "C" int k5_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int S, int Skv, int Hq, int Hkv,
                                      int D, int is_bf16, int causal,
                                      int window, float softcap, int kv_len,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return launch_bf16(D, q, k, v, o, l, B, S, Skv, Hq, Hkv, causal, window,
                       softcap, kv_len, scale, st);
  return launch_d<float>(D, q, k, v, o, l, B, S, Skv, Hq, Hkv, causal, window,
                         softcap, kv_len, scale, st);
}

// The f32 scratch k5_flash_attention_bwd takes, in floats: delta (B,Hq,S)
// for f32; for bf16 delta and lse·log2(e) at rows padded to 128, and with
// Hq != Hkv the f32 partials of dk and dv a query head (B,Skv,Hq,D) each.
extern "C" long long k5_flash_attention_bwd_scratch(int B, int S, int Skv,
                                                    int Hq, int Hkv, int D,
                                                    int is_bf16) {
  return is_bf16 ? bwd_tc_scratch(B, S, Skv, Hq, Hkv, D)
                 : (long long)B * Hq * S;
}

// K5-bwd: the gradients of k5_flash_attention_fwd's output, from q, k, v,
// o, the forward's lse and dO (all contiguous, o and dO (B,S,Hq,D) in q's
// dtype) into dq (B,S,Hq,D) and dk, dv (B,Skv,Hkv,D) in that dtype, with
// `scratch` (k5_flash_attention_bwd_scratch floats, 16-byte aligned).
// Launches on `stream`: f32 delta, dk/dv, dq (FFMA); bf16 prep, dk/dv, the
// GQA sum where Hq != Hkv, dq (wgmma). Returns 0, a cudaError_t code or a
// negative code of this file.
extern "C" int k5_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dO,
                                      void* scratch, void* dq, void* dk,
                                      void* dv, int B, int S, int Skv, int Hq,
                                      int Hkv, int D, int is_bf16, int causal,
                                      int window, float softcap, int kv_len,
                                      float scale, void* stream) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dO = dO;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(scratch);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.S = S; a.Skv = Skv; a.Hq = Hq; a.Hkv = Hkv;
  a.causal = causal; a.window = window; a.kv_len = kv_len;
  a.softcap = softcap; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_bf16(D, a, static_cast<float*>(scratch), st)
                 : bwd_d<float>(D, a, st);
}

// Fault injection for the tests: the bf16 launches that follow ask for
// `bytes` of dynamic shared memory instead of their own size (0 restores
// it). A size the card cannot give makes k5_flash_attention_fwd return the
// attribute call's error without launching.
extern "C" void k5_request_smem(int bytes) { g_smem_request = bytes; }

extern "C" const char* k5_error_string(int err) {
  switch (err) {
    case ERR_HEAD_DIM: return "unsupported head dim";
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found in the driver";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused the tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
