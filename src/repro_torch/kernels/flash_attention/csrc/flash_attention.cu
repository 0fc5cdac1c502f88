// Blockwise causal flash attention, forward only — Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// (flash_attention_pallas). Same function: q (B,S,Hq,D) against k/v
// (B,S,Hkv,D), GQA head h -> kv head h / (Hq/Hkv), scale 1/sqrt(D), optional
// tanh softcap, causal and sliding-window masks, keys at or past `kv_len`
// (the reference's seq_len) masked, online softmax with f32 (m, l, acc),
// masked scores at -1e30 exactly as the reference. Unlike the Pallas kernel
// (which asserts S % block == 0) it masks ragged edges itself: any S >= 1.
//
// What bounds it on the H100: at prefill lengths (S >= ~300 per head) the
// useful operations, 4*S^2*D*Hq/2 for causal, outweigh the bytes (q, k, v, o
// each once), so it is operation-bound; short prompts are bound by launch
// and memory latency. What the design does about the bound:
// * bf16 (the serving path) runs on the tensor cores with warp-level
//   mma.sync m16n8k16 (bf16 in, f32 accumulate): a CTA of 4 warps owns 64
//   query rows of one head, each warp 16 rows whose Q fragments, running
//   (m, l) and O accumulator stay in registers (FlashAttention-2 layout: the
//   S accumulator is re-packed in registers as the A operand of P·V, P in
//   bf16 as the reference's XLA path casts p to v's dtype). K/V tiles stream
//   through shared memory, rows padded by 16 bytes so the fragment loads
//   (32-bit for K, ldmatrix.trans for V) are bank-conflict free.
// * f32 runs an exact FFMA kernel (bounded by the 67 TFLOP/s f32 rate): one
//   (query block, head) per CTA, D/32 dims per thread with D/32 threads per
//   query row finishing each dot product with xor-shuffles.
// Both load a K/V tile once per query block and skip tiles outside the
// causal/window band. wgmma/TMA and a producer warp come later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;           // keys per shared-memory tile
constexpr float NEG = -1e30f;    // the reference's NEG_INF

// ---- 16-byte vector loads/stores with f32 conversion ----------------------
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
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
__device__ __forceinline__ uint32_t pack(const float* in, __nv_bfloat16) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(in[0]));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(in[1]));
  return lo | (hi << 16);
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
// grid (ceil(S/BQ), Hq, B); THREADS threads; TPR = D/32 threads per query
// row, BQ = THREADS/TPR rows per CTA. Thread `part` of a row owns the dims
// (c*TPR + part)*VN + [0, VN) for c in [0, 32/VN): neighbouring threads read
// neighbouring 16-byte chunks of a shared K/V row (no bank conflicts), and a
// row's dot product is finished with log2(TPR) xor-shuffles.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int Hq, int Hkv, int causal, int window,
                 float softcap, int kv_len, float scale) {
  constexpr int TPR = D / 32;
  constexpr int BQ = THREADS / TPR;
  constexpr int VN = Vec<T>::N;
  constexpr int NV = 32 / VN;          // 16-byte vectors per thread per row
  constexpr int VPR = D / VN;          // 16-byte vectors per K/V row

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

  float qr[32];
  float acc[32];
  if (qpos < S) {
    const T* qp = q + ((size_t)(b * S + qpos) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) load16(qp + (c * TPR + part) * VN, qr + c * VN);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
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
      if (kp < S) {
        const size_t off = ((size_t)(b * S + kp) * Hkv + hk) * D + c * VN;
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
    for (int i = 0; i < 32; ++i) acc[i] *= corr;
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
    for (int i = 0; i < 32; ++i) acc[i] *= inv;
    T* op = o + ((size_t)(b * S + qpos) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) store16(op + (c * TPR + part) * VN, acc + c * VN);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int causal, int window, float softcap, int kv_len,
           float scale, cudaStream_t stream) {
  constexpr int BQ = THREADS / (D / 32);
  const int smem = 2 * BK * D * (int)sizeof(T);
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, causal,
      window, softcap, kv_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int S, int Hq, int Hkv, int causal, int window,
             float softcap, int kv_len, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64, T>(q, k, v, o, B, S, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 128: return launch<128, T>(q, k, v, o, B, S, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 256: return launch<256, T>(q, k, v, o, B, S, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    default: return -1;
  }
}

// ---- tensor-core path (bf16) -----------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 b16 matrices, transposed on the way in (V tile -> B fragments)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = 16 * MMA_WARPS;   // query rows per CTA

template <int D> struct MmaTile {
  static constexpr int BK = D == 256 ? 32 : 64;   // keys per tile
  static constexpr int STR = D + 8;               // padded smem row
};

// grid (ceil(S/64), Hq, B); 128 threads. Lane l of warp w holds query rows
// r0 = q0 + 16w + l/4 and r1 = r0 + 8, and columns 2*(l%4) + {0,1} of every
// 8-wide accumulator tile (the mma.sync C layout).
template <int D>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
                     int causal, int window, float softcap, int kv_len,
                     float scale) {
  constexpr int BKM = MmaTile<D>::BK;
  constexpr int STR = MmaTile<D>::STR;
  constexpr int KS = D / 16;          // k-steps of Q.K^T over the head dim
  constexpr int NT = BKM / 8;         // 8-key tiles of S per warp
  constexpr int DT = D / 8;           // 8-dim tiles of O per warp
  constexpr int VPR = D / 8;          // 16-byte vectors per K/V row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BKM * STR;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * MMA_BQ;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as A fragments: {Q[r0][c..c+1], Q[r1][c..], Q[r0][c+8..], Q[r1][c+8..]}
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* q0p = q + ((size_t)(b * S + r0) * Hq + h) * D;
    const __nv_bfloat16* q1p = q + ((size_t)(b * S + r1) * Hq + h) * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * t;
      qa[ks][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(q0p + c) : 0u;
      qa[ks][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(q1p + c) : 0u;
      qa[ks][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(q0p + c + 8) : 0u;
      qa[ks][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(q1p + c + 8) : 0u;
    }
  }
  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};

  const int q_hi = min(q0 + MMA_BQ - 1, S - 1);
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);

  for (int k0 = (k_begin / BKM) * BKM; k0 < k_end; k0 += BKM) {
    __syncthreads();                   // the previous tile is consumed
    for (int idx = tid; idx < BKM * VPR; idx += 32 * MMA_WARPS) {
      const int j = idx / VPR;
      const int c = idx % VPR;
      const int kp = k0 + j;
      uint4 kk = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (kp < S) {
        const size_t off = ((size_t)(b * S + kp) * Hkv + hk) * D + c * 8;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + j * STR + c * 8) = kk;
      *reinterpret_cast<uint4*>(sV + j * STR + c * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BKM keys
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = sK + (nt * 8 + g) * STR + ks * 16 + 2 * t;
        const uint32_t kb[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                *reinterpret_cast<const uint32_t*>(kp + 8)};
        mma_bf16(sacc[nt], qa[ks], kb);
      }
    }

    // scale, softcap, mask; row maxima over the quad that shares a row
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = sacc[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = col < kv_len;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && (row - col) < window;
        x = ok ? x : NEG;
        sacc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      oacc[i][0] *= corr[0];
      oacc[i][1] *= corr[0];
      oacc[i][2] *= corr[1];
      oacc[i][3] *= corr[1];
    }

    // P (bf16) re-packed in registers as the A operand of P.V
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(sacc[nt][0] - m[0]);
      const float p1 = expf(sacc[nt][1] - m[0]);
      const float p2 = expf(sacc[nt][2] - m[1]);
      const float p3 = expf(sacc[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V tile rows are keys, ldmatrix.trans yields B fragments
    const int mi = lane >> 3;
    const int ri = lane & 7;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, sV + (kk * 16 + (mi & 1) * 8 + ri) * STR + (dt + (mi >> 1)) * 8);
        mma_bf16(oacc[dt], pa[kk], vb);
        mma_bf16(oacc[dt + 1], pa[kk], vb + 2);
      }
    }
  }

  // the quad's partial row sums -> full row sums; normalize and store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* o0 = o + ((size_t)(b * S + r0) * Hq + h) * D;
  __nv_bfloat16* o1 = o + ((size_t)(b * S + r1) * Hq + h) * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_bf16(oacc[dt][0] * l[0], oacc[dt][1] * l[0]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_bf16(oacc[dt][2] * l[1], oacc[dt][3] * l[1]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Hq, int Hkv, int causal, int window, float softcap,
               int kv_len, float scale, cudaStream_t stream) {
  const int smem = 2 * MmaTile<D>::BK * MmaTile<D>::STR *
                   (int)sizeof(__nv_bfloat16);
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + MMA_BQ - 1) / MMA_BQ, Hq, B);
  kern<<<grid, 32 * MMA_WARPS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Hq, Hkv, causal, window, softcap, kv_len, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(int D, const void* q, const void* k, const void* v, void* o,
                int B, int S, int Hq, int Hkv, int causal, int window,
                float softcap, int kv_len, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_mma<64>(q, k, v, o, B, S, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 128: return launch_mma<128>(q, k, v, o, B, S, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    case 256: return launch_mma<256>(q, k, v, o, B, S, Hq, Hkv, causal, window, softcap, kv_len, scale, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t code, or -1 for an unsupported head dim.
extern "C" int k5_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int D, int is_bf16,
                                      int causal, int window, float softcap,
                                      int kv_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(D, q, k, v, o, B, S, Hq, Hkv, causal, window, softcap,
                       kv_len, scale, st);
  return launch_d<float>(D, q, k, v, o, B, S, Hq, Hkv, causal, window,
                         softcap, kv_len, scale, st);
}

extern "C" const char* k5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
