// Flash-decoding: one query token per sequence against a KV cache —
// Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel
// (decode_attention_pallas). Same function: q (B,1,Hq,D) against caches
// (B,S,Hkv,D), GQA head h -> kv head h / G (G = Hq/Hkv), scale 1/sqrt(D),
// optional tanh softcap, positions >= valid_len[b] masked and, with a
// window, positions < valid_len[b] - window masked; online softmax in f32.
// The Pallas kernel asserts S % block_kv == 0; this one takes any S. It
// requires valid_len[b] >= 1 (the decode path always has the just-written
// token); valid_len above S is clamped to S.
//
// What bounds it on the H100: bytes. Each live cache row is used by G query
// heads for 4*D operations each — far below the ~295 operations per byte at
// which bf16 work turns operation-bound — so the least time is the live K/V
// bytes over 3.35 TB/s. What the design does about it: (1) one CTA per
// (split, kv head, sequence) serves ALL G query heads of that kv head (one
// warp each), so every K/V row is read from memory once, not G times;
// (2) rows at or past valid_len, or before the window, are never loaded;
// (3) the sequence is split across CTAs so that even B*Hkv = 32 fills the
// 132 SMs, each split writing an f32 partial (max, sumexp, acc) that a second
// small kernel merges exactly as repro's decode_attention_sharded merges its
// shards (models/attention.py, the pmax/psum merge).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;            // keys per shared-memory tile (2 per lane)
constexpr int MAX_G = 16;         // query heads per kv head (one warp each)

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// Load NE consecutive elements (NE*sizeof(T) in {4, 8, 16, 32} bytes,
// aligned to that size up to 16) and widen them to f32.
template <typename T, int NE>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int BYTES = NE * (int)sizeof(T);
  constexpr int EPW = 4 / (int)sizeof(T);
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      unpack(u.x, out + (4 * c + 0) * EPW, T());
      unpack(u.y, out + (4 * c + 1) * EPW, T());
      unpack(u.z, out + (4 * c + 2) * EPW, T());
      unpack(u.w, out + (4 * c + 3) * EPW, T());
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack(u.x, out, T());
    unpack(u.y, out + EPW, T());
  } else {
    static_assert(BYTES == 4, "unsupported vector width");
    unpack(*reinterpret_cast<const uint32_t*>(p), out, T());
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* p) { *p = __float2bfloat16_rn(x); }

// grid (n_split, Hkv, B); 32*G threads: warp g serves query head hk*G + g.
// Shared memory: sQ[G][D] f32 (pre-scaled q), sK[BK][D + pad] (the pad
// shifts each row by 16 bytes so 32 lanes reading 32 rows hit distinct
// banks), sV[BK][D], sP[G][BK] f32 probabilities.
template <int D, typename T>
__global__ void __launch_bounds__(32 * MAX_G)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ valid_len,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int S, int Hq, int Hkv,
                      int split_len, float softcap, int window, float scale) {
  constexpr int VN = 16 / (int)sizeof(T);     // elements per 16-byte vector
  constexpr int KSTRIDE = D + VN;             // padded sK row (elements)
  constexpr int VPR = D / VN;                 // 16-byte vectors per row
  constexpr int DL = D / 32;                  // dims per lane in PV

  const int G = Hq / Hkv;
  const int n_split = gridDim.x;
  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = hk * G + warp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sP = sQ + G * D;
  T* sK = reinterpret_cast<T*>(sP + G * BK);
  T* sV = sK + BK * KSTRIDE;

  for (int i = tid; i < G * D; i += nthreads) {
    const int g = i / D, d = i % D;
    sQ[i] = to_float(q[((size_t)b * Hq + hk * G + g) * D + d]) * scale;
  }

  const int valid = min(valid_len[b], S);
  const int lo = window > 0 ? max(0, valid - window) : 0;
  const int a = max(sp * split_len, lo);
  const int e = min(min(sp * split_len + split_len, S), valid);

  float m = -INFINITY;
  float l = 0.f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int t0 = a; t0 < e; t0 += BK) {
    __syncthreads();                  // sQ written / previous tile consumed
    for (int idx = tid; idx < BK * VPR; idx += nthreads) {
      const int j = idx / VPR;
      const int c = idx % VPR;
      const int kp = t0 + j;
      uint4 kk = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (kp < e) {
        const size_t off = (((size_t)b * S + kp) * Hkv + hk) * D + c * VN;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + j * KSTRIDE + c * VN) = kk;
      *reinterpret_cast<uint4*>(sV + j * D + c * VN) = vv;
    }
    __syncthreads();

    // scores of this lane's two keys (rows lane, lane + 32) against this
    // warp's head: one pass over the dims, each q chunk read once
    const float* qh = sQ + warp * D;
    const T* k0p = sK + lane * KSTRIDE;
    const T* k1p = sK + (lane + 32) * KSTRIDE;
    float dot0 = 0.f;
    float dot1 = 0.f;
#pragma unroll 2
    for (int c = 0; c < VPR; ++c) {
      float kf0[VN];
      float kf1[VN];
      load_vec<T, VN>(k0p + c * VN, kf0);
      load_vec<T, VN>(k1p + c * VN, kf1);
#pragma unroll
      for (int x = 0; x < VN; ++x) {
        const float qv = qh[c * VN + x];
        dot0 = fmaf(qv, kf0[x], dot0);
        dot1 = fmaf(qv, kf1[x], dot1);
      }
    }
    if (softcap > 0.f) {
      dot0 = tanhf(dot0 / softcap) * softcap;
      dot1 = tanhf(dot1 / softcap) * softcap;
    }
    const bool ok[2] = {t0 + lane < e, t0 + lane + 32 < e};
    const float s[2] = {ok[0] ? dot0 : -INFINITY, ok[1] ? dot1 : -INFINITY};
    float m_blk = fmaxf(s[0], s[1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, off));
    const float m_new = fmaxf(m, m_blk);          // finite: t0 < e
    const float corr = expf(m - m_new);           // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p = ok[r] ? expf(s[r] - m_new) : 0.f;
      sP[warp * BK + lane + 32 * r] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= corr;
    const int nk = min(BK, e - t0);
    for (int j = 0; j < nk; ++j) {
      const float p = sP[warp * BK + j];
      float vf[DL];
      load_vec<T, DL>(sV + j * D + lane * DL, vf);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
    m = m_new;
  }

  const size_t prow = ((size_t)b * Hq + h) * n_split + sp;
  if (lane == 0) {
    part_m[prow] = m;                 // -inf: the split held no live key
    part_l[prow] = l;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) part_acc[prow * D + lane * DL + i] = acc[i];
}

// grid (Hq, B); D threads. The shard merge of decode_attention_sharded:
// m = max over splits, corr = exp(m_split - m) (0 for empty splits),
// out = sum(corr * acc) / max(sum(corr * l), 1e-30).
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    T* __restrict__ out, int Hq, int D,
                                    int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * Hq + h) * n_split;
  float mg = -INFINITY;
  for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, part_m[base + s]);
  const float m_safe = isfinite(mg) ? mg : 0.f;
  float lsum = 0.f;
  float o = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = part_m[base + s];
    const float c = isfinite(ms) ? expf(ms - m_safe) : 0.f;
    lsum += c * part_l[base + s];
    o += c * part_acc[(base + s) * D + d];
  }
  from_float(o / fmaxf(lsum, 1e-30f), out + ((size_t)b * Hq + h) * D + d);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           float* part_m, float* part_l, float* part_acc, void* out, int B,
           int S, int Hq, int Hkv, int n_split, int split_len, float softcap,
           int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  constexpr int VN = 16 / (int)sizeof(T);
  const int smem = (G * D + G * BK) * (int)sizeof(float) +
                   BK * (D + VN) * (int)sizeof(T) + BK * D * (int)sizeof(T);
  auto kern = decode_partial_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(n_split, Hkv, B), 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, part_m, part_l, part_acc, S, Hq,
      Hkv, split_len, softcap, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T><<<dim3(Hq, B), D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), Hq, D, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* valid_len, float* pm, float* pl, float* pa, void* out,
             int B, int S, int Hq, int Hkv, int n_split, int split_len,
             float softcap, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64, T>(q, k, v, valid_len, pm, pl, pa, out, B, S, Hq, Hkv, n_split, split_len, softcap, window, scale, st);
    case 128: return launch<128, T>(q, k, v, valid_len, pm, pl, pa, out, B, S, Hq, Hkv, n_split, split_len, softcap, window, scale, st);
    case 256: return launch<256, T>(q, k, v, valid_len, pm, pl, pa, out, B, S, Hq, Hkv, n_split, split_len, softcap, window, scale, st);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t code, -1 for an unsupported head dim, or -2 for
// an unsupported group size (Hq/Hkv must be in [1, 16]).
extern "C" int k4_decode_attention(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* part_m, void* part_l, void* part_acc,
                                   void* out, int B, int S, int Hq, int Hkv,
                                   int D, int is_bf16, int n_split,
                                   int split_len, float softcap, int window,
                                   float scale, void* stream) {
  const int G = Hq / Hkv;
  if (G < 1 || G > MAX_G || G * Hkv != Hq) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, vl, pm, pl, pa, out, B, S, Hq,
                                   Hkv, n_split, split_len, softcap, window,
                                   scale, st);
  return launch_d<float>(D, q, k, v, vl, pm, pl, pa, out, B, S, Hq, Hkv,
                         n_split, split_len, softcap, window, scale, st);
}

extern "C" const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
