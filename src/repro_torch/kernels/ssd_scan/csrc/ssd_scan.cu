// Mamba2 SSD chunk kernel (intra-chunk output + chunk-end states) — Hopper
// (sm_90a), CUDA C++, f32 FFMA.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::_ssd_chunk_kernel
// (ssd_chunk_pallas). Same function, for every (batch b, chunk c, head h):
//   y[i,h,p] = sum_{j<=i} (C_i . B_j) * exp(cum[i,h] - cum[j,h]) * dt[j,h]
//                         * x[j,h,p]
//   S[h,p,n] = sum_l x[l,h,p] * (dt[l,h] * exp(cum[L-1,h] - cum[l,h]))
//                         * B[l,n]
// Inputs are f32: x (B,C,L,H,P), dt and cum (B,C,L,H), Bm and Cm (B,C,L,N);
// outputs y_intra (B,C,L,H,P) and states (B,C,H,P,N). Any L >= 1 (the serve
// path's chunks are the prompt itself, 4..23 rows), any H, any N, P <= 64:
// ragged rows, heads, columns and states are masked here, not padded by the
// caller. The inter-chunk recurrence stays in PyTorch (ops.py), as the
// reference keeps it in JAX.
//
// What bounds it on the H100: at L = 256, N = 128, P = 64 the work is
// 2 * [L(L+1)/2 * (N + H*P) + H*L*P*N] operations per (b, c) against
// (2*L*H*P + 4*L*H + 2*L*N + H*P*N) * 4 bytes: ~50 operations a byte,
// above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// operation-bound at the f32 rate (no TF32: the contract with the plain
// version is 1e-4). At the serve shape (C = 1, L = 17) it is
// byte-bound (the 1.5 MB of states) and, in practice, launch-latency bound.
// What the design does about it:
// * The Pallas kernel holds one head block's whole (L, L, Hb) decay tensor
//   in VMEM; one head's (L, L) f32 weights alone are 256 KB at L = 256, more
//   than an SM's shared memory. Here the output is tiled as flash attention
//   is, without the softmax: a CTA owns BR = 32 rows of one (b, c) for HB
//   heads and walks the causal column blocks (BJ = 64) up to its last row.
//   Per column block it forms G = C_i B_j^T (32 x 64, over N in NK-wide
//   slices) once for its heads, then per head weights G by the decay and dt
//   (masking j > i and the ragged edge), stages the weights and x_j in
//   shared memory and accumulates y_i += W x_j in registers. The next
//   head's x_j is loaded into registers while this head accumulates.
// * G does not depend on the head: with HB = 8 it is N / (8 P) = 25% of
//   the y work at the mamba2 shape (the TPU kernel's 4-head blocks: 50%).
//   Where 8-head CTAs would not give every SM one (a short chunk: the
//   serve path's prompts are 4..23 rows), HB = 1 instead, so the heads run
//   in parallel and the small G is recomputed per head.
// * The diagonal column block and a ragged chunk stop at the last column
//   they need, so a 17-row chunk runs 17 columns, not 64.
// * The chunk-end states are a second kernel: per (b, c, h, 64 states) a
//   (P x L)(L x N) product over L in 32-row slices, x weighted by
//   dt * exp(cum_end - cum) as it is staged.
// * Shared tiles are transposed where a thread reads along the other
//   dimension, so each inner-loop read is one float2/float4 per operand;
//   every tile fits in 48 KB of static shared memory.
// exp(cum_i - cum_j) is evaluated only for j <= i, where it is <= 1 (cum is
// a cumulative sum of dt * A <= 0), so masked entries never make inf * 0.
// cp.async/TMA double buffering and 3xTF32 on the tensor cores come later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BR = 32;        // rows i of y per CTA
constexpr int BJ = 64;        // columns j per step
constexpr int NK = 32;        // state columns n per G slice
constexpr int PMAX = 64;      // head dim a CTA covers (16 threads x 4)
constexpr int LT = 32;        // rows l per state-kernel slice
constexpr int NT = 64;        // state columns per state-kernel CTA
constexpr int CT_PITCH = BR + 2;   // float2 reads, 2-way store conflicts
constexpr int BT_PITCH = BJ + 4;   // float4 reads
constexpr int WT_PITCH = BR + 2;

// y_intra: grid (B*C*nrb, ceil(H/HB)); CTA = (b, c, row block, head group).
template <int HB>
__global__ void __launch_bounds__(THREADS)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y, int L,
                 int H, int P, int N, int nrb) {
  constexpr int XPT = BJ * PMAX / THREADS;   // x_j values a thread stages
  __shared__ __align__(16) float Ct[NK][CT_PITCH];   // C_i^T slice
  __shared__ __align__(16) float Bt[NK][BT_PITCH];   // B_j^T slice
  __shared__ __align__(16) float Wt[BJ][WT_PITCH];   // W^T of one head
  __shared__ __align__(16) float xs[BJ][PMAX];       // x_j of one head
  __shared__ float cum_i[HB][BR];
  __shared__ float cum_j[HB][BJ];
  __shared__ float dt_j[HB][BJ];

  const int tid = threadIdx.x;
  const int ty = tid / 16;     // rows ty*2 .. ty*2+1 of the CTA's 32
  const int tx = tid % 16;     // columns (or p) tx*4 .. tx*4+3
  // heaviest row blocks (most causal columns) first
  const int rb = nrb - 1 - (int)(blockIdx.x % nrb);
  const long long bc = blockIdx.x / nrb;
  const int h0 = blockIdx.y * HB;
  const int r0 = rb * BR;
  const long long row0 = bc * L;          // first (b, c, l) row of the chunk

  for (int e = tid; e < HB * BR; e += THREADS) {
    const int hh = e / BR, i = e % BR;
    const int h = h0 + hh, gi = r0 + i;
    cum_i[hh][i] = (h < H && gi < L) ? cum[(row0 + gi) * H + h] : 0.f;
  }

  float acc[HB][2][4];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[hh][a][b] = 0.f;

  // x_j rows of head h into registers (row tid/PMAX + k*THREADS/PMAX,
  // channel tid%PMAX): issued a head ahead, so the loads are in flight
  // while the previous head accumulates
  float xr[XPT];
  auto load_x = [&](int j0, int jn, int h) {
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int e = tid + k * THREADS, j = e / PMAX, p = e % PMAX;
      xr[k] = (j < jn && p < P) ? x[((row0 + j0 + j) * H + h) * P + p] : 0.f;
    }
  };

  const int last_i = min(r0 + BR, L) - 1;
  const int n_jb = last_i / BJ + 1;
  for (int jb = 0; jb < n_jb; ++jb) {
    const int j0 = jb * BJ;
    // columns this block needs: inside the chunk and at or before the
    // CTA's last row (the diagonal block stops there)
    const int jn = min(BJ, min(L, r0 + BR) - j0);
    // ---- G = C_i B_j^T over N, once for the CTA's heads ----
    float g[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) g[a][b] = 0.f;
    for (int n0 = 0; n0 < N; n0 += NK) {
      for (int e = tid; e < BR * NK; e += THREADS) {
        const int i = e / NK, n = e % NK;
        const int gi = r0 + i, gn = n0 + n;
        Ct[n][i] = (gi < L && gn < N) ? Cm[(row0 + gi) * N + gn] : 0.f;
      }
      for (int e = tid; e < BJ * NK; e += THREADS) {
        const int j = e / NK, n = e % NK;
        const int gn = n0 + n;
        Bt[n][j] = (j < jn && gn < N) ? Bm[(row0 + j0 + j) * N + gn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < NK; ++n) {
        const float2 c2 = *reinterpret_cast<const float2*>(&Ct[n][ty * 2]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bt[n][tx * 4]);
        const float cv[2] = {c2.x, c2.y};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) g[a][b] = fmaf(cv[a], bv[b], g[a][b]);
      }
      __syncthreads();
    }
    for (int e = tid; e < HB * BJ; e += THREADS) {
      const int hh = e / BJ, j = e % BJ;
      const int h = h0 + hh;
      const bool ok = h < H && j < jn;
      cum_j[hh][j] = ok ? cum[(row0 + j0 + j) * H + h] : 0.f;
      dt_j[hh][j] = ok ? dt[(row0 + j0 + j) * H + h] : 0.f;
    }
    load_x(j0, jn, h0);
    __syncthreads();
    // ---- per head: W = G * decay * dt (causal, ragged edge masked),
    //      y_i += W x_j ----
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const int h = h0 + hh;
      if (h >= H) break;                      // uniform across the CTA
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = ty * 2 + a, gi = r0 + i;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = tx * 4 + b, gj = j0 + j;
          float w = 0.f;
          if (gj <= gi && gi < L)             // gj <= gi < L: gj < L too
            w = g[a][b] * expf(cum_i[hh][i] - cum_j[hh][j]) * dt_j[hh][j];
          Wt[j][i] = w;
        }
      }
#pragma unroll
      for (int k = 0; k < XPT; ++k) {
        const int e = tid + k * THREADS;
        xs[e / PMAX][e % PMAX] = xr[k];
      }
      __syncthreads();
      if (hh + 1 < HB && h + 1 < H) load_x(j0, jn, h + 1);
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const float2 w2 = *reinterpret_cast<const float2*>(&Wt[j][ty * 2]);
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[j][tx * 4]);
        const float wv[2] = {w2.x, w2.y};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[hh][a][b] = fmaf(wv[a], xv[b], acc[hh][a][b]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int gi = r0 + ty * 2 + a;
      if (gi >= L) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx * 4 + b;
        if (p < P) y[((row0 + gi) * H + h) * P + p] = acc[hh][a][b];
      }
    }
  }
}

// chunk-end states: grid (B*C*H, ceil(N/NT)); CTA = (b, c, h, 64 states).
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bm,
                 float* __restrict__ states, int L, int H, int P, int N) {
  __shared__ __align__(16) float xw[LT][PMAX];   // x * dt * exp(end - cum)
  __shared__ __align__(16) float Bs[LT][NT];
  __shared__ float wl[LT];

  const int tid = threadIdx.x;
  const int tp = tid / 16;     // p rows tp*4 .. tp*4+3
  const int tn = tid % 16;     // state columns tn*4 .. tn*4+3 of the tile
  const int h = (int)(blockIdx.x % H);
  const long long bc = blockIdx.x / H;
  const int n0 = blockIdx.y * NT;
  const long long row0 = bc * L;
  const float cum_end = cum[(row0 + L - 1) * H + h];

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int l0 = 0; l0 < L; l0 += LT) {
    if (tid < LT) {
      const int gl = l0 + tid;
      wl[tid] = gl < L ? dt[(row0 + gl) * H + h] *
                             expf(cum_end - cum[(row0 + gl) * H + h])
                       : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < LT * PMAX; e += THREADS) {
      const int l = e / PMAX, p = e % PMAX;
      const int gl = l0 + l;
      xw[l][p] = (gl < L && p < P)
                     ? x[((row0 + gl) * H + h) * P + p] * wl[l] : 0.f;
    }
    for (int e = tid; e < LT * NT; e += THREADS) {
      const int l = e / NT, n = e % NT;
      const int gl = l0 + l, gn = n0 + n;
      Bs[l][n] = (gl < L && gn < N) ? Bm[(row0 + gl) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < LT; ++l) {
      const float4 x4 = *reinterpret_cast<const float4*>(&xw[l][tp * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[l][tn * 4]);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* out = states + (bc * H + h) * (long long)P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = tp * 4 + a;
    if (p >= P) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tn * 4 + b;
      if (n < N) out[(long long)p * N + n] = acc[a][b];
    }
  }
}

}  // namespace

// Returns 0 or a cudaError_t; -1 for a shape the kernels do not take.
extern "C" int k6_ssd_chunk_fwd(const void* x, const void* dt, const void* cum,
                                const void* Bm, const void* Cm, void* y,
                                void* states, int Bsz, int C, int L, int H,
                                int P, int N, void* stream) {
  if (Bsz < 1 || C < 1 || L < 1 || H < 1 || N < 1 || P < 1 || P > PMAX)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nrb = (L + BR - 1) / BR;
  const long long bc = (long long)Bsz * C;
  if (bc * nrb > 0x7fffffffLL || bc * H > 0x7fffffffLL) return -1;
  // 8 heads a CTA share G; where that leaves less than one CTA per SM (a
  // short chunk: the serve path's prompts), one head a CTA instead, so the
  // heads run in parallel and G (L x L x N, small at such L) is recomputed
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* cf = static_cast<const float*>(cum);
  const float* bf = static_cast<const float*>(Bm);
  const float* cmf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  if (bc * nrb * ((H + 7) / 8) >= sms) {
    dim3 g1((unsigned)(bc * nrb), (H + 7) / 8);
    ssd_intra_kernel<8><<<g1, THREADS, 0, st>>>(xf, dtf, cf, bf, cmf, yf, L,
                                                H, P, N, nrb);
  } else {
    dim3 g1((unsigned)(bc * nrb), H);
    ssd_intra_kernel<1><<<g1, THREADS, 0, st>>>(xf, dtf, cf, bf, cmf, yf, L,
                                                H, P, N, nrb);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((unsigned)(bc * H), (N + NT - 1) / NT);
  ssd_state_kernel<<<g2, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(Bm),
      static_cast<float*>(states), L, H, P, N);
  return (int)cudaGetLastError();
}

extern "C" const char* k6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
