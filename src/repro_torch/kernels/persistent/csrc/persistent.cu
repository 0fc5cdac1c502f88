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
// What bounds it on the H100: for matmul rows, operations. A 128^3 tile
// product is 4.2 MFLOP of f32 work kept exact (FFMA, never TF32: results are
// held to 1e-4 against f32 math), so the card's floor is the f32 rate
// (67 TFLOP/s over 132 SMs). The rows of one cluster are sequential by
// definition (row i + 1 reads row i's writes), so one CTA per cluster caps
// a C = 1 launch at one SM's share, ~8.3 us per tile product; C = 132
// clusters fill the card. The workspace (512 KiB per cluster at nbuf = 8)
// exceeds shared memory, so it stays in global memory (L2 holds most of
// it) and each product stages 32-wide k-blocks of its operands in shared
// memory; each thread keeps an 8x8 block of the product in registers until
// both operands are fully read, so dst may alias a or b. Elementwise rows
// are safe in place: a thread reads element e of its inputs before it
// writes element e of dst. __syncthreads() ends every row, so row i + 1
// sees row i's global writes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
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
constexpr int NT = 256;             // threads per CTA: 16 x 16, 8x8 outputs each
constexpr int KB = 32;              // k-block of a tile product
constexpr int LDA = TILE + 1;       // padded row of the transposed A block
constexpr int NWARP = NT / 32;

struct Smem {
  float a[KB * LDA];                // A[:, k0:k0+KB] transposed: a[k][m]
  alignas(16) float b[KB * TILE];   // B[k0:k0+KB, :]
  float red[NWARP];
};

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

// Sum of v over the CTA; the total is valid on thread 0 only. Callers end
// the row with __syncthreads() before the next call reuses red.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < NWARP ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

// acc[i][j] = sum_k A[ty + 16 i][k] * B[k][tx + 16 j] in f32 FFMA, k in
// order. Ends with __syncthreads(): every read of A and B is done.
__device__ void tile_product(const float* A, const float* B,
                             float (&acc)[8][8], Smem& sm) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < TILE; k0 += KB) {
#pragma unroll
    for (int r = 0; r < KB * TILE / 4 / NT; ++r) {
      const int f = threadIdx.x + NT * r;        // float4 of the A block
      const int m = f / (KB / 4), kq = (f % (KB / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(A + m * TILE + k0 + kq);
      sm.a[(kq + 0) * LDA + m] = v.x;
      sm.a[(kq + 1) * LDA + m] = v.y;
      sm.a[(kq + 2) * LDA + m] = v.z;
      sm.a[(kq + 3) * LDA + m] = v.w;
      const int kk = f / (TILE / 4), nq = (f % (TILE / 4)) * 4;
      *reinterpret_cast<float4*>(sm.b + kk * TILE + nq) =
          *reinterpret_cast<const float4*>(B + (k0 + kk) * TILE + nq);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = sm.a[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sm.b[kk * TILE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Run one tile op (op already clipped, indices already in range) on one
// cluster's workspace. Returns the sum of the tile written — or, for
// REDUCE, sum(ws[a]) — valid on thread 0 only. Every thread calls it with
// the same arguments (the row's branch is uniform over the CTA).
__device__ float tile_op(int op, float* ws, int dst, int a, int arg1,
                         int nbuf, Smem& sm) {
  float part = 0.f;
  if (op == OP_MATMUL) {
    float acc[8][8];
    tile_product(ws + (size_t)a * TT, ws + (size_t)tile_index(arg1, nbuf) * TT,
                 acc, sm);
    float* D = ws + (size_t)dst * TT;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = (ty + 16 * i) * TILE + tx + 16 * j;
        const float v = D[e] + acc[i][j];
        D[e] = v;
        part += v;
      }
  } else {
    const float4* A4 = reinterpret_cast<const float4*>(ws + (size_t)a * TT);
    const float4* B4 = reinterpret_cast<const float4*>(
        ws + (size_t)tile_index(arg1, nbuf) * TT);
    float4* D4 = reinterpret_cast<float4*>(ws + (size_t)dst * TT);
    const float scale = __int2float_rn(arg1) * (1.0f / (1 << SCALE_SHIFT));
    for (int f = threadIdx.x; f < TT / 4; f += NT) {
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
  }
  return block_sum(part, sm.red);
}

template <bool PROFILE>
__global__ void __launch_bounds__(NT)
drain_kernel(const int* ctrl, const int* queue, float* ws, float* carry,
             int* tick, int* acks, float* results, int* ctrl_out, int* prof,
             int Q, int nbuf) {
  __shared__ Smem sm;
  const int c = blockIdx.x;
  const int* cc = ctrl + c * QCTRL_WIDTH;
  const int head = cc[QC_HEAD], tail = cc[QC_TAIL], stop = cc[QC_STOP];
  float* wsc = ws + (size_t)c * nbuf * TT;
  float carry_c = carry[c];           // threads other than 0 never use it
  int tick_c = PROFILE ? tick[c] : 0;
  int drained = 0;
  for (int i = 0; i < Q; ++i) {
    const int* d = queue + ((size_t)c * Q + i) * DESC_WIDTH;
    const int status = d[W_STATUS], opcode = d[W_OPCODE], arg0 = d[W_ARG0];
    const bool active = i >= head && i < tail && stop == 0 &&
                        status >= THREAD_WORK;
    float res = 0.f;
    if (active) {
      const int op = min(max(opcode, 0), NUM_DRAIN_OPS - 1);
      if (op != 0) {
        const float s = tile_op(op, wsc, tile_index(arg0 >> 8, nbuf),
                                tile_index(arg0 & 255, nbuf), d[W_ARG1], nbuf,
                                sm);
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
      const int chunk = d[W_CHUNK], n_chunks = d[W_NCHUNKS];
      const bool done = wrap_add(chunk, 1) >= max(n_chunks, 1);
      int* ack = acks + row * DESC_WIDTH;
      for (int w = 0; w < DESC_WIDTH; ++w) ack[w] = 0;
      ack[W_STATUS] = active ? (done ? THREAD_FINISHED : THREAD_PREEMPTED)
                             : THREAD_NOP;
      ack[W_REQID] = d[W_REQID];
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
          p[P_OPCODE] = opcode;
          p[P_REQID] = d[W_REQID];
          p[P_ACTIVE] = 1;
        }
      }
    }
    if (active) {
      ++drained;
      if (PROFILE) tick_c = wrap_add(tick_c, 1);
    }
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

__global__ void __launch_bounds__(NT)
execute_kernel(const int* queue, float* ws, int* fromgpu, int Q, int nbuf) {
  __shared__ Smem sm;
  const int c = blockIdx.x;
  float* wsc = ws + (size_t)c * nbuf * TT;
  int done = 0;
  for (int i = 0; i < Q; ++i) {
    const int* d = queue + ((size_t)c * Q + i) * DESC_WIDTH;
    if (d[W_STATUS] < THREAD_WORK) continue;       // uniform over the CTA
    ++done;
    const int op = min(max(d[W_OPCODE], 0), NUM_OPS - 1);
    if (op != 0) {
      const int arg0 = d[W_ARG0];
      tile_op(op, wsc, tile_index(arg0 >> 8, nbuf),
              tile_index(arg0 & 255, nbuf), d[W_ARG1], nbuf, sm);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int* fg = fromgpu + (size_t)c * DESC_WIDTH;
    for (int w = 0; w < DESC_WIDTH; ++w) fg[w] = 0;
    fg[W_STATUS] = THREAD_FINISHED;
    fg[W_ARG0] = done;
  }
}

}  // namespace

// K1 (profile = 0) and K2 (profile = 1): one drain launch of C clusters.
// ctrl (C, QCTRL_WIDTH) i32, queue (C, Q, DESC_WIDTH) i32, ws
// (C, nbuf, 128, 128) f32, carry (C, 1) f32, tick (C, 1) i32 (K2 only; ws,
// carry and tick updated in place); out: acks (C, Q, DESC_WIDTH) i32,
// results (C, Q) f32, ctrl_out (C, QCTRL_WIDTH) i32, prof
// (C, Q, PROF_WIDTH) i32 (K2 only). Returns the launch's cudaError_t.
extern "C" int persistent_drain(const void* ctrl, const void* queue, void* ws,
                                void* carry, void* tick, void* acks,
                                void* results, void* ctrl_out, void* prof,
                                int C, int Q, int nbuf, int profile,
                                void* stream) {
  if (C < 1) return 0;
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
    drain_kernel<true><<<C, NT, 0, st>>>(ct, qu, w, ca, ti, ac, re, co, pr, Q,
                                         nbuf);
  else
    drain_kernel<false><<<C, NT, 0, st>>>(ct, qu, w, ca, ti, ac, re, co, pr, Q,
                                          nbuf);
  return static_cast<int>(cudaGetLastError());
}

// K3: queue (C, Q, DESC_WIDTH) i32, ws (C, nbuf, 128, 128) f32 (in place)
// -> fromgpu (C, DESC_WIDTH) i32. Returns the launch's cudaError_t.
extern "C" int persistent_execute(const void* queue, void* ws, void* fromgpu,
                                  int C, int Q, int nbuf, void* stream) {
  if (C < 1) return 0;
  execute_kernel<<<C, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(queue), static_cast<float*>(ws),
      static_cast<int*>(fromgpu), Q, nbuf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* persistent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
