// Mamba2 SSD chunk kernel (intra-chunk output + chunk-end states) — Hopper
// (sm_90a), CUDA C++, 3xTF32 on the tensor cores (wgmma), one launch.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::_ssd_chunk_kernel
// (ssd_chunk_pallas). Same function, for every (batch b, chunk c, head h):
//   y[i,h,p] = sum_{j<=i} (C_i . B_j) * exp(cum[i,h] - cum[j,h]) * dt[j,h]
//                         * x[j,h,p]
//   S[h,p,n] = sum_l x[l,h,p] * (dt[l,h] * exp(cum[L-1,h] - cum[l,h]))
//                         * B[l,n]
// Inputs are f32: x (B,C,L,H,P), dt and cum (B,C,L,H), Bm and Cm (B,C,L,N);
// outputs y_intra (B,C,L,H,P) and states (B,C,H,P,N). Any L >= 1 (the serve
// path's chunks are the prompt itself, 4..23 rows), any H, N <= NMAX,
// P <= 64: ragged rows, heads, columns and states are zero-filled on the way
// into shared memory or masked, not padded by the caller. The inter-chunk
// recurrence stays in PyTorch (ops.py), as the reference keeps it in JAX.
//
// What bounds it on the H100: at L = 256, N = 128, P = 64 the work is
// 2 * [L(L+1)/2 * (N + H*P) + H*L*P*N] operations per (b, c) against
// (2*L*H*P + 4*L*H + 2*L*N + H*P*N) * 4 bytes, ~50 operations a byte. The
// contract with the plain version is f32's (rtol and atol 1e-4), which plain
// TF32 (10-bit mantissa) misses; 3xTF32 keeps it: each f32 operand v is split
// into big = tf32(v) and small = tf32(v - big), and a_small b_big +
// a_big b_small + a_big b_big is summed on the tensor cores (small * small,
// ~2^-22 relative, dropped). Three TF32 products at 495 TFLOP/s against the
// card's 3.35 TB/s put the bound at the bytes and the products about evenly
// (0.020 ms at B=1 S=2048), where f32 FFMA's bound is 0.049 ms. At the serve
// shape (C = 1, L = 17) it is byte-bound (the 1.5 MB of states) and, in
// practice, latency bound. Measured, it is held by latency: one CTA of eight
// warps an SM (registers and shared memory), whose phases — split, G, W,
// products — follow each other (PERF.md).
//
// What the design does about it:
// * One launch computes both outputs. The chunk-end states are y's product
//   with other rows: S_h^T[n,p] = sum_l (B[l,n] w_l) x[l,h,p], w_l = dt_l
//   exp(cum_end - cum_l), so a "state row" n takes B^T scaled by w where a
//   y row i takes W = G * exp(cum_i - cum_j) * dt_j, and both stream the same
//   x_j. A CTA owns BR = 128 rows — y rows i of one row block, or state rows
//   n of one block of N — for HB heads of one (b, c); two warpgroups own 64
//   rows each. Its grid is B*C * ceil(H/HB) * (ceil(L/BR) + ceil(N/BR))
//   CTAs, heaviest first: the last y row block (every column, plus G), then
//   the state blocks (every column, no G), then the other y row blocks. HB =
//   4 where that grid gives every SM two CTAs (B=1 S=2048: 288 CTAs), else
//   2 where it gives every SM one (B=4 S=256: 288), else 1 (the serve
//   shape: 96 CTAs), within the card's shared memory.
// * Every tile arrives ahead of its use: a CTA walks its columns in stages
//   of BJ = 32 rows of B_j, x_j (its heads), dt_j and cum_j. A stage lands
//   in a raw buffer by 16-byte cp.async (4-byte copies where N or P is not
//   a multiple of 4, or a pointer not 16-byte aligned), zero-filled past L,
//   H, P and N, each thread at a slot fixed before the loop (no division a
//   stage); it is split into the product buffers, and the next stage's
//   copies land in the raw buffer while this one is multiplied. A y block's
//   C_i rows (BR x N) stay resident. x_j's rows are H*P*4 bytes apart: a
//   stage copies HB*P contiguous floats a row.
// * Products on the tensor cores: wgmma m64n64k8 (tf32, f32 accumulate)
//   for y and the states, m64n32k8 for G, A from registers, B from shared
//   memory. TF32 wgmma reads B K-major, which x_j (p-contiguous) is not: the
//   split pass writes x_j's tf32 halves transposed (xT, one 64 x 32 tile a
//   head and half, 128-byte swizzle), once for the CTA, and B_j's halves
//   K-major for G. Rounding to tf32 is an integer add and mask: splitting
//   with cvt.rna.tf32 costs more than the products it feeds (PERF.md). The
//   tensor cores sum with truncation, so each head's stage (and each
//   32-deep block of G) sums its three products in a fresh accumulator that
//   is then added to the running sum in f32.
// * W never goes through shared memory. G = C_i B_j^T is formed per
//   warpgroup (64 rows x 32 columns, over N) once for the CTA's HB heads;
//   its accumulator fragment is scaled in registers by exp(cum_i - cum_j)
//   dt_j (j > i masked) and becomes the A operand of W x_j directly. The
//   accumulator holds columns (2t, 2t+1) where the A fragment holds
//   k = (t, t+4), so the k order is permuted: xT's column t holds x row 2t,
//   column t + 4 row 2t + 1 (as FlashAttention-2 does with P).
//   exp(cum_i - cum_j) is evaluated only for j <= i, where it is <= 1 (cum
//   is a cumulative sum of dt * A <= 0); never factored into
//   exp(cum_i) exp(-cum_j), which overflows for long chunks with strong
//   decay. A warpgroup skips the k-steps past its last row (the causal edge).
// * C and raw B rows have a pitch of roundup(N, 32) + 4 floats, so the
//   fragment reads of C and of B^T (the state rows' A) are free of bank
//   conflicts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // eight warps
constexpr int BR = 16 * THREADS / 32; // rows (y rows or state rows) a CTA
constexpr int BJ = 32;                // columns (x and B rows) a stage
constexpr int PMAX = 64;              // head dim a CTA covers
constexpr int PT = PMAX / 8;          // n8 tiles over the head dim
constexpr int NMAX = 224;             // state width the launcher takes
constexpr int SMEM_MAX = 232448;      // the H100's opt-in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory, in floats from a 1024-byte-aligned base: xT, the
// split halves of the stage's x_j for the products, transposed for wgmma
// (per head: big then small, each 64 rows p x 32 columns j in the 128-byte
// swizzle); B_j's halves for G (per 32 columns n: 32 rows j in the 128-byte
// swizzle; raw B_j in a state block, rows at pitch ns); C_i (BR rows);
// cum_i (HB x BR); the raw stage the next load lands in (B_j, x_j of HB
// heads, cum_j, dt_j); cum_j and dt_j of the stage being multiplied.
constexpr int XT_FLOATS = PMAX * BJ;  // one half of one head's xT: 8 KB
constexpr int SMEM_ALIGN = 1024;      // the 128-byte swizzle repeats every 8 rows
struct Layout {
  int ns;      // pitch of a C or B row: roundup(N, 32) + 4
  int xs;      // pitch of a raw x row: HB * PMAX + 4
  int b_big;   // offsets
  int b_small;
  int c;
  int cum_i;
  int raw;
  int raw_x;
  int raw_cum;
  int raw_dt;
  int cum_j;
  int dt_j;
  int floats;
  int bytes;   // what the launch asks for: floats and the alignment slack
};

__host__ __device__ inline Layout layout(int N, int HB) {
  Layout lo;
  lo.ns = (N + 31) / 32 * 32 + 4;
  lo.xs = HB * PMAX + 4;
  const int b_floats = (BJ * lo.ns + 255) / 256 * 256;   // whole 1 KB
  lo.b_big = HB * 2 * XT_FLOATS;
  lo.b_small = lo.b_big + b_floats;
  lo.c = lo.b_small + b_floats;
  lo.cum_i = lo.c + BR * lo.ns;
  lo.raw = lo.cum_i + HB * BR;
  lo.raw_x = lo.raw + BJ * lo.ns;
  lo.raw_cum = lo.raw_x + BJ * lo.xs;
  lo.raw_dt = lo.raw_cum + HB * BJ;
  lo.cum_j = lo.raw_dt + HB * BJ;
  lo.dt_j = lo.cum_j + HB * BJ;
  lo.floats = lo.dt_j + HB * BJ;
  lo.bytes = lo.floats * 4 + SMEM_ALIGN;
  return lo;
}

// ---- copies ----------------------------------------------------------------

// 16 (or 4) bytes from gmem to smem; zeros where !ok (nothing is read)
__device__ __forceinline__ void cp16(float* smem, const float* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(float* smem, const float* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every cp.async this thread committed has landed.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's fixed place in copies of rows of `units` copy units of
// `unit` floats each: its first row, its column (floats) and the rows
// between its copies (threads past whole rows stay idle). Computed once,
// so no copy of a stage divides.
struct Slot {
  int r, c, rstep;
};

__device__ __forceinline__ Slot slot(int units, int unit) {
  Slot s;
  s.rstep = THREADS / units;             // units <= THREADS
  const int r = threadIdx.x / units;
  s.r = r < s.rstep ? r : BR;            // past every block of rows
  s.c = (threadIdx.x % units) * unit;
  return s;
}

// Rows r0 .. r0 + nrows - 1 of a chunk's (L, N) matrix (its rows from
// `src`) into `dst` at pitch ns: columns up to ns - 4, zeros past row L and
// column N. Slot `s` is one of ns - 4 floats (4 where vec: 16-byte copies).
__device__ __forceinline__ void fill_rows(float* dst, int ns,
                                          const float* src, int r0,
                                          int nrows, int L, int N, bool vec,
                                          const Slot& s) {
  const bool col_ok = s.c < N;
  for (int r = s.r; r < nrows; r += s.rstep) {
    const bool ok = col_ok && r0 + r < L;
    const float* g = ok ? src + (long long)(r0 + r) * N + s.c : src;
    if (vec)
      cp16(dst + r * ns + s.c, g, ok);
    else
      cp4(dst + r * ns + s.c, g, ok);
  }
}

// NROWS rows of a chunk's (L, H) array (dt or cum) from row r0, for heads
// h0 .. h0 + HB - 1, into dst[hh * NROWS + r]; zeros past L and H.
template <int HB, int NROWS>
__device__ __forceinline__ void fill_heads(float* dst, const float* src,
                                           int r0, int L, int H, int h0) {
#pragma unroll
  for (int e = threadIdx.x; e < HB * NROWS; e += THREADS) {
    const int hh = e / NROWS, r = e % NROWS;
    const bool ok = r0 + r < L && h0 + hh < H;
    cp4(dst + e, ok ? src + (long long)(r0 + r) * H + h0 + hh : src, ok);
  }
}

// The raw stage: rows j0 .. j0 + BJ - 1 of B, of x for heads
// h0 .. h0 + HB - 1, of cum and dt. `x`, `Bm`, `cum`, `dt` point at the
// chunk's first row; slots sb (B's rows) and sx (x's: HB heads of PMAX
// floats a row).
template <int HB>
__device__ __forceinline__ void fill_stage(float* smem, const Layout& lo,
                                           const float* x, const float* dt,
                                           const float* cum, const float* Bm,
                                           int j0, int L, int H, int P, int N,
                                           int h0, bool vec, const Slot& sb,
                                           const Slot& sx) {
  fill_rows(smem + lo.raw, lo.ns, Bm, j0, BJ, L, N, vec, sb);
  float* xs = smem + lo.raw_x + sx.c;
  const int hh = sx.c / PMAX, p = sx.c % PMAX;
  const bool hp_ok = h0 + hh < H && p < P;
  const float* xh = x + (long long)(h0 + hh) * P + p;
  const long long row = (long long)H * P;
  for (int j = sx.r; j < BJ; j += sx.rstep) {
    const bool ok = hp_ok && j0 + j < L;
    const float* g = ok ? xh + (j0 + j) * row : x;
    if (vec)
      cp16(xs + j * lo.xs, g, ok);
    else
      cp4(xs + j * lo.xs, g, ok);
  }
  fill_heads<HB, BJ>(smem + lo.raw_cum, cum, j0, L, H, h0);
  fill_heads<HB, BJ>(smem + lo.raw_dt, dt, j0, L, H, h0);
}

// ---- 3xTF32 ----------------------------------------------------------------

// v rounded to tf32 (in f32's layout, low bits clear), to nearest with ties
// away from zero: half the dropped bits' range added to the magnitude, then
// the bits cleared — what cvt.rna.tf32.f32 gives a finite v, in two integer
// instructions (cvt issues at a fraction of their rate: PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small, both tf32, rounded to nearest (ties away from zero)
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// A fragment of four f32 values, split: a[0..3] at (g, t) (g+8, t) (g, t+4)
// (g+8, t+4) of a warp's 16 rows of a warpgroup's m64 x k8 tile
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ab)[4],
                                        uint32_t (&as)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(a[r], ab[r], as[r]);
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every product group this warpgroup committed is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle: start address,
// 1024 bytes between groups of 8 rows (both in 16-byte units), layout 1
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Byte offset of 16-byte chunk c (0..7) of row r of a tile of 128-byte rows
// in the 128-byte swizzle (chunk index XOR row % 8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4);
}

// d += a * b: m64n64k8, a (this thread's four tf32 of the warpgroup's
// 64 x 8 A) from registers, b (64 x 8, K-major) from shared memory, f32
// accumulate
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a * b: m64n32k8, a from registers, b (32 x 8, K-major) from shared
// memory, f32 accumulate
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// G = C_i B_j^T for the calling warpgroup's 64 rows and the stage's 32
// columns, over N: C's fragments (crow: this thread's row g, column t of
// the warp's 16 rows) split in registers, B_j's halves (per 32 columns n a
// 4 KB K-major block, big at shared address `bbig`, small at `bsmall`) by
// descriptor; each 32-deep block of n in a fresh accumulator.
__device__ __forceinline__ void product_g(float (&gacc)[16], const float* crow,
                                          int ns, uint32_t bbig,
                                          uint32_t bsmall) {
#pragma unroll
  for (int i = 0; i < 16; ++i) gacc[i] = 0.f;
  for (int n0 = 0; n0 < ns - 4; n0 += 32) {
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a[4] = {crow[n0 + 8 * k], crow[8 * ns + n0 + 8 * k],
                          crow[n0 + 8 * k + 4], crow[8 * ns + n0 + 8 * k + 4]};
      split_a(a, ab[k], as[k]);
    }
    float p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = 0.f;
    wgmma_fence();
    const uint32_t blk = (uint32_t)n0 * 128;   // 32 rows x 128 bytes a block
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_n32(p, as[k], kmajor_sw128_desc(bbig + blk + 32 * k));
      wgmma_n32(p, ab[k], kmajor_sw128_desc(bsmall + blk + 32 * k));
      wgmma_n32(p, ab[k], kmajor_sw128_desc(bbig + blk + 32 * k));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(p);
#pragma unroll
    for (int i = 0; i < 16; ++i) gacc[i] += p[i];
  }
}

// acc[hh] += A_hh xT_hh over the stage's first nsteps 8-deep steps, for
// the calling warpgroup's 64 rows and each of its heads (64 p each). A per
// step comes from `a_frag(hh, s, a)` (this thread's four f32 values of the
// step's A fragment; k = t is stage column 8s + 2t, k = t + 4 column
// 8s + 2t + 1), split in registers; xT_hh's halves are at shared addresses
// xt + hh * 16 KB (big) and + 8 KB (small), rows p, columns in the same
// permuted k order. Per step a_small xT_big, a_big xT_small, a_big xT_big
// (a_small xT_small dropped), a head's stage in one fresh accumulator that
// is then added to acc in f32: the tensor cores sum with truncation.
template <int HB, typename AFrag>
__device__ __forceinline__ void product_wg(float (&acc)[HB][32], uint32_t xt,
                                           int nheads, int nsteps,
                                           AFrag a_frag) {
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    if (hh >= nheads) break;
    uint32_t ab[BJ / 8][4], as[BJ / 8][4];
#pragma unroll
    for (int s = 0; s < BJ / 8; ++s) {
      if (s >= nsteps) break;
      float a[4];
      a_frag(hh, s, a);
      split_a(a, ab[s], as[s]);
    }
    float p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = 0.f;
    wgmma_fence();
    const uint32_t big = xt + hh * 8 * XT_FLOATS;
#pragma unroll
    for (int s = 0; s < BJ / 8; ++s) {
      if (s >= nsteps) break;
      const uint32_t k = 32 * s;         // 8 tf32 = 32 bytes a step
      wgmma_n64(p, as[s], kmajor_sw128_desc(big + k));
      wgmma_n64(p, ab[s], kmajor_sw128_desc(big + 4 * XT_FLOATS + k));
      wgmma_n64(p, ab[s], kmajor_sw128_desc(big + k));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(p);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] += p[i];
  }
}

// The landed raw stage, split for the products: x_j of each head into xT's
// big and small halves (row p, column k in the permuted order: column
// 8q + t holds stage row 8q + 2t, column 8q + 4 + t row 8q + 2t + 1, in
// the 128-byte swizzle); B_j into its halves, K-major for G (a state
// block, whose A is B_j scaled per head, copies it raw at pitch ns); cum_j
// and dt_j copied, so the next raw stage can land while this one is
// multiplied. Slot s4: one float4 of a B row.
template <int HB>
__device__ __forceinline__ void split_stage(float* smem, const Layout& lo,
                                            bool state_blk, const Slot& s4) {
  const float* xr = smem + lo.raw_x;
#pragma unroll 4
  for (int e = threadIdx.x; e < HB * PMAX * 8; e += THREADS) {
    const int p = e % PMAX, c = (e / PMAX) % 8, hh = e / (PMAX * 8);
    const float* col = xr + (8 * (c >> 1) + (c & 1)) * lo.xs + hh * PMAX + p;
    uint4 b, sm;
    split(col[0], b.x, sm.x);
    split(col[2 * lo.xs], b.y, sm.y);
    split(col[4 * lo.xs], b.z, sm.z);
    split(col[6 * lo.xs], b.w, sm.w);
    float* t = smem + hh * 2 * XT_FLOATS + sw128_offset(p, c) / 4;
    *reinterpret_cast<uint4*>(t) = b;
    *reinterpret_cast<uint4*>(t + XT_FLOATS) = sm;
  }
  const float* braw = smem + lo.raw;
  for (int r = s4.r; r < BJ; r += s4.rstep) {
    const float4 v = *reinterpret_cast<const float4*>(braw + r * lo.ns + s4.c);
    if (state_blk) {
      *reinterpret_cast<float4*>(smem + lo.b_big + r * lo.ns + s4.c) = v;
    } else {
      uint4 b, sm;
      split(v.x, b.x, sm.x);
      split(v.y, b.y, sm.y);
      split(v.z, b.z, sm.z);
      split(v.w, b.w, sm.w);
      const int off = (s4.c / 32) * (BJ * 32) +
                      (int)sw128_offset(r, (s4.c % 32) / 4) / 4;
      *reinterpret_cast<uint4*>(smem + lo.b_big + off) = b;
      *reinterpret_cast<uint4*>(smem + lo.b_small + off) = sm;
    }
  }
  for (int e = threadIdx.x; e < 2 * HB * BJ; e += THREADS)  // cum_j, dt_j
    smem[lo.cum_j + e] = smem[lo.raw_cum + e];
}

// ---- the kernel ------------------------------------------------------------

// grid: B*C * n_hg * (nrb + nsb) CTAs; CTA = (order, b*c, head group).
template <int HB>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, int L, int H, int P, int N,
                 int n_hg, int nrb, int nsb, long long n_bc, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~(uintptr_t)(SMEM_ALIGN - 1));
  const Layout lo = layout(N, HB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // order 0: the last y row block; 1..nsb: the state blocks; then the
  // other y row blocks, last first (heaviest first)
  const long long per = n_bc * n_hg;
  const int order = (int)(blockIdx.x / per);
  const long long rest = blockIdx.x % per;
  const long long bc = rest / n_hg;
  const int h0 = (int)(rest % n_hg) * HB;
  const bool state_blk = order >= 1 && order <= nsb;
  const int blk = order == 0 ? nrb - 1
                  : state_blk ? order - 1 : nrb - 1 - (order - nsb);
  const int r0 = blk * BR;                  // first row (i, or n) of the block
  const int jend = state_blk ? L : min(L, r0 + BR);
  const int nkb = (jend + BJ - 1) / BJ;

  const long long row0 = bc * L;            // the chunk's first (b, c, l) row
  const float* xc = x + row0 * H * P;
  const float* dtc = dt + row0 * H;
  const float* cumc = cum + row0 * H;
  const float* Bc = Bm + row0 * N;
  const bool v = vec != 0;
  // copy slots: a B or C row (16-byte or 4-byte units), a raw x row (HB
  // heads), and one float4 of a B row (the split pass)
  const Slot sb = v ? slot((lo.ns - 4) / 4, 4) : slot(lo.ns - 4, 1);
  const Slot sx = v ? slot(HB * PMAX / 4, 4) : slot(HB * PMAX, 1);
  const Slot s4 = slot((lo.ns - 4) / 4, 4);

  float cum_end[HB];
  if (state_blk) {
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
      cum_end[hh] = h0 + hh < H ? cumc[(long long)(L - 1) * H + h0 + hh] : 0.f;
  } else {
    // the warpgroups' rows that lie in the chunk, in whole 64-row tiles
    const int rows = min(BR, (L - r0 + 63) / 64 * 64);
    fill_rows(smem + lo.c, lo.ns, Cm + row0 * N, r0, rows, L, N, v, sb);
    fill_heads<HB, BR>(smem + lo.cum_i, cumc, r0, L, H, h0);
  }
  fill_stage<HB>(smem, lo, xc, dtc, cumc, Bc, 0, L, H, P, N, h0, v, sb, sx);
  cp_commit();

  float acc[HB][32];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;

  const int npt = (P + 7) / 8;
  const int w0 = r0 + 16 * warp;            // the warp's first row
  const int wg0 = r0 + 64 * (warp >> 2);    // its warpgroup's first row
  const uint32_t xt = smem_u32(smem);       // head hh's xT at + hh * 16 KB
  const float* bb = smem + lo.b_big;
  const float* cj = smem + lo.cum_j;
  const float* dj = smem + lo.dt_j;
  cp_wait_all();                            // stage 0 landed (this thread)
  __syncthreads();                          // ... for every thread
  for (int kb = 0; kb < nkb; ++kb) {
    split_stage<HB>(smem, lo, state_blk, s4);
    fence_proxy_async_shared();             // xT visible to wgmma
    __syncthreads();                        // split; the raw stage is free
    if (kb + 1 < nkb)
      fill_stage<HB>(smem, lo, xc, dtc, cumc, Bc, (kb + 1) * BJ, L, H, P, N,
                     h0, v, sb, sx);
    cp_commit();
    const int j0 = kb * BJ;
    const int nheads = min(HB, H - h0);
    if (state_blk) {
      if (wg0 < N) {
        // state rows n = w0 + g (+8): A[n, l] = B[l, n] * w_l, w_l =
        // dt_l exp(cum_end - cum_l) (the difference taken first: both
        // ends may be large where the difference is not)
        const int nsteps = min(BJ / 8, (L - j0 + 7) / 8);
        const float* bcol = bb + 2 * t * lo.ns + w0 + g;
        const bool na = w0 + g < N, nb = w0 + g + 8 < N;
        product_wg<HB>(acc, xt, nheads, nsteps,
                       [&](int hh, int s, float (&a)[4]) {
                         const int lc = hh * BJ + 8 * s + 2 * t;
                         const float wa =
                             dj[lc] * ex2((cum_end[hh] - cj[lc]) * LOG2E);
                         const float wb = dj[lc + 1] *
                                          ex2((cum_end[hh] - cj[lc + 1]) * LOG2E);
                         const float* b = bcol + 8 * s * lo.ns;
                         a[0] = na ? b[0] * wa : 0.f;
                         a[1] = nb ? b[8] * wa : 0.f;
                         a[2] = na ? b[lo.ns] * wb : 0.f;
                         a[3] = nb ? b[lo.ns + 8] * wb : 0.f;
                       });
      }
    } else if (wg0 < L && j0 <= wg0 + 63) {
      // k8 steps with a column at or before the warpgroup's last row
      const int nsteps = min(BJ / 8, (min(wg0 + 63, L - 1) - j0) / 8 + 1);
      // G = C_i B_j^T for the warpgroup's 64 rows and the stage's columns
      float gacc[16];
      product_g(gacc, smem + lo.c + (16 * warp + g) * lo.ns + t, lo.ns,
                smem_u32(smem + lo.b_big), smem_u32(smem + lo.b_small));
      // W = G * exp(cum_i - cum_j) * dt_j (j > i masked), A of W xT
      const int ia = w0 + g, ib = ia + 8;
      const float* ci = smem + lo.cum_i + 16 * warp + g;
      product_wg<HB>(acc, xt, nheads, nsteps,
                     [&](int hh, int s, float (&a)[4]) {
                       const int lc = hh * BJ + 8 * s + 2 * t;
                       const int ja = j0 + 8 * s + 2 * t, jb = ja + 1;
                       const float cia = ci[hh * BR], cib = ci[hh * BR + 8];
                       // cum_i - cum_j <= 0 where j <= i; clamped
                       // elsewhere, so a masked entry never makes inf
                       auto w = [&](float gv, float c_i, int l, bool live) {
                         return live ? gv *
                                           ex2(fminf(c_i - cj[l], 0.f) * LOG2E) *
                                           dj[l]
                                     : 0.f;
                       };
                       a[0] = w(gacc[4 * s], cia, lc, ja <= ia);
                       a[1] = w(gacc[4 * s + 2], cib, lc, ja <= ib);
                       a[2] = w(gacc[4 * s + 1], cia, lc + 1, jb <= ia);
                       a[3] = w(gacc[4 * s + 3], cib, lc + 1, jb <= ib);
                     });
    }
    cp_wait_all();                          // stage kb + 1 landed (this thread)
    __syncthreads();                        // ... for all; xT, B_j halves free
  }

  // epilogue: accumulator element 4 pt + r is row g (+8 for r >= 2), column
  // 8 pt + 2t (+1 for odd r) of the warp's 16 rows
  if (state_blk) {
    if (w0 >= N) return;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const int h = h0 + hh;
      if (h >= H) break;
      float* out = states + (bc * H + h) * (long long)P * N;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        if (pt >= npt) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = w0 + g + 8 * (r >> 1), p = 8 * pt + 2 * t + (r & 1);
          if (n < N && p < P) out[(long long)p * N + n] = acc[hh][4 * pt + r];
        }
      }
    }
  } else {
    if (w0 >= L) return;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const int h = h0 + hh;
      if (h >= H) break;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        if (pt >= npt) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = w0 + g + 8 * (r >> 1), p = 8 * pt + 2 * t + (r & 1);
          if (i < L && p < P)
            y[((row0 + i) * H + h) * P + p] = acc[hh][4 * pt + r];
        }
      }
    }
  }
}

// what k6_request_smem set (a fault-injection hook: a size above the card's
// opt-in limit makes the attribute call fail, which the launcher reports)
int g_smem_request = 0;
int g_force_heads = 0;     // k6_force_heads: 0, or the instance's HB
int g_sms = 0;             // the SM count, read on the first launch

template <int HB>
int launch(const void* x, const void* dt, const void* cum, const void* Bm,
           const void* Cm, void* y, void* states, long long n_bc, int L,
           int H, int P, int N, int vec, cudaStream_t stream) {
  static int smem_set = 0;   // the attribute this instance was given
  const int smem =
      g_smem_request > 0 ? g_smem_request : layout(N, HB).bytes;
  auto kern = ssd_chunk_kernel<HB>;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();    // reported here; the next launch must not see it
      return (int)err;
    }
    smem_set = smem;
  }
  const int n_hg = (H + HB - 1) / HB;
  const int nrb = (L + BR - 1) / BR, nsb = (N + BR - 1) / BR;
  const long long grid = n_bc * n_hg * (nrb + nsb);
  if (grid > 0x7fffffffLL) return -1;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), L, H, P, N, n_hg, nrb, nsb, n_bc, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The card's SM count, read on the first launch only.
int sm_count(int* sms) {
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = g_sms;
  return 0;
}

// The shape rule: 4 heads a CTA share G where that still gives two CTAs an
// SM (the heaviest CTA, a chunk's last row block, is a third of the
// chunk's work: two waves balance it); else 2 where every SM gets a CTA;
// else 1 (a short chunk: the serve path's prompts); always within the
// card's shared memory.
int heads_for(long long n_bc, int L, int H, int N, int sms) {
  const long long blocks = (L + BR - 1) / BR + (N + BR - 1) / BR;
  const int cands[2] = {4, 2};
  for (int hb : cands)
    if (layout(N, hb).bytes <= SMEM_MAX &&
        n_bc * ((H + hb - 1) / hb) * blocks >= (hb == 4 ? 2 : 1) * sms)
      return hb;
  return 1;
}

}  // namespace

// Returns 0 or a cudaError_t; -1 for a shape the kernel does not take.
extern "C" int k6_ssd_chunk_fwd(const void* x, const void* dt, const void* cum,
                                const void* Bm, const void* Cm, void* y,
                                void* states, int Bsz, int C, int L, int H,
                                int P, int N, void* stream) {
  if (Bsz < 1 || C < 1 || L < 1 || H < 1 || N < 1 || N > NMAX || P < 1 ||
      P > PMAX)
    return -1;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const long long n_bc = (long long)Bsz * C;
  const int hb = g_force_heads > 0 ? g_force_heads
                                   : heads_for(n_bc, L, H, N, sms);
  const int vec = N % 4 == 0 && P % 4 == 0 && aligned16(x) && aligned16(Bm) &&
                  aligned16(Cm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hb) {
    case 4: return launch<4>(x, dt, cum, Bm, Cm, y, states, n_bc, L, H, P, N, vec, st);
    case 2: return launch<2>(x, dt, cum, Bm, Cm, y, states, n_bc, L, H, P, N, vec, st);
    case 1: return launch<1>(x, dt, cum, Bm, Cm, y, states, n_bc, L, H, P, N, vec, st);
    default: return -1;
  }
}

// Fault injection for the tests: the launches that follow ask for `bytes`
// of dynamic shared memory instead of their own size (0 restores it). A
// size the card cannot give makes k6_ssd_chunk_fwd return the attribute
// call's error without launching.
extern "C" void k6_request_smem(int bytes) { g_smem_request = bytes; }

// The instance the launches that follow take (4, 2 or 1 heads a CTA; 0
// restores the shape rule), for the tests and the timing scripts.
extern "C" void k6_force_heads(int hb) { g_force_heads = hb; }

// Heads a CTA that the shape rule picks for a shape (what k6_ssd_chunk_fwd
// launches unless forced), or a negative cudaError_t.
extern "C" int k6_heads_for(int Bsz, int C, int L, int H, int N) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return -err;
  return heads_for((long long)Bsz * C, L, H, N, sms);
}

extern "C" const char* k6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
