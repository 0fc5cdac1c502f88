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
// Shard mode (k4_decode_attention_shard): the caches hold one sequence
// shard, global positions [off, off + S_loc) of a cache of S_glob. The live
// range, global [max(0, vl - window), min(vl, S_glob)) (or from 0 without a
// window), is cut to the shard on the device, and the kernel writes the
// shard's partial: its normalized output and lse = m + log(l) in f32, (B, Hq);
// a shard with no live key writes o = 0 and lse = -inf and loads no key.
// merge_decode_partials (kernel.py) joins the partials of the shards — over
// the mesh's all_reduce on the seq axes, or a list on one card — as
// repro's decode_attention_sharded merges its shard_map partials
// (src/repro/models/attention.py:479-514).
//
// What bounds it on the H100: bytes. Each live cache row is used by G query
// heads for 4*D operations each — far below the ~295 operations per byte at
// which bf16 work turns operation-bound — so the least time is the live K/V
// bytes over 3.35 TB/s. At the serve path's shapes (a 128-position cache)
// the bytes take well under a microsecond, and the launch itself is most of
// the time. What the design does about it:
// (1) One launch a call. Each of the n_split CTAs that share a (sequence,
//     kv head) computes the online-softmax partial (max, sumexp, acc) of
//     its key range for all G query heads of the kv head (so every K/V
//     row is read from memory once, not G times) and leaves it in its
//     shared memory. Up to MAX_CLUSTER splits the CTAs form one
//     thread-block cluster: after cluster.sync() every CTA merges a slice
//     of the G x D outputs, reading the partials of all n_split CTAs
//     through distributed shared memory, with the merge of repro's
//     decode_attention_sharded (models/attention.py, the pmax/psum merge);
//     no partial goes through global memory, and the wrapper allocates
//     only the output. Past one cluster (finish()), each CTA writes its
//     partial (m, l, acc in f32) to scratch the wrapper allocates, and the
//     last CTA to arrive, told by an arrival counter it then sets back to
//     0 (so no launch clears it), merges the splits' partials in split
//     order. The order of every sum is fixed: the result repeats bit for
//     bit, and the counter is the only atomic.
// (2) Splits follow valid_len on the device. Each CTA derives its key range
//     from valid_len[b] and the window: the live keys [lo, valid) are cut
//     into n_split even ranges, so a short sequence's CTAs finish at once
//     and a long sequence's CTAs share its keys evenly; rows at or past
//     valid_len, or before the window, are never loaded. The host never
//     reads valid_len.
// (3) The split count and the cluster size (the wrapper's: kernel.py
//     split_count and cluster_size; a cluster is at most MAX_CLUSTER = 8
//     CTAs, the portable limit). With llama3-8b's B = 4 sequences x Hkv =
//     8 kv heads = 32 clusters and a long cache, 8 splits make 256 CTAs of
//     128 threads and ~104 KB of shared memory each: two fit on an SM (the
//     card started 240 of them at once, on 124 SMs, the last 16 as others
//     ended). A split is given at least 64 positions of the cache (or
//     window), so the serve path's 128-position cache takes 2 splits: on
//     the card 2 beat 1, 4 and 8 there (PERF.md). bf16 at D = 256 takes
//     more splits than one cluster holds where B x Hkv is small (gemma2-2b's
//     decode: 1 x 4 pairs): enough CTAs of ~140 KB (one an SM) to fill the
//     card in one wave, 132 at gemma2-2b's long cache. Those are clusters
//     of one CTA, and so are D = 256's splits wherever the grid has more
//     than 120 CTAs (gemma2-2b's 4 slots at the long cache: 4 x 4 x 8): at
//     one CTA an SM the card placed no more than 120 CTAs in clusters of 4
//     or 8 at once, the rest a second wave (0.063 ms against 0.035 in
//     clusters of one), and a merge through distributed shared memory
//     before the one through scratch cost more than it saved
//     (scripts/exec_decode_turns.py, PERF.md).
// (4) K/V tiles stream through a ring of STAGES stages: 16-byte cp.async
//     copies from every thread, one commit group a tile, the next STAGES -
//     1 tiles' loads in flight while one tile is scored and summed (~64-100
//     KB a CTA), keys past the range's end within its last tile
//     zero-filled, never read (at D = 256 two stages of 64 keys, ~140 KB
//     a CTA with the slabs' score exchange: one CTA an SM).
// (5) The math. bf16 (every head dim: 32, 64, 112, 128 and 256) runs on
//     the tensor cores (mma.sync m16n8k16, f32 accumulate): the G query
//     heads are the 16 rows of the A operand (rows past G zero), each of
//     the MMA_WARPS warps takes 16 keys of every 64-key tile with its own
//     online softmax (the warps' partials merged in shared memory into the
//     CTA's before the cluster merge), K and V fragments come by ldmatrix
//     (V transposed), and P goes from the score accumulators to A
//     fragments in registers. So a CTA reads a tile from shared memory
//     once, where FFMA with one warp a head read it G times (shared-memory
//     wavefronts, not the FMAs, set that kernel's pace:
//     scripts/exec_decode_turns.py's no_math variant). Q stays in
//     registers as A fragments. At D = 256 (gemma2-2b) two warps share a
//     16-key slab (eight warps a CTA, one CTA an SM): each takes 8 of Q·Kᵀ's
//     16 k16 steps, they add their partial scores through shared memory,
//     and each holds half of O (16 n8 tiles), so Q's 32 and O's 64
//     registers fit where one warp would need 64 and 128. f32 keeps the FFMA kernel:
//     one warp a query head, two or one keys a lane for Q·Kᵀ, ceil(D/32)
//     dims a lane for P·V (at D = 112, 28 lanes of 4; at D = 32, 8 lanes
//     of 4). D = 112 (zamba2-7b): Q·Kᵀ in 7 k16 steps, P·V in 14 n8 tiles;
//     its 224-byte cache rows keep the 16-byte copies aligned. D = 32
//     (every reduced config): 2 k16 steps and 4 n8 tiles, rows padded to
//     80 bytes (the 8 rows of an ldmatrix read start 20 words apart:
//     distinct banks); D = 256's 528-byte rows start 4 words apart.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_G = 16;         // query heads per kv head (one m16 tile; one warp each in FFMA)
constexpr int MIN_WARPS = 4;      // FFMA warps a CTA, at least (extra ones only load)
constexpr int MAX_CLUSTER = 8;    // CTAs (splits) a cluster: the portable limit
constexpr int MAX_SPLITS = 128;   // splits (CTAs) a (sequence, kv head)
// bf16: tensor-core products, 16-key slabs of a tile (a warp each, or
// DIM_SPLIT_D256 warps at D = 256); rows of K and V padded by 16 bytes (the
// 8 rows of an ldmatrix read hit distinct banks); as many stages as keep
// the ring near 100 KB (two CTAs an SM), and at D = 256 two (one CTA an SM).
constexpr int MMA_WARPS = 4;      // slabs a tile
constexpr int MMA_BK = 16 * MMA_WARPS;
constexpr int STAGES_MMA_D32 = 4;
constexpr int STAGES_MMA_D64 = 4;
constexpr int STAGES_MMA_D112 = 3;
constexpr int STAGES_MMA_D128 = 3;
constexpr int STAGES_MMA_D256 = 2;
// warps a 16-key slab of a tile: at D = 256 (one CTA an SM, no other CTA's
// warps to switch to) two, each taking half of Q·Kᵀ's k-steps and of O's
// dims, so twice the warps share the products
constexpr int DIM_SPLIT_D256 = 2;
constexpr int MAX_WARPS = MMA_WARPS * DIM_SPLIT_D256;
// FFMA (f32): keys a tile and ring stages, per head dim: two keys a lane
// while a cache row is at most 256 bytes, else one; as many stages as keep
// the ring near 100 KB (two CTAs an SM), at least two.
constexpr int BK_F32_D32 = 64;
constexpr int STAGES_F32_D32 = 3;
constexpr int BK_F32_D64 = 64;
constexpr int STAGES_F32_D64 = 3;
constexpr int BK_F32_D112 = 32;
constexpr int STAGES_F32_D112 = 3;
constexpr int BK_F32_D128 = 32;
constexpr int STAGES_F32_D128 = 3;
constexpr int BK_F32_D256 = 32;
constexpr int STAGES_F32_D256 = 2;

template <int D, typename T> struct Cfg;
template <> struct Cfg<32, float> { static constexpr int BK = BK_F32_D32, STAGES = STAGES_F32_D32; };
template <> struct Cfg<64, float> { static constexpr int BK = BK_F32_D64, STAGES = STAGES_F32_D64; };
template <> struct Cfg<112, float> { static constexpr int BK = BK_F32_D112, STAGES = STAGES_F32_D112; };
template <> struct Cfg<128, float> { static constexpr int BK = BK_F32_D128, STAGES = STAGES_F32_D128; };
template <> struct Cfg<256, float> { static constexpr int BK = BK_F32_D256, STAGES = STAGES_F32_D256; };

// The FFMA kernel's shared memory (bytes): the ring's stages, each a K
// tile with rows padded by 16 bytes (32 lanes reading 32 rows hit distinct
// banks) and a V tile; then sQ[G][D] f32 (pre-scaled q), sP[G][BK] f32
// probabilities, and the partial sM[G], sL[G], sAcc[G][D] f32 the cluster
// merge reads.
template <int D, typename T>
struct Layout {
  static constexpr int BK = Cfg<D, T>::BK;
  static constexpr int STAGES = Cfg<D, T>::STAGES;
  static constexpr int VN = 16 / (int)sizeof(T);         // elements a 16-byte vector
  static constexpr int KSTRIDE = D + VN;                 // padded K row (elements)
  static constexpr int STAGE_BYTES = BK * (KSTRIDE + D) * (int)sizeof(T);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  __host__ __device__ static int bytes(int G) { return RING_BYTES + G * (2 * D + BK + 2) * 4; }
};

// The tensor-core kernel's: the ring's stages (K then V tile, rows of
// D + 8 bf16), then at D = 256 the slabs' score exchange; in
// the same bytes once the ring has drained, the warps' partials sM[W][G],
// sL[W][G], sAcc[W][G][D] f32 and the CTA's merged one (cM[G], cL[G],
// cAcc[G][D]).
template <int D> struct MmaCfg;
template <> struct MmaCfg<32> { static constexpr int STAGES = STAGES_MMA_D32, DSPLIT = 1; };
template <> struct MmaCfg<64> { static constexpr int STAGES = STAGES_MMA_D64, DSPLIT = 1; };
template <> struct MmaCfg<112> { static constexpr int STAGES = STAGES_MMA_D112, DSPLIT = 1; };
template <> struct MmaCfg<128> { static constexpr int STAGES = STAGES_MMA_D128, DSPLIT = 1; };
template <> struct MmaCfg<256> { static constexpr int STAGES = STAGES_MMA_D256, DSPLIT = DIM_SPLIT_D256; };
template <int D>
struct MmaLayout {
  static constexpr int STAGES = MmaCfg<D>::STAGES;
  static constexpr int DSPLIT = MmaCfg<D>::DSPLIT;
  static constexpr int WARPS = MMA_WARPS * DSPLIT;
  static constexpr int ST = D + 8;                       // padded row (elements)
  static constexpr int STAGE_ELEMS = 2 * MMA_BK * ST;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  // the warps of a slab trade their halves of its scores: 8 f32 a lane
  static constexpr int XCH_BYTES = DSPLIT > 1 ? WARPS * 32 * 8 * 4 : 0;
  __host__ __device__ static int bytes(int G) {
    const int part = (MMA_WARPS + 1) * G * (D + 2) * 4;
    const int tiles = RING_BYTES + XCH_BYTES;
    return tiles > part ? tiles : part;
  }
};

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

// 16 bytes global -> shared, asynchronously; src_bytes = 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// This thread's 16-byte copies of the K and V rows of keys [t0, t0 + BK) of
// (sequence b, kv head hk) into sK and sV (rows of KST and VST elements);
// keys at or past e are zero-filled.
template <typename T, int D, int BK, int KST, int VST>
__device__ __forceinline__ void issue_tile(T* sK, T* sV, const T* k,
                                           const T* v, int b, int hk, int S,
                                           int Hkv, int t0, int e) {
  constexpr int VN = 16 / (int)sizeof(T);
  constexpr int VPR = D / VN;                 // 16-byte vectors a row
  for (int idx = threadIdx.x; idx < BK * VPR; idx += blockDim.x) {
    const int r = idx / VPR;
    const int c = idx % VPR;
    const int kp = t0 + r;
    const int live = kp < e;
    const size_t off =
        (((size_t)b * S + (live ? kp : 0)) * Hkv + hk) * D + c * VN;
    cp_async16(sK + r * KST + c * VN, k + off, live ? 16 : 0);
    cp_async16(sV + r * VST + c * VN, v + off, live ? 16 : 0);
  }
}

// One merged output element: m = max over the partials, -inf where none
// had a live key; l = sum(c * l_p) and acc = sum(c * acc_p) with c =
// exp(m_p - m), 0 for an empty partial. The final output is acc / max(l,
// 1e-30) and, in the shard mode, lse = m + log(l) (-inf where no key).
template <typename T>
__device__ __forceinline__ void store_merged(float m, float l, float acc,
                                             int idx, int D, T* out,
                                             float* lse) {
  from_float(acc / fmaxf(l, 1e-30f), out + idx);
  if (lse != nullptr && idx % D == 0)
    lse[idx / D] = isfinite(m) ? m + logf(l) : -INFINITY;
}

// The shard merge of decode_attention_sharded over the partials of a
// cluster's CTAs, one a CTA (sM[g], sL[g], sAcc[g D + d] in its shared
// memory; m = -inf for a partial without a live key), each CTA a slice of
// the G x D outputs, merged as store_merged says. Reads the other CTAs'
// partials through distributed shared memory, every CTA's words of an
// output issued at once. n <= MAX_CLUSTER: the launch sets no
// non-portable cluster attribute, so the card refuses a larger cluster.
template <typename T>
__device__ void cluster_merge(const cg::cluster_group& cluster,
                              float* sM, float* sL, float* sAcc, int G, int D,
                              T* out, float* lse) {
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int idx = rank * blockDim.x + threadIdx.x; idx < G * D;
       idx += n * blockDim.x) {
    const int g = idx / D;
    float ms[MAX_CLUSTER], ls[MAX_CLUSTER], os[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      ms[r] = r < n ? *cluster.map_shared_rank(sM + g, r) : -INFINITY;
      ls[r] = r < n ? *cluster.map_shared_rank(sL + g, r) : 0.f;
      os[r] = r < n ? *cluster.map_shared_rank(sAcc + idx, r) : 0.f;
    }
    float mg = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) mg = fmaxf(mg, ms[r]);
    const float m_safe = isfinite(mg) ? mg : 0.f;
    float lsum = 0.f;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      const float c = isfinite(ms[r]) ? expf(ms[r] - m_safe) : 0.f;
      lsum += c * ls[r];
      o += c * os[r];
    }
    store_merged(mg, lsum, o, idx, D, out, lse);
  }
}

// The end of every launch, once each CTA's partial is in its shared
// memory (sM[g], sL[g], sAcc[g D + d]). The n_split = gridDim.x CTAs of a
// (sequence, kv head) bh are one cluster (n_split <= MAX_CLUSTER), whose
// merge through distributed shared memory is the output; or, past one
// cluster (clusters of one CTA), each CTA stores its partial in scratch
// (split sp of bh at (bh n_split + sp) G (D + 4) floats: acc[G D], then
// m[G], l[G]), and one thread fences and counts the CTA's arrival in
// counters[bh] (the fence is cumulative: it publishes the CTA's stores).
// The CTA that arrives last sets the counter back to 0 and merges every
// split's partial, in split order, in `work` (free shared memory of
// work_bytes, 16-byte aligned): all the partials copied in at once where
// they fit (else read from L2 as they are summed) while each head's
// weights are made (a warp a head), then each output's sum over the
// splits, the splits dealt round-robin to as many threads an output as
// the CTA has to spare and their sums added in a fixed order. out and lse
// point at this (sequence, kv head)'s G heads.
template <typename T>
__device__ void finish(const cg::cluster_group& cluster, float* sM,
                       float* sL, float* sAcc, int G, int D, T* out,
                       float* lse, float* scratch, int* counters, int bh,
                       float* work, int work_bytes) {
  __shared__ int last;
  const int n_split = gridDim.x;
  if (static_cast<int>(cluster.num_blocks()) == n_split) {
    cluster.sync();                   // every partial of the cluster written
    cluster_merge<T>(cluster, sM, sL, sAcc, G, D, out, lse);
    cluster.sync();                   // no CTA leaves while others read it
    return;
  }
  const int stride = G * (D + 4);
  const int GD = G * D;
  scratch += (size_t)bh * n_split * stride;
  __syncthreads();                    // the CTA's partial written
  float* mine = scratch + (size_t)blockIdx.x * stride;
  for (int i = threadIdx.x; i < GD; i += blockDim.x) mine[i] = sAcc[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    mine[GD + g] = sM[g];
    mine[GD + G + g] = sL[g];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    last = atomicAdd(counters + bh, 1) + 1 == n_split;
    if (last) counters[bh] = 0;       // ready for the next launch
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!last) return;
  const int nq = GD / 4;              // float4s of the output
  const int parts = max(1, static_cast<int>(blockDim.x) / nq);
  const int table = (2 * n_split * G + 2 * G + 3) & ~3;   // floats
  const int staged = n_split * stride;                    // floats
  const bool in_smem =
      (staged + table + 4 * parts * nq) * 4 <= work_bytes;
  const float* src = in_smem ? work : scratch;
  float* wm = work + (in_smem ? staged : 0);  // [n_split][G]: m, then weights
  float* wl = wm + n_split * G;               // [n_split][G]: l
  float* hm = wl + n_split * G;               // [G]: max over the splits
  float* hl = hm + G;                         // [G]: sum of weighted l
  float4* part = reinterpret_cast<float4*>(wm + table);   // [parts][nq]
  if (in_smem) {                      // in flight while the weights are made
    for (int i = threadIdx.x; i < staged / 4; i += blockDim.x)
      cp_async16(work + 4 * i, scratch + 4 * i, 16);
    cp_async_commit();
  }
  // a warp a head: the max over the splits, the weights, their sum of l
  // (each lane's m and l loaded once: n_split <= MAX_SPLITS = 4 x 32)
  const int lane = threadIdx.x % 32;
  for (int g = threadIdx.x / 32; g < G; g += blockDim.x / 32) {
    float mc[MAX_SPLITS / 32], lc[MAX_SPLITS / 32];
    float mg = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int c = lane + 32 * i;
      const float* pc = scratch + (size_t)c * stride + GD;
      mc[i] = c < n_split ? __ldcg(pc + g) : -INFINITY;
      lc[i] = c < n_split ? __ldcg(pc + G + g) : 0.f;
      mg = fmaxf(mg, mc[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
    const float m_safe = isfinite(mg) ? mg : 0.f;
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int c = lane + 32 * i;
      const float w = isfinite(mc[i]) ? expf(mc[i] - m_safe) : 0.f;
      if (c < n_split) wm[c * G + g] = w;
      lsum += w * lc[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) {
      hm[g] = mg;
      hl[g] = lsum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int t = threadIdx.x; t < nq * parts; t += blockDim.x) {
    const int q4 = t % nq, pt = t / nq;
    const int g = 4 * q4 / D;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = pt; c < n_split; c += parts) {
      const float w = wm[c * G + g];
      const float4* pc = reinterpret_cast<const float4*>(
          src + (size_t)c * stride) + q4;
      const float4 x = in_smem ? *pc : __ldcg(pc);
      o.x += w * x.x;
      o.y += w * x.y;
      o.z += w * x.z;
      o.w += w * x.w;
    }
    part[pt * nq + q4] = o;
  }
  __syncthreads();
  for (int q4 = threadIdx.x; q4 < nq; q4 += blockDim.x) {
    const int g = 4 * q4 / D;
    float4 o = part[q4];
    for (int pt = 1; pt < parts; ++pt) {
      const float4 x = part[pt * nq + q4];
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    store_merged(hm[g], hl[g], o.x, 4 * q4, D, out, lse);
    store_merged(hm[g], hl[g], o.y, 4 * q4 + 1, D, out, lse);
    store_merged(hm[g], hl[g], o.z, 4 * q4 + 2, D, out, lse);
    store_merged(hm[g], hl[g], o.w, 4 * q4 + 3, D, out, lse);
  }
}

// The key range [a, e) of split `sp` of n_split, in the shard's own
// positions: the live keys, global [lo, valid), cut to the shard
// [off, off + S_loc) and then into even ranges (split_ranges in
// tests/test_torch_kernels_attention.py mirrors it). Unsharded: off = 0,
// S_loc = S_glob = S.
__device__ __forceinline__ void split_range(int valid_len, int S_glob,
                                            int window, int off, int S_loc,
                                            int sp, int n_split, int& a,
                                            int& e) {
  const int valid = min(valid_len, S_glob);
  const int lo = window > 0 ? max(0, valid - window) : 0;
  const int lo_l = max(lo, off) - off;
  const int hi_l = max(min(valid, off + S_loc) - off, lo_l);
  const int chunk = (hi_l - lo_l + n_split - 1) / n_split;
  a = lo_l + sp * chunk;
  e = min(a + chunk, hi_l);
}

// grid (n_split, Hkv, B) in clusters along x; 32 * max(G, MIN_WARPS)
// threads: warp g < G serves query head hk*G + g, every thread issues the
// ring's copies.
template <int D, typename T>
__global__ void __launch_bounds__(32 * MAX_G)
decode_ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              T* __restrict__ out, int S, int Hq, int Hkv, float softcap,
              int window, float scale, int off, int S_glob,
              float* __restrict__ lse, float* __restrict__ scratch,
              int* __restrict__ counters) {
  using L = Layout<D, T>;
  constexpr int BK = L::BK;
  constexpr int STAGES = L::STAGES;
  constexpr int VN = L::VN;
  constexpr int KSTRIDE = L::KSTRIDE;
  constexpr int VPR = D / VN;                 // 16-byte vectors a row of Q·Kᵀ
  constexpr int DL = D <= 32 ? 4 : (D + 31) / 32;   // dims a lane in P·V
  constexpr int KPL = BK / 32;                // keys a lane in Q·Kᵀ
  constexpr int STAGE_ELEMS = BK * (KSTRIDE + D);

  cg::cluster_group cluster = cg::this_cluster();
  const int G = Hq / Hkv;
  const int n_split = gridDim.x;
  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool pv_lane = lane * DL < D;         // false past D (D = 32, 112)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem_raw + L::RING_BYTES);
  float* sP = sQ + G * D;
  float* sM = sP + G * BK;
  float* sL = sM + G;
  float* sAcc = sL + G;

  int a, e;
  split_range(valid_len[b], S_glob, window, off, S, sp, n_split, a, e);
  const int ntiles = e > a ? (e - a + BK - 1) / BK : 0;

  // this thread's copies of tile j (keys a + j*BK ...) into its stage
  auto issue = [&](int j) {
    T* sK = ring + (j % STAGES) * STAGE_ELEMS;
    issue_tile<T, D, BK, KSTRIDE, D>(sK, sK + BK * KSTRIDE, k, v, b, hk, S,
                                     Hkv, a + j * BK, e);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    cp_async_commit();
  }

  for (int i = tid; i < G * D; i += nthreads) {
    const int g = i / D, d = i % D;
    sQ[i] = to_float(q[((size_t)b * Hq + hk * G + g) * D + d]) * scale;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<STAGES - 2>();      // tile j has landed for this thread
    __syncthreads();                  // ... for every thread; tile j-1 consumed
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_async_commit();
    if (warp >= G) continue;
    const T* sK = ring + (j % STAGES) * STAGE_ELEMS;
    const T* sV = sK + BK * KSTRIDE;
    const int t0 = a + j * BK;

    // scores of this lane's KPL keys (rows lane + 32 r) against this warp's
    // head: one pass over the dims, each q chunk read once
    const float* qh = sQ + warp * D;
    float dot[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) dot[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < VPR; ++c) {
      float kf[KPL][VN];
#pragma unroll
      for (int r = 0; r < KPL; ++r)
        load_vec<T, VN>(sK + (lane + 32 * r) * KSTRIDE + c * VN, kf[r]);
#pragma unroll
      for (int x = 0; x < VN; ++x) {
        const float qv = qh[c * VN + x];
#pragma unroll
        for (int r = 0; r < KPL; ++r) dot[r] = fmaf(qv, kf[r][x], dot[r]);
      }
    }
    float s[KPL];
    float m_blk = -INFINITY;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      float x = dot[r];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      s[r] = t0 + lane + 32 * r < e ? x : -INFINITY;
      m_blk = fmaxf(m_blk, s[r]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, off));
    const float m_new = fmaxf(m, m_blk);          // finite: t0 < e
    const float corr = expf(m - m_new);           // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const float p = t0 + lane + 32 * r < e ? expf(s[r] - m_new) : 0.f;
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
    const int nk = pv_lane ? min(BK, e - t0) : 0;
    for (int jj = 0; jj < nk; ++jj) {
      const float p = sP[warp * BK + jj];
      float vf[DL];
      load_vec<T, DL>(sV + jj * D + lane * DL, vf);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
    __syncwarp();                     // sP read before the next tile writes it
    m = m_new;
  }
  cp_async_wait<0>();                 // no copy outlives the CTA's ring

  // this CTA's partial: m = -inf where the split held no live key
  if (warp < G) {
    if (lane == 0) {
      sM[warp] = m;
      sL[warp] = l;
    }
    if (pv_lane) {
#pragma unroll
      for (int i = 0; i < DL; ++i) sAcc[warp * D + lane * DL + i] = acc[i];
    }
  }
  finish<T>(cluster, sM, sL, sAcc, G, D, out + ((size_t)b * Hq + hk * G) * D,
            lse == nullptr ? nullptr : lse + (size_t)b * Hq + hk * G,
            scratch, counters, b * Hkv + hk,
            reinterpret_cast<float*>(smem_raw), L::bytes(G));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// d += a * b: m16n8k16, bf16 in, f32 accumulate (registers only: the
// compiler may move it among the fragment reads)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t x = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t y = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return x | (y << 16);
}

// bf16, D in {32, 64, 112, 128, 256}. grid (n_split, Hkv, B) in clusters
// along x; MMA_WARPS warps. Lane (g, t) = (lane / 4, lane % 4) holds, in
// every m16n8 accumulator, rows (query heads) g and g + 8 and columns 2t,
// 2t + 1 (keys of S, dims of O). Warp w takes keys 16 w ... 16 w + 15 of
// each tile: S = Q·Kᵀ as two n8 tiles, the online softmax over its 16 keys
// (its own m and l per head), O += P·V with P from S's accumulators, V by
// ldmatrix.trans. The warps' partials are merged in shared memory into
// the CTA's, which joins the cluster merge (finish). At D = 256 the
// DSPLIT warps of a slab share it: each takes KSTEPS / DSPLIT of Q·Kᵀ's
// k-steps (in two chains, summed), the slab's warps add their partial
// scores through shared memory in a fixed order (a named barrier a slab),
// and each sums P·V into its D / DSPLIT dims of O (64 accumulators, so
// its 8 k-steps of Q stay in registers too).
// Tiles come by 16-byte cp.async from every thread into padded rows. A
// warp whose 16 keys of a tile all lie past the range skips the tile.
template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ valid_len,
                  __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                  float softcap, int window, float scale, int off,
                  int S_glob, float* __restrict__ lse,
                  float* __restrict__ scratch, int* __restrict__ counters) {
  using L = MmaLayout<D>;
  using T = __nv_bfloat16;
  constexpr int STAGES = L::STAGES;
  constexpr int ST = L::ST;
  constexpr int KSTEPS = D / 16;              // k16 steps of Q·Kᵀ
  constexpr int NT = D / 8 / L::DSPLIT;       // n8 tiles of O a warp holds
  constexpr int KSW = KSTEPS / L::DSPLIT;     // k16 steps of Q·Kᵀ a warp takes

  cg::cluster_group cluster = cg::this_cluster();
  const int G = Hq / Hkv;
  const int n_split = gridDim.x;
  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % MMA_WARPS;          // its 16 keys of a tile
  const int part = warp / MMA_WARPS;          // its share of k-steps and dims

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  int a, e;
  split_range(valid_len[b], S_glob, window, off, S, sp, n_split, a, e);
  const int ntiles = e > a ? (e - a + MMA_BK - 1) / MMA_BK : 0;
  auto issue = [&](int j) {
    T* sK = ring + (j % STAGES) * L::STAGE_ELEMS;
    issue_tile<T, D, MMA_BK, ST, ST>(sK, sK + MMA_BK * ST, k, v, b, hk, S,
                                     Hkv, a + j * MMA_BK, e);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    cp_async_commit();
  }

  // Q as A fragments of this warp's k-steps (rows = this kv head's query
  // heads, zero past G)
  const T* qh = q + ((size_t)b * Hq + hk * G) * D;
  uint32_t qf[KSW][4];
#pragma unroll
  for (int kk = 0; kk < KSW; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1);
      const int col = (part * KSW + kk) * 16 + 2 * t + 8 * (r >> 1);
      qf[kk][r] = row < G
          ? *reinterpret_cast<const uint32_t*>(qh + (size_t)row * D + col)
          : 0u;
    }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                    // this thread's columns only
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  const int key0 = 16 * slab;                 // this warp's keys in a tile
  const int dim0 = part * (D / L::DSPLIT);    // its dims of O
  // the slabs' partial scores (DSPLIT > 1), 8 floats a lane a warp
  float* xch = reinterpret_cast<float*>(smem_raw + L::RING_BYTES);
  const int kr = ((lane >> 4) & 1) * 8 + (lane & 7);   // ldmatrix rows
  const int kc = ((lane >> 3) & 1) * 8;
  const int vr = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int vc = (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<STAGES - 2>();      // tile j has landed for this thread
    __syncthreads();                  // ... for every thread; tile j-1 consumed
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_async_commit();
    // a slab past the range's end has no live key: its scores would all be
    // masked, leaving m, l and O as they are (bit for bit)
    if (a + j * MMA_BK + key0 >= e) continue;
    const T* sK = ring + (j % STAGES) * L::STAGE_ELEMS;
    const T* sV = sK + MMA_BK * ST;

    // at D = 256 the k-steps go round-robin into two accumulators
    // (shorter chains of dependent products), summed in order
    constexpr int CH = KSTEPS > 8 ? 2 : 1;
    float sch[CH][2][4];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) sch[c][i >> 2][i & 3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSW; ++kk) {
      const int ks = part * KSW + kk;
      uint32_t kb[4];
      uint32_t (&qa)[4] = qf[kk];
      float (&sc)[2][4] = sch[kk % CH];
      ldmatrix_x4(kb, sK + (key0 + kr) * ST + ks * 16 + kc);
      mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma_bf16(sc[1], qa, kb[2], kb[3]);
    }
    float (&s)[2][4] = sch[0];
#pragma unroll
    for (int c = 1; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i >> 2][i & 3] += sch[c][i >> 2][i & 3];
    if constexpr (L::DSPLIT > 1) {
      // the slab's scores: its warps' partials added in warp order
      float* own = xch + (slab * L::DSPLIT + part) * 256 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) own[32 * i] = s[i >> 2][i & 3];
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slab),
                   "r"(32 * L::DSPLIT) : "memory");
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* x = xch + slab * L::DSPLIT * 256 + lane + 32 * i;
        float sum = x[0];
#pragma unroll
        for (int pp = 1; pp < L::DSPLIT; ++pp) sum += x[256 * pp];
        s[i >> 2][i & 3] = sum;
      }
    }
    const int t0 = a + j * MMA_BK + key0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nt][r] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = t0 + 8 * nt + 2 * t + (r & 1) < e ? x : -INFINITY;
        s[nt][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float m_use[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // no live key yet: every weight so far and now is 0
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = expf(m[h] - m_use[h]);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = expf(s[nt][r] - m_use[r >> 1]);
        s[nt][r] = pr;
        l[r >> 1] += pr;
      }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] *= corr[r >> 1];
    // P (rows g, g + 8; keys 2t, 2t + 1 and 8 + 2t, 9 + 2t) as an A fragment
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, sV + (key0 + vr) * ST + dim0 + np * 16 + vc);
      mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();                 // no copy outlives the ring
  __syncthreads();                    // every warp done with it: reuse it

  // this warp's partial (its rows g, g + 8 below G); l summed over the quad
  float* sM = reinterpret_cast<float*>(smem_raw);
  float* sL = sM + MMA_WARPS * G;
  float* sAcc = sL + MMA_WARPS * G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = g + 8 * h;
    if (row < G) {
      if (t == 0 && dim0 == 0) {      // a slab's warps hold the same m, l
        sM[slab * G + row] = m[h];
        sL[slab * G + row] = l[h];
      }
      float* o = sAcc + (size_t)(slab * G + row) * D + dim0 + 2 * t;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        o[8 * i] = acc[i][2 * h];
        o[8 * i + 1] = acc[i][2 * h + 1];
      }
    }
  }
  __syncthreads();
  // the CTA's partial: the warps' merged as the cluster merges CTAs'
  float* cM = sAcc + MMA_WARPS * G * D;
  float* cL = cM + G;
  float* cAcc = cL + G;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int row = idx / D;
    float mw[MMA_WARPS];
    float mg = -INFINITY;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      mw[w] = sM[w * G + row];
      mg = fmaxf(mg, mw[w]);
    }
    const float m_safe = isfinite(mg) ? mg : 0.f;
    float lsum = 0.f;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float c = isfinite(mw[w]) ? expf(mw[w] - m_safe) : 0.f;
      lsum += c * sL[w * G + row];
      o += c * sAcc[(size_t)(w * G + row) * D + idx % D];
    }
    cAcc[idx] = o;
    if (idx % D == 0) {
      cM[row] = mg;
      cL[row] = lsum;
    }
  }
  finish<T>(cluster, cM, cL, cAcc, G, D, out + ((size_t)b * Hq + hk * G) * D,
            lse == nullptr ? nullptr : lse + (size_t)b * Hq + hk * G,
            scratch, counters, b * Hkv + hk,
            reinterpret_cast<float*>(smem_raw), L::bytes(G));
}

// One launch of `kern` on grid (n_split, Hkv, B) in clusters of `cluster`
// CTAs along x.
template <typename... P, typename... A>
int cluster_launch(void (*kern)(P...), int n_split, int cluster, int Hkv,
                   int B, int threads, int smem, cudaStream_t stream,
                   A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();     // reported here; the next launch must not see it
    return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The arguments every instance takes after its kernel's own.
struct Args {
  const void *q, *k, *v;
  const int* valid_len;
  void* out;
  int B, S, Hq, Hkv, n_split, cluster;
  float softcap;
  int window;
  float scale;
  int off, S_glob;
  float* lse;
  float* scratch;
  int* counters;
  cudaStream_t stream;
};

template <int D, typename T>
int launch_ffma(const Args& a) {
  const int G = a.Hq / a.Hkv;
  return cluster_launch(decode_ffma_kernel<D, T>, a.n_split, a.cluster, a.Hkv,
                        a.B, 32 * (G > MIN_WARPS ? G : MIN_WARPS),
                        Layout<D, T>::bytes(G), a.stream,
                        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                        static_cast<const T*>(a.v), a.valid_len,
                        static_cast<T*>(a.out), a.S, a.Hq, a.Hkv, a.softcap,
                        a.window, a.scale, a.off, a.S_glob, a.lse, a.scratch,
                        a.counters);
}

template <int D>
int launch_mma(const Args& a) {
  using T = __nv_bfloat16;
  return cluster_launch(decode_mma_kernel<D>, a.n_split, a.cluster, a.Hkv,
                        a.B, 32 * MmaLayout<D>::WARPS,
                        MmaLayout<D>::bytes(a.Hq / a.Hkv),
                        a.stream, static_cast<const T*>(a.q),
                        static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                        a.valid_len, static_cast<T*>(a.out), a.S, a.Hq, a.Hkv,
                        a.softcap, a.window, a.scale, a.off, a.S_glob, a.lse,
                        a.scratch, a.counters);
}

}  // namespace

// One launch over a cache shard: q (B,1,Hq,D), caches (B,S_loc,Hkv,D) at
// global positions [off, off + S_loc) of a cache of S_glob, valid_len (B,)
// i32 -> out (B,1,Hq,D) and, when lse is not null, lse (B,Hq) f32; n_split
// CTAs a (sequence, kv head), in one cluster (cluster = n_split) or,
// past one cluster, in clusters of one (cluster = 1): then scratch holds
// B Hkv n_split Hq/Hkv (D + 4) f32 and counters B Hkv int32 that are 0
// (each launch leaves them 0). Returns 0, a cudaError_t code (the
// attribute call's or the launch's: a cluster the card refuses), -1 for
// an unsupported head dim, -2 for an unsupported group size (Hq/Hkv must
// be in [1, 16]), or -3 for a split count outside [1, MAX_SPLITS], a
// cluster size other than n_split or 1, or clusters of one without
// scratch and counters.
extern "C" int k4_decode_attention_shard(const void* q, const void* k,
                                         const void* v, const void* valid_len,
                                         void* out, void* lse, void* scratch,
                                         void* counters, int B, int S_loc,
                                         int Hq, int Hkv, int D, int is_bf16,
                                         int n_split, int cluster,
                                         float softcap, int window,
                                         float scale, int off, int S_glob,
                                         void* stream) {
  const int G = Hq / Hkv;
  if (G < 1 || G > MAX_G || G * Hkv != Hq) return -2;
  if (n_split < 1 || n_split > MAX_SPLITS ||
      (cluster != n_split && cluster != 1) ||
      (n_split > cluster && (scratch == nullptr || counters == nullptr)))
    return -3;
  const Args a{q, k, v, static_cast<const int*>(valid_len), out, B, S_loc,
               Hq, Hkv, n_split, cluster, softcap, window, scale, off, S_glob,
               static_cast<float*>(lse), static_cast<float*>(scratch),
               static_cast<int*>(counters), static_cast<cudaStream_t>(stream)};
  switch (is_bf16 ? D : -D) {
    case 32: return launch_mma<32>(a);
    case 64: return launch_mma<64>(a);
    case 112: return launch_mma<112>(a);
    case 128: return launch_mma<128>(a);
    case 256: return launch_mma<256>(a);
    case -32: return launch_ffma<32, float>(a);
    case -64: return launch_ffma<64, float>(a);
    case -112: return launch_ffma<112, float>(a);
    case -128: return launch_ffma<128, float>(a);
    case -256: return launch_ffma<256, float>(a);
    default: return -1;
  }
}

// One launch over the whole cache: q (B,1,Hq,D), caches (B,S,Hkv,D),
// valid_len (B,) i32 -> out (B,1,Hq,D); the shard mode's kernel with one
// shard of S and no lse.
extern "C" int k4_decode_attention(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* out, void* scratch, void* counters,
                                   int B, int S, int Hq, int Hkv, int D,
                                   int is_bf16, int n_split, int cluster,
                                   float softcap, int window, float scale,
                                   void* stream) {
  return k4_decode_attention_shard(q, k, v, valid_len, out, nullptr, scratch,
                                   counters, B, S, Hq, Hkv, D, is_bf16,
                                   n_split, cluster, softcap, window, scale,
                                   0, S, stream);
}

extern "C" const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
