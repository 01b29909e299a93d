// flash_decode for Hopper (sm_90a), hand-written: one cluster launch a call.
//
// Replaces the TPU kernel `_decode_kernel` / `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py:75 of the JAX reference package): one
// query token per sequence against a KV cache,
//   q (B,H,D), k/v (B,S,KVH,D), kv_len -> o (B,H,D),
// keys at positions >= kv_len masked, online softmax in fp32. As in the
// reference, kv_len may live on the device (there a scalar in SMEM, here an
// int the kernel reads), so one launch, or one captured CUDA graph, serves
// every position.
//
// What bounds it on an H100: bytes. A (b, kv head) reads 2 * kv_len * D cache
// elements and does about one FLOP a byte, far below the card's 295. At the
// serving path's sizes (B=4, KVH=4, D=64, kv_len <= 543, bf16: 2.3 MB) that is
// 0.7 us, less than a launch, so what is left is latency: the launch, the
// first tile's trip from memory, and any step that waits on another. The
// design answers both:
//   * One launch and no scratch. The grid is one thread-block cluster of c
//     blocks per (b, kv head, 16-row fragment of the group's query heads).
//     Every warp walks its own tiles of the cache with its own online-softmax
//     state (m, l, acc in fp32 registers); the warps of a block merge in warp
//     order through shared memory, then, after cluster.sync(), the ranks
//     merge in rank order 0..c-1 through distributed shared memory, each rank
//     normalising and writing its share of the fragment's output in the
//     input dtype. A second cluster.sync() keeps every rank resident while
//     another reads it. Nothing but q, the cache and o touches device memory;
//     no atomics, so repeated launches are bit-identical.
//   * A plan over the cache length S, not over kv_len (`decode_plan` in
//     kernels/flash_decode.py): tile t of the cache belongs to rank t mod c
//     and, within it, to warp (t / c) mod WARPS, so the work spreads over the
//     ranks whatever kv_len is, and the grid does not depend on it. Tiles at
//     or past kv_len are skipped; a warp or block with none keeps the empty
//     state (m = NEG_INF, l = 0), which adds exactly 0 to a merge (NEG_INF is
//     finite, so exp2(m_r - m) is 0 or 1, never NaN).
//   * No block barrier in the walk. Each warp fills its own 3-stage cp.async
//     ring (the next tiles in flight while this one's products run) and waits
//     on it with __syncwarp; rows at or past kv_len arrive as zeros, so no
//     stale cache value reaches a product.
//   * bf16 on the tensor cores (`mma.sync.m16n8k16`, helpers of
//     `mma_tile.cuh` shared with K1 and K2): the G query heads are the A
//     fragment's 16 rows (rows >= G zero; G > 16 takes one cluster per 16-row
//     fragment), read once into registers; K by ldmatrix, V by
//     ldmatrix.trans, straight from the bf16 tiles; P goes from the score
//     accumulators to the A operand of P V in registers (rounded to bf16 as
//     in K1). Only the tile that holds kv_len is masked (K1's
//     `softmax_step<MASK>`). 32 keys a tile at every head dim: two blocks
//     share an SM at D <= 64, one at D = 128 (where 16-key tiles, two blocks
//     an SM, were 14 % slower over a 32k cache on the card).
//   * fp32 keeps IEEE FMA products (TF32 would miss 2e-5): a lane per key for
//     the scores, a lane per 32nd column for P V, loads straight from L2; the
//     same tile, plan, walk and merges.
//   * The host path: the kernel's attributes are set once per instance and
//     device, not per call; the caller allocates only the output.
//
// The probabilities are rounded to bf16 for P V with a bf16 cache (fp32
// inside with fp32), so a bf16 result agrees with the fp32 plain version to
// bf16 rounding. A device kv_len outside [1, S] is clamped into it, so no
// read leaves the cache.
//
// The partial entry (`flash_decode_partial_fwd`) serves a cache whose
// sequence is sharded over several ranks: each rank holds S rows of it and
// attends over the first kv_len of them, and the ranks' results are then
// combined by their log-sum-exps (`kernels.ops.combine_partials`, the
// flash-decode split). It is the same kernel, plan, walk and merges, one
// launch a call; only the end differs. The last merge (over the cluster's
// ranks) already holds each row's m and l, so instead of dividing them away
// it writes the normalised output in fp32 (out = acc / l, whatever the
// cache's dtype) and lse = (m + log2 l) ln 2, the natural-log log-sum-exp of
// the scaled scores. That costs 2 x the bf16 output's bytes plus 4 bytes a
// head, and no pass. kv_len may be 0 here (a rank whose shard holds no
// valid key; a device kv_len is clamped into [0, S], never up to 1): every
// warp then walks no tile and keeps the empty state (m = NEG_INF, l = 0),
// and the row is written as out = 0, lse = NEG_INF, which weighs exactly 0
// in the combine.
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// the output and the stream, and gets cudaGetLastError() back.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;              // warps a block, each walking its own tiles
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;              // query heads a fragment: the mma's 16 rows
constexpr int STAGES = 3;             // bf16: each warp's cp.async ring
constexpr int KEYS = 32;              // keys a tile (fp32: one a lane)
constexpr int MAX_CLUSTER = 16;       // 8 is portable; 16 where the card allows it

// A warp's (and the block's) merge state in shared memory, fp32:
// m[ROWS] (log2 units), l[ROWS], acc[ROWS][D].
template <int D> __host__ __device__ constexpr int part_floats() { return 2 * ROWS + ROWS * D; }

template <int D> __host__ __device__ constexpr int mma_warp_bytes() {
  return STAGES * 2 * KEYS * (D + 8) * (int)sizeof(__nv_bfloat16);
}
template <int D> __host__ __device__ constexpr size_t mma_smem() {
  return (size_t)WARPS * mma_warp_bytes<D>() + part_floats<D>() * sizeof(float);
}
template <int D> __host__ __device__ constexpr size_t fma_smem() {
  return (size_t)(ROWS * D + (WARPS + 1) * part_floats<D>()) * sizeof(float);
}

constexpr float LN2 = 0.6931471805599453f;

// The whole-cache entry reads kv_len in [1, S], the partial entry in [0, S].
__device__ __forceinline__ int read_kv_len(const int* dev, int host, int lo, int S) {
  return min(max(dev ? *dev : host, lo), S);
}

// The block's state in `blk`, merged over the warps' states (`parts`, `stride`
// floats apart) in warp order. Rows >= rows are padding and are skipped.
template <int D>
__device__ __forceinline__ void merge_warps(const float* parts, int stride, float* blk, int rows) {
  for (int u = threadIdx.x; u < rows * D / 4; u += THREADS) {
    const int row = u / (D / 4), col = (u % (D / 4)) * 4;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, parts[w * stride + row]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* p = parts + w * stride;
      const float e = exp2f(p[row] - m);
      const float4 x = *reinterpret_cast<const float4*>(p + 2 * ROWS + row * D + col);
      l += p[ROWS + row] * e;
      a.x += x.x * e, a.y += x.y * e, a.z += x.z * e, a.w += x.w * e;
    }
    *reinterpret_cast<float4*>(blk + 2 * ROWS + row * D + col) = a;
    if (col == 0) {
      blk[row] = m;
      blk[ROWS + row] = l;
    }
  }
}

__device__ __forceinline__ void store4(float* o, float4 x) { *reinterpret_cast<float4*>(o) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 x) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// After cluster.sync(): rank `rank` merges its share of the fragment's
// rows x D outputs over the ranks' block states in rank order 0..c-1 (through
// distributed shared memory), normalises and writes them; o is the
// fragment's row 0. Where `lse` is not null (the partial entry) each row's
// natural-log log-sum-exp goes there too, NEG_INF for a row with no key.
template <typename T, int D>
__device__ __forceinline__ void merge_ranks(cg::cluster_group& cluster, float* blk, T* o,
                                            float* lse, int rows, int rank, int c) {
  const int units = rows * D / 4;
  for (int u = rank * units / c + threadIdx.x; u < (rank + 1) * units / c; u += THREADS) {
    const int row = u / (D / 4), col = (u % (D / 4)) * 4;
    float m = NEG_INF;
    for (int src = 0; src < c; ++src) m = fmaxf(m, cluster.map_shared_rank(blk, src)[row]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < c; ++src) {
      const float* p = cluster.map_shared_rank(blk, src);
      const float e = exp2f(p[row] - m);
      const float4 x = *reinterpret_cast<const float4*>(p + 2 * ROWS + row * D + col);
      l += p[ROWS + row] * e;
      a.x += x.x * e, a.y += x.y * e, a.z += x.z * e, a.w += x.w * e;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    store4(o + row * D + col, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    if (lse && col == 0) lse[row] = l > 0.f ? (m + log2f(l)) * LN2 : NEG_INF;
  }
}

// Where a block stands: its (b, kv head, fragment), rank, the fragment's
// live rows, and the tiles of its warp: tile first + j * stride for j < n.
struct Walk {
  int b, kvh, f, rows, rank, c, kv_len, first, stride, n;
};

__device__ __forceinline__ Walk walk_of(const cg::cluster_group& cluster, const int* kv_len_dev,
                                        int kv_len_host, int min_len, int S, int H, int KVH) {
  Walk w;
  w.c = (int)cluster.num_blocks();
  w.rank = (int)cluster.block_rank();
  const int G = H / KVH, frags = (G + ROWS - 1) / ROWS, id = blockIdx.x / w.c;
  w.f = id % frags;
  w.kvh = (id / frags) % KVH;
  w.b = id / (frags * KVH);
  w.rows = min(ROWS, G - w.f * ROWS);
  w.kv_len = read_kv_len(kv_len_dev, kv_len_host, min_len, S);
  const int live = (w.kv_len + KEYS - 1) / KEYS;    // tiles holding a key below kv_len
  w.first = w.rank + w.c * (int)(threadIdx.x / 32);
  w.stride = w.c * WARPS;
  w.n = w.first < live ? (live - w.first + w.stride - 1) / w.stride : 0;
  return w;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

// Thread (g = lane/4, t = lane%4) of a warp holds query rows g and g + 8 of
// the fragment in the mma fragment layout. PARTIAL: o is fp32 and lse is
// written (the partial entry); else o is bf16 and lse is null.
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_decode_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_len_dev, int kv_len_host,
                 int S, int H, int KVH, float scale_log2) {
  constexpr int BN = KEYS, LD = D + 8, NT = BN / 8;
  constexpr int WARP_ELEMS = mma_warp_bytes<D>() / (int)sizeof(__nv_bfloat16);
  static_assert(part_floats<D>() * (int)sizeof(float) <= mma_warp_bytes<D>(),
                "a warp's merge state fits in its ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Walk w = walk_of(cluster, kv_len_dev, kv_len_host, PARTIAL ? 0 : 1, S, H, KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * WARP_ELEMS;
  float* blk = reinterpret_cast<float*>(smem_raw + WARPS * mma_warp_bytes<D>());
  const size_t head0 = (size_t)w.b * H + (size_t)w.kvh * (H / KVH) + w.f * ROWS;
  const __nv_bfloat16* kb = k + (size_t)w.b * S * KVH * D;
  const __nv_bfloat16* vb = v + (size_t)w.b * S * KVH * D;

  auto load = [&](int j) {
    __nv_bfloat16* Ks = ring + (j % STAGES) * 2 * BN * LD;
    const int n0 = (w.first + j * w.stride) * BN;
    cp_async_rows<D, LD, BN, 32>(Ks, kb, n0, w.kv_len, KVH, w.kvh, lane);
    cp_async_rows<D, LD, BN, 32>(Ks + BN * LD, vb, n0, w.kv_len, KVH, w.kvh, lane);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < w.n) load(j);
    cp_async_commit();
  }

  // Q's A fragments straight from global memory (rows >= rows are zero):
  // a[0]/a[2] row g, a[1]/a[3] row g + 8, columns 16kk + 2t (+ 8 for a[2..3]).
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* qa = q + (head0 + g) * D + 2 * t;
    const __nv_bfloat16* qb = qa + 8 * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = g < w.rows ? *reinterpret_cast<const uint32_t*>(qa + kk * 16) : 0u;
      qf[kk][1] = g + 8 < w.rows ? *reinterpret_cast<const uint32_t*>(qb + kk * 16) : 0u;
      qf[kk][2] = g < w.rows ? *reinterpret_cast<const uint32_t*>(qa + kk * 16 + 8) : 0u;
      qf[kk][3] = g + 8 < w.rows ? *reinterpret_cast<const uint32_t*>(qb + kk * 16 + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < w.n; ++j) {
    cp_async_wait<STAGES - 2>();         // this lane's pieces of tile j are in
    __syncwarp();                        // the warp's are; the stage of tile j - 1 is free
    if (j + STAGES - 1 < w.n) load(j + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* Ks = ring + (j % STAGES) * 2 * BN * LD;
    const __nv_bfloat16* Vs = Ks + BN * LD;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_abt<D, LD, NT>(s, qf, Ks, lane);             // S = Q K^T

    const int n0 = (w.first + j * w.stride) * BN;
    if (n0 + BN > w.kv_len)                          // the tile that holds kv_len
      softmax_step<true, NT, D>(s, acc, m_run, l_run, scale_log2, 0, n0 + t * 2, w.kv_len, 0);
    else
      softmax_step<false, NT, D>(s, acc, m_run, l_run, scale_log2, 0, n0 + t * 2, w.kv_len, 0);
    mma_xt<D, LD, BN / 16>(acc, s, Vs, lane);        // acc += P V
  }
  cp_async_wait<0>();
  __syncwarp();                          // the ring is idle: it takes the warp's state

  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (t == 0) {
    part[g] = m_run[0];
    part[g + 8] = m_run[1];
    part[ROWS + g] = l_run[0];
    part[ROWS + g + 8] = l_run[1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(part + 2 * ROWS + (g + r * 8) * D + i * 8 + t * 2) =
          make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
  __syncthreads();
  merge_warps<D>(reinterpret_cast<const float*>(smem_raw), WARP_ELEMS / 2, blk, w.rows);
  cluster.sync();                        // every rank's block state is visible to the cluster
  if constexpr (PARTIAL)
    merge_ranks<float, D>(cluster, blk, static_cast<float*>(o) + head0 * D, lse + head0, w.rows,
                          w.rank, w.c);
  else
    merge_ranks<__nv_bfloat16, D>(cluster, blk, static_cast<__nv_bfloat16*>(o) + head0 * D,
                                  nullptr, w.rows, w.rank, w.c);
  cluster.sync();                        // no rank leaves while another reads its state
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs, loads straight from L2
// ---------------------------------------------------------------------------

template <int D, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_decode_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, void* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_len_dev, int kv_len_host, int S, int H, int KVH,
                 float scale_log2) {
  constexpr int BN = KEYS, J = D / 32;
  static_assert(ROWS * BN <= part_floats<D>(), "a warp's P fits in its part");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Walk w = walk_of(cluster, kv_len_dev, kv_len_host, PARTIAL ? 0 : 1, S, H, KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = reinterpret_cast<float*>(smem_raw);        // [ROWS][D], rows >= rows zero
  float* parts = qs + ROWS * D;                          // WARPS x part_floats<D>
  float* part = parts + warp * part_floats<D>();         // P [ROWS][BN] in the walk
  float* blk = parts + WARPS * part_floats<D>();
  const size_t head0 = (size_t)w.b * H + (size_t)w.kvh * (H / KVH) + w.f * ROWS;
  const size_t row_stride = (size_t)KVH * D;             // cache positions are KVH * D apart
  const float* kb = k + (size_t)w.b * S * row_stride + (size_t)w.kvh * D;
  const float* vb = v + (size_t)w.b * S * row_stride + (size_t)w.kvh * D;

  for (int i = threadIdx.x; i < ROWS * D; i += THREADS)
    qs[i] = i / D < w.rows ? q[head0 * D + i] : 0.f;
  __syncthreads();

  float m_run[ROWS], l_run[ROWS], acc[ROWS][J];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[r][jj] = 0.f;
  }

  for (int j = 0; j < w.n; ++j) {
    const int n0 = (w.first + j * w.stride) * BN, key = n0 + lane;
    const bool live = key < w.kv_len;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    if (live) {
      const float4* kr = reinterpret_cast<const float4*>(kb + key * row_stride);
#pragma unroll 4
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < w.rows) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + 4 * d4);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < w.rows) {
        const float x = live ? s[r] * scale_log2 : NEG_INF;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[r], mx);
        const float alpha = exp2f(m_run[r] - m_new);
        const float p = exp2f(x - m_new);
        m_run[r] = m_new;
        l_run[r] = l_run[r] * alpha + p;
        part[r * BN + lane] = p;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) acc[r][jj] *= alpha;
      }
    }
    __syncwarp();                        // the warp's P is in shared memory
    const int keys = min(BN, w.kv_len - n0);
#pragma unroll 4
    for (int kk = 0; kk < keys; ++kk) {
      const float* vr = vb + (size_t)(n0 + kk) * row_stride + lane;
      float vv[J];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) vv[jj] = vr[32 * jj];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < w.rows) {
          const float p = part[r * BN + kk];
#pragma unroll
          for (int jj = 0; jj < J; ++jj) acc[r][jj] = fmaf(p, vv[jj], acc[r][jj]);
        }
      }
    }
    __syncwarp();                        // P is read before the next tile rewrites it
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float l = l_run[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      part[r] = m_run[r];
      part[ROWS + r] = l;
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) part[2 * ROWS + r * D + lane + 32 * jj] = acc[r][jj];
  }
  __syncthreads();
  merge_warps<D>(parts, part_floats<D>(), blk, w.rows);
  cluster.sync();
  merge_ranks<float, D>(cluster, blk, static_cast<float*>(o) + head0 * D,
                        PARTIAL ? lse + head0 : nullptr, w.rows, w.rank, w.c);
  cluster.sync();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;             // the partial entry's; null for the whole-cache entry
  const int* kv_len_dev;
  int kv_len_host, S, H, KVH;
  float scale_log2;
  int cluster, grid_x;
  cudaStream_t stream;
  bool partial;
};

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, void*, float*, const int*, int, int, int,
                          int, float);

// The kernel instance of a dtype, head dim and entry, and its shared memory.
template <typename T, int D, bool PARTIAL> struct Kernel;
template <int D, bool PARTIAL> struct Kernel<__nv_bfloat16, D, PARTIAL> {
  static KernelFn<__nv_bfloat16> fn() { return flash_decode_mma<D, PARTIAL>; }
  static constexpr size_t smem = mma_smem<D>();
};
template <int D, bool PARTIAL> struct Kernel<float, D, PARTIAL> {
  static KernelFn<float> fn() { return flash_decode_fma<D, PARTIAL>; }
  static constexpr size_t smem = fma_smem<D>();
};

// The kernel's attributes (dynamic shared memory, clusters of 16), set once
// per instance and device: not on every call.
template <typename T, int D, bool PARTIAL>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (ready.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  using K = Kernel<T, D, PARTIAL>;
  if ((err = cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)K::smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(K::fn(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return err;
  ready.fetch_or(bit, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int D>
cudaLaunchConfig_t config(const Args& a, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid_x, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Kernel<T, D, false>::smem;   // the same for both entries
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int D, bool PARTIAL>
cudaError_t launch_entry(const Args& a) {
  cudaError_t err = prepare<T, D, PARTIAL>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<T, D>(a, attr);
  if ((err = cudaLaunchKernelEx(&cfg, Kernel<T, D, PARTIAL>::fn(), static_cast<const T*>(a.q),
                                static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.o,
                                a.lse, a.kv_len_dev, a.kv_len_host, a.S, a.H, a.KVH,
                                a.scale_log2)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  return a.partial ? launch_entry<T, D, true>(a) : launch_entry<T, D, false>(a);
}

template <typename T, int D, bool PARTIAL>
cudaError_t max_clusters_of(const Args& a, int* out) {
  cudaError_t err = prepare<T, D, PARTIAL>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<T, D>(a, attr);
  return cudaOccupancyMaxActiveClusters(out, Kernel<T, D, PARTIAL>::fn(), &cfg);
}

template <typename T, int D>
cudaError_t max_clusters(const Args& a, int* out) {
  return a.partial ? max_clusters_of<T, D, true>(a, out) : max_clusters_of<T, D, false>(a, out);
}

// Does the plan's grid give each (b, kv head, fragment) one cluster of
// `cluster` blocks, with this kernel's tile?
bool covers(int B, int S, int H, int KVH, int D, int tile, int cluster, int grid_x) {
  if (B < 1 || S < 1 || KVH < 1 || H < KVH || H % KVH != 0) return false;
  if (cluster < 1 || cluster > MAX_CLUSTER || tile != KEYS) return false;
  if (D != 32 && D != 64 && D != 128) return false;
  const long long frags = (H / KVH + ROWS - 1) / ROWS;
  return (long long)grid_x == (long long)B * KVH * frags * cluster &&
         (long long)B * KVH * frags * cluster <= 0x7fffffffLL;
}

template <typename T>
int dispatch(const Args& a, int D) {
  switch (D) {
    case 32: return (int)launch<T, 32>(a);
    case 64: return (int)launch<T, 64>(a);
    case 128: return (int)launch<T, 128>(a);
    default: return -1;
  }
}

template <typename T>
int dispatch_max_clusters(const Args& a, int D, int* out) {
  switch (D) {
    case 32: return (int)max_clusters<T, 32>(a, out);
    case 64: return (int)max_clusters<T, 64>(a, out);
    case 128: return (int)max_clusters<T, 128>(a, out);
    default: return -1;
  }
}

// Runs fn on `device`, restoring the calling thread's device after.
template <typename Fn>
int on_device(int device, Fn fn) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const int code = fn();
  if (cur != device) cudaSetDevice(cur);
  return code;
}

}  // namespace

// kv_len from `kv_len_dev` (one int on the card, read by the kernel) when it
// is not NULL, else `kv_len_host`. `tile`, `cluster` and `grid_x` are the
// plan's (`decode_plan`). Returns 0, a cudaError_t, or -1 for arguments the
// kernels do not take (head dims 32, 64, 128; H a multiple of KVH; a host
// kv_len in [1, S]; a plan whose grid does not give each (b, kv head,
// fragment) one cluster with this kernel's tile).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                                const int* kv_len_dev, int kv_len_host, int B, int S, int H,
                                int KVH, int D, float scale, int is_bf16, int tile, int cluster,
                                int grid_x, int device, void* stream) {
  if (!covers(B, S, H, KVH, D, tile, cluster, grid_x)) return -1;
  if (!kv_len_dev && (kv_len_host < 1 || kv_len_host > S)) return -1;
  const Args a{q, k, v, o, nullptr, kv_len_dev, kv_len_host, S, H, KVH, scale * LOG2E, cluster,
               grid_x, static_cast<cudaStream_t>(stream), false};
  return on_device(device, [&] {
    return is_bf16 ? dispatch<__nv_bfloat16>(a, D) : dispatch<float>(a, D);
  });
}

// The partial entry: o (B,H,D) fp32, normalised over this cache's first
// kv_len rows, and lse (B,H) fp32, their natural-log log-sum-exp; kv_len in
// [0, S] (a device kv_len is clamped into it), a row with no key giving
// o = 0 and lse = NEG_INF. Otherwise as flash_decode_fwd.
extern "C" int flash_decode_partial_fwd(const void* q, const void* k, const void* v, float* o,
                                        float* lse, const int* kv_len_dev, int kv_len_host,
                                        int B, int S, int H, int KVH, int D, float scale,
                                        int is_bf16, int tile, int cluster, int grid_x,
                                        int device, void* stream) {
  if (!covers(B, S, H, KVH, D, tile, cluster, grid_x) || !lse) return -1;
  if (!kv_len_dev && (kv_len_host < 0 || kv_len_host > S)) return -1;
  const Args a{q, k, v, o, lse, kv_len_dev, kv_len_host, S, H, KVH, scale * LOG2E, cluster,
               grid_x, static_cast<cudaStream_t>(stream), true};
  return on_device(device, [&] {
    return is_bf16 ? dispatch<__nv_bfloat16>(a, D) : dispatch<float>(a, D);
  });
}

// cudaOccupancyMaxActiveClusters of this launch (of the partial entry's
// instance where `partial`), into *out: how many of its clusters the card
// holds at once.
extern "C" int flash_decode_max_clusters(int B, int S, int H, int KVH, int D, int is_bf16,
                                         int tile, int cluster, int grid_x, int partial,
                                         int device, int* out) {
  if (!covers(B, S, H, KVH, D, tile, cluster, grid_x)) return -1;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, S, H, KVH, 1.f, cluster,
               grid_x, nullptr, partial != 0};
  return on_device(device, [&] {
    return is_bf16 ? dispatch_max_clusters<__nv_bfloat16>(a, D, out)
                   : dispatch_max_clusters<float>(a, D, out);
  });
}
