// flash_attention backward for Hopper (sm_90a), hand-written: two kernels.
//
// Replaces the TPU kernels of `flash_attention_bwd_pallas`
// (src/repro/kernels/flash_attention_bwd.py of the JAX reference package):
//   K2a `_dq_kernel`  (:132)  dq = sum_kv dS K
//   K2b `_dkv_kernel` (:153)  dk = sum_q dS^T Q,  dv = sum_q P^T dO,
//                             each summed over the G = H/KVH heads of a group
// with  P = exp(scale * Q K^T - lse)  recomputed tile by tile from the
// forward's `lse` (never stored), dP = dO V^T and dS = P * (dP - delta) * scale,
// delta = rowsum(out * dO) (fp32, computed by the caller).
//   q (B,Sq,H,D), dO (B,Sq,H,DV); k (B,Skv,KVH,D), v (B,Skv,KVH,DV);
//   lse, delta (B,Sq,H) fp32 -> dq (B,Sq,H,D), dk (B,Skv,KVH,D), dv (B,Skv,KVH,DV)
// at (D, DV) = (32, 32), (64, 64), (128, 128) and (192, 128), K1's pairs. S and
// dq contract over D, dP and dv over DV.
//
// What bounds it on an H100: at the training path's shape (B=4, S=1024, H=32,
// KVH=4, D=64, bf16, causal: 524,800 (q,k) pairs on or below the diagonal)
// K2a does 3 products (6*B*H*D*pairs = 25.8 GFLOP, 26 us at 989 TFLOP/s)
// against 55.6 MB of I/O (17 us at 3.35 TB/s), K2b 4 products (34.4 GFLOP,
// 35 us) against 43 MB (13 us): both are bound by operations. Every product
// therefore runs on the tensor cores (`mma.sync.m16n8k16`, bf16 operands, fp32
// accumulate), P, dP and dS stay in registers (the C fragments of one product
// are repacked as the A fragments of the next), and no tile above the causal
// diagonal is visited.
//
// Design (bf16), two passes, no atomics, bit-identical run to run:
//   * K2a: one 4-warp block per (64-row q-tile, query head, batch), the KV
//     loop inside, dq in fp32 registers. Grid (B*H, q-tiles): with `causal`
//     blockIdx.y = 0 is the LAST q-tile, which walks the most key tiles, so
//     the launch hands out the longest blocks first and the short ones fill
//     the tail.
//   * K2b: one 4-warp block per (64-key tile, query head, batch) -- not per
//     KV head, which left 256 blocks of up to G x 16 = 128 steps at the
//     training shape; each block walks its own head's q-tiles only (at most
//     16 there). Grid (B*KVH*c, key tiles), key tile 0 (the most q-tiles)
//     first. The sum over the G heads of a group is made by a thread-block
//     cluster of c blocks (c the largest divisor of G up to 8; each block
//     walks G/c heads): each block leaves its fp32 partial dk and dv in its
//     own shared memory, and after cluster.sync() block r sums its share of
//     the tile's 64 rows over ranks 0..c-1 in rank order through distributed
//     shared memory and writes them as bf16. Deterministic, and no scratch in
//     device memory. At G = 1 (MHA, MLA) c = 1: each block sums its own rows.
//   * Copies overlap products: the tiles a block walks (K and V in K2a; Q,
//     dO, lse and delta in K2b) come through a cp.async ring of 2-3 stages,
//     the next tile in flight while this one's products run; rows past the
//     lengths load as zeros (src-size 0).
//   * Operands reach the tensor cores through ldmatrix (.trans for the
//     second product's B). At D <= 64 some of the block's fixed A operands
//     stay in registers (Q in K2a, K and V in K2b); the rest, and all of
//     them at D >= 128, are re-read from shared memory, which keeps both
//     kernels free of spills (K2a within the 168 registers of 3 blocks an SM).
//   * Masks only where a tile needs one: the causal mask on tiles that cross
//     the diagonal, the length masks on the ragged last tile. K2a's query
//     rows past Sq get lse = +inf (so P = 0) instead; K2b's key rows past
//     Skv are computed and never written.
//   * At D = 128 a K2b step takes 32 query rows, so S^T and dP^T take 16
//     registers each beside the 128 of the dk and dv accumulators.
//
// MLA (deepseek-v2-236b's training): D = 192, DV = 128, H = KVH = 128 (G = 1,
// so c = 1), scale 192^-0.5. At B=4, S=1024, causal K2a does
// 2*B*H*pairs*(D + DV + D) = 275.1 GFLOP (0.278 ms at 989 TFLOP/s) against
// 0.88 GB (0.26 ms), K2b 2*B*H*pairs*(D + DV + DV + D) = 343.9 GFLOP
// (0.348 ms) against 1.01 GB (0.30 ms): both narrowly bound by operations.
// What binds the design is registers and shared memory:
//   * K2a's dq accumulator is 16 rows x 192 a warp, 96 fp32 registers a
//     thread. Its key tile is 32 there (not 64): S and dP take 16 registers
//     each, and the block's shared memory -- Q (64 x 192) and dO (64 x 128)
//     plus 3 stages of K (32 x 192) and V (32 x 128), rows padded by 8 --
//     is 107,520 B, so two blocks share an SM; at 64 keys two stages alone
//     took 129,024 B, one block an SM.
//   * K2b's accumulators alone are dk 16 x 192 + dv 16 x 128 a warp, 160
//     registers a thread (the D = 128 instance, at 128 of accumulators and
//     32 of S^T and dP^T, already takes 246). A step there takes 16 query
//     rows: S^T and dP^T in 8 registers each. The fp32 partials the
//     cluster sum reads are 64 x (200 + 136) x 4 = 86,016 B, more than the
//     tiles' 75,648 B, and share their memory: two blocks an SM.
//   * Q, dO, K and V are read from shared memory at every product (none of
//     them in registers at D = 192), the dq/dk products run over 12 k-steps
//     of 16 and the dP/dv ones over 8.
// The build's ptxas report must show no spill in the bf16 (192, 128)
// instances.
//
// The host-side plan (`bwd_plan` in kernels/flash_attention_bwd.py) is what
// runs: both grids, K2a's key tile and K2b's q-tile (which pick the kernel
// instances), c and G/c come from it; the entry points refuse a plan whose
// grid does not hand each tile to one block, or a tile no instance has. P and
// dS are rounded to bf16 as the A operands of P^T dO, dS K and dS^T Q; the
// fp32 sums are not. fp32 inputs take two FMA kernels in IEEE fp32 (no TF32).
// The causal mask is top-left (key index <= query index), as in the forward;
// the wrapper admits `causal` only with Sq == Skv.
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// the outputs and the stream, and gets cudaGetLastError() back.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;   // 4 warps, each 16 rows of a tile (bf16 kernels)
constexpr int DQ_BM = 64;      // query rows of a K2a block
constexpr int BN = 64;         // keys of a K2b block
constexpr int DKV_STAGES = 3;  // K2b's Q/dO ring
constexpr int MAX_CLUSTER = 8; // the portable cluster size
constexpr int FT = 32;         // rows and keys per tile (fp32 kernels)

// K2a's (K, V) ring: 3 stages of 64 keys at D <= 64, 2 of 64 at D = 128, 3 of
// 32 at D = 192 (the instance's key tile)
template <int D> __host__ __device__ constexpr int dq_stages() { return D == 128 ? 2 : 3; }

// K2a's dS = P (dP - delta) scale in place of s, P = exp(s scale - lse) of
// the thread's rows row_a and row_a + 8. With MASK, keys at or beyond Skv and
// (causal) keys above the row are 0; col0 is the key of s[0][0].
template <bool MASK, int NT>
__device__ __forceinline__ void dq_ds(float (&s)[NT][4], const float (&dp)[NT][4],
                                      const float (&lse_r)[2], const float (&del_r)[2],
                                      float scale, int row_a, int col0, int Skv, int causal) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = __expf(s[nt][e] * scale - lse_r[r]);
      if (MASK) {
        const int col = col0 + nt * 8 + (e & 1), row = row_a + r * 8;
        if (col >= Skv || (causal && col > row)) p = 0.f;
      }
      s[nt][e] = p * (dp[nt][e] - del_r[r]) * scale;
    }
  }
}

// K2b's P^T (into st) and dS^T (into dpt), the queries as columns: lse and
// delta per column from shared memory. With MASK, queries at or beyond Sq
// and (causal) queries before the key are 0; m0 is the step's first query.
template <bool MASK, int NT>
__device__ __forceinline__ void dkv_ds(float (&st)[NT][4], float (&dpt)[NT][4],
                                       const float* lse_s, const float* del_s, float scale,
                                       int key_a, int m0, int t, int Sq, int causal) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = nt * 8 + t * 2 + (e & 1);
      float p = __expf(st[nt][e] * scale - lse_s[c]);
      if (MASK) {
        const int col = m0 + c, key = key_a + (e >> 1) * 8;
        if (col >= Sq || (causal && key > col)) p = 0.f;
      }
      st[nt][e] = p;
      dpt[nt][e] = p * (dpt[nt][e] - del_s[c]) * scale;
    }
  }
}

// K2a: Q and dO, then the ring of (K, V) tiles of BNQ keys; rows padded by 8
// bf16 (ldmatrix rows on distinct banks).
template <int D, int DV, int BNQ>
constexpr size_t dq_smem() {
  return (size_t)(DQ_BM + dq_stages<D>() * BNQ) * (D + 8 + DV + 8) * sizeof(__nv_bfloat16);
}

// K2b: K and V, the ring of (Q, dO) tiles and their (lse, delta); at the end
// the same memory holds the block's fp32 dk and dv partials, [64][D + 8] and
// [64][DV + 8] (the padding keeps a half-warp's float2 stores on 32 banks).
// BM: query rows of a step.
template <int D, int DV, int BM>
constexpr size_t dkv_smem() {
  constexpr size_t tiles = (size_t)(BN + DKV_STAGES * BM) * (D + 8 + DV + 8) * sizeof(__nv_bfloat16)
                           + (size_t)DKV_STAGES * 2 * BM * sizeof(float);
  constexpr size_t partials = (size_t)BN * (D + 8 + DV + 8) * sizeof(float);
  return tiles > partials ? tiles : partials;
}

// K2a. Warp w owns query rows [16w, 16w+16) of the tile; in the mma fragment
// layout thread (g = lane/4, t = lane%4) holds rows g and g+8. BNQ: keys of a
// step (the plan's key tile).
template <int D, int DV, int BNQ>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 2)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KVH, float scale,
                int causal) {
  constexpr int BM = DQ_BM, LD = D + 8, LDV = DV + 8, ST = dq_stages<D>(), NT = BNQ / 8;
  constexpr int STAGE = BNQ * (LD + LDV);  // elements of one stage: K, V
  constexpr bool Q_REGS = D <= 64;       // dO's fragments too would spill at 168 registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BM * LD;
  __nv_bfloat16* ring = dOs + BM * LDV;  // ST stages of (K, V)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nq = (Sq + BM - 1) / BM;
  const int m0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * KVH * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * KVH * DV;
  const int n_end = causal ? min(Skv, m0 + BM) : Skv;   // tiles above the diagonal skipped
  const int ntiles = (n_end + BNQ - 1) / BNQ;

  auto load_kv = [&](int j) {
    __nv_bfloat16* Ks = ring + (j % ST) * STAGE;
    cp_async_tile<D, LD, BNQ>(Ks, kb, j * BNQ, Skv, KVH, kvh);
    cp_async_tile<DV, LDV, BNQ>(Ks + BNQ * LD, vb, j * BNQ, Skv, KVH, kvh);
  };
  cp_async_tile<D, LD, BM>(Qs, q + (size_t)b * Sq * H * D, m0, Sq, H, h);
  cp_async_tile<DV, LDV, BM>(dOs, dout + (size_t)b * Sq * H * DV, m0, Sq, H, h);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < ntiles) load_kv(j);
    cp_async_commit();
  }

  const int row_a = m0 + warp * 16 + g;   // rows of c[.][0..1]; c[.][2..3] are row_a + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const size_t i = ((size_t)b * Sq + row) * H + h;
    lse_r[r] = row < Sq ? lse[i] : __int_as_float(0x7f800000);   // +inf: P = 0 past Sq
    del_r[r] = row < Sq ? delta[i] : 0.f;
  }

  const __nv_bfloat16* q_rows = Qs + warp * 16 * LD;
  const __nv_bfloat16* do_rows = dOs + warp * 16 * LDV;
  uint32_t qf[Q_REGS ? D / 16 : 1][4];
  cp_async_wait<ST - 1>();               // Q and dO are in
  __syncthreads();
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qf[kk], q_rows, kk, lane);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<ST - 2>();             // this thread's pieces of tile j are in
    __syncthreads();                     // everyone's are; the stage of tile j - 1 is free
    if (j + ST - 1 < ntiles) load_kv(j + ST - 1);
    cp_async_commit();
    const __nv_bfloat16* Ks = ring + (j % ST) * STAGE;
    const __nv_bfloat16* Vs = Ks + BNQ * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    if constexpr (Q_REGS)
      mma_abt<D, LD, NT>(s, qf, Ks, lane);       // S = Q K^T over D
    else
      mma_abt<D, LD, NT>(s, q_rows, Ks, lane);
    mma_abt<DV, LDV, NT>(dp, do_rows, Vs, lane); // dP = dO V^T over DV

    const int n0 = j * BNQ;
    if ((causal && n0 + BNQ - 1 > m0) || n0 + BNQ > Skv)   // the diagonal tiles; the ragged last
      dq_ds<true>(s, dp, lse_r, del_r, scale, row_a, n0 + t * 2, Skv, causal);
    else
      dq_ds<false>(s, dp, lse_r, del_r, scale, row_a, n0 + t * 2, Skv, causal);
    mma_xt<D, LD, BNQ / 16>(acc, s, Ks, lane);   // dq += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8 + t * 2) = pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// K2b's partials to this block's shared memory: the warp's 16 rows of a
// [BN][W + 8] fp32 buffer from the C fragments of a 16 x W accumulator.
template <int W>
__device__ __forceinline__ void store_partial(float* part, const float (&acc)[W / 8][4], int warp,
                                              int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int i = 0; i < W / 8; ++i)
      *reinterpret_cast<float2*>(part + row * (W + 8) + i * 8 + t * 2) =
          make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// Rows [r0, r1) of the [BN][W + 8] partial at `part` summed over the blocks
// of the cluster, ranks 0, 1, ..., c - 1 in that order, and written as bf16
// to rows n0 + r of `out` (the batch's and KV head's (Skv, KVH, W) slab) for
// keys below Skv.
template <int W>
__device__ __forceinline__ void cluster_sum_rows(float* part, int c, int r0, int r1, int n0,
                                                 int Skv, int KVH, __nv_bfloat16* out) {
  constexpr int Q4 = W / 4;              // float4 pieces a row
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < (r1 - r0) * Q4; i += THREADS) {
    const int row = r0 + i / Q4, col = (i % Q4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < c; ++src) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, src) + row * (W + 8) + col);
      sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
    }
    const int key = n0 + row;
    if (key < Skv)
      *reinterpret_cast<uint2*>(out + (size_t)key * KVH * W + col) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
}

// K2b. Warp w owns keys [16w, 16w+16) of the tile. Products are taken
// transposed (keys as rows): S^T = K Q^T, dP^T = V dO^T, so the rows of
// every fragment are this warp's keys and the columns are queries. Launched
// as clusters of `cluster` blocks along x: the blocks of one cluster share
// (batch, KV head, key tile), and block r walks query heads
// kvh*G + r*heads_per_block ... + heads_per_block - 1. BM: query rows of a
// step (the plan's q-tile).
template <int D, int DV, int BM>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                 int H, int KVH, float scale, int causal, int cluster_size, int heads_per_block) {
  constexpr int LD = D + 8, LDV = DV + 8, ST = DKV_STAGES, NT = BM / 8;
  constexpr int STAGE = BM * (LD + LDV); // elements of one stage: Q, dO
  constexpr bool A_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BN * LD;
  __nv_bfloat16* ring = Vs + BN * LDV;   // ST stages of (Q, dO)
  float* stats = reinterpret_cast<float*>(ring + ST * STAGE);   // ST stages of (lse, delta)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / cluster_size, b = grp / KVH, kvh = grp % KVH;
  const int G = H / KVH;
  const int n0 = blockIdx.y * BN;
  const int h0 = kvh * G + rank * heads_per_block;
  const int nq = (Sq + BM - 1) / BM;
  const int m_first = causal ? n0 / BM : 0;   // q-tiles wholly above the diagonal skipped
  const int per_head = nq - m_first, nsteps = heads_per_block * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * H * D;
  const __nv_bfloat16* dob = dout + (size_t)b * Sq * H * DV;

  auto load_step = [&](int s) {
    const int h = h0 + s / per_head, m0 = (m_first + s % per_head) * BM;
    __nv_bfloat16* Qs = ring + (s % ST) * STAGE;
    cp_async_tile<D, LD, BM>(Qs, qb, m0, Sq, H, h);
    cp_async_tile<DV, LDV, BM>(Qs + BM * LD, dob, m0, Sq, H, h);
    if (threadIdx.x < 2 * BM) {          // lse to [0, BM), delta to [BM, 2BM)
      const int row = m0 + threadIdx.x % BM;
      const bool ok = row < Sq;
      const float* src = threadIdx.x < BM ? lse : delta;
      cp_async4(stats + (s % ST) * 2 * BM + threadIdx.x,
                src + ((size_t)b * Sq + (ok ? row : 0)) * H + h, ok);
    }
  };
  cp_async_tile<D, LD, BN>(Ks, k + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);
  cp_async_tile<DV, LDV, BN>(Vs, v + (size_t)b * Skv * KVH * DV, n0, Skv, KVH, kvh);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }

  const __nv_bfloat16* k_rows = Ks + warp * 16 * LD;
  const __nv_bfloat16* v_rows = Vs + warp * 16 * LDV;
  uint32_t kf[A_REGS ? D / 16 : 1][4], vf[A_REGS ? DV / 16 : 1][4];
  cp_async_wait<ST - 1>();               // K and V are in
  __syncthreads();
  if constexpr (A_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(kf[kk], k_rows, kk, lane);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) load_a<LDV>(vf[kk], v_rows, kk, lane);
  }

  float dk_acc[D / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[i][e] = 0.f;

  const int key_a = n0 + warp * 16 + g;   // keys of c[.][0..1]; c[.][2..3] are key_a + 8
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<ST - 2>();             // this thread's pieces of step s are in
    __syncthreads();                     // everyone's are; the stage of step s - 1 is free
    if (s + ST - 1 < nsteps) load_step(s + ST - 1);
    cp_async_commit();
    const __nv_bfloat16* Qs = ring + (s % ST) * STAGE;
    const __nv_bfloat16* dOs = Qs + BM * LD;
    const float* lse_s = stats + (s % ST) * 2 * BM;
    const float* del_s = lse_s + BM;
    const int m0 = (m_first + s % per_head) * BM;

    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    if constexpr (A_REGS) {
      mma_abt<D, LD, NT>(st, kf, Qs, lane);        // S^T = K Q^T over D
      mma_abt<DV, LDV, NT>(dpt, vf, dOs, lane);    // dP^T = V dO^T over DV
    } else {
      mma_abt<D, LD, NT>(st, k_rows, Qs, lane);
      mma_abt<DV, LDV, NT>(dpt, v_rows, dOs, lane);
    }

    if ((causal && n0 + BN - 1 > m0) || m0 + BM > Sq)   // diagonal steps; the ragged last
      dkv_ds<true>(st, dpt, lse_s, del_s, scale, key_a, m0, t, Sq, causal);
    else
      dkv_ds<false>(st, dpt, lse_s, del_s, scale, key_a, m0, t, Sq, causal);
    mma_xt<DV, LDV, BM / 16>(dv_acc, st, dOs, lane);  // dv += P^T dO
    mma_xt<D, LD, BM / 16>(dk_acc, dpt, Qs, lane);    // dk += dS^T Q
  }

  // The sum over the cluster's heads: every block's partials to its own
  // shared memory, then block `rank` sums rows [r0, r1) of the tile over
  // ranks 0, 1, ..., cluster_size - 1 in that order and writes them.
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free
  float* dk_part = reinterpret_cast<float*>(smem_raw);   // [BN][D + 8]
  float* dv_part = dk_part + BN * (D + 8);               // [BN][DV + 8]
  store_partial<D>(dk_part, dk_acc, warp, g, t);
  store_partial<DV>(dv_part, dv_acc, warp, g, t);
  cluster.sync();                        // every block's partials are visible to the cluster
  const int r0 = rank * BN / cluster_size, r1 = (rank + 1) * BN / cluster_size;
  cluster_sum_rows<D>(dk_part, cluster_size, r0, r1, n0, Skv, KVH,
                      dk + (size_t)b * Skv * KVH * D + (size_t)kvh * D);
  cluster_sum_rows<DV>(dv_part, cluster_size, r0, r1, n0, Skv, KVH,
                       dv + (size_t)b * Skv * KVH * DV + (size_t)kvh * DV);
  cluster.sync();                        // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on 32 x 32 tiles in shared memory, 256 threads
// ---------------------------------------------------------------------------

// `FT` rows of D fp32 from a (S, heads, D) slab into shared memory with row
// stride LDX; rows at or beyond S are zero-filled.
template <int D, int LDX>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int S,
                                              int heads, int head) {
  for (int idx = threadIdx.x; idx < FT * D; idx += blockDim.x) {
    int r = idx / D, d = idx % D, row = row0 + r;
    dst[r * LDX + d] = row < S ? src[((size_t)row * heads + head) * D + d] : 0.f;
  }
}

template <int D, int DV>
constexpr size_t dq_fma_smem() {
  return (size_t)(2 * FT * (D + 1) + 2 * FT * (DV + 1) + FT * (FT + 1) + 2 * FT) * sizeof(float);
}

template <int D, int DV>
constexpr size_t dkv_fma_smem() {
  return (size_t)(2 * FT * (D + 1) + 2 * FT * (DV + 1) + 2 * FT * (FT + 1) + 2 * FT) *
         sizeof(float);
}

// K2a, fp32. Thread tid computes score entries (tid + 256 i) / 32, % 32 for
// i < 4, and owns dq entries (row tid / 8, columns tid % 8 + 8 j).
template <int D, int DV>
__global__ void __launch_bounds__(256)
attn_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int Sq, int Skv, int H, int KVH, float scale,
                int causal) {
  constexpr int LDX = D + 1, LDXV = DV + 1, LDS = FT + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + FT * LDX;
  float* Ks = dOs + FT * LDXV;
  float* Vs = Ks + FT * LDX;
  float* dSs = Vs + FT * LDXV;
  float* lse_s = dSs + FT * LDS;
  float* del_s = lse_s + FT;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* kb = k + (size_t)b * Skv * KVH * D;
  const float* vb = v + (size_t)b * Skv * KVH * DV;

  load_tile_f32<D, LDX>(Qs, q + (size_t)b * Sq * H * D, m0, Sq, H, h);
  load_tile_f32<DV, LDXV>(dOs, dout + (size_t)b * Sq * H * DV, m0, Sq, H, h);
  if (tid < FT) {
    int row = m0 + tid;
    size_t i = ((size_t)b * Sq + row) * H + h;
    lse_s[tid] = row < Sq ? lse[i] : 0.f;
    del_s[tid] = row < Sq ? delta[i] : 0.f;
  }
  float acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j] = 0.f;
  const int ro = tid / 8, co = tid % 8;

  const int n_end = causal ? min(Skv, m0 + FT) : Skv;
  for (int n0 = 0; n0 < n_end; n0 += FT) {
    __syncthreads();
    load_tile_f32<D, LDX>(Ks, kb, n0, Skv, KVH, kvh);
    load_tile_f32<DV, LDXV>(Vs, vb, n0, Skv, KVH, kvh);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int e = tid + 256 * i, r = e / FT, c = e % FT;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[r * LDX + d], Ks[c * LDX + d], s);
      for (int d = 0; d < DV; ++d) dp = fmaf(dOs[r * LDXV + d], Vs[c * LDXV + d], dp);
      int row = m0 + r, col = n0 + c;
      bool ok = row < Sq && col < Skv && (!causal || col <= row);
      float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
      dSs[r * LDS + c] = p * (dp - del_s[r]) * scale;
    }
    __syncthreads();
    for (int c = 0; c < FT; ++c) {
      float ds = dSs[ro * LDS + c];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[j] = fmaf(ds, Ks[c * LDX + co + 8 * j], acc[j]);
    }
  }
  int row = m0 + ro;
  if (row < Sq) {
    float* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) out[co + 8 * j] = acc[j];
  }
}

// K2b, fp32. Thread tid computes entries (key, query) = ((tid + 256 i) / 32,
// % 32) of P^T and dS^T, and owns dk / dv entries (key tid / 8, columns
// tid % 8 + 8 j).
template <int D, int DV>
__global__ void __launch_bounds__(256)
attn_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                 float scale, int causal) {
  constexpr int LDX = D + 1, LDXV = DV + 1, LDS = FT + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + FT * LDX;
  float* Qs = Vs + FT * LDXV;
  float* dOs = Qs + FT * LDX;
  float* Ps = dOs + FT * LDXV;
  float* dSs = Ps + FT * LDS;
  float* lse_s = dSs + FT * LDS;
  float* del_s = lse_s + FT;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * FT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const float* qb = q + (size_t)b * Sq * H * D;
  const float* dob = dout + (size_t)b * Sq * H * DV;
  load_tile_f32<D, LDX>(Ks, k + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);
  load_tile_f32<DV, LDXV>(Vs, v + (size_t)b * Skv * KVH * DV, n0, Skv, KVH, kvh);

  float dk_acc[D / 8], dv_acc[DV / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk_acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) dv_acc[j] = 0.f;
  const int ro = tid / 8, co = tid % 8;

  const int m_start = causal ? n0 : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    for (int m0 = m_start; m0 < Sq; m0 += FT) {
      __syncthreads();
      load_tile_f32<D, LDX>(Qs, qb, m0, Sq, H, h);
      load_tile_f32<DV, LDXV>(dOs, dob, m0, Sq, H, h);
      if (tid < FT) {
        int row = m0 + tid;
        size_t i = ((size_t)b * Sq + row) * H + h;
        lse_s[tid] = row < Sq ? lse[i] : 0.f;
        del_s[tid] = row < Sq ? delta[i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int e = tid + 256 * i, r = e / FT, c = e % FT;   // r: key, c: query
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(Ks[r * LDX + d], Qs[c * LDX + d], s);
        for (int d = 0; d < DV; ++d) dp = fmaf(Vs[r * LDXV + d], dOs[c * LDXV + d], dp);
        int key = n0 + r, col = m0 + c;
        bool ok = col < Sq && key < Skv && (!causal || key <= col);
        float p = ok ? expf(s * scale - lse_s[c]) : 0.f;
        Ps[r * LDS + c] = p;
        dSs[r * LDS + c] = p * (dp - del_s[c]) * scale;
      }
      __syncthreads();
      for (int c = 0; c < FT; ++c) {
        float p = Ps[ro * LDS + c], ds = dSs[ro * LDS + c];
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) dv_acc[j] = fmaf(p, dOs[c * LDXV + co + 8 * j], dv_acc[j]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) dk_acc[j] = fmaf(ds, Qs[c * LDX + co + 8 * j], dk_acc[j]);
      }
    }
  }
  int key = n0 + ro;
  if (key < Skv) {
    const size_t row = ((size_t)b * Skv + key) * KVH + kvh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dk[row * D + co + 8 * j] = dk_acc[j];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) dv[row * DV + co + 8 * j] = dv_acc[j];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Skv, H, KVH;
  float scale;
  int causal;
  cudaStream_t stream;
};

// The host-side plan (`bwd_plan`): the grid to launch, the tile that picks
// the kernel instance (K2a's key tile, K2b's q-tile) and, for K2b, the
// cluster size c and the heads per block G/c.
struct Plan {
  dim3 grid;
  int tile, cluster, heads_per_block;
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

bool same(dim3 x, dim3 y) { return x.x == y.x && x.y == y.y && x.z == y.z; }

// Does the plan's grid hand each tile of the tensors to exactly one block,
// and its cluster split each group of G heads evenly?
bool covers(const Args& a, const Plan& p, int is_bf16, bool dkv) {
  const int G = a.H / a.KVH;
  if (!is_bf16)
    return p.tile == FT &&
           (dkv ? same(p.grid, dim3(cdiv(a.Skv, FT), a.KVH, a.B)) && p.cluster == 1 &&
                      p.heads_per_block == G
                : same(p.grid, dim3(cdiv(a.Sq, FT), a.H, a.B)));
  if (!dkv) return same(p.grid, dim3(a.B * a.H, cdiv(a.Sq, DQ_BM), 1));
  return p.cluster >= 1 && p.cluster <= MAX_CLUSTER && G % p.cluster == 0 &&
         p.heads_per_block * p.cluster == G &&
         same(p.grid, dim3(a.B * a.KVH * p.cluster, cdiv(a.Skv, BN), 1));
}

template <int D, int DV, int BNQ>
cudaError_t launch_dq_mma(const Args& a, const Plan& p) {
  cudaError_t err;
  constexpr size_t smem = dq_smem<D, DV, BNQ>();
  if ((err = prepare(attn_bwd_dq_mma<D, DV, BNQ>, smem)) != cudaSuccess) return err;
  attn_bwd_dq_mma<D, DV, BNQ><<<p.grid, THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      a.delta, static_cast<__nv_bfloat16*>(a.dq), a.Sq, a.Skv, a.H, a.KVH, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_dq_fma(const Args& a, const Plan& p) {
  cudaError_t err;
  constexpr size_t smem = dq_fma_smem<D, DV>();
  if ((err = prepare(attn_bwd_dq_fma<D, DV>, smem)) != cudaSuccess) return err;
  attn_bwd_dq_fma<D, DV><<<p.grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KVH, a.scale, a.causal);
  return cudaGetLastError();
}

// K2b's launch: the plan's grid, in clusters of (c, 1, 1).
template <int D, int DV, int BM>
cudaLaunchConfig_t dkv_config(const Args& a, const Plan& p, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = dkv_smem<D, DV, BM>();
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, int DV, int BM>
cudaError_t launch_dkv_mma(const Args& a, const Plan& p) {
  cudaError_t err;
  if ((err = prepare(attn_bwd_dkv_mma<D, DV, BM>, dkv_smem<D, DV, BM>())) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dkv_config<D, DV, BM>(a, p, attr);
  if ((err = cudaLaunchKernelEx(
           &cfg, attn_bwd_dkv_mma<D, DV, BM>, static_cast<const __nv_bfloat16*>(a.q),
           static_cast<const __nv_bfloat16*>(a.k), static_cast<const __nv_bfloat16*>(a.v),
           static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
           static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.Sq, a.Skv,
           a.H, a.KVH, a.scale, a.causal, p.cluster, p.heads_per_block)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_dkv_fma(const Args& a, const Plan& p) {
  cudaError_t err;
  constexpr size_t smem = dkv_fma_smem<D, DV>();
  if ((err = prepare(attn_bwd_dkv_fma<D, DV>, smem)) != cudaSuccess) return err;
  attn_bwd_dkv_fma<D, DV><<<p.grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.KVH, a.scale,
      a.causal);
  return cudaGetLastError();
}

// The fp32 instances, by (D, DV): K1's pairs.
#define FMA_CASES(FN)                                                   \
  if (D == 32 && DV == 32) return (int)FN<32, 32>(a, p);                \
  if (D == 64 && DV == 64) return (int)FN<64, 64>(a, p);                \
  if (D == 128 && DV == 128) return (int)FN<128, 128>(a, p);            \
  if (D == 192 && DV == 128) return (int)FN<192, 128>(a, p);            \
  return -1;

// The bf16 K2a instances, by (D, DV, the plan's key tile): 64 keys a step,
// 32 at (192, 128) (S and dP in 16 registers each beside the 96 of dq, and
// two blocks an SM). -1 for a triple with no instance.
int launch_dq(const Args& a, int D, int DV, int is_bf16, const Plan& p) {
  if (!is_bf16) { FMA_CASES(launch_dq_fma) }
  if (D == 32 && DV == 32 && p.tile == 64) return (int)launch_dq_mma<32, 32, 64>(a, p);
  if (D == 64 && DV == 64 && p.tile == 64) return (int)launch_dq_mma<64, 64, 64>(a, p);
  if (D == 128 && DV == 128 && p.tile == 64) return (int)launch_dq_mma<128, 128, 64>(a, p);
  if (D == 192 && DV == 128 && p.tile == 32) return (int)launch_dq_mma<192, 128, 32>(a, p);
  return -1;
}

// The bf16 K2b instances, by (D, DV, the plan's q-tile): 64-row steps at
// D <= 64, 32-row steps at D = 128 (S^T and dP^T in 16 registers each beside
// the 128 of the dk and dv accumulators), 16-row steps at (192, 128) (8 each
// beside 160). -1 for a triple with no instance.
int launch_dkv(const Args& a, int D, int DV, int is_bf16, const Plan& p) {
  if (!is_bf16) { FMA_CASES(launch_dkv_fma) }
  if (D == 32 && DV == 32 && p.tile == 64) return (int)launch_dkv_mma<32, 32, 64>(a, p);
  if (D == 64 && DV == 64 && p.tile == 64) return (int)launch_dkv_mma<64, 64, 64>(a, p);
  if (D == 128 && DV == 128 && p.tile == 32) return (int)launch_dkv_mma<128, 128, 32>(a, p);
  if (D == 192 && DV == 128 && p.tile == 16) return (int)launch_dkv_mma<192, 128, 16>(a, p);
  return -1;
}
#undef FMA_CASES

template <int D, int DV, int BM>
cudaError_t dkv_max_clusters(const Args& a, const Plan& p, int* out) {
  cudaError_t err;
  if ((err = prepare(attn_bwd_dkv_mma<D, DV, BM>, dkv_smem<D, DV, BM>())) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dkv_config<D, DV, BM>(a, p, attr);
  return cudaOccupancyMaxActiveClusters(out, attn_bwd_dkv_mma<D, DV, BM>, &cfg);
}

bool bad_shape(int B, int Sq, int Skv, int H, int KVH) {
  // grid limits: x up to 2^31 - 1 (B*H, B*KVH*c), y and z up to 65535
  return B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || B > 65535 || H > 65535 ||
         (Sq + DQ_BM - 1) / DQ_BM > 65535 || (Skv + BN - 1) / BN > 65535 ||
         (long long)B * H > 0x7fffffffLL;
}

}  // namespace

// All return 0, a cudaError_t, or -1 for a shape, type or plan this file has
// no kernel for ((D, Dv) one of (32, 32), (64, 64), (128, 128), (192, 128); H
// a multiple of KVH; lengths within the grid's limits; a grid, tile, cluster
// size and heads per block of `bwd_plan`). All tensors contiguous in the
// layouts named at the top.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Skv, int H, int KVH, int D,
                                      int Dv, float scale, int causal, int is_bf16, int kv_tile,
                                      int grid_x, int grid_y, int grid_z, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, B, Sq, Skv, H, KVH, scale, causal,
         static_cast<cudaStream_t>(stream)};
  const Plan p{dim3(grid_x, grid_y, grid_z), kv_tile, 1, H / KVH};
  return covers(a, p, is_bf16, false) ? launch_dq(a, D, Dv, is_bf16, p) : -1;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                                       int D, int Dv, float scale, int causal, int is_bf16,
                                       int q_tile, int grid_x, int grid_y, int grid_z,
                                       int cluster, int heads_per_block, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, B, Sq, Skv, H, KVH, scale, causal,
         static_cast<cudaStream_t>(stream)};
  const Plan p{dim3(grid_x, grid_y, grid_z), q_tile, cluster, heads_per_block};
  return covers(a, p, is_bf16, true) ? launch_dkv(a, D, Dv, is_bf16, p) : -1;
}

// cudaOccupancyMaxActiveClusters for the bf16 K2b launch of this shape and
// plan, into *max_clusters: how many of its clusters the card holds at once.
extern "C" int flash_attention_bwd_dkv_max_clusters(int B, int Sq, int Skv, int H, int KVH, int D,
                                                    int Dv, int q_tile, int grid_x, int grid_y,
                                                    int grid_z, int cluster, int heads_per_block,
                                                    int* max_clusters) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         B, Sq, Skv, H, KVH, 1.f, 1, nullptr};
  const Plan p{dim3(grid_x, grid_y, grid_z), q_tile, cluster, heads_per_block};
  if (!covers(a, p, 1, true)) return -1;
  if (D == 32 && Dv == 32 && q_tile == 64) return (int)dkv_max_clusters<32, 32, 64>(a, p, max_clusters);
  if (D == 64 && Dv == 64 && q_tile == 64) return (int)dkv_max_clusters<64, 64, 64>(a, p, max_clusters);
  if (D == 128 && Dv == 128 && q_tile == 32)
    return (int)dkv_max_clusters<128, 128, 32>(a, p, max_clusters);
  if (D == 192 && Dv == 128 && q_tile == 16)
    return (int)dkv_max_clusters<192, 128, 16>(a, p, max_clusters);
  return -1;
}
