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
//   q, dO (B,Sq,H,D); k, v (B,Skv,KVH,D); lse, delta (B,Sq,H) fp32
//   -> dq (B,Sq,H,D), dk, dv (B,Skv,KVH,D)
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
//     device memory.
//   * Copies overlap products: the tiles a block walks (K and V in K2a; Q,
//     dO, lse and delta in K2b) come through a cp.async ring of 2-3 stages,
//     the next tile in flight while this one's products run; rows past the
//     lengths load as zeros (src-size 0).
//   * Operands reach the tensor cores through ldmatrix (.trans for the
//     second product's B). At D <= 64 some of the block's fixed A operands
//     stay in registers (Q in K2a, K and V in K2b); the rest, and all of
//     them at D = 128, are re-read from shared memory, which keeps both
//     kernels free of spills (K2a within the 168 registers of 3 blocks an SM).
//   * Masks only where a tile needs one: the causal mask on tiles that cross
//     the diagonal, the length masks on the ragged last tile. K2a's query
//     rows past Sq get lse = +inf (so P = 0) instead; K2b's key rows past
//     Skv are computed and never written.
//   * At D = 128 a K2b step takes 32 query rows, so S^T and dP^T take 16
//     registers each beside the 128 of the dk and dv accumulators.
// The host-side plan (`bwd_plan` in kernels/flash_attention_bwd.py) is what
// runs: both grids, K2b's q-tile (which picks its kernel instance), c and G/c
// come from it; the entry points refuse a plan whose grid does not hand each
// tile to one block, or a q-tile no instance has. P and dS are rounded to
// bf16 as the A operands of P^T dO, dS K and dS^T Q; the fp32 sums are not.
// fp32 inputs take two FMA kernels in IEEE fp32 (no TF32). The causal mask is
// top-left (key index <= query index), as in the forward; the wrapper admits
// `causal` only with Sq == Skv.
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
constexpr int BN = 64;         // keys of a K2a step and of a K2b block
constexpr int DKV_STAGES = 3;  // K2b's Q/dO ring
constexpr int MAX_CLUSTER = 8; // the portable cluster size
constexpr int FT = 32;         // rows and keys per tile (fp32 kernels)

template <int D> __host__ __device__ constexpr int dq_stages() { return D <= 64 ? 3 : 2; }

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

template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * DQ_BM + dq_stages<D>() * 2 * BN) * (D + 8) * sizeof(__nv_bfloat16);
}

// K2b: K and V, the ring of (Q, dO) tiles and their (lse, delta); at the end
// the same memory holds the block's fp32 dk and dv partials, [64][D + 8] each
// (the padding keeps a half-warp's float2 stores on 32 banks). BM: query rows
// of a step.
template <int D, int BM>
constexpr size_t dkv_smem() {
  constexpr size_t tiles = (size_t)(2 * BN + DKV_STAGES * 2 * BM) * (D + 8) * sizeof(__nv_bfloat16)
                           + (size_t)DKV_STAGES * 2 * BM * sizeof(float);
  constexpr size_t partials = (size_t)2 * BN * (D + 8) * sizeof(float);
  return tiles > partials ? tiles : partials;
}

// K2a. Warp w owns query rows [16w, 16w+16) of the tile; in the mma fragment
// layout thread (g = lane/4, t = lane%4) holds rows g and g+8.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 2)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KVH, float scale,
                int causal) {
  constexpr int BM = DQ_BM, LD = D + 8, ST = dq_stages<D>(), NT = BN / 8;
  constexpr bool Q_REGS = D <= 64;       // dO's fragments too would spill at 168 registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BM * LD;
  __nv_bfloat16* ring = dOs + BM * LD;   // ST stages of (K, V)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nq = (Sq + BM - 1) / BM;
  const int m0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * KVH * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * KVH * D;
  const int n_end = causal ? min(Skv, m0 + BM) : Skv;   // tiles above the diagonal skipped
  const int ntiles = (n_end + BN - 1) / BN;

  auto load_kv = [&](int j) {
    __nv_bfloat16* Ks = ring + (j % ST) * 2 * BN * LD;
    cp_async_tile<D, LD, BN>(Ks, kb, j * BN, Skv, KVH, kvh);
    cp_async_tile<D, LD, BN>(Ks + BN * LD, vb, j * BN, Skv, KVH, kvh);
  };
  cp_async_tile<D, LD, BM>(Qs, q + (size_t)b * Sq * H * D, m0, Sq, H, h);
  cp_async_tile<D, LD, BM>(dOs, dout + (size_t)b * Sq * H * D, m0, Sq, H, h);
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
  const __nv_bfloat16* do_rows = dOs + warp * 16 * LD;
  uint32_t qf[D / 16][4];
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
    const __nv_bfloat16* Ks = ring + (j % ST) * 2 * BN * LD;
    const __nv_bfloat16* Vs = Ks + BN * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    if constexpr (Q_REGS)
      mma_abt<D, LD, NT>(s, qf, Ks, lane);      // S = Q K^T
    else
      mma_abt<D, LD, NT>(s, q_rows, Ks, lane);
    mma_abt<D, LD, NT>(dp, do_rows, Vs, lane);  // dP = dO V^T

    const int n0 = j * BN;
    if ((causal && n0 + BN - 1 > m0) || n0 + BN > Skv)   // the diagonal tile; the ragged last
      dq_ds<true>(s, dp, lse_r, del_r, scale, row_a, n0 + t * 2, Skv, causal);
    else
      dq_ds<false>(s, dp, lse_r, del_r, scale, row_a, n0 + t * 2, Skv, causal);
    mma_xt<D, LD, BN / 16>(acc, s, Ks, lane);   // dq += dS K
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

// K2b. Warp w owns keys [16w, 16w+16) of the tile. Products are taken
// transposed (keys as rows): S^T = K Q^T, dP^T = V dO^T, so the rows of
// every fragment are this warp's keys and the columns are queries. Launched
// as clusters of `cluster` blocks along x: the blocks of one cluster share
// (batch, KV head, key tile), and block r walks query heads
// kvh*G + r*heads_per_block ... + heads_per_block - 1. BM: query rows of a
// step (the plan's q-tile).
template <int D, int BM>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                 int H, int KVH, float scale, int causal, int cluster_size, int heads_per_block) {
  constexpr int LD = D + 8, ST = DKV_STAGES, NT = BM / 8, RLD = D + 8;
  constexpr int STAGE = 2 * BM * LD;     // elements of one stage: Q, dO
  constexpr bool A_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BN * LD;
  __nv_bfloat16* ring = Vs + BN * LD;    // ST stages of (Q, dO)
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
  const __nv_bfloat16* dob = dout + (size_t)b * Sq * H * D;

  auto load_step = [&](int s) {
    const int h = h0 + s / per_head, m0 = (m_first + s % per_head) * BM;
    __nv_bfloat16* Qs = ring + (s % ST) * STAGE;
    cp_async_tile<D, LD, BM>(Qs, qb, m0, Sq, H, h);
    cp_async_tile<D, LD, BM>(Qs + BM * LD, dob, m0, Sq, H, h);
    if (threadIdx.x < 2 * BM) {          // lse to [0, BM), delta to [BM, 2BM)
      const int row = m0 + threadIdx.x % BM;
      const bool ok = row < Sq;
      const float* src = threadIdx.x < BM ? lse : delta;
      cp_async4(stats + (s % ST) * 2 * BM + threadIdx.x,
                src + ((size_t)b * Sq + (ok ? row : 0)) * H + h, ok);
    }
  };
  cp_async_tile<D, LD, BN>(Ks, k + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);
  cp_async_tile<D, LD, BN>(Vs, v + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }

  const __nv_bfloat16* k_rows = Ks + warp * 16 * LD;
  const __nv_bfloat16* v_rows = Vs + warp * 16 * LD;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  cp_async_wait<ST - 1>();               // K and V are in
  __syncthreads();
  if constexpr (A_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a<LD>(kf[kk], k_rows, kk, lane);
      load_a<LD>(vf[kk], v_rows, kk, lane);
    }
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

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
      mma_abt<D, LD, NT>(st, kf, Qs, lane);      // S^T = K Q^T
      mma_abt<D, LD, NT>(dpt, vf, dOs, lane);    // dP^T = V dO^T
    } else {
      mma_abt<D, LD, NT>(st, k_rows, Qs, lane);
      mma_abt<D, LD, NT>(dpt, v_rows, dOs, lane);
    }

    if ((causal && n0 + BN - 1 > m0) || m0 + BM > Sq)   // diagonal steps; the ragged last
      dkv_ds<true>(st, dpt, lse_s, del_s, scale, key_a, m0, t, Sq, causal);
    else
      dkv_ds<false>(st, dpt, lse_s, del_s, scale, key_a, m0, t, Sq, causal);
    mma_xt<D, LD, BM / 16>(dv_acc, st, dOs, lane);    // dv += P^T dO
    mma_xt<D, LD, BM / 16>(dk_acc, dpt, Qs, lane);    // dk += dS^T Q
  }

  // The sum over the cluster's heads: every block's partials to its own
  // shared memory, then block `rank` sums rows [r0, r1) of the tile over
  // ranks 0, 1, ..., cluster_size - 1 in that order and writes them.
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free
  float* part = reinterpret_cast<float*>(smem_raw);   // dk [BN][RLD], then dv
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + t * 2;
      *reinterpret_cast<float2*>(part + row * RLD + col) =
          make_float2(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
      *reinterpret_cast<float2*>(part + (BN + row) * RLD + col) =
          make_float2(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
  cluster.sync();                        // every block's partials are visible to the cluster
  const int r0 = rank * BN / cluster_size, r1 = (rank + 1) * BN / cluster_size;
  const int per_half = (r1 - r0) * (D / 4);
  for (int i = threadIdx.x; i < 2 * per_half; i += THREADS) {
    const int half = i / per_half, rem = i % per_half;   // half 0: dk, 1: dv
    const int row = r0 + rem / (D / 4), col = (rem % (D / 4)) * 4;
    const int off = (half * BN + row) * RLD + col;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < cluster_size; ++src) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, src) + off);
      sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
    }
    const int key = n0 + row;
    if (key < Skv) {
      __nv_bfloat16* out = (half ? dv : dk) + (((size_t)b * Skv + key) * KVH + kvh) * D + col;
      *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    }
  }
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

// K2a, fp32. Thread tid computes score entries (tid + 256 i) / 32, % 32 for
// i < 4, and owns dq entries (row tid / 8, columns tid % 8 + 8 j).
template <int D>
__global__ void __launch_bounds__(256)
attn_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int Sq, int Skv, int H, int KVH, float scale,
                int causal) {
  constexpr int LDX = D + 1, LDS = FT + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + FT * LDX;
  float* Ks = dOs + FT * LDX;
  float* Vs = Ks + FT * LDX;
  float* dSs = Vs + FT * LDX;
  float* lse_s = dSs + FT * LDS;
  float* del_s = lse_s + FT;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* kb = k + (size_t)b * Skv * KVH * D;
  const float* vb = v + (size_t)b * Skv * KVH * D;

  load_tile_f32<D, LDX>(Qs, q + (size_t)b * Sq * H * D, m0, Sq, H, h);
  load_tile_f32<D, LDX>(dOs, dout + (size_t)b * Sq * H * D, m0, Sq, H, h);
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
    load_tile_f32<D, LDX>(Vs, vb, n0, Skv, KVH, kvh);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int e = tid + 256 * i, r = e / FT, c = e % FT;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[r * LDX + d], Ks[c * LDX + d], s);
        dp = fmaf(dOs[r * LDX + d], Vs[c * LDX + d], dp);
      }
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
template <int D>
__global__ void __launch_bounds__(256)
attn_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                 float scale, int causal) {
  constexpr int LDX = D + 1, LDS = FT + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + FT * LDX;
  float* Qs = Vs + FT * LDX;
  float* dOs = Qs + FT * LDX;
  float* Ps = dOs + FT * LDX;
  float* dSs = Ps + FT * LDS;
  float* lse_s = dSs + FT * LDS;
  float* del_s = lse_s + FT;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * FT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const float* qb = q + (size_t)b * Sq * H * D;
  const float* dob = dout + (size_t)b * Sq * H * D;
  load_tile_f32<D, LDX>(Ks, k + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);
  load_tile_f32<D, LDX>(Vs, v + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);

  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  const int ro = tid / 8, co = tid % 8;

  const int m_start = causal ? n0 : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    for (int m0 = m_start; m0 < Sq; m0 += FT) {
      __syncthreads();
      load_tile_f32<D, LDX>(Qs, qb, m0, Sq, H, h);
      load_tile_f32<D, LDX>(dOs, dob, m0, Sq, H, h);
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
        for (int d = 0; d < D; ++d) {
          s = fmaf(Ks[r * LDX + d], Qs[c * LDX + d], s);
          dp = fmaf(Vs[r * LDX + d], dOs[c * LDX + d], dp);
        }
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
        for (int j = 0; j < D / 8; ++j) {
          dv_acc[j] = fmaf(p, dOs[c * LDX + co + 8 * j], dv_acc[j]);
          dk_acc[j] = fmaf(ds, Qs[c * LDX + co + 8 * j], dk_acc[j]);
        }
      }
    }
  }
  int key = n0 + ro;
  if (key < Skv) {
    size_t base = (((size_t)b * Skv + key) * KVH + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk[base + co + 8 * j] = dk_acc[j];
      dv[base + co + 8 * j] = dv_acc[j];
    }
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

// The host-side plan (`bwd_plan`): the grid to launch and, for K2b, the
// q-tile that picks the kernel instance, the cluster size c and the heads
// per block G/c.
struct Plan {
  dim3 grid;
  int q_tile, cluster, heads_per_block;
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
    return dkv ? same(p.grid, dim3(cdiv(a.Skv, FT), a.KVH, a.B)) && p.q_tile == FT &&
                     p.cluster == 1 && p.heads_per_block == G
               : same(p.grid, dim3(cdiv(a.Sq, FT), a.H, a.B));
  if (!dkv) return same(p.grid, dim3(a.B * a.H, cdiv(a.Sq, DQ_BM), 1));
  return p.cluster >= 1 && p.cluster <= MAX_CLUSTER && G % p.cluster == 0 &&
         p.heads_per_block * p.cluster == G &&
         same(p.grid, dim3(a.B * a.KVH * p.cluster, cdiv(a.Skv, BN), 1));
}

template <int D>
cudaError_t launch_dq(const Args& a, int is_bf16, const Plan& p) {
  cudaError_t err;
  if (is_bf16) {
    constexpr size_t smem = dq_smem<D>();
    if ((err = prepare(attn_bwd_dq_mma<D>, smem)) != cudaSuccess) return err;
    attn_bwd_dq_mma<D><<<p.grid, THREADS, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
        a.delta, static_cast<__nv_bfloat16*>(a.dq), a.Sq, a.Skv, a.H, a.KVH, a.scale, a.causal);
  } else {
    size_t smem = (size_t)(4 * FT * (D + 1) + FT * (FT + 1) + 2 * FT) * sizeof(float);
    if ((err = prepare(attn_bwd_dq_fma<D>, smem)) != cudaSuccess) return err;
    attn_bwd_dq_fma<D><<<p.grid, 256, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KVH, a.scale, a.causal);
  }
  return cudaGetLastError();
}

// K2b's launch: the plan's grid, in clusters of (c, 1, 1).
template <int D, int BM>
cudaLaunchConfig_t dkv_config(const Args& a, const Plan& p, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = dkv_smem<D, BM>();
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, int BM>
cudaError_t launch_dkv_mma(const Args& a, const Plan& p) {
  cudaError_t err;
  if ((err = prepare(attn_bwd_dkv_mma<D, BM>, dkv_smem<D, BM>())) != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dkv_config<D, BM>(a, p, attr);
  if ((err = cudaLaunchKernelEx(
           &cfg, attn_bwd_dkv_mma<D, BM>, static_cast<const __nv_bfloat16*>(a.q),
           static_cast<const __nv_bfloat16*>(a.k), static_cast<const __nv_bfloat16*>(a.v),
           static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
           static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.Sq, a.Skv,
           a.H, a.KVH, a.scale, a.causal, p.cluster, p.heads_per_block)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_fma(const Args& a, const Plan& p) {
  cudaError_t err;
  size_t smem = (size_t)(4 * FT * (D + 1) + 2 * FT * (FT + 1) + 2 * FT) * sizeof(float);
  if ((err = prepare(attn_bwd_dkv_fma<D>, smem)) != cudaSuccess) return err;
  attn_bwd_dkv_fma<D><<<p.grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.KVH, a.scale,
      a.causal);
  return cudaGetLastError();
}

// The bf16 K2b instances, by (D, the plan's q-tile): 64-row steps at D <= 64,
// 32-row steps at D = 128 (S^T and dP^T in 16 registers each beside the 128
// of the dk and dv accumulators). -1 for a pair with no instance.
int launch_dkv(const Args& a, int D, int is_bf16, const Plan& p) {
  if (!is_bf16) {
    switch (D) {
      case 32: return (int)launch_dkv_fma<32>(a, p);
      case 64: return (int)launch_dkv_fma<64>(a, p);
      case 128: return (int)launch_dkv_fma<128>(a, p);
      default: return -1;
    }
  }
  if (D == 32 && p.q_tile == 64) return (int)launch_dkv_mma<32, 64>(a, p);
  if (D == 64 && p.q_tile == 64) return (int)launch_dkv_mma<64, 64>(a, p);
  if (D == 128 && p.q_tile == 32) return (int)launch_dkv_mma<128, 32>(a, p);
  return -1;
}

template <int D, int BM>
cudaError_t dkv_max_clusters(const Args& a, const Plan& p, int* out) {
  cudaError_t err;
  if ((err = prepare(attn_bwd_dkv_mma<D, BM>, dkv_smem<D, BM>())) != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dkv_config<D, BM>(a, p, attr);
  return cudaOccupancyMaxActiveClusters(out, attn_bwd_dkv_mma<D, BM>, &cfg);
}

bool bad_shape(int B, int Sq, int Skv, int H, int KVH) {
  // grid limits: x up to 2^31 - 1 (B*H, B*KVH*c), y and z up to 65535
  return B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || B > 65535 || H > 65535 ||
         (Sq + DQ_BM - 1) / DQ_BM > 65535 || (Skv + BN - 1) / BN > 65535 ||
         (long long)B * H > 0x7fffffffLL;
}

}  // namespace

// All return 0, a cudaError_t, or -1 for a shape, type or plan this file has
// no kernel for (head dims 32, 64, 128; H a multiple of KVH; lengths within
// the grid's limits; a grid, q-tile, cluster size and heads per block of
// `bwd_plan`). All tensors contiguous in the layouts named at the top.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Skv, int H, int KVH, int D,
                                      float scale, int causal, int is_bf16, int grid_x,
                                      int grid_y, int grid_z, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, B, Sq, Skv, H, KVH, scale, causal,
         static_cast<cudaStream_t>(stream)};
  const Plan p{dim3(grid_x, grid_y, grid_z), 0, 1, H / KVH};
  if (!covers(a, p, is_bf16, false)) return -1;
  switch (D) {
    case 32: return (int)launch_dq<32>(a, is_bf16, p);
    case 64: return (int)launch_dq<64>(a, is_bf16, p);
    case 128: return (int)launch_dq<128>(a, is_bf16, p);
    default: return -1;
  }
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                                       int D, float scale, int causal, int is_bf16, int q_tile,
                                       int grid_x, int grid_y, int grid_z, int cluster,
                                       int heads_per_block, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, B, Sq, Skv, H, KVH, scale, causal,
         static_cast<cudaStream_t>(stream)};
  const Plan p{dim3(grid_x, grid_y, grid_z), q_tile, cluster, heads_per_block};
  return covers(a, p, is_bf16, true) ? launch_dkv(a, D, is_bf16, p) : -1;
}

// cudaOccupancyMaxActiveClusters for the bf16 K2b launch of this shape and
// plan, into *max_clusters: how many of its clusters the card holds at once.
extern "C" int flash_attention_bwd_dkv_max_clusters(int B, int Sq, int Skv, int H, int KVH, int D,
                                                    int q_tile, int grid_x, int grid_y,
                                                    int grid_z, int cluster, int heads_per_block,
                                                    int* max_clusters) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         B, Sq, Skv, H, KVH, 1.f, 1, nullptr};
  const Plan p{dim3(grid_x, grid_y, grid_z), q_tile, cluster, heads_per_block};
  if (!covers(a, p, 1, true)) return -1;
  if (D == 32 && q_tile == 64) return (int)dkv_max_clusters<32, 64>(a, p, max_clusters);
  if (D == 64 && q_tile == 64) return (int)dkv_max_clusters<64, 64>(a, p, max_clusters);
  if (D == 128 && q_tile == 32) return (int)dkv_max_clusters<128, 32>(a, p, max_clusters);
  return -1;
}
