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
// 35 us) against 43 MB (13 us): both are bound by operations. The design
// therefore keeps every product on the tensor cores (`mma.sync.m16n8k16`,
// bf16 operands, fp32 accumulate), keeps P, dP and dS in registers (the C
// fragments of one product are repacked as the A fragments of the next), and
// skips every tile above the causal diagonal.
//
// What differs from the TPU kernels, whose grid ran in order on one core and
// carried the accumulators in scratch between grid steps:
//   * K2a: one block per (batch, query head, 64-row q-tile), the KV loop
//     inside, the dq accumulator in registers (fp32);
//   * K2b: one block per (batch, KV head, 64-key tile), a loop over the G
//     query heads of the group and over the q-tiles inside, the dk / dv
//     accumulators in registers (fp32). The loop over G does what the Pallas
//     kernel's row stacking (`_prep`) did: the sum over a group's heads.
//   * Two passes and no atomics, so dq, dk, dv are bit-identical run to run.
//   * (B,S,H,D) is read in place (no transposed copies); ragged tails are
//     zero-filled and masked, so neither length need be a tile multiple.
//   * P and dS are rounded to bf16 as the A operands of P^T dO, dS K and
//     dS^T Q; the fp32 sums are not.
//   * fp32 inputs take two FMA kernels in IEEE fp32 (no TF32).
// The causal mask is top-left (key index <= query index), as in the forward;
// the wrapper admits `causal` only with Sq == Skv.
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// the outputs and the stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per tile (bf16 kernels)
constexpr int BN = 64;   // keys per tile (bf16 kernels)
constexpr int FT = 32;   // rows and keys per tile (fp32 kernels)

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync (the fragment layouts of the forward)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low 16 bits) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// `ROWS` rows of D bf16 (row r of the tile is row row0 + r of a (S, heads, D)
// slab, head `head`) into shared memory with row stride LD, 16 bytes at a
// time; rows at or beyond S are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int S, int heads, int head) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += blockDim.x) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) val = *reinterpret_cast<const uint4*>(src + ((size_t)row * heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The A fragments (16 rows x D) of a row-major tile in shared memory, rows
// [row0, row0 + 16): kk-th 16-column slice in a[kk].
template <int D, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile,
                                             int row0, int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + g) * LD + t * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(p + kk * 16);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + kk * 16);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(p + kk * 16 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + kk * 16 + 8);
  }
}

// c[nt] (16 x 64) += A (16 x D, fragments) . T^T, T a row-major (64 x D) tile
// in shared memory: the B operand of n-tile nt is rows nt*8.. of T, read by
// 4-byte loads (as K in the forward's Q K^T).
template <int D, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* p = tile + (nt * 8 + g) * LD + kk * 16 + t * 2;
      mma_bf16_16816(c[nt], a[kk], *reinterpret_cast<const uint32_t*>(p),
                     *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// acc (16 x D) += X (16 x 64, C fragments in x, rounded to bf16 here) . T,
// T a row-major (64 x D) tile in shared memory read through ldmatrix.trans
// (as V in the forward's P V).
template <int D, int LD>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4], const float (&x)[8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* row =
        tile + (kk * 16 + (lane % 8) + ((lane / 8) & 1) * 8) * LD + (lane / 16) * 8;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, row + dt * 16);
      mma_bf16_16816(acc[2 * dt], xa, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * dt + 1], xa, bf[2], bf[3]);
    }
  }
}

// K2a. 4 warps; warp w owns query rows [16w, 16w+16) of the tile; in the mma
// fragment layout thread (g = lane/4, t = lane%4) holds rows g and g+8.
template <int D>
__global__ void __launch_bounds__(128)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KVH, float scale,
                int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BM * LD;
  __nv_bfloat16* Ks = dOs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;

  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * KVH * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * KVH * D;

  load_tile_bf16<D, LD, BM>(Qs, q + (size_t)b * Sq * H * D, m0, Sq, H, h);
  load_tile_bf16<D, LD, BM>(dOs, dout + (size_t)b * Sq * H * D, m0, Sq, H, h);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags<D, LD>(qf, Qs, warp * 16, g, t);
  load_a_frags<D, LD>(dof, dOs, warp * 16, g, t);

  const int row_a = m0 + warp * 16 + g;   // rows of c[.][0..1]; c[.][2..3] are row_a + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row_a + r * 8;
    size_t i = ((size_t)b * Sq + row) * H + h;
    lse_r[r] = row < Sq ? lse[i] : 0.f;
    del_r[r] = row < Sq ? delta[i] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_end = causal ? min(Skv, m0 + BM) : Skv;   // tiles above the diagonal skipped
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();                     // every warp is done with the previous K/V tile
    load_tile_bf16<D, LD, BN>(Ks, kb, n0, Skv, KVH, kvh);
    load_tile_bf16<D, LD, BN>(Vs, vb, n0, Skv, KVH, kvh);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    mma_abt<D, LD>(s, qf, Ks, g, t);     // S = Q K^T
    mma_abt<D, LD>(dp, dof, Vs, g, t);   // dP = dO V^T

    // P from lse, dS = P (dP - delta) scale; masked entries are 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = n0 + nt * 8 + t * 2 + (e & 1);
        int r = e >> 1, row = row_a + r * 8;
        bool ok = row < Sq && col < Skv && (!causal || col <= row);
        float p = ok ? __expf(s[nt][e] * scale - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - del_r[r]) * scale;
      }
    }
    mma_xt<D, LD>(acc, s, Ks, lane);     // dq += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row_a + r * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8 + t * 2) = pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// K2b. 4 warps; warp w owns keys [16w, 16w+16) of the tile. Products are
// taken transposed (keys as rows): S^T = K Q^T, dP^T = V dO^T, so the rows
// of every fragment are this warp's keys and the columns are queries.
template <int D>
__global__ void __launch_bounds__(128)
attn_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                 int H, int KVH, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BN * LD;
  __nv_bfloat16* Qs = Vs + BN * LD;
  __nv_bfloat16* dOs = Qs + BM * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BM * LD);
  float* del_s = lse_s + BM;

  const int n0 = blockIdx.x * BN, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * H * D;
  const __nv_bfloat16* dob = dout + (size_t)b * Sq * H * D;

  load_tile_bf16<D, LD, BN>(Ks, k + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);
  load_tile_bf16<D, LD, BN>(Vs, v + (size_t)b * Skv * KVH * D, n0, Skv, KVH, kvh);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int key_a = n0 + warp * 16 + g;   // keys of c[.][0..1]; c[.][2..3] are key_a + 8
  const int m_start = causal ? n0 : 0;    // q-tiles wholly above the diagonal skipped (BM == BN)
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    for (int m0 = m_start; m0 < Sq; m0 += BM) {
      __syncthreads();                   // every warp is done with the previous Q/dO tile
      load_tile_bf16<D, LD, BM>(Qs, qb, m0, Sq, H, h);
      load_tile_bf16<D, LD, BM>(dOs, dob, m0, Sq, H, h);
      for (int r = threadIdx.x; r < BM; r += blockDim.x) {
        int row = m0 + r;
        size_t i = ((size_t)b * Sq + row) * H + h;
        lse_s[r] = row < Sq ? lse[i] : 0.f;
        del_s[r] = row < Sq ? delta[i] : 0.f;
      }
      __syncthreads();

      float st[8][4], dpt[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
      {
        uint32_t af[D / 16][4];
        load_a_frags<D, LD>(af, Ks, warp * 16, g, t);
        mma_abt<D, LD>(st, af, Qs, g, t);    // S^T = K Q^T
        load_a_frags<D, LD>(af, Vs, warp * 16, g, t);
        mma_abt<D, LD>(dpt, af, dOs, g, t);  // dP^T = V dO^T
      }

      // P^T from lse (per query column), dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int c = nt * 8 + t * 2 + (e & 1), col = m0 + c;
          int key = key_a + (e >> 1) * 8;
          bool ok = col < Sq && key < Skv && (!causal || key <= col);
          float p = ok ? __expf(st[nt][e] * scale - lse_s[c]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - del_s[c]) * scale;
        }
      }
      mma_xt<D, LD>(dv_acc, st, dOs, lane);   // dv += P^T dO
      mma_xt<D, LD>(dk_acc, dpt, Qs, lane);   // dk += dS^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int key = key_a + r * 8;
    if (key >= Skv) continue;
    size_t base = (((size_t)b * Skv + key) * KVH + kvh) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(dk + base + i * 8 + t * 2) =
          pack_bf16(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + i * 8 + t * 2) =
          pack_bf16(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
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

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_dq(const Args& a, int is_bf16) {
  cudaError_t err;
  if (is_bf16) {
    size_t smem = (size_t)(2 * BM + 2 * BN) * (D + 8) * sizeof(__nv_bfloat16);
    if ((err = prepare(attn_bwd_dq_mma<D>, smem)) != cudaSuccess) return err;
    dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
    attn_bwd_dq_mma<D><<<grid, 128, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
        a.delta, static_cast<__nv_bfloat16*>(a.dq), a.Sq, a.Skv, a.H, a.KVH, a.scale, a.causal);
  } else {
    size_t smem = (size_t)(4 * FT * (D + 1) + FT * (FT + 1) + 2 * FT) * sizeof(float);
    if ((err = prepare(attn_bwd_dq_fma<D>, smem)) != cudaSuccess) return err;
    dim3 grid((a.Sq + FT - 1) / FT, a.H, a.B);
    attn_bwd_dq_fma<D><<<grid, 256, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KVH, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, int is_bf16) {
  cudaError_t err;
  if (is_bf16) {
    size_t smem = (size_t)(2 * BM + 2 * BN) * (D + 8) * sizeof(__nv_bfloat16) + 2 * BM * sizeof(float);
    if ((err = prepare(attn_bwd_dkv_mma<D>, smem)) != cudaSuccess) return err;
    dim3 grid((a.Skv + BN - 1) / BN, a.KVH, a.B);
    attn_bwd_dkv_mma<D><<<grid, 128, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout), a.lse,
        a.delta, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.Sq,
        a.Skv, a.H, a.KVH, a.scale, a.causal);
  } else {
    size_t smem = (size_t)(4 * FT * (D + 1) + 2 * FT * (FT + 1) + 2 * FT) * sizeof(float);
    if ((err = prepare(attn_bwd_dkv_fma<D>, smem)) != cudaSuccess) return err;
    dim3 grid((a.Skv + FT - 1) / FT, a.KVH, a.B);
    attn_bwd_dkv_fma<D><<<grid, 256, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.KVH, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int H, int KVH) {
  return B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || B > 65535 || H > 65535;
}

}  // namespace

// Both return 0, a cudaError_t, or -1 for a shape or type this file has no
// kernel for (head dims 32, 64, 128; H a multiple of KVH; B and H within the
// grid's y/z limits). All tensors contiguous in the layouts named at the top.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Skv, int H, int KVH, int D,
                                      float scale, int causal, int is_bf16, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, B, Sq, Skv, H, KVH, scale, causal,
         static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dq<32>(a, is_bf16);
    case 64: return (int)launch_dq<64>(a, is_bf16);
    case 128: return (int)launch_dq<128>(a, is_bf16);
    default: return -1;
  }
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                                       int D, float scale, int causal, int is_bf16,
                                       void* stream) {
  if (bad_shape(B, Sq, Skv, H, KVH)) return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, B, Sq, Skv, H, KVH, scale, causal,
         static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dkv<32>(a, is_bf16);
    case 64: return (int)launch_dkv<64>(a, is_bf16);
    case 128: return (int)launch_dkv<128>(a, is_bf16);
    default: return -1;
  }
}
