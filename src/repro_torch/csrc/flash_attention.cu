// flash_attention forward for Hopper (sm_90a), hand-written.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:96 of the JAX reference package):
//   O = softmax(scale * Q K^T [+ causal mask]) V   for grouped-query attention,
//   q (B,Sq,H,D), k/v (B,Skv,KVH,D) -> o (B,Sq,H,D), plus lse (B,Sq,H) fp32,
// with an online softmax (fp32 running max / sum / accumulator), so the
// (Sq x Skv) scores never reach device memory. `lse` is a second output that
// the TPU forward did not have: the backward kernels need it.
//
// What bounds it on an H100: at the serving path's shape (B=4, S=512, H=32,
// KVH=4, D=64, bf16, causal) the 19 MB of q, k, v, o at 3.35 TB/s take longer
// than the 4.3 GFLOP at the tensor cores' 989 TFLOP/s, so the bound is bytes.
// The design therefore reads q once and writes o once per block, keeps every
// intermediate in registers or shared memory, and leaves K/V re-reads (each
// K/V tile is read by the G = H/KVH query heads of its group and by every
// q-tile) to the 50 MB L2, which holds all of k and v at these sizes.
//
// What differs from the TPU kernel, whose grid ran in order on one core and
// carried the accumulator in scratch between grid steps:
//   * one block per (batch, query head, 64-row q-tile); the loop over KV tiles
//     is inside the block and the running max / sum / acc stay in registers;
//   * the (B,S,H,D) layout is read in place by computing offsets (no
//     transposed copies); the KV head of query head h is h / G;
//   * ragged tails are masked, so neither Sq nor Skv need be a tile multiple;
//   * under `causal`, KV tiles wholly above the diagonal are skipped;
//   * bf16 operands go to the tensor cores as bf16 (`mma.sync.m16n8k16`, fp32
//     accumulate) instead of being upcast tile by tile; fp32 inputs take a
//     second kernel that does the products as fp32 FMAs, since the tensor
//     cores have no IEEE fp32 mode and TF32 would miss the 2e-5 tolerance.
// The causal mask is top-left aligned (key index <= query index, no offset),
// as on the model path; the wrapper only admits `causal` with Sq == Skv.
// NEG_INF = -1e30 and the max(l, 1e-30) floor are kept so no row yields NaN.
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// outputs and the stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per KV tile

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way, so
// that row-major V[key][d] arrives as the k-major B operand of P.V.
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

// Copies `ROWS` rows of D bf16 (row `r` of the tile is row `row0 + r` of a
// (S, heads, D) slab, head `head`) into shared memory with row stride LD, in
// 16-byte pieces; rows at or beyond `S` are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int S, int heads, int head) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += blockDim.x) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      size_t off = ((size_t)row * heads + head) * D + c;
      val = *reinterpret_cast<const uint4*>(src + off);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// 4 warps; warp w owns query rows [16w, 16w+16) of the tile. Within a warp the
// mma fragment layout gives thread (g = lane/4, t = lane%4) rows g and g+8.
template <int D>
__global__ void __launch_bounds__(128)
attn_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv, int H, int KVH, float scale,
             int causal) {
  constexpr int LD = D + 8;   // +16 bytes a row: fragment loads hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;

  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const __nv_bfloat16* qb = q + (size_t)b * Sq * H * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * KVH * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * KVH * D;

  load_tile_bf16<D, LD, BM>(Qs, qb, m0, Sq, H, h);
  __syncthreads();

  // Q fragments stay in registers for the whole KV loop.
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* q0 = Qs + (warp * 16 + g) * LD + t * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(q0 + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(q0 + 8 * LD + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + kk * 16 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(q0 + 8 * LD + kk * 16 + 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};          // this thread's share; summed over the quad at the end

  const int row_a = m0 + warp * 16 + g;  // rows of acc[.][0..1]; acc[.][2..3] are row_a + 8
  const int n_end = causal ? min(Skv, m0 + BM) : Skv;   // tiles above the diagonal are skipped

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();                     // every warp is done with the previous K/V tile
    load_tile_bf16<D, LD, BN>(Ks, kb, n0, Skv, KVH, kvh);
    load_tile_bf16<D, LD, BN>(Vs, vb, n0, Skv, KVH, kvh);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows against 64 keys: 8 n-tiles of 8 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + kk * 16 + t * 2;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_bf16_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale, mask (ragged tail and diagonal), running max
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = n0 + nt * 8 + t * 2 + (e & 1);
        int row = row_a + (e >> 1) * 8;
        bool ok = col < Skv && (!causal || col <= row);
        float x = ok ? s[nt][e] * scale : NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = __expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0]; acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1]; acc[i][3] *= alpha[1];
    }

    // acc += P V. The C fragments of two neighbouring n-tiles of S are exactly
    // the A fragment of one 16-key step, so P never leaves registers.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lane -> row of one of the four 8x8 blocks: keys (+8 for odd blocks),
      // d-columns (+8 for blocks 2 and 3)
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + (lane % 8) + ((lane / 8) & 1) * 8) * LD + (lane / 16) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + dt * 16);
        mma_bf16_16816(acc[2 * dt], pa, vf[0], vf[1]);
        mma_bf16_16816(acc[2 * dt + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: finish the row sums over the quad, normalise, store o and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row_a + r * 8;
    if (row >= Sq) continue;
    float inv = 1.f / l_run[r];
    size_t base = (((size_t)b * Sq + row) * H + h);
    __nv_bfloat16* orow = o + base * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + i * 8 + t * 2) =
          pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    if (t == 0) lse[base] = m_run[r] + logf(l_run[r]);
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on tiles in shared memory
// ---------------------------------------------------------------------------

// 256 threads as a 16x16 grid; thread (ty, tx) owns rows ty+16i (i<4) and, for
// the scores, keys tx+16j (j<4), for the output, columns tx+16j (j<D/16).
template <int D>
__global__ void __launch_bounds__(256)
attn_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int Sq, int Skv, int H, int KVH, float scale, int causal) {
  constexpr int LDK = D + 1;    // odd stride: a warp's 16 keys fall in 16 banks
  constexpr int LDS = BN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BM][D]
  float* Ks = Qs + BM * D;                          // [BN][LDK]
  float* Vs = Ks + BN * LDK;                        // [BN][D]
  float* Ss = Vs + BN * D;                          // [BM][LDS] scores, then probabilities
  float* m_s = Ss + BM * LDS;                       // [BM] running max
  float* l_s = m_s + BM;                            // [BM] running sum
  float* a_s = l_s + BM;                            // [BM] rescale factor of this tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + (size_t)b * Sq * H * D;
  const float* kb = k + (size_t)b * Skv * KVH * D;
  const float* vb = v + (size_t)b * Skv * KVH * D;

  for (int idx = tid; idx < BM * D; idx += 256) {
    int r = idx / D, d = idx % D, row = m0 + r;
    Qs[idx] = row < Sq ? qb[((size_t)row * H + h) * D + d] : 0.f;
  }
  if (tid < BM) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int n_end = causal ? min(Skv, m0 + BM) : Skv;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();                       // previous tile fully consumed (and Qs, m_s, l_s set)
    for (int idx = tid; idx < BN * D; idx += 256) {
      int r = idx / D, d = idx % D, row = n0 + r;
      bool ok = row < Skv;
      size_t off = ((size_t)row * KVH + kvh) * D + d;
      Ks[r * LDK + d] = ok ? kb[off] : 0.f;
      Vs[idx] = ok ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = ty + 16 * i, c = tx + 16 * j;
        int row = m0 + r, col = n0 + c;
        bool ok = col < Skv && (!causal || col <= row);
        Ss[r * LDS + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    __syncthreads();

    // online softmax: 4 neighbouring lanes share a row, 16 keys each
    {
      int r = tid / 4, part = tid % 4;
      float* srow = Ss + r * LDS + part * 16;
      float m_prev = m_s[r], l_prev = l_s[r];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {                     // after the shuffles: all four lanes have read m_s, l_s
        float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_prev * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pv[4], vv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = ty + 16 * i, row = m0 + r;
    if (row >= Sq) continue;
    float l = fmaxf(l_s[r], 1e-30f);
    float inv = 1.f / l;
    size_t base = ((size_t)b * Sq + row) * H + h;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[base * D + tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) lse[base] = m_s[r] + logf(l);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int H, int KVH, float scale, int causal,
                       cudaStream_t stream) {
  size_t smem = (size_t)(BM + 2 * BN) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  attn_fwd_mma<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, KVH,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int H, int KVH, float scale, int causal,
                       cudaStream_t stream) {
  size_t smem = (size_t)(BM * D + BN * (D + 1) + BN * D + BM * (BN + 1) + 3 * BM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_fma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  attn_fwd_fma<D><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, H, KVH, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Returns 0, a cudaError_t, or -1 for a shape or type this file has no kernel
// for (head dims 32, 64, 128; H a multiple of KVH; B and H within the grid's
// y/z limits). All tensors contiguous in the layouts named at the top.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Skv, int H, int KVH, int D,
                                   float scale, int causal, int is_bf16, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || B > 65535 || H > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
#define DISPATCH(FN)                                                                         \
  switch (D) {                                                                               \
    case 32: return (int)FN<32>(q, k, v, o, lse_f, B, Sq, Skv, H, KVH, scale, causal, st);   \
    case 64: return (int)FN<64>(q, k, v, o, lse_f, B, Sq, Skv, H, KVH, scale, causal, st);   \
    case 128: return (int)FN<128>(q, k, v, o, lse_f, B, Sq, Skv, H, KVH, scale, causal, st); \
    default: return -1;                                                                      \
  }
  if (is_bf16) {
    DISPATCH(launch_mma)
  }
  DISPATCH(launch_fma)
#undef DISPATCH
}
