// flash_attention forward for Hopper (sm_90a), hand-written.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:96 of the JAX reference package):
//   O = softmax(scale * Q K^T [+ causal mask]) V   for grouped-query attention,
//   q (B,Sq,H,D), k (B,Skv,KVH,D), v (B,Skv,KVH,DV) -> o (B,Sq,H,DV), plus
//   lse (B,Sq,H) fp32, at (D, DV) = (32, 32), (64, 64), (128, 128) and (192, 128),
// with an online softmax (fp32 running max / sum / accumulator), so the
// (Sq x Skv) scores never reach device memory. `lse` (natural log) is a second
// output that the TPU forward did not have: the backward kernels read it.
//
// What bounds it on an H100: at the serving path's shape (B=4, S=512, H=32,
// KVH=4, D=64, bf16, causal) the 19 MB of q, k, v, o and lse at 3.35 TB/s
// (5.7 us) take longer than the 4.3 GFLOP at the tensor cores' 989 TFLOP/s,
// so the bound is bytes; at the training path's shape (B=4, S=1024) the
// 17.2 GFLOP take 17.4 us against 11 us of bytes: operations. Every product
// therefore runs on the tensor cores (`mma.sync.m16n8k16`, bf16 operands,
// fp32 accumulate), q is read and o written once per block, the scores and
// probabilities stay in registers (the C fragments of S are repacked as the
// A fragments of P V), no tile above the causal diagonal is visited, and the
// K/V re-reads (by the G = H/KVH heads of a group and by every q-tile) are
// left to the 50 MB L2, which holds all of k and v at these sizes.
//
// MLA (deepseek-v2-236b's prefill): q and k carry head dim D = 192 (128 of
// the latent's per-head keys + 64 of the shared rope key), v DV = 128, with
// H = KVH = 128 (G = 1) and scale 192^-0.5. At B=4, S=512, causal the 336.6
// MB of q, k, v, o and lse take 0.100 ms at 3.35 TB/s against 0.044 ms for
// the 43.0 GFLOP at 989 TFLOP/s: the bound is bytes. The (D, DV) instance
// is the same pipeline templated on both widths: S = Q K^T is summed over D
// (12 k-steps of 16 at 192), while the V ring, P V, the accumulator, the
// softmax's rescale and the o epilogue run over DV; o is staged in the
// warp's own Q rows, which have room since DV <= D. Shared memory at 2
// stages is (64 + 2*64)(192 + 8) 2 B of Q and K plus 2*64(128 + 8) 2 B of V,
// 111,616 B, so two blocks still share an SM (228 KB). Q's 12 A fragments
// are NOT kept in registers there: beside 64 registers of accumulator and
// 32 of a 64-key S tile they took the instance to 255 registers with 28 B
// of spills (ptxas, on the card), so each KV tile ldmatrix-loads them from
// the warp's own Q rows, which stay in shared memory until the epilogue.
// The build's ptxas report must show no spill. The fp32 instance (192, 128)
// takes 148,736 B of shared memory, one block an SM.
//
// Design (bf16), the pipeline of the backward's dq pass (K2a):
//   * One 4-warp block per (64-row q-tile, query head, batch); warp w owns
//     rows [16w, 16w+16). The KV loop is inside the block, the running max,
//     sum and accumulator stay in registers. Grid (B*H, q-tiles): with
//     `causal` blockIdx.y = 0 is the LAST q-tile, which walks the most key
//     tiles, so the launch hands out the longest blocks first and the short
//     ones fill the tail instead of setting it.
//   * Copies overlap products: Q comes by cp.async with the first stages of
//     a ring of K/V tiles (3 stages at D <= 64, 2 at D >= 128); tile j+ST-1 is
//     in flight while tile j's two products run, so no tile's copy latency
//     stands between two barriers. Rows past the lengths load as zeros
//     (src-size 0).
//   * Operands come through ldmatrix (`mma_tile.cuh`, shared with K2): Q's A
//     fragments once, into registers, at D <= 128; K's B fragments by plain
//     ldmatrix, one x4 load for two mma; V's by ldmatrix.trans.
//   * Masks only where a tile needs one (`softmax_step<MASK>`, in
//     `mma_tile.cuh`, shared with K3): the causal
//     mask on the tile that crosses the diagonal, the length mask on the
//     ragged last tile; every other tile takes no index computation, compare
//     or select per score.
//   * Scores are scaled once by scale * log2(e) and exponentiated by ex2;
//     lse = m ln 2 + ln l comes out in natural log, as K2a/K2b read it.
//   * o is normalised, staged in the warp's own rows of the (then free) Q
//     buffer, and written in 16-byte pieces, one row of DV at a time, not as
//     4-byte pieces scattered over 8 rows.
//   * At most 168 registers at D <= 64, so 3 blocks (64 KB of shared memory
//     each at D = 64) share an SM; 2 blocks at D = 128 and at (192, 128). No
//     spills.
// Rows past Sq are computed on zeros and never written. The causal mask is
// top-left aligned (key index <= query index, no offset), as on the model
// path; the wrapper only admits `causal` with Sq == Skv. NEG_INF = -1e30 and
// the max(l, 1e-30) floor are kept so no row yields NaN. fp32 inputs take a
// second kernel that does the products as IEEE fp32 FMAs, since the tensor
// cores have no IEEE fp32 mode and TF32 would miss the 2e-5 tolerance.
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// outputs and the stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;
constexpr int BN = 64;                    // keys per KV tile
constexpr int MMA_WARPS = 4;              // bf16: 16 query rows a warp
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BM = 16 * MMA_WARPS;    // bf16: query rows per block
constexpr int BM = 64;                    // fp32: query rows per block

template <int D> __host__ __device__ constexpr int fwd_stages() { return D <= 64 ? 3 : 2; }

// Q's rows and each stage's K rows at D + 8 bf16, its V rows at DV + 8.
template <int D, int DV>
constexpr size_t fwd_smem() {
  return ((size_t)(MMA_BM + fwd_stages<D>() * BN) * (D + 8) +
          (size_t)fwd_stages<D>() * BN * (DV + 8)) * sizeof(__nv_bfloat16);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

// In the mma fragment layout thread (g = lane/4, t = lane%4) of warp w holds
// query rows 16w + g and 16w + g + 8 of the block's tile.
template <int D, int DV>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 3 : 2)
attn_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv, int H, int KVH, float scale,
             int causal) {
  constexpr int LD = D + 8;   // +16 bytes a row: ldmatrix rows hit distinct banks
  constexpr int LDV = DV + 8;
  constexpr int ST = fwd_stages<D>(), NT = BN / 8, STAGE = BN * (LD + LDV);
  static_assert(DV <= D, "o is staged in the warp's own rows of Q");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = Qs + MMA_BM * LD;   // ST stages of (K, V)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nq = (Sq + MMA_BM - 1) / MMA_BM;
  const int m0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * MMA_BM;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * KVH * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * KVH * DV;
  const int n_end = causal ? min(Skv, m0 + MMA_BM) : Skv;   // tiles above the diagonal skipped
  const int ntiles = (n_end + BN - 1) / BN;

  auto load_kv = [&](int j) {
    __nv_bfloat16* Ks = ring + (j % ST) * STAGE;
    cp_async_tile<D, LD, BN, MMA_THREADS>(Ks, kb, j * BN, Skv, KVH, kvh);
    cp_async_tile<DV, LDV, BN, MMA_THREADS>(Ks + BN * LD, vb, j * BN, Skv, KVH, kvh);
  };
  cp_async_tile<D, LD, MMA_BM, MMA_THREADS>(Qs, q + (size_t)b * Sq * H * D, m0, Sq, H, h);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < ntiles) load_kv(j);
    cp_async_commit();
  }

  // Q's A fragments stay in registers for the whole KV loop up to D = 128;
  // at D = 192 they would spill (255 registers, 28 B), so each KV tile
  // reads them from the warp's own Q rows in shared memory instead.
  constexpr bool Q_IN_REGS = D <= 128;
  __nv_bfloat16* q_rows = Qs + warp * 16 * LD;
  uint32_t qf[Q_IN_REGS ? D / 16 : 1][4];
  cp_async_wait<ST - 1>();               // Q is in
  __syncthreads();
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qf[kk], q_rows, kk, lane);
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  const int row_a = m0 + warp * 16 + g;  // rows of acc[.][0..1]; acc[.][2..3] are row_a + 8
  const float scale_log2 = scale * LOG2E;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<ST - 2>();             // this thread's pieces of tile j are in
    __syncthreads();                     // everyone's are; the stage of tile j - 1 is free
    if (j + ST - 1 < ntiles) load_kv(j + ST - 1);
    cp_async_commit();
    const __nv_bfloat16* Ks = ring + (j % ST) * STAGE;
    const __nv_bfloat16* Vs = Ks + BN * LD;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (Q_IN_REGS)
      mma_abt<D, LD, NT>(s, qf, Ks, lane);         // S = Q K^T
    else
      mma_abt<D, LD, NT>(s, q_rows, Ks, lane);

    const int n0 = j * BN;
    if ((causal && n0 + BN - 1 > m0) || n0 + BN > Skv)   // the diagonal tile; the ragged last
      softmax_step<true, NT, DV>(s, acc, m_run, l_run, scale_log2, row_a, n0 + t * 2, Skv, causal);
    else
      softmax_step<false, NT, DV>(s, acc, m_run, l_run, scale_log2, row_a, n0 + t * 2, Skv, causal);
    mma_xt<DV, LDV, BN / 16>(acc, s, Vs, lane);    // acc += P V
  }

  // Epilogue: finish the row sums over the quad, write lse, normalise o into
  // the warp's own 16 rows of Qs (only this warp ever read them), then store
  // those rows in 16-byte pieces.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const float l = fmaxf(l_run[r], 1e-30f);
    inv[r] = 1.f / l;
    const int row = row_a + r * 8;
    if (t == 0 && row < Sq) lse[((size_t)b * Sq + row) * H + h] = m_run[r] * LN2 + logf(l);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(q_rows + (g + r * 8) * LD + i * 8 + t * 2) =
          pack_bf16(acc[i][2 * r] * inv[r], acc[i][2 * r + 1] * inv[r]);
  }
  __syncwarp();                          // every lane's rows are staged
  constexpr int CHUNKS = DV / 8;         // 16-byte pieces a row
#pragma unroll
  for (int j = 0; j < 16 * CHUNKS / 32; ++j) {
    const int i = lane + j * 32, r = i / CHUNKS, c = (i % CHUNKS) * 8, row = m0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(o + (((size_t)b * Sq + row) * H + h) * DV + c) =
          *reinterpret_cast<const uint4*>(q_rows + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on tiles in shared memory
// ---------------------------------------------------------------------------

// 256 threads as a 16x16 grid; thread (ty, tx) owns rows ty+16i (i<4) and, for
// the scores, keys tx+16j (j<4), for the output, columns tx+16j (j<DV/16).
template <int D, int DV>
__global__ void __launch_bounds__(256)
attn_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int Sq, int Skv, int H, int KVH, float scale, int causal) {
  constexpr int LDK = D + 1;    // odd stride: a warp's 16 keys fall in 16 banks
  constexpr int LDS = BN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BM][D]
  float* Ks = Qs + BM * D;                          // [BN][LDK]
  float* Vs = Ks + BN * LDK;                        // [BN][DV]
  float* Ss = Vs + BN * DV;                         // [BM][LDS] scores, then probabilities
  float* m_s = Ss + BM * LDS;                       // [BM] running max
  float* l_s = m_s + BM;                            // [BM] running sum
  float* a_s = l_s + BM;                            // [BM] rescale factor of this tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + (size_t)b * Sq * H * D;
  const float* kb = k + (size_t)b * Skv * KVH * D;
  const float* vb = v + (size_t)b * Skv * KVH * DV;

  for (int idx = tid; idx < BM * D; idx += 256) {
    int r = idx / D, d = idx % D, row = m0 + r;
    Qs[idx] = row < Sq ? qb[((size_t)row * H + h) * D + d] : 0.f;
  }
  if (tid < BM) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  float acc[4][DV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) acc[i][j] = 0.f;

  const int n_end = causal ? min(Skv, m0 + BM) : Skv;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();                       // previous tile fully consumed (and Qs, m_s, l_s set)
    for (int idx = tid; idx < BN * D; idx += 256) {
      int r = idx / D, d = idx % D, row = n0 + r;
      bool ok = row < Skv;
      size_t off = ((size_t)row * KVH + kvh) * D + d;
      Ks[r * LDK + d] = ok ? kb[off] : 0.f;
      if (DV == D) Vs[idx] = ok ? vb[off] : 0.f;
    }
    if (DV != D)
      for (int idx = tid; idx < BN * DV; idx += 256) {
        int r = idx / DV, d = idx % DV, row = n0 + r;
        Vs[idx] = row < Skv ? vb[((size_t)row * KVH + kvh) * DV + d] : 0.f;
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
      for (int j = 0; j < DV / 16; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pv[4], vv[DV / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) vv[j] = Vs[kk * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DV / 16; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
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
    for (int j = 0; j < DV / 16; ++j) o[base * DV + tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) lse[base] = m_s[r] + logf(l);
  }
}

template <int D, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int H, int KVH, float scale, int causal,
                       dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_mma<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_mma<D, DV><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, KVH,
      scale, causal);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Skv, int H, int KVH, float scale, int causal,
                       dim3 grid, cudaStream_t stream) {
  size_t smem =
      (size_t)(BM * D + BN * (D + 1) + BN * DV + BM * (BN + 1) + 3 * BM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_fma<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_fma<D, DV><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, H, KVH, scale, causal);
  return cudaGetLastError();
}

// The grid the host's plan (`attn_fwd_plan`) launches: bf16 (B*H, q-tiles),
// fp32 (q-tiles, H, B), one block for each (q-tile, head, batch).
dim3 planned_grid(int B, int Sq, int H, int is_bf16) {
  return is_bf16 ? dim3(B * H, (Sq + MMA_BM - 1) / MMA_BM, 1) : dim3((Sq + BM - 1) / BM, H, B);
}

}  // namespace

// Returns 0, a cudaError_t, or -1 for a shape, type or grid this file has no
// kernel for ((D, Dv) one of (32, 32), (64, 64), (128, 128), (192, 128); H a
// multiple of KVH; B, H and the q-tiles within the grids' limits; the grid of
// `attn_fwd_plan`). All tensors contiguous in the layouts named at the top.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Skv, int H, int KVH, int D,
                                   int Dv, float scale, int causal, int is_bf16, int grid_x,
                                   int grid_y, int grid_z, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || B > 65535 || H > 65535) return -1;
  // the bf16 grid is (B*H, q-tiles): x up to 2^31 - 1, y up to 65535
  if (is_bf16 && ((long long)B * H > 0x7fffffffLL || (Sq + MMA_BM - 1) / MMA_BM > 65535))
    return -1;
  const dim3 grid(grid_x, grid_y, grid_z), want = planned_grid(B, Sq, H, is_bf16);
  if (grid.x != want.x || grid.y != want.y || grid.z != want.z) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
#define CASE(FN, DQ, DO)                                                              \
  if (D == DQ && Dv == DO)                                                            \
    return (int)FN<DQ, DO>(q, k, v, o, lse_f, B, Sq, Skv, H, KVH, scale, causal, grid, st);
#define DISPATCH(FN) \
  CASE(FN, 32, 32) CASE(FN, 64, 64) CASE(FN, 128, 128) CASE(FN, 192, 128) return -1;
  if (is_bf16) {
    DISPATCH(launch_mma)
  }
  DISPATCH(launch_fma)
#undef DISPATCH
#undef CASE
}
