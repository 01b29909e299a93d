// ssd_scan for Hopper (sm_90a), hand-written: the Mamba-2 SSD chunked scan.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan.py:21-67, pallas_call at :89 of the JAX
// reference package). Per (sequence b, head h) and chunk of L = 64 tokens:
//   seg   = cumsum(dt * A)                                     (L)
//   y     = ((C B^T) . exp(seg_i - seg_j) . [j <= i]) (x * dt)  intra-chunk
//         + exp(seg_i) * (C state)                             inter-chunk
//   state = (B . exp(seg_L - seg_j))^T (x * dt) + exp(seg_L) * state
//   x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, B/C (B,S,N)
//     -> y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32,
// from a zero state. The TPU kernel dropped the final state; the model's
// chunked scan returns it, so this kernel does too. B and C are indexed by b,
// not repeated per head as the TPU wrapper did. The chunk length is the
// kernel's own (64, whatever the model's ssm_chunk is: the result depends on
// it only through summation order); a ragged tail arrives as zeros, so its
// dt = 0 means no decay and no input.
//
// What bounds it on an H100: bytes. x and y dominate (2*B*S*H*P elements);
// at the serving path's shape (B=4, S=512, H=64, P=64, N=64, bf16) the
// 38.8 MB of inputs and outputs take 0.0116 ms at 3.35 TB/s, and the 4.3 GFLOP of the four
// products per chunk, 2*L*(L*N + L*P + 2*N*P) per (b, h), take 0.0043 ms on
// the tensor cores. What sets the pace in practice is the chain of chunks:
// each (b, h) walks its S/64 chunks in order, the state of one feeding the
// next, and every chunk is a few dependent products.
//
// Two routes, picked on the host (`ssd_plan`, kernels/ssd_scan.py) before
// any launch:
//
// "mma", `ssd_chunk_scan_mma<P, N>` (bf16; N of 64 or 128, P of 16 to 64):
//   * One 4-warp block per (b, h) with the chunk loop inside, so the state
//     never leaves the SM. Warp w owns rows [16w, 16w+16) of a chunk's y and
//     N/4 rows of the (N x P) state, which lives in the warps' fp32 mma
//     accumulators (registers) from the first chunk to the last.
//   * A 2-stage cp.async ring over chunks: chunk c+1's x (L x P of head h,
//     rows H*P apart), B and C (L x N) and dt (L fp32) are in flight while
//     chunk c computes; 16-byte pieces, rows past S as zeros.
//   * Per chunk, one block barrier. Every warp scans dt*A itself (log2 units,
//     two tokens a lane) into its own scratch, so no barrier waits on it.
//     Sc = C B^T (mma_abt, C's A fragments by ldmatrix) is scaled in the
//     accumulator fragment by exp(seg_i - seg_j) dt_j, masked above the
//     diagonal and packed to bf16 A fragments at once. Then y = exp(seg_i)
//     (C st), st the entering state as a bf16 (N x P) tile, plus att x, x
//     read through ldmatrix.trans (mma_ab). y is rounded to bf16 once and
//     leaves in 16-byte rows through the warp's staging rows. C's fragments
//     are loaded again for the second product rather than held: held, they
//     cost N/4 registers a thread and P=128 or N=128 spilled.
//     The state update st <- exp(seg_L) st + W^T x takes W^T's A fragments
//     straight from B by ldmatrix.trans, scales them by
//     exp(seg_L - seg_j) dt_j in fp32 and splits them into bf16 hi + lo.
//     The next chunk's bf16 state tile is double-buffered, so no second
//     barrier is needed before it is written.
//   * The final state leaves through shared memory as (P, N) fp32 rows.
//   Precision: the products are exact on bf16 inputs (C B^T, x) and sum in
//   fp32. Three roundings are new: att * dt to bf16 (y_intra's operand), the
//   state to bf16 (y_inter's operand), and W = hi + lo (the state update,
//   about 16 bits of W kept). An fp32 emulation of exactly these points
//   (tests/test_torch_ssd_plan.py) holds y within 2e-2 + 2e-2|y| and a
//   relative norm error of 1e-2, the final state within 2e-4 + 2e-3|s| of
//   the fp32 oracle: the tolerances the kernel is held to on the card. With
//   hi alone the state lands 10x or more further off, beyond its
//   tolerance: the lo term is not optional.
//
// "fma", `ssd_chunk_scan<T, P>` (fp32, and bf16 shapes the mma route does
// not take): 256 threads, every product an fp32 FMA from shared memory, the
// (N x P) fp32 state in shared memory, synchronous loads. fp32 keeps it:
// tensor cores at TF32 would miss its 2e-4 / 2e-3 checks.
//
// Plain C interface, no allocation, no synchronisation, no atomics (two
// launches are bit-identical): the caller provides the outputs and the
// stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int L = 64;            // tokens per chunk
constexpr int SMEM_MAX = 227 * 1024;

// ---------------------------------------------------------------------------
// fp32 (and bf16 shapes the mma route does not take): FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;     // a 16 x 16 grid of threads

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared memory in floats: at most 227 KB, so N * P is bounded (N = 128 at
// P = 128 fits).
__host__ __device__ inline int smem_floats(int P, int N) {
  return L * P + 2 * L * (N + 1) + L * (L + 1) + N * P + 3 * L;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int N) {
  constexpr int PC = P / 16;            // output columns per thread
  const int LDN = N + 1;                // odd stride: 16 rows of a warp fall in 16 banks
  constexpr int LDA = L + 1;
  extern __shared__ __align__(16) float smem[];
  float* xdt = smem;                    // [L][P]    x * dt
  float* Bs = xdt + L * P;              // [L][LDN]
  float* Cs = Bs + L * LDN;             // [L][LDN]
  float* att = Cs + L * LDN;            // [L][LDA]  (C B^T) . decay . mask
  float* st = att + L * LDA;            // [N][P]    the carried state
  float* dts = st + N * P;              // [L]
  float* seg = dts + L;                 // [L]
  float* dout = seg + L;                // [L]       exp(seg_L - seg_j)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h];

  for (int idx = tid; idx < N * P; idx += THREADS) st[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int len = min(L, S - c0);
    __syncthreads();                    // the previous chunk is done with every tile
    if (tid < L) dts[tid] = tid < len ? dt[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    for (int idx = tid; idx < L * N; idx += THREADS) {
      int r = idx / N, n = idx % N;
      bool ok = r < len;
      size_t off = ((size_t)b * S + c0 + r) * N + n;
      Bs[r * LDN + n] = ok ? to_float(bm[off]) : 0.f;
      Cs[r * LDN + n] = ok ? to_float(cm[off]) : 0.f;
    }
    __syncthreads();                    // dts ready
    for (int idx = tid; idx < L * P; idx += THREADS) {
      int r = idx / P, p = idx % P;
      xdt[idx] = r < len ? to_float(x[(((size_t)b * S + c0 + r) * H + h) * P + p]) * dts[r] : 0.f;
    }
    if (warp == 0) {                    // seg = inclusive cumsum of dt * A, two tokens a lane
      float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      // s is now the inclusive sum through token 2 lane + 1
      float total = __shfl_sync(0xffffffffu, s, 31);
      seg[2 * lane] = s - v1;
      seg[2 * lane + 1] = s;
      dout[2 * lane] = expf(total - (s - v1));
      dout[2 * lane + 1] = expf(total - s);
    }
    __syncthreads();

    // att[i][j] = (C_i . B_j) exp(seg_i - seg_j) for j <= i, else 0
    {
      float s4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s4[i][j] = fmaf(cv[i], bv[j], s4[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int r = ty + 16 * i, c = tx + 16 * j;
          att[r * LDA + c] = c <= r ? s4[i][j] * expf(seg[r] - seg[c]) : 0.f;
        }
    }
    __syncthreads();

    // y[i][p] = sum_j att[i][j] xdt[j][p] + exp(seg_i) sum_n C[i][n] st[n][p]
    {
      float yd[4][PC], yo[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) yd[i][c] = yo[i][c] = 0.f;
      for (int j = 0; j < L; ++j) {
        float av[4], xv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = att[(ty + 16 * i) * LDA + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xdt[j * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) yd[i][c] = fmaf(av[i], xv[c], yd[i][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = st[n * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) yo[i][c] = fmaf(cv[i], sv[c], yo[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int r = ty + 16 * i;
        if (r >= len) continue;
        float e = expf(seg[r]);
        T* yrow = y + (((size_t)b * S + c0 + r) * H + h) * P;
#pragma unroll
        for (int c = 0; c < PC; ++c) from_float(yrow + tx + 16 * c, yd[i][c] + e * yo[i][c]);
      }
    }
    __syncthreads();                    // every thread has read the old state

    // st[n][p] = exp(total) st[n][p] + sum_j B[j][n] exp(total - seg_j) xdt[j][p]
    {
      const float et = expf(seg[L - 1]);
      for (int n0 = 0; n0 < N; n0 += 64) {      // rows n0 + ty + 16 i, i < 4
        float u[4][PC];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) u[i][c] = 0.f;
        for (int j = 0; j < L; ++j) {
          float w[4], xv[PC];
          const float dj = dout[j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            int n = n0 + ty + 16 * i;
            w[i] = n < N ? Bs[j * LDN + n] * dj : 0.f;
          }
#pragma unroll
          for (int c = 0; c < PC; ++c) xv[c] = xdt[j * P + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < PC; ++c) u[i][c] = fmaf(w[i], xv[c], u[i][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int n = n0 + ty + 16 * i;
          if (n >= N) continue;
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            float* sp = st + n * P + tx + 16 * c;
            *sp = u[i][c] + et * *sp;
          }
        }
      }
    }
  }
  __syncthreads();

  float* so = state_out + (size_t)blockIdx.x * P * N;     // (P, N) of this (b, h)
  for (int idx = tid; idx < N * P; idx += THREADS) {
    int p = idx / N, n = idx % N;
    so[idx] = st[n * P + p];
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* bm, const void* cm,
                   void* y, float* state, int B, int S, int H, int N, cudaStream_t stream) {
  size_t smem = (size_t)smem_floats(P, N) * sizeof(float);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<T, P><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), state, S, H, N);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* bm, const void* cm,
             void* y, float* state, int B, int S, int H, int P, int N, cudaStream_t st) {
  switch (P) {
    case 16: return (int)launch<T, 16>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    case 32: return (int)launch<T, 32>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    case 64: return (int)launch<T, 64>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    case 128: return (int)launch<T, 128>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    default: return -1;
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;                 // 16 rows of a chunk's y a warp
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_STAGES = 2;                // chunks in the cp.async ring
constexpr int MMA_ACC_REGS = 96;             // most fp32 accumulator values a thread carries

// A thread carries N * P / MMA_THREADS state values and P / 2 of y: beyond
// MMA_ACC_REGS (P = 128) ptxas spills, at 255 registers.
constexpr bool mma_takes(int P, int N) {
  return (N == 64 || N == 128) && N * P / MMA_THREADS + P / 2 <= MMA_ACC_REGS;
}

// Shared memory in bytes: the ring (each stage x, B, C in bf16 with rows
// padded by 16 bytes, and dt), two bf16 (N x P) state tiles, each warp's 16
// rows of y on their way out, and each warp's seg and dout.
__host__ __device__ constexpr size_t mma_stage_bytes(int P, int N) {
  return (size_t)2 * L * ((P + 8) + 2 * (N + 8)) + (size_t)4 * L;
}
__host__ __device__ constexpr size_t mma_smem_bytes(int P, int N) {
  return MMA_STAGES * mma_stage_bytes(P, N) + (size_t)2 * 2 * N * (P + 8) +
         (size_t)2 * MMA_WARPS * 16 * (P + 8) + (size_t)4 * MMA_WARPS * 2 * L;
}

// W^T's A fragment (B's values times the fragment's dout_j) as bf16 hi + lo:
// v holds B[j][n], B[j+1][n] (low half first), d the two dout_j.
__device__ __forceinline__ void split_scaled(uint32_t v, float2 d, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const float w0 = __low2float(b2) * d.x, w1 = __high2float(b2) * d.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(w0, w1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(w0 - __low2float(h2), w1 - __high2float(h2));
}

// In the fragment layout thread (g = lane/4, t = lane%4) of warp w holds y
// rows 16w + g and 16w + g + 8 of a chunk, and state rows n0 + g, n0 + g + 8
// of each of its 16-row slabs n0.
// Two blocks an SM at P = N = 64 (shared memory allows it): the bound also
// steers ptxas to a schedule that ran 0-9 % faster on an H100 than without
// it, and without spills at P <= 64.
template <int P, int N>
__global__ void __launch_bounds__(MMA_THREADS, 2)
ssd_chunk_scan_mma(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const __nv_bfloat16* __restrict__ bm,
                   const __nv_bfloat16* __restrict__ cm, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ state_out, int S, int H) {
  constexpr int LDX = P + 8, LDN = N + 8;    // +16 bytes a row: ldmatrix rows in distinct banks
  constexpr int PT = P / 8;                  // 8-column tiles of y and of the state
  constexpr int NS = N / 16 / MMA_WARPS;     // 16-row state slabs a warp owns
  constexpr int STAGE = (int)mma_stage_bytes(P, N) / 2;   // in bf16 elements
  constexpr int LDT = N + 4;                 // the final state's staging rows (fp32)
  static_assert(P % 16 == 0 && N % (16 * MMA_WARPS) == 0, "whole fragments");
  static_assert((size_t)P * LDT * 4 <= MMA_STAGES * mma_stage_bytes(P, N),
                "the final state's staging fits the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sts = ring + MMA_STAGES * STAGE;     // [2][N][LDX] state entering a chunk
  __nv_bfloat16* ys = sts + 2 * N * LDX;              // [warps][16][LDX] y on its way out
  float* scratch = reinterpret_cast<float*>(ys + MMA_WARPS * 16 * LDX);   // [warps][2][L]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a2 = A[h] * LOG2E;             // seg in log2 units: exp(u) = ex2(u log2 e)
  const int nchunks = (S + L - 1) / L;
  const __nv_bfloat16* xb = x + (size_t)b * S * H * P;
  const __nv_bfloat16* bb = bm + (size_t)b * S * N;
  const __nv_bfloat16* cb = cm + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H;
  float* seg = scratch + warp * 2 * L;       // this warp's cumsum(dt A), log2 units
  float* dout = seg + L;                     // exp(seg_L - seg_j) dt_j
  const int row0 = warp * 16;                // this warp's rows of y in a chunk
  const int i0 = row0 + g;                   // the fragments' rows i0 and i0 + 8

  auto load_chunk = [&](int c) {
    __nv_bfloat16* dst = ring + (c % MMA_STAGES) * STAGE;
    const int c0 = c * L;
    cp_async_rows<P, LDX, L, MMA_THREADS>(dst, xb, c0, S, H, h, tid);
    cp_async_rows<N, LDN, L, MMA_THREADS>(dst + L * LDX, bb, c0, S, 1, 0, tid);
    cp_async_rows<N, LDN, L, MMA_THREADS>(dst + L * LDX + L * LDN, cb, c0, S, 1, 0, tid);
    if (tid < L) {
      const bool ok = c0 + tid < S;
      cp_async4(reinterpret_cast<float*>(dst + L * LDX + 2 * L * LDN) + tid,
                dtb + (size_t)(ok ? c0 + tid : 0) * H + h, ok);
    }
  };

  float st[NS][PT][4];                       // this warp's state rows, fp32, across chunks
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) st[k][nt][0] = st[k][nt][1] = st[k][nt][2] = st[k][nt][3] = 0.f;

#pragma unroll
  for (int c = 0; c < MMA_STAGES - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_async_commit();
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<MMA_STAGES - 2>();         // this thread's pieces of chunk c are in
    __syncthreads();                         // everyone's are; chunk c - 1 is done with all tiles
    if (c + MMA_STAGES - 1 < nchunks) load_chunk(c + MMA_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* Xs = ring + (c % MMA_STAGES) * STAGE;
    const __nv_bfloat16* Bs = Xs + L * LDX;
    const __nv_bfloat16* Cs = Bs + L * LDN;
    const float* dts = reinterpret_cast<const float*>(Cs + L * LDN);

    // seg = inclusive cumsum of dt A, two tokens a lane; every warp its own copy
    {
      const float2 d = reinterpret_cast<const float2*>(dts)[lane];
      const float v0 = d.x * a2, v1 = d.y * a2;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      const float total = __shfl_sync(0xffffffffu, s, 31);
      seg[2 * lane] = s - v1;
      seg[2 * lane + 1] = s;
      dout[2 * lane] = ex2(total - (s - v1)) * d.x;
      dout[2 * lane + 1] = ex2(total - s) * d.y;
      __syncwarp();
    }
    const float seg_r[2] = {seg[i0], seg[i0 + 8]};

    // att = C B^T . exp(seg_i - seg_j) dt_j . [j <= i], C's A fragments by
    // ldmatrix from this warp's 16 rows; packed to bf16 at once as the A
    // fragments of y_intra, so the fp32 scores die before y's accumulator lives
    uint32_t att[L / 16][4];
    {
      float s[L / 8][4];
#pragma unroll
      for (int nt = 0; nt < L / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      mma_abt<N, LDN, L / 8>(s, Cs + row0 * LDN, Bs, lane);
#pragma unroll
      for (int nt = 0; nt < L / 8; ++nt) {
        if (nt * 8 > row0 + 15) {            // above the diagonal: the whole tile is masked
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          continue;
        }
        const int j = nt * 8 + 2 * t;
        const float2 sj = *reinterpret_cast<const float2*>(seg + j);
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + (e >> 1) * 8, jj = j + (e & 1);
          const float f = ex2(seg_r[e >> 1] - ((e & 1) ? sj.y : sj.x)) * ((e & 1) ? dj.y : dj.x);
          s[nt][e] = jj <= i ? s[nt][e] * f : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk) {
        att[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        att[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        att[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        att[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    }

    // y = exp(seg_i) (C st) + att x, st the state entering the chunk (zero in
    // the first), read as a bf16 (N x P) tile
    float acc[PT][4];
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    if (c > 0) {
      const __nv_bfloat16* st_in = sts + (c & 1) * N * LDX;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t cf[4];
        load_a<LDN>(cf, Cs + row0 * LDN, kk, lane);
        mma_ab_slice<P, LDX>(acc, cf, st_in, kk, lane);
      }
      const float e0 = ex2(seg_r[0]), e1 = ex2(seg_r[1]);
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) {
        acc[nt][0] *= e0; acc[nt][1] *= e0;
        acc[nt][2] *= e1; acc[nt][3] *= e1;
      }
    }
    mma_ab<P, LDX, L / 16>(acc, att, Xs, lane);

    // y rounded to bf16 once, staged in the warp's rows, stored in 16-byte rows
    {
      __nv_bfloat16* yrows = ys + warp * 16 * LDX;
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) {
        *reinterpret_cast<uint32_t*>(yrows + g * LDX + nt * 8 + 2 * t) =
            pack_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(yrows + (g + 8) * LDX + nt * 8 + 2 * t) =
            pack_bf16(acc[nt][2], acc[nt][3]);
      }
      __syncwarp();
      constexpr int CHUNKS = P / 8;          // 16-byte pieces a row
#pragma unroll
      for (int j = 0; j < 16 * CHUNKS / 32; ++j) {
        const int i = lane + j * 32, r = i / CHUNKS, col = (i % CHUNKS) * 8;
        const int row = c * L + row0 + r;
        if (row < S)
          *reinterpret_cast<uint4*>(y + (((size_t)b * S + row) * H + h) * P + col) =
              *reinterpret_cast<const uint4*>(yrows + r * LDX + col);
      }
    }

    // st <- exp(seg_L) st + W_hi^T x + W_lo^T x, W[j][n] = B[j][n] dout_j
    {
      const float et = ex2(seg[L - 1]);
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
          st[k][nt][0] *= et; st[k][nt][1] *= et;
          st[k][nt][2] *= et; st[k][nt][3] *= et;
        }
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk) {
        // the fragment's columns j: 16kk + 2t, +1 (regs 0, 1) and 16kk + 2t + 8, +9 (2, 3)
        const float2 d_lo = *reinterpret_cast<const float2*>(dout + kk * 16 + 2 * t);
        const float2 d_hi = *reinterpret_cast<const float2*>(dout + kk * 16 + 2 * t + 8);
        uint32_t whi[NS][4], wlo[NS][4];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          uint32_t bt[4];
          load_a_trans<LDN>(bt, Bs, kk, (warp * NS + k) * 16, lane);
          split_scaled(bt[0], d_lo, whi[k][0], wlo[k][0]);
          split_scaled(bt[1], d_lo, whi[k][1], wlo[k][1]);
          split_scaled(bt[2], d_hi, whi[k][2], wlo[k][2]);
          split_scaled(bt[3], d_hi, whi[k][3], wlo[k][3]);
        }
        // x's B fragments as in mma_ab_slice, loaded once for hi, lo and every slab
        const __nv_bfloat16* xrow =
            Xs + (kk * 16 + (lane % 8) + ((lane / 8) & 1) * 8) * LDX + (lane / 16) * 8;
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t xf[4];
          ldmatrix_x4_trans(xf, xrow + pp * 16);
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            mma_bf16_16816(st[k][2 * pp], whi[k], xf[0], xf[1]);
            mma_bf16_16816(st[k][2 * pp + 1], whi[k], xf[2], xf[3]);
            mma_bf16_16816(st[k][2 * pp], wlo[k], xf[0], xf[1]);
            mma_bf16_16816(st[k][2 * pp + 1], wlo[k], xf[2], xf[3]);
          }
        }
      }
    }

    // the next chunk's bf16 state tile, in the buffer chunk c did not read
    if (c + 1 < nchunks) {
      __nv_bfloat16* nxt = sts + ((c + 1) & 1) * N * LDX;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int n = (warp * NS + k) * 16 + g;
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
          *reinterpret_cast<uint32_t*>(nxt + n * LDX + nt * 8 + 2 * t) =
              pack_bf16(st[k][nt][0], st[k][nt][1]);
          *reinterpret_cast<uint32_t*>(nxt + (n + 8) * LDX + nt * 8 + 2 * t) =
              pack_bf16(st[k][nt][2], st[k][nt][3]);
        }
      }
    }
  }

  // the final state, transposed to (P, N) in the (now idle) ring, then stored
  // in 16-byte pieces along N
  cp_async_wait<0>();
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int nt = 0; nt < PT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (warp * NS + k) * 16 + g + (e >> 1) * 8, p = nt * 8 + 2 * t + (e & 1);
        stage[p * LDT + n] = st[k][nt][e];
      }
  __syncthreads();
  float* so = state_out + (size_t)blockIdx.x * P * N;
  for (int i = tid; i < P * N / 4; i += MMA_THREADS) {
    const int p = i / (N / 4), n = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(so + p * N + n) = *reinterpret_cast<const float4*>(stage + p * LDT + n);
  }
}

template <int P, int N>
cudaError_t launch_mma(const void* x, const float* dt, const float* A, const void* bm,
                       const void* cm, void* y, float* state, int B, int S, int H,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes(P, N);
  static_assert(smem <= SMEM_MAX, "the mma route's shared memory fits a block");
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_mma<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_mma<P, N><<<B * H, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<__nv_bfloat16*>(y), state, S, H);
  return cudaGetLastError();
}

template <int P, int N>
int run_mma(const void* x, const float* dt, const float* A, const void* bm, const void* cm,
            void* y, float* state, int B, int S, int H, cudaStream_t st) {
  if constexpr (mma_takes(P, N)) return (int)launch_mma<P, N>(x, dt, A, bm, cm, y, state, B, S, H, st);
  else return -1;
}

template <int P>
int dispatch_mma_n(const void* x, const float* dt, const float* A, const void* bm, const void* cm,
                   void* y, float* state, int B, int S, int H, int N, cudaStream_t st) {
  switch (N) {
    case 64: return run_mma<P, 64>(x, dt, A, bm, cm, y, state, B, S, H, st);
    case 128: return run_mma<P, 128>(x, dt, A, bm, cm, y, state, B, S, H, st);
    default: return -1;
  }
}

int dispatch_mma(const void* x, const float* dt, const float* A, const void* bm, const void* cm,
                 void* y, float* state, int B, int S, int H, int P, int N, cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_mma_n<16>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    case 32: return dispatch_mma_n<32>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    case 64: return dispatch_mma_n<64>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    case 128: return dispatch_mma_n<128>(x, dt, A, bm, cm, y, state, B, S, H, N, st);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
// route_mma 1: the mma route, bf16 with head dim P of 16, 32 or 64 and N of
// 64 or 128 (`mma_takes`). route_mma 0: the fma route,
// bf16 or fp32, P of 16, 32, 64 or 128, N >= 1 with the block's shared memory
// within 227 KB. Both: B*H within the grid's x limit.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, void* y, void* state, int B, int S, int H, int P,
                            int N, int is_bf16, int route_mma, void* stream) {
  if (B < 1 || S < 1 || H < 1 || N < 1 || (long long)B * H > 2147483647LL) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (route_mma) {
    if (!is_bf16) return -1;
    return dispatch_mma(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, st);
  }
  if ((size_t)smem_floats(P, N) * sizeof(float) > (size_t)SMEM_MAX) return -1;
  if (is_bf16) return dispatch<__nv_bfloat16>(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, st);
  return dispatch<float>(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, st);
}
