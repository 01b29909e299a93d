// ssd_scan for Hopper (sm_90a), hand-written: the Mamba-2 SSD chunked scan.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan.py:70, pallas_call at :89 of the JAX reference
// package). Per (sequence b, head h) and chunk of L = 64 tokens:
//   seg   = cumsum(dt * A)                                     (L)
//   y     = ((C B^T) . exp(seg_i - seg_j) . [j <= i]) (x * dt)  intra-chunk
//         + exp(seg_i) * (C state)                             inter-chunk
//   state = (B . exp(seg_L - seg_j))^T (x * dt) + exp(seg_L) * state
//   x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, B/C (B,S,N)
//     -> y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32,
// from a zero state. The TPU kernel dropped the final state; the model's
// chunked scan returns it, so this kernel does too.
//
// What bounds it on an H100: bytes. Each input is read once and y written
// once (x and y dominate: 2*B*S*H*P elements); the FLOPs per (b,h) and chunk,
// 2*L*(L*N + L*P + 2*N*P), come to ~4.3 GFLOP at the serving path's shape
// (B=4, S=512, H=64, P=64, N=64), under half the time of the 34.6 MB at
// 3.35 TB/s if they ran on the tensor cores. The design:
//   * one block per (b, h) with the chunk loop inside: Hopper blocks carry
//     nothing from one grid step to the next, so the (N x P) fp32 state stays
//     in shared memory for the whole sequence and never touches device memory
//     (B*H = 256 blocks at the path's shape, enough for 132 SMs);
//   * B and C are indexed by b, not repeated per head as the TPU wrapper did;
//   * the chunk length is the kernel's own (64, whatever the model's
//     ssm_chunk is: the result depends on it only through summation order),
//     so the (L x L) decay-weighted score tile is 16 KB; a ragged tail is
//     masked (dt = 0 past S: no decay, no input);
//   * every product is an fp32 FMA from shared memory: the first version is
//     simple and exact to fp32 rounding; tensor cores are later work. C B^T is
//     recomputed by each head of a sequence (a block per head of one b could
//     share it; later work too).
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// the outputs and the stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;            // tokens per chunk
constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int SMEM_MAX = 227 * 1024;

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

}  // namespace

// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take
// (head dim P of 16, 32, 64 or 128; N >= 1 with the block's shared memory
// within 227 KB; B*H within the grid's x limit).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, void* y, void* state, int B, int S, int H, int P,
                            int N, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || N < 1 || (long long)B * H > 2147483647LL ||
      (size_t)smem_floats(P, N) * sizeof(float) > (size_t)SMEM_MAX)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (is_bf16) return dispatch<__nv_bfloat16>(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, st);
  return dispatch<float>(x, dtf, af, bm, cm, y, sf, B, S, H, P, N, st);
}
