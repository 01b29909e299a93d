// fused_ffn for Hopper (sm_90a), hand-written: the SwiGLU MLP without its
// (T x F) gate and up tensors in device memory.
//
// Replaces the TPU kernel `_ffn_kernel` / `fused_ffn_pallas`
// (src/repro/kernels/fused_ffn.py:45, pallas_call at :55 of the JAX
// reference package):
//   y = (silu(x W_g) . (x W_u)) W_d,
//   x (T,D), W_g/W_u (D,F), W_d (F,D) -> y (T,D), fp32 accumulation.
// The TPU kernel kept a (256 x D) fp32 accumulator (2 MB at D = 2048) across
// a sequential F grid axis, so no (T x F) tensor reached HBM. A Hopper block
// has 227 KB of shared memory and 64K registers, so the port has two routes,
// picked on the host by fused_ffn.py:ffn_plan.
//
// What bounds it on an H100: at the prefill shape (T = 2048, D = 2048,
// F = 8192) the 206 GFLOP take 0.21 ms at 989 TFLOP/s, above the 0.03 ms
// that reading the weights once would take: operations. At decode (T = 4) it
// is the 100 MB of weights: bytes.
//
// Route "tiled" (bf16, T >= 256): operations bound, so the tiles must be
// large enough for the tensor cores to run from shared memory. The card's
// 50 MB L2, not a block, holds the hidden state: h is made in row chunks of
// at most 16 MiB (the host picks the rows) by two tensor-core passes per
// chunk, each a 128-row tile of a plain product with a 3-stage cp.async ring:
//   * ffn_gate_up_mma: h[c] = bf16(silu(x[c] W_g) . (x[c] W_u)), a 128 x 64
//     tile of g and of u a block (g and u share a C-fragment layout and never
//     leave registers), blockIdx.x over the row tiles so that the blocks in
//     flight read the same weight columns from L2;
//   * ffn_down_mma: y[c] = h[c] W_d, a 128 x 128 tile a block with all of F
//     summed inside it: no split-K, no atomics, the same bits every run.
// Even if every byte of h went to HBM it would cost ~20 us at the prefill
// shape against the 208 us bound. The route that splits D across blocks
// instead (g and u recomputed for every D range) was dropped: a 128 x D_tile
// fp32 slice of y fits a block's registers only up to D_tile = 256, so at
// D = 2048 it recomputes g and u 8 times, 5.7x the FLOP, a 1.18 ms bound.
//
// Route "rowtile" (fp32; bf16 at T < 256, which serves decode):
//   * one block per 16-row tile of x (one m16 row of mma.sync) and per split
//     of F. The 16 x D fp32 accumulator of y is spread over the block's 8
//     warps, D/8 columns each: 128 registers a thread at D = 2048. x's tile
//     (16 x D bf16, 64 KB) sits in shared memory for the whole F loop;
//   * for each 64-column step of F, each warp computes one 8-column n-tile of
//     g = x W_g and of u = x W_u (the two C fragments share a layout, so
//     h = silu(g) u is taken in fp32 in registers), rounds h to bf16 into
//     shared memory, and the block adds h W_d into the accumulator. W_g/W_u
//     stream through shared memory in 128-row steps, W_d in 32-row steps over
//     the same buffer; `ldmatrix.trans` turns the row-major weights into the
//     k-major B operands;
//   * F is split across blocks by the host's plan (fused_ffn.py:split_plan)
//     so that T-tiles x splits fill the card: none at the prefill shape
//     (128 T-tiles), many at decode (T = 4: one T-tile). With more than one
//     split each block writes its fp32 partial sums (splits, T, D) and a
//     second kernel adds them in split order: deterministic, no atomics;
//   * ragged T and F are masked (zero rows of x, zero columns of W_g/W_u,
//     zero rows of W_d), so F = 5632 and T = 4 need no padding by the caller.
//   bf16 goes to the tensor cores (mma.sync.m16n8k16, fp32 accumulate);
//   fp32 inputs take a second kernel of IEEE fp32 FMAs (TF32 would miss
//   1e-4). Every T-tile re-reads all the weights, which at decode is the
//   bound anyway and at T = 2048 made it 20x its bound: hence the tiled route.
//
// Both routes round h = silu(g) u, taken in fp32, once to bf16 as the down
// product's operand. Plain C interface, no allocation, no synchronisation:
// the caller provides the output, the scratch (partial sums, or h's chunk)
// and the stream, and gets cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;          // rows of x per block
constexpr int BF = 64;          // hidden columns per step of the F loop
constexpr int BK = 128;         // rows of W_g / W_u per shared-memory step
constexpr int WD_ROWS = 32;     // rows of W_d per shared-memory step
constexpr int THREADS = 256;    // 8 warps
constexpr int MAX_D = 2048;
constexpr int MAX_NT = MAX_D / 64;      // n-tiles of 8 columns per warp at MAX_D
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed on the way:
// row-major [k][n] weights arrive as the k-major B operands of mma.sync.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragment of m16n8k16 from a row-major bf16 tile: lanes 0-15 address
// rows 0-15 at column k0, lanes 16-31 the same rows at k0 + 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from global to shared memory through L2 only; zeros where !valid
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low 16 bits) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// A fragment of m16n8k16 from a row-major bf16 tile: rows g and g+8,
// columns k0 + 2t (+1) and k0 + 8 + 2t (+1).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int k0, int g, int t) {
  const __nv_bfloat16* p = tile + g * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// Shared memory of the bf16 kernel, in bytes: x's tile, h's tile, and one
// buffer that holds W_g and W_u steps, then W_d steps.
__host__ __device__ inline size_t smem_mma(int D) {
  size_t xs = (size_t)BM * (D + 8), hs = (size_t)BM * (BF + 8);
  size_t wgu = 2 * (size_t)BK * (BF + 8), wd = (size_t)WD_ROWS * (D + 8);
  return (xs + hs + (wgu > wd ? wgu : wd)) * sizeof(__nv_bfloat16);
}

__host__ __device__ inline size_t smem_fma(int D) {
  return ((size_t)BM * D + (size_t)BM * BF) * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
ffn_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
        const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ wd,
        __nv_bfloat16* __restrict__ y, float* __restrict__ part, int T, int D, int F,
        int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDX = D + 8;                 // +16 bytes a row: fragment loads hit 32 banks
  constexpr int LDW = BF + 8;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BM][LDX]
  __nv_bfloat16* Hs = Xs + BM * LDX;                                // [BM][LDW]
  __nv_bfloat16* Ws = Hs + BM * LDW;     // [BK][LDW] W_g, [BK][LDW] W_u; or [WD_ROWS][LDX] W_d
  __nv_bfloat16* Wgs = Ws;
  __nv_bfloat16* Wus = Ws + BK * LDW;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int t0 = blockIdx.x * BM;
  const int n_ftiles = (F + BF - 1) / BF;
  const int ft0 = blockIdx.y * tiles_per_split;
  const int ft1 = min(n_ftiles, ft0 + tiles_per_split);
  const int NT = D / 64;                 // this warp's n-tiles: columns [warp D/8, (warp+1) D/8)
  const int col0 = warp * (D / 8);

  const int xchunks = D / 8;             // 16-byte pieces of a row
  for (int idx = tid; idx < BM * xchunks; idx += THREADS) {
    int r = idx / xchunks, c = (idx % xchunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) v = *reinterpret_cast<const uint4*>(x + (size_t)(t0 + r) * D + c);
    *reinterpret_cast<uint4*>(Xs + r * LDX + c) = v;
  }

  float acc[MAX_NT][4];
#pragma unroll
  for (int i = 0; i < MAX_NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // lane -> row of one of four 8x8 matrices for ldmatrix: k rows +8 for the
  // odd matrices
  const int lrow = (lane % 8) + ((lane / 8) & 1) * 8;

  for (int ft = ft0; ft < ft1; ++ft) {
    const int f0 = ft * BF;
    float gc[4] = {0.f, 0.f, 0.f, 0.f}, uc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();                   // Ws free (and Xs written, Hs read, on entry)
      for (int idx = tid; idx < BK * (BF / 8); idx += THREADS) {
        int r = idx / (BF / 8), c = (idx % (BF / 8)) * 8;
        uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
        if (f0 + c < F) {
          size_t off = (size_t)(k0 + r) * F + f0 + c;
          a = *reinterpret_cast<const uint4*>(wg + off);
          b = *reinterpret_cast<const uint4*>(wu + off);
        }
        *reinterpret_cast<uint4*>(Wgs + r * LDW + c) = a;
        *reinterpret_cast<uint4*>(Wus + r * LDW + c) = b;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4], r[4];
        load_a(a, Xs, LDX, k0 + kk * 16, g, t);
        // lanes 0-15 address W_g's 16 rows, lanes 16-31 W_u's, at this warp's 8 columns
        ldmatrix_x4_trans(r, (lane < 16 ? Wgs : Wus) + (kk * 16 + lrow) * LDW + warp * 8);
        mma_bf16_16816(gc, a, r[0], r[1]);
        mma_bf16_16816(uc, a, r[2], r[3]);
      }
    }
    // h = silu(g) u in fp32, rounded to bf16 as the A operand of the down product
    {
      __nv_bfloat16* hp = Hs + g * LDW + warp * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(hp) = pack_bf16(silu(gc[0]) * uc[0], silu(gc[1]) * uc[1]);
      *reinterpret_cast<uint32_t*>(hp + 8 * LDW) =
          pack_bf16(silu(gc[2]) * uc[2], silu(gc[3]) * uc[3]);
    }
    for (int r0 = 0; r0 < BF; r0 += WD_ROWS) {
      __syncthreads();                   // Hs written; Ws free
      for (int idx = tid; idx < WD_ROWS * xchunks; idx += THREADS) {
        int r = idx / xchunks, c = (idx % xchunks) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (f0 + r0 + r < F) v = *reinterpret_cast<const uint4*>(wd + (size_t)(f0 + r0 + r) * D + c);
        *reinterpret_cast<uint4*>(Ws + r * LDX + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WD_ROWS / 16; ++kk) {
        uint32_t a[4];
        load_a(a, Hs, LDW, r0 + kk * 16, g, t);
        const __nv_bfloat16* wrow = Ws + (kk * 16 + lrow) * LDX + col0 + (lane / 16) * 8;
#pragma unroll
        for (int p = 0; p < MAX_NT / 2; ++p) {
          if (2 * p >= NT) break;
          uint32_t r[4];
          ldmatrix_x4_trans(r, wrow + p * 16);
          mma_bf16_16816(acc[2 * p], a, r[0], r[1]);
          mma_bf16_16816(acc[2 * p + 1], a, r[2], r[3]);
        }
      }
    }
  }

  // epilogue: rows t0 + g and t0 + g + 8, columns col0 + 8 nt + 2t (+1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + g + half * 8;
    if (row >= T) continue;
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt >= NT) break;
      const int col = col0 + nt * 8 + 2 * t;
      float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      if (part == nullptr) {
        *reinterpret_cast<uint32_t*>(y + (size_t)row * D + col) = pack_bf16(v0, v1);
      } else {
        float* pp = part + ((size_t)blockIdx.y * T + row) * D + col;
        pp[0] = v0;
        pp[1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs
// ---------------------------------------------------------------------------

// Phase 1: thread (r = tid / 16, c = tid % 16) computes g and u at row r,
// columns c + 16 j (j < 4) of the F step. Phase 2: thread tid owns columns
// tid + 256 j (j < D/256) of all 16 rows of the accumulator.
__global__ void __launch_bounds__(THREADS)
ffn_fma(const float* __restrict__ x, const float* __restrict__ wg, const float* __restrict__ wu,
        const float* __restrict__ wd, float* __restrict__ y, float* __restrict__ part, int T,
        int D, int F, int tiles_per_split) {
  constexpr int DJ = MAX_D / THREADS;    // 8
  extern __shared__ __align__(16) float fsmem[];
  float* Xs = fsmem;                     // [BM][D]
  float* Hs = Xs + BM * D;               // [BM][BF]

  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int t0 = blockIdx.x * BM;
  const int n_ftiles = (F + BF - 1) / BF;
  const int ft0 = blockIdx.y * tiles_per_split;
  const int ft1 = min(n_ftiles, ft0 + tiles_per_split);

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    int rr = idx / D, k = idx % D;
    Xs[idx] = t0 + rr < T ? x[(size_t)(t0 + rr) * D + k] : 0.f;
  }
  float acc[BM][DJ];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int ft = ft0; ft < ft1; ++ft) {
    const int f0 = ft * BF;
    __syncthreads();                     // Xs written; Hs of the previous step read
    float gv[4] = {0.f, 0.f, 0.f, 0.f}, uv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < D; ++k) {
      const float xv = Xs[r * D + k];
      const float* gr = wg + (size_t)k * F + f0 + c;
      const float* ur = wu + (size_t)k * F + f0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (f0 + c + 16 * j < F) {
          gv[j] = fmaf(xv, gr[16 * j], gv[j]);
          uv[j] = fmaf(xv, ur[16 * j], uv[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Hs[r * BF + c + 16 * j] = silu(gv[j]) * uv[j];
    __syncthreads();
    const int fn = min(BF, F - f0);
    for (int ff = 0; ff < fn; ++ff) {
      const float* wrow = wd + (size_t)(f0 + ff) * D;
      float wv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        int d = tid + THREADS * j;
        wv[j] = d < D ? wrow[d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float hv = Hs[i * BF + ff];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(hv, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int row = t0 + i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      int d = tid + THREADS * j;
      if (d >= D) continue;
      if (part == nullptr) y[(size_t)row * D + d] = acc[i][j];
      else part[((size_t)blockIdx.y * T + row) * D + d] = acc[i][j];
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// y = sum over the splits of the fp32 partials, in split order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_combine(const float* __restrict__ part, T* __restrict__ y, size_t n, int n_splits) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[k * n + i];
    store(y + i, s);
  }
}

template <typename T>
cudaError_t combine(const float* part, void* y, int Tn, int D, int n_splits,
                    cudaStream_t stream) {
  size_t n = (size_t)Tn * D;
  int blocks = (int)((n + THREADS - 1) / THREADS);
  if (blocks > 1024) blocks = 1024;
  ffn_combine<T><<<blocks, THREADS, 0, stream>>>(part, static_cast<T*>(y), n, n_splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, T >= 256: two tiled tensor-core passes over row chunks of h
// ---------------------------------------------------------------------------

constexpr int TM = 128;            // rows of a block tile in both passes
constexpr int TK = 32;             // depth of one stage of the ring
constexpr int STAGES = 3;          // cp.async ring
constexpr int GU_N = 64;           // columns of g and of u a block (pass A)
constexpr int DN_N = 128;          // columns of y a block (pass B)
constexpr int LDA_S = TK + 8;      // padded rows (80, 144, 272 bytes): the
constexpr int LDG_S = GU_N + 8;    // eight rows an ldmatrix phase reads fall
constexpr int LDD_S = DN_N + 8;    // on 32 different banks
constexpr int STAGE_GU = TM * LDA_S + 2 * TK * LDG_S;   // elements: x, W_g, W_u
constexpr int STAGE_DN = TM * LDA_S + TK * LDD_S;       // elements: h, W_d
constexpr size_t SMEM_GU = STAGES * STAGE_GU * sizeof(__nv_bfloat16);   // 58,368 bytes
constexpr size_t SMEM_DN = STAGES * STAGE_DN * sizeof(__nv_bfloat16);   // 56,832 bytes

// Pass A. Grid (row tiles of the chunk, ldh / 64); rows >= `rows` of x load
// as zeros, and so do the columns >= F of W_g and W_u, so h's padded rows
// and columns come out as silu(0) 0 = 0. Warp w: rows 32 (w % 4), columns
// 32 (w / 4) of the block's 64, of g and of u.
__global__ void __launch_bounds__(THREADS, 2)
ffn_gate_up_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                const __nv_bfloat16* __restrict__ wu, __nv_bfloat16* __restrict__ h, int rows,
                int D, int F, int ldh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int r0 = blockIdx.x * TM, c0 = blockIdx.y * GU_N;
  const int ktiles = D / TK;

  auto load = [&](int stage, int kt) {
    __nv_bfloat16* xs = ring + stage * STAGE_GU;
    __nv_bfloat16* gs = xs + TM * LDA_S;
    __nv_bfloat16* us = gs + TK * LDG_S;
    const int k0 = kt * TK;
#pragma unroll
    for (int j = 0; j < TM * (TK / 8) / THREADS; ++j) {      // two 16-byte pieces each
      const int i = tid + j * THREADS, r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      const bool ok = r0 + r < rows;
      cp_async16(xs + r * LDA_S + c, x + (size_t)(ok ? r0 + r : 0) * D + k0 + c, ok);
    }
    const int r = tid / (GU_N / 8), c = (tid % (GU_N / 8)) * 8;  // 32 x 8 pieces: one each
    const bool ok = c0 + c < F;
    const size_t off = (size_t)(k0 + r) * F + (ok ? c0 + c : 0);
    cp_async16(gs + r * LDG_S + c, wg + off, ok);
    cp_async16(us + r * LDG_S + c, wu + off, ok);
  };

  float accg[2][4][4], accu[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[mi][ni][e] = accu[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  // ldmatrix.trans: lanes 0-7 / 8-15 / 16-23 / 24-31 address k rows 0-7 /
  // 8-15 / 0-7 / 8-15, the last two 8 columns further on
  const int lrow = (lane % 8) + ((lane / 8) & 1) * 8;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();       // this thread's pieces of stage kt are in
    __syncthreads();                   // everyone's are; stage kt - 1 is free
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* xs = ring + (kt % STAGES) * STAGE_GU;
    const __nv_bfloat16* gs = xs + TM * LDA_S;
    const __nv_bfloat16* us = gs + TK * LDG_S;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[2][4], bg[2][4], bu[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], xs + (wm * 32 + mi * 16 + lane % 16) * LDA_S + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int off = (kk * 16 + lrow) * LDG_S + wn * 32 + p * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(bg[p], gs + off);
        ldmatrix_x4_trans(bu[p], us + off);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16_16816(accg[mi][2 * p], a[mi], bg[p][0], bg[p][1]);
          mma_bf16_16816(accg[mi][2 * p + 1], a[mi], bg[p][2], bg[p][3]);
          mma_bf16_16816(accu[mi][2 * p], a[mi], bu[p][0], bu[p][1]);
          mma_bf16_16816(accu[mi][2 * p + 1], a[mi], bu[p][2], bu[p][3]);
        }
    }
  }

  // h = silu(g) u in fp32, rounded once to bf16: rows +g and +g+8 of each
  // m16 tile, columns +2t, +2t+1 of each n8 tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float(&gc)[4] = accg[mi][ni];
      const float(&uc)[4] = accu[mi][ni];
      __nv_bfloat16* hp = h + (size_t)(r0 + wm * 32 + mi * 16 + g) * ldh + c0 + wn * 32 + ni * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(hp) = pack_bf16(silu(gc[0]) * uc[0], silu(gc[1]) * uc[1]);
      *reinterpret_cast<uint32_t*>(hp + 8 * (size_t)ldh) =
          pack_bf16(silu(gc[2]) * uc[2], silu(gc[3]) * uc[3]);
    }
}

// Pass B. Grid (row tiles of the chunk, D / 128); the k loop runs over all of
// ldh (h's padded columns are zeros; W_d's rows >= F load as zeros); rows
// >= `rows` are not stored. Warp w: rows 32 (w % 4), columns 64 (w / 4).
__global__ void __launch_bounds__(THREADS, 2)
ffn_down_mma(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ wd,
             __nv_bfloat16* __restrict__ y, int rows, int D, int F, int ldh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int r0 = blockIdx.x * TM, c0 = blockIdx.y * DN_N;
  const int ktiles = ldh / TK;

  auto load = [&](int stage, int kt) {
    __nv_bfloat16* hs = ring + stage * STAGE_DN;
    __nv_bfloat16* ws = hs + TM * LDA_S;
    const int k0 = kt * TK;
#pragma unroll
    for (int j = 0; j < TM * (TK / 8) / THREADS; ++j) {      // h: two pieces each
      const int i = tid + j * THREADS, r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      cp_async16(hs + r * LDA_S + c, h + (size_t)(r0 + r) * ldh + k0 + c, true);
    }
#pragma unroll
    for (int j = 0; j < TK * (DN_N / 8) / THREADS; ++j) {    // W_d: two pieces each
      const int i = tid + j * THREADS, r = i / (DN_N / 8), c = (i % (DN_N / 8)) * 8;
      const bool ok = k0 + r < F;
      cp_async16(ws + r * LDD_S + c, wd + (size_t)(ok ? k0 + r : 0) * D + c0 + c, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  const int lrow = (lane % 8) + ((lane / 8) & 1) * 8;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* hs = ring + (kt % STAGES) * STAGE_DN;
    const __nv_bfloat16* ws = hs + TM * LDA_S;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], hs + (wm * 32 + mi * 16 + lane % 16) * LDA_S + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (kk * 16 + lrow) * LDD_S + wn * 64 + p * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(acc[mi][2 * p], a[mi], b[0], b[1]);
          mma_bf16_16816(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = c0 + wn * 64 + ni * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(y + (size_t)row * D + col) =
            pack_bf16(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

}  // namespace

// `part` holds n_splits*T*D floats when n_splits > 1 and may be NULL
// otherwise. Split s covers F tiles [s*tiles_per_split, (s+1)*tiles_per_split)
// of 64 columns, and every split must be non-empty. Returns 0, a cudaError_t,
// or -1 for arguments the kernels do not take (D <= 2048, bf16: D a multiple
// of 128; F a multiple of 8).
extern "C" int fused_ffn_fwd(const void* x, const void* wg, const void* wu, const void* wd,
                             void* y, void* part, int T, int D, int F, int n_splits,
                             int tiles_per_split, int is_bf16, void* stream) {
  const int n_ftiles = (F + BF - 1) / BF;
  if (T < 1 || D < 1 || D > MAX_D || F < 8 || F % 8 != 0 || (is_bf16 && D % 128 != 0) ||
      n_splits < 1 || n_splits > 65535 || tiles_per_split < 1 ||
      (long long)(n_splits - 1) * tiles_per_split >= n_ftiles ||
      (long long)n_splits * tiles_per_split < n_ftiles || (n_splits > 1 && part == nullptr))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = n_splits > 1 ? static_cast<float*>(part) : nullptr;
  dim3 grid((T + BM - 1) / BM, n_splits);
  cudaError_t err;
  if (is_bf16) {
    size_t smem = smem_mma(D);
    if (smem > SMEM_MAX) return -1;
    err = cudaFuncSetAttribute(ffn_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffn_mma<<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
        static_cast<const __nv_bfloat16*>(wu), static_cast<const __nv_bfloat16*>(wd),
        static_cast<__nv_bfloat16*>(y), pf, T, D, F, tiles_per_split);
  } else {
    size_t smem = smem_fma(D);
    if (smem > SMEM_MAX) return -1;
    err = cudaFuncSetAttribute(ffn_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffn_fma<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd), static_cast<float*>(y),
        pf, T, D, F, tiles_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  return (int)(is_bf16 ? combine<__nv_bfloat16>(pf, y, T, D, n_splits, st)
                       : combine<float>(pf, y, T, D, n_splits, st));
}

// The tiled route, bf16 only. `h` is (chunk_rows, round_up(F, 64)) bf16
// scratch; row chunk [r0, r0 + chunk_rows) of x goes through pass A then
// pass B before the next chunk reuses it. Returns 0, a cudaError_t, or -1 for
// arguments it does not take (D a multiple of 128 and at most 2048, F a
// multiple of 8, chunk_rows a positive multiple of 128).
extern "C" int fused_ffn_tiled_fwd(const void* x, const void* wg, const void* wu, const void* wd,
                                   void* y, void* h, int T, int D, int F, int chunk_rows,
                                   void* stream) {
  const int ldh = (F + GU_N - 1) / GU_N * GU_N;
  if (T < 1 || D < DN_N || D > MAX_D || D % DN_N != 0 || F < 8 || F % 8 != 0 ||
      ldh / GU_N > 65535 || chunk_rows < TM || chunk_rows % TM != 0 || h == nullptr)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(ffn_gate_up_mma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_GU);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ffn_down_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_DN);
  if (err != cudaSuccess) return (int)err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wgb = static_cast<const __nv_bfloat16*>(wg);
  const auto* wub = static_cast<const __nv_bfloat16*>(wu);
  const auto* wdb = static_cast<const __nv_bfloat16*>(wd);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  for (int r0 = 0; r0 < T; r0 += chunk_rows) {
    const int rows = T - r0 < chunk_rows ? T - r0 : chunk_rows;
    const int tiles = (rows + TM - 1) / TM;
    ffn_gate_up_mma<<<dim3(tiles, ldh / GU_N), THREADS, SMEM_GU, st>>>(
        xb + (size_t)r0 * D, wgb, wub, hb, rows, D, F, ldh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ffn_down_mma<<<dim3(tiles, D / DN_N), THREADS, SMEM_DN, st>>>(
        hb, wdb, yb + (size_t)r0 * D, rows, D, F, ldh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
