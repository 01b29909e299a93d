// The bf16 fragment helpers of the hand-written tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu, flash_decode.cu, ssd_scan.cu): warp-level
// tensor-core products (`mma.sync.m16n8k16`, bf16 operands, fp32 accumulate)
// on tiles in shared memory, their operands through `ldmatrix`, the
// `cp.async` copies that fill those tiles, and the forward kernels' online
// softmax step. Included by the .cu files; not compiled on its own.
//
// Fragment layout (PTX ISA, m16n8k16): in a warp, thread (g = lane/4,
// t = lane%4) holds C rows g and g+8, columns 2t and 2t+1 of each 8-column
// n-tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 address the rows
// of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// 4 bytes, the same way (lse and delta: one fp32 a row, H apart).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
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

// `ROWS` rows of D bf16 into shared memory with row stride LD, by cp.async
// from THREADS threads, this one number `tid` of them: row r of the tile is
// row row0 + r of a (S, heads, D) slab, head `head` (rows heads * D apart);
// rows at or beyond S arrive as zeros.
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int row0, int S, int heads, int head, int tid) {
  constexpr int CHUNKS = D / 8;
  static_assert((ROWS * CHUNKS) % THREADS == 0, "whole rounds of 16-byte pieces");
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * LD + c, src + ((size_t)(ok ? row0 + r : 0) * heads + head) * D + c, ok);
  }
}

// The same by the block's THREADS threads.
template <int D, int LD, int ROWS, int THREADS = 128>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int row0, int S, int heads, int head) {
  cp_async_rows<D, LD, ROWS, THREADS>(dst, src, row0, S, heads, head, threadIdx.x);
}

// The A fragment of columns [16kk, 16kk + 16) of the 16 rows at `rows` (a
// row-major tile in shared memory): lanes 0-15 address rows 0-15 at column
// 16kk, lanes 16-31 the same rows at 16kk + 8.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* rows, int kk,
                                       int lane) {
  ldmatrix_x4(a, rows + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// The A fragment of the transpose: rows [col0, col0 + 16) of T^T, its columns
// [16kk, 16kk + 16), with T a row-major tile in shared memory (rows of T are
// the k index). ldmatrix.trans hands each lane T[k][m], T[k+1][m] as A's
// (m, k), (m, k+1): lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 / 0-7 /
// 8-15 / 8-15 of the slice at columns col0 / col0 + 8 / col0 / col0 + 8.
template <int LD>
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* tile, int kk,
                                             int col0, int lane) {
  ldmatrix_x4_trans(a, tile + (kk * 16 + (lane % 8) + (lane / 16) * 8) * LD + col0 +
                           ((lane / 8) & 1) * 8);
}

// c (16 x 8NT) += a . T^T for one 16-column slice kk: `a` the A fragment of
// columns [16kk, 16kk + 16), T a row-major (8NT x D) tile in shared memory
// whose rows are the n index, so its B fragments come straight from
// ldmatrix: `brow` (from b_rows) has lanes 0-7 / 8-15 / 16-23 / 24-31 address
// rows 0-7 / 0-7 / 8-15 / 8-15 of a 16-row pair of n-tiles, at columns 16kk /
// 16kk + 8 / 16kk / 16kk + 8.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* b_rows(const __nv_bfloat16* tile, int lane) {
  return tile + ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) & 1) * 8;
}

template <int LD, int NT>
__device__ __forceinline__ void mma_abt_slice(float (&c)[NT][4], const uint32_t (&a)[4],
                                              const __nv_bfloat16* brow, int kk) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t bf[4];
    ldmatrix_x4(bf, brow + np * 16 * LD + kk * 16);
    mma_bf16_16816(c[2 * np], a, bf[0], bf[1]);
    mma_bf16_16816(c[2 * np + 1], a, bf[2], bf[3]);
  }
}

// c (16 x 8NT) += A (16 x D) . T^T, A's D/16 fragments in registers.
template <int D, int LD, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const uint32_t (&areg)[D / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
  const __nv_bfloat16* brow = b_rows<LD>(tile, lane);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_abt_slice<LD, NT>(c, areg[kk], brow, kk);
}

// The same with A read from the warp's 16 rows at `arows` (shared memory).
template <int D, int LD, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const __nv_bfloat16* arows,
                                        const __nv_bfloat16* tile, int lane) {
  const __nv_bfloat16* brow = b_rows<LD>(tile, lane);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, arows, kk, lane);
    mma_abt_slice<LD, NT>(c, a, brow, kk);
  }
}

// acc (16 x D) += A . T for one 16-row slice kk of T: `a` the A fragment of
// A's columns [16kk, 16kk + 16), T a row-major (rows: the k index, D columns)
// tile in shared memory read through ldmatrix.trans.
template <int D, int LD>
__device__ __forceinline__ void mma_ab_slice(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int kk, int lane) {
  const __nv_bfloat16* row =
      tile + (kk * 16 + (lane % 8) + ((lane / 8) & 1) * 8) * LD + (lane / 16) * 8;
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, row + dt * 16);
    mma_bf16_16816(acc[2 * dt], a, bf[0], bf[1]);
    mma_bf16_16816(acc[2 * dt + 1], a, bf[2], bf[3]);
  }
}

// acc (16 x D) += A (16 x 16KT, its KT fragments in registers) . T, T a
// row-major (16KT x D) tile in shared memory.
template <int D, int LD, int KT>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KT][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) mma_ab_slice<D, LD>(acc, a[kk], tile, kk, lane);
}

// acc (16 x D) += X (16 x 16KT, C fragments in x, rounded to bf16 here) . T,
// T a row-major (16KT x D) tile in shared memory read through ldmatrix.trans.
template <int D, int LD, int KT>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4], const float (&x)[2 * KT][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    mma_ab_slice<D, LD>(acc, xa, tile, kk, lane);
  }
}

// ---------------------------------------------------------------------------
// The forward kernels' online softmax (flash_attention.cu, flash_decode.cu)
// ---------------------------------------------------------------------------

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KV tile's online-softmax step for the thread's rows row_a and row_a + 8.
// s holds the tile's Q K^T (C fragments) and leaves as P; m_run (log2 units)
// and l_run (this thread's share of the row sum) are updated and acc
// rescaled. With MASK, keys at or beyond Skv and (causal) keys above the row
// get NEG_INF; col0 is the key of s[0][0].
template <bool MASK, int NT, int D>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&acc)[D / 8][4],
                                             float (&m_run)[2], float (&l_run)[2],
                                             float scale_log2, int row_a, int col0, int Skv,
                                             int causal) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale_log2;
      if (MASK) {
        const int col = col0 + nt * 8 + (e & 1), row = row_a + (e >> 1) * 8;
        if (col >= Skv || (causal && col > row)) x = NEG_INF;
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[nt][e] - m_run[e >> 1]);
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
}

}  // namespace
