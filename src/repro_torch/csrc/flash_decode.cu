// flash_decode for Hopper (sm_90a), hand-written: split-KV partial + combine.
//
// Replaces the TPU kernel `_decode_kernel` / `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py:75 of the JAX reference package): one
// query token per sequence against a KV cache,
//   q (B,H,D), k/v (B,S,KVH,D), kv_len -> o (B,H,D),
// keys at positions >= kv_len masked, online softmax over KV tiles in fp32.
//
// What bounds it on an H100: bytes. Each sequence must read 2*kv_len*KVH*D
// cache elements and does ~1 FLOP per byte, far below the card's 295 FLOP per
// byte; at the serving path's sizes (B=4, KVH=4, D=64, kv_len <= 543, bf16:
// at most 1.1 MB a call) the traffic takes under a microsecond, so what is
// left is launch latency. The design answers both:
//   * the TPU kernel walked the cache serially, one program per (b, kv head):
//     16-32 programs, where this card has 132 SMs. Here the grid is
//     (B*KVH, n_splits): every split reduces its own slice of the cache to a
//     partial (max, sum, acc) in a scratch tensor, and a second small kernel
//     merges the partials. The caller picks n_splits to fill the card;
//   * it loops only to kv_len (a host integer, so no device sync), not over
//     the whole cache as the TPU kernel did, and the cache length S need not
//     be a multiple of anything;
//   * a block serves all G = H/KVH query heads of its KV head from one copy
//     of each K/V tile in shared memory, so the cache is read once per group.
// The products are plain fp32 FMAs from shared memory: with one query row per
// head the tensor cores' 16-row tiles would be mostly padding, and the kernel
// is not bound by arithmetic.
//
// The probabilities stay fp32 for P.V. The reference's model path
// (`decode_attention`) rounds them to the cache's dtype first, so with a bf16
// cache the two differ at bf16 rounding; comparisons at model level carry a
// tolerance for that reason.
//
// Plain C interface, no allocation, no synchronisation: the caller provides
// the output, the scratch for the partials and the stream, and gets
// cudaGetLastError() back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BN = 64;          // keys per tile
constexpr int THREADS = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Partial layout: [(b*KVH + kvh) * n_splits + split][g][D + 2] fp32, with
// [0] = running max, [1] = running sum, [2..] = unnormalised accumulator.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               float* __restrict__ part, int S, int H, int KVH, int D, int kv_len,
               int split_len, float scale) {
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte load
  const int G = H / KVH;
  const int LDK = D + 1;                   // odd stride: a warp's 32 keys fall in 32 banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [G][D], pre-scaled
  float* Ks = qs + G * D;                           // [BN][LDK]
  float* Vs = Ks + BN * LDK;                        // [BN][D]
  float* ps = Vs + BN * D;                          // [G][BN] scores, then probabilities
  float* acc = ps + G * BN;                         // [G][D]
  float* m_s = acc + G * D;                         // [G]
  float* l_s = m_s + G;                             // [G]
  float* a_s = l_s + G;                             // [G]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH, split = blockIdx.y;
  const int start = split * split_len;
  const int end = min(kv_len, start + split_len);

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int idx = tid; idx < G * D; idx += THREADS) {
    qs[idx] = to_float(qb[idx]) * scale;
    acc[idx] = 0.f;
  }
  if (tid < G) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  const int chunks = D / VEC;
  for (int n0 = start; n0 < end; n0 += BN) {
    __syncthreads();                       // previous tile consumed; qs, acc, m_s, l_s set
    for (int idx = tid; idx < BN * chunks; idx += THREADS) {
      int r = idx / chunks, c = (idx % chunks) * VEC;
      int pos = n0 + r;
      float* kd = Ks + r * LDK + c;
      float* vd = Vs + r * D + c;
      if (pos < end) {
        size_t off = (((size_t)b * S + pos) * KVH + kvh) * D + c;
        uint4 kraw = *reinterpret_cast<const uint4*>(k + off);
        uint4 vraw = *reinterpret_cast<const uint4*>(v + off);
        const T* ke = reinterpret_cast<const T*>(&kraw);
        const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) { kd[i] = to_float(ke[i]); vd[i] = to_float(ve[i]); }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) { kd[i] = 0.f; vd[i] = 0.f; }
      }
    }
    __syncthreads();

    // scores: one (head, key) pair per thread and step
    for (int idx = tid; idx < G * BN; idx += THREADS) {
      int g = idx / BN, kk = idx % BN;
      const float* qr = qs + g * D;
      const float* kr = Ks + kk * LDK;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      ps[idx] = (n0 + kk < end) ? dot : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per head, two keys per lane
    for (int g = warp; g < G; g += THREADS / 32) {
      float* prow = ps + g * BN;
      float s0 = prow[lane], s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_prev = m_s[g];
      float m_new = fmaxf(m_prev, mx);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        float alpha = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: each (head, d) element has one owner thread
    for (int idx = tid; idx < G * D; idx += THREADS) {
      int g = idx / D, d = idx % D;
      const float* prow = ps + g * BN;
      float a = acc[idx] * a_s[g];
#pragma unroll 8
      for (int kk = 0; kk < BN; ++kk) a = fmaf(prow[kk], Vs[kk * D + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  float* out = part + ((size_t)blockIdx.x * gridDim.y + split) * G * (D + 2);
  for (int idx = tid; idx < G * D; idx += THREADS) {
    int g = idx / D, d = idx % D;
    out[g * (D + 2) + 2 + d] = acc[idx];
  }
  if (tid < G) {
    out[tid * (D + 2)] = m_s[tid];
    out[tid * (D + 2) + 1] = l_s[tid];
  }
}

// One block per (b, query head): merge the splits' partials and normalise.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part, T* __restrict__ o, int n_splits, int H, int KVH,
               int D) {
  const int G = H / KVH;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / G, g = h % G;
  const float* base = part + ((size_t)(b * KVH + kvh) * n_splits * G + g) * (D + 2);
  const size_t split_stride = (size_t)G * (D + 2);

  float m = NEG_INF;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, base[s * split_stride]);
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s)
    l += base[s * split_stride + 1] * expf(base[s * split_stride] - m);
  const float inv = 1.f / fmaxf(l, 1e-30f);

  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a += base[s * split_stride + 2 + d] * expf(base[s * split_stride] - m);
    from_float(o + (size_t)blockIdx.x * D + d, a * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* part, int B,
                   int S, int H, int KVH, int D, int kv_len, int n_splits, int split_len,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  size_t smem = (size_t)(2 * G * D + BN * (D + 1) + BN * D + G * BN + 3 * G) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_partial<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * KVH, n_splits);
  decode_partial<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part, S, H,
      KVH, D, kv_len, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<B * H, THREADS, 0, stream>>>(part, static_cast<T*>(o), n_splits, H, KVH, D);
  return cudaGetLastError();
}

}  // namespace

// `part` holds B*KVH*n_splits*(H/KVH)*(D+2) floats. Split i covers keys
// [i*split_len, min(kv_len, (i+1)*split_len)) and every split must be
// non-empty. Returns 0, a cudaError_t, or -1 for arguments the kernels do not
// take (D a multiple of 8; 1 <= kv_len <= S; H a multiple of KVH).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* o, void* part,
                                int B, int S, int H, int KVH, int D, int kv_len, int n_splits,
                                int split_len, float scale, int is_bf16, void* stream) {
  if (B < 1 || KVH < 1 || H % KVH != 0 || D < 8 || D % 8 != 0 || kv_len < 1 || kv_len > S ||
      n_splits < 1 || n_splits > 65535 || split_len < 1 ||
      (long long)(n_splits - 1) * split_len >= kv_len ||
      (long long)n_splits * split_len < kv_len)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, o, pf, B, S, H, KVH, D, kv_len, n_splits,
                                      split_len, scale, st);
  return (int)launch<float>(q, k, v, o, pf, B, S, H, KVH, D, kv_len, n_splits, split_len, scale,
                            st);
}
