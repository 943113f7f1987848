// Shared device helpers for the port's kernels (plain CUDA C++, sm_90a).
//
// Every kernel takes float32 or bfloat16 tensors (template parameter T),
// keeps GEMM operand tiles in shared memory as T and GEMM outputs as float,
// and accumulates in float.  round_t<T> rounds a float to T's precision: it reproduces the
// places where the JAX kernels cast to the compute dtype (`.astype(dt)`), so
// bf16 results track the JAX package and fp32 results are unchanged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace loftr {

constexpr int kThreads = 256;  // every block GEMM below assumes 8 warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// elu(x) + 1, in the form of the JAX kernels' _phi.
__device__ __forceinline__ float phi(float x) {
  return x > 0.f ? x + 1.f : expf(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[r*ldo + n] = sum_k A[r*lda + k] * W[k*ldw + n] for r < R, n < N.
// A: rows in shared memory.  W: [K, ldw] row-major in global memory (read
// through L1/L2; every block reads the same weights).
//
// The float paths' GEMM (the exactness check): CUDA-core FMAs; the
// bfloat16 paths use mma_tile.cuh or sim_tile.cuh.  Warp w owns rows w, w+8,
// ..., lane l owns columns l, l+32, ... of each 32*NJ-wide pass, so A reads
// broadcast within a warp and W reads coalesce.
template <int RPT, int NJ, typename TA, typename TW>
__device__ void gemm_simt_nj(const TA* A, int lda, int R, int K,
                             const TW* __restrict__ W, int ldw, int N,
                             float* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < N; n0 += 32 * NJ) {
    float acc[RPT][NJ];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float w[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + lane + 32 * j;
        w[j] = n < N ? to_f(W[(size_t)k * ldw + n]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = warp + 8 * i;
        const float a = r < R ? to_f(A[r * lda + k]) : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + 8 * i;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + lane + 32 * j;
        if (n < N) out[r * ldo + n] = acc[i][j];
      }
    }
  }
}

// Dispatch on the width: 8 columns a lane where N is a multiple of 256.
template <int RPT, typename TA, typename TW>
__device__ void gemm(const TA* A, int lda, int R, int K,
                     const TW* __restrict__ W, int ldw, int N, float* out,
                     int ldo) {
  if (N % 256 == 0)
    gemm_simt_nj<RPT, 8>(A, lda, R, K, W, ldw, N, out, ldo);
  else
    gemm_simt_nj<RPT, 4>(A, lda, R, K, W, ldw, N, out, ldo);
}

// In-place float32 LayerNorm over C columns of R rows (two-pass variance,
// as the JAX kernels' _layer_norm), one warp per row.  Result rows are
// written to dst (which may alias src) through `op(r, c, y)`.
template <typename Op>
__device__ void layer_norm_rows(const float* src, int lds, int R, int C,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, float eps,
                                Op op) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += 8) {
    const float* row = src + r * lds;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float t = row[c] - mean;
      v += t * t;
    }
    const float inv = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32)
      op(r, c, (row[c] - mean) * inv * scale[c] + bias[c]);
  }
}

}  // namespace loftr
