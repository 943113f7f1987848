// Block GEMM on raw mma.sync for the bfloat16 passes of kernels A and C
// (sm_90a), and the LayerNorm that runs on its accumulators.
//
// out[r, n] = sum_k A[r, k] * W[k, n0 + n] for the block's R = 16*MT rows
// and N columns, N = 256 (kernel A, C = 256) or 128 (kernel C, C = 128).
// 8 warps; warp w owns columns [w*N/8, (w+1)*N/8) of every row -- one head
// at both widths -- as MT x N/64 m16n8 float accumulator tiles kept in
// registers, so the caller's epilogue runs on the accumulators (fragment
// layout of mma.m16n8k16: element i of acc[mt][j] is row 16*mt + lane/4 +
// 8*(i/2), column w*N/8 + 8*j + 2*(lane%4) + i%2).
//
//   A: bf16 rows in shared memory (row stride lda elements, lda*2 bytes an
//      odd multiple of 16 so that ldmatrix is free of bank conflicts), read
//      with ldmatrix.x4.
//   W: the packed [K, ldw] row-major bf16 weight in global memory.  Slabs of
//      32 k-rows x N columns (16 KB at N = 256) go through a ring of NST
//      stages in shared memory with cp.async (16 bytes a thread), NST-1
//      slabs ahead of the products, so each slab crosses L2 once a block
//      and feeds all 8 warps; read with ldmatrix.x4.trans from rows padded
//      by 16 bytes.
//
// Use: ring_prefetch (issues the first NST-1 slabs), then ring_gemm (the
// main loop).  Between the end of one ring_gemm and the next ring_prefetch
// every warp must pass a __syncthreads (the ring is reused).  ring_gemm
// starts each slab with a __syncthreads, so shared-memory writes to A made
// before the call are visible to it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace loftr {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kSlabK = 32;               // k rows a ring stage
constexpr int kN = 256;                  // kernel A's columns a call: 8 x 32

// padded stage row, and one stage, in elements, for N columns
template <int N>
__host__ __device__ constexpr int ring_ld() {
  return N + 8;
}
template <int N>
__host__ __device__ constexpr int stage_elems() {
  return kSlabK * ring_ld<N>();
}
constexpr int kStageElems = stage_elems<kN>();

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b, m16n8k16, bf16 operands, float accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half (the
// lower column / k index of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void st_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// W[k0 .. k0+32) x [0, N) -> one stage: 32*N/8 chunks of 16 bytes, N/64 a
// thread.
template <int N = kN>
__device__ __forceinline__ void load_slab(bf16* stage,
                                          const bf16* __restrict__ W, int ldw,
                                          int k0) {
  static_assert(N == 256 || N == 128, "ring GEMM takes 128 or 256 columns");
  constexpr int kShift = N == 256 ? 5 : 4;  // log2 of the chunks a row
#pragma unroll
  for (int i = 0; i < N / 64; ++i) {
    const int idx = threadIdx.x + 256 * i;
    const int r = idx >> kShift, c = (idx & (N / 8 - 1)) * 8;
    cp_async16(stage + r * ring_ld<N>() + c, W + (size_t)(k0 + r) * ldw + c);
  }
}

template <int NST, int N = kN>
__device__ __forceinline__ void ring_prefetch(const bf16* __restrict__ W,
                                              int ldw, int K, bf16* ring) {
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s * kSlabK < K)
      load_slab<N>(ring + s * stage_elems<N>(), W, ldw, s * kSlabK);
    cp_async_commit();
  }
}

// acc = A[0:16*MT, 0:K] @ W[0:K, N-column strip]; the first NST-1 slabs
// must have been issued by ring_prefetch with the same W, ldw, K and N.
template <int MT, int NST, int N = kN>
__device__ __forceinline__ void ring_gemm(const bf16* A, int lda, int K,
                                          const bf16* __restrict__ W, int ldw,
                                          bf16* ring,
                                          float (&acc)[MT][N / 64][4]) {
  constexpr int NJ = N / 64;   // n8 tiles a warp
  constexpr int LD = ring_ld<N>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  // ldmatrix lane addresses: A rows lane%16, k halves lane/16; the four
  // 8x8 B matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of two n8 tiles.
  const bf16* a_lane = A + (lane & 15) * lda + (lane >> 4) * 8;
  const int b_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     warp * (N / 8) + (lane >> 4) * 8;
  const int nslab = K / kSlabK;
  for (int i = 0; i < nslab; ++i) {
    cp_async_wait<NST - 2>();   // this thread's copies of slab i are in
    __syncthreads();            // everyone's are; slab i-1 is consumed
    const int nxt = i + NST - 1;
    if (nxt < nslab)
      load_slab<N>(ring + (nxt % NST) * stage_elems<N>(), W, ldw,
                   nxt * kSlabK);
    cp_async_commit();
    const bf16* st = ring + (i % NST) * stage_elems<N>() + b_lane;
    const bf16* a_k = a_lane + i * kSlabK;
#pragma unroll
    for (int kk = 0; kk < kSlabK; kk += 16) {
      // written out, not as a loop: kernel A's code stays as it was
      uint32_t b[NJ / 2][4];
      ldmatrix_x4_trans(b[0], st + kk * LD);
      if constexpr (NJ == 4) ldmatrix_x4_trans(b[1], st + kk * LD + 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a_k + mt * 16 * lda + kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[mt][j], a, b[j >> 1][(j & 1) * 2],
                   b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
  }
}

// LayerNorm (two-pass variance, eps 1e-5) over the N columns of the
// block's 16*MT x N GEMM output held in the warps' accumulators;
// op(r, c, y_c, y_c+1) receives each thread's column pairs.
// red: [2][8 warps][16*MT] floats.
template <int MT, int N = kN, typename Op>
__device__ __forceinline__ void layer_norm_acc(
    const float (&acc)[MT][N / 64][4], const float* __restrict__ scale,
    const float* __restrict__ bias, float* red, Op op) {
  constexpr int TM = 16 * MT, NJ = N / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float mean[MT][2], rstd[MT][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* rp = red + pass * 8 * TM;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float v = acc[mt][j][2 * h + i];
            s += pass == 0 ? v : (v - mean[mt][h]) * (v - mean[mt][h]);
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (q == 0) rp[warp * TM + mt * 16 + g + 8 * h] = s;
      }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) t += rp[w * TM + r];
        if (pass == 0)
          mean[mt][h] = t / N;
        else
          rstd[mt][h] = rsqrtf(t / N + 1e-5f);
      }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = warp * (N / 8) + j * 8 + 2 * q;
    const float s0 = scale[c], s1 = scale[c + 1];
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m = mean[mt][h], rs = rstd[mt][h];
        op(mt * 16 + g + 8 * h, c, (acc[mt][j][2 * h] - m) * rs * s0 + b0,
           (acc[mt][j][2 * h + 1] - m) * rs * s1 + b1);
      }
  }
}

}  // namespace mma
}  // namespace loftr
