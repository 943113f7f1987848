// The bfloat16 sim-tile machinery that kernels B (dual_softmax.cu) and E
// (sinkhorn.cu) share on sm_90a: rows of a [*, 256] bf16 matrix staged
// into shared memory by 16-byte cp.async, and a warp's product of 32
// resident rows with 8*NJ streamed rows on mma.m16n8k16.
//
// Shared rows are padded to kLd = 264 elements (528 bytes, an odd multiple
// of 16), so ldmatrix reads them without bank conflicts.  A block stages
// its resident rows once and streams tiles of rows through a ring of
// stages; warp (wr, wc) owns resident rows [32 wr, 32 wr + 32) and streamed
// rows [8 NJ wc, 8 NJ wc + 8 NJ) of each tile as acc[mt][j][i]: resident row
// 32 wr + 16 mt + lane/4 + 8 (i/2), streamed row 8 NJ wc + 8 j + 2 (lane%4)
// + i%2 (the accumulator layout of mma.m16n8k16).
#pragma once

#include "common.cuh"
#include "mma_tile.cuh"

namespace loftr {
namespace ring {

using mma::bf16;
constexpr int kC = 256;          // the coarse width of every preset
constexpr int kLd = kC + 8;      // shared row stride: 528 bytes, 33 x 16
constexpr int kChunks = kC / 8;  // 16-byte chunks a row
constexpr int kSmemSM = 233472;  // shared memory an SM (H100), 1 KB a block

// rows [0, n) of a [*, kC] bf16 matrix -> dst (row stride kLd) by cp.async,
// rows [n, ROWS) zero-filled; the copies join the caller's next group.
template <int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int n) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    if (r < n)
      mma::cp_async16(dst + r * kLd + c, src + (size_t)r * kC + c);
    else
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = make_uint4(0, 0, 0, 0);
  }
}

// (v, j) beats (bv, bj): larger, or equal with the lower index.
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && j < bj);
}

// ldmatrix lane addresses: A (resident rows) rows lane%16, k halves
// lane/16; B (streamed rows = n) the four 8x8 matrices (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15): b0, b1 of one n8
// tile, then of the next.  a_lane points into the resident tile, b_lane is
// an offset into a ring stage.
__device__ __forceinline__ const bf16* a_lane(const bf16* As, int wr,
                                              int lane) {
  return As + (wr * 32 + (lane & 15)) * kLd + (lane >> 4) * 8;
}

template <int NJ>
__device__ __forceinline__ int b_lane(int wc, int lane) {
  return (wc * 8 * NJ + (lane & 7) + ((lane >> 4) & 1) * 8) * kLd +
         ((lane >> 3) & 1) * 8;
}

// acc = the warp's 32 resident rows (from a_lane) . its 8*NJ streamed rows
// (bs = stage + b_lane) over all kC; each ldmatrix.x4 of B feeds 4 mma.
template <int NJ>
__device__ __forceinline__ void product(float (&acc)[2][NJ][4],
                                        const bf16* al, const bf16* bs) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
#pragma unroll
  for (int k = 0; k < kC; k += 16) {
    uint32_t a[2][4];
    mma::ldmatrix_x4(a[0], al + k);
    mma::ldmatrix_x4(a[1], al + 16 * kLd + k);
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      uint32_t bq[4];
      mma::ldmatrix_x4(bq, bs + p * 16 * kLd + k);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma::mma_bf16(acc[mt][2 * p], a[mt], bq[0], bq[1]);
        mma::mma_bf16(acc[mt][2 * p + 1], a[mt], bq[2], bq[3]);
      }
    }
  }
}

}  // namespace ring
}  // namespace loftr
