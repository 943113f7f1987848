// One 64x64 tile of f0 . f1^T from shared-memory k-slabs, shared by the
// dual-softmax kernels (dual_softmax.cu) and the focal-loss kernels
// (focal_loss.cu).
//
// bf16 features: bf16 slabs and WMMA (tensor cores, float accumulation: the
// products of bf16 values are exact in float).  float features: float slabs
// and CUDA-core FMAs (the exactness path).
#pragma once

#include "common.cuh"

namespace loftr {

constexpr int kTM = 64, kTN = 64, kTK = 32;
constexpr int kLdh = kTK + 8;   // bf16 slab row stride (WMMA: multiple of 8)
constexpr int kLds = kTN + 4;   // float sim tile row stride
constexpr size_t kFloatSlabs = 2 * kTK * (kTM + 1) * sizeof(float);
constexpr size_t kHalfSlabs = 2 * kTM * kLdh * sizeof(__nv_bfloat16) +
                              kTM * kLds * sizeof(float);
constexpr size_t kTileBytes = kFloatSlabs > kHalfSlabs ? kFloatSlabs
                                                       : kHalfSlabs;

// acc[a][c] = <f0b[i0 + ty + 16a], f1b[j0 + tx + 16c]> for the thread
// (ty, tx) = (tid / 16, tid % 16) of a 256-thread block; rows past L and
// columns past S read as zero.  tile_smem: kTileBytes, 128-byte aligned
// (float path: k-slabs As/Bs [kTK][64+1]; bf16 path: slabs A16/B16
// [64][kLdh] and the float tile Ssim [64][kLds]).  Every thread of the
// block must call it; it synchronises the block, and on return no thread
// still writes tile_smem (a caller that reuses tile_smem synchronises once
// more, since other threads may still be reading their entries).
template <typename T>
__device__ __forceinline__ void sim_tile(const T* __restrict__ f0b,
                                         const T* __restrict__ f1b, int L,
                                         int S, int C, int i0, int j0,
                                         unsigned char* tile_smem,
                                         float (&acc)[4][4]) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  if constexpr (kTC) {
    // warp w: 16-row tile w/2, 16-column tiles 2*(w%2) and 2*(w%2)+1
    using namespace nvcuda;
    __nv_bfloat16* A16 = reinterpret_cast<__nv_bfloat16*>(tile_smem);
    __nv_bfloat16* B16 = A16 + kTM * kLdh;
    float* Ssim = reinterpret_cast<float*>(B16 + kTN * kLdh);
    const int warp = tid >> 5, mi = warp >> 1, nj = (warp & 1) * 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fr[2];
    wmma::fill_fragment(fr[0], 0.f);
    wmma::fill_fragment(fr[1], 0.f);
    for (int k0 = 0; k0 < C; k0 += kTK) {
      for (int e = tid; e < kTM * kTK; e += kThreads) {
        const int r = e / kTK, k = e % kTK;
        const int gi = i0 + r, gj = j0 + r, gk = k0 + k;
        const __nv_bfloat16 z = __float2bfloat16(0.f);
        A16[r * kLdh + k] = (gi < L && gk < C) ? f0b[(size_t)gi * C + gk] : z;
        B16[r * kLdh + k] = (gj < S && gk < C) ? f1b[(size_t)gj * C + gk] : z;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A16 + mi * 16 * kLdh + kk, kLdh);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // sim = f0 . f1^T: f1 rows are the columns of B (col-major)
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fb, B16 + (nj + j) * 16 * kLdh + kk, kLdh);
          wmma::mma_sync(fr[j], fa, fb, fr[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ssim + mi * 16 * kLds + (nj + j) * 16, fr[j],
                              kLds, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[a][c] = Ssim[(ty + 16 * a) * kLds + tx + 16 * c];
  } else {
    float(*As)[kTM + 1] = reinterpret_cast<float(*)[kTM + 1]>(tile_smem);
    float(*Bs)[kTN + 1] = As + kTK;
    for (int k0 = 0; k0 < C; k0 += kTK) {
      for (int e = tid; e < kTM * kTK; e += kThreads) {
        const int r = e / kTK, k = e % kTK;
        const int gi = i0 + r, gj = j0 + r, gk = k0 + k;
        As[k][r] = (gi < L && gk < C) ? to_f(f0b[(size_t)gi * C + gk]) : 0.f;
        Bs[k][r] = (gj < S && gk < C) ? to_f(f1b[(size_t)gj * C + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kTK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = As[k][ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[k][tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
      __syncthreads();
    }
  }
}

}  // namespace loftr
