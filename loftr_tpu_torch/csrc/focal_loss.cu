// Fused dense focal coarse loss: forward sums and feature gradients without
// the [L, S] matrix.
//
// Replaces loftr_tpu/ops/pallas/focal_loss.py::fused_focal_sums (forward
// _loss_kernel; backward _srow_scol_kernel and _grad_kernel).  The row and
// column softmax statistics (its _stats_kernel pass) come from
// dual_softmax.cu through loftr_dual_softmax_stats.
//
// sim = (f0 . f1^T) * scale + (m0 m1 - 1) * 1e9, scale = 1/(C*T);
// r = softmax_row(sim), c = softmax_col(sim), conf = r c, w = m0 m1;
// cell (i, j) is positive when gt_valid[i] and gt_j[i] == j.
//   forward:  pos = sum_pos w * focal_pos(conf), neg = sum_neg w * focal_neg(conf)
//   backward: A = focal'(conf) * w * g * conf (g = gpos or gneg; focal' is 0
//             outside the clamp (1e-6, 1 - 1e-6)),
//             Srow = sum_j A, Scol = sum_i A                       (pass B1)
//             dsim = 2A - r Srow - c Scol,
//             dfeat0 = dsim @ f1 * scale, dfeat1 = dsim^T @ f0 * scale (pass B2)
//
// What bounds it on the H100: operations (each pass recomputes the
// 2*L*S*C-flop sim tiles; B2 adds one 2*L*S*C product per gradient) against
// (L+S)*C values in and out.
//
// The TPU kernels carry pos/neg, Scol and dfeat1 across a sequential grid.
// CUDA blocks run in no order, so:
//  - the forward sums, Srow and Scol are written as per-block partials and
//    added by small kernels in a fixed order (no float atomics);
//  - each gradient has a grid of its own that owns 64-row tiles of its own
//    side and loops over the other side, recomputing the sim tiles, so
//    nothing is summed across blocks.  One kernel serves both: with the
//    sides swapped, sim becomes its transpose and the row statistics the
//    column statistics; only the lookup of the ground truth changes side.
// Sim tiles of bf16 features run on the tensor cores (sim_tile.cuh); dsim is
// float, so the gradient products run in float on the CUDA cores.

#include "sim_tile.cuh"

namespace loftr {
namespace {

constexpr float kBig = 1e9f;
constexpr float kEps = 1e-6f;
constexpr int kMaxC = 256;  // grad_kernel keeps a [64, kMaxC] tile per block
constexpr int kLdd = kTN + 1;  // dsim tile and feature slab row stride

__device__ __forceinline__ float powg(float x, float gamma) {
  return gamma == 2.f ? x * x : powf(x, gamma);
}

// pow(x, gamma - 1)
__device__ __forceinline__ float powg1(float x, float gamma) {
  return gamma == 2.f ? x : powf(x, gamma - 1.f);
}

// Focal value of one cell (conf unclamped).
__device__ __forceinline__ float focal_value(float conf, bool is_pos,
                                             float alpha, float gamma) {
  const float c = fminf(fmaxf(conf, kEps), 1.f - kEps);
  return is_pos ? -alpha * powg(1.f - c, gamma) * logf(c)
                : -alpha * powg(c, gamma) * log1pf(-c);
}

// d focal / d conf, zero outside the clamp's open interval.
__device__ __forceinline__ float focal_slope(float conf, bool is_pos,
                                             float alpha, float gamma) {
  if (!(conf > kEps && conf < 1.f - kEps)) return 0.f;
  const float c = conf;
  if (is_pos)
    return -alpha * (-gamma * powg1(1.f - c, gamma) * logf(c) +
                     powg(1.f - c, gamma) / c);
  return -alpha * (gamma * powg1(c, gamma) * log1pf(-c) -
                   powg(c, gamma) / (1.f - c));
}

// MODE 0 (forward): per-block partial (pos, neg) sums.
// MODE 1 (backward pass B1): row partials of A per column chunk, column
// partials per row tile.  Grid (row tiles, column chunks, B).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    focal_tile_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                      const float* __restrict__ m0,
                      const float* __restrict__ m1,
                      const float* __restrict__ rmax,
                      const float* __restrict__ rsum,
                      const float* __restrict__ cmax,
                      const float* __restrict__ csum,
                      const int* __restrict__ gtj,
                      const float* __restrict__ gtv,
                      const float* __restrict__ gpos,
                      const float* __restrict__ gneg,
                      float* __restrict__ part, float* __restrict__ row_p,
                      float* __restrict__ col_p, int L, int S, int C,
                      int chunk_tiles, float scale, float alpha, float gamma) {
  __shared__ __align__(128) unsigned char tile_smem[kTileBytes];
  __shared__ float red[16][kTN];
  __shared__ float wsum[2][kThreads / 32];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rt = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int nrt = gridDim.x, nch = gridDim.y;
  const int i0 = rt * kTM;
  const T* f0b = f0 + (size_t)b * L * C;
  const T* f1b = f1 + (size_t)b * S * C;

  int rows[4], rgt[4];
  float rm0[4], rmx[4], rsm[4], racc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rows[a] = i0 + ty + 16 * a;
    const bool ok = rows[a] < L;
    const size_t o = (size_t)b * L + rows[a];
    rm0[a] = ok ? m0[o] : 0.f;
    rmx[a] = ok ? rmax[o] : 0.f;
    rsm[a] = ok ? rsum[o] : 1.f;
    rgt[a] = (ok && gtv[o] > 0.f) ? gtj[o] : -1;
    racc[a] = 0.f;
  }
  float gp = 0.f, gn = 0.f;
  if (MODE == 1) {
    gp = gpos[b];
    gn = gneg[b];
  }
  float pos = 0.f, neg = 0.f;

  const int ct0 = chunk * chunk_tiles;
  for (int ct = ct0; ct < ct0 + chunk_tiles; ++ct) {
    const int j0 = ct * kTN;
    if (j0 >= S) break;
    float acc[4][4];
    sim_tile<T>(f0b, f1b, L, S, C, i0, j0, tile_smem, acc);
    int cols[4];
    float cm1[4], cmx[4], csm[4], cacc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cols[c] = j0 + tx + 16 * c;
      const bool ok = cols[c] < S;
      const size_t o = (size_t)b * S + cols[c];
      cm1[c] = ok ? m1[o] : 0.f;
      cmx[c] = ok ? cmax[o] : 0.f;
      csm[c] = ok ? csum[o] : 1.f;
      cacc[c] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (rows[a] >= L || cols[c] >= S) continue;
        const float w = rm0[a] * cm1[c];
        const float sim = acc[a][c] * scale + (w - 1.f) * kBig;
        const float conf =
            expf(sim - rmx[a]) / rsm[a] * (expf(sim - cmx[c]) / csm[c]);
        const bool is_pos = cols[c] == rgt[a];
        if (MODE == 0) {
          const float v = focal_value(conf, is_pos, alpha, gamma) * w;
          if (is_pos)
            pos += v;
          else
            neg += v;
        } else {
          const float A = focal_slope(conf, is_pos, alpha, gamma) * w *
                          (is_pos ? gp : gn) * conf;
          racc[a] += A;
          cacc[c] += A;
        }
      }
    if (MODE == 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) red[ty][tx + 16 * c] = cacc[c];
      __syncthreads();
      if (tid < kTN && j0 + tid < S) {
        float s = 0.f;
        for (int t = 0; t < 16; ++t) s += red[t][tid];
        col_p[((size_t)b * nrt + rt) * S + j0 + tid] = s;
      }
      __syncthreads();
    }
  }
  if (MODE == 0) {
    pos = warp_sum(pos);
    neg = warp_sum(neg);
    if ((tid & 31) == 0) {
      wsum[0][tid >> 5] = pos;
      wsum[1][tid >> 5] = neg;
    }
    __syncthreads();
    if (tid < 2) {
      float s = 0.f;
      for (int t = 0; t < kThreads / 32; ++t) s += wsum[tid][t];
      part[(((size_t)b * nrt + rt) * nch + chunk) * 2 + tid] = s;
    }
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float s = racc[a];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tx == 0 && rows[a] < L)
        row_p[((size_t)b * nch + chunk) * L + rows[a]] = s;
    }
  }
}

// out[b, i] = sum over t < n of p[b, t, i], in ascending t.
__global__ void sum_combine_kernel(const float* __restrict__ p, int n, int len,
                                   int B, float* __restrict__ o) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * len) return;
  const int b = idx / len, i = idx % len;
  float s = 0.f;
  for (int t = 0; t < n; ++t) s += p[((size_t)b * n + t) * len + i];
  o[idx] = s;
}

// pos[b], neg[b] from the per-block partials part[b, n, 2], in ascending
// block order.
__global__ void scalar_combine_kernel(const float* __restrict__ part, int n,
                                      int B, float* __restrict__ pos,
                                      float* __restrict__ neg) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * B) return;
  const int b = idx / 2, which = idx % 2;
  float s = 0.f;
  for (int t = 0; t < n; ++t) s += part[((size_t)b * n + t) * 2 + which];
  (which == 0 ? pos : neg)[b] = s;
}

// Backward pass B2 for one side.  The block owns the 64 rows a0.. of side
// "a" ([La, C]) and loops over side "b" ([Lb, C]) in 64-row tiles:
//   out[a] = scale * sum_b dsim[a, b] * fb[b],
//   dsim = 2A - ra * sa - rb * sb,  ra = exp(sim - amax) / asum (and rb alike).
// GT_ON_A: the ground-truth table (gtj, gtv) is indexed by side a (a is
// image 0: dfeat0); else by side b (a is image 1: dfeat1).  Grid (a tiles, B).
template <typename T, bool GT_ON_A>
__global__ void __launch_bounds__(kThreads)
    focal_grad_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                      const float* __restrict__ ma,
                      const float* __restrict__ mb,
                      const float* __restrict__ amax,
                      const float* __restrict__ asum,
                      const float* __restrict__ bmax,
                      const float* __restrict__ bsum,
                      const float* __restrict__ sa,
                      const float* __restrict__ sb,
                      const int* __restrict__ gtj,
                      const float* __restrict__ gtv,
                      const float* __restrict__ gpos,
                      const float* __restrict__ gneg, T* __restrict__ out,
                      int La, int Lb, int C, float scale, float alpha,
                      float gamma) {
  __shared__ __align__(128) unsigned char tile_smem[kTileBytes];
  __shared__ float D[kTM][kLdd];
  static_assert(kTileBytes >= kTN * kLdd * sizeof(float),
                "the feature slab reuses the sim tile's shared memory");
  float(*F)[kLdd] = reinterpret_cast<float(*)[kLdd]>(tile_smem);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTM;
  const T* fab = fa + (size_t)b * La * C;
  const T* fbb = fb + (size_t)b * Lb * C;
  const float gp = gpos[b], gn = gneg[b];

  int rows[4], rgt[4];
  float rma[4], rmx[4], rsm[4], rs[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rows[a] = a0 + ty + 16 * a;
    const bool ok = rows[a] < La;
    const size_t o = (size_t)b * La + rows[a];
    rma[a] = ok ? ma[o] : 0.f;
    rmx[a] = ok ? amax[o] : 0.f;
    rsm[a] = ok ? asum[o] : 1.f;
    rs[a] = ok ? sa[o] : 0.f;
    rgt[a] = -1;
    if (GT_ON_A && ok && gtv[o] > 0.f) rgt[a] = gtj[o];
  }
  float acc[4][16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[a][c] = 0.f;

  for (int b0 = 0; b0 < Lb; b0 += kTN) {
    float s[4][4];
    sim_tile<T>(fab, fbb, La, Lb, C, a0, b0, tile_smem, s);
    int cols[4], cgt[4];
    float cmb[4], cmx[4], csm[4], cs[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cols[c] = b0 + tx + 16 * c;
      const bool ok = cols[c] < Lb;
      const size_t o = (size_t)b * Lb + cols[c];
      cmb[c] = ok ? mb[o] : 0.f;
      cmx[c] = ok ? bmax[o] : 0.f;
      csm[c] = ok ? bsum[o] : 1.f;
      cs[c] = ok ? sb[o] : 0.f;
      cgt[c] = -1;
      if (!GT_ON_A && ok && gtv[o] > 0.f) cgt[c] = gtj[o];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float d = 0.f;
        if (rows[a] < La && cols[c] < Lb) {
          const float w = rma[a] * cmb[c];
          const float sim = s[a][c] * scale + (w - 1.f) * kBig;
          const float ra = expf(sim - rmx[a]) / rsm[a];
          const float rb = expf(sim - cmx[c]) / csm[c];
          const float conf = ra * rb;
          const bool is_pos =
              GT_ON_A ? cols[c] == rgt[a] : rows[a] == cgt[c];
          const float A = focal_slope(conf, is_pos, alpha, gamma) * w *
                          (is_pos ? gp : gn) * conf;
          d = 2.f * A - ra * rs[a] - rb * cs[c];
        }
        D[ty + 16 * a][tx + 16 * c] = d;
      }
    // all threads are past their reads of the sim tile before the feature
    // slab overwrites its shared memory, and D is complete
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kMaxC / 64; ++cc) {
      const int c0 = cc * 64;
      if (c0 < C) {
        for (int e = tid; e < kTN * 64; e += kThreads) {
          const int k = e / 64, c = e % 64;
          const int gb = b0 + k, gc = c0 + c;
          F[k][c] = (gb < Lb && gc < C) ? to_f(fbb[(size_t)gb * C + gc]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kTN; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = D[ty + 16 * a][k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = F[k][tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[a][cc * 4 + c] = fmaf(av[a], bv[c], acc[a][cc * 4 + c]);
        }
        __syncthreads();
      }
    }
  }
  T* outb = out + (size_t)b * La * C;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (rows[a] >= La) continue;
#pragma unroll
    for (int cc = 0; cc < kMaxC / 64; ++cc)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gc = cc * 64 + tx + 16 * c;
        if (gc < C)
          outb[(size_t)rows[a] * C + gc] =
              from_f<T>(acc[a][cc * 4 + c] * scale);
      }
  }
}

inline dim3 tile_grid(int B, int L, int S, int chunk_tiles) {
  const int nrt = (L + kTM - 1) / kTM;
  const int nct = (S + kTN - 1) / kTN;
  return dim3(nrt, (nct + chunk_tiles - 1) / chunk_tiles, B);
}

template <typename T>
int launch_fwd(const void* f0, const void* f1, const void* m0, const void* m1,
               const void* rmax, const void* rsum, const void* cmax,
               const void* csum, const void* gtj, const void* gtv, void* part,
               void* pos, void* neg, int B, int L, int S, int C,
               int chunk_tiles, float scale, float alpha, float gamma,
               cudaStream_t st) {
  const dim3 grid = tile_grid(B, L, S, chunk_tiles);
  focal_tile_kernel<T, 0><<<grid, kThreads, 0, st>>>(
      (const T*)f0, (const T*)f1, (const float*)m0, (const float*)m1,
      (const float*)rmax, (const float*)rsum, (const float*)cmax,
      (const float*)csum, (const int*)gtj, (const float*)gtv, nullptr, nullptr,
      (float*)part, nullptr, nullptr, L, S, C, chunk_tiles, scale, alpha,
      gamma);
  scalar_combine_kernel<<<(2 * B + 63) / 64, 64, 0, st>>>(
      (const float*)part, (int)(grid.x * grid.y), B, (float*)pos, (float*)neg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* f0, const void* f1, const void* m0, const void* m1,
               const void* rmax, const void* rsum, const void* cmax,
               const void* csum, const void* gtj, const void* gtv,
               const void* gpos, const void* gneg, void* row_p, void* col_p,
               void* srow, void* scol, void* df0, void* df1, int B, int L,
               int S, int C, int chunk_tiles, float scale, float alpha,
               float gamma, cudaStream_t st) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  const dim3 grid = tile_grid(B, L, S, chunk_tiles);
  focal_tile_kernel<T, 1><<<grid, kThreads, 0, st>>>(
      (const T*)f0, (const T*)f1, (const float*)m0, (const float*)m1,
      (const float*)rmax, (const float*)rsum, (const float*)cmax,
      (const float*)csum, (const int*)gtj, (const float*)gtv,
      (const float*)gpos, (const float*)gneg, nullptr, (float*)row_p,
      (float*)col_p, L, S, C, chunk_tiles, scale, alpha, gamma);
  sum_combine_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(
      (const float*)row_p, (int)grid.y, L, B, (float*)srow);
  sum_combine_kernel<<<(B * S + 255) / 256, 256, 0, st>>>(
      (const float*)col_p, (int)grid.x, S, B, (float*)scol);
  focal_grad_kernel<T, true><<<dim3((L + kTM - 1) / kTM, B), kThreads, 0, st>>>(
      (const T*)f0, (const T*)f1, (const float*)m0, (const float*)m1,
      (const float*)rmax, (const float*)rsum, (const float*)cmax,
      (const float*)csum, (const float*)srow, (const float*)scol,
      (const int*)gtj, (const float*)gtv, (const float*)gpos,
      (const float*)gneg, (T*)df0, L, S, C, scale, alpha, gamma);
  focal_grad_kernel<T, false><<<dim3((S + kTM - 1) / kTM, B), kThreads, 0,
                                st>>>(
      (const T*)f1, (const T*)f0, (const float*)m1, (const float*)m0,
      (const float*)cmax, (const float*)csum, (const float*)rmax,
      (const float*)rsum, (const float*)scol, (const float*)srow,
      (const int*)gtj, (const float*)gtv, (const float*)gpos,
      (const float*)gneg, (T*)df1, S, L, C, scale, alpha, gamma);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace loftr

// Forward pass 2.  f0 [B, L, C], f1 [B, S, C] (T); m0 [B, L], m1 [B, S]
// float 0/1; rmax, rsum [B, L], cmax, csum [B, S] from
// loftr_dual_softmax_stats with the same chunk_tiles and scale; gtj [B, L]
// int32, gtv [B, L] float 0/1.  Scratch: part [B, nrt * nch, 2] float.
// Outputs: pos, neg [B] float.
extern "C" int loftr_focal_fwd(const void* f0, const void* f1, const void* m0,
                               const void* m1, const void* rmax,
                               const void* rsum, const void* cmax,
                               const void* csum, const void* gtj,
                               const void* gtv, void* part, void* pos,
                               void* neg, int B, int L, int S, int C,
                               int chunk_tiles, float scale, float alpha,
                               float gamma, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch_fwd<__nv_bfloat16>(
        f0, f1, m0, m1, rmax, rsum, cmax, csum, gtj, gtv, part, pos, neg, B, L,
        S, C, chunk_tiles, scale, alpha, gamma, st);
  return loftr::launch_fwd<float>(f0, f1, m0, m1, rmax, rsum, cmax, csum, gtj,
                                  gtv, part, pos, neg, B, L, S, C, chunk_tiles,
                                  scale, alpha, gamma, st);
}

// Backward.  Inputs as the forward's, plus gpos, gneg [B] float (the
// cotangents of pos and neg, on the device).  Scratch: row_p [B, nch, L],
// col_p [B, nrt, S] float.  Outputs: srow [B, L], scol [B, S] float; df0
// [B, L, C], df1 [B, S, C] (T).  C <= 256.
extern "C" int loftr_focal_bwd(const void* f0, const void* f1, const void* m0,
                               const void* m1, const void* rmax,
                               const void* rsum, const void* cmax,
                               const void* csum, const void* gtj,
                               const void* gtv, const void* gpos,
                               const void* gneg, void* row_p, void* col_p,
                               void* srow, void* scol, void* df0, void* df1,
                               int B, int L, int S, int C, int chunk_tiles,
                               float scale, float alpha, float gamma,
                               int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch_bwd<__nv_bfloat16>(
        f0, f1, m0, m1, rmax, rsum, cmax, csum, gtj, gtv, gpos, gneg, row_p,
        col_p, srow, scol, df0, df1, B, L, S, C, chunk_tiles, scale, alpha,
        gamma, st);
  return loftr::launch_bwd<float>(f0, f1, m0, m1, rmax, rsum, cmax, csum, gtj,
                                  gtv, gpos, gneg, row_p, col_p, srow, scol,
                                  df0, df1, B, L, S, C, chunk_tiles, scale,
                                  alpha, gamma, st);
}
