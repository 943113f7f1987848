// Fused dense focal coarse loss: forward sums and feature gradients without
// the [L, S] matrix.
//
// Replaces loftr_tpu/ops/pallas/focal_loss.py::fused_focal_sums (forward
// _loss_kernel; backward _srow_scol_kernel and _grad_kernel).  The row and
// column softmax statistics (its _stats_kernel pass) come from
// dual_softmax.cu: loftr_dual_softmax_bf16_stats (kernel B's bf16 pass 1)
// on the bf16 path below, loftr_dual_softmax_stats on the tile path.
//
// sim = (f0 . f1^T) * sim_scale + (m0 m1 - 1) * 1e9;
// r = softmax_row(sim), c = softmax_col(sim), conf = r c, w = m0 m1;
// cell (i, j) is positive when gt_valid[i] and gt_j[i] == j.
//   forward:  pos = sum_pos w * focal_pos(conf), neg = sum_neg w * focal_neg(conf)
//   backward: A = focal'(conf) * w * g * conf (g = gpos or gneg; focal' is 0
//             outside the clamp (1e-6, 1 - 1e-6)),
//             Srow = sum_j A, Scol = sum_i A,
//             dsim = 2A - r Srow - c Scol,
//             dfeat0 = dsim @ f1 * grad_scale, dfeat1 = dsim^T @ f0 * grad_scale.
// The JAX kernel scales the features by s = 1/sqrt(C*T) before every pass
// and, for bf16 features, rounds s and each scaled feature to bf16.  Here
// float features keep the raw dot with sim_scale = grad_scale = 1/(C*T);
// bf16 features are first rounded as JAX rounds them (focal_prescale:
// f~ = bf16(f * bf16(s))), and every pass reads those copies with sim_scale
// 1 and grad_scale s.
//
// What bounds it on the H100: operations.  Forward 2 sim products of
// 2*L*S*C flop (statistics, loss); backward 2 gradient grids, each a sim
// product and a gradient product of 2*L*S*C, against (L+S)*C values in and
// out.
//
// The TPU kernels carry pos/neg, Scol and dfeat1 across a sequential grid.
// CUDA blocks run in no order, so sums come out as per-block partials that
// small kernels add in ascending order (no float atomics), and each
// gradient has a grid of its own that owns rows of its side and loops over
// the other side; with the sides swapped, sim becomes its transpose and the
// row statistics the column statistics.
//
// bf16 features, C = 256 (namespace bf): kernel B's pattern (sim_ring.cuh:
// resident rows staged once by cp.async into rows padded to kLd = 264,
// streamed tiles through a cp.async ring, mma.m16n8k16, epilogues on the
// accumulators).
//  - The loss pass runs on kernel B's 128 x 128 tile and forms conf once an
//    element.  With a gradient to come it also forms a = focal'(conf) w conf
//    and writes its row partials per column chunk and its column partials
//    per row tile split by class (positive cell or not): the backward's A is
//    a * gpos or a * gneg, so Srow = gpos Srow_pos + gneg Srow_neg (and
//    Scol alike) without the JAX backward's first sim pass.
//  - A gradient grid block owns 128 rows of side a (8 warps x 16 rows) and
//    streams side b in tiles of 8 NJ rows: sim on mma.sync, dsim on the
//    accumulators, then dsim @ fb on mma.sync too.  dsim is split into bf16
//    hi = bf16(dsim) and lo = bf16(dsim - hi), two mma a fragment (about 16
//    mantissa bits; fb is exact in bf16 and the output is rounded to bf16).
//    The m16n8k16 accumulators of two adjacent n8 tiles are the A fragment
//    of one k16 step, so dsim goes from registers into the second product;
//    its B operand is the ring stage that fed the sim product, read with
//    ldmatrix.trans.  Side b is cut into chunks (bf16_plan) so the grid
//    fills the card; chunks write float partials [B, nch, La, C] that
//    grad_combine adds in ascending order, scales and rounds.
// Other C, and float features: 64x64 sim tiles (sim_tile.cuh) rebuilt at
// every k-step, the gradient products in float on the CUDA cores.

#include "sim_ring.cuh"
#include "sim_tile.cuh"

namespace loftr {
namespace {

constexpr float kBig = 1e9f;
constexpr float kEps = 1e-6f;
constexpr int kMaxC = 256;  // grad_kernel keeps a [64, kMaxC] tile per block
constexpr int kLdd = kTN + 1;  // dsim tile and feature slab row stride

// pow(x, gamma); G2: gamma is 2
template <bool G2 = false>
__device__ __forceinline__ float powg(float x, float gamma) {
  return G2 || gamma == 2.f ? x * x : powf(x, gamma);
}

// pow(x, gamma - 1)
template <bool G2 = false>
__device__ __forceinline__ float powg1(float x, float gamma) {
  return G2 || gamma == 2.f ? x : powf(x, gamma - 1.f);
}

// Focal value of one cell (conf unclamped).
template <bool G2 = false>
__device__ __forceinline__ float focal_value(float conf, bool is_pos,
                                             float alpha, float gamma) {
  const float c = fminf(fmaxf(conf, kEps), 1.f - kEps);
  return is_pos ? -alpha * powg<G2>(1.f - c, gamma) * logf(c)
                : -alpha * powg<G2>(c, gamma) * log1pf(-c);
}

// d focal / d conf at c inside the clamp's open interval (1e-6, 1 - 1e-6).
template <bool G2 = false>
__device__ __forceinline__ float focal_slope_in(float c, bool is_pos,
                                                float alpha, float gamma) {
  if (is_pos)
    return -alpha * (-gamma * powg1<G2>(1.f - c, gamma) * logf(c) +
                     powg<G2>(1.f - c, gamma) / c);
  return -alpha * (gamma * powg1<G2>(c, gamma) * log1pf(-c) -
                   powg<G2>(c, gamma) / (1.f - c));
}

// d focal / d conf, zero outside the clamp's open interval.
template <bool G2 = false>
__device__ __forceinline__ float focal_slope(float conf, bool is_pos,
                                             float alpha, float gamma) {
  if (!(conf > kEps && conf < 1.f - kEps)) return 0.f;
  return focal_slope_in<G2>(conf, is_pos, alpha, gamma);
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
//   out[a] = grad_scale * sum_b dsim[a, b] * fb[b],
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
                      int La, int Lb, int C, float scale, float grad_scale,
                      float alpha, float gamma) {
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
              from_f<T>(acc[a][cc * 4 + c] * grad_scale);
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
               int S, int C, int chunk_tiles, float scale, float grad_scale,
               float alpha, float gamma, cudaStream_t st) {
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
      (const float*)gneg, (T*)df0, L, S, C, scale, grad_scale, alpha, gamma);
  focal_grad_kernel<T, false><<<dim3((S + kTM - 1) / kTM, B), kThreads, 0,
                                st>>>(
      (const T*)f1, (const T*)f0, (const float*)m1, (const float*)m0,
      (const float*)cmax, (const float*)csum, (const float*)rmax,
      (const float*)rsum, (const float*)scol, (const float*)srow,
      (const int*)gtj, (const float*)gtv, (const float*)gpos,
      (const float*)gneg, (T*)df1, S, L, C, scale, grad_scale, alpha, gamma);
  return (int)cudaGetLastError();
}

// f~ = bf16(f * sb) for both feature maps (sb = bf16(s) as a float: the
// product of two bf16 values is exact in float, so this is the bf16
// product JAX forms).
__global__ void focal_prescale(const __nv_bfloat16* __restrict__ f0,
                               const __nv_bfloat16* __restrict__ f1,
                               __nv_bfloat16* __restrict__ o0,
                               __nv_bfloat16* __restrict__ o1, long long n0,
                               long long n1, float sb) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n0 + n1; i += stride) {
    if (i < n0)
      o0[i] = __float2bfloat16(__bfloat162float(f0[i]) * sb);
    else
      o1[i - n0] = __float2bfloat16(__bfloat162float(f1[i - n0]) * sb);
  }
}

// ---- bfloat16, C = 256: mma.sync on resident row tiles --------------------

namespace bf {

using namespace ring;  // bf16, kC, kLd, stage_rows, a_lane, b_lane, product

// The loss pass: kernel B's tile, WR warps down R = 32 WR rows of f0, 8/WR
// across N = 64 NJ / WR f1 rows a tile, NST ring stages.  red: a tile's
// column partials [2][WR][N] (with a gradient to come), the end-of-block
// exchange of row partials [R][WC][2]; then [8][2] for the block's sums
// and [8] flags.
template <int WR, int NJ, int NST>
struct LossCfg {
  static constexpr int kWC = 8 / WR;
  static constexpr int kR = 32 * WR;
  static constexpr int kN = 8 * NJ * kWC;
  static constexpr int kRed = 2 * WR * kN > 2 * kR * kWC ? 2 * WR * kN
                                                          : 2 * kR * kWC;
  static constexpr size_t kSmem =
      (size_t)(kR + NST * kN) * kLd * sizeof(bf16) +
      (kRed + 16 + 8) * sizeof(float);
  static_assert(NJ <= 8, "a thread's cells of a tile index a 64-bit mask");
};

// One loss pass over the block's row tile x column chunk, on the bf16
// copies (sim scale 1).  rstat = [rmax; 1/rsum] [2, B, L], cstat = [cmax;
// 1/csum] [2, B, S] from kernel B's pass 1; m0 / m1 0/1 or both null.
//   part [B, nrt, nch, 2]: the block's (pos, neg) sums.
//   GRAD: row_p [2, B, nch, L] and col_p [2, B, nrt, S]: partial sums of
//         a = focal'(conf) w conf over the chunk / the row tile, positive
//         cells in [0], the others in [1].
// A cell of weight 0 (masked, or past L or S) adds nothing, so it is
// skipped; its sim bias is then not 0, which is how it is found.  Thread
// (warp, lane) holds rows wr*32 + 16*mt + g + 8*h and columns wc*8*NJ +
// 8*j + 2*q + e of each tile as acc[mt][j][2*h + e].
template <int WR, int NJ, int NST, bool GRAD, bool G2>
__global__ void __launch_bounds__(kThreads, 1)
    focal_loss_bf16(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                    const float* __restrict__ m0,
                    const float* __restrict__ m1,
                    const float* __restrict__ rstat,
                    const float* __restrict__ cstat,
                    const int* __restrict__ gtj,
                    const float* __restrict__ gtv, float* __restrict__ part,
                    float* __restrict__ row_p, float* __restrict__ col_p,
                    int B, int L, int S, int chunk_tiles, float alpha,
                    float gamma) {
  using K = LossCfg<WR, NJ, NST>;
  constexpr int WC = K::kWC, R = K::kR, N = K::kN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = (bf16*)smem_raw;                  // [R][kLd] the f0 rows
  bf16* ring = As + R * kLd;                   // NST x [N][kLd] f1 rows
  float* red = (float*)(ring + NST * N * kLd);  // cross-warp partials
  float* wsum = red + K::kRed;                 // [8][2]
  int* wlive = (int*)(wsum + 16);              // [8]: a warp had live cells
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / WC, wc = warp % WC;
  const int rt = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int nrt = gridDim.x, nch = gridDim.y;
  const int i0 = rt * R;
  const int t0 = chunk * chunk_tiles;
  const int nt = min(chunk_tiles, (S + N - 1) / N - t0);
  const bf16* f1b = f1 + (size_t)b * S * kC;

  stage_rows<R>(As, f0 + ((size_t)b * L + i0) * kC, min(R, L - i0));
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nt) {
      const int j0 = (t0 + s) * N;
      stage_rows<N>(ring + s * N * kLd, f1b + (size_t)j0 * kC,
                    min(N, S - j0));
    }
    mma::cp_async_commit();
  }

  // per row x = 2*mt + h: its index, mask bias, statistics, ground truth
  // and its partial sums of a by class
  int rows[4], rgt[4];
  float rbias[4], rmx[4], rinv[4], rpos[4], rneg[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    rows[x] = i0 + wr * 32 + (x >> 1) * 16 + g + 8 * (x & 1);
    const bool ok = rows[x] < L;
    const size_t o = (size_t)b * L + rows[x];
    rbias[x] = !ok ? -INFINITY : m0 != nullptr ? (m0[o] - 1.f) * kBig : 0.f;
    rmx[x] = ok ? rstat[o] : 0.f;
    rinv[x] = ok ? rstat[(size_t)B * L + o] : 0.f;
    rgt[x] = ok && gtv[o] > 0.f ? gtj[o] : -1;
    rpos[x] = 0.f;
    rneg[x] = 0.f;
  }
  float spos = 0.f, sneg = 0.f;
  // the focal values at conf <= 1e-6 (clamped; their slope is 0)
  const float vpos_lo = focal_value<G2>(0.f, true, alpha, gamma);
  const float vneg_lo = focal_value<G2>(0.f, false, alpha, gamma);

  const bf16* al = a_lane(As, wr, lane);
  const int bl = b_lane<NJ>(wc, lane);

  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait<NST - 2>();  // this thread's copies of tile t are in
    __syncthreads();                // everyone's; tile t-1 and red are free
    const int nx = t + NST - 1;
    if (nx < nt) {
      const int jn = (t0 + nx) * N;
      stage_rows<N>(ring + (nx % NST) * N * kLd, f1b + (size_t)jn * kC,
                    min(N, S - jn));
    }
    mma::cp_async_commit();

    float acc[2][NJ][4];
    product<NJ>(acc, al, ring + (t % NST) * N * kLd + bl);

    // conf once an element, in place: on a cell of weight 1 (w1) the bias
    // is 0 and sim is the product itself; any other cell adds nothing.
    // Exponentials by the SFU (__expf).  Almost every cell is clamped low
    // (conf <= 1e-6): its value is a constant and its slope 0.  The others
    // are flagged in `live` (bit 8 j + 4 e + x) for the loop below.
    const int j0 = (t0 + t) * N;
    const int cw = wc * 8 * NJ + 2 * q;  // + 8*j + e: column in the tile
    uint64_t live = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j0 + cw + 8 * j + e;
        const bool cok = c < S;
        const size_t o = (size_t)b * S + c;
        const float cbias =
            !cok ? -INFINITY : m1 != nullptr ? (m1[o] - 1.f) * kBig : 0.f;
        const float cmx = cok ? cstat[o] : 0.f;
        const float cinv = cok ? cstat[(size_t)B * S + o] : 0.f;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float& v = acc[x >> 1][j][2 * (x & 1) + e];
          const bool w1 = fminf(rbias[x], cbias) == 0.f;
          v = __expf(v - rmx[x]) * rinv[x] * (__expf(v - cmx) * cinv);
          if (w1 && v > kEps) {
            live |= 1ull << (8 * j + 4 * e + x);
          } else if (w1) {
            if (c == rgt[x])
              spos += vpos_lo;
            else
              sneg += vneg_lo;
          }
        }
      }

    // The live cells (a few in a warp's tile, if any): their logarithms in
    // one compact loop over the set bits, which the warp enters only when
    // one of its lanes has such a cell (written out for each of the 64
    // cells, this code outgrew the instruction cache and tripled the
    // pass's time).  Its arrays are indexed at run time, so they live in
    // local memory: the rare path pays for that, the common one does not.
    const bool any = __any_sync(0xffffffffu, live != 0);
    if (any) {
      float cf[8 * NJ];
      int rg[4];
      float rp[4], rn[4], cacc[2 * NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cacc[2 * j + e][0] = cacc[2 * j + e][1] = 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x)
            cf[8 * j + 4 * e + x] = acc[x >> 1][j][2 * (x & 1) + e];
        }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rg[x] = rgt[x];
        rp[x] = rn[x] = 0.f;
      }
      for (uint64_t m = live; m != 0; m &= m - 1) {
        const int k = __ffsll((long long)m) - 1;
        const int x = k & 3, je = k >> 2;  // je = 2 j + e
        const int c = j0 + cw + 8 * (je >> 1) + (je & 1);
        const float conf = cf[k];
        const bool is_pos = c == rg[x];
        const float v = focal_value<G2>(conf, is_pos, alpha, gamma);
        if (is_pos)
          spos += v;
        else
          sneg += v;
        if (GRAD && conf < 1.f - kEps) {
          const float a =
              focal_slope_in<G2>(conf, is_pos, alpha, gamma) * conf;
          if (is_pos) {
            rp[x] += a;
            cacc[je][0] += a;
          } else {
            rn[x] += a;
            cacc[je][1] += a;
          }
        }
      }
      if (GRAD) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          rpos[x] += rp[x];
          rneg[x] += rn[x];
        }
        // columns: the warp's 32 rows by shuffles across g, then
        // red[class][wr]
#pragma unroll
        for (int je = 0; je < 2 * NJ; ++je) {
          float cp = cacc[je][0], cn = cacc[je][1];
#pragma unroll
          for (int o2 = 4; o2 <= 16; o2 <<= 1) {
            cp += __shfl_xor_sync(0xffffffffu, cp, o2);
            cn += __shfl_xor_sync(0xffffffffu, cn, o2);
          }
          if (g == 0) {
            const int cl = cw + 8 * (je >> 1) + (je & 1);
            red[wr * N + cl] = cp;
            red[(WR + wr) * N + cl] = cn;
          }
        }
      }
    }
    if (GRAD) {
      // a warp without live cells wrote nothing to red this tile
      if (lane == 0) wlive[warp] = any;
      __syncthreads();
      if (threadIdx.x < N && j0 + (int)threadIdx.x < S) {
        const int cl = threadIdx.x, wcl = cl / (8 * NJ);
        float sp = 0.f, sn = 0.f;
#pragma unroll
        for (int w = 0; w < WR; ++w)
          if (wlive[w * WC + wcl]) {
            sp += red[w * N + cl];
            sn += red[(WR + w) * N + cl];
          }
        col_p[((size_t)b * nrt + rt) * S + j0 + cl] = sp;
        col_p[((size_t)(B + b) * nrt + rt) * S + j0 + cl] = sn;
      }
    }
  }

  // the block's sums: each warp's, then the 8 warps in ascending order; the
  // row partials: the quad, then the WC warps of the row through red
  spos = warp_sum(spos);
  sneg = warp_sum(sneg);
  if (GRAD) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        rpos[x] += __shfl_xor_sync(0xffffffffu, rpos[x], o2);
        rneg[x] += __shfl_xor_sync(0xffffffffu, rneg[x], o2);
      }
  }
  __syncthreads();  // the last column combine has read red
  if (lane == 0) {
    wsum[2 * warp] = spos;
    wsum[2 * warp + 1] = sneg;
  }
  if (GRAD && q == 0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = rows[x] - i0;
      red[(r * WC + wc) * 2] = rpos[x];
      red[(r * WC + wc) * 2 + 1] = rneg[x];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += wsum[2 * w + threadIdx.x];
    part[(((size_t)b * nrt + rt) * nch + chunk) * 2 + threadIdx.x] = s;
  }
  if (GRAD && threadIdx.x < R && i0 + (int)threadIdx.x < L) {
    const int r = threadIdx.x;
    float sp = 0.f, sn = 0.f;
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      sp += red[(r * WC + w) * 2];
      sn += red[(r * WC + w) * 2 + 1];
    }
    row_p[((size_t)b * nch + chunk) * L + i0 + r] = sp;
    row_p[((size_t)(B + b) * nch + chunk) * L + i0 + r] = sn;
  }
}

// The loss pass's partials -> pos, neg [B] (part over its nrt * nch
// blocks), and with row_p: srow2 [2, B, L] (row_p over its nch chunks),
// scol2 [2, B, S] (col_p over its nrt row tiles); every sum in ascending
// partial order.  One thread an output.
__global__ void loss_combine(const float* __restrict__ part,
                             const float* __restrict__ row_p,
                             const float* __restrict__ col_p, int nrt,
                             int nch, int B, int L, int S,
                             float* __restrict__ pos, float* __restrict__ neg,
                             float* __restrict__ srow2,
                             float* __restrict__ scol2) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * B) {
    const int b = i >> 1, n = nrt * nch;
    float s = 0.f;
    for (int t = 0; t < n; ++t) s += part[((size_t)b * n + t) * 2 + (i & 1)];
    ((i & 1) ? neg : pos)[b] = s;
    return;
  }
  if (row_p == nullptr) return;
  i -= 2 * B;
  if (i < 2 * B * L) {  // i = (class * B + b) * L + k
    const int cb = i / L, k = i % L;
    float s = 0.f;
    for (int t = 0; t < nch; ++t) s += row_p[((size_t)cb * nch + t) * L + k];
    srow2[i] = s;
    return;
  }
  i -= 2 * B * L;
  if (i < 2 * B * S) {
    const int cb = i / S, k = i % S;
    float s = 0.f;
    for (int t = 0; t < nrt; ++t) s += col_p[((size_t)cb * nrt + t) * S + k];
    scol2[i] = s;
  }
}

// A gradient grid: R = 128 resident rows of side a (8 warps x 16 rows),
// streamed tiles of N = 8 NJ rows of side b, NOUT of the 256 output columns
// a block, NST ring stages.  cinfo: per streamed row of the current and the
// next tile, (max, 1/sum, mask bias, gpos Spos + gneg Sneg) and its ground
// truth; rinfo the same of the resident rows (kept in shared memory, not in
// registers beside the 4 NOUT / 8 accumulators a thread).
template <int NJ, int NOUT, int NST>
struct GradCfg {
  static constexpr int kR = 128;
  static constexpr int kN = 8 * NJ;
  static constexpr int kSplit = kC / NOUT;
  static constexpr size_t kSmem =
      (size_t)(kR + NST * kN) * kLd * sizeof(bf16) +
      (2 * kN + kR) * (sizeof(float4) + sizeof(int));
  static_assert(NJ % 2 == 0 && NOUT % 16 == 0 && kC % NOUT == 0,
                "n8 tiles come in pairs");
};

// hi = bf16(x), lo = bf16(x - hi) of two adjacent accumulators, packed as
// one register each of an A fragment (x - hi is exact in float).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const float h0 = mma::round_bf16(x0), h1 = mma::round_bf16(x1);
  hi = mma::pack_bf16(h0, h1);
  lo = mma::pack_bf16(x0 - h0, x1 - h1);
}

// out[a] = grad_scale * sum over b of dsim[a, b] fb[b] for the block's 128
// rows of side a, its chunk of side b's tiles and its NOUT output columns;
// dsim = 2A - ra sa - rb sb with ra = exp(sim - amax) / asum, rb alike,
// A = focal'(conf) w conf g, and sa = gpos sa2[0] + gneg sa2[1] (sb alike).
// astat, bstat: [2, B, La] / [2, B, Lb] (max; 1/sum).  GT_ON_A: the ground
// truth (gtj, gtv) is indexed by side a (a = image 0: dfeat0); else by side
// b (a = image 1: dfeat1).  part null: the block writes out (bf16) itself;
// else float partials part [B, nch, La, 256] for grad_combine.  Grid (a
// tiles, chunks, B * 256/NOUT).  Thread (warp, lane) holds rows 16 warp + g
// + 8 h of side a: of the sim tile, columns 8 j + 2 q + e as s[j][2 h + e];
// of the output, columns col0 + 8 j + 2 q + e as acc[j][2 h + e].
template <int NJ, int NOUT, int NST, bool GT_ON_A, bool G2>
__global__ void __launch_bounds__(kThreads, 1)
    focal_grad_bf16(const bf16* __restrict__ fa, const bf16* __restrict__ fb,
                    const float* __restrict__ ma,
                    const float* __restrict__ mb,
                    const float* __restrict__ astat,
                    const float* __restrict__ bstat,
                    const float* __restrict__ sa2,
                    const float* __restrict__ sb2,
                    const int* __restrict__ gtj,
                    const float* __restrict__ gtv,
                    const float* __restrict__ gpos,
                    const float* __restrict__ gneg, float* __restrict__ part,
                    bf16* __restrict__ out, int B, int La, int Lb,
                    int chunk_tiles, float grad_scale, float alpha,
                    float gamma) {
  using K = GradCfg<NJ, NOUT, NST>;
  constexpr int R = K::kR, N = K::kN, NO = NOUT / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = (bf16*)smem_raw;                    // [R][kLd] side a rows
  bf16* ring = As + R * kLd;                     // NST x [N][kLd] side b rows
  float4* cinfo = (float4*)(ring + NST * N * kLd);  // [2][N]
  float4* rinfo = cinfo + 2 * N;                    // [R]
  int* cgt = (int*)(rinfo + R);                     // [2][N]
  int* rgt = cgt + 2 * N;                           // [R]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int rt = blockIdx.x, chunk = blockIdx.y;
  const int b = blockIdx.z / K::kSplit;
  const int col0 = (blockIdx.z % K::kSplit) * NOUT;
  const int nch = gridDim.y;
  const int i0 = rt * R;
  const int t0 = chunk * chunk_tiles;
  const int nt = min(chunk_tiles, (Lb + N - 1) / N - t0);
  const bf16* fbb = fb + (size_t)b * Lb * kC;
  const float gp = gpos[b], gn = gneg[b];

  stage_rows<R>(As, fa + ((size_t)b * La + i0) * kC, min(R, La - i0));
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nt) {
      const int j0 = (t0 + s) * N;
      stage_rows<N>(ring + s * N * kLd, fbb + (size_t)j0 * kC,
                    min(N, Lb - j0));
    }
    mma::cp_async_commit();
  }
  // what the epilogue needs of a row: (max, 1/sum, mask bias, gpos Spos +
  // gneg Sneg) and its ground truth, or -1
  const auto info = [&](const float* __restrict__ stat,
                        const float* __restrict__ m,
                        const float* __restrict__ s2, int len, int k,
                        bool gt, float4& v, int& gtk) {
    const bool ok = k < len;
    const size_t o = (size_t)b * len + k;
    v.x = ok ? stat[o] : 0.f;
    v.y = ok ? stat[(size_t)B * len + o] : 0.f;
    v.z = !ok ? -INFINITY : m != nullptr ? (m[o] - 1.f) * kBig : 0.f;
    v.w = ok ? gp * s2[o] + gn * s2[(size_t)B * len + o] : 0.f;
    gtk = gt && ok && gtv[o] > 0.f ? gtj[o] : -1;
  };
  // the streamed rows of tile t into slot t % 2
  const auto col_info = [&](int t) {
    if (threadIdx.x < N) {
      const int k = (t & 1) * N + threadIdx.x;
      info(bstat, mb, sb2, Lb, (t0 + t) * N + threadIdx.x, !GT_ON_A,
           cinfo[k], cgt[k]);
    }
  };
  if (threadIdx.x < R)
    info(astat, ma, sa2, La, i0 + threadIdx.x, GT_ON_A, rinfo[threadIdx.x],
         rgt[threadIdx.x]);
  col_info(0);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // ldmatrix lanes: A rows 16 warp + lane%16, k halves lane/16; the sim
  // product's B (streamed rows = n) as in ring::product; the gradient
  // product's B (streamed rows = k, feature columns = n) transposed: the
  // four 8x8 matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of two n8 tiles
  const bf16* al = As + (16 * warp + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int bl = b_lane<NJ>(0, lane);
  const int tl = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + col0 +
                 (lane >> 4) * 8;

  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait<NST - 2>();  // this thread's copies of tile t are in
    __syncthreads();  // everyone's, and slot t%2 of cinfo; tile t-1 is free
    const int nx = t + NST - 1;
    if (nx < nt) {
      const int jn = (t0 + nx) * N;
      stage_rows<N>(ring + (nx % NST) * N * kLd, fbb + (size_t)jn * kC,
                    min(N, Lb - jn));
    }
    mma::cp_async_commit();
    if (t + 1 < nt) col_info(t + 1);  // slot (t+1)%2 was last read at t-1
    const bf16* stg = ring + (t % NST) * N * kLd;

    // sim of the warp's 16 rows x the tile's N streamed rows (unrolled by
    // 4 k16 steps: deeper unrolling hoists fragments past the register
    // budget)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kC; k += 16) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, al + k);
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        uint32_t bq[4];
        mma::ldmatrix_x4(bq, stg + bl + p * 16 * kLd + k);
        mma::mma_bf16(s[2 * p], a, bq[0], bq[1]);
        mma::mma_bf16(s[2 * p + 1], a, bq[2], bq[3]);
      }
    }

    // dsim in place.  A cell past La or Lb has a -inf bias: ra = rb = 0,
    // and its S terms are 0, so its dsim is 0; a masked cell has A = 0, and
    // so has every cell clamped low (conf <= 1e-6: almost all).  The slope's
    // logarithms run in a branch the whole warp takes or skips.
    const float4* ci = cinfo + (t & 1) * N;
    const int* cg = cgt + (t & 1) * N;
    const int j0 = (t0 + t) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      const float4 rv = rinfo[r];
      const int rg = rgt[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * j + 2 * q + e;
          const float4 cv = ci[cl];
          float& v = s[j][2 * h + e];
          const float bias = fminf(rv.z, cv.z);
          const float sim = v + bias;
          const float ra = __expf(sim - rv.x) * rv.y;
          const float rb = __expf(sim - cv.x) * cv.y;
          const float conf = ra * rb;
          const bool live = bias == 0.f && conf > kEps && conf < 1.f - kEps;
          float A2 = 0.f;
          if (__any_sync(0xffffffffu, live)) {
            if (live) {
              const bool is_pos =
                  GT_ON_A ? j0 + cl == rg : i0 + r == cg[cl];
              A2 = 2.f * focal_slope_in<G2>(conf, is_pos, alpha, gamma) *
                   conf * (is_pos ? gp : gn);
            }
          }
          v = A2 - ra * rv.w - rb * cv.w;
        }
    }

    // acc += dsim @ fb[tile]: s[2 kk], s[2 kk + 1] are the A fragment of
    // k16 step kk, as hi and lo halves
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t hi[4], lo[4];
      split2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        uint32_t bq[4];
        mma::ldmatrix_x4_trans(bq, stg + tl + kk * 16 * kLd + p * 16);
        mma::mma_bf16(acc[2 * p], hi, bq[0], bq[1]);
        mma::mma_bf16(acc[2 * p], lo, bq[0], bq[1]);
        mma::mma_bf16(acc[2 * p + 1], hi, bq[2], bq[3]);
        mma::mma_bf16(acc[2 * p + 1], lo, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + 16 * warp + g + 8 * h;
    if (row >= La) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = col0 + 8 * j + 2 * q;
      if (part != nullptr) {
        *reinterpret_cast<float2*>(
            part + (((size_t)b * nch + chunk) * La + row) * kC + c) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        mma::st_pair(out + ((size_t)b * La + row) * kC + c,
                     acc[j][2 * h] * grad_scale,
                     acc[j][2 * h + 1] * grad_scale);
      }
    }
  }
}

// o_s = bf16(scale * sum over t < n_s of p_s[b, t, :, :]) in ascending t,
// for the sides s whose partials are not null; 4 floats a thread.
__global__ void grad_combine(const float* __restrict__ p0,
                             const float* __restrict__ p1, int n0, int n1,
                             int B, int L0, int L1, float scale,
                             bf16* __restrict__ o0, bf16* __restrict__ o1) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long q0 = p0 != nullptr ? (long long)B * L0 * (kC / 4) : 0;
  const long long q1 = p1 != nullptr ? (long long)B * L1 * (kC / 4) : 0;
  const float* p = p0;
  bf16* o = o0;
  int n = n0;
  long long per = (long long)L0 * (kC / 4);  // float4s of one pair
  if (i >= q0) {
    i -= q0;
    if (i >= q1) return;
    p = p1;
    o = o1;
    n = n1;
    per = (long long)L1 * (kC / 4);
  }
  const long long bi = i / per, k = i % per;
  const float4* src = reinterpret_cast<const float4*>(p) + bi * n * per + k;
  float4 s = src[0];
  for (int t = 1; t < n; ++t) {
    const float4 v = src[(long long)t * per];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  bf16* d = o + i * 4;
  mma::st_pair(d, s.x * scale, s.y * scale);
  mma::st_pair(d + 2, s.z * scale, s.w * scale);
}

template <int WR, int NJ, int NST, bool GRAD, bool G2>
void loss_pass(dim3 grid, cudaStream_t st, const bf16* f0, const bf16* f1,
               const float* m0, const float* m1, const float* rstat,
               const float* cstat, const int* gtj, const float* gtv,
               float* part, float* row_p, float* col_p, int B, int L, int S,
               int chunk_tiles, float alpha, float gamma) {
  using K = LossCfg<WR, NJ, NST>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      focal_loss_bf16<WR, NJ, NST, GRAD, G2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
  (void)attr;
  focal_loss_bf16<WR, NJ, NST, GRAD, G2><<<grid, kThreads, K::kSmem, st>>>(
      f0, f1, m0, m1, rstat, cstat, gtj, gtv, part, row_p, col_p, B, L, S,
      chunk_tiles, alpha, gamma);
}

// The loss pass and its combine: 2 launches.  Scratch (float): part [B,
// nrt, nch, 2]; with grad, row_p [2, B, nch, L] and col_p [2, B, nrt, S],
// and the outputs srow2 [2, B, L], scol2 [2, B, S].
template <int WR, int NJ, int NST>
int launch_loss(const bf16* f0, const bf16* f1, const float* m0,
                const float* m1, const float* rstat, const float* cstat,
                const int* gtj, const float* gtv, float* part, float* row_p,
                float* col_p, float* pos, float* neg, float* srow2,
                float* scol2, int B, int L, int S, int chunk_tiles,
                float alpha, float gamma, bool grad, cudaStream_t st) {
  using K = LossCfg<WR, NJ, NST>;
  if (chunk_tiles < 1) return (int)cudaErrorInvalidValue;
  const int nrt = (L + K::kR - 1) / K::kR;
  const int nch = ((S + K::kN - 1) / K::kN + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid(nrt, nch, B);
  const bool g2 = gamma == 2.f;
#define LOSS_PASS(GR, G)                                                    \
  loss_pass<WR, NJ, NST, GR, G>(grid, st, f0, f1, m0, m1, rstat, cstat, gtj, \
                                gtv, part, row_p, col_p, B, L, S,            \
                                chunk_tiles, alpha, gamma)
  if (grad && g2)
    LOSS_PASS(true, true);
  else if (grad)
    LOSS_PASS(true, false);
  else if (g2)
    LOSS_PASS(false, true);
  else
    LOSS_PASS(false, false);
#undef LOSS_PASS
  const int n = 2 * B + (grad ? 2 * B * (L + S) : 0);
  loss_combine<<<(n + 255) / 256, 256, 0, st>>>(
      part, grad ? row_p : nullptr, col_p, nrt, nch, B, L, S, pos, neg, srow2,
      scol2);
  return (int)cudaGetLastError();
}

template <int NJ, int NOUT, int NST, bool GT_ON_A, bool G2>
void grad_pass(dim3 grid, cudaStream_t st, const bf16* fa, const bf16* fb,
               const float* ma, const float* mb, const float* astat,
               const float* bstat, const float* sa2, const float* sb2,
               const int* gtj, const float* gtv, const float* gpos,
               const float* gneg, float* part, bf16* out, int B, int La,
               int Lb, int chunk_tiles, float grad_scale, float alpha,
               float gamma) {
  using K = GradCfg<NJ, NOUT, NST>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      focal_grad_bf16<NJ, NOUT, NST, GT_ON_A, G2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
  (void)attr;
  focal_grad_bf16<NJ, NOUT, NST, GT_ON_A, G2>
      <<<grid, kThreads, K::kSmem, st>>>(fa, fb, ma, mb, astat, bstat, sa2,
                                         sb2, gtj, gtv, gpos, gneg, part,
                                         out, B, La, Lb, chunk_tiles,
                                         grad_scale, alpha, gamma);
}

// Both gradient grids and, where a side is cut into chunks, their combine:
// 2 or 3 launches.  ct0 / ct1: streamed tiles a block of the dfeat0 grid
// (side a = f0, b = f1) and the dfeat1 grid (a = f1, b = f0); part0 /
// part1 [B, nch, La, 256] float, null where nch is 1.
template <int NJ, int NOUT, int NST>
int launch_grad(const bf16* f0, const bf16* f1, const float* m0,
                const float* m1, const float* rstat, const float* cstat,
                const float* srow2, const float* scol2, const int* gtj,
                const float* gtv, const float* gpos, const float* gneg,
                float* part0, float* part1, bf16* df0, bf16* df1, int B,
                int L, int S, int ct0, int ct1, float grad_scale, float alpha,
                float gamma, cudaStream_t st) {
  using K = GradCfg<NJ, NOUT, NST>;
  if (ct0 < 1 || ct1 < 1) return (int)cudaErrorInvalidValue;
  const int nch0 = ((S + K::kN - 1) / K::kN + ct0 - 1) / ct0;
  const int nch1 = ((L + K::kN - 1) / K::kN + ct1 - 1) / ct1;
  if ((nch0 > 1) != (part0 != nullptr) || (nch1 > 1) != (part1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid0((L + K::kR - 1) / K::kR, nch0, B * K::kSplit);
  const dim3 grid1((S + K::kR - 1) / K::kR, nch1, B * K::kSplit);
  const bool g2 = gamma == 2.f;
#define GRAD_PASSES(G)                                                       \
  grad_pass<NJ, NOUT, NST, true, G>(grid0, st, f0, f1, m0, m1, rstat, cstat,  \
                                    srow2, scol2, gtj, gtv, gpos, gneg,      \
                                    part0, df0, B, L, S, ct0, grad_scale,    \
                                    alpha, gamma);                           \
  grad_pass<NJ, NOUT, NST, false, G>(grid1, st, f1, f0, m1, m0, cstat, rstat, \
                                     scol2, srow2, gtj, gtv, gpos, gneg,     \
                                     part1, df1, B, S, L, ct1, grad_scale,   \
                                     alpha, gamma)
  if (g2) {
    GRAD_PASSES(true);
  } else {
    GRAD_PASSES(false);
  }
#undef GRAD_PASSES
  if (part0 != nullptr || part1 != nullptr) {
    const long long n = (long long)B *
                        ((part0 ? L : 0) + (part1 ? S : 0)) * (kC / 4);
    grad_combine<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        part0, part1, nch0, nch1, B, L, S, grad_scale, df0, df1);
  }
  return (int)cudaGetLastError();
}

}  // namespace bf
}  // namespace
}  // namespace loftr

// Tile path, forward pass 2.  f0 [B, L, C], f1 [B, S, C] (T); m0 [B, L],
// m1 [B, S] float 0/1; rmax, rsum [B, L], cmax, csum [B, S] from
// loftr_dual_softmax_stats with the same chunk_tiles and scale (the sim
// scale); gtj [B, L] int32, gtv [B, L] float 0/1.  Scratch: part [B, nrt *
// nch, 2] float.  Outputs: pos, neg [B] float.
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

// Tile path, backward.  Inputs as the forward's, plus gpos, gneg [B] float
// (the cotangents of pos and neg, on the device); scale: the sim scale,
// grad_scale: the gradients' (dfeat = grad_scale * dsim @ f).  Scratch:
// row_p [B, nch, L], col_p [B, nrt, S] float.  Outputs: srow [B, L], scol
// [B, S] float; df0 [B, L, C], df1 [B, S, C] (T).  C <= 256.
extern "C" int loftr_focal_bwd(const void* f0, const void* f1, const void* m0,
                               const void* m1, const void* rmax,
                               const void* rsum, const void* cmax,
                               const void* csum, const void* gtj,
                               const void* gtv, const void* gpos,
                               const void* gneg, void* row_p, void* col_p,
                               void* srow, void* scol, void* df0, void* df1,
                               int B, int L, int S, int C, int chunk_tiles,
                               float scale, float grad_scale, float alpha,
                               float gamma, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch_bwd<__nv_bfloat16>(
        f0, f1, m0, m1, rmax, rsum, cmax, csum, gtj, gtv, gpos, gneg, row_p,
        col_p, srow, scol, df0, df1, B, L, S, C, chunk_tiles, scale,
        grad_scale, alpha, gamma, st);
  return loftr::launch_bwd<float>(f0, f1, m0, m1, rmax, rsum, cmax, csum, gtj,
                                  gtv, gpos, gneg, row_p, col_p, srow, scol,
                                  df0, df1, B, L, S, C, chunk_tiles, scale,
                                  grad_scale, alpha, gamma, st);
}

// bf16 copies f~ = bf16(f * sb) of f0 [n0] and f1 [n1] (bf16) into o0, o1;
// sb = bf16(1/sqrt(C*T)) as a float.
extern "C" int loftr_focal_prescale(const void* f0, const void* f1, void* o0,
                                    void* o1, long long n0, long long n1,
                                    float sb, void* stream) {
  const long long n = n0 + n1;
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  if (blocks > 0)
    loftr::focal_prescale<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)f0, (const __nv_bfloat16*)f1,
        (__nv_bfloat16*)o0, (__nv_bfloat16*)o1, n0, n1, sb);
  return (int)cudaGetLastError();
}

// bf16 path, C = 256: the loss pass on the copies f~0 [B, L, 256], f~1 [B,
// S, 256] (16-byte aligned) with rstat [2, B, L], cstat [2, B, S] from
// loftr_dual_softmax_bf16_stats (sim scale 1); m0 [B, L], m1 [B, S] float
// 0/1 or both null; gtj [B, L] int32, gtv [B, L] float 0/1.  The tile is
// 128 x 128; chunk_tiles from loss_plan.  Scratch (float): part
// [B, nrt, nch, 2]; with grad, row_p [2, B, nch, L], col_p [2, B, nrt, S].
// Outputs: pos, neg [B]; with grad, srow2 [2, B, L] and scol2 [2, B, S]
// (the sums of a = focal'(conf) w conf over positive cells, then the
// others).
extern "C" int loftr_focal_bf16_fwd(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* rstat, const void* cstat, const void* gtj, const void* gtv,
    void* part, void* row_p, void* col_p, void* pos, void* neg, void* srow2,
    void* scol2, int B, int L, int S, int chunk_tiles, float alpha,
    float gamma, int grad, void* stream) {
  using loftr::ring::bf16;
  if (((uintptr_t)f0 | (uintptr_t)f1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return loftr::bf::launch_loss<4, 8, 2>(
      (const bf16*)f0, (const bf16*)f1, (const float*)m0, (const float*)m1,
      (const float*)rstat, (const float*)cstat, (const int*)gtj,
      (const float*)gtv, (float*)part, (float*)row_p, (float*)col_p,
      (float*)pos, (float*)neg, (float*)srow2, (float*)scol2, B, L, S,
      chunk_tiles, alpha, gamma, grad != 0, (cudaStream_t)stream);
}

// bf16 path, C = 256: both gradient grids.  Inputs as the loss pass's, plus
// srow2, scol2 from it and gpos, gneg [B] float (the cotangents of pos and
// neg, on the device).  A block holds 128 rows of one side and all 256
// output columns and streams 32 rows of the other side a tile; ct0, ct1:
// streamed tiles a block of the dfeat0 and the dfeat1 grid (grad_plan in
// ops/kernels/focal_loss.py).
// Scratch: part0 [B, nch0, L, 256], part1 [B, nch1, S, 256] float, null
// where that grid has one chunk.  Outputs: df0 [B, L, 256], df1 [B, S, 256]
// bf16, grad_scale * dsim @ f~.
extern "C" int loftr_focal_bf16_bwd(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* rstat, const void* cstat, const void* srow2,
    const void* scol2, const void* gtj, const void* gtv, const void* gpos,
    const void* gneg, void* part0, void* part1, void* df0, void* df1, int B,
    int L, int S, int ct0, int ct1, float grad_scale, float alpha,
    float gamma, void* stream) {
  using loftr::ring::bf16;
  if (((uintptr_t)f0 | (uintptr_t)f1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return loftr::bf::launch_grad<4, 256, 2>(
      (const bf16*)f0, (const bf16*)f1, (const float*)m0, (const float*)m1,
      (const float*)rstat, (const float*)cstat, (const float*)srow2,
      (const float*)scol2, (const int*)gtj, (const float*)gtv,
      (const float*)gpos, (const float*)gneg, (float*)part0, (float*)part1,
      (bf16*)df0, (bf16*)df1, B, L, S, ct0, ct1, grad_scale, alpha, gamma,
      (cudaStream_t)stream);
}
