// Dual-softmax + mutual-nearest statistics without the [L, S] matrix.
//
// Replaces loftr_tpu/ops/pallas/dual_softmax.py::_fused_dual_softmax_core
// (_stats_kernel and _best_kernel).
//
// sim = (f0 . f1^T) * scale + (m0 m1 - 1) * 1e9, scale = 1/(C*T), as an
// float dot of the raw features scaled afterwards.
//   pass 1: row max / sumexp and per-row-tile column max / sumexp;
//   pass 2: conf = softmax_row * softmax_col on the fly -> per-row best value
//           and lowest argmax, per-row-tile column max of conf.
// Each pass recomputes the sim tiles; [L, S] never reaches device memory.
//
// What bounds it on the H100: operations (2 x 2*L*S*C flop plus about
// 4*L*S exponentials against (L+S)*C input values), so the products and the
// exps.  Blocks compute 64x64 sim tiles from shared-memory k-slabs: on the
// tensor cores (WMMA, float accumulation) in bf16, on the CUDA cores in
// float (the exactness check).
//
// The TPU kernels carry column statistics across a sequential grid.  Here a
// block owns a 64-row tile and a chunk of columns; it writes row partials
// per column chunk and column partials per row tile, and small combine
// kernels reduce them in a fixed order (log-sum-exp rescale for the
// softmax statistics, max with the lowest index on ties for the row best).
// No float atomics, so results are deterministic.

#include "sim_tile.cuh"

namespace loftr {
namespace {

constexpr float kBig = 1e9f;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                const float* __restrict__ m0, const float* __restrict__ m1,
                const float* __restrict__ rmax, const float* __restrict__ rsum,
                const float* __restrict__ cmax, const float* __restrict__ csum,
                float* __restrict__ row_pa, float* __restrict__ row_pb,
                float* __restrict__ col_pa, float* __restrict__ col_pb, int L,
                int S, int C, int chunk_tiles, float scale) {
  __shared__ __align__(128) unsigned char tile_smem[kTileBytes];
  __shared__ float red_a[16][kTN];
  __shared__ float red_b[16][kTN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rt = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int nrt = gridDim.x, nch = gridDim.y;
  const int i0 = rt * kTM;
  const T* f0b = f0 + (size_t)b * L * C;
  const T* f1b = f1 + (size_t)b * S * C;

  int rows[4];
  float rm0[4], r_a[4], r_b[4];  // MODE 0: running max/sum; 1: best val/idx
  int r_j[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rows[a] = i0 + ty + 16 * a;
    const bool ok = rows[a] < L;
    rm0[a] = ok ? m0[(size_t)b * L + rows[a]] : 0.f;
    r_a[a] = MODE == 0 ? -INFINITY : -1.f;
    r_b[a] = 0.f;
    r_j[a] = 0;
  }
  float rmx[4], rsm[4];
  if (MODE == 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const bool ok = rows[a] < L;
      rmx[a] = ok ? rmax[(size_t)b * L + rows[a]] : 0.f;
      rsm[a] = ok ? rsum[(size_t)b * L + rows[a]] : 1.f;
    }
  }

  const int ct0 = chunk * chunk_tiles;
  for (int ct = ct0; ct < ct0 + chunk_tiles; ++ct) {
    const int j0 = ct * kTN;
    if (j0 >= S) break;
    float acc[4][4];
    sim_tile<T>(f0b, f1b, L, S, C, i0, j0, tile_smem, acc);
    // sim (and conf) for this thread's 4x4 entries; out-of-range -> skipped
    int cols[4];
    float cm1[4], cmx[4], csm[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cols[c] = j0 + tx + 16 * c;
      const bool ok = cols[c] < S;
      cm1[c] = ok ? m1[(size_t)b * S + cols[c]] : 0.f;
      if (MODE == 1) {
        cmx[c] = ok ? cmax[(size_t)b * S + cols[c]] : 0.f;
        csm[c] = ok ? csum[(size_t)b * S + cols[c]] : 1.f;
      }
    }
    float v[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sim = acc[a][c] * scale + (rm0[a] * cm1[c] - 1.f) * kBig;
        if (MODE == 1)
          sim = expf(sim - rmx[a]) / rsm[a] * (expf(sim - cmx[c]) / csm[c]);
        v[a][c] = sim;
      }

    if (MODE == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cols[c] < S) tmax = fmaxf(tmax, v[a][c]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        float ts = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cols[c] < S) ts += expf(v[a][c] - tmax);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          ts += __shfl_xor_sync(0xffffffffu, ts, o);
        const float nm = fmaxf(r_a[a], tmax);
        r_b[a] = r_b[a] * expf(r_a[a] - nm) + ts * expf(tmax - nm);
        r_a[a] = nm;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float cmaxl = -INFINITY;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (rows[a] < L) cmaxl = fmaxf(cmaxl, v[a][c]);
        float csl = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (rows[a] < L) csl += expf(v[a][c] - cmaxl);
        red_a[ty][tx + 16 * c] = cmaxl;
        red_b[ty][tx + 16 * c] = csl;
      }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float bv = -1.f;
        int bj = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cols[c] < S && v[a][c] > bv) {
            bv = v[a][c];
            bj = cols[c];
          }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
          if (ov > bv || (ov == bv && oj < bj)) {
            bv = ov;
            bj = oj;
          }
        }
        if (bv > r_a[a]) {  // later tiles have larger indices: ties keep old
          r_a[a] = bv;
          r_j[a] = bj;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float cmaxl = -1.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (rows[a] < L) cmaxl = fmaxf(cmaxl, v[a][c]);
        red_a[ty][tx + 16 * c] = cmaxl;
      }
    }
    __syncthreads();
    if (tid < kTN && j0 + tid < S) {
      const size_t o = ((size_t)b * nrt + rt) * S + j0 + tid;
      if (MODE == 0) {
        float m = -INFINITY;
        for (int t = 0; t < 16; ++t) m = fmaxf(m, red_a[t][tid]);
        float s = 0.f;
        for (int t = 0; t < 16; ++t)
          if (red_b[t][tid] > 0.f) s += red_b[t][tid] * expf(red_a[t][tid] - m);
        col_pa[o] = m;
        col_pb[o] = s;
      } else {
        float m = -1.f;
        for (int t = 0; t < 16; ++t) m = fmaxf(m, red_a[t][tid]);
        col_pa[o] = m;
      }
    }
    __syncthreads();
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (rows[a] >= L) continue;
      const size_t o = ((size_t)b * nch + chunk) * L + rows[a];
      row_pa[o] = r_a[a];
      if (MODE == 0)
        row_pb[o] = r_b[a];
      else
        ((int*)row_pb)[o] = r_j[a];
    }
  }
}

// Log-sum-exp combine of n partial (max, sumexp) pairs per position.
__global__ void lse_combine_kernel(const float* __restrict__ pm,
                                   const float* __restrict__ ps, int n,
                                   int len, int B, float* __restrict__ om,
                                   float* __restrict__ os) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * len) return;
  const int b = idx / len, i = idx % len;
  const float* a = pm + (size_t)b * n * len + i;
  const float* s = ps + (size_t)b * n * len + i;
  float m = -INFINITY;
  for (int t = 0; t < n; ++t) m = fmaxf(m, a[(size_t)t * len]);
  float sum = 0.f;
  for (int t = 0; t < n; ++t) {
    const float st = s[(size_t)t * len];
    if (st > 0.f) sum += st * expf(a[(size_t)t * len] - m);
  }
  om[idx] = m;
  os[idx] = sum;
}

// Row best over column chunks in ascending order: ties keep the lowest index.
__global__ void best_combine_kernel(const float* __restrict__ pv,
                                    const int* __restrict__ pj, int n, int L,
                                    int B, float* __restrict__ ov,
                                    int* __restrict__ oj) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L) return;
  const int b = idx / L, i = idx % L;
  float best = -1.f;
  int bj = 0;
  for (int t = 0; t < n; ++t) {
    const size_t o = ((size_t)b * n + t) * L + i;
    if (pv[o] > best) {
      best = pv[o];
      bj = pj[o];
    }
  }
  ov[idx] = best;
  oj[idx] = bj;
}

__global__ void max_combine_kernel(const float* __restrict__ p, int n, int len,
                                   int B, float* __restrict__ o) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * len) return;
  const int b = idx / len, i = idx % len;
  float m = -1.f;
  for (int t = 0; t < n; ++t) m = fmaxf(m, p[((size_t)b * n + t) * len + i]);
  o[idx] = m;
}

// Pass 1 alone: row and column softmax statistics of sim.
template <typename T>
int launch_stats(const void* f0, const void* f1, const void* m0,
                 const void* m1, void* row_pa, void* row_pb, void* col_pa,
                 void* col_pb, void* rmax, void* rsum, void* cmax, void* csum,
                 int B, int L, int S, int C, int chunk_tiles, float scale,
                 cudaStream_t st) {
  const int nrt = (L + kTM - 1) / kTM;
  const int nct = (S + kTN - 1) / kTN;
  const int nch = (nct + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid(nrt, nch, B);
  const float *F = nullptr;
  tile_kernel<T, 0><<<grid, kThreads, 0, st>>>(
      (const T*)f0, (const T*)f1, (const float*)m0, (const float*)m1, F, F, F,
      F, (float*)row_pa, (float*)row_pb, (float*)col_pa, (float*)col_pb, L, S,
      C, chunk_tiles, scale);
  lse_combine_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(
      (const float*)row_pa, (const float*)row_pb, nch, L, B, (float*)rmax,
      (float*)rsum);
  lse_combine_kernel<<<(B * S + 255) / 256, 256, 0, st>>>(
      (const float*)col_pa, (const float*)col_pb, nrt, S, B, (float*)cmax,
      (float*)csum);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f0, const void* f1, const void* m0, const void* m1,
           void* row_pa, void* row_pb, void* col_pa, void* col_pb, void* rmax,
           void* rsum, void* cmax, void* csum, void* best_val, void* best_j,
           void* colconf, int B, int L, int S, int C, int chunk_tiles,
           float scale, cudaStream_t st) {
  const int nrt = (L + kTM - 1) / kTM;
  const int nct = (S + kTN - 1) / kTN;
  const int nch = (nct + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid(nrt, nch, B);
  const int err = launch_stats<T>(f0, f1, m0, m1, row_pa, row_pb, col_pa,
                                  col_pb, rmax, rsum, cmax, csum, B, L, S, C,
                                  chunk_tiles, scale, st);
  if (err != 0) return err;
  tile_kernel<T, 1><<<grid, kThreads, 0, st>>>(
      (const T*)f0, (const T*)f1, (const float*)m0, (const float*)m1,
      (const float*)rmax, (const float*)rsum, (const float*)cmax,
      (const float*)csum, (float*)row_pa, (float*)row_pb, (float*)col_pa,
      (float*)col_pb, L, S, C, chunk_tiles, scale);
  best_combine_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(
      (const float*)row_pa, (const int*)row_pb, nch, L, B, (float*)best_val,
      (int*)best_j);
  max_combine_kernel<<<(B * S + 255) / 256, 256, 0, st>>>(
      (const float*)col_pa, nrt, S, B, (float*)colconf);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace loftr

// f0 [B, L, C], f1 [B, S, C] (T); m0 [B, L], m1 [B, S] float 0/1.
// Scratch: row_pa, row_pb [B, nch, L] (4-byte), col_pa, col_pb [B, nrt, S]
// float, with nrt = ceil(L/64), nch = ceil(ceil(S/64) / chunk_tiles).
// Outputs (float unless noted): rmax, rsum [B, L]; cmax, csum [B, S];
// best_val [B, L], best_j [B, L] int32, colconf [B, S].
extern "C" int loftr_dual_softmax(const void* f0, const void* f1,
                                  const void* m0, const void* m1,
                                  void* row_pa, void* row_pb, void* col_pa,
                                  void* col_pb, void* rmax, void* rsum,
                                  void* cmax, void* csum, void* best_val,
                                  void* best_j, void* colconf, int B, int L,
                                  int S, int C, int chunk_tiles, float scale,
                                  int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch<__nv_bfloat16>(f0, f1, m0, m1, row_pa, row_pb, col_pa,
                                        col_pb, rmax, rsum, cmax, csum,
                                        best_val, best_j, colconf, B, L, S, C,
                                        chunk_tiles, scale, st);
  return loftr::launch<float>(f0, f1, m0, m1, row_pa, row_pb, col_pa, col_pb,
                              rmax, rsum, cmax, csum, best_val, best_j,
                              colconf, B, L, S, C, chunk_tiles, scale, st);
}

// Pass 1 alone (the focal-loss kernels' statistics pass): the same inputs
// and scratch, outputs rmax, rsum [B, L] and cmax, csum [B, S].
extern "C" int loftr_dual_softmax_stats(const void* f0, const void* f1,
                                        const void* m0, const void* m1,
                                        void* row_pa, void* row_pb,
                                        void* col_pa, void* col_pb, void* rmax,
                                        void* rsum, void* cmax, void* csum,
                                        int B, int L, int S, int C,
                                        int chunk_tiles, float scale,
                                        int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch_stats<__nv_bfloat16>(f0, f1, m0, m1, row_pa, row_pb,
                                              col_pa, col_pb, rmax, rsum, cmax,
                                              csum, B, L, S, C, chunk_tiles,
                                              scale, st);
  return loftr::launch_stats<float>(f0, f1, m0, m1, row_pa, row_pb, col_pa,
                                    col_pb, rmax, rsum, cmax, csum, B, L, S, C,
                                    chunk_tiles, scale, st);
}
