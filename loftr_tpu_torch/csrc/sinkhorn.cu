// Fused Sinkhorn-OT matching statistics without the [L+1, S+1] coupling
// matrix.
//
// Replaces loftr_tpu/ops/pallas/sinkhorn.py::fused_sinkhorn_match (_u_kernel,
// _ot_best_kernel, _ot_best_filtered_kernel).
//
// sim = (f0 . f1^T) * scale + (m0 m1 - 1) * 1e9, scale = 1/C on the float
// dot.  A dustbin row and column hold alpha = bin_score.  Per iteration, in
// log space (log_mu = log_nu = -log(L+S) for real rows and columns):
//   u_bin = log_mu_bin - (alpha + lse([v, v_bin]))
//   u_i   = log_mu - lse_j([sim_ij + v_j, alpha + v_bin])
//   v_j   = log_nu - logaddexp(lse_i(sim_ij + u_i), alpha + u_bin)
//   v_bin = log_nu_bin - (alpha + lse([u, u_bin]))
// then conf = exp(sim + u + v + log(L+S)): row best / first argmax, column
// max, and the flags "the dustbin beats every real entry" of each row and
// column (alpha + v_bin > max_j(sim + v), alpha + u_bin > max_i(sim + u)).
// With prefilter, one more pass takes the best values over conf with the
// flagged rows and columns zeroed.
//
// What bounds it on the H100: operations (iters + 1 (+ 1) sim products of
// 2*L*S*C flop against (L+S)*C input values).  Every pass recomputes 64x64
// sim tiles (sim_tile.cuh: WMMA in bf16, FMAs in float); nothing of size
// L x S reaches device memory.
//
// The TPU kernel holds a whole row slab, finishes u_new and uses it for the
// column statistics in the same sequential grid step.  Here tiles run in
// parallel and a row's u_new needs all S columns first, so an iteration is
// two passes over the tiles: a row pass (per column-chunk partial max /
// sumexp of sim + v) and a column pass (per row-tile partial max / sumexp
// of sim + u_new).  Small kernels combine the partials in a fixed order
// together with the dustbin terms; the dustbin's own updates are one-block
// reductions.  No float atomics: results are deterministic.  alpha and all
// running scalars are read from device memory, so the host never waits.

#include "sim_tile.cuh"

namespace loftr {
namespace {

constexpr float kBig = 1e9f;
constexpr int kRow = 0, kCol = 1, kBest = 2, kBestFiltered = 3;

// MODE kRow:  row partials (max, sumexp) of sim + v over a column chunk.
// MODE kCol:  column partials (max, sumexp) of sim + u over a row tile.
// MODE kBest: conf = exp(sim + u + v + log_ls): row best value / lowest
//             argmax per chunk, column max per row tile, and the partial
//             maxima of sim + v per row and sim + u per column.
// MODE kBestFiltered: the same over conf * keep0_i * keep1_j, no logit maxima.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    ot_tile_kernel(const T* __restrict__ f0, const T* __restrict__ f1,
                   const float* __restrict__ m0, const float* __restrict__ m1,
                   const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ keep0,
                   const float* __restrict__ keep1, float* __restrict__ row_pa,
                   float* __restrict__ row_pb, float* __restrict__ row_pc,
                   float* __restrict__ col_pa, float* __restrict__ col_pb,
                   int L, int S, int C, int chunk_tiles, float scale,
                   float log_ls) {
  __shared__ __align__(128) unsigned char tile_smem[kTileBytes];
  __shared__ float red_a[16][kTN];
  __shared__ float red_b[16][kTN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rt = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int nrt = gridDim.x, nch = gridDim.y;
  const int i0 = rt * kTM;
  const T* f0b = f0 + (size_t)b * L * C;
  const T* f1b = f1 + (size_t)b * S * C;

  int rows[4], r_j[4];
  float rm0[4], ru[4], rk[4];
  float r_a[4], r_b[4], r_c[4];  // kRow: running max, sum; else best, -, rowlog
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rows[a] = i0 + ty + 16 * a;
    const bool ok = rows[a] < L;
    const size_t o = (size_t)b * L + rows[a];
    rm0[a] = ok ? m0[o] : 0.f;
    ru[a] = (MODE != kRow && ok) ? u[o] : 0.f;
    rk[a] = (MODE == kBestFiltered && ok) ? keep0[o] : 1.f;
    r_a[a] = MODE == kRow ? -INFINITY : -1.f;
    r_b[a] = 0.f;
    r_c[a] = -INFINITY;
    r_j[a] = 0;
  }

  const int ct0 = chunk * chunk_tiles;
  for (int ct = ct0; ct < ct0 + chunk_tiles; ++ct) {
    const int j0 = ct * kTN;
    if (j0 >= S) break;
    float acc[4][4];
    sim_tile<T>(f0b, f1b, L, S, C, i0, j0, tile_smem, acc);
    int cols[4];
    float cm1[4], cv[4], ck[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cols[c] = j0 + tx + 16 * c;
      const bool ok = cols[c] < S;
      const size_t o = (size_t)b * S + cols[c];
      cm1[c] = ok ? m1[o] : 0.f;
      cv[c] = (MODE != kCol && ok) ? v[o] : 0.f;
      ck[c] = (MODE == kBestFiltered && ok) ? keep1[o] : 1.f;
    }
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[a][c] = acc[a][c] * scale + (rm0[a] * cm1[c] - 1.f) * kBig;

    if (MODE == kRow) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cols[c] < S) tmax = fmaxf(tmax, s[a][c] + cv[c]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        float ts = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cols[c] < S) ts += expf(s[a][c] + cv[c] - tmax);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          ts += __shfl_xor_sync(0xffffffffu, ts, o);
        const float nm = fmaxf(r_a[a], tmax);
        r_b[a] = r_b[a] * expf(r_a[a] - nm) + ts * expf(tmax - nm);
        r_a[a] = nm;
      }
    } else if (MODE == kCol) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float cmaxl = -INFINITY;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (rows[a] < L) cmaxl = fmaxf(cmaxl, s[a][c] + ru[a]);
        float csl = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (rows[a] < L) csl += expf(s[a][c] + ru[a] - cmaxl);
        red_a[ty][tx + 16 * c] = cmaxl;
        red_b[ty][tx + 16 * c] = csl;
      }
    } else {
      float conf[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          conf[a][c] = expf(s[a][c] + ru[a] + cv[c] + log_ls);
          if (MODE == kBestFiltered) conf[a][c] *= rk[a] * ck[c];
        }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float bv = -1.f;
        int bj = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cols[c] < S && conf[a][c] > bv) {
            bv = conf[a][c];
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
        if (MODE == kBest) {
          float rl = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (cols[c] < S) rl = fmaxf(rl, s[a][c] + cv[c]);
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            rl = fmaxf(rl, __shfl_xor_sync(0xffffffffu, rl, o));
          r_c[a] = fmaxf(r_c[a], rl);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float cmaxl = -1.f, clog = -INFINITY;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (rows[a] < L) {
            cmaxl = fmaxf(cmaxl, conf[a][c]);
            clog = fmaxf(clog, s[a][c] + ru[a]);
          }
        red_a[ty][tx + 16 * c] = cmaxl;
        if (MODE == kBest) red_b[ty][tx + 16 * c] = clog;
      }
    }
    if (MODE != kRow) {
      __syncthreads();
      if (tid < kTN && j0 + tid < S) {
        const size_t o = ((size_t)b * nrt + rt) * S + j0 + tid;
        if (MODE == kCol) {
          float m = -INFINITY;
          for (int t = 0; t < 16; ++t) m = fmaxf(m, red_a[t][tid]);
          float sum = 0.f;
          for (int t = 0; t < 16; ++t)
            if (red_b[t][tid] > 0.f)
              sum += red_b[t][tid] * expf(red_a[t][tid] - m);
          col_pa[o] = m;
          col_pb[o] = sum;
        } else {
          float m = -1.f;
          for (int t = 0; t < 16; ++t) m = fmaxf(m, red_a[t][tid]);
          col_pa[o] = m;
          if (MODE == kBest) {
            float l = -INFINITY;
            for (int t = 0; t < 16; ++t) l = fmaxf(l, red_b[t][tid]);
            col_pb[o] = l;
          }
        }
      }
      __syncthreads();
    }
  }
  if (MODE != kCol && tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (rows[a] >= L) continue;
      const size_t o = ((size_t)b * nch + chunk) * L + rows[a];
      row_pa[o] = r_a[a];
      if (MODE == kRow) {
        row_pb[o] = r_b[a];
      } else {
        ((int*)row_pb)[o] = r_j[a];
        if (MODE == kBest) row_pc[o] = r_c[a];
      }
    }
  }
}

__device__ __forceinline__ float block_max(float x, float* sh) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = sh[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, sh[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ float block_sum(float x, float* sh) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = sh[0];
  for (int w = 1; w < kThreads / 32; ++w) s += sh[w];
  __syncthreads();
  return s;
}

// A dustbin potential, one block per pair:
// out[b] = log_marg - (alpha + lse([x[b, 0..len), other[b]])).
__global__ void __launch_bounds__(kThreads)
    bin_kernel(const float* __restrict__ x, int len,
               const float* __restrict__ other,
               const float* __restrict__ alpha, float log_marg,
               float* __restrict__ out) {
  __shared__ float sh[kThreads / 32];
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * len;
  const float ob = other[b];
  float m = -INFINITY;
  for (int i = threadIdx.x; i < len; i += kThreads) m = fmaxf(m, xb[i]);
  m = fmaxf(block_max(m, sh), ob);
  float s = 0.f;
  for (int i = threadIdx.x; i < len; i += kThreads) s += expf(xb[i] - m);
  s = block_sum(s, sh) + expf(ob - m);
  if (threadIdx.x == 0) out[b] = log_marg - (alpha[0] + m + logf(s));
}

// u_i = log_mu - lse([row partials of sim + v, alpha + v_bin]).
__global__ void u_combine_kernel(const float* __restrict__ pm,
                                 const float* __restrict__ ps, int n, int L,
                                 int B, const float* __restrict__ alpha,
                                 const float* __restrict__ vbin, float log_mu,
                                 float* __restrict__ u) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L) return;
  const int b = idx / L, i = idx % L;
  const float* a = pm + (size_t)b * n * L + i;
  const float* s = ps + (size_t)b * n * L + i;
  const float av = alpha[0] + vbin[b];
  float m = av;
  for (int t = 0; t < n; ++t) m = fmaxf(m, a[(size_t)t * L]);
  float sum = 0.f;
  for (int t = 0; t < n; ++t) {
    const float st = s[(size_t)t * L];
    if (st > 0.f) sum += st * expf(a[(size_t)t * L] - m);
  }
  sum += expf(av - m);
  u[idx] = log_mu - (m + logf(sum));
}

// v_j = log_nu - logaddexp(lse(column partials of sim + u), alpha + u_bin).
__global__ void v_combine_kernel(const float* __restrict__ pm,
                                 const float* __restrict__ ps, int n, int S,
                                 int B, const float* __restrict__ alpha,
                                 const float* __restrict__ ubin, float log_nu,
                                 float* __restrict__ v) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, j = idx % S;
  const float* a = pm + (size_t)b * n * S + j;
  const float* s = ps + (size_t)b * n * S + j;
  float m = -INFINITY;
  for (int t = 0; t < n; ++t) m = fmaxf(m, a[(size_t)t * S]);
  float sum = 0.f;
  for (int t = 0; t < n; ++t) {
    const float st = s[(size_t)t * S];
    if (st > 0.f) sum += st * expf(a[(size_t)t * S] - m);
  }
  const float col_lse = m + logf(fmaxf(sum, 1e-38f));
  const float au = alpha[0] + ubin[b];
  const float hi = fmaxf(col_lse, au), lo = fminf(col_lse, au);
  v[idx] = log_nu - (hi + log1pf(expf(lo - hi)));
}

// Row best over column chunks in ascending order (ties keep the lowest
// index).  With flags: pf0 = alpha + v_bin > max_j(sim + v), keep0 = !pf0.
__global__ void row_best_kernel(const float* __restrict__ pv,
                                const int* __restrict__ pj,
                                const float* __restrict__ pl, int n, int L,
                                int B, const float* __restrict__ alpha,
                                const float* __restrict__ vbin, int flags,
                                float* __restrict__ ov, int* __restrict__ oj,
                                unsigned char* __restrict__ pf0,
                                float* __restrict__ keep0) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L) return;
  const int b = idx / L, i = idx % L;
  float best = -1.f, rl = -INFINITY;
  int bj = 0;
  for (int t = 0; t < n; ++t) {
    const size_t o = ((size_t)b * n + t) * L + i;
    if (pv[o] > best) {
      best = pv[o];
      bj = pj[o];
    }
    if (flags) rl = fmaxf(rl, pl[o]);
  }
  ov[idx] = best;
  oj[idx] = bj;
  if (flags) {
    const bool f = alpha[0] + vbin[b] > rl;
    pf0[idx] = f ? 1 : 0;
    keep0[idx] = f ? 0.f : 1.f;
  }
}

// Column max of conf over row tiles.  With flags: pf1 = alpha + u_bin >
// max_i(sim + u), keep1 = !pf1.
__global__ void col_best_kernel(const float* __restrict__ pc,
                                const float* __restrict__ pl, int n, int S,
                                int B, const float* __restrict__ alpha,
                                const float* __restrict__ ubin, int flags,
                                float* __restrict__ oc,
                                unsigned char* __restrict__ pf1,
                                float* __restrict__ keep1) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, j = idx % S;
  float m = -1.f, cl = -INFINITY;
  for (int t = 0; t < n; ++t) {
    const size_t o = ((size_t)b * n + t) * S + j;
    m = fmaxf(m, pc[o]);
    if (flags) cl = fmaxf(cl, pl[o]);
  }
  oc[idx] = m;
  if (flags) {
    const bool f = alpha[0] + ubin[b] > cl;
    pf1[idx] = f ? 1 : 0;
    keep1[idx] = f ? 0.f : 1.f;
  }
}

template <typename T>
int launch(const void* f0v, const void* f1v, const float* m0, const float* m1,
           const float* alpha, float* u, float* v, float* ubin, float* vbin,
           float* row_pa, float* row_pb, float* row_pc, float* col_pa,
           float* col_pb, float* keep0, float* keep1, float* best_val,
           int* best_j, float* colconf, unsigned char* pf0,
           unsigned char* pf1, int B, int L, int S, int C, int chunk_tiles,
           int iters, int prefilter, float scale, cudaStream_t st) {
  const T* f0 = (const T*)f0v;
  const T* f1 = (const T*)f1v;
  const int nrt = (L + kTM - 1) / kTM;
  const int nct = (S + kTN - 1) / kTN;
  const int nch = (nct + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid(nrt, nch, B);
  const int gl = (B * L + 255) / 256, gs = (B * S + 255) / 256;
  const float log_ls = logf((float)(L + S));
  const float norm = -log_ls;
  const float log_mu_bin = logf((float)S) + norm;
  const float log_nu_bin = logf((float)L) + norm;
  for (int it = 0; it < iters; ++it) {
    bin_kernel<<<B, kThreads, 0, st>>>(v, S, vbin, alpha, log_mu_bin, ubin);
    ot_tile_kernel<T, kRow><<<grid, kThreads, 0, st>>>(
        f0, f1, m0, m1, u, v, keep0, keep1, row_pa, row_pb, row_pc, col_pa,
        col_pb, L, S, C, chunk_tiles, scale, log_ls);
    u_combine_kernel<<<gl, 256, 0, st>>>(row_pa, row_pb, nch, L, B, alpha,
                                         vbin, norm, u);
    ot_tile_kernel<T, kCol><<<grid, kThreads, 0, st>>>(
        f0, f1, m0, m1, u, v, keep0, keep1, row_pa, row_pb, row_pc, col_pa,
        col_pb, L, S, C, chunk_tiles, scale, log_ls);
    v_combine_kernel<<<gs, 256, 0, st>>>(col_pa, col_pb, nrt, S, B, alpha,
                                         ubin, norm, v);
    bin_kernel<<<B, kThreads, 0, st>>>(u, L, ubin, alpha, log_nu_bin, vbin);
  }
  ot_tile_kernel<T, kBest><<<grid, kThreads, 0, st>>>(
      f0, f1, m0, m1, u, v, keep0, keep1, row_pa, row_pb, row_pc, col_pa,
      col_pb, L, S, C, chunk_tiles, scale, log_ls);
  row_best_kernel<<<gl, 256, 0, st>>>(row_pa, (const int*)row_pb, row_pc, nch,
                                      L, B, alpha, vbin, 1, best_val, best_j,
                                      pf0, keep0);
  col_best_kernel<<<gs, 256, 0, st>>>(col_pa, col_pb, nrt, S, B, alpha, ubin,
                                      1, colconf, pf1, keep1);
  if (prefilter) {
    ot_tile_kernel<T, kBestFiltered><<<grid, kThreads, 0, st>>>(
        f0, f1, m0, m1, u, v, keep0, keep1, row_pa, row_pb, row_pc, col_pa,
        col_pb, L, S, C, chunk_tiles, scale, log_ls);
    row_best_kernel<<<gl, 256, 0, st>>>(row_pa, (const int*)row_pb, row_pc,
                                        nch, L, B, alpha, vbin, 0, best_val,
                                        best_j, pf0, keep0);
    col_best_kernel<<<gs, 256, 0, st>>>(col_pa, col_pb, nrt, S, B, alpha,
                                        ubin, 0, colconf, pf1, keep1);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace loftr

// f0 [B, L, C], f1 [B, S, C] (T); m0 [B, L], m1 [B, S] float 0/1; alpha [1]
// float (bin_score).  State, zero on entry: u [B, L], v [B, S], ubin, vbin
// [B].  Scratch (float): row_pa, row_pb, row_pc [B, nch, L]; col_pa, col_pb
// [B, nrt, S]; keep0 [B, L], keep1 [B, S]; nrt = ceil(L/64), nch =
// ceil(ceil(S/64) / chunk_tiles).  Outputs: best_val [B, L] float, best_j
// [B, L] int32, colconf [B, S] float, pf0 [B, L] and pf1 [B, S] bytes 0/1.
extern "C" int loftr_sinkhorn(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* alpha, void* u, void* v, void* ubin, void* vbin, void* row_pa,
    void* row_pb, void* row_pc, void* col_pa, void* col_pb, void* keep0,
    void* keep1, void* best_val, void* best_j, void* colconf, void* pf0,
    void* pf1, int B, int L, int S, int C, int chunk_tiles, int iters,
    int prefilter, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = dtype == 1 ? loftr::launch<__nv_bfloat16> : loftr::launch<float>;
  return fn(f0, f1, (const float*)m0, (const float*)m1, (const float*)alpha,
            (float*)u, (float*)v, (float*)ubin, (float*)vbin, (float*)row_pa,
            (float*)row_pb, (float*)row_pc, (float*)col_pa, (float*)col_pb,
            (float*)keep0, (float*)keep1, (float*)best_val, (int*)best_j,
            (float*)colconf, (unsigned char*)pf0, (unsigned char*)pf1, B, L,
            S, C, chunk_tiles, iters, prefilter, scale, st);
}
