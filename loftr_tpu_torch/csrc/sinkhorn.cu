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
// 2*L*S*C flop against (L+S)*C input values).  Every pass recomputes its
// sim tiles; nothing of size L x S reaches device memory.
//
// The TPU kernel holds a whole row slab, finishes u_new and uses it for the
// column statistics in the same sequential grid step.  Here tiles run in
// parallel and a row's u_new needs all S columns first, so an iteration is
// two passes over the tiles: a row pass (per-chunk partial max / sumexp of
// sim + v per row) and a column pass (partial max / sumexp of sim + u_new
// per column).  Small kernels combine the partials in a fixed order
// together with the dustbin terms; the dustbin's own updates are one-block
// reductions.  No float atomics: results are deterministic.  alpha and all
// running scalars are read from device memory, so the host never waits.
//
// float features (the exactness check): 64x64 sim tiles from shared-memory
// k-slabs (sim_tile.cuh); the column pass reduces each tile's columns
// through shared memory into per-row-tile partials.
//
// bfloat16 features, C = 256 (namespace bf below), on kernel B's pattern
// (sim_ring.cuh): 128 resident rows staged once by cp.async, 128-row tiles
// of the other side through a 2-stage cp.async ring, mma.m16n8k16 with each
// warp owning 32 x 64 accumulators, and every epilogue (scale, mask bias,
// __expf, reductions) on the accumulators.  The column pass is the row pass
// with the operands swapped (f1 resident, f0 streamed, bias u): sim^T is
// the same function, its per-chunk partials [B, nch', S] need no
// cross-thread column reduction, and their maxima are max_i(sim + u), so the
// last column pass also gives the column flags.  The best pass forms conf
// once an element for the row best and the per-row-tile column max.  Tile
// shape and chunks: sinkhorn_plan in ops/kernels/sinkhorn.py and
// tools/sinkhorn_chunk_sweep.py.

#include "sim_ring.cuh"
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
// conf partials pc [B, n, S]; logit partials pl [B, nl, S] (the float
// path's best pass, or the bf16 path's last column pass).
__global__ void col_best_kernel(const float* __restrict__ pc,
                                const float* __restrict__ pl, int n, int nl,
                                int S, int B, const float* __restrict__ alpha,
                                const float* __restrict__ ubin, int flags,
                                float* __restrict__ oc,
                                unsigned char* __restrict__ pf1,
                                float* __restrict__ keep1) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, j = idx % S;
  float m = -1.f, cl = -INFINITY;
  for (int t = 0; t < n; ++t) m = fmaxf(m, pc[((size_t)b * n + t) * S + j]);
  if (flags)
    for (int t = 0; t < nl; ++t)
      cl = fmaxf(cl, pl[((size_t)b * nl + t) * S + j]);
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
  col_best_kernel<<<gs, 256, 0, st>>>(col_pa, col_pb, nrt, nrt, S, B, alpha,
                                      ubin, 1, colconf, pf1, keep1);
  if (prefilter) {
    ot_tile_kernel<T, kBestFiltered><<<grid, kThreads, 0, st>>>(
        f0, f1, m0, m1, u, v, keep0, keep1, row_pa, row_pb, row_pc, col_pa,
        col_pb, L, S, C, chunk_tiles, scale, log_ls);
    row_best_kernel<<<gl, 256, 0, st>>>(row_pa, (const int*)row_pb, row_pc,
                                        nch, L, B, alpha, vbin, 0, best_val,
                                        best_j, pf0, keep0);
    col_best_kernel<<<gs, 256, 0, st>>>(col_pa, col_pb, nrt, nrt, S, B,
                                        alpha, ubin, 0, colconf, pf1, keep1);
  }
  return (int)cudaGetLastError();
}


// ---- bfloat16, C = 256: mma.sync on a resident row tile ------------------

namespace bf {

using namespace ring;  // bf16, kC, kLd, stage_rows, better, product, ...

constexpr int kLse = 0, kConf = 1, kConfFiltered = 2;  // pass modes

// WR warps down the R = 32*WR resident rows, 8/WR across the N = 64*NJ/WR
// streamed rows of a tile; NST ring stages.  red: a best pass's per-tile
// column maxima [WR][N], and the end-of-pass exchange across the warps of
// a row [R][WC][3].
template <int WR, int NJ, int NST>
struct Cfg {
  static constexpr int kWC = 8 / WR;
  static constexpr int kR = 32 * WR;
  static constexpr int kN = 8 * NJ * kWC;
  static constexpr int kRed = WR * kN > 3 * kR * kWC ? WR * kN : 3 * kR * kWC;
  static constexpr size_t kSmem =
      (size_t)(kR + NST * kN) * kLd * sizeof(bf16) + kRed * sizeof(float);
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= kSmemSM ? 2 : 1;
};

// One pass over the block's tile of resident rows x (f0 in the row and best
// passes, f1 in the column pass; nx of them) and chunk of streamed rows y
// (ny), with s = sim + by_y:
//   kLse: per-chunk (max, sumexp) of s over the chunk -> pa, pb [B, nch,
//         nx]; by = v (row pass) or u (column pass, sim^T).
//   kConf: conf = exp(s + bx_x + log_ls) (bx = u, by = v): per-chunk (best
//         conf, lowest argmax) -> pa, pb (int) and max of s -> pc [B, nch,
//         nx]; per-row-tile column max of conf -> cpa [B, nrt, ny].
//   kConfFiltered: the same over conf * kx_x * ky_y (keep0, keep1), no pc.
// mx / my (0/1) may both be null (no masks).  Thread (warp, lane) holds
// rows wr*32 + 16*mt + g + 8*h and columns wc*8*NJ + 8*j + 2*q + e of each
// tile (g = lane/4, q = lane%4) as acc[mt][j][2*h + e].
template <int WR, int NJ, int NST, int MODE>
__global__ void __launch_bounds__(kThreads, (Cfg<WR, NJ, NST>::kMinBlocks))
    sinkhorn_bf16(const bf16* __restrict__ fx, const bf16* __restrict__ fy,
                  const float* __restrict__ mx, const float* __restrict__ my,
                  const float* __restrict__ bx, const float* __restrict__ by,
                  const float* __restrict__ kx, const float* __restrict__ ky,
                  float* __restrict__ pa, float* __restrict__ pb,
                  float* __restrict__ pc, float* __restrict__ cpa, int nx,
                  int ny, int chunk_tiles, float scale, float log_ls) {
  using K = Cfg<WR, NJ, NST>;
  constexpr int WC = K::kWC, R = K::kR, N = K::kN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = (bf16*)smem_raw;                 // [R][kLd] resident rows
  bf16* stages = As + R * kLd;                // NST x [N][kLd] streamed rows
  float* red = (float*)(stages + NST * N * kLd);  // cross-warp partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / WC, wc = warp % WC;
  const int rt = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int nrt = gridDim.x, nch = gridDim.y;
  const int i0 = rt * R;
  const int t0 = chunk * chunk_tiles;
  const int nt = min(chunk_tiles, (ny + N - 1) / N - t0);
  const bf16* fyb = fy + (size_t)b * ny * kC;

  stage_rows<R>(As, fx + ((size_t)b * nx + i0) * kC, min(R, nx - i0));
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nt) {
      const int j0 = (t0 + s) * N;
      stage_rows<N>(stages + s * N * kLd, fyb + (size_t)j0 * kC,
                    min(N, ny - j0));
    }
    mma::cp_async_commit();
  }

  // per row x = 2*mt + h: its index, mask bias, bx + log_ls, keep, and the
  // carried statistics
  int rows[4], rj[4];
  float rbias[4], rterm[4], rkeep[4], ra[4], rb[4], rl[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    rows[x] = i0 + wr * 32 + (x >> 1) * 16 + g + 8 * (x & 1);
    const bool ok = rows[x] < nx;
    const size_t o = (size_t)b * nx + rows[x];
    rbias[x] = !ok ? -INFINITY : mx != nullptr ? (mx[o] - 1.f) * kBig : 0.f;
    rterm[x] = MODE != kLse && ok ? bx[o] + log_ls : 0.f;
    rkeep[x] = MODE == kConfFiltered && ok ? kx[o] : 1.f;
    ra[x] = MODE == kLse ? -INFINITY : -1.f;  // running max | best conf
    rb[x] = 0.f;                              // running sumexp
    rj[x] = 0;                                // best column
    rl[x] = -INFINITY;                        // max of sim + by
  }

  const bf16* al = a_lane(As, wr, lane);
  const int bl = b_lane<NJ>(wc, lane);

  for (int t = 0; t < nt; ++t) {
    mma::cp_async_wait<NST - 2>();  // this thread's copies of tile t are in
    __syncthreads();                // everyone's; tile t-1 and red are free
    const int nx_t = t + NST - 1;
    if (nx_t < nt) {
      const int jn = (t0 + nx_t) * N;
      stage_rows<N>(stages + (nx_t % NST) * N * kLd, fyb + (size_t)jn * kC,
                    min(N, ny - jn));
    }
    mma::cp_async_commit();

    float acc[2][NJ][4];
    product<NJ>(acc, al, stages + (t % NST) * N * kLd + bl);

    // s = sim + by (kLse) or conf (kConf*) in place, one expression an
    // element.  The mask term (m0 m1 - 1) * 1e9 of 0/1 masks is the smaller
    // of the row's and the column's (m - 1) * 1e9; cells outside [nx) x
    // [ny) take a -inf bias, so s is -inf and conf 0, which never win a
    // reduction over a valid cell of lower index.  Exponentials by the SFU
    // (ex2.approx, __expf).
    const int j0 = (t0 + t) * N;
    const int cw = wc * 8 * NJ + 2 * q;  // + 8*j + e: column in the tile
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j0 + cw + 8 * j + e;
        const bool cok = c < ny;
        const size_t o = (size_t)b * ny + c;
        const float cbias =
            !cok ? -INFINITY : my != nullptr ? (my[o] - 1.f) * kBig : 0.f;
        const float cv = cok ? by[o] : 0.f;
        const float ck = MODE == kConfFiltered && cok ? ky[o] : 1.f;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float& v = acc[x >> 1][j][2 * (x & 1) + e];
          const float sv = fmaf(v, scale, fminf(rbias[x], cbias)) + cv;
          if (MODE == kLse) {
            v = sv;
          } else {
            if (MODE == kConf) rl[x] = fmaxf(rl[x], sv);
            v = __expf(sv + rterm[x]);
            if (MODE == kConfFiltered) v *= rkeep[x] * ck;
          }
        }
      }

    // rows: kLse online max / sumexp, each thread's sum relative to the
    // quad's common max; kConf* best value, ascending columns, ties kept
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int mt = x >> 1, hi = 2 * (x & 1);
      if (MODE == kLse) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          tmax = fmaxf(tmax, fmaxf(acc[mt][j][hi], acc[mt][j][hi + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float nm = fmaxf(ra[x], tmax);
        if (nm != -INFINITY) {
          float ts = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            ts += __expf(acc[mt][j][hi] - nm) +
                  __expf(acc[mt][j][hi + 1] - nm);
          rb[x] = rb[x] * __expf(ra[x] - nm) + ts;
          ra[x] = nm;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (acc[mt][j][hi + e] > ra[x]) {
              ra[x] = acc[mt][j][hi + e];
              rj[x] = j0 + cw + 8 * j + e;
            }
      }
    }

    if (MODE != kLse) {
      // column max of conf: the warp's 32 rows by shuffles across g, then
      // the WR warps of the column through red[wr][col]
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float cm = fmaxf(fmaxf(acc[0][j][e], acc[0][j][2 + e]),
                           fmaxf(acc[1][j][e], acc[1][j][2 + e]));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 8));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
          if (g == 0) red[wr * N + cw + 8 * j + e] = cm;
        }
      __syncthreads();
      if (threadIdx.x < N && j0 + (int)threadIdx.x < ny) {
        const int cl = threadIdx.x;
        float m = red[cl];
#pragma unroll
        for (int w = 1; w < WR; ++w) m = fmaxf(m, red[w * N + cl]);
        cpa[((size_t)b * nrt + rt) * ny + j0 + cl] = m;
      }
    }
  }

  // rows: the quad, then the WC warps of the row through red[row][wc]
  __syncthreads();  // the last column combine has read red
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    float va = ra[x], vb = rb[x], vl = rl[x];
    int vj = rj[x];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      if (MODE == kLse) {
        vb += __shfl_xor_sync(0xffffffffu, vb, o);
      } else {
        const float ov = __shfl_xor_sync(0xffffffffu, va, o);
        const int oj = __shfl_xor_sync(0xffffffffu, vj, o);
        if (better(ov, oj, va, vj)) {
          va = ov;
          vj = oj;
        }
        if (MODE == kConf)
          vl = fmaxf(vl, __shfl_xor_sync(0xffffffffu, vl, o));
      }
    }
    if (q == 0) {
      float* p = red + ((rows[x] - i0) * WC + wc) * 3;
      p[0] = va;
      p[1] = MODE == kLse ? vb : __int_as_float(vj);
      p[2] = vl;
    }
  }
  __syncthreads();
  if (threadIdx.x < R && i0 + (int)threadIdx.x < nx) {
    const int r = threadIdx.x;
    const size_t o = ((size_t)b * nch + chunk) * nx + i0 + r;
    const float* p = red + r * WC * 3;
    if (MODE == kLse) {
      float m = p[0];
#pragma unroll
      for (int w = 1; w < WC; ++w) m = fmaxf(m, p[3 * w]);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WC; ++w)
        if (p[3 * w + 1] > 0.f) s += p[3 * w + 1] * expf(p[3 * w] - m);
      pa[o] = m;
      pb[o] = s;
    } else {
      float bv = p[0], l = p[2];
      int bj = __float_as_int(p[1]);
#pragma unroll
      for (int w = 1; w < WC; ++w) {
        if (better(p[3 * w], __float_as_int(p[3 * w + 1]), bv, bj)) {
          bv = p[3 * w];
          bj = __float_as_int(p[3 * w + 1]);
        }
        l = fmaxf(l, p[3 * w + 2]);
      }
      pa[o] = bv;
      ((int*)pb)[o] = bj;
      if (MODE == kConf) pc[o] = l;
    }
  }
}

template <int WR, int NJ, int NST, int MODE>
void pass(dim3 grid, cudaStream_t st, const bf16* fx, const bf16* fy,
          const float* mx, const float* my, const float* bx, const float* by,
          const float* kx, const float* ky, float* pa, float* pb, float* pc,
          float* cpa, int nx, int ny, int chunk_tiles, float scale,
          float log_ls) {
  using K = Cfg<WR, NJ, NST>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sinkhorn_bf16<WR, NJ, NST, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
  (void)attr;
  sinkhorn_bf16<WR, NJ, NST, MODE><<<grid, kThreads, K::kSmem, st>>>(
      fx, fy, mx, my, bx, by, kx, ky, pa, pb, pc, cpa, nx, ny, chunk_tiles,
      scale, log_ls);
}

// Every pass and combine.  The row and best passes run on the L x S grid
// (nrt row tiles of f0, nch chunks of ct_row f1 tiles), the column pass on
// the S x L grid (nrtc row tiles of f1, nchc chunks of ct_col f0 tiles).
// Launches: 6 an iteration, 3 for the best pass and its combines, 3 more
// with prefilter (21 and 24 at 3 iterations); one column pass more at 0
// iterations, for the column flags.
template <int WR, int NJ, int NST>
int launch(const bf16* f0, const bf16* f1, const float* m0, const float* m1,
           const float* alpha, float* u, float* v, float* ubin, float* vbin,
           float* pa, float* pb, float* pc, float* qa, float* qb, float* cpa,
           float* keep0, float* keep1, float* best_val, int* best_j,
           float* colconf, unsigned char* pf0, unsigned char* pf1, int B,
           int L, int S, int ct_row, int ct_col, int iters, int prefilter,
           float scale, cudaStream_t st) {
  using K = Cfg<WR, NJ, NST>;
  if (ct_row < 1 || ct_col < 1) return (int)cudaErrorInvalidValue;
  const int nrt = (L + K::kR - 1) / K::kR;
  const int nch = ((S + K::kN - 1) / K::kN + ct_row - 1) / ct_row;
  const int nrtc = (S + K::kR - 1) / K::kR;
  const int nchc = ((L + K::kN - 1) / K::kN + ct_col - 1) / ct_col;
  const dim3 grid(nrt, nch, B), gridc(nrtc, nchc, B);
  const int gl = (B * L + 255) / 256, gs = (B * S + 255) / 256;
  const float log_ls = logf((float)(L + S));
  const float norm = -log_ls;
  const float log_mu_bin = logf((float)S) + norm;
  const float log_nu_bin = logf((float)L) + norm;
  const float* F = nullptr;
  float* O = nullptr;
  for (int it = 0; it < iters; ++it) {
    bin_kernel<<<B, kThreads, 0, st>>>(v, S, vbin, alpha, log_mu_bin, ubin);
    pass<WR, NJ, NST, kLse>(grid, st, f0, f1, m0, m1, F, v, F, F, pa, pb, O,
                            O, L, S, ct_row, scale, log_ls);
    u_combine_kernel<<<gl, 256, 0, st>>>(pa, pb, nch, L, B, alpha, vbin, norm,
                                         u);
    pass<WR, NJ, NST, kLse>(gridc, st, f1, f0, m1, m0, F, u, F, F, qa, qb, O,
                            O, S, L, ct_col, scale, log_ls);
    v_combine_kernel<<<gs, 256, 0, st>>>(qa, qb, nchc, S, B, alpha, ubin,
                                         norm, v);
    bin_kernel<<<B, kThreads, 0, st>>>(u, L, ubin, alpha, log_nu_bin, vbin);
  }
  if (iters == 0)  // the column flags read max_i(sim + u) from qa
    pass<WR, NJ, NST, kLse>(gridc, st, f1, f0, m1, m0, F, u, F, F, qa, qb, O,
                            O, S, L, ct_col, scale, log_ls);
  pass<WR, NJ, NST, kConf>(grid, st, f0, f1, m0, m1, u, v, F, F, pa, pb, pc,
                           cpa, L, S, ct_row, scale, log_ls);
  row_best_kernel<<<gl, 256, 0, st>>>(pa, (const int*)pb, pc, nch, L, B,
                                      alpha, vbin, 1, best_val, best_j, pf0,
                                      keep0);
  col_best_kernel<<<gs, 256, 0, st>>>(cpa, qa, nrt, nchc, S, B, alpha, ubin,
                                      1, colconf, pf1, keep1);
  if (prefilter) {
    pass<WR, NJ, NST, kConfFiltered>(grid, st, f0, f1, m0, m1, u, v, keep0,
                                     keep1, pa, pb, O, cpa, L, S, ct_row,
                                     scale, log_ls);
    row_best_kernel<<<gl, 256, 0, st>>>(pa, (const int*)pb, pc, nch, L, B,
                                        alpha, vbin, 0, best_val, best_j, pf0,
                                        keep0);
    col_best_kernel<<<gs, 256, 0, st>>>(cpa, qa, nrt, nchc, S, B, alpha,
                                        ubin, 0, colconf, pf1, keep1);
  }
  return (int)cudaGetLastError();
}

}  // namespace bf

}  // namespace
}  // namespace loftr

// float features (dtype 0; bfloat16 goes to loftr_sinkhorn_bf16).
// f0 [B, L, C], f1 [B, S, C]; m0 [B, L], m1 [B, S] float 0/1; alpha [1]
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: entry below
  return loftr::launch<float>(
      f0, f1, (const float*)m0, (const float*)m1, (const float*)alpha,
      (float*)u, (float*)v, (float*)ubin, (float*)vbin, (float*)row_pa,
      (float*)row_pb, (float*)row_pc, (float*)col_pa, (float*)col_pb,
      (float*)keep0, (float*)keep1, (float*)best_val, (int*)best_j,
      (float*)colconf, (unsigned char*)pf0, (unsigned char*)pf1, B, L, S, C,
      chunk_tiles, iters, prefilter, scale, st);
}

// bfloat16, C = 256: f0 [B, L, 256], f1 [B, S, 256], 16-byte aligned; m0
// [B, L], m1 [B, S] float 0/1, or both null (no masks); alpha [1] float.
// Tiles of 128 resident x 128 streamed rows (bf16_plan's default shape);
// ct_row / ct_col: streamed tiles a block on the L x S grid (row and best
// passes) and the S x L grid (column pass), from sinkhorn_plan in
// ops/kernels/sinkhorn.py.  State, zero on entry: u [B, L], v [B, S],
// ubin, vbin [B].  Scratch (float): pa, pb, pc [B, nch, L]; qa, qb [B,
// nchc, S]; cpa [B, nrt, S]; keep0 [B, L], keep1 [B, S]; nrt =
// ceil(L/128), nch = ceil(ceil(S/128) / ct_row), nchc = ceil(ceil(L/128) /
// ct_col).  Outputs as loftr_sinkhorn's.
extern "C" int loftr_sinkhorn_bf16(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* alpha, void* u, void* v, void* ubin, void* vbin, void* pa,
    void* pb, void* pc, void* qa, void* qb, void* cpa, void* keep0,
    void* keep1, void* best_val, void* best_j, void* colconf, void* pf0,
    void* pf1, int B, int L, int S, int C, int ct_row, int ct_col,
    int iters, int prefilter, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != loftr::ring::kC || ((uintptr_t)f0 | (uintptr_t)f1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return loftr::bf::launch<4, 8, 2>(
      (const loftr::ring::bf16*)f0, (const loftr::ring::bf16*)f1,
      (const float*)m0, (const float*)m1, (const float*)alpha, (float*)u,
      (float*)v, (float*)ubin, (float*)vbin, (float*)pa, (float*)pb,
      (float*)pc, (float*)qa, (float*)qb, (float*)cpa, (float*)keep0,
      (float*)keep1, (float*)best_val, (int*)best_j, (float*)colconf,
      (unsigned char*)pf0, (unsigned char*)pf1, B, L, S, ct_row, ct_col,
      iters, prefilter, scale, st);
}
