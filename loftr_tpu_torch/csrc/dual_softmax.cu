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
// What bounds it on the H100: operations, 2 x 2*L*S*C flop plus 4*L*S
// exponentials (2 an element in each pass, as the JAX kernel forms them)
// against (L+S)*C input values.  At L = S = 4800, C = 256 each pass is 12 us
// of bf16 tensor-core work and about as much of the SFU's exponentials.
//
// The TPU kernels carry column statistics across a sequential grid.  Here a
// block owns a row tile and a chunk of columns; it writes row partials
// per column chunk and column partials per row tile, and small combine
// kernels reduce them in a fixed order (log-sum-exp rescale for the
// softmax statistics, max with the lowest index on ties for the row best).
// No float atomics, so results are deterministic.
//
// float features (the exactness check, and the focal loss's tile-path
// statistics entry loftr_dual_softmax_stats in both types): 64x64 sim tiles
// from shared-memory k-slabs (sim_tile.cuh), rebuilt at every k-step.  The
// focal loss's bf16 path at C = 256 takes pass 1 below alone
// (loftr_dual_softmax_bf16_stats).
//
// bfloat16 features, C = 256 (dual_softmax_bf16 below): what held the tile
// kernel at 3% of the bound was that every 64x64 tile reloaded both operands
// from L2 one scalar at a time at every 32-deep k-step, sent the products
// through a float tile in shared memory, and spread each row over 16
// threads.  The bf16 path instead
//   - stages the block's R rows of f0 into shared memory once, with 16-byte
//     cp.async into rows padded by 16 bytes (ldmatrix without bank
//     conflicts), and keeps them there across the block's whole chunk of
//     columns;
//   - streams f1 tiles of N rows through a ring of NST shared-memory stages,
//     NST-1 ahead of the products, so each tile crosses L2 once a block and
//     feeds all 8 warps; f1 rows are the columns of the col-major B operand,
//     read with plain ldmatrix.x4;
//   - gives each warp 32 rows x N/(8/WR) columns as m16n8k16 accumulators,
//     so every ldmatrix.x4 fragment feeds 4 mma.sync;
//   - runs the scale, the mask bias, the exponentials and every reduction on
//     the accumulators: row statistics are carried across the chunk in
//     registers (quad shuffles, one exchange across the warps of a row at
//     the end), column partials per tile go through shuffles across the
//     warp's rows and a small shared buffer across warps.  conf is formed
//     once per element and feeds both the row best and the column max, so
//     best_val[i] and colconf[best_j[i]] come from the same float.
// Tile shapes and chunk counts: see bf16_plan in ops/kernels/dual_softmax.py
// and tools/dual_softmax_tile_sweep.py.

#include "sim_ring.cuh"
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


// ---- bfloat16, C = 256: mma.sync on a resident row tile ------------------

namespace bf {

using namespace ring;  // bf16, kC, kLd, stage_rows, better, product, ...

// WR warps down the R = 32*WR rows, 8/WR across the N = 64*NJ/WR columns;
// each warp owns 32 rows x 8*NJ columns; NST ring stages of N f1 rows.
template <int WR, int NJ, int NST>
struct Cfg {
  static constexpr int kWC = 8 / WR;
  static constexpr int kR = 32 * WR;
  static constexpr int kN = 8 * NJ * kWC;
  static constexpr int kRed = 2 * WR * kN > 2 * kR * kWC ? 2 * WR * kN
                                                          : 2 * kR * kWC;
  static constexpr size_t kSmem =
      (size_t)(kR + NST * kN) * kLd * sizeof(bf16) + kRed * sizeof(float);
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= kSmemSM ? 2 : 1;
};

// One pass over the block's row tile x column chunk.
//   MODE 0: row (max, sumexp) partials per chunk -> row_pa, row_pb;
//           column (max, sumexp) partials per row tile -> col_pa, col_pb.
//   MODE 1: with rstat = [rmax; 1/rsum] [2, B, L] and cstat = [cmax;
//           1/csum] [2, B, S]: row (best conf, lowest argmax) per chunk ->
//           row_pa, row_pb (int); column max of conf per row tile -> col_pa.
// m0 / m1 may be null (no masks).  Thread (warp, lane) holds rows
// wr*32 + 16*mt + g + 8*h and columns wc*8*NJ + 8*j + 2*q + e of each tile
// (g = lane/4, q = lane%4), acc[mt][j][2*h + e] (mma.m16n8k16 layout).
template <int WR, int NJ, int NST, int MODE>
__global__ void __launch_bounds__(kThreads, (Cfg<WR, NJ, NST>::kMinBlocks))
    dual_softmax_bf16(const bf16* __restrict__ f0, const bf16* __restrict__ f1,
                      const float* __restrict__ m0,
                      const float* __restrict__ m1,
                      const float* __restrict__ rstat,
                      const float* __restrict__ cstat,
                      float* __restrict__ row_pa, float* __restrict__ row_pb,
                      float* __restrict__ col_pa, float* __restrict__ col_pb,
                      int B, int L, int S, int chunk_tiles, float scale) {
  using K = Cfg<WR, NJ, NST>;
  constexpr int WC = K::kWC, R = K::kR, N = K::kN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = (bf16*)smem_raw;                  // [R][kLd] the f0 rows
  bf16* ring = As + R * kLd;                   // NST x [N][kLd] f1 rows
  float* red = (float*)(ring + NST * N * kLd);  // cross-warp partials
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

  // per row x = 2*mt + h: its index, mask bias, and the carried statistics
  int rows[4];
  float rbias[4], ra[4], rb[4], rmx[4], rinv[4];
  int rj[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    rows[x] = i0 + wr * 32 + (x >> 1) * 16 + g + 8 * (x & 1);
    const bool ok = rows[x] < L;
    const size_t o = (size_t)b * L + rows[x];
    rbias[x] = !ok ? -INFINITY : m0 != nullptr ? (m0[o] - 1.f) * kBig : 0.f;
    ra[x] = MODE == 0 ? -INFINITY : -1.f;  // running max | best conf
    rb[x] = 0.f;                           // running sumexp
    rj[x] = 0;                             // best column
    rmx[x] = MODE == 1 && ok ? rstat[o] : 0.f;
    rinv[x] = MODE == 1 && ok ? rstat[(size_t)B * L + o] : 0.f;
  }

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

    // sim (MODE 0) or conf (MODE 1) in place, one expression an element.
    // The mask term (m0 m1 - 1) * 1e9 of 0/1 masks is the smaller of the
    // row's and the column's (m - 1) * 1e9; cells outside [L) x [S) take a
    // -inf bias, so sim -inf (MODE 0) or conf 0 (MODE 1: rinv and cinv are
    // 0 there), which never win a reduction over a valid cell of lower
    // index.  Exponentials by the SFU (ex2.approx, __expf).
    const int j0 = (t0 + t) * N;
    const int cw = wc * 8 * NJ + 2 * q;  // + 8*j + e: column in the tile
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j0 + cw + 8 * j + e;
        const bool cok = c < S;
        const size_t o = (size_t)b * S + c;
        const float cbias =
            !cok ? -INFINITY : m1 != nullptr ? (m1[o] - 1.f) * kBig : 0.f;
        const float cmx = MODE == 1 && cok ? cstat[o] : 0.f;
        const float cinv = MODE == 1 && cok ? cstat[(size_t)B * S + o] : 0.f;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float& v = acc[x >> 1][j][2 * (x & 1) + e];
          const float sim = fmaf(v, scale, fminf(rbias[x], cbias));
          if (MODE == 0)
            v = sim;
          else
            v = __expf(sim - rmx[x]) * rinv[x] * (__expf(sim - cmx) * cinv);
        }
      }

    // rows: MODE 0 online max / sumexp, each thread's sum relative to the
    // quad's common max; MODE 1 best value, ascending columns, ties kept
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int mt = x >> 1, hi = 2 * (x & 1);
      if (MODE == 0) {
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

    // columns: the warp's 32 rows by shuffles across g, then red[wr][col]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cm = fmaxf(fmaxf(acc[0][j][e], acc[0][j][2 + e]),
                         fmaxf(acc[1][j][e], acc[1][j][2 + e]));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 8));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
        const int cl = cw + 8 * j + e;
        if (MODE == 0) {
          float cs =
              __expf(acc[0][j][e] - cm) + __expf(acc[0][j][2 + e] - cm) +
              __expf(acc[1][j][e] - cm) + __expf(acc[1][j][2 + e] - cm);
          cs += __shfl_xor_sync(0xffffffffu, cs, 4);
          cs += __shfl_xor_sync(0xffffffffu, cs, 8);
          cs += __shfl_xor_sync(0xffffffffu, cs, 16);
          if (g == 0) red[(WR + wr) * N + cl] = cm == -INFINITY ? 0.f : cs;
        }
        if (g == 0) red[wr * N + cl] = cm;
      }
    __syncthreads();
    if (threadIdx.x < N && j0 + (int)threadIdx.x < S) {
      const int cl = threadIdx.x;
      const size_t o = ((size_t)b * nrt + rt) * S + j0 + cl;
      float m = red[cl];
#pragma unroll
      for (int w = 1; w < WR; ++w) m = fmaxf(m, red[w * N + cl]);
      col_pa[o] = m;
      if (MODE == 0) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WR; ++w) {
          const float sw = red[(WR + w) * N + cl];
          if (sw > 0.f) s += sw * expf(red[w * N + cl] - m);
        }
        col_pb[o] = s;
      }
    }
  }

  // rows: the quad, then the WC warps of the row through red[row][wc]
  __syncthreads();  // the last column combine has read red
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    float va = ra[x], vb = rb[x];
    int vj = rj[x];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      if (MODE == 0) {
        vb += __shfl_xor_sync(0xffffffffu, vb, o);
      } else {
        const float ov = __shfl_xor_sync(0xffffffffu, va, o);
        const int oj = __shfl_xor_sync(0xffffffffu, vj, o);
        if (better(ov, oj, va, vj)) {
          va = ov;
          vj = oj;
        }
      }
    }
    if (q == 0) {
      const int r = rows[x] - i0;
      red[(r * WC + wc) * 2] = va;
      red[(r * WC + wc) * 2 + 1] = MODE == 0 ? vb : __int_as_float(vj);
    }
  }
  __syncthreads();
  if (threadIdx.x < R && i0 + (int)threadIdx.x < L) {
    const int r = threadIdx.x;
    const size_t o = ((size_t)b * nch + chunk) * L + i0 + r;
    const float* p = red + r * WC * 2;
    if (MODE == 0) {
      float m = p[0];
#pragma unroll
      for (int w = 1; w < WC; ++w) m = fmaxf(m, p[2 * w]);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WC; ++w)
        if (p[2 * w + 1] > 0.f) s += p[2 * w + 1] * expf(p[2 * w] - m);
      row_pa[o] = m;
      row_pb[o] = s;
    } else {
      float bv = p[0];
      int bj = __float_as_int(p[1]);
#pragma unroll
      for (int w = 1; w < WC; ++w)
        if (better(p[2 * w], __float_as_int(p[2 * w + 1]), bv, bj)) {
          bv = p[2 * w];
          bj = __float_as_int(p[2 * w + 1]);
        }
      row_pa[o] = bv;
      ((int*)row_pb)[o] = bj;
    }
  }
}

// Pass 1's row partials [B, nch, L] and column partials [B, nrt, S] ->
// rstat = [rmax; 1/rsum] [2, B, L] and cstat = [cmax; 1/csum] [2, B, S]:
// log-sum-exp over the partials in ascending order, rows and columns in one
// launch.
__global__ void stats_combine(const float* __restrict__ row_pa,
                              const float* __restrict__ row_pb,
                              const float* __restrict__ col_pa,
                              const float* __restrict__ col_pb, int nch,
                              int nrt, int B, int L, int S,
                              float* __restrict__ rstat,
                              float* __restrict__ cstat) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row = i < B * L;
  if (!row) i -= B * L;
  const int len = row ? L : S, n = row ? nch : nrt;
  if (i >= B * len) return;
  const int b = i / len, k = i % len;
  const float* a = (row ? row_pa : col_pa) + (size_t)b * n * len + k;
  const float* s = (row ? row_pb : col_pb) + (size_t)b * n * len + k;
  float m = -INFINITY;
  for (int t = 0; t < n; ++t) m = fmaxf(m, a[(size_t)t * len]);
  float sum = 0.f;
  for (int t = 0; t < n; ++t) {
    const float st = s[(size_t)t * len];
    if (st > 0.f) sum += st * expf(a[(size_t)t * len] - m);
  }
  float* out = row ? rstat : cstat;
  out[i] = m;
  out[(size_t)B * len + i] = 1.f / sum;
}

// Pass 2's partials -> best_val, best_j [B, L] (chunks in ascending order,
// ties keep the lowest index) and colconf [B, S], in one launch.
__global__ void best_combine(const float* __restrict__ row_pa,
                             const int* __restrict__ row_pb,
                             const float* __restrict__ col_pa, int nch,
                             int nrt, int B, int L, int S,
                             float* __restrict__ best_val,
                             int* __restrict__ best_j,
                             float* __restrict__ colconf) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * L) {
    const int b = i / L, k = i % L;
    float bv = -1.f;
    int bj = 0;
    for (int t = 0; t < nch; ++t) {
      const size_t o = ((size_t)b * nch + t) * L + k;
      if (row_pa[o] > bv) {
        bv = row_pa[o];
        bj = row_pb[o];
      }
    }
    best_val[i] = bv;
    best_j[i] = bj;
    return;
  }
  i -= B * L;
  if (i >= B * S) return;
  const int b = i / S, k = i % S;
  float m = -1.f;
  for (int t = 0; t < nrt; ++t)
    m = fmaxf(m, col_pa[((size_t)b * nrt + t) * S + k]);
  colconf[i] = m;
}

// Pass 1 and its combine: rstat, cstat (alone, the focal loss's statistics,
// focal_loss.cu).  Scratch as launch's.
template <int WR, int NJ, int NST>
int launch_stats(const void* f0, const void* f1, const void* m0,
                 const void* m1, void* row_pa, void* row_pb, void* col_pa,
                 void* col_pb, void* rstat, void* cstat, int B, int L, int S,
                 int chunk_tiles, float scale, cudaStream_t st) {
  using K = Cfg<WR, NJ, NST>;
  static const cudaError_t a0 = cudaFuncSetAttribute(
      dual_softmax_bf16<WR, NJ, NST, 0>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
  (void)a0;
  if (chunk_tiles < 1) return (int)cudaErrorInvalidValue;
  const int nrt = (L + K::kR - 1) / K::kR;
  const int nct = (S + K::kN - 1) / K::kN;
  const int nch = (nct + chunk_tiles - 1) / chunk_tiles;
  float *RA = (float*)row_pa, *RB = (float*)row_pb, *CA = (float*)col_pa,
        *CB = (float*)col_pb;
  dual_softmax_bf16<WR, NJ, NST, 0><<<dim3(nrt, nch, B), kThreads, K::kSmem,
                                      st>>>(
      (const bf16*)f0, (const bf16*)f1, (const float*)m0, (const float*)m1,
      nullptr, nullptr, RA, RB, CA, CB, B, L, S, chunk_tiles, scale);
  stats_combine<<<(B * (L + S) + 63) / 64, 64, 0, st>>>(
      RA, RB, CA, CB, nch, nrt, B, L, S, (float*)rstat, (float*)cstat);
  return (int)cudaGetLastError();
}

// Both passes and their combines: 4 launches.  Scratch: row_pa, row_pb
// [B, nch, L], col_pa, col_pb [B, nrt, S], rstat [2, B, L], cstat [2, B, S]
// (float), nrt = ceil(L/R), nch = ceil(ceil(S/N) / chunk_tiles).
template <int WR, int NJ, int NST>
int launch(const void* f0, const void* f1, const void* m0, const void* m1,
           void* row_pa, void* row_pb, void* col_pa, void* col_pb,
           void* rstat, void* cstat, void* best_val, void* best_j,
           void* colconf, int B, int L, int S, int chunk_tiles, float scale,
           cudaStream_t st) {
  using K = Cfg<WR, NJ, NST>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      dual_softmax_bf16<WR, NJ, NST, 1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
  (void)a1;
  const int err = launch_stats<WR, NJ, NST>(f0, f1, m0, m1, row_pa, row_pb,
                                            col_pa, col_pb, rstat, cstat, B,
                                            L, S, chunk_tiles, scale, st);
  if (err != 0) return err;
  const int nrt = (L + K::kR - 1) / K::kR;
  const int nct = (S + K::kN - 1) / K::kN;
  const int nch = (nct + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid(nrt, nch, B);
  // combines: one thread a row or column, 64 a block so that B = 1's
  // (L + S) threads spread over the SMs
  const int ncomb = (B * (L + S) + 63) / 64;
  float *RA = (float*)row_pa, *CA = (float*)col_pa;
  dual_softmax_bf16<WR, NJ, NST, 1><<<grid, kThreads, K::kSmem, st>>>(
      (const bf16*)f0, (const bf16*)f1, (const float*)m0, (const float*)m1,
      (const float*)rstat, (const float*)cstat, RA, (float*)row_pb, CA,
      (float*)col_pb, B, L, S, chunk_tiles, scale);
  best_combine<<<ncomb, 64, 0, st>>>(RA, (const int*)row_pb, CA, nch, nrt, B,
                                      L, S, (float*)best_val, (int*)best_j,
                                      (float*)colconf);
  return (int)cudaGetLastError();
}

}  // namespace bf
}  // namespace
}  // namespace loftr

// float features (dtype 0; bfloat16 goes to loftr_dual_softmax_bf16).
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: entry below
  return loftr::launch<float>(f0, f1, m0, m1, row_pa, row_pb, col_pa, col_pb,
                              rmax, rsum, cmax, csum, best_val, best_j,
                              colconf, B, L, S, C, chunk_tiles, scale, st);
}

// Pass 1 alone (the focal loss's tile-path statistics): the same inputs
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

// bfloat16, C = 256: f0 [B, L, 256], f1 [B, S, 256], 16-byte aligned;
// m0 [B, L], m1 [B, S] float 0/1, or both null (no masks).  rows x cols:
// the tile shape (R x N); the launcher takes the shapes bf16_plan in
// ops/kernels/dual_softmax.py returns.  Scratch (float): row_pa, row_pb
// [B, nch, L], col_pa, col_pb [B, nrt, S], rstat [2, B, L], cstat
// [2, B, S], with nrt = ceil(L/rows), nch = ceil(ceil(S/cols) /
// chunk_tiles).  Outputs: best_val [B, L], best_j [B, L] int32, colconf
// [B, S].
extern "C" int loftr_dual_softmax_bf16(
    const void* f0, const void* f1, const void* m0, const void* m1,
    void* row_pa, void* row_pb, void* col_pa, void* col_pb, void* rstat,
    void* cstat, void* best_val, void* best_j, void* colconf, int B, int L,
    int S, int C, int rows, int cols, int chunk_tiles, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != loftr::bf::kC || ((uintptr_t)f0 | (uintptr_t)f1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 128 && cols == 128)
    return loftr::bf::launch<4, 8, 2>(f0, f1, m0, m1, row_pa, row_pb, col_pa,
                                      col_pb, rstat, cstat, best_val, best_j,
                                      colconf, B, L, S, chunk_tiles, scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}

// Pass 1 of the bfloat16 path alone (the focal loss's statistics): inputs,
// tile shape and scratch as loftr_dual_softmax_bf16's; outputs rstat =
// [rmax; 1/rsum] [2, B, L] and cstat = [cmax; 1/csum] [2, B, S].
extern "C" int loftr_dual_softmax_bf16_stats(
    const void* f0, const void* f1, const void* m0, const void* m1,
    void* row_pa, void* row_pb, void* col_pa, void* col_pb, void* rstat,
    void* cstat, int B, int L, int S, int C, int rows, int cols,
    int chunk_tiles, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != loftr::bf::kC || ((uintptr_t)f0 | (uintptr_t)f1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 128 && cols == 128)
    return loftr::bf::launch_stats<4, 8, 2>(f0, f1, m0, m1, row_pa, row_pb,
                                            col_pa, col_pb, rstat, cstat, B, L,
                                            S, chunk_tiles, scale, st);
  return (int)cudaErrorInvalidValue;
}
