// Fine stage: the 2-layer fine transformer (self, then sequential cross)
// and the centre-vs-window soft-argmax.
//
// Replaces loftr_tpu/ops/pallas/fine_stage.py::fused_fine_stage
// (_fine_stage_kernel).
//
// What bounds it on the H100: operations.  Each window pair costs about
// 4 encoder applications x 25 rows x 20*C^2 flop (33 MFLOP at C=128) for
// 2 x 25 x C input values and 3 output floats.  Both windows stay in shared
// memory from load to the [NB, 3] result, so device memory sees exactly one
// read of win0/win1.
//
// bfloat16 (the main path; C = 128, 8 heads of d = 16): the kernel takes G
// window pairs a block (G = 1 to 3), laid out as [win0 of the G pairs |
// win1 of the G pairs], so the self layer runs on 50G rows and each cross
// layer on 25G, padded as a whole to 16-row tiles, and every weight slab a
// block streams from L2 (0.98 MB a block) feeds G pairs.  The launcher runs
// G = 1, two blocks an SM, the fastest at every NB measured (launch_bf16).
// The products run on raw mma.sync (mma_tile.cuh): weights go through a
// ring of 32 x 128 k-slabs in shared memory with cp.async, the next GEMM's
// first slabs in flight while the current epilogue runs; warp w
// owns head w's 16 columns of every product, so phi, the rounding, ReLU,
// both LayerNorms (row sums across warps through a small buffer) and the
// residual run on the accumulators.  Attention runs on the tensor cores,
// per window and head in warp `head`: phi(q) [32 x 16] . phi(k)^T [16 x 32],
// the score columns past the window's 25 zeroed, rounded, re-packed as A
// fragments of s . v [32 x 16].  The windows start at any row (ldmatrix
// takes one row address a lane).
//
// float (the exactness check) keeps one window pair a block on the CUDA
// cores, with every GEMM output in a float tile in shared memory.
//
// Attention is the score form of linear attention per window and head:
// A = phi(q) phi(k)^T [25 x 25], out = (A v) / (sum A + eps).  Rounding
// follows the JAX kernel's default 'stack' mode: q, k, v, phi(q), phi(k),
// the scores, the message, LN1, the FFN hidden, LN2 and the residual are
// rounded to the compute type where the JAX kernel casts with astype(dt).

#include "common.cuh"
#include "mma_tile.cuh"

namespace loftr {
namespace {

constexpr int kW2 = 25;           // 5 x 5 window
constexpr int kRows = 2 * kW2;    // both windows of a pair
constexpr int kRowsPad = 64;      // rows of the float path's tiles
constexpr int kMaxHead = 32;      // largest head width C / nheads taken

struct Layer {
  const void* w;     // packed [q|k|v|merge|mlp0|mlp2], each [in, out], type T
  const float* ln;   // [ln1_s, ln1_b, ln2_s, ln2_b]
};

// ---- float: one window pair a block on the CUDA cores ----------------------

// GEMM over R rows; the rows-per-thread count follows R (both windows, or
// one).
template <typename T>
__device__ void gemm_r(const T* A, int lda, int R, int K, const T* W, int ldw,
                       int N, float* out, int ldo) {
  if (R > 32)
    gemm<(kRowsPad + 7) / 8>(A, lda, R, K, W, ldw, N, out, ldo);
  else
    gemm<4>(A, lda, R, K, W, ldw, N, out, ldo);
}

// One LoFTREncoderLayer on rows [xr, xr+R) of XM attending to source rows
// [sr, sr+R); windows of kW2 rows, query window i attends to source window i.
// XM [kRowsPad, 2C] (T): x | message.  T1 [kRowsPad, 2C] (T): phi(k) | v,
// then the FFN hidden.  T2 [kRowsPad, C] (float): GEMM outputs and phi(q).
template <typename T>
__device__ void encoder(T* XM, T* T1, float* T2, int xr, int sr, int R,
                        int C, int nheads, float eps, Layer L) {
  const int C2 = 2 * C, d = C / nheads;
  const T* w = (const T*)L.w;
  const size_t CC = (size_t)C * C;
  gemm_r(XM + sr * C2, C2, R, C, w + CC, C, C, T2, C);           // k
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += kThreads)
    T1[(i / C) * C2 + i % C] = from_f<T>(phi(round_t<T>(T2[i])));
  __syncthreads();
  gemm_r(XM + sr * C2, C2, R, C, w + 2 * CC, C, C, T2, C);       // v
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += kThreads)
    T1[(i / C) * C2 + C + i % C] = from_f<T>(T2[i]);
  __syncthreads();
  gemm_r(XM + xr * C2, C2, R, C, w, C, C, T2, C);                // q
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += kThreads)
    T2[i] = round_t<T>(phi(round_t<T>(T2[i])));
  __syncthreads();
  // score-form attention: one task per (query row, head)
  for (int task = threadIdx.x; task < R * nheads; task += kThreads) {
    const int r = task / nheads, h = task % nheads;
    const int win = r / kW2;
    const float* q = T2 + r * C + h * d;
    const T* kw = T1 + win * kW2 * C2 + h * d;
    float qv[kMaxHead];  // phi(q) of this row and head, read once
#pragma unroll
    for (int a = 0; a < kMaxHead; ++a) qv[a] = a < d ? q[a] : 0.f;
    float s[kW2];
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < kW2; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < kMaxHead; ++a)
        if (a < d) acc = fmaf(qv[a], to_f(kw[j * C2 + a]), acc);
      s[j] = round_t<T>(acc);
      z += s[j];
    }
    const float zinv = 1.f / (z + eps);
    const T* vw = kw + C;
    T* o = XM + (xr + r) * C2 + C + h * d;
    for (int e = 0; e < d; ++e) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kW2; ++j) acc = fmaf(s[j], to_f(vw[j * C2 + e]), acc);
      o[e] = from_f<T>(acc * zinv);
    }
  }
  __syncthreads();
  T* X = XM + xr * C2;
  gemm_r(X + C, C2, R, C, w + 3 * CC, C, C, T2, C);              // merge
  __syncthreads();
  layer_norm_rows(T2, C, R, C, L.ln, L.ln + C, 1e-5f,
                  [&](int r, int c, float y) {
                    X[r * C2 + C + c] = from_f<T>(y);
                  });
  __syncthreads();
  for (int half = 0; half < 2; ++half) {                         // mlp0
    gemm_r(X, C2, R, C2, w + 4 * CC + half * C, C2, C, T2, C);
    __syncthreads();
    for (int i = threadIdx.x; i < R * C; i += kThreads)
      T1[(i / C) * C2 + half * C + i % C] = from_f<T>(fmaxf(T2[i], 0.f));
    __syncthreads();
  }
  gemm_r(T1, C2, R, C2, w + 8 * CC, C, C, T2, C);                // mlp2
  __syncthreads();
  layer_norm_rows(T2, C, R, C, L.ln + 2 * C, L.ln + 3 * C, 1e-5f,
                  [&](int r, int c, float y) {
                    X[r * C2 + c] =
                        from_f<T>(to_f(X[r * C2 + c]) + round_t<T>(y));
                  });
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fine_stage_kernel(const T* __restrict__ win0, const T* __restrict__ win1,
                      Layer L0, Layer L1, float* __restrict__ out, int C,
                      int nheads, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C2 = 2 * C;
  T* XM = (T*)smem_raw;                      // [kRowsPad, 2C]
  T* T1 = XM + kRowsPad * C2;                // [kRowsPad, 2C]
  float* T2 = (float*)(T1 + kRowsPad * C2);  // [kRowsPad, C]
  const size_t g = blockIdx.x;
  const T* a = win0 + g * kW2 * C;
  const T* b = win1 + g * kW2 * C;
  for (int i = threadIdx.x; i < kRowsPad * C2; i += kThreads) {
    const int r = i / C2, c = i % C2;
    float v = 0.f;
    if (c < C && r < kW2) v = to_f(a[r * C + c]);
    else if (c < C && r < kRows) v = to_f(b[(r - kW2) * C + c]);
    XM[i] = from_f<T>(v);
    T1[i] = from_f<T>(0.f);
  }
  __syncthreads();
  encoder<T>(XM, T1, T2, 0, 0, kRows, C, nheads, eps, L0);   // self, both
  encoder<T>(XM, T1, T2, 0, kW2, kW2, C, nheads, eps, L1);   // x0 <- x1
  encoder<T>(XM, T1, T2, kW2, 0, kW2, C, nheads, eps, L1);   // x1 <- new x0

  // soft-argmax: centre of window 0 against every position of window 1
  if (threadIdx.x < 32) {
    const int j = threadIdx.x;
    const T* ctr = XM + (kW2 / 2) * C2;
    float sim = -INFINITY;
    if (j < kW2) {
      const T* x1 = XM + (kW2 + j) * C2;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc = fmaf(to_f(ctr[c]), to_f(x1[c]), acc);
      sim = acc / sqrtf((float)C);
    }
    const float m = warp_max(sim);
    const float e = j < kW2 ? expf(sim - m) : 0.f;
    const float heat = e / warp_sum(e);
    constexpr int w = 5;
    const float gx = j < kW2 ? (float)(j % w) / (w - 1) * 2.f - 1.f : 0.f;
    const float gy = j < kW2 ? (float)(j / w) / (w - 1) * 2.f - 1.f : 0.f;
    const float cx = warp_sum(heat * gx);
    const float cy = warp_sum(heat * gy);
    const float ex2 = warp_sum(heat * gx * gx);
    const float ey2 = warp_sum(heat * gy * gy);
    if (j == 0) {
      out[g * 3 + 0] = cx;
      out[g * 3 + 1] = cy;
      out[g * 3 + 2] = sqrtf(fmaxf(ex2 - cx * cx, 1e-10f)) +
                       sqrtf(fmaxf(ey2 - cy * cy, 1e-10f));
    }
  }
}

// ---- bfloat16: G window pairs a block on mma.sync (mma_tile.cuh) ---------
using mma::bf16;
constexpr int kC = 128, kD = 16, kNH = kC / kD;  // warp w owns head w
constexpr int kLdX = 2 * kC + 8;  // padded [rows, 2C] bf16 row (elements)
constexpr int kRing = 4;          // weight ring stages

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

template <int G>
struct Pairs {
  static constexpr int kMTs = (2 * kW2 * G + 15) / 16;  // self rows, tiles
  static constexpr int kMTc = (kW2 * G + 15) / 16;      // cross rows, tiles
  // rows of XM and T1: every 16-row GEMM tile (the second cross layer's
  // start at 25G) and every 32-row window tile of the attention
  static constexpr int kBufRows = cmax(cmax(16 * kMTs, kW2 * G + 16 * kMTc),
                                    kW2 * (2 * G - 1) + 32);
  static constexpr size_t kSmem =
      (size_t)2 * kBufRows * kLdX * sizeof(bf16) +
      (size_t)kRing * mma::stage_elems<kC>() * sizeof(bf16) +
      (size_t)2 * 8 * 16 * kMTs * sizeof(float);
};

// Score-form linear attention of head `warp` on nw windows of 25 rows:
// phi(q) rows Q, phi(k) rows K, v rows V (row stride kLdX, the head's 16
// columns).  The rounded message overwrites phi(q): window i reads rows
// [25i, 25i + 32) and writes rows [25i, 25i + 25), so no later window's
// rows change before it reads them.
__device__ __forceinline__ void window_attention(bf16* Q, const bf16* K,
                                                 const bf16* V, int nw,
                                                 float eps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int i = 0; i < nw; ++i) {
    bf16* Qw = Q + i * kW2 * kLdX;
    const bf16* Kw = K + i * kW2 * kLdX;
    const bf16* Vw = V + i * kW2 * kLdX;
    // A: phi(q) rows 0-15 | 16-31; B: phi(k) rows as columns, keys
    // (0-7 | 8-15) x dims (0-7 | 8-15) of each 16-key half
    uint32_t qa[2][4], kb[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      mma::ldmatrix_x4(qa[t], Qw + (t * 16 + (lane & 15)) * kLdX +
                                  (lane >> 4) * 8);
      mma::ldmatrix_x4(kb[t], Kw + (t * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       kLdX + ((lane >> 3) & 1) * 8);
    }
    float s[2][4][4] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma::mma_bf16(s[mt][j], qa[mt], kb[j >> 1][(j & 1) * 2],
                      kb[j >> 1][(j & 1) * 2 + 1]);
    // rows 25-31 of the key tile belong to the next window or to padding:
    // their score columns are zero (not phi(0) = 1), out of z and of s v
    float z[2][2] = {};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = 8 * j + 2 * q + (e & 1) < kW2
                              ? mma::round_bf16(s[mt][j][e]) : 0.f;
          s[mt][j][e] = v;
          z[mt][e >> 1] += v;
        }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t = z[mt][h];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        z[mt][h] = 1.f / (t + eps);
      }
    // out = s v: the rounded scores re-packed as A fragments (k = key),
    // v rows read transposed as B
    float o[2][2][4] = {};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      uint32_t vb[4];
      mma::ldmatrix_x4_trans(
          vb, Vw + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdX +
                  (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t sa[4] = {
            mma::pack_bf16(s[mt][2 * t][0], s[mt][2 * t][1]),
            mma::pack_bf16(s[mt][2 * t][2], s[mt][2 * t][3]),
            mma::pack_bf16(s[mt][2 * t + 1][0], s[mt][2 * t + 1][1]),
            mma::pack_bf16(s[mt][2 * t + 1][2], s[mt][2 * t + 1][3])};
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
          mma::mma_bf16(o[mt][jn], sa, vb[2 * jn], vb[2 * jn + 1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= kW2) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
          mma::st_pair(Qw + r * kLdX + jn * 8 + 2 * q,
                       o[mt][jn][2 * h] * z[mt][h],
                       o[mt][jn][2 * h + 1] * z[mt][h]);
      }
  }
}

// acc + the dot product of two pairs of bf16 (32-bit words, low half first)
__device__ __forceinline__ float dot_bf16x2(uint32_t a, uint32_t b,
                                            float acc) {
  acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
  return fmaf(__uint_as_float(a & 0xffff0000u),
              __uint_as_float(b & 0xffff0000u), acc);
}

// One LoFTREncoderLayer on the nw windows of x rows [xr, xr + 25 nw) of XM,
// window i attending to source window i at rows sr + 25i; MT 16-row tiles
// cover either.  XM [*, kLdX]: x | message (phi(q), then the message, then
// LN1).  T1 [*, kLdX]: phi(k) | v of the source tiles, then the FFN hidden.
// On entry this layer's k slabs are in flight; on exit those of `next`
// (the next layer's weights, or none).
template <int MT>
__device__ void encoder_bf16(bf16* XM, bf16* T1, bf16* ring, float* red,
                             int xr, int sr, int nw, const bf16* w,
                             const float* ln, const bf16* next, float eps) {
  constexpr int NST = kRing;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int col = warp * kD + 2 * q;   // + 8j: this thread's columns
  const int nx = kW2 * nw;             // rows of x written back
  const size_t CC = (size_t)kC * kC;
  bf16* X = XM + xr * kLdX;
  const bf16* S = XM + sr * kLdX;
  float acc[MT][2][4];

  mma::ring_gemm<MT, NST, kC>(S, kLdX, kC, w + CC, kC, ring, acc);       // k
  __syncthreads();
  mma::ring_prefetch<NST, kC>(w + 2 * CC, kC, kC, ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma::st_pair(T1 + (mt * 16 + g + 8 * h) * kLdX + col + 8 * j,
                     phi(mma::round_bf16(acc[mt][j][2 * h])),
                     phi(mma::round_bf16(acc[mt][j][2 * h + 1])));
  mma::ring_gemm<MT, NST, kC>(S, kLdX, kC, w + 2 * CC, kC, ring, acc);   // v
  __syncthreads();
  mma::ring_prefetch<NST, kC>(w, kC, kC, ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma::st_pair(T1 + (mt * 16 + g + 8 * h) * kLdX + kC + col + 8 * j,
                     acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  mma::ring_gemm<MT, NST, kC>(X, kLdX, kC, w, kC, ring, acc);            // q
  __syncthreads();
  mma::ring_prefetch<NST, kC>(w + 3 * CC, kC, kC, ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma::st_pair(X + (mt * 16 + g + 8 * h) * kLdX + kC + col + 8 * j,
                     phi(mma::round_bf16(acc[mt][j][2 * h])),
                     phi(mma::round_bf16(acc[mt][j][2 * h + 1])));
  __syncwarp();   // the warp reads back only its own head's columns
  window_attention(X + kC + warp * kD, T1 + warp * kD, T1 + kC + warp * kD,
                   nw, eps);
  mma::ring_gemm<MT, NST, kC>(X + kC, kLdX, kC, w + 3 * CC, kC, ring,
                              acc);                                    // merge
  __syncthreads();
  mma::ring_prefetch<NST, kC>(w + 4 * CC, 2 * kC, 2 * kC, ring);
  mma::layer_norm_acc<MT, kC>(acc, ln, ln + kC, red,
                              [&](int r, int c, float y0, float y1) {
                                mma::st_pair(X + r * kLdX + kC + c, y0, y1);
                              });
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {                     // mlp0, by halves
    mma::ring_gemm<MT, NST, kC>(X, kLdX, 2 * kC, w + 4 * CC + half * kC,
                                2 * kC, ring, acc);
    __syncthreads();
    if (half == 0)
      mma::ring_prefetch<NST, kC>(w + 4 * CC + kC, 2 * kC, 2 * kC, ring);
    else
      mma::ring_prefetch<NST, kC>(w + 8 * CC, kC, 2 * kC, ring);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma::st_pair(T1 + (mt * 16 + g + 8 * h) * kLdX + half * kC + col +
                           8 * j,
                       fmaxf(acc[mt][j][2 * h], 0.f),
                       fmaxf(acc[mt][j][2 * h + 1], 0.f));
  }
  mma::ring_gemm<MT, NST, kC>(T1, kLdX, 2 * kC, w + 8 * CC, kC, ring,
                              acc);                                    // mlp2
  __syncthreads();
  if (next != nullptr) mma::ring_prefetch<NST, kC>(next + CC, kC, kC, ring);
  // LN2 rounded, plus the residual; only the layer's own x rows (in the
  // first cross layer, the tiles past 25G are the other window's rows)
  mma::layer_norm_acc<MT, kC>(
      acc, ln + 2 * kC, ln + 3 * kC, red,
      [&](int r, int c, float y0, float y1) {
        if (r >= nx) return;
        bf16* xr_ = X + r * kLdX + c;
        mma::st_pair(xr_, __bfloat162float(xr_[0]) + mma::round_bf16(y0),
                     __bfloat162float(xr_[1]) + mma::round_bf16(y1));
      });
}

template <int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 2 : 1)
    fine_stage_bf16(const bf16* __restrict__ win0,
                    const bf16* __restrict__ win1,
                    const bf16* __restrict__ w0, const float* __restrict__ ln0,
                    const bf16* __restrict__ w1, const float* __restrict__ ln1,
                    float* __restrict__ out, int NB, float eps) {
  using P = Pairs<G>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* XM = (bf16*)smem_raw;               // [kBufRows, kLdX]
  bf16* T1 = XM + P::kBufRows * kLdX;       // [kBufRows, kLdX]
  bf16* ring = T1 + P::kBufRows * kLdX;
  float* red = (float*)(ring + kRing * mma::stage_elems<kC>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * G, np = min(G, NB - p0);
  const int n = kW2 * np;                   // rows of one side
  // XM rows [0, n): win0 of the pairs, [n, 2n): win1, by cp.async (joining
  // the first ring group); zeros elsewhere, so padding rows stay finite
  const bf16* a = win0 + (size_t)p0 * kW2 * kC;
  const bf16* b = win1 + (size_t)p0 * kW2 * kC;
  for (int idx = threadIdx.x; idx < P::kBufRows * (kLdX / 8);
       idx += kThreads) {
    const int r = idx / (kLdX / 8), c = (idx % (kLdX / 8)) * 8;
    if (c < kC && r < 2 * n)
      mma::cp_async16(XM + r * kLdX + c,
                      (r < n ? a + (size_t)r * kC : b + (size_t)(r - n) * kC) +
                          c);
    else
      *reinterpret_cast<uint4*>(XM + r * kLdX + c) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(T1 + r * kLdX + c) = make_uint4(0, 0, 0, 0);
  }
  mma::ring_prefetch<kRing, kC>(w0 + (size_t)kC * kC, kC, kC, ring);
  encoder_bf16<P::kMTs>(XM, T1, ring, red, 0, 0, 2 * np, w0, ln0, w1,
                        eps);                                  // self, both
  encoder_bf16<P::kMTc>(XM, T1, ring, red, 0, n, np, w1, ln1, w1,
                        eps);                                  // x0 <- x1
  encoder_bf16<P::kMTc>(XM, T1, ring, red, n, 0, np, w1, ln1, nullptr,
                        eps);                                  // x1 <- new x0
  __syncthreads();

  // soft-argmax of pair p (warp p): centre of window 0 against window 1
  for (int p = warp; p < np; p += kThreads / 32) {
    const bf16* ctr = XM + (p * kW2 + kW2 / 2) * kLdX;
    const int j = lane;
    float sim = -INFINITY;
    if (j < kW2) {
      const bf16* x1 = XM + (n + p * kW2 + j) * kLdX;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < kC; c += 8) {   // 16-byte rows: no bank conflicts
        const uint4 u = *reinterpret_cast<const uint4*>(ctr + c);
        const uint4 v = *reinterpret_cast<const uint4*>(x1 + c);
        acc = dot_bf16x2(u.y, v.y, dot_bf16x2(u.x, v.x, acc));
        acc = dot_bf16x2(u.w, v.w, dot_bf16x2(u.z, v.z, acc));
      }
      sim = acc / sqrtf((float)kC);
    }
    const float m = warp_max(sim);
    const float e = j < kW2 ? expf(sim - m) : 0.f;
    const float heat = e / warp_sum(e);
    constexpr int w = 5;
    const float gx = j < kW2 ? (float)(j % w) / (w - 1) * 2.f - 1.f : 0.f;
    const float gy = j < kW2 ? (float)(j / w) / (w - 1) * 2.f - 1.f : 0.f;
    const float cx = warp_sum(heat * gx);
    const float cy = warp_sum(heat * gy);
    const float ex2 = warp_sum(heat * gx * gx);
    const float ey2 = warp_sum(heat * gy * gy);
    if (j == 0) {
      float* o = out + (size_t)(p0 + p) * 3;
      o[0] = cx;
      o[1] = cy;
      o[2] = sqrtf(fmaxf(ex2 - cx * cx, 1e-10f)) +
             sqrtf(fmaxf(ey2 - cy * cy, 1e-10f));
    }
  }
}

template <int G>
void launch_pairs(const void* win0, const void* win1, const void* w0,
                  const void* ln0, const void* w1, const void* ln1, void* out,
                  int NB, float eps, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fine_stage_bf16<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Pairs<G>::kSmem);
  (void)attr;
  fine_stage_bf16<G><<<(NB + G - 1) / G, kThreads, Pairs<G>::kSmem,
                       stream>>>(
      (const bf16*)win0, (const bf16*)win1, (const bf16*)w0,
      (const float*)ln0, (const bf16*)w1, (const float*)ln1, (float*)out, NB,
      eps);
}

// One window pair a block, two blocks an SM.  Blocks of 2 or 3 pairs (one
// an SM: shared memory) were no faster at any NB measured: at one pair two
// blocks share each SM and stream weights from L2 at about 3.5 TB/s; at
// three, 8 warps an SM leave the ring and the products waiting on latency,
// at the same pair rate (PERF.md, the table of tools/fine_group_sweep.py).
int launch_bf16(const void* win0, const void* win1, const void* w0,
                const void* ln0, const void* w1, const void* ln1, void* out,
                int NB, int C, int nheads, float eps, cudaStream_t stream) {
  if (C != kC || nheads != kNH) return (int)cudaErrorInvalidValue;
  if (NB > 0)
    launch_pairs<1>(win0, win1, w0, ln0, w1, ln1, out, NB, eps, stream);
  return (int)cudaGetLastError();
}

int launch_f32(const void* win0, const void* win1, const void* w0,
               const void* ln0, const void* w1, const void* ln1, void* out,
               int NB, int C, int nheads, float eps, cudaStream_t stream) {
  using T = float;
  const size_t smem =
      (size_t)kRowsPad * C * (4 * sizeof(T) + sizeof(float));
  cudaFuncSetAttribute(fine_stage_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (NB > 0)
    fine_stage_kernel<T><<<NB, kThreads, smem, stream>>>(
        (const T*)win0, (const T*)win1, Layer{w0, (const float*)ln0},
        Layer{w1, (const float*)ln1}, (float*)out, C, nheads, eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace loftr

// win0/win1 [NB, 25, C] (T), w0/w1 packed layer weights (T), ln0/ln1 float
// [4C], out [NB, 3] float.  bfloat16 takes C = 128 with 8 heads only.
extern "C" int loftr_fine_stage(const void* win0, const void* win1,
                                const void* w0, const void* ln0,
                                const void* w1, const void* ln1, void* out,
                                int NB, int C, int nheads, float eps,
                                int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch_bf16(win0, win1, w0, ln0, w1, ln1, out, NB, C,
                              nheads, eps, st);
  return loftr::launch_f32(win0, win1, w0, ln0, w1, ln1, out, NB, C, nheads,
                           eps, st);
}
