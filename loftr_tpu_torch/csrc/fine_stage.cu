// Fine stage: the 2-layer fine transformer (self, then sequential cross)
// and the centre-vs-window soft-argmax, one window pair per block.
//
// Replaces loftr_tpu/ops/pallas/fine_stage.py::fused_fine_stage
// (_fine_stage_kernel).
//
// What bounds it on the H100: operations.  Each window pair costs about
// 4 encoder applications x 25 rows x 20*C^2 flop (33 MFLOP at C=128) for
// 2 x 25 x C input values and 3 output floats.  The design keeps both
// windows in shared memory from load to the [NB, 3] result, so device
// memory sees exactly one read of win0/win1.  In bf16 the projections and
// FFN run on the tensor cores (WMMA, float accumulation, weights read from
// L1/L2); the float path runs them on the CUDA cores.
//
// Attention is the score form of linear attention per window and head:
// A = phi(q) phi(k)^T [25 x 25], out = (A v) / (sum A + eps).  Rounding
// follows the JAX kernel's default 'stack' mode: q, k, v, phi(q), phi(k),
// the scores, the message, LN1, the FFN hidden and LN2 are rounded to the
// compute type T where the JAX kernel casts with astype(dt).

#include "common.cuh"

namespace loftr {
namespace {

constexpr int kW2 = 25;           // 5 x 5 window
constexpr int kRows = 2 * kW2;    // both windows of a pair
constexpr int kRowsPad = 64;      // kRows rounded up to whole 16-row tiles
constexpr int kMaxHead = 32;      // largest head width C / nheads taken

struct Layer {
  const void* w;     // packed [q|k|v|merge|mlp0|mlp2], each [in, out], type T
  const float* ln;   // [ln1_s, ln1_b, ln2_s, ln2_b]
};

// GEMM over R rows: on the CUDA-core path the rows-per-thread count follows
// R (both windows, or one); the tensor-core path works in 16-row tiles.
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
  // zero the padding rows too: the tensor-core GEMMs read whole 16-row tiles
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

template <typename T>
int launch(const void* win0, const void* win1, const void* w0,
           const void* ln0, const void* w1, const void* ln1, void* out,
           int NB, int C, int nheads, float eps, cudaStream_t stream) {
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
// [4C], out [NB, 3] float.
extern "C" int loftr_fine_stage(const void* win0, const void* win1,
                                const void* w0, const void* ln0,
                                const void* w1, const void* ln1, void* out,
                                int NB, int C, int nheads, float eps,
                                int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch<__nv_bfloat16>(win0, win1, w0, ln0, w1, ln1, out, NB,
                                        C, nheads, eps, st);
  return loftr::launch<float>(win0, win1, w0, ln0, w1, ln1, out, NB, C,
                              nheads, eps, st);
}
