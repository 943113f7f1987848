// Coarse encoder layer: one LoFTREncoderLayer application (linear
// attention) in three launches.
//
// Replaces loftr_tpu/ops/pallas/coarse_layer.py::fused_coarse_layer
// (_kv_kernel and _apply_kernel).
//
// What bounds it on the H100: operations.  The projections and FFN cost
// about 20*C^2 flop per row against 2*C bytes of bf16 activations in and
// out; the weights (10*C^2 values) stay in L2.  Rows stay in shared memory
// from load to store, so the [B, L, C] activations cross device memory once
// each way.  In bf16 the products run on the tensor cores (WMMA, float
// accumulation); the float path (the exactness check) runs on the CUDA
// cores.  The attention itself (per-head KV apply, normaliser) is CUDA-core
// work of C*d flop per row.
//
// The TPU kernel sums KV and ksum over a sequential grid.  CUDA blocks run
// in no order, so pass 1 writes one partial per source tile, a second small
// kernel sums them in a fixed order (deterministic, no float atomics), and
// pass 3 applies the layer to row tiles.
//
// Rounding follows the JAX kernel: phi(k), v/S, phi(q), KV, the per-channel
// phi(q)*ksum terms, the message, LN1 and the FFN hidden are rounded to the
// compute type T where the JAX kernel casts with astype(dt).

#include "common.cuh"

namespace loftr {
namespace {

constexpr int kTileS = 32;  // source rows per KV-partial block
constexpr int kTileL = 32;  // x rows per apply block

// Packed weights, each [in, out] row-major:
//   q @ 0, k @ C^2, v @ 2C^2, merge @ 3C^2, mlp0 [2C,2C] @ 4C^2,
//   mlp2 [2C,C] @ 8C^2.   ln = [ln1_s, ln1_b, ln2_s, ln2_b] float, 4C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    kv_partial_kernel(const T* __restrict__ src, const float* __restrict__ smask,
                      const T* __restrict__ w, float* __restrict__ kv_part,
                      float* __restrict__ ks_part, int S, int C, int nheads) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Xs = (T*)smem_raw;                // [kTileS, C] GEMM operand
  float* Ks = (float*)(Xs + kTileS * C);  // [kTileS, C]
  float* Vs = Ks + kTileS * C;         // [kTileS, C]
  float* ms = Vs + kTileS * C;         // [kTileS]
  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int s0 = tile * kTileS;
  const int rows = min(kTileS, S - s0);
  const T* srcb = src + ((size_t)b * S + s0) * C;
  for (int i = threadIdx.x; i < kTileS * C; i += kThreads) {
    const int r = i / C;
    Xs[i] = r < rows ? srcb[i] : from_f<T>(0.f);
  }
  for (int r = threadIdx.x; r < kTileS; r += kThreads)
    ms[r] = r < rows ? smask[(size_t)b * S + s0 + r] : 0.f;
  __syncthreads();
  const size_t CC = (size_t)C * C;
  gemm<kTileS / 8>(Xs, C, kTileS, C, w + CC, C, C, Ks, C);
  gemm<kTileS / 8>(Xs, C, kTileS, C, w + 2 * CC, C, C, Vs, C);
  __syncthreads();
  const float inv_s = 1.f / S;
  float* ksb = ks_part + ((size_t)b * ntiles + tile) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < kTileS; ++r) {
      const float m = ms[r];
      const float K = phi(Ks[r * C + c]) * m;          // float, unrounded
      sum += K;
      Ks[r * C + c] = round_t<T>(K);
      Vs[r * C + c] = round_t<T>(Vs[r * C + c] * (m * inv_s));
    }
    ksb[c] = sum;
  }
  __syncthreads();
  // per-head diagonal blocks of phi(K)^T (V/S): kv[c][e], c in head c/d
  const int d = C / nheads;
  float* kvb = kv_part + ((size_t)b * ntiles + tile) * C * d;
  for (int idx = threadIdx.x; idx < C * d; idx += kThreads) {
    const int c = idx / d, e = idx % d;
    const int ve = (c / d) * d + e;
    float acc = 0.f;
    for (int r = 0; r < kTileS; ++r)
      acc = fmaf(Ks[r * C + c], Vs[r * C + ve], acc);
    kvb[idx] = acc;
  }
}

// kv[b][i] = sum over tiles of kv_part[b][tile][i], in tile order.
__global__ void kv_reduce_kernel(const float* __restrict__ kv_part,
                                 const float* __restrict__ ks_part,
                                 float* __restrict__ kv, float* __restrict__ ks,
                                 int ntiles, int n_kv, int C) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_kv) {
    const float* p = kv_part + (size_t)b * ntiles * n_kv + i;
    float acc = 0.f;
    for (int t = 0; t < ntiles; ++t) acc += p[(size_t)t * n_kv];
    kv[(size_t)b * n_kv + i] = acc;
  } else if (i < n_kv + C) {
    const int c = i - n_kv;
    const float* p = ks_part + (size_t)b * ntiles * C + c;
    float acc = 0.f;
    for (int t = 0; t < ntiles; ++t) acc += p[(size_t)t * C];
    ks[(size_t)b * C + c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const float* __restrict__ xmask,
                 const float* __restrict__ kv, const float* __restrict__ ksum,
                 const T* __restrict__ w, const float* __restrict__ ln,
                 T* __restrict__ out, int L, int S, int C, int nheads,
                 float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C2 = 2 * C, d = C / nheads;
  // GEMM operands first (32-byte aligned tiles), then float buffers
  T* XM = (T*)smem_raw;                // [kTileL, 2C]: x | LN1(message)
  T* T1 = XM + kTileL * C2;            // [kTileL, 2C]: message, FFN hidden
  float* T2 = (float*)(T1 + kTileL * C2);  // [kTileL, C]: GEMM outputs
  float* KVs = T2 + kTileL * C;        // [C, d] rounded to T
  float* kss = KVs + C * d;            // [C]
  float* mrow = kss + C;               // [kTileL]
  float* den = mrow + kTileL;          // [kTileL, nheads]
  const int b = blockIdx.y, l0 = blockIdx.x * kTileL;
  const int rows = min(kTileL, L - l0);
  const T* xb = x + ((size_t)b * L + l0) * C;
  for (int i = threadIdx.x; i < kTileL * C; i += kThreads) {
    const int r = i / C, c = i % C;
    XM[r * C2 + c] = r < rows ? xb[i] : from_f<T>(0.f);
  }
  for (int r = threadIdx.x; r < kTileL; r += kThreads)
    mrow[r] = r < rows ? xmask[(size_t)b * L + l0 + r] : 0.f;
  for (int i = threadIdx.x; i < C * d; i += kThreads)
    KVs[i] = round_t<T>(kv[(size_t)b * C * d + i]);
  for (int c = threadIdx.x; c < C; c += kThreads)
    kss[c] = ksum[(size_t)b * C + c];
  __syncthreads();

  const size_t CC = (size_t)C * C;
  constexpr int RPT = kTileL / 8;
  gemm<RPT>(XM, C2, kTileL, C, w, C, C, T2, C);                // q
  __syncthreads();
  for (int i = threadIdx.x; i < kTileL * C; i += kThreads)
    T2[i] = round_t<T>(phi(T2[i]) * mrow[i / C]);            // masked phi(q)
  __syncthreads();
  for (int i = threadIdx.x; i < kTileL * nheads; i += kThreads) {
    const int r = i / nheads, h = i % nheads;
    float acc = 0.f;
    for (int a = 0; a < d; ++a)
      acc += round_t<T>(T2[r * C + h * d + a] * kss[h * d + a]);
    den[i] = acc;
  }
  __syncthreads();
  const float s_len = (float)S;
  for (int i = threadIdx.x; i < kTileL * C; i += kThreads) {
    const int r = i / C, c = i % C, h = c / d, e = c % d;
    const float* q = T2 + r * C + h * d;
    const float* kvh = KVs + h * d * d + e;
    float acc = 0.f;
    for (int a = 0; a < d; ++a) acc = fmaf(q[a], kvh[a * d], acc);
    T1[r * C2 + c] = from_f<T>(acc * (s_len / (den[r * nheads + h] + eps)));
  }
  __syncthreads();
  gemm<RPT>(T1, C2, kTileL, C, w + 3 * CC, C, C, T2, C);     // merge
  __syncthreads();
  layer_norm_rows(T2, C, kTileL, C, ln, ln + C, 1e-5f,
                  [&](int r, int c, float y) {
                    XM[r * C2 + C + c] = from_f<T>(y);
                  });
  __syncthreads();
  for (int half = 0; half < 2; ++half) {                     // mlp0, by halves
    gemm<RPT>(XM, C2, kTileL, C2, w + 4 * CC + half * C, C2, C, T2, C);
    __syncthreads();
    for (int i = threadIdx.x; i < kTileL * C; i += kThreads)
      T1[(i / C) * C2 + half * C + i % C] = from_f<T>(fmaxf(T2[i], 0.f));
    __syncthreads();
  }
  gemm<RPT>(T1, C2, kTileL, C2, w + 8 * CC, C, C, T2, C);    // mlp2
  __syncthreads();
  T* ob = out + ((size_t)b * L + l0) * C;
  layer_norm_rows(T2, C, rows, C, ln + 2 * C, ln + 3 * C, 1e-5f,
                  [&](int r, int c, float y) {
                    ob[(size_t)r * C + c] = from_f<T>(to_f(XM[r * C2 + c]) + y);
                  });
}

template <typename T>
int launch(const void* x, const void* xmask, const void* src,
           const void* smask, const void* w, const void* ln, void* kv_part,
           void* ks_part, void* kv, void* ksum, void* out, int B, int L, int S,
           int C, int nheads, float eps, cudaStream_t stream) {
  const int d = C / nheads;
  const int ntiles = (S + kTileS - 1) / kTileS;
  const size_t smem_kv =
      (2 * kTileS * C + kTileS) * sizeof(float) + kTileS * C * sizeof(T);
  const size_t smem_ap =
      (kTileL * C + C * d + C + kTileL + kTileL * nheads) * sizeof(float) +
      2 * kTileL * 2 * C * sizeof(T);
  cudaFuncSetAttribute(kv_partial_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_kv);
  cudaFuncSetAttribute(apply_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_ap);
  kv_partial_kernel<T><<<dim3(ntiles, B), kThreads, smem_kv, stream>>>(
      (const T*)src, (const float*)smask, (const T*)w, (float*)kv_part,
      (float*)ks_part, S, C, nheads);
  const int n_kv = C * d;
  kv_reduce_kernel<<<dim3((n_kv + C + 255) / 256, B), 256, 0, stream>>>(
      (const float*)kv_part, (const float*)ks_part, (float*)kv, (float*)ksum,
      ntiles, n_kv, C);
  apply_kernel<T><<<dim3((L + kTileL - 1) / kTileL, B), kThreads, smem_ap,
                    stream>>>((const T*)x, (const float*)xmask,
                              (const float*)kv, (const float*)ksum,
                              (const T*)w, (const float*)ln, (T*)out, L, S, C,
                              nheads, eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace loftr

// Scratch sizes (float): kv_part [B, ceil(S/32), C, C/nheads],
// ks_part [B, ceil(S/32), C], kv [B, C, C/nheads], ksum [B, C].
extern "C" int loftr_coarse_layer(const void* x, const void* xmask,
                                  const void* src, const void* smask,
                                  const void* w, const void* ln,
                                  void* kv_part, void* ks_part, void* kv,
                                  void* ksum, void* out, int B, int L, int S,
                                  int C, int nheads, float eps, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch<__nv_bfloat16>(x, xmask, src, smask, w, ln, kv_part,
                                        ks_part, kv, ksum, out, B, L, S, C,
                                        nheads, eps, st);
  return loftr::launch<float>(x, xmask, src, smask, w, ln, kv_part, ks_part,
                              kv, ksum, out, B, L, S, C, nheads, eps, st);
}
