// Per-window linear attention in score form, one window per block.
//
// Replaces loftr_tpu/ops/pallas/window_attention.py::window_linear_attention
// (_window_attn_kernel).
//
// For q, k, v [NB, W2, C] with C = nheads * d, per window and head:
//   Q = phi(q), K = phi(k)   (phi = elu + 1 in float, rounded back to T)
//   A = Q K^T                [W2 x W2], float accumulation
//   z = 1 / (rowsum(A) + eps)          (float, from the unrounded scores)
//   out = (round_T(A) V) * z           (float accumulation), stored as T
// which equals linear attention over the window (the reference's v / S and
// * S cancel, and its eps lands on the same denominator).
//
// What bounds it on the H100: bytes (q, k, v read once and out written
// once, 4 * NB * W2 * C values; 2 * 2 * W2 * W2 * C flop a window is far
// below the operation bound).  The TPU kernel packs 16 windows into one
// tile and masks the score matrix block-diagonally to fill its matrix
// unit; here one window (W2 x C, 6.4 KB in bf16 for each of q, k, v) sits
// in shared memory, the score form is kept (the same rounding points as
// the TPU kernel), and one thread owns one (query row, head): its W2
// scores stay in registers.  Threads of a warp share a head, so their K
// and V reads are shared-memory broadcasts, taken two values at a time.
// q, k, v arrive and the result leaves in 16-byte accesses; the result is
// staged over Q.  The fine stage's size (5 x 5 windows, heads of 16) is
// compiled with its loop bounds fixed, which removes the predicated
// no-ops of the general version (bounds 32 and 32, checked at run time).

#include "common.cuh"

namespace loftr {
namespace {

constexpr int kMaxW2 = 32;    // largest window (rows) taken
constexpr int kMaxHead = 32;  // largest head width C / nheads taken
constexpr int kFineW2 = 25;   // the fine stage's 5 x 5 window

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Needs W2 * C * sizeof(T) to be a multiple of 16 and C / nheads even.
// EXACT: the window has BW2 rows and the heads BD columns (loop bounds
// known to the compiler); otherwise BW2 and BD are upper bounds.
template <typename T, int BW2, int BD, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    window_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int W2_arg, int C, int nheads, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);  // values in one 16-byte access
  const int W2 = EXACT ? BW2 : W2_arg;
  const int n = W2 * C;
  T* Q = (T*)smem_raw;  // phi(q), then the output
  T* K = Q + n;         // phi(k)
  T* V = K + n;
  const size_t base = (size_t)blockIdx.x * n;
  const uint4* q4 = reinterpret_cast<const uint4*>(q + base);
  const uint4* k4 = reinterpret_cast<const uint4*>(k + base);
  const uint4* v4 = reinterpret_cast<const uint4*>(v + base);
  for (int i = threadIdx.x; i < n / kVec; i += kThreads) {
    uint4 a = q4[i], b = k4[i];
    T* ap = reinterpret_cast<T*>(&a);
    T* bp = reinterpret_cast<T*>(&b);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ap[e] = from_f<T>(phi(to_f(ap[e])));
      bp[e] = from_f<T>(phi(to_f(bp[e])));
    }
    reinterpret_cast<uint4*>(Q)[i] = a;
    reinterpret_cast<uint4*>(K)[i] = b;
    reinterpret_cast<uint4*>(V)[i] = v4[i];
  }
  __syncthreads();
  const int d = EXACT ? BD : C / nheads;
  for (int task = threadIdx.x; task < W2 * nheads; task += kThreads) {
    const int h = task / W2, r = task % W2;
    T* qrow = Q + r * C + h * d;  // read here, then overwritten by this task
    const T* kh = K + h * d;
    const T* vh = V + h * d;
    float qv[BD];
#pragma unroll
    for (int a = 0; a < BD; ++a) qv[a] = a < d ? to_f(qrow[a]) : 0.f;
    float s[BW2];
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < BW2; ++j) {
      float acc = 0.f;
      if (j < W2) {
#pragma unroll
        for (int a = 0; a < BD; a += 2)
          if (a < d) {
            const float2 kk = load2(kh + j * C + a);
            acc = fmaf(qv[a], kk.x, acc);
            acc = fmaf(qv[a + 1], kk.y, acc);
          }
      }
      z += acc;
      s[j] = round_t<T>(acc);
    }
    const float zinv = 1.f / (z + eps);
    for (int e = 0; e < d; e += 2) {
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < BW2; ++j)
        if (j < W2) {
          const float2 vv = load2(vh + j * C + e);
          acc0 = fmaf(s[j], vv.x, acc0);
          acc1 = fmaf(s[j], vv.y, acc1);
        }
      store2(qrow + e, acc0 * zinv, acc1 * zinv);
    }
  }
  __syncthreads();
  uint4* o4 = reinterpret_cast<uint4*>(out + base);
  for (int i = threadIdx.x; i < n / kVec; i += kThreads)
    o4[i] = reinterpret_cast<const uint4*>(Q)[i];
}

template <typename T, int BW2, int BD, bool EXACT>
int launch_as(const void* q, const void* k, const void* v, void* out, int NB,
              int W2, int C, int nheads, float eps, cudaStream_t st) {
  const size_t smem = (size_t)3 * W2 * C * sizeof(T);
  auto kernel = window_attn_kernel<T, BW2, BD, EXACT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (NB > 0)
    kernel<<<NB, kThreads, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                       (T*)out, W2, C, nheads, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int NB,
           int W2, int C, int nheads, float eps, cudaStream_t st) {
  const int d = C / nheads;
  if (W2 == kFineW2 && d == 16)
    return launch_as<T, kFineW2, 16, true>(q, k, v, out, NB, W2, C, nheads,
                                           eps, st);
  return launch_as<T, kMaxW2, kMaxHead, false>(q, k, v, out, NB, W2, C,
                                               nheads, eps, st);
}

}  // namespace
}  // namespace loftr

// q, k, v, out [NB, W2, C] (T), W2 <= 32, C / nheads <= 32 and even,
// W2 * C * sizeof(T) a multiple of 16.
extern "C" int loftr_window_attention(const void* q, const void* k,
                                      const void* v, void* out, int NB, int W2,
                                      int C, int nheads, float eps, int dtype,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch<__nv_bfloat16>(q, k, v, out, NB, W2, C, nheads, eps,
                                        st);
  return loftr::launch<float>(q, k, v, out, NB, W2, C, nheads, eps, st);
}
