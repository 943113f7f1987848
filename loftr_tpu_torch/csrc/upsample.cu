// x2 align-corners bilinear upsample of NCHW maps, one fused gather pass.
//
// Replaces loftr_tpu/ops/pallas/upsample.py::upsample2x_pallas
// (_upsample_kernel).
//
// The function is the two interpolation products of ops/interpolate.py
// (H pass, then W pass) with two-tap weights cast to the activation type,
// float accumulation and the intermediate rounded to T:
//   t(oy, x)   = round_T(a_lo[oy] x[y_lo[oy], x] + a_hi[oy] x[y_hi[oy], x])
//   y(oy, ox)  = round_T(b_lo[ox] t(oy, x_lo[ox]) + b_hi[ox] t(oy, x_hi[ox]))
// The TPU kernel forms both as dense [2N, N] matrix products to feed its
// matrix unit; only two entries of each matrix row are non-zero, so here
// each output element gathers its 2 x 2 taps and no zero product is formed.
// The tap tables (index and weight, already rounded to T) come from the
// host, so the weights are bit for bit those of the plain version.
//
// What bounds it on the H100: bytes (the input read once, four times as
// many values written).  A thread row owns one output row (its y taps are
// read once) and each thread writes two neighbouring outputs in one store,
// so the stores coalesce, neighbouring threads share their loads in L1 and
// no per-element index division is left.

#include "common.cuh"

namespace loftr {
namespace {

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// blockDim = (bx, by): thread row ty of block blk owns output row
// blk * by + ty of the [BC * 2H] rows; its bx threads walk the row's W
// output pairs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample2x_kernel(const T* __restrict__ x, const int* __restrict__ ylo,
                      const int* __restrict__ yhi,
                      const float* __restrict__ alo,
                      const float* __restrict__ ahi,
                      const int* __restrict__ xlo, const int* __restrict__ xhi,
                      const float* __restrict__ blo,
                      const float* __restrict__ bhi, T* __restrict__ out,
                      int H, int W, int rows) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int H2 = 2 * H;
  const int oy = row % H2;
  const T* p = x + (size_t)(row / H2) * H * W;
  const T* r0 = p + (size_t)ylo[oy] * W;
  const T* r1 = p + (size_t)yhi[oy] * W;
  const float a0 = alo[oy], a1 = ahi[oy];
  T* o = out + (size_t)row * 2 * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ox = 2 * k + e;
      const int x0 = xlo[ox], x1 = xhi[ox];
      const float t0 = round_t<T>(fmaf(a1, to_f(r1[x0]), a0 * to_f(r0[x0])));
      const float t1 = round_t<T>(fmaf(a1, to_f(r1[x1]), a0 * to_f(r0[x1])));
      y[e] = fmaf(bhi[ox], t1, blo[ox] * t0);
    }
    store2(o + 2 * k, y[0], y[1]);
  }
}

template <typename T>
int launch(const void* x, const int* ylo, const int* yhi, const float* alo,
           const float* ahi, const int* xlo, const int* xhi, const float* blo,
           const float* bhi, void* out, int BC, int H, int W,
           cudaStream_t st) {
  const long long rows = (long long)BC * 2 * H;
  if (rows == 0 || W == 0) return (int)cudaGetLastError();
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bx = W >= kThreads ? kThreads : 32 * ((W + 31) / 32);
  const int by = kThreads / bx;
  const dim3 block(bx, by);
  const int grid = (int)((rows + by - 1) / by);
  upsample2x_kernel<T><<<grid, block, 0, st>>>(
      (const T*)x, ylo, yhi, alo, ahi, xlo, xhi, blo, bhi, (T*)out, H, W,
      (int)rows);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace loftr

// x [BC, H, W] (T) -> out [BC, 2H, 2W] (T).  Tap tables: ylo, yhi int32 and
// alo, ahi float [2H]; xlo, xhi int32 and blo, bhi float [2W].
extern "C" int loftr_upsample2x(const void* x, const void* ylo,
                                const void* yhi, const void* alo,
                                const void* ahi, const void* xlo,
                                const void* xhi, const void* blo,
                                const void* bhi, void* out, int BC, int H,
                                int W, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = dtype == 1 ? loftr::launch<__nv_bfloat16> : loftr::launch<float>;
  return fn(x, (const int*)ylo, (const int*)yhi, (const float*)alo,
            (const float*)ahi, (const int*)xlo, (const int*)xhi,
            (const float*)blo, (const float*)bhi, out, BC, H, W, st);
}
