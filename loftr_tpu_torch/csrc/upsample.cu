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
// many values written).
//
// bfloat16, namespace band: a block takes one (b, c) plane and a band of
// kRows = 64 output rows (1,568 blocks at [2,196,120,160]; taller bands
// won over 8-32 rows in tools/window_upsample_sweep.py, as a thread's
// weights and the block's set-up serve more rows).  It loads the input rows
// the band reads (ylo of its first row to yhi of its last, at most
// kRows / 2 + 2) into shared memory, 16 bytes a thread, and the band's row
// taps; the H pass forms each t value of the band once, 8 of a row a
// thread from two 16-byte reads, and keeps it as bf16 (it is rounded there
// anyway); the W pass writes 8 adjacent outputs a thread in one 16-byte
// store.  Its 8 outputs 8m..8m+7 read t at columns 4m-1 .. 4m+4: the exact
// x2 align-corners taps are (i-1, i) for output 2i and (i, i+1) for 2i+1,
// clamped to [0, W-1]; where the clamp moves a tap (outputs 0 and 2W-1)
// the host's weight on it is 0, so the value is the table form's.  The
// weights come from the host tables; a thread keeps its 8 columns' weights
// in registers over the band's rows.  Rows whose width is not a multiple
// of 8 values (16 bytes of input), W = 1 and H = 1 take the scalar path:
// the same band, one value a thread, the host's index tables.  Rows too
// wide for the shared tiles (W > 1176) and float32 take the one-pass
// kernel below.
//
// The one-pass kernel: a thread row owns one output row (its y taps are
// read once) and each thread writes two neighbouring outputs
// in one store, so the stores coalesce and neighbouring threads share
// their loads in L1.

#include "common.cuh"
#include "mma_tile.cuh"

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

namespace band {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;  // output rows a block (the production launch)
constexpr int kMaxSmem = 232448;  // shared memory a block can have (H100)

// input rows a band of ROWS output rows reads, at most
template <int ROWS>
__host__ __device__ constexpr int in_rows() {
  return ROWS / 2 + 2;
}

__host__ __device__ inline int padded(int W) { return (W + 7) & ~7; }

// shared: input rows [in_rows][Wp], t [ROWS][Wp] (bf16), row taps [ROWS]
template <int ROWS>
__host__ __device__ inline int smem_bytes(int W) {
  return (in_rows<ROWS>() + ROWS) * padded(W) * 2 + ROWS * 16;
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// VEC: W a multiple of 8 (16-byte rows in and out); else the scalar path.
// ROWS: output rows a band.
template <bool VEC, int ROWS>
__global__ void __launch_bounds__(kThreads)
    upsample2x_band(const bf16* __restrict__ x, const int* __restrict__ ylo,
                    const int* __restrict__ yhi,
                    const float* __restrict__ alo,
                    const float* __restrict__ ahi,
                    const int* __restrict__ xlo, const int* __restrict__ xhi,
                    const float* __restrict__ blo,
                    const float* __restrict__ bhi, bf16* __restrict__ out,
                    int H, int W, int nbands) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Wp = padded(W);
  bf16* in = reinterpret_cast<bf16*>(smem_raw);
  bf16* t = in + in_rows<ROWS>() * Wp;
  int* ryl = reinterpret_cast<int*>(t + ROWS * Wp);
  int* ryh = ryl + ROWS;
  float* ra0 = reinterpret_cast<float*>(ryh + ROWS);
  float* ra1 = ra0 + ROWS;
  const int H2 = 2 * H, W2 = 2 * W;
  const int plane = blockIdx.x / nbands;
  const int o0 = (blockIdx.x % nbands) * ROWS;
  const int R = min(ROWS, H2 - o0);
  const int y0 = ylo[o0];
  const int nin = yhi[o0 + R - 1] - y0 + 1;  // <= in_rows (monotone taps)
  const bf16* src = x + ((size_t)plane * H + y0) * W;
  if (threadIdx.x < R) {
    ryl[threadIdx.x] = (ylo[o0 + threadIdx.x] - y0) * Wp;
    ryh[threadIdx.x] = (yhi[o0 + threadIdx.x] - y0) * Wp;
    ra0[threadIdx.x] = alo[o0 + threadIdx.x];
    ra1[threadIdx.x] = ahi[o0 + threadIdx.x];
  }
  if constexpr (VEC) {
    const int M = W / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < nin * M; i += kThreads) {
      const int r = i / M, c = i % M;
      *reinterpret_cast<uint4*>(in + r * Wp + 8 * c) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * W + 8 * c);
    }
  } else {
    for (int i = threadIdx.x; i < nin * W; i += kThreads)
      in[(i / W) * Wp + i % W] = src[i];
  }
  __syncthreads();

  // H pass: t(r, x) = bf16(fmaf(a1, in[yh], a0 * in[yl]))
  if constexpr (VEC) {
    // 8 values a thread: chunk c of rows r = g, g + G, ...
    const int M = W / 8, G = max(1, kThreads / M);
    for (int i = threadIdx.x; i < M * G; i += kThreads) {
      const int c = i % M;
      for (int r = i / M; r < R; r += G) {
        const uint4 u = *reinterpret_cast<const uint4*>(in + ryl[r] + 8 * c);
        const uint4 w = *reinterpret_cast<const uint4*>(in + ryh[r] + 8 * c);
        const float a0 = ra0[r], a1 = ra1[r];
        const uint32_t* up = reinterpret_cast<const uint32_t*>(&u);
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(&w);
        uint4 res;
        uint32_t* rp = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rp[e] = mma::pack_bf16(fmaf(a1, lo_f(wp[e]), a0 * lo_f(up[e])),
                                 fmaf(a1, hi_f(wp[e]), a0 * hi_f(up[e])));
        *reinterpret_cast<uint4*>(t + r * Wp + 8 * c) = res;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += kThreads) {
      const int r = i / W, c = i % W;
      t[r * Wp + c] = __float2bfloat16(fmaf(
          ra1[r], __bfloat162float(in[ryh[r] + c]),
          ra0[r] * __bfloat162float(in[ryl[r] + c])));
    }
  }
  __syncthreads();

  // W pass: y(r, ox) = bf16(fmaf(bhi, t[hi], blo * t[lo]))
  bf16* dst = out + ((size_t)plane * H2 + o0) * W2;
  if constexpr (VEC) {
    // 8 outputs a thread: chunk m (outputs 8m..8m+7) of rows g, g + G, ...
    const int M = W / 4, G = max(1, kThreads / M);
    for (int i = threadIdx.x; i < M * G; i += kThreads) {
      const int m = i % M;
      float wl[8], wh[8];
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 l = *reinterpret_cast<const float4*>(blo + 8 * m + e);
        const float4 h = *reinterpret_cast<const float4*>(bhi + 8 * m + e);
        wl[e] = l.x, wl[e + 1] = l.y, wl[e + 2] = l.z, wl[e + 3] = l.w;
        wh[e] = h.x, wh[e + 1] = h.y, wh[e + 2] = h.z, wh[e + 3] = h.w;
      }
      const int left = m > 0 ? 4 * m - 1 : 0;            // clamped 4m - 1
      const int right = 4 * m + 4 < W ? 4 * m + 4 : W - 1;  // clamped 4m + 4
      for (int r = i / M; r < R; r += G) {
        const bf16* tr = t + r * Wp;
        const uint2 mid = *reinterpret_cast<const uint2*>(tr + 4 * m);
        float c[6];  // t at columns 4m - 1 .. 4m + 4
        c[0] = __bfloat162float(tr[left]);
        c[1] = lo_f(mid.x), c[2] = hi_f(mid.x);
        c[3] = lo_f(mid.y), c[4] = hi_f(mid.y);
        c[5] = __bfloat162float(tr[right]);
        uint4 res;
        uint32_t* rp = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
        for (int j = 0; j < 4; ++j)  // outputs 2i, 2i + 1 with i = 4m + j
          rp[j] = mma::pack_bf16(
              fmaf(wh[2 * j], c[j + 1], wl[2 * j] * c[j]),
              fmaf(wh[2 * j + 1], c[j + 2], wl[2 * j + 1] * c[j + 1]));
        *reinterpret_cast<uint4*>(dst + (size_t)r * W2 + 8 * m) = res;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * W2; i += kThreads) {
      const int r = i / W2, ox = i % W2;
      dst[(size_t)r * W2 + ox] = __float2bfloat16(fmaf(
          bhi[ox], __bfloat162float(t[r * Wp + xhi[ox]]),
          blo[ox] * __bfloat162float(t[r * Wp + xlo[ox]])));
    }
  }
}

// False when the rows are too wide for the shared tiles.
template <int ROWS>
bool launch(const void* x, const int* ylo, const int* yhi, const float* alo,
            const float* ahi, const int* xlo, const int* xhi,
            const float* blo, const float* bhi, void* out, int BC, int H,
            int W, cudaStream_t st, int* err) {
  if (W > kMaxSmem || smem_bytes<ROWS>(W) > kMaxSmem) return false;
  const int nbands = (2 * H + ROWS - 1) / ROWS;
  const long long blocks = (long long)BC * nbands;
  if (blocks > 0x7fffffffLL) return false;
  const int smem = smem_bytes<ROWS>(W);
  auto kernel = W % 8 == 0 ? upsample2x_band<true, ROWS>
                           : upsample2x_band<false, ROWS>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  kernel<<<(int)blocks, kThreads, smem, st>>>(
      (const bf16*)x, ylo, yhi, alo, ahi, xlo, xhi, blo, bhi, (bf16*)out, H,
      W, nbands);
  *err = (int)cudaGetLastError();
  return true;
}

}  // namespace band

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
  int err = 0;
  if (dtype == 1 && BC > 0 && H > 0 && W > 0 &&
      loftr::band::launch<loftr::band::kRows>(
          x, (const int*)ylo, (const int*)yhi, (const float*)alo,
          (const float*)ahi, (const int*)xlo, (const int*)xhi,
          (const float*)blo, (const float*)bhi, out, BC, H, W, st, &err))
    return err;
  auto fn = dtype == 1 ? loftr::launch<__nv_bfloat16> : loftr::launch<float>;
  return fn(x, (const int*)ylo, (const int*)yhi, (const float*)alo,
            (const float*)ahi, (const int*)xlo, (const int*)xhi,
            (const float*)blo, (const float*)bhi, out, BC, H, W, st);
}
