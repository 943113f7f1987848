// Per-window linear attention in score form.
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
// unit; here the score form is kept with the TPU kernel's rounding points,
// in two versions.
//
// bfloat16 at the fine stage's shape (W2 = 25, C = 128, 8 heads of 16),
// namespace fine: blocks of 8 warps, one wave of them (3 an SM), walk the
// windows grid-stride; warp h owns head h of every window of its block, so
// the warps never wait for each other.  Each warp copies its head's 16
// columns of the next window's q, k and v (25 rows x 32 bytes each) into a
// 2-stage cp.async ring while it computes on the current one (deeper rings
// cost blocks an SM and ran slower: tools/window_upsample_sweep.py); shared
// rows are padded by 16 bytes (272 bytes, an odd multiple of 16) so
// ldmatrix reads them without bank conflicts.  phi is applied once, in
// float, to the warp's q and k columns as they land.  The scores are 8
// mma.m16n8k16 (query rows 25 -> 32 as 2 m-tiles, key rows 25 -> 32 as 4
// n8 tiles, k = the head width 16); the row sums come from the float accumulators; the
// scores are rounded to bf16 in registers, two adjacent n8 accumulators
// forming one k16 A fragment of the second product, whose B operand (V,
// key rows = k) comes by ldmatrix.trans: 8 more mma.  z scales the
// accumulators, and the result goes through the warp's Q columns of the
// stage so that it leaves in 16-byte stores.  Traps: phi(0) = 1, so the
// padded K rows 25-31 must be zero after phi (else every row sum gains
// 7 |Q_h|_1): they are zeroed once and neither the ring nor phi writes
// them; the padded V rows must be zero, not stale (0 * NaN is NaN), and
// likewise stay as zeroed; the padded Q rows give score rows that are
// computed and never stored.  phi uses expf, as the float path does.
//
// Every other shape, and float32: one window a block, one thread a (query
// row, head) with its W2 scores in registers and CUDA-core FMAs; threads
// of a warp share a head, so their K and V reads are shared-memory
// broadcasts.  The fine stage's size is compiled with its loop bounds
// fixed; the general version takes W2 <= 32 and heads <= 32 wide.

#include "common.cuh"
#include "mma_tile.cuh"

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

namespace fine {

using mma::bf16;
constexpr int kW2 = kFineW2;
constexpr int kC = 128;             // 8 heads of 16
constexpr int kD = 16;
constexpr int kRows = 32;           // rows padded to 2 m16 tiles
constexpr int kLd = kC + 8;         // 272 bytes: 17 x 16
constexpr int kTile = kRows * kLd;  // one tensor of one window
constexpr int kStage = 3 * kTile;   // q, k, v
constexpr int kChunks = kW2 * 2;    // 16-byte chunks of a head's tensor
constexpr int kLoads = (3 * kChunks + 31) / 32;  // cp.async a lane a window
constexpr int kPhis = (2 * kChunks + 31) / 32;   // phi chunks a lane
constexpr int kStores = (kChunks + 31) / 32;     // output chunks a lane

template <int NST>
constexpr int smem_bytes() {
  return NST * kStage * (int)sizeof(bf16);
}

// Chunk i of a head's q, k, v (or q, k): tensor i / 50, row (i % 50) / 2,
// half i % 2; its offset in a stage and, for the ring, in the inputs.
__device__ __forceinline__ int stage_off(int i, int h) {
  return (i / kChunks) * kTile + ((i % kChunks) >> 1) * kLd + h * kD +
         (i & 1) * 8;
}

// NST: stages of the ring (windows in flight a warp: NST - 1); MINB: the
// blocks an SM the registers are capped for.
template <int NST, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    window_attn_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int NB, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  // the padded rows 25-31 of every stage's tiles, this warp's columns: zero
  // for good (the ring and phi write rows 0-24 only)
  for (int i = lane; i < NST * 3 * (kRows - kW2) * 2; i += 32) {
    const int t = i / ((kRows - kW2) * 2);  // stage * 3 + tensor
    const int r = kW2 + (i % ((kRows - kW2) * 2)) / 2, c = (i & 1) * 8;
    *reinterpret_cast<uint4*>(ring + t * kTile + r * kLd + h * kD + c) =
        make_uint4(0, 0, 0, 0);
  }
  // this lane's chunks, once: the ring's (source and stage offsets), phi's
  // and the output's (stage and window offsets)
  const bf16* src[kLoads];
  int dst[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = min(lane + 32 * j, 3 * kChunks - 1);
    const int t = i / kChunks, r = (i % kChunks) >> 1, c = (i & 1) * 8;
    src[j] = (t == 0 ? q : t == 1 ? k : v) + r * kC + h * kD + c;
    dst[j] = stage_off(i, h);
  }
  int phi_off[kPhis];
#pragma unroll
  for (int j = 0; j < kPhis; ++j)
    phi_off[j] = stage_off(min(lane + 32 * j, 2 * kChunks - 1), h);
  int st_off[kStores], out_off[kStores];
#pragma unroll
  for (int j = 0; j < kStores; ++j) {
    const int i = min(lane + 32 * j, kChunks - 1);
    st_off[j] = stage_off(i, h);
    out_off[j] = (i >> 1) * kC + h * kD + (i & 1) * 8;
  }
  const auto issue = [&](bf16* st, size_t w) {
    const size_t base = w * kW2 * kC;
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (lane + 32 * j < 3 * kChunks)
        mma::cp_async16(st + dst[j], src[j] + base);
  };

  // windows blockIdx.x, blockIdx.x + gridDim.x, ... (gridDim.x <= NB)
  const int n = (NB - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const auto window = [&](int i) {
    return (size_t)blockIdx.x + (size_t)i * gridDim.x;
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n) issue(ring + s * kStage, window(s));
    mma::cp_async_commit();
  }
  // ldmatrix lanes: Q (A operand) rows lane%16, k halves lane/16; K (B,
  // key rows = n) the four 8x8 matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
  // (n 8-15, k 0-7), (n 8-15, k 8-15); V (B by .trans, key rows = k) the
  // four (k 0-7 | 8-15) x (d 0-7 | 8-15)
  const int a_off = (lane & 15) * kLd + h * kD + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * kLd + h * kD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + h * kD +
                    (lane >> 4) * 8;
  for (int i = 0; i < n; ++i) {
    mma::cp_async_wait<NST - 2>();  // this lane's copies of window i
    __syncwarp();  // every lane's; window i-1's stage is consumed
    if (i + NST - 1 < n)
      issue(ring + ((i + NST - 1) % NST) * kStage, window(i + NST - 1));
    mma::cp_async_commit();
    bf16* Qs = ring + (i % NST) * kStage;
    bf16* Ks = Qs + kTile;
    const bf16* Vs = Ks + kTile;

    // phi in place on the warp's columns of q and k, rows 0-24
#pragma unroll
    for (int j = 0; j < kPhis; ++j) {
      if (lane + 32 * j >= 2 * kChunks) break;
      uint4* p = reinterpret_cast<uint4*>(Qs + phi_off[j]);
      uint4 x = *p;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = __bfloat1622float2(e[c]);
        e[c] = __floats2bfloat162_rn(phi(f.x), phi(f.y));
      }
      *p = x;
    }
    __syncwarp();

    // scores: s[mt][j] = query rows 16 mt.. x key rows 8 j..
    uint32_t a[2][4], b[2][4];
    mma::ldmatrix_x4(a[0], Qs + a_off);
    mma::ldmatrix_x4(a[1], Qs + a_off + 16 * kLd);
    mma::ldmatrix_x4(b[0], Ks + k_off);
    mma::ldmatrix_x4(b[1], Ks + k_off + 16 * kLd);
    float s[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
        mma::mma_bf16(s[mt][j], a[mt], b[j >> 1][(j & 1) * 2],
                      b[j >> 1][(j & 1) * 2 + 1]);
      }
    // z of rows 16 mt + g (+ 8): the unrounded scores' row sums (the
    // padded key columns are exact zeros)
    float z[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sum += s[mt][j][2 * hh] + s[mt][j][2 * hh + 1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        z[mt][hh] = 1.f / (sum + eps);
      }

    // o = bf16(scores) V: score tiles 2 kk, 2 kk + 1 are the A fragment
    // of k16 step kk
    float o[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t vb[4];
      mma::ldmatrix_x4_trans(vb, Vs + v_off + kk * 16 * kLd);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t af[4] = {
            mma::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]),
            mma::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]),
            mma::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]),
            mma::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3])};
        mma::mma_bf16(o[mt][0], af, vb[0], vb[1]);
        mma::mma_bf16(o[mt][1], af, vb[2], vb[3]);
      }
    }

    // out = bf16(o * z): staged over the warp's Q columns, rows 0-24, then
    // 16-byte stores
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * mt + g + 8 * hh;
        if (r < kW2)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma::st_pair(Qs + r * kLd + h * kD + 8 * j + 2 * qd,
                         o[mt][j][2 * hh] * z[mt][hh],
                         o[mt][j][2 * hh + 1] * z[mt][hh]);
      }
    __syncwarp();
    bf16* dst_w = out + window(i) * kW2 * kC;
#pragma unroll
    for (int j = 0; j < kStores; ++j)
      if (lane + 32 * j < kChunks)
        *reinterpret_cast<uint4*>(dst_w + out_off[j]) =
            *reinterpret_cast<const uint4*>(Qs + st_off[j]);
  }
}

// One wave of blocks (at most NB), each with the ring's shared memory.
template <int NST, int MINB>
int launch(const void* q, const void* k, const void* v, void* out, int NB,
           float eps, cudaStream_t st) {
  if (NB <= 0) return (int)cudaGetLastError();
  static int grid_max = 0;  // blocks in one wave on this device
  if (grid_max == 0) {
    cudaFuncSetAttribute(window_attn_bf16<NST, MINB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes<NST>());
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_attn_bf16<NST, MINB>, kThreads, smem_bytes<NST>());
    grid_max = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = NB < grid_max ? NB : grid_max;
  window_attn_bf16<NST, MINB><<<grid, kThreads, smem_bytes<NST>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, NB, eps);
  return (int)cudaGetLastError();
}

// the production launch (tools/window_upsample_sweep.py)
constexpr int kStages = 2;
constexpr int kMinBlocks = 3;

}  // namespace fine

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
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (W2 == kFineW2 && C == fine::kC && nheads == fine::kC / fine::kD)
      return fine::launch<fine::kStages, fine::kMinBlocks>(q, k, v, out, NB,
                                                           eps, st);
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
