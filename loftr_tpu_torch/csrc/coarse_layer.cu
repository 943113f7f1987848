// Coarse encoder layer: one LoFTREncoderLayer application (linear
// attention) in three launches.
//
// Replaces loftr_tpu/ops/pallas/coarse_layer.py::fused_coarse_layer
// (_kv_kernel and _apply_kernel).
//
// The TPU kernel sums KV and ksum over a sequential grid.  CUDA blocks run
// in no order, so pass 1 writes one partial per 64-row source tile, a
// second small kernel sums them in a fixed order (deterministic, no float
// atomics), and pass 3 applies the layer to row tiles.
//
// What bounds it on the H100: operations.  The projections and FFN cost
// 20*C^2 flop per row against 2*C bytes of bf16 activations in and out, so
// the bound is the bf16 tensor-core rate (0.013 ms at x=src [2,4800,256]).
// What kept the first version at 2.6% of it: every 16-deep k-step loaded
// its WMMA weight fragments from L2 and waited for them; 32-row tiles sent
// all 1.05 MB of apply weights through L2 for every 32 rows; every GEMM
// output went through a float tile in shared memory before its epilogue.
// The bfloat16 passes now run on raw mma.sync (mma_tile.cuh):
//   - weights stream through a ring of 16 KB k-slabs in shared memory with
//     cp.async, issued ahead of the products, each slab read from L2 once a
//     block and shared by the 8 warps; the next GEMM's first slabs are in
//     flight while the current epilogue runs;
//   - each warp owns a 32-column strip (one head) of every row, so every
//     epilogue runs on the accumulators in registers: phi(q) * mask and the
//     per-head normaliser, the attention itself (phi(q) re-packed as an mma
//     A operand against the head's KV block, as flash attention reuses its
//     scores), ReLU, both LayerNorms (row sums across warps through a
//     [2][8 warps][rows] float buffer) and the residual;
//   - pass 1 projects 64-row source tiles the same way and forms the
//     per-head KV blocks with mma.sync from phi(K) and V/S in shared memory.
// What bounds it now: each apply block still streams all 1.05 MB of apply
// weights from L2, so a block costs about 20 us whatever its height, plus
// about 0.5 us a row of tensor-core work (NVIDIA H100 80GB HBM3, 700 W,
// tools/coarse_tile_sweep.py).  The row tile (TM) is therefore the tallest
// the shared memory holds, 80 rows, unless 48 rows still fit the grid in
// one wave of the card's SMs (as at [1,4800,256] on 132 SMs).  Sharing
// the slabs between SMs (TMA multicast in a cluster) is the next step.
// The float instantiation (the exactness check) keeps the CUDA-core code.
//
// Rounding follows the JAX kernel: phi(k), v/S, phi(q), KV, the per-channel
// phi(q)*ksum terms, the message, LN1 and the FFN hidden are rounded to the
// compute type T where the JAX kernel casts with astype(dt).

#include "common.cuh"
#include "mma_tile.cuh"

namespace loftr {
namespace {

constexpr int kTileS = 64;  // source rows per KV-partial block
constexpr int kTileL = 32;  // x rows per float apply block

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

// ---- bfloat16: mma.sync with cp.async-staged weights (mma_tile.cuh) -------
//
// Fixed width: C = 256 (8 warps x 32 columns), 8 heads of d = 32, so warp w
// owns head w's columns in every product.
using mma::bf16;
using mma::layer_norm_acc;
using mma::st_pair;
constexpr int kC = 256, kD = 32, kNH = kC / kD;
constexpr int kLdS = kC + 8;       // padded [rows, C] bf16 row (elements)
constexpr int kLdX = 2 * kC + 8;   // padded [rows, 2C] bf16 row (elements)
constexpr int kRingKV = 2;         // ring stages of the KV pass
constexpr int kRingApply = 3;      // ring stages of the apply pass

// rows [0, rows) of a [*, C] bf16 tile -> dst (row stride ld) by cp.async,
// rows [rows, R) zero-filled; the copies join the caller's next group.
template <int R>
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int rows) {
  for (int idx = threadIdx.x; idx < R * (kC / 8); idx += kThreads) {
    const int r = idx / (kC / 8), c = (idx % (kC / 8)) * 8;
    if (r < rows)
      mma::cp_async16(dst + r * ld + c, src + (size_t)r * kC + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

// Pass 1, bf16: K and V projections of a 64-row source tile, masked phi(K)
// summed (unrounded) into the ksum partial, per-head KV blocks on mma.sync.
// V/S overwrites the source rows, so two blocks fit an SM.
__global__ void __launch_bounds__(kThreads, 2)
    kv_partial_bf16(const bf16* __restrict__ src,
                    const float* __restrict__ smask,
                    const bf16* __restrict__ w, float* __restrict__ kv_part,
                    float* __restrict__ ks_part, int S) {
  constexpr int MT = kTileS / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Xs = (bf16*)smem_raw;       // [kTileS, kLdS] source rows, then V*m/S
  bf16* Ks = Xs + kTileS * kLdS;    // phi(K) * m, rounded
  bf16* Vs = Xs;
  bf16* ring = Ks + kTileS * kLdS;
  float* ms = (float*)(ring + kRingKV * mma::kStageElems);  // [kTileS]
  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int s0 = tile * kTileS;
  const int rows = min(kTileS, S - s0);
  const size_t CC = (size_t)kC * kC;
  load_rows<kTileS>(Xs, kLdS, src + ((size_t)b * S + s0) * kC, rows);
  for (int r = threadIdx.x; r < kTileS; r += kThreads)
    ms[r] = r < rows ? smask[(size_t)b * S + s0 + r] : 0.f;
  mma::ring_prefetch<kRingKV>(w + CC, kC, kC, ring);
  float acc[MT][4][4];
  mma::ring_gemm<MT, kRingKV>(Xs, kLdS, kC, w + CC, kC, ring, acc);   // k
  __syncthreads();
  mma::ring_prefetch<kRingKV>(w + 2 * CC, kC, kC, ring);
  float csum[4][2] = {};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const float m = ms[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float k0 = phi(acc[mt][j][2 * h]) * m;       // float, unrounded
        const float k1 = phi(acc[mt][j][2 * h + 1]) * m;
        csum[j][0] += k0;
        csum[j][1] += k1;
        st_pair(Ks + r * kLdS + warp * 32 + j * 8 + 2 * q, k0, k1);
      }
    }
  float* ksb = ks_part + ((size_t)b * ntiles + tile) * kC + warp * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = csum[j][i];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) ksb[j * 8 + 2 * q + i] = s;
    }
  mma::ring_gemm<MT, kRingKV>(Xs, kLdS, kC, w + 2 * CC, kC, ring, acc);  // v
  __syncthreads();                       // every warp is done reading Xs
  const float inv_s = 1.f / S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const float f = ms[r] * inv_s;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_pair(Vs + r * kLdS + warp * 32 + j * 8 + 2 * q,
                acc[mt][j][2 * h] * f, acc[mt][j][2 * h + 1] * f);
    }
  __syncthreads();
  // warp h: KV_h[c][e] = sum_s phi(K)[s][32h + c] * (V/S)[s][32h + e], the
  // A operand (K_h^T) and B (V_h) both read transposed from [s][c] rows.
  float kvacc[2][4][4] = {};
  const bf16* Kh = Ks + warp * 32;
  const bf16* Vh = Vs + warp * 32;
#pragma unroll
  for (int k0 = 0; k0 < kTileS; k0 += 16) {
    uint32_t a[2][4], bq[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma::ldmatrix_x4_trans(
          a[mt], Kh + (k0 + (lane & 7) + (lane >> 4) * 8) * kLdS + mt * 16 +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      mma::ldmatrix_x4_trans(
          bq[p], Vh + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdS +
                     p * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma::mma_bf16(kvacc[mt][j], a[mt], bq[j >> 1][(j & 1) * 2],
                      bq[j >> 1][(j & 1) * 2 + 1]);
  }
  float* kvb =
      kv_part + (((size_t)b * ntiles + tile) * kC + warp * 32) * kD;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(kvb + (mt * 16 + g + 8 * h) * kD + j * 8 +
                                   2 * q) =
            make_float2(kvacc[mt][j][2 * h], kvacc[mt][j][2 * h + 1]);
}

// Pass 3, bf16: q, attention, merge + LN1, FFN, LN2 and the residual on a
// tile of TM rows held in shared memory.
template <int TM>
__global__ void __launch_bounds__(kThreads, 1)
    apply_bf16(const bf16* __restrict__ x, const float* __restrict__ xmask,
               const float* __restrict__ kv, const float* __restrict__ ksum,
               const bf16* __restrict__ w, const float* __restrict__ ln,
               bf16* __restrict__ out, int L, int S, float eps) {
  constexpr int MT = TM / 16, NST = kRingApply;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* XM = (bf16*)smem_raw;            // [TM, kLdX]: x | LN1, then output
  bf16* T1 = XM + TM * kLdX;             // [TM, kLdX]: message | FFN hidden
  bf16* ring = T1 + TM * kLdX;
  float* red = (float*)(ring + NST * mma::kStageElems);  // [2][8][TM]
  float* mrow = red + 2 * 8 * TM;                          // [TM]
  const int b = blockIdx.y, l0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int rows = min(TM, L - l0);
  const size_t CC = (size_t)kC * kC;
  load_rows<TM>(XM, kLdX, x + ((size_t)b * L + l0) * kC, rows);
  for (int r = threadIdx.x; r < TM; r += kThreads)
    mrow[r] = r < rows ? xmask[(size_t)b * L + l0 + r] : 0.f;
  mma::ring_prefetch<NST>(w, kC, kC, ring);
  // head `warp`'s KV block, rounded, as mma B fragments (k = a, n = e), and
  // ksum at this thread's accumulator columns
  uint32_t kvb[2][4][2];
  const float* kvh = kv + ((size_t)b * kC + warp * 32) * kD;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int a = t * 16 + hh * 8 + 2 * q, e = jn * 8 + g;
        kvb[t][jn][hh] = mma::pack_bf16(kvh[a * kD + e], kvh[(a + 1) * kD + e]);
      }
  float ks[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ks[j][i] = ksum[(size_t)b * kC + warp * 32 + j * 8 + 2 * q + i];

  float acc[MT][4][4];
  mma::ring_gemm<MT, NST>(XM, kLdX, kC, w, kC, ring, acc);            // q
  __syncthreads();
  mma::ring_prefetch<NST>(w + 3 * CC, kC, kC, ring);        // merge slabs
  const float s_len = (float)S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // masked phi(q) rounded, its per-head normaliser, and the same values
    // re-packed as the A operand of phi(q) @ KV_h
    const float m0 = mrow[mt * 16 + g], m1 = mrow[mt * 16 + g + 8];
    uint32_t qa[2][4];
    float den0 = 0.f, den1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q0 = mma::round_bf16(phi(acc[mt][j][0]) * m0);
      const float q1 = mma::round_bf16(phi(acc[mt][j][1]) * m0);
      const float q2 = mma::round_bf16(phi(acc[mt][j][2]) * m1);
      const float q3 = mma::round_bf16(phi(acc[mt][j][3]) * m1);
      den0 += mma::round_bf16(q0 * ks[j][0]);
      den0 += mma::round_bf16(q1 * ks[j][1]);
      den1 += mma::round_bf16(q2 * ks[j][0]);
      den1 += mma::round_bf16(q3 * ks[j][1]);
      qa[j >> 1][(j & 1) * 2] = mma::pack_bf16(q0, q1);
      qa[j >> 1][(j & 1) * 2 + 1] = mma::pack_bf16(q2, q3);
    }
    den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
    den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
    den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
    den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
    const float f0 = s_len / (den0 + eps), f1 = s_len / (den1 + eps);
    float msg[4][4] = {};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        mma::mma_bf16(msg[jn], qa[t], kvb[t][jn][0], kvb[t][jn][1]);
    bf16* t1 = T1 + (mt * 16 + g) * kLdX + warp * 32 + 2 * q;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      st_pair(t1 + jn * 8, msg[jn][0] * f0, msg[jn][1] * f0);
      st_pair(t1 + 8 * kLdX + jn * 8, msg[jn][2] * f1, msg[jn][3] * f1);
    }
  }
  mma::ring_gemm<MT, NST>(T1, kLdX, kC, w + 3 * CC, kC, ring, acc);   // merge
  __syncthreads();
  mma::ring_prefetch<NST>(w + 4 * CC, 2 * kC, 2 * kC, ring);
  layer_norm_acc<MT>(acc, ln, ln + kC, red,
                     [&](int r, int c, float y0, float y1) {
                       st_pair(XM + r * kLdX + kC + c, y0, y1);
                     });
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {                     // mlp0, by halves
    mma::ring_gemm<MT, NST>(XM, kLdX, 2 * kC, w + 4 * CC + half * kC, 2 * kC,
                            ring, acc);
    __syncthreads();
    if (half == 0)
      mma::ring_prefetch<NST>(w + 4 * CC + kC, 2 * kC, 2 * kC, ring);
    else
      mma::ring_prefetch<NST>(w + 8 * CC, kC, 2 * kC, ring);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st_pair(T1 + (mt * 16 + g + 8 * h) * kLdX + half * kC + warp * 32 +
                      j * 8 + 2 * q,
                  fmaxf(acc[mt][j][2 * h], 0.f),
                  fmaxf(acc[mt][j][2 * h + 1], 0.f));
  }
  mma::ring_gemm<MT, NST>(T1, kLdX, 2 * kC, w + 8 * CC, kC, ring, acc);  // mlp2
  // LN2 + residual, staged as bf16 in XM's second half (free since mlp0)
  layer_norm_acc<MT>(acc, ln + 2 * kC, ln + 3 * kC, red,
                     [&](int r, int c, float y0, float y1) {
                       const bf16* xr = XM + r * kLdX + c;
                       st_pair(XM + r * kLdX + kC + c,
                               __bfloat162float(xr[0]) + y0,
                               __bfloat162float(xr[1]) + y1);
                     });
  __syncthreads();
  bf16* ob = out + ((size_t)b * L + l0) * kC;
  for (int idx = threadIdx.x; idx < rows * (kC / 8); idx += kThreads) {
    const int r = idx / (kC / 8), c = (idx % (kC / 8)) * 8;
    *reinterpret_cast<uint4*>(ob + (size_t)r * kC + c) =
        *reinterpret_cast<const uint4*>(XM + r * kLdX + kC + c);
  }
}

template <int TM>
size_t apply_smem() {
  return (size_t)2 * TM * kLdX * sizeof(bf16) +
         (size_t)kRingApply * mma::kStageElems * sizeof(bf16) +
         (size_t)(2 * 8 * TM + TM) * sizeof(float);
}

template <int TM>
void launch_apply(const void* x, const void* xmask, const float* kv,
                  const float* ksum, const void* w, const void* ln, void* out,
                  int B, int L, int S, float eps, cudaStream_t stream) {
  const size_t smem = apply_smem<TM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      apply_bf16<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  (void)attr;
  apply_bf16<TM><<<dim3((L + TM - 1) / TM, B), kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)xmask, kv, ksum, (const bf16*)w,
      (const float*)ln, (bf16*)out, L, S, eps);
}

// Passes 1 and 2 in bfloat16: KV and ksum partials, then their sums.
void launch_kv_bf16(const void* src, const void* smask, const void* w,
                    void* kv_part, void* ks_part, void* kv, void* ksum, int B,
                    int S, cudaStream_t stream) {
  const int ntiles = (S + kTileS - 1) / kTileS;
  const size_t smem_kv = (size_t)2 * kTileS * kLdS * sizeof(bf16) +
                         (size_t)kRingKV * mma::kStageElems * sizeof(bf16) +
                         kTileS * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv_partial_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  (void)attr;
  kv_partial_bf16<<<dim3(ntiles, B), kThreads, smem_kv, stream>>>(
      (const bf16*)src, (const float*)smask, (const bf16*)w, (float*)kv_part,
      (float*)ks_part, S);
  const int n_kv = kC * kD;
  kv_reduce_kernel<<<dim3((n_kv + kC + 255) / 256, B), 256, 0, stream>>>(
      (const float*)kv_part, (const float*)ks_part, (float*)kv, (float*)ksum,
      ntiles, n_kv, kC);
}

// Rows per apply block: 48 when that grid fits one wave (one block an SM),
// else 80, the tallest tile the shared memory holds (PERF.md, the tile
// table of tools/coarse_tile_sweep.py).
int apply_rows(int B, int L) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return B * ((L + 47) / 48) <= sms ? 48 : 80;
}

int launch_bf16(const void* x, const void* xmask, const void* src,
                const void* smask, const void* w, const void* ln,
                void* kv_part, void* ks_part, void* kv, void* ksum, void* out,
                int B, int L, int S, int C, int nheads, float eps,
                cudaStream_t stream) {
  if (C != kC || nheads != kNH) return (int)cudaErrorInvalidValue;
  launch_kv_bf16(src, smask, w, kv_part, ks_part, kv, ksum, B, S, stream);
  const float* kvf = (const float*)kv;
  const float* ksf = (const float*)ksum;
  if (apply_rows(B, L) == 48)
    launch_apply<48>(x, xmask, kvf, ksf, w, ln, out, B, L, S, eps, stream);
  else
    launch_apply<80>(x, xmask, kvf, ksf, w, ln, out, B, L, S, eps, stream);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const void* xmask, const void* src,
               const void* smask, const void* w, const void* ln, void* kv_part,
               void* ks_part, void* kv, void* ksum, void* out, int B, int L,
               int S, int C, int nheads, float eps, cudaStream_t stream) {
  using T = float;
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

// Scratch sizes (float): kv_part [B, ceil(S/64), C, C/nheads],
// ks_part [B, ceil(S/64), C], kv [B, C, C/nheads], ksum [B, C].
// bfloat16 takes C = 256 with 8 heads only.
extern "C" int loftr_coarse_layer(const void* x, const void* xmask,
                                  const void* src, const void* smask,
                                  const void* w, const void* ln,
                                  void* kv_part, void* ks_part, void* kv,
                                  void* ksum, void* out, int B, int L, int S,
                                  int C, int nheads, float eps, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return loftr::launch_bf16(x, xmask, src, smask, w, ln, kv_part, ks_part,
                              kv, ksum, out, B, L, S, C, nheads, eps, st);
  return loftr::launch_f32(x, xmask, src, smask, w, ln, kv_part, ks_part, kv,
                           ksum, out, B, L, S, C, nheads, eps, st);
}
