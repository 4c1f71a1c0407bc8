// The dQ and dK/dV passes shared by the two attention backwards:
// `mha_bwd.cu` (P rebuilt from the forward's saved row LSE) and
// `mha_head_group.cu` (P rebuilt from a row max and a row sum that the dQ
// kernel recomputes). Each includes this file and instantiates the kernels
// with its row policy; the anonymous namespace keeps the two copies apart
// at link time.
//
//   qkv  (B, L, 3W), bf16 or fp32 (W = H * D): q at column h*D, k at
//        W + h*D, v at 2W + h*D;
//   row_a, row_b (B, L, H) fp32: the row statistics P is formed from
//        (given, or written by the dQ kernel's first sweep);
//   dout (B, L, W), qkv's type;
//   drow (B, H, L) fp32: Dr = rowsum(dP o P), written by the dQ kernel's
//        first sweep;
//   dqkv (B, L, 3W), qkv's type.
//
// With S = Q.K^T * s (s = D^-0.5) and the causal mask col > row:
//   dV = P^T.dO,  dP = dO.V^T,  dS = P o (dP - Dr),  dQ = dS.K * s,
//   dK = dS^T.Q * s.
// Two kernels on one stream, no atomics (two runs give the same bits):
//   the dQ kernel takes one (batch, head) and a tile of query rows and
//     sweeps the keys twice: the first sweep forms the row statistics
//     (Dr alone from the saved LSE; or, for the head-group rows, the
//     online max m, l = sum exp(s - m) and a = sum exp(s - m) dP, both
//     rescaled by exp(m_old - m_new) when m grows, then Dr = a / l) and
//     writes them for the second kernel; the second sweep forms dS and
//     accumulates dQ;
//   the dK/dV kernel takes one (batch, head) and a tile of keys, walks the
//     query rows (from its own first key on when causal) and accumulates
//     dK and dV from the statistics the dQ kernel wrote.
// S and dP are recomputed in each sweep: nine L^2.D products a head (S and
// dP three times, dQ, dK and dV once) instead of five, in exchange for no
// (L, L) scratch and no atomics.
//
// bf16 (`mha_bwd_{dq,dkv}_bf16_kernel`): all five products on the tensor
// cores, mma.sync m16n8k16, bf16 in, fp32 accumulate; 4 warps, 64 query
// rows (dQ) or 64 keys (dK/dV) a block, 16 a warp; the other side streams
// through a two-stage cp.async ring of 32-row bf16 tiles (rows padded by 8
// elements, so the 8 rows an ldmatrix reads fall on distinct banks; head
// columns zero-filled up to the mma's k of 16), the next tile's copy in
// flight while this one computes. S = Q.K^T and dP = dO.V^T take the bf16
// inputs as they stand: their products are exact in fp32. dQ = dS.K, dK =
// dS^T.Q and dV = P^T.dO take the fp32 P and dS as two bf16 terms (hi +
// lo, |x - hi - lo| <= 2^-16 |x|): dS = P o (dP - Dr) cancels, and a single
// bf16 dS would carry 2^-8 of the terms into the gradient. So a head costs
// twelve L^2.D products on the tensor cores (dQ, dK and dV count twice).
// The dK/dV kernel computes S^T = K.Q^T and dP^T = V.dO^T, keys as the
// rows, so P^T and dS^T leave the accumulators already laid out as the A
// fragment of the next product; Q's and dO's B fragments come from ldmatrix
// (plain for S^T and dP^T, transposed for dV and dK). The dQ kernel's two
// sweeps run the same mma sequence and see the same S and dP bit for bit;
// the dK/dV kernel's transposed products need not sum in the tensor cores'
// order for S, so its P may differ from the dQ kernel's in the last fp32
// bits. Dr is then rowsum(dP o P) to fp32 rounding against that P, an error
// far inside the bf16 tolerance the gradients are held to, and no pass
// depends on another's bits (which the fp32 route still arranges).
//
// fp32 (`mha_bwd_{dq,dkv}_fp32_kernel`): plain fp32 FMAs out of shared
// memory (TF32 would round the inputs), 32-row tiles, one key a lane for S
// and dP (`pair_dots`, the same FMAs in the same order in every sweep, so
// every sweep sees bitwise the same P).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;
// fp32
constexpr int kTile = 32;                        // query rows and keys a tile: one per lane
constexpr int kRowsPerWarp = kTile / kWarps;     // tile rows a warp owns
constexpr int kColsPerLane = kMaxHeadDim / 32;   // gradient columns a lane owns
// bf16
constexpr int kMmaRows = 16 * kWarps;  // query rows (dQ) or keys (dK/dV) a block, 16 a warp
constexpr int kMmaTile = 32;           // keys (dQ) or query rows (dK/dV) a pipeline stage
constexpr int kMmaN = kMmaTile / 8;    // 8-wide n-tiles of a stage's scores

constexpr float kLog2e = 1.4426950408889634f;

// P from the forward's row log-sum-exp: P = exp(S - LSE). row_a is the
// LSE, row_b is not read; the dQ kernel's first sweep sums Dr.
//   prob: fp32, natural units.
//   prob2: bf16, the exponent in log2 units (S log2 e and LSE log2 e), on
//     the SFU's 2^x.
struct SavedLse {
  static constexpr bool kOnline = false;
  __device__ static __forceinline__ float prob(float s, float lse, float) { return expf(s - lse); }
  __device__ static __forceinline__ float prob2(float s2, float lse2, float) {
    return exp2f(s2 - lse2);
  }
};

// P from the row max m (row_a) and sum l = sum exp(S - m) (row_b) that the
// dQ kernel's first sweep recomputes online and writes, normalised by the
// row sum as the TPU head-group kernel does (pallas_attention.py:250-252).
//   prob: fp32, e / l by division.
//   prob2: bf16, m in log2 units and the row's 1 / l (which the bf16 dQ
//     kernel writes to row_b in place of l), so e / l is one multiply, an
//     fp32 ulp from the quotient.
struct HeadGroupRows {
  static constexpr bool kOnline = true;
  __device__ static __forceinline__ float prob(float s, float m, float l) {
    return expf(s - m) / l;
  }
  __device__ static __forceinline__ float prob2(float s2, float m2, float inv_l) {
    return exp2f(s2 - m2) * inv_l;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// ------------------------------------------------------------------ fp32

// Rows [r0, r0 + kTile) of one head's D columns (source row stride `stride`
// elements) into shared memory, row stride sd; rows past L are zero.
__device__ void stage(float* dst, int sd, const float* src, int64_t stride, int r0, int L, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    dst[r * sd + d] = row < L ? src[row * stride + d] : 0.f;
  }
}

// x[n] = bc_a[r_n] . ln_a[lane] and y[n] = bc_b[r_n] . ln_b[lane] over D,
// for the warp's rows r_n = warp + kWarps * n. The bc rows are read by the
// whole warp at once (a broadcast); the ln rows one per lane, as float4 with
// a row stride of D + 4 floats, which keeps 8 neighbouring lanes on 8
// distinct groups of 4 banks. The product order is the same whichever side
// is broadcast, so every pass gets the same S and dP bit for bit.
__device__ __forceinline__ void pair_dots(const float* __restrict__ bc_a,
                                          const float* __restrict__ bc_b,
                                          const float* __restrict__ ln_a,
                                          const float* __restrict__ ln_b, int sd, int D,
                                          int warp, int lane, float (&x)[kRowsPerWarp],
                                          float (&y)[kRowsPerWarp]) {
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) x[n] = y[n] = 0.f;
  const float* la = ln_a + lane * sd;
  const float* lb = ln_b + lane * sd;
  for (int d = 0; d < D; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(la + d);
    const float4 b = *reinterpret_cast<const float4*>(lb + d);
#pragma unroll
    for (int n = 0; n < kRowsPerWarp; ++n) {
      const int r = warp + kWarps * n;
      const float4 p = *reinterpret_cast<const float4*>(bc_a + r * sd + d);
      const float4 q = *reinterpret_cast<const float4*>(bc_b + r * sd + d);
      x[n] = fmaf(p.x, a.x, x[n]);
      x[n] = fmaf(p.y, a.y, x[n]);
      x[n] = fmaf(p.z, a.z, x[n]);
      x[n] = fmaf(p.w, a.w, x[n]);
      y[n] = fmaf(q.x, b.x, y[n]);
      y[n] = fmaf(q.y, b.y, y[n]);
      y[n] = fmaf(q.z, b.z, y[n]);
      y[n] = fmaf(q.w, b.w, y[n]);
    }
  }
}

// dQ and the row statistics. Grid (query tiles of 32, H, B).
template <typename Rows>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_fp32_kernel(const float* __restrict__ qkv, float* __restrict__ row_a,
                       float* __restrict__ row_b, const float* __restrict__ dout,
                       float* __restrict__ dqkv, float* __restrict__ drow, int L, int H, int D,
                       int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int sd = D + 4;
  float* q_s = smem;
  float* do_s = q_s + kTile * sd;
  float* k_s = do_s + kTile * sd;
  float* v_s = k_s + kTile * sd;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t qkv_stride = 3 * (int64_t)W;
  const float* qkv_b = qkv + b * L * qkv_stride + (int64_t)h * D;
  const float* dout_b = dout + b * L * (int64_t)W + (int64_t)h * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage(q_s, sd, qkv_b, qkv_stride, q0, L, D);
  stage(do_s, sd, dout_b, (int64_t)W, q0, L, D);

  // ra, rb: the LSE (and 1), or the running max and sum; dr: Dr's sum
  int row[kRowsPerWarp];
  float ra[kRowsPerWarp], rb[kRowsPerWarp], dr[kRowsPerWarp];
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    row[n] = q0 + warp + kWarps * n;
    const bool live = row[n] < L;
    ra[n] = Rows::kOnline ? -INFINITY : live ? row_a[(b * L + row[n]) * H + h] : 0.f;
    rb[n] = Rows::kOnline ? 0.f : 1.f;
    dr[n] = 0.f;
  }

  const int key_end = causal ? min(L, q0 + kTile) : L;
  float s[kRowsPerWarp], dp[kRowsPerWarp];

  // sweep 1: the row statistics
  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed; Q and dO are visible
    stage(k_s, sd, qkv_b + W, qkv_stride, k0, L, D);
    stage(v_s, sd, qkv_b + 2 * W, qkv_stride, k0, L, D);
    __syncthreads();
    pair_dots(q_s, do_s, k_s, v_s, sd, D, warp, lane, s, dp);
    const int key = k0 + lane;
#pragma unroll
    for (int n = 0; n < kRowsPerWarp; ++n) {
      const bool valid = row[n] < L && key < L && (!causal || key <= row[n]);
      if constexpr (Rows::kOnline) {
        const float sc = valid ? s[n] * scale : -INFINITY;
        const float m_new = fmaxf(ra[n], warp_max(sc));
        // a row past L sees no valid key: keep its sums at 0, never NaN
        const float alpha = m_new == -INFINITY ? 0.f : expf(ra[n] - m_new);
        const float e = valid ? expf(sc - m_new) : 0.f;
        rb[n] = rb[n] * alpha + warp_sum(e);
        dr[n] = dr[n] * alpha + warp_sum(e * dp[n]);
        ra[n] = m_new;
      } else {
        const float p = valid ? Rows::prob(s[n] * scale, ra[n], rb[n]) : 0.f;
        dr[n] += warp_sum(p * dp[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    if (Rows::kOnline) dr[n] = rb[n] > 0.f ? dr[n] / rb[n] : 0.f;  // Dr = a / l
    if (row[n] >= L || lane != 0) continue;
    drow[(b * H + h) * L + row[n]] = dr[n];
    if (Rows::kOnline) {
      row_a[(b * L + row[n]) * H + h] = ra[n];
      row_b[(b * L + row[n]) * H + h] = rb[n];
    }
  }

  // sweep 2: dS = P o (dP - Dr); dQ = dS.K
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[n][c] = 0.f;

  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    __syncthreads();
    stage(k_s, sd, qkv_b + W, qkv_stride, k0, L, D);
    stage(v_s, sd, qkv_b + 2 * W, qkv_stride, k0, L, D);
    __syncthreads();
    pair_dots(q_s, do_s, k_s, v_s, sd, D, warp, lane, s, dp);
    const int key = k0 + lane;
    float ds[kRowsPerWarp];
#pragma unroll
    for (int n = 0; n < kRowsPerWarp; ++n) {
      const bool valid = row[n] < L && key < L && (!causal || key <= row[n]);
      const float p = valid ? Rows::prob(s[n] * scale, ra[n], rb[n]) : 0.f;
      ds[n] = p * (dp[n] - dr[n]);
    }
    const int n_keys = min(kTile, key_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      float kv[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? k_s[j * sd + d] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kRowsPerWarp; ++n) {
        const float dsj = __shfl_sync(kFullMask, ds[n], j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[n][c] = fmaf(dsj, kv[c], acc[n][c]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    if (row[n] >= L) continue;
    float* out = dqkv + (b * L + row[n]) * qkv_stride + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[d] = acc[n][c] * scale;
    }
  }
}

// dK and dV. Grid (key tiles of 32, H, B).
template <typename Rows>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_fp32_kernel(const float* __restrict__ qkv, const float* __restrict__ row_a,
                        const float* __restrict__ row_b, const float* __restrict__ dout,
                        const float* __restrict__ drow, float* __restrict__ dqkv, int L, int H,
                        int D, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int sd = D + 4;
  float* k_s = smem;
  float* v_s = k_s + kTile * sd;
  float* q_s = v_s + kTile * sd;
  float* do_s = q_s + kTile * sd;
  float* ra_s = do_s + kTile * sd;
  float* rb_s = ra_s + kTile;
  float* dr_s = rb_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t qkv_stride = 3 * (int64_t)W;
  const float* qkv_b = qkv + b * L * qkv_stride + (int64_t)h * D;
  const float* dout_b = dout + b * L * (int64_t)W + (int64_t)h * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage(k_s, sd, qkv_b + W, qkv_stride, k0, L, D);
  stage(v_s, sd, qkv_b + 2 * W, qkv_stride, k0, L, D);

  int key[kRowsPerWarp];
  float acc_k[kRowsPerWarp][kColsPerLane], acc_v[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    key[n] = k0 + warp + kWarps * n;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;
  }

  // causal: query rows before k0 see none of this block's keys
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed; K and V are visible
    stage(q_s, sd, qkv_b, qkv_stride, q0, L, D);
    stage(do_s, sd, dout_b, (int64_t)W, q0, L, D);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const bool live = r < L;
      ra_s[threadIdx.x] = live ? row_a[(b * L + r) * H + h] : 0.f;
      rb_s[threadIdx.x] = Rows::kOnline && live ? row_b[(b * L + r) * H + h] : 1.f;
      dr_s[threadIdx.x] = live ? drow[(b * H + h) * L + r] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
    pair_dots(k_s, v_s, q_s, do_s, sd, D, warp, lane, s, dp);
    const int r = q0 + lane;  // this lane's query row
    const float ra = ra_s[lane], rb = rb_s[lane], dr = dr_s[lane];
    float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int n = 0; n < kRowsPerWarp; ++n) {
      const bool valid = r < L && key[n] < L && (!causal || key[n] <= r);
      p[n] = valid ? Rows::prob(s[n] * scale, ra, rb) : 0.f;
      ds[n] = p[n] * (dp[n] - dr);
    }
    const int n_rows = min(kTile, L - q0);
    for (int i = 0; i < n_rows; ++i) {
      float qv[kColsPerLane], dov[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        qv[c] = d < D ? q_s[i * sd + d] : 0.f;
        dov[c] = d < D ? do_s[i * sd + d] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kRowsPerWarp; ++n) {
        const float pi = __shfl_sync(kFullMask, p[n], i);
        const float dsi = __shfl_sync(kFullMask, ds[n], i);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          acc_v[n][c] = fmaf(pi, dov[c], acc_v[n][c]);
          acc_k[n][c] = fmaf(dsi, qv[c], acc_k[n][c]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    if (key[n] >= L) continue;
    float* out = dqkv + (b * L + key[n]) * qkv_stride + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        out[W + d] = acc_k[n][c] * scale;
        out[2 * W + d] = acc_v[n][c];
      }
    }
  }
}

// ------------------------------------------------------------------ bf16

// Rows [r0, r0 + n_rows) of one head (source row stride `stride` elements)
// into shared memory, row stride kStride, by cp.async: 16-byte vectors up
// to the head's padded width pad_vecs * 8, zero past L and past D.
template <int kStride>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t stride, int r0, int n_rows, int L, int vecs,
                                           int pad_vecs) {
  for (int i = threadIdx.x; i < n_rows * pad_vecs; i += kThreads) {
    const int r = i / pad_vecs, c = i - r * pad_vecs;
    const int row = r0 + r;
    const bool full = row < L && c < vecs;
    cp_async16(dst + r * kStride + c * 8, full ? src + row * stride + c * 8 : src, full);
  }
}

// acc(16 x 32) += X(16 x 16 rows of a row-major tile at `a`) . Y^T, Y the
// 32 rows of an (n, k) tile at `bt`, over pad_vecs / 2 k-steps of 16: the
// 16-row warp slab's S or dP (or S^T, dP^T) for one stage.
template <int kMaxD>
__device__ __forceinline__ void slab_scores(float (&acc)[kMmaN][4], const __nv_bfloat16* a,
                                            const __nv_bfloat16* bt, int pad_vecs) {
  constexpr int kStride = kMaxD + 8;
#pragma unroll
  for (int n = 0; n < kMmaN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (2 * ks < pad_vecs) {
      uint32_t af[4];
      ldmatrix_x4(af, a + ks * 16);
#pragma unroll
      for (int np = 0; np < kMmaN / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bt + np * 16 * kStride + ks * 16);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc(16 x D) += X(16 x 32) . Y, X fp32 in accumulator layout (kMmaN
// n-tiles of 8), taken as hi + lo, Y the 32 rows of a row-major (k, n)
// tile at `yt` (this lane's transposed-load offset applied), over the
// head's vecs 8-wide column tiles.
template <int kMaxD>
__device__ __forceinline__ void slab_times_tile(float (&acc)[kMaxD / 8][4],
                                                const float (&x)[kMmaN][4],
                                                const __nv_bfloat16* yt, int vecs) {
  constexpr int kStride = kMaxD + 8;
#pragma unroll
  for (int kk = 0; kk < kMmaN / 2; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < kMaxD / 16; ++np) {
      if (2 * np < vecs) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, yt + kk * 16 * kStride + np * 16);
        mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
        mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
        if (2 * np + 1 < vecs) {
          mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
          mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
        }
      }
    }
  }
}

// Shared memory of either bf16 kernel: two 64-row tiles, a two-stage ring
// of two 32-row tiles, and the dK/dV kernel's per-row statistics (two
// stages of three rows of 32 floats).
template <int kMaxD>
constexpr size_t bf16_bwd_smem_bytes() {
  return (size_t)(2 * kMmaRows + 4 * kMmaTile) * (kMaxD + 8) * sizeof(__nv_bfloat16) +
         2 * 3 * kMmaTile * sizeof(float);
}

// dQ and the row statistics. Grid (query tiles of 64, H, B). At head_dim
// <= 64 the registers are held to 96 a thread, five blocks an SM (no
// spill; see the dK/dV kernel's note).
template <int kMaxD, typename Rows>
__global__ void __launch_bounds__(kThreads, kMaxD <= 64 ? 5 : 1)
mha_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, float* __restrict__ row_a,
                       float* __restrict__ row_b, const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dqkv, float* __restrict__ drow, int L, int H,
                       int D, int causal, float scale) {
  constexpr int kStride = kMaxD + 8;
  constexpr int kCols = kMaxD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kMmaRows * kStride;
  __nv_bfloat16* k_s = do_s + kMmaRows * kStride;  // [2][kMmaTile][kStride]
  __nv_bfloat16* v_s = k_s + 2 * kMmaTile * kStride;

  const int q0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t qkv_stride = 3 * (int64_t)W;
  const __nv_bfloat16* qkv_b = qkv + b * L * qkv_stride + (int64_t)h * D;
  const __nv_bfloat16* dout_b = dout + b * L * (int64_t)W + (int64_t)h * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int vecs = D / 8, pad_vecs = ((D + 15) & ~15) / 8;

  stage_bf16<kStride>(q_s, qkv_b, qkv_stride, q0, kMmaRows, L, vecs, pad_vecs);
  stage_bf16<kStride>(do_s, dout_b, W, q0, kMmaRows, L, vecs, pad_vecs);
  auto load_kv = [&](int buf, int k0) {
    stage_bf16<kStride>(k_s + buf * kMmaTile * kStride, qkv_b + W, qkv_stride, k0, kMmaTile, L,
                        vecs, pad_vecs);
    stage_bf16<kStride>(v_s + buf * kMmaTile * kStride, qkv_b + 2 * W, qkv_stride, k0, kMmaTile,
                        L, vecs, pad_vecs);
  };
  const int key_end = causal ? min(L, q0 + kMmaRows) : L;
  const int n_tiles = (key_end + kMmaTile - 1) / kMmaTile;
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and the first K/V tile

  // this lane's rows (accumulator rows g and g + 8 of the warp's slab);
  // exponents in log2 units (scores times scale2 = s log2 e). ra, rb: the
  // LSE (and 1), or the running max and this lane's share of the running
  // sum (then 1 / l once sweep 1 ends); dr: this lane's share of Dr's sum
  const float scale2 = scale * kLog2e;
  int row[2];
  float ra[2], rb[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = q0 + warp * 16 + (lane >> 2) + 8 * hr;
    const bool live = row[hr] < L;
    ra[hr] = Rows::kOnline ? -INFINITY : live ? row_a[(b * L + row[hr]) * H + h] * kLog2e : 0.f;
    rb[hr] = Rows::kOnline ? 0.f : 1.f;
    dr[hr] = 0.f;
  }
  float acc[kCols][4];
#pragma unroll
  for (int n = 0; n < kCols; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const __nv_bfloat16* q_frag = q_s + warp * 16 * kStride + frag_offset<kStride>(lane);
  const __nv_bfloat16* do_frag = do_s + warp * 16 * kStride + frag_offset<kStride>(lane);
  // the warp's first row: a slab wholly past L (the ragged last tile) has
  // nothing to compute, and neither has a key tile wholly past the slab's
  // last row under the causal mask
  const int slab0 = q0 + warp * 16;

  // one ring over both sweeps: stage it holds key tile it % n_tiles, the
  // first n_tiles for the statistics, the next n_tiles for dQ
  const int total = 2 * n_tiles;
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {
      // the other buffer was consumed in the previous iteration (its last
      // __syncthreads): fill it with the next tile while this one computes
      load_kv(buf ^ 1, ((it + 1) % n_tiles) * kMmaTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, on the first, Q and dO) is visible to every warp
    const __nv_bfloat16* kt = k_s + buf * kMmaTile * kStride;
    const __nv_bfloat16* vt = v_s + buf * kMmaTile * kStride;
    const int k0 = (it % n_tiles) * kMmaTile;
    if (it == n_tiles && slab0 < L) {
      // the end of sweep 1: the lane quad's shares summed, the statistics
      // stored once a row
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dr[hr] = quad_sum(dr[hr]);
        if (Rows::kOnline) {
          const float l = quad_sum(rb[hr]);
          rb[hr] = l > 0.f ? 1.f / l : 0.f;  // 1 / l; 0 on a row past L
          dr[hr] *= rb[hr];                  // Dr = a / l
        }
        if (t == 0 && row[hr] < L) {
          drow[(b * H + h) * L + row[hr]] = dr[hr];
          if (Rows::kOnline) {
            row_a[(b * L + row[hr]) * H + h] = ra[hr];  // m, log2 units
            row_b[(b * L + row[hr]) * H + h] = rb[hr];  // 1 / l
          }
        }
      }
    }
    if (slab0 >= L || (causal && k0 > slab0 + 15)) {
      __syncthreads();  // the block's barrier, kept by every warp
      continue;
    }

    float s[kMmaN][4], dp[kMmaN][4];
    slab_scores<kMaxD>(s, q_frag, kt + nk_offset<kStride>(lane), pad_vecs);
    slab_scores<kMaxD>(dp, do_frag, vt + nk_offset<kStride>(lane), pad_vecs);
    // the mask, where the tile reaches past L or the diagonal
    const bool edge = k0 + kMmaTile > L || slab0 + 16 > L || (causal && k0 + kMmaTile - 1 > slab0);
    bool valid[kMmaN][4];
#pragma unroll
    for (int n = 0; n < kMmaN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1), r = row[e >> 1];
        valid[n][e] = !edge || (r < L && key < L && (!causal || key <= r));
        s[n][e] *= scale2;
      }

    if (it < n_tiles) {  // sweep 1
      if constexpr (Rows::kOnline) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kMmaN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (valid[n][e]) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float m_new = fmaxf(ra[hr], quad_max(mx[hr]));
          // a row that has seen no valid key keeps its sums at 0, never NaN
          const float alpha = m_new == -INFINITY ? 0.f : exp2f(ra[hr] - m_new);
          rb[hr] *= alpha;
          dr[hr] *= alpha;
          ra[hr] = m_new;
        }
#pragma unroll
        for (int n = 0; n < kMmaN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ev = valid[n][e] ? exp2f(s[n][e] - ra[e >> 1]) : 0.f;
            rb[e >> 1] += ev;
            dr[e >> 1] += ev * dp[n][e];
          }
      } else {
#pragma unroll
        for (int n = 0; n < kMmaN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dr[e >> 1] += valid[n][e] ? Rows::prob2(s[n][e], ra[e >> 1], 1.f) * dp[n][e] : 0.f;
      }
    } else {  // sweep 2
      // dS = P o (dP - Dr), in dP's registers; dQ += dS.K
#pragma unroll
      for (int n = 0; n < kMmaN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const float p = valid[n][e] ? Rows::prob2(s[n][e], ra[hr], rb[hr]) : 0.f;
          dp[n][e] = p * (dp[n][e] - dr[hr]);
        }
      slab_times_tile<kMaxD>(acc, dp, kt + frag_offset<kStride>(lane), vecs);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row[hr] >= L) continue;
    __nv_bfloat16* out = dqkv + (b * L + row[hr]) * qkv_stride + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      if (n < vecs) {
        *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * hr] * scale, acc[n][2 * hr + 1] * scale);
      }
    }
  }
}

// dK and dV. Grid (key tiles of 64, H, B). At head_dim <= 64 the
// registers are held to 128 a thread, four blocks an SM: it fits without
// spilling (ptxas), and the fourth block hides more of the mma and
// ldmatrix latency than the registers it costs (PERF.md §6 has the times,
// from scripts/profile_attention.py).
template <int kMaxD, typename Rows>
__global__ void __launch_bounds__(kThreads, kMaxD <= 64 ? 4 : 1)
mha_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ row_a,
                        const float* __restrict__ row_b, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ drow, __nv_bfloat16* __restrict__ dqkv, int L,
                        int H, int D, int causal, float scale) {
  constexpr int kStride = kMaxD + 8;
  constexpr int kCols = kMaxD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kMmaRows * kStride;
  __nv_bfloat16* q_s = v_s + kMmaRows * kStride;    // [2][kMmaTile][kStride]
  __nv_bfloat16* do_s = q_s + 2 * kMmaTile * kStride;
  float* st_s = reinterpret_cast<float*>(do_s + 2 * kMmaTile * kStride);  // [2][3][kMmaTile]

  const int k0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t qkv_stride = 3 * (int64_t)W;
  const __nv_bfloat16* qkv_b = qkv + b * L * qkv_stride + (int64_t)h * D;
  const __nv_bfloat16* dout_b = dout + b * L * (int64_t)W + (int64_t)h * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int vecs = D / 8, pad_vecs = ((D + 15) & ~15) / 8;

  stage_bf16<kStride>(k_s, qkv_b + W, qkv_stride, k0, kMmaRows, L, vecs, pad_vecs);
  stage_bf16<kStride>(v_s, qkv_b + 2 * W, qkv_stride, k0, kMmaRows, L, vecs, pad_vecs);
  auto load_q = [&](int buf, int q0) {
    stage_bf16<kStride>(q_s + buf * kMmaTile * kStride, qkv_b, qkv_stride, q0, kMmaTile, L, vecs,
                        pad_vecs);
    stage_bf16<kStride>(do_s + buf * kMmaTile * kStride, dout_b, W, q0, kMmaTile, L, vecs,
                        pad_vecs);
    float* st = st_s + buf * 3 * kMmaTile;
    const int i = threadIdx.x;
    if (i < kMmaTile) {
      const int q = q0 + i;
      const bool live = q < L;
      cp_async4(st + i, live ? row_a + (b * L + q) * H + h : row_a, live);
      if (Rows::kOnline) cp_async4(st + kMmaTile + i, live ? row_b + (b * L + q) * H + h : row_b, live);
      cp_async4(st + 2 * kMmaTile + i, live ? drow + (b * H + h) * L + q : drow, live);
    }
  };
  // causal: query rows before k0 see none of this block's keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (L - q_begin + kMmaTile - 1) / kMmaTile;
  load_q(0, q_begin);
  cp_async_commit();  // group 0: K, V and the first query tile

  const float scale2 = scale * kLog2e;
  int key[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) key[hr] = k0 + warp * 16 + (lane >> 2) + 8 * hr;
  float acc_k[kCols][4], acc_v[kCols][4];
#pragma unroll
  for (int n = 0; n < kCols; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const __nv_bfloat16* k_frag = k_s + warp * 16 * kStride + frag_offset<kStride>(lane);
  const __nv_bfloat16* v_frag = v_s + warp * 16 * kStride + frag_offset<kStride>(lane);
  // the warp's first key: a slab wholly past L has nothing to compute, and
  // neither has a query tile wholly before it under the causal mask
  const int slab0 = k0 + warp * 16;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_q(buf ^ 1, q_begin + (tile + 1) * kMmaTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = q_s + buf * kMmaTile * kStride;
    const __nv_bfloat16* dot = do_s + buf * kMmaTile * kStride;
    const float* st = st_s + buf * 3 * kMmaTile;
    const int q0 = q_begin + tile * kMmaTile;
    if (slab0 >= L || (causal && q0 + kMmaTile <= slab0)) {
      __syncthreads();  // the block's barrier, kept by every warp
      continue;
    }

    // S^T and dP^T for the warp's 16 keys by 32 query rows; then P^T and
    // dS^T in their registers (exponents in log2 units, as the dQ kernel's)
    float p[kMmaN][4], ds[kMmaN][4];
    slab_scores<kMaxD>(p, k_frag, qt + nk_offset<kStride>(lane), pad_vecs);
    slab_scores<kMaxD>(ds, v_frag, dot + nk_offset<kStride>(lane), pad_vecs);
    // the mask, where the tile reaches past L or the diagonal
    const bool edge = slab0 + 16 > L || q0 + kMmaTile > L || (causal && q0 < slab0 + 15);
#pragma unroll
    for (int n = 0; n < kMmaN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), q = q0 + c, kk = key[e >> 1];
        const bool valid = !edge || (q < L && kk < L && (!causal || kk <= q));
        // the LSE in log2 units, or m as the dQ kernel wrote it
        const float a2 = Rows::kOnline ? st[c] : st[c] * kLog2e;
        p[n][e] = valid ? Rows::prob2(p[n][e] * scale2, a2, st[kMmaTile + c]) : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] - st[2 * kMmaTile + c]);
      }
    // dV += P^T.dO, dK += dS^T.Q
    slab_times_tile<kMaxD>(acc_v, p, dot + frag_offset<kStride>(lane), vecs);
    slab_times_tile<kMaxD>(acc_k, ds, qt + frag_offset<kStride>(lane), vecs);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (key[hr] >= L) continue;
    __nv_bfloat16* out = dqkv + (b * L + key[hr]) * qkv_stride + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      if (n < vecs) {
        *reinterpret_cast<__nv_bfloat162*>(out + W + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc_k[n][2 * hr] * scale, acc_k[n][2 * hr + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(out + 2 * W + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc_v[n][2 * hr], acc_v[n][2 * hr + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <int kMaxD, typename Rows>
int launch_bf16(const void* qkv, float* row_a, float* row_b, const void* dout, void* dqkv,
                float* drow, int batch, int seq, int heads, int head_dim, int causal, float scale,
                cudaStream_t stream) {
  const int smem = (int)bf16_bwd_smem_bytes<kMaxD>();
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_dq_bf16_kernel<kMaxD, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mha_bwd_dkv_bf16_kernel<kMaxD, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kMmaRows - 1) / kMmaRows, heads, batch);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* d = static_cast<const __nv_bfloat16*>(dout);
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  mha_bwd_dq_bf16_kernel<kMaxD, Rows><<<grid, kThreads, smem, stream>>>(
      q, row_a, row_b, d, out, drow, seq, heads, head_dim, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_bf16_kernel<kMaxD, Rows><<<grid, kThreads, smem, stream>>>(
      q, row_a, row_b, d, drow, out, seq, heads, head_dim, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Rows>
int launch_fp32(const void* qkv, float* row_a, float* row_b, const void* dout, void* dqkv,
                float* drow, int batch, int seq, int heads, int head_dim, int causal, float scale,
                cudaStream_t stream) {
  // Q, dO, K and V tiles of 32 fp32 rows; the dK/dV kernel adds 3 rows of
  // per-row statistics
  const size_t dq_smem = 4 * kTile * (size_t)(head_dim + 4) * sizeof(float);
  const size_t dkv_smem = dq_smem + 3 * kTile * sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_dq_fp32_kernel<Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mha_bwd_dkv_fp32_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const auto* q = static_cast<const float*>(qkv);
  const auto* d = static_cast<const float*>(dout);
  auto* out = static_cast<float*>(dqkv);
  mha_bwd_dq_fp32_kernel<Rows><<<grid, kThreads, dq_smem, stream>>>(
      q, row_a, row_b, d, out, drow, seq, heads, head_dim, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_fp32_kernel<Rows><<<grid, kThreads, dkv_smem, stream>>>(
      q, row_a, row_b, d, drow, out, seq, heads, head_dim, causal, scale);
  return (int)cudaGetLastError();
}

bool valid_bwd_args(const void* qkv, const void* dout, int batch, int seq, int heads,
                    int head_dim, int dtype) {
  // cp.async copies 16-byte vectors: the bf16 path needs qkv and dout on a
  // 16-byte boundary (the wrappers copy a misaligned view first)
  const bool aligned = ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout)) &
                        15) == 0;
  return head_dim > 0 && head_dim <= kMaxHeadDim && head_dim % 8 == 0 && seq > 0 && heads > 0 &&
         batch > 0 && batch <= 65535 && heads <= 65535 &&
         (dtype == 0 || (dtype == 1 && aligned));
}

// Launch the dQ kernel, then the dK/dV kernel, on `stream`; the first CUDA
// error (0 on success). dtype: 0 = fp32, 1 = bf16.
template <typename Rows>
int launch_dq_dkv(const void* qkv, float* row_a, float* row_b, const void* dout, void* dqkv,
                  float* drow, int batch, int seq, int heads, int head_dim, int causal, int dtype,
                  float scale, cudaStream_t stream) {
  if (!valid_bwd_args(qkv, dout, batch, seq, heads, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fp32<Rows>(qkv, row_a, row_b, dout, dqkv, drow, batch, seq, heads, head_dim,
                             causal, scale, stream);
  if (head_dim <= 64)
    return launch_bf16<64, Rows>(qkv, row_a, row_b, dout, dqkv, drow, batch, seq, heads,
                                 head_dim, causal, scale, stream);
  return launch_bf16<128, Rows>(qkv, row_a, row_b, dout, dqkv, drow, batch, seq, heads, head_dim,
                                causal, scale, stream);
}

}  // namespace
