// The dQ and dK/dV passes shared by the two attention backwards:
// `mha_bwd.cu` (P rebuilt from the forward's saved row LSE) and
// `mha_head_group.cu` (P rebuilt from a row max and a row sum that its own
// stats pass recomputes). Each includes this file and instantiates the
// kernels with its row policy; the anonymous namespace keeps the two
// copies apart at link time.
//
//   qkv  (B, L, 3W), bf16 or fp32 (W = H * D): q at column h*D, k at
//        W + h*D, v at 2W + h*D;
//   row_a, row_b (B, L, H) fp32: the row statistics P is formed from;
//   dout (B, L, W), qkv's type;
//   drow (B, H, L) fp32: Dr = rowsum(dP o P), written by the dQ kernel's
//        first pass (SavedLse) or given (HeadGroupRows);
//   dqkv (B, L, 3W), qkv's type.
//
// With S = Q.K^T * s (s = D^-0.5) and the causal mask col > row:
//   dV = P^T.dO,  dP = dO.V^T,  dS = P o (dP - Dr),  dQ = dS.K * s,
//   dK = dS^T.Q * s.
// `mha_bwd_dq_kernel`: a block takes one (batch, head) and 32 query rows,
// walks the keys in tiles of 32 (twice when it sums Dr itself) and
// accumulates dQ. `mha_bwd_dkv_kernel`: a block takes one (batch, head) and
// 32 keys, walks the query rows in tiles of 32 (from its own first key on
// when causal) and accumulates dK and dV. No atomics; deterministic. S and
// dP are recomputed in each pass with the same fp32 FMAs in the same order
// (`pair_dots`), so every pass sees bitwise the same P. All products run on
// fp32 FMAs out of shared memory (bf16 inputs are widened on the way in).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                        // query rows and keys a tile: one per lane
constexpr int kRowsPerWarp = kTile / kWarps;     // tile rows a warp owns
constexpr int kColsPerLane = kMaxHeadDim / 32;   // gradient columns a lane owns
constexpr unsigned kFullMask = 0xffffffffu;

// P from the forward's row log-sum-exp: P = exp(S - LSE). row_a is the
// LSE, row_b is not read; the dQ kernel sums Dr in a first pass.
struct SavedLse {
  static constexpr bool kDrGiven = false;
  __device__ static __forceinline__ float prob(float s, float lse, float) { return expf(s - lse); }
};

// P from a recomputed row max m (row_a) and sum l = sum exp(S - m) (row_b),
// normalised by division as the TPU head-group kernel does
// (pallas_attention.py:250-252); Dr is given in drow.
struct HeadGroupRows {
  static constexpr bool kDrGiven = true;
  __device__ static __forceinline__ float prob(float s, float m, float l) {
    return expf(s - m) / l;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Rows [r0, r0 + kTile) of one head's D columns (source row stride `stride`
// elements) into shared memory as fp32, row stride sd; rows past L are zero.
template <typename T>
__device__ void stage(float* dst, int sd, const T* src, int64_t stride, int r0, int L, int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    dst[r * sd + d] = row < L ? to_float(src[row * stride + d]) : 0.f;
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

// dQ (and, for SavedLse, the row sums Dr). Grid (query tiles, H, B).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ row_a,
                  const float* __restrict__ row_b, const T* __restrict__ dout,
                  T* __restrict__ dqkv, float* __restrict__ drow, int L, int H, int D, int causal,
                  float scale) {
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
  const T* qkv_b = qkv + b * L * qkv_stride + (int64_t)h * D;
  const T* dout_b = dout + b * L * (int64_t)W + (int64_t)h * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage(q_s, sd, qkv_b, qkv_stride, q0, L, D);
  stage(do_s, sd, dout_b, (int64_t)W, q0, L, D);

  int row[kRowsPerWarp];
  float ra[kRowsPerWarp], rb[kRowsPerWarp], dr[kRowsPerWarp];
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    row[n] = q0 + warp + kWarps * n;
    const bool live = row[n] < L;
    ra[n] = live ? row_a[(b * L + row[n]) * H + h] : 0.f;
    rb[n] = Rows::kDrGiven && live ? row_b[(b * L + row[n]) * H + h] : 1.f;
    dr[n] = Rows::kDrGiven && live ? drow[(b * H + h) * L + row[n]] : 0.f;
  }

  const int key_end = causal ? min(L, q0 + kTile) : L;
  float s[kRowsPerWarp], dp[kRowsPerWarp];

  // pass 1: Dr = rowsum(dP o P)
  if (!Rows::kDrGiven) {
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
        const float p = valid ? Rows::prob(s[n] * scale, ra[n], rb[n]) : 0.f;
        dr[n] += warp_sum(p * dp[n]);
      }
    }
  }

  // pass 2: dS = P o (dP - Dr); dQ = dS.K
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
    T* out = dqkv + (b * L + row[n]) * qkv_stride + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[d] = from_float<T>(acc[n][c] * scale);
    }
    if (!Rows::kDrGiven && lane == 0) drow[(b * H + h) * L + row[n]] = dr[n];
  }
}

// dK and dV. Grid (key tiles, H, B).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ row_a,
                   const float* __restrict__ row_b, const T* __restrict__ dout,
                   const float* __restrict__ drow, T* __restrict__ dqkv, int L, int H, int D,
                   int causal, float scale) {
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
  const T* qkv_b = qkv + b * L * qkv_stride + (int64_t)h * D;
  const T* dout_b = dout + b * L * (int64_t)W + (int64_t)h * D;
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
      rb_s[threadIdx.x] = Rows::kDrGiven && live ? row_b[(b * L + r) * H + h] : 1.f;
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
    T* out = dqkv + (b * L + key[n]) * qkv_stride + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        out[W + d] = from_float<T>(acc_k[n][c] * scale);
        out[2 * W + d] = from_float<T>(acc_v[n][c]);
      }
    }
  }
}

// Shared memory of the dQ kernel: Q, dO, K and V tiles of 32 fp32 rows.
inline size_t dq_smem_bytes(int head_dim) {
  return 4 * kTile * (size_t)(head_dim + 4) * sizeof(float);
}

// Launch the dQ kernel, then the dK/dV kernel, on `stream`; the first CUDA
// error (0 on success).
template <typename T, typename Rows>
int launch_dq_dkv(const void* qkv, const float* row_a, const float* row_b, const void* dout,
                  void* dqkv, float* drow, int batch, int seq, int heads, int head_dim, int causal,
                  float scale, cudaStream_t stream) {
  const size_t dq_smem = dq_smem_bytes(head_dim);
  const size_t dkv_smem = dq_smem + 3 * kTile * sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_dq_kernel<T, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mha_bwd_dkv_kernel<T, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const dim3 block(kThreads);
  mha_bwd_dq_kernel<T, Rows><<<grid, block, dq_smem, stream>>>(
      static_cast<const T*>(qkv), row_a, row_b, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), drow, seq, heads, head_dim, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_dkv_kernel<T, Rows><<<grid, block, dkv_smem, stream>>>(
      static_cast<const T*>(qkv), row_a, row_b, static_cast<const T*>(dout), drow,
      static_cast<T*>(dqkv), seq, heads, head_dim, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace
