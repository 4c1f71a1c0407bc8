// Fused uniformity potential over the N x N pairwise-distance block, forward
// and backward, without the N x N matrix ever reaching device memory.
//
// Replaces the TPU kernels of sparsify_clip_tpu/ops/pallas_lunif.py:
//   `_fwd_kernel` (under `_pairwise_exp_sum`)  -> sparsify_lunif_fwd
//   `_bwd_kernel` (under `_row_sums_and_wx`)   -> sparsify_lunif_bwd
//
//   x (N, D) fp32 row-major, t > 0 a constant (2.0 in every loss);
//   n_i = |x_i|^2, G = x.x^T, d2_ij = max(n_i + n_j - 2 G_ij, 0),
//   W_ij = exp(-t d2_ij) for i != j and 0 on the diagonal.
//   forward:  S = sum_ij W_ij,  loss = log(S / (N (N - 1)))
//   backward: r_i = sum_j W_ij,  (Wx)_i = sum_j W_ij x_j,
//             dx_i = g ((-4 t / S) (r_i x_i - (Wx)_i))
//
// The diagonal and every index >= N are masked by index before any sum
// (subtracting N afterwards would cancel catastrophically when the
// off-diagonal terms are small). Every product is an fp32 FMA (no tensor
// cores: TF32 would round x to 10 bits, and the JAX side asks for
// Precision.HIGHEST). D is walked in chunks of 128 columns; the backward
// keeps a block's (Wx) rows in shared memory, so D <= 2048.
//
// On the TPU one SMEM accumulator is carried across a sequential grid. Here
// blocks run in no order: each forward block sums its 16 x 32 tile of W and
// writes the partial, and a second one-block pass adds the partials in a
// fixed order and takes the log on the device, so S and the loss never need
// a host read and do not change from run to run. The backward needs no
// cross-block sum: each block owns 16 rows i and walks every j.
//
// Forward and backward see the same W: the norms come from one kernel (one
// warp a row, a fixed reduction tree), and G_ij is the same FMA chain over
// d = 0..D-1 in both, through the same `tile_gram` and `pair_weight`.
//
// What bounds it on an H100: at N = 256, D = 512 the forward needs the i<j
// half of the symmetric Gram, N (N-1) D = 33 MFLOP (these kernels compute
// both halves, 2 N^2 D), and the backward adds 2 N^2 D = 67 MFLOP for W.x,
// over 0.5 MB of input: about 0.5 us and 1.5 us at 67 TFLOP/s of fp32, far
// below launch latency. The forward
// spreads the N^2 tiles over (N/16) x (N/32) = 128 blocks; the backward has
// N/16 = 16 blocks on 132 SMs and is bound by the latency of one block's FMA
// chain, as the InfoNCE backward is (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows i a block owns
constexpr int kColTile = 32;                  // rows j a tile: one a lane
constexpr int kChunk = 128;                   // D columns staged at a time (= kThreads)
constexpr int kSd = kChunk + 1;               // odd row stride: lane-indexed rows hit distinct banks
constexpr int kMaxD = 2048;
constexpr int kNormWarps = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// n_i = sum_d x_id^2: one warp a row, lane-strided partial sums and a fixed
// xor tree.
__global__ void lunif_norms_kernel(const float* __restrict__ x, int N, int D,
                                   float* __restrict__ norms) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // warp-uniform: the whole warp leaves together
  const float* xr = x + (int64_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(xr[d], xr[d], s);
  s = warp_sum(s);
  if (lane == 0) norms[row] = s;
}

// rows [r0, r0 + rows) and columns [c0, c0 + kChunk) of x (N, D) into dst
// with row stride kSd; zero outside x
__device__ void stage(float* dst, const float* __restrict__ x, int rows, int r0, int c0, int N,
                      int D) {
  for (int i = threadIdx.x; i < rows * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i - r * kChunk;
    const int row = r0 + r, col = c0 + c;
    dst[r * kSd + c] = row < N && col < D ? x[(int64_t)row * D + col] : 0.f;
  }
}

// g[n] = x_{r0 + warp*4 + n} . x_{j0 + lane} for the block's rows against
// one tile of 32 rows. Ends with a barrier-free read of the staged tiles;
// the caller syncs before restaging them.
__device__ void tile_gram(const float* __restrict__ x, int N, int D, int r0, int j0, float* a_s,
                          float* b_s, float (&g)[kRowsPerWarp]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) g[n] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage(a_s, x, kRows, r0, c0, N, D);
    stage(b_s, x, kColTile, j0, c0, N, D);
    __syncthreads();
    const int w = min(kChunk, D - c0);
    const float* bl = b_s + lane * kSd;
    for (int d = 0; d < w; ++d) {
      const float bv = bl[d];
#pragma unroll
      for (int n = 0; n < kRowsPerWarp; ++n)
        g[n] = fmaf(a_s[(warp * kRowsPerWarp + n) * kSd + d], bv, g[n]);
    }
  }
}

// W_ij from the norms and the Gram entry, 0 where the pair is masked. The
// FMA is written out so that no contraction choice of the compiler can make
// the forward's W differ from the backward's.
__device__ __forceinline__ float pair_weight(float ni, float nj, float g, float t, bool keep) {
  const float d2 = fmaxf(fmaf(-2.f, g, ni + nj), 0.f);
  return keep ? expf(-t * d2) : 0.f;
}

// One 16 x 32 tile of W a block (blockIdx.x: rows i, blockIdx.y: rows j);
// writes the tile's sum to partial[blockIdx.y * gridDim.x + blockIdx.x].
__global__ void __launch_bounds__(kThreads)
lunif_fwd_kernel(const float* __restrict__ x, const float* __restrict__ norms, int N, int D,
                 float t, float* __restrict__ partial) {
  __shared__ float a_s[kRows * kSd];
  __shared__ float b_s[kColTile * kSd];
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows, j0 = blockIdx.y * kColTile;
  float g[kRowsPerWarp];
  tile_gram(x, N, D, r0, j0, a_s, b_s, g);
  const int j = j0 + lane;
  const float nj = j < N ? norms[j] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    const int r = r0 + warp * kRowsPerWarp + n;
    const float ni = r < N ? norms[r] : 0.f;
    s += pair_weight(ni, nj, g[n], t, r < N && j < N && r != j);
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    partial[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

// S = sum of the partials in a fixed order; loss = log(S / (N (N - 1))).
__global__ void lunif_sum_kernel(const float* __restrict__ partial, int n_partial, int N,
                                 float* __restrict__ s_out, float* __restrict__ loss) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) s += partial[i];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
    s_out[0] = total;
    loss[0] = logf(total / (float)((long long)N * (N - 1)));
  }
}

// dx for the block's 16 rows: W recomputed tile by tile as the forward
// computes it; r and Wx accumulate in the block (r in registers, one
// partial a lane, Wx in shared memory, one column a thread); S and g are
// read from device memory.
__global__ void __launch_bounds__(kThreads)
lunif_bwd_kernel(const float* __restrict__ x, const float* __restrict__ norms,
                 const float* __restrict__ s_ptr, const float* __restrict__ g_ptr, int N, int D,
                 float t, float* __restrict__ dx) {
  extern __shared__ float smem[];
  float* a_s = smem;                             // kRows x kSd
  float* b_s = a_s + kRows * kSd;                // kColTile x kSd
  float* w_s = b_s + kColTile * kSd;             // kRows x (kColTile + 1)
  float* acc_s = w_s + kRows * (kColTile + 1);   // kRows x D: (Wx) rows
  __shared__ float r_s[kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) acc_s[i] = 0.f;

  float ni[kRowsPerWarp], r_part[kRowsPerWarp], g[kRowsPerWarp];
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    const int r = r0 + warp * kRowsPerWarp + n;
    ni[n] = r < N ? norms[r] : 0.f;
    r_part[n] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kColTile) {
    tile_gram(x, N, D, r0, j0, a_s, b_s, g);
    const int j = j0 + lane;
    const float nj = j < N ? norms[j] : 0.f;
#pragma unroll
    for (int n = 0; n < kRowsPerWarp; ++n) {
      const int rl = warp * kRowsPerWarp + n;
      const int r = r0 + rl;
      const float w = pair_weight(ni[n], nj, g[n], t, r < N && j < N && r != j);
      r_part[n] += w;
      w_s[rl * (kColTile + 1) + lane] = w;
    }
    // acc += W_tile . x_tile, one column a thread, chunk by chunk
    const int n_cols = min(kColTile, N - j0);
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      __syncthreads();  // w_s is written; the last b_s chunk is consumed
      stage(b_s, x, kColTile, j0, c0, N, D);
      __syncthreads();
      const int col = c0 + threadIdx.x;
      if (col < D) {
        for (int rl = 0; rl < kRows; ++rl) {
          float acc = acc_s[rl * D + col];
          for (int jj = 0; jj < n_cols; ++jj)
            acc = fmaf(w_s[rl * (kColTile + 1) + jj], b_s[jj * kSd + threadIdx.x], acc);
          acc_s[rl * D + col] = acc;
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    const float r = warp_sum(r_part[n]);
    if (lane == 0) r_s[warp * kRowsPerWarp + n] = r;
  }
  __syncthreads();
  const float coef = (-4.f * t) / *s_ptr;
  const float gin = *g_ptr;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int rl = i / D;
    const int r = r0 + rl;
    if (r < N) {
      const int64_t at = (int64_t)r * D + (i - rl * D);
      dx[at] = gin * (coef * (x[at] * r_s[rl] - acc_s[i]));
    }
  }
}

int row_blocks(int n) { return (n + kRows - 1) / kRows; }
int col_tiles(int n) { return (n + kColTile - 1) / kColTile; }

bool bad_shape(int n, int d) { return n < 2 || d <= 0 || d > kMaxD; }

cudaError_t launch_norms(const float* x, int n, int d, float* norms, cudaStream_t s) {
  lunif_norms_kernel<<<(n + kNormWarps - 1) / kNormWarps, kNormWarps * 32, 0, s>>>(x, n, d,
                                                                                   norms);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 on success). Scratch is allocated by the wrapper:
// norms, N floats; partial, ceil(N / 16) * ceil(N / 32) floats.
extern "C" int sparsify_lunif_fwd(const float* x, int n, int d, float t, float* norms,
                                  float* partial, float* s_out, float* loss, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_norms(x, n, d, norms, s);
  if (err != cudaSuccess) return (int)err;
  lunif_fwd_kernel<<<dim3(row_blocks(n), col_tiles(n)), kThreads, 0, s>>>(x, norms, n, d, t,
                                                                           partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lunif_sum_kernel<<<1, 256, 0, s>>>(partial, row_blocks(n) * col_tiles(n), n, s_out, loss);
  return (int)cudaGetLastError();
}

extern "C" int sparsify_lunif_bwd(const float* x, const float* s_ptr, const float* g_ptr, int n,
                                  int d, float t, float* norms, float* dx, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_norms(x, n, d, norms, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (kRows * kSd + kColTile * kSd + kRows * (kColTile + 1) + (size_t)kRows * d) * sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  err = cudaFuncSetAttribute(lunif_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lunif_bwd_kernel<<<row_blocks(n), kThreads, smem, s>>>(x, norms, s_ptr, g_ptr, n, d, t, dx);
  return (int)cudaGetLastError();
}
