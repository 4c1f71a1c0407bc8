// Fused symmetric InfoNCE over the B x B similarity block, forward and
// backward, without the logits ever reaching device memory.
//
// Replaces the TPU kernels of sparsify_clip_tpu/ops/pallas_infonce.py:
//   `_fwd_kernel`      (under `_run_fwd`)  -> sparsify_infonce_fwd
//   `_bwd_dimg_kernel` (under `_run_bwd`)  -> sparsify_infonce_bwd_dimg
//   `_bwd_dtxt_kernel` (under `_run_bwd`)  -> sparsify_infonce_bwd_dtxt
//
//   img, txt (N, D) fp32 row-major; T is the raw temperature divisor, read
//   from device memory (no host sync per step); Z = img.txt^T / T.
//   forward:  row_lse_i = LSE_j Z_ij, col_lse_j = LSE_i Z_ij,
//             loss = ((sum row_lse - sum diag) / N + (sum col_lse - sum diag) / N) / 2
//   backward: dZ = g / (2N) (exp(Z - row_lse) + exp(Z - col_lse) - 2 I),
//             d_img = dZ.txt / T,  d_txt = dZ^T.img / T,  dT = -sum(dZ o Z) / T
//
// Every product is an fp32 FMA (no tensor cores: TF32 would round the
// embeddings to 10 bits, and the JAX side asks for Precision.HIGHEST). The
// TPU pads N to 128-row tiles; here every row and column index is masked
// against N, so any N works, and D is walked in chunks; the entry points
// and their wrappers refuse D > 2048.
//
// One kernel body serves both directions of each pass: the column LSE of Z
// is the row LSE of Z^T = txt.img^T / T, and d_txt is the d_img of the
// transposed problem with the two LSE vectors swapped. Every logit is one
// fmaf chain over d = 0..D-1 in ascending order, divided by T, in the
// forward (`tile_logits`) and in the backward (`pair::dot_chunk`), in either
// direction, so the forward's LSE and the backward's dZ see the same Z.
//
// Forward: a block takes 16 rows of its side (4 a warp) and walks the other
// side in tiles of 32 rows, one a lane; the row LSE is an online max/sum
// across the tiles, and a one-block pass sums the loss in a fixed order.
//
// Backward, on `pair_tiles.cuh`: a grid of (i-tile, j-split, column split)
// blocks over 32 x 32 tiles of Z, 64 of them at N = 256 and 128 once D's
// columns are split (48 at N = 64, D = 768). A block computes its tile of Z
// and dZ, and writes its share of dZ.b for its columns (and, for d_img, of
// sum(dZ o Z)) to scratch; a second kernel adds the j-splits' shares in
// ascending order, divides by T and, for d_img, sums dT's shares in a fixed
// order. Two launches a direction; no atomics, so two runs agree bit for
// bit.
//
// What bounds it on an H100: at N = 256, D = 512 the forward is 2 x 67 MFLOP
// and each backward direction 2 x 67 MFLOP over 1 MB of embeddings: about 2
// us at 67 TFLOP/s of fp32, below the two launches. The forward's 16 blocks
// a direction at N = 256 are bound by the latency of one block's FMA chain;
// the backward's blocks by shared memory's bandwidth into registers
// (`pair_tiles.cuh`), its calls by that and their two launches (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows of its own side a block owns
constexpr int kColTile = 32;                  // rows of the other side a tile: one per lane
constexpr int kChunk = 128;                   // D columns staged at a time
constexpr int kSd = kChunk + 1;               // odd row stride: lane-indexed rows hit distinct banks
constexpr int kMaxD = 2048;
using pair::kFullMask;
using pair::warp_sum;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
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

// z[n] = (a_{r0 + warp*4 + n} . b_{j0 + lane}) / T for the block's rows
// against one tile of the other side. Ends with a barrier-free read of the
// staged tiles; the caller syncs before restaging them.
__device__ void tile_logits(const float* __restrict__ a, const float* __restrict__ b, int N,
                            int D, int r0, int j0, float T, float* a_s, float* b_s,
                            float (&z)[kRowsPerWarp]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) z[n] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage(a_s, a, kRows, r0, c0, N, D);
    stage(b_s, b, kColTile, j0, c0, N, D);
    __syncthreads();
    const int w = min(kChunk, D - c0);
    const float* bl = b_s + lane * kSd;
    for (int d = 0; d < w; ++d) {
      const float bv = bl[d];
#pragma unroll
      for (int n = 0; n < kRowsPerWarp; ++n)
        z[n] = fmaf(a_s[(warp * kRowsPerWarp + n) * kSd + d], bv, z[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) z[n] /= T;
}

// Row LSE of a.b^T / T; blockIdx.y picks the direction: 0 gives row_lse
// (a = img) and the diagonal logits, 1 gives col_lse (a = txt).
__global__ void __launch_bounds__(kThreads)
infonce_lse_kernel(const float* __restrict__ img, const float* __restrict__ txt,
                   const float* __restrict__ temp, int N, int D, float* __restrict__ row_lse,
                   float* __restrict__ col_lse, float* __restrict__ diag) {
  __shared__ float a_s[kRows * kSd];
  __shared__ float b_s[kColTile * kSd];
  const bool rows = blockIdx.y == 0;
  const float* a = rows ? img : txt;
  const float* b = rows ? txt : img;
  float* out = rows ? row_lse : col_lse;
  const float T = *temp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;

  float m[kRowsPerWarp], l[kRowsPerWarp], z[kRowsPerWarp];
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    m[n] = -INFINITY;
    l[n] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kColTile) {
    tile_logits(a, b, N, D, r0, j0, T, a_s, b_s, z);
    const int j = j0 + lane;
#pragma unroll
    for (int n = 0; n < kRowsPerWarp; ++n) {
      const int r = r0 + warp * kRowsPerWarp + n;
      if (rows && r == j && r < N) diag[r] = z[n];
      const float zz = j < N ? z[n] : -INFINITY;
      const float m_new = fmaxf(m[n], warp_max(zz));  // finite: column j0 < N is valid
      l[n] = l[n] * expf(m[n] - m_new) + warp_sum(j < N ? expf(zz - m_new) : 0.f);
      m[n] = m_new;
    }
  }
#pragma unroll
  for (int n = 0; n < kRowsPerWarp; ++n) {
    const int r = r0 + warp * kRowsPerWarp + n;
    if (r < N && lane == 0) out[r] = m[n] + logf(l[n]);
  }
}

// Block-wide sum in a fixed order (the caller passes each thread's share).
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

__global__ void infonce_loss_kernel(const float* __restrict__ row_lse,
                                    const float* __restrict__ col_lse,
                                    const float* __restrict__ diag, int N,
                                    float* __restrict__ loss) {
  __shared__ float red[32];
  float r = 0.f, c = 0.f, d = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    r += row_lse[i];
    c += col_lse[i];
    d += diag[i];
  }
  r = block_sum(r, red);
  c = block_sum(c, red);
  d = block_sum(d, red);
  if (threadIdx.x == 0) loss[0] = ((r - d) / N + (c - d) / N) / 2.f;
}

// First pass of the backward, d_a = dZ.b / T, where a.b^T / T is Z in this
// direction (lse_a indexes a's rows, lse_b b's): block (bi, s, z) walks the
// j-tiles of split s against i-tile bi; for each it computes the logits
// tile, dZ into shared memory and dZ.b's share for column slice z, added to
// share[s] (s, N, D). With dt_share non-null, blocks z = 0 also write their
// share of sum(dZ o Z) to dt_share[s * gridDim.x + bi]. No __launch_bounds__:
// under one ptxas caps the kernel at 128 registers and spills; without, it
// takes 110 and spills nothing.
__global__ void
infonce_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ temp, const float* __restrict__ g,
                   const float* __restrict__ lse_a, const float* __restrict__ lse_b, int N, int D,
                   int z_cols, bool vec, float* __restrict__ share, float* __restrict__ dt_share) {
  __shared__ pair::Smem sm;
  __shared__ float red[pair::kThreads / 32];
  const float T = *temp;
  const float coef = *g / (2.f * N);
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int i0 = blockIdx.x * pair::kTile, s = blockIdx.y;
  const int c_begin = blockIdx.z * z_cols, c_end = min(D, c_begin + z_cols);
  int jt_begin, jt_end;
  pair::split_range(gridDim.x, gridDim.y, s, &jt_begin, &jt_end);
  float dt = 0.f;
  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int j0 = jt * pair::kTile;
    const auto grads = [&](const float (&z)[2][2]) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int il = ti + 16 * u, jl = tj + 16 * v;
          const int i = i0 + il, j = j0 + jl;
          const float zz = z[u][v] / T;
          float dz = 0.f;
          if (i < N && j < N) {
            dz = coef * (expf(zz - lse_a[i]) + expf(zz - lse_b[j]) - (i == j ? 2.f : 0.f));
            dt = fmaf(dz, zz, dt);
          }
          sm.wt[jl][il] = dz;
        }
      __syncthreads();
    };
    pair::pair_tile(sm, a, b, N, D, i0, j0, c_begin, c_end, share + (size_t)s * N * D,
                    jt == jt_begin, vec, [](const auto&, int) {}, grads);
  }
  if (dt_share != nullptr && blockIdx.z == 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    dt = warp_sum(dt);
    if (lane == 0) red[warp] = dt;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < pair::kThreads / 32; ++w) total += red[w];
      dt_share[s * gridDim.x + blockIdx.x] = total;
    }
  }
}

// Second pass: d_a = (the splits' shares added in ascending order) / T, a
// thread for 4 consecutive columns of a row; with dt_share non-null, warp 0
// of block 0 also adds the n_dt shares of sum(dZ o Z) (lane-strided, then a
// fixed xor tree) into dT = -sum / T.
__global__ void infonce_bwd_finish_kernel(const float* __restrict__ share, int splits,
                                          const float* __restrict__ temp, int N, int D, bool vec,
                                          float* __restrict__ d_a,
                                          const float* __restrict__ dt_share, int n_dt,
                                          float* __restrict__ d_temp) {
  const float T = *temp;
  if (dt_share != nullptr && blockIdx.x == 0 && threadIdx.x < 32) {
    float s = 0.f;
    for (int k = threadIdx.x; k < n_dt; k += 32) s += dt_share[k];
    s = warp_sum(s);
    if (threadIdx.x == 0) d_temp[0] = -s / T;
  }
  const int quads = (D + 3) / 4;
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (int64_t)N * quads) return;
  const int i = (int)(k / quads), c = (int)(k % quads) * 4;
  const size_t plane = (size_t)N * D, at = (size_t)i * D + c;
  if (vec) {
    float4 acc = *reinterpret_cast<const float4*>(share + at);
    for (int s = 1; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(share + s * plane + at);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    *reinterpret_cast<float4*>(d_a + at) =
        make_float4(acc.x / T, acc.y / T, acc.z / T, acc.w / T);
  } else {
    for (int e = 0; e < 4 && c + e < D; ++e) {
      float acc = share[at + e];
      for (int s = 1; s < splits; ++s) acc += share[s * plane + at + e];
      d_a[at + e] = acc / T;
    }
  }
}

int n_blocks(int n) { return (n + kRows - 1) / kRows; }

// Both passes of one direction's backward; dt_share and d_temp null for d_txt.
int launch_bwd(const float* a, const float* b, const float* temp, const float* g,
               const float* lse_a, const float* lse_b, int n, int d, float* d_a, float* scratch,
               float* d_temp, cudaStream_t stream) {
  const pair::Plan p = pair::plan(n, d);
  const bool vec = pair::vec_ok(d, a, b, d_a) && pair::vec_ok(d, scratch, scratch, scratch);
  float* dt_share = d_temp != nullptr ? scratch + p.share_floats(n, d) : nullptr;
  infonce_bwd_kernel<<<p.grid(), pair::kThreads, 0, stream>>>(a, b, temp, g, lse_a, lse_b, n,
                                                              d, p.z_cols, vec, scratch, dt_share);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)n * ((d + 3) / 4);
  infonce_bwd_finish_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      scratch, p.splits, temp, n, d, vec, d_a, dt_share, p.tiles * p.splits, d_temp);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int d) { return n <= 0 || d <= 0 || d > kMaxD; }

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 on success). Scratch is allocated by the wrapper:
// for the forward, diag, N floats; for either backward,
// sparsify_infonce_bwd_scratch(N, D) floats.
extern "C" int sparsify_infonce_fwd(const float* img, const float* txt, const float* temp, int n,
                                    int d, float* loss, float* row_lse, float* col_lse,
                                    float* diag, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  infonce_lse_kernel<<<dim3(n_blocks(n), 2), kThreads, 0, s>>>(img, txt, temp, n, d, row_lse,
                                                               col_lse, diag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  infonce_loss_kernel<<<1, 256, 0, s>>>(row_lse, col_lse, diag, n, loss);
  return (int)cudaGetLastError();
}

// The backward's scratch in floats: dZ.b's shares (splits, N, D), then the
// (splits x i-tiles) shares of sum(dZ o Z); 0 for a shape the kernels refuse.
extern "C" long long sparsify_infonce_bwd_scratch(int n, int d) {
  if (bad_shape(n, d)) return 0;
  const pair::Plan p = pair::plan(n, d);
  return (long long)p.share_floats(n, d) + (long long)p.tiles * p.splits;
}

extern "C" int sparsify_infonce_bwd_dimg(const float* img, const float* txt, const float* temp,
                                         const float* g, const float* row_lse,
                                         const float* col_lse, int n, int d, float* d_img,
                                         float* scratch, float* d_temp, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  return launch_bwd(img, txt, temp, g, row_lse, col_lse, n, d, d_img, scratch, d_temp,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int sparsify_infonce_bwd_dtxt(const float* img, const float* txt, const float* temp,
                                         const float* g, const float* row_lse,
                                         const float* col_lse, int n, int d, float* d_txt,
                                         float* scratch, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  return launch_bwd(txt, img, temp, g, col_lse, row_lse, n, d, d_txt, scratch, nullptr,
                    static_cast<cudaStream_t>(stream));
}
