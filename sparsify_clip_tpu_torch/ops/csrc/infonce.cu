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
// Every logit is one fmaf chain over d = 0..D-1 in ascending order, divided
// by T, in the forward and in the backward, in either direction
// (`pair::dot_chunk`; fmaf(a, b, c) = fmaf(b, a, c)), so the forward's LSE
// and the backward's dZ see the same Z: at N = 1 the LSE is Z_11 and every
// gradient exactly 0.
//
// Forward, on `pair_tiles.cuh`: a grid of 16 x 16 tiles of Z (256 blocks
// at N = 256, 16 at N = 64). A block computes its tile of Z once and takes both directions
// from it: each of its rows' and each of its columns' (max, sum of exp)
// over the tile go to scratch, and a diagonal tile writes Z_ii. A one-block
// second pass merges each row's and each column's partials in ascending
// tile order (m = max m_k, l = sum l_k exp(m_k - m), LSE = m + log l) and
// sums the loss in a fixed order.
//
// Backward, on `pair_tiles.cuh`: a grid of (i-tile, j-split, column split)
// blocks over 32 x 32 tiles of Z, 64 of them at N = 256 and 128 once D's
// columns are split (48 at N = 64, D = 768). A block computes its tile of Z
// and dZ, and writes its share of dZ.b for its columns (and, for d_img, of
// sum(dZ o Z)) to scratch; a second kernel adds the j-splits' shares in
// ascending order, divides by T and, for d_img, sums dT's shares in a fixed
// order. One kernel body serves both directions: d_txt is the d_img of the
// transposed problem, Z^T = txt.img^T / T, with the two LSE vectors swapped.
//
// Two launches a call, forward or backward direction; no atomics, so two
// runs agree bit for bit.
//
// What bounds it on an H100: at N = 256, D = 512 the forward is 67 MFLOP and
// each backward direction 2 x 67 MFLOP over 1 MB of embeddings: about 1 and
// 2 us at 67 TFLOP/s of fp32, below the two launches. No split of D (it
// would change Z's rounding), so a block's floor is its D-long FMA chain and
// its staging; the forward's 16 x 16 tiles put a block on every SM at N =
// 256, and the backward's blocks are bound by shared memory's bandwidth
// into registers (`pair_tiles.cuh`); each call by that and its two
// launches (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_tiles.cuh"

namespace {

constexpr int kMaxD = 2048;
constexpr int kFinishThreads = 512;
using pair::kFullMask;
using pair::warp_sum;

// Forward, first pass: block (x, y) takes the K x K tile of Z at j-tile x,
// i-tile y, computes it once and takes both directions from it: for each
// of its rows i the tile's (max, sum of exp) over its columns, written to
// row_part[x][i], and for each of its columns j the same over its rows, to
// col_part[y][j] ((tiles, N) pairs each); a diagonal tile writes Z_ii to
// diag. The 2K lines (rows, then columns) take K/8 consecutive threads
// each, 8 entries a thread, and a fixed xor tree.
__global__ void __launch_bounds__(pair::kFwdThreads)
infonce_fwd_kernel(const float* __restrict__ img, const float* __restrict__ txt,
                   const float* __restrict__ temp, int N, int D, bool vec,
                   float2* __restrict__ row_part, float2* __restrict__ col_part,
                   float* __restrict__ diag) {
  constexpr int K = pair::kFwdTile, kHalf = K / 2, kPer = K / 8;  // kPer: threads a line
  __shared__ pair::FwdRing ring;
  __shared__ float zs[K][K + 1];
  const float T = *temp;
  const int i0 = blockIdx.y * K, j0 = blockIdx.x * K;
  float p[2][2] = {};
  pair::dot_tile(ring, img, txt, N, D, i0, j0, vec, [](const auto&, int) {}, p);
  const int ti = threadIdx.x / kHalf, tj = threadIdx.x % kHalf;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int il = ti + kHalf * u, jl = tj + kHalf * v;
      const float z = p[u][v] / T;
      zs[il][jl] = z;
      if (i0 == j0 && il == jl && i0 + il < N) diag[i0 + il] = z;
    }
  __syncthreads();
  const int line = threadIdx.x / kPer, part = threadIdx.x % kPer;
  const bool is_row = line < K;
  const int l = is_row ? line : line - K;
  const int along0 = is_row ? j0 : i0;  // the first index along the line
  float z[8];
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = part * 8 + q;
    z[q] = along0 + e < N ? (is_row ? zs[l][e] : zs[e][l]) : -INFINITY;
    m = fmaxf(m, z[q]);
  }
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
  float sum = 0.f;  // m is finite: entry along0 < N is in every line
#pragma unroll
  for (int q = 0; q < 8; ++q) sum += along0 + part * 8 + q < N ? expf(z[q] - m) : 0.f;
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
  const int idx = (is_row ? i0 : j0) + l;
  if (part == 0 && idx < N)
    (is_row ? row_part[(size_t)blockIdx.x * N + idx] : col_part[(size_t)blockIdx.y * N + idx]) =
        make_float2(m, sum);
}

// LSE of line i from its tiles' partials part[k][i] = (m_k, l_k): m = max
// m_k, then l = sum l_k exp(m_k - m) with k ascending, LSE = m + log l. The
// loads go out kBatch at a time (a warp's lanes on consecutive lines), and
// the first batch stays in registers, so up to kBatch tiles a thread waits
// on one round trip. A missing tile reads (-inf, 0) and adds +0 to l > 0.
__device__ __forceinline__ float merge_lse(const float2* __restrict__ part, int tiles, int N,
                                           int i) {
  constexpr int kBatch = 16;
  const auto load = [&](float2 (&v)[kBatch], int k0) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      v[q] = k0 + q < tiles ? part[(size_t)(k0 + q) * N + i] : make_float2(-INFINITY, 0.f);
  };
  float2 first[kBatch], v[kBatch];
  load(first, 0);
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < kBatch; ++q) m = fmaxf(m, first[q].x);
  for (int k0 = kBatch; k0 < tiles; k0 += kBatch) {
    load(v, k0);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) m = fmaxf(m, v[q].x);
  }
  float l = 0.f;
#pragma unroll
  for (int q = 0; q < kBatch; ++q) l += first[q].y * expf(first[q].x - m);
  for (int k0 = kBatch; k0 < tiles; k0 += kBatch) {
    load(v, k0);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) l += v[q].y * expf(v[q].x - m);
  }
  return m + logf(l);
}

// Forward, second pass, one block: the 2N lines' LSEs (rows, then
// columns, a thread a line) from the partials, then loss = ((sum row_lse -
// sum diag) / N + (sum col_lse - sum diag) / N) / 2, each sum a thread's
// lines in order, a warp's xor tree, then the warps in order.
__global__ void __launch_bounds__(kFinishThreads)
infonce_fwd_finish_kernel(const float2* __restrict__ row_part, const float2* __restrict__ col_part,
                          const float* __restrict__ diag, int tiles, int N,
                          float* __restrict__ row_lse, float* __restrict__ col_lse,
                          float* __restrict__ loss) {
  constexpr int kWarps = kFinishThreads / 32;
  __shared__ float red[3][kWarps];
  float sums[3] = {};  // row LSEs, column LSEs, the diagonal
  for (int line = threadIdx.x; line < 2 * N; line += kFinishThreads) {
    const bool is_row = line < N;
    const int i = is_row ? line : line - N;
    const float lse = merge_lse(is_row ? row_part : col_part, tiles, N, i);
    if (is_row) {
      row_lse[i] = lse;
      sums[0] += lse;
      sums[2] += diag[i];
    } else {
      col_lse[i] = lse;
      sums[1] += lse;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total[3] = {};
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total[k] += red[k][w];
    loss[0] = ((total[0] - total[2]) / N + (total[1] - total[2]) / N) / 2.f;
  }
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

// Tiles a side of the forward's grid.
int fwd_tiles(int n) { return (n + pair::kFwdTile - 1) / pair::kFwdTile; }

int launch_fwd(const float* img, const float* txt, const float* temp, int n, int d, float* loss,
               float* row_lse, float* col_lse, float* scratch, cudaStream_t stream) {
  const int tiles = fwd_tiles(n);
  float2* row_part = reinterpret_cast<float2*>(scratch);  // 8-byte aligned: the buffer's start
  float2* col_part = row_part + (size_t)tiles * n;
  float* diag = reinterpret_cast<float*>(col_part + (size_t)tiles * n);
  const bool vec = pair::vec_ok(d, img, txt, img);
  infonce_fwd_kernel<<<dim3(tiles, tiles), pair::kFwdThreads, 0, stream>>>(
      img, txt, temp, n, d, vec, row_part, col_part, diag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  infonce_fwd_finish_kernel<<<1, kFinishThreads, 0, stream>>>(row_part, col_part, diag, tiles, n,
                                                               row_lse, col_lse, loss);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 on success). Scratch is allocated by the wrapper:
// sparsify_infonce_fwd_scratch(N, D) floats for the forward, 8-byte
// aligned, sparsify_infonce_bwd_scratch(N, D) for either backward.

// The forward's scratch in floats: the row and the column partials,
// (tiles, N) pairs each, then the diagonal (N); 0 for a shape the kernels
// refuse.
extern "C" long long sparsify_infonce_fwd_scratch(int n, int d) {
  if (bad_shape(n, d)) return 0;
  return 4LL * fwd_tiles(n) * n + n;
}

extern "C" int sparsify_infonce_fwd(const float* img, const float* txt, const float* temp, int n,
                                    int d, float* loss, float* row_lse, float* col_lse,
                                    float* scratch, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  return launch_fwd(img, txt, temp, n, d, loss, row_lse, col_lse, scratch,
                    static_cast<cudaStream_t>(stream));
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
