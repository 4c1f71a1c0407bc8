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
// Precision.HIGHEST). The entry points and their wrappers refuse D > 2048.
//
// On the TPU one SMEM accumulator is carried across a sequential grid. Here
// blocks run in no order, and both passes run on `pair_tiles.cuh`, two
// launches each; no atomics, so two runs agree bit for bit.
//
// The forward: a grid of 16 x 16 tiles of W (256 blocks at N = 256, 16 at
// N = 64). A block computes its rows' norms and the Gram tile over the same
// staged chunks and writes the tile's sum of W; a one-block second pass
// adds the partials in a fixed order and takes the log on the device, so S
// and the loss never need a host read.
//
// The backward: a grid of (i-tile, j-split, column split) blocks over 32 x
// 32 tiles of W, 64 of them at N = 256 and 128 once D's columns are split
// (48 at N = 64, D = 768). A block computes its tile's norms and Gram, W,
// its share of r (one thread a row, j ascending) and its share of W.x for
// its columns, and writes both to scratch; a second kernel adds the
// j-splits' shares in ascending order and writes dx.
//
// Forward and backward see the same W: n_i is the same lane-strided fmaf sum
// and xor tree in both (`TileNorms`, lane l taking columns l, l + 32, ...
// in order from the staged chunks), G_ij is one fmaf chain over d =
// 0..D-1 in ascending order in both (`pair::dot_chunk`), and `pair_weight`
// turns them into W.
//
// What bounds it on an H100: at N = 256, D = 512 the forward needs the i<j
// half of the symmetric Gram, N (N-1) D = 33 MFLOP (it computes the whole
// Gram, 2 N^2 D), and the backward adds 2 N^2 D = 67 MFLOP for W.x, over
// 0.5 MB of input: about 0.5 us and 1.5 us at 67 TFLOP/s of fp32, far
// below launch latency. No split of D, so a block's
// floor is its D-long FMA chain and its staging. The backward's blocks are
// bound by shared memory's bandwidth into registers (`pair_tiles.cuh`),
// each call by that and its two launches (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_tiles.cuh"

namespace {

using pair::warp_sum;

constexpr int kMaxD = 2048;
constexpr int kSumThreads = 256;

// n_i = sum_d x_id^2 of a K x K tile's 2K rows, from the chunks its ring
// stages: the first half of the warps takes the i rows, the second the j
// rows, kRows a warp; lane l sums columns l, l + 32, ... in ascending order
// (`add`, a chunk at a time), then a fixed xor tree (`store`). The forward
// and the backward fold the same sum into their first passes.
template <int K>
struct TileNorms {
  static constexpr int kWarps = pair::kThreadsOf<K> / 32;
  static constexpr int kRows = 2 * K / kWarps;  // 8 at K = 32, 16 at K = 16
  float part[kRows] = {};
  template <class Buf>
  __device__ __forceinline__ void add(const Buf& buf, int c0, int D) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int side = warp / (kWarps / 2), r_base = (warp % (kWarps / 2)) * kRows;
#pragma unroll
    for (int h = 0; h < pair::kChunk; h += 32) {
      if (c0 + h + lane >= D) break;
#pragma unroll
      for (int n = 0; n < kRows; ++n) {
        const float v = buf[side][r_base + n][h + lane];
        part[n] = fmaf(v, v, part[n]);
      }
    }
  }
  // norm_s[0][r]: row i0 + r, norm_s[1][r]: row j0 + r; the caller syncs
  __device__ __forceinline__ void store(float (&norm_s)[2][K]) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int side = warp / (kWarps / 2), r_base = (warp % (kWarps / 2)) * kRows;
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const float v = warp_sum(part[n]);
      if (lane == 0) norm_s[side][r_base + n] = v;
    }
  }
};

// W_ij from the norms and the Gram entry, 0 where the pair is masked. The
// FMA is written out so that no contraction choice of the compiler can make
// the forward's W differ from the backward's.
__device__ __forceinline__ float pair_weight(float ni, float nj, float g, float t, bool keep) {
  const float d2 = fmaxf(fmaf(-2.f, g, ni + nj), 0.f);
  return keep ? expf(-t * d2) : 0.f;
}

// Forward, first pass: block (x, y) takes the K x K tile of W at j-tile x,
// i-tile y, over a tile of the Gram with the rows' norms folded in, and
// writes the tile's sum (each thread's 4 entries, a warp's xor tree, the
// warps ascending) to partial[y][x].
__global__ void __launch_bounds__(pair::kFwdThreads)
lunif_fwd_kernel(const float* __restrict__ x, int N, int D, float t, bool vec,
                 float* __restrict__ partial) {
  constexpr int K = pair::kFwdTile, kHalf = K / 2;
  __shared__ pair::FwdRing ring;
  __shared__ float norm_s[2][K];
  __shared__ float red[TileNorms<K>::kWarps];
  const int i0 = blockIdx.y * K, j0 = blockIdx.x * K;
  TileNorms<K> norms;
  float g[2][2] = {};
  pair::dot_tile(ring, x, x, N, D, i0, j0, vec,
                    [&](const auto& buf, int c0) { norms.add(buf, c0, D); }, g);
  norms.store(norm_s);
  __syncthreads();
  const int ti = threadIdx.x / kHalf, tj = threadIdx.x % kHalf;
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int il = ti + kHalf * u, jl = tj + kHalf * v;
      const int i = i0 + il, j = j0 + jl;
      s += pair_weight(norm_s[0][il], norm_s[1][jl], g[u][v], t, i < N && j < N && i != j);
    }
  s = warp_sum(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < TileNorms<K>::kWarps; ++w) total += red[w];
    partial[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

// Forward, second pass: S = sum of the partials in a fixed order; loss =
// log(S / (N (N - 1))).
__global__ void __launch_bounds__(kSumThreads)
lunif_sum_kernel(const float* __restrict__ partial, int n_partial, int N,
                 float* __restrict__ s_out, float* __restrict__ loss) {
  __shared__ float red[kSumThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) s += partial[i];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kSumThreads / 32; ++w) total += red[w];
    s_out[0] = total;
    loss[0] = logf(total / (float)((long long)N * (N - 1)));
  }
}

// First pass of the backward: block (bi, s, z) walks the j-tiles of split s
// against i-tile bi. For each it computes the 64 rows' norms and the Gram
// tile over the same staged chunks, W into shared memory, r's share (one
// thread a row of the i-tile, z = 0 only) and W.x's share for column slice
// z, added to share[s] (s, N, D). r_share[s] (s, N) gets the split's r.
__global__ void __launch_bounds__(pair::kThreads)
lunif_bwd_kernel(const float* __restrict__ x, int N, int D, float t, int z_cols, bool vec,
                 float* __restrict__ share, float* __restrict__ r_share) {
  __shared__ pair::Smem sm;
  __shared__ float norm_s[2][pair::kTile];  // [0: i rows, 1: j rows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int i0 = blockIdx.x * pair::kTile, s = blockIdx.y;
  const int c_begin = blockIdx.z * z_cols, c_end = min(D, c_begin + z_cols);
  int jt_begin, jt_end;
  pair::split_range(gridDim.x, gridDim.y, s, &jt_begin, &jt_end);
  float r = 0.f;  // thread `lane` of warp 0: row i0 + lane
  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int j0 = jt * pair::kTile;
    TileNorms<pair::kTile> norms;
    const auto weights = [&](const float (&g)[2][2]) {
      norms.store(norm_s);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int il = ti + 16 * u, jl = tj + 16 * v;
          const int i = i0 + il, j = j0 + jl;
          sm.wt[jl][il] =
              pair_weight(norm_s[0][il], norm_s[1][jl], g[u][v], t, i < N && j < N && i != j);
        }
      __syncthreads();
      if (blockIdx.z == 0 && warp == 0)
        for (int jl = 0; jl < pair::kTile; ++jl) r += sm.wt[jl][lane];
    };
    pair::pair_tile(sm, x, x, N, D, i0, j0, c_begin, c_end, share + (size_t)s * N * D,
                    jt == jt_begin, vec,
                    [&](const auto& buf, int c0) { norms.add(buf, c0, D); }, weights);
  }
  if (blockIdx.z == 0 && warp == 0 && i0 + lane < N) r_share[(size_t)s * N + i0 + lane] = r;
}

// Second pass: r and Wx as the splits' shares added in ascending order, then
// dx = g ((-4 t / S) (r x - Wx)); a thread takes 4 consecutive columns of a
// row.
__global__ void lunif_bwd_finish_kernel(const float* __restrict__ x,
                                        const float* __restrict__ share,
                                        const float* __restrict__ r_share, int splits,
                                        const float* __restrict__ s_ptr,
                                        const float* __restrict__ g_ptr, int N, int D, float t,
                                        bool vec, float* __restrict__ dx) {
  const int quads = (D + 3) / 4;
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (int64_t)N * quads) return;
  const int i = (int)(k / quads), c = (int)(k % quads) * 4;
  const size_t plane = (size_t)N * D, at = (size_t)i * D + c;
  float r = 0.f;
  for (int s = 0; s < splits; ++s) r += r_share[(size_t)s * N + i];
  const float coef = (-4.f * t) / *s_ptr;
  const float gin = *g_ptr;
  if (vec) {
    float4 wx = *reinterpret_cast<const float4*>(share + at);
    for (int s = 1; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(share + s * plane + at);
      wx.x += v.x, wx.y += v.y, wx.z += v.z, wx.w += v.w;
    }
    const float4 xv = *reinterpret_cast<const float4*>(x + at);
    *reinterpret_cast<float4*>(dx + at) =
        make_float4(gin * (coef * (xv.x * r - wx.x)), gin * (coef * (xv.y * r - wx.y)),
                    gin * (coef * (xv.z * r - wx.z)), gin * (coef * (xv.w * r - wx.w)));
  } else {
    for (int e = 0; e < 4 && c + e < D; ++e) {
      float wx = share[at + e];
      for (int s = 1; s < splits; ++s) wx += share[s * plane + at + e];
      dx[at + e] = gin * (coef * (x[at + e] * r - wx));
    }
  }
}

bool bad_shape(int n, int d) { return n < 2 || d <= 0 || d > kMaxD; }

// Tiles a side of the forward's grid.
int fwd_tiles(int n) { return (n + pair::kFwdTile - 1) / pair::kFwdTile; }

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 on success). Scratch is allocated by the wrapper:
// sparsify_lunif_fwd_scratch(N, D) floats for the forward,
// sparsify_lunif_bwd_scratch(N, D) for the backward.

// The forward's scratch in floats: one partial sum a tile; 0 for a shape
// the kernels refuse.
extern "C" long long sparsify_lunif_fwd_scratch(int n, int d) {
  if (bad_shape(n, d)) return 0;
  const long long tiles = fwd_tiles(n);
  return tiles * tiles;
}

extern "C" int sparsify_lunif_fwd(const float* x, int n, int d, float t, float* scratch,
                                  float* s_out, float* loss, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = fwd_tiles(n);
  lunif_fwd_kernel<<<dim3(tiles, tiles), pair::kFwdThreads, 0, s>>>(
      x, n, d, t, pair::vec_ok(d, x, x, x), scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lunif_sum_kernel<<<1, kSumThreads, 0, s>>>(scratch, tiles * tiles, n, s_out, loss);
  return (int)cudaGetLastError();
}

// The backward's scratch in floats: W.x's shares (splits, N, D), then r's
// (splits, N); 0 for a shape the kernels refuse.
extern "C" long long sparsify_lunif_bwd_scratch(int n, int d) {
  if (bad_shape(n, d)) return 0;
  const pair::Plan p = pair::plan(n, d);
  return (long long)p.share_floats(n, d) + (long long)p.splits * n;
}

extern "C" int sparsify_lunif_bwd(const float* x, const float* s_ptr, const float* g_ptr, int n,
                                  int d, float t, float* scratch, float* dx, void* stream) {
  if (bad_shape(n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const pair::Plan p = pair::plan(n, d);
  const bool vec = pair::vec_ok(d, x, scratch, dx);
  float* r_share = scratch + p.share_floats(n, d);
  lunif_bwd_kernel<<<p.grid(), pair::kThreads, 0, s>>>(x, n, d, t, p.z_cols, vec, scratch,
                                                        r_share);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)n * ((d + 3) / 4);
  lunif_bwd_finish_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      x, scratch, r_share, p.splits, s_ptr, g_ptr, n, d, t, vec, dx);
  return (int)cudaGetLastError();
}
