// The tiles of an N x N pair block shared by the four loss kernels, the
// uniformity forward and backward (`lunif.cu`) and the InfoNCE forward and
// backward (`infonce.cu`). For rows a (N, D) and b (N, D) every one of them
// computes P_ij = a_i . b_j (the Gram entry or the raw logit), one block a
// tile (i-tile, j-tile) of the pair block, so the card fills from both
// sides of it, and a thread a 2 x 2 register micro-tile of P: every entry
// one fmaf chain over d = 0..D-1 in ascending order (`dot_chunk`), so the
// forwards and the backwards see the same P bit for bit.
//
// The backwards go on to W_ij = f(P_ij, i, j) (the pair weight, or dZ) and
// out_i = sum_j W_ij b_j (Wx, or dZ.b), on 32 x 32 tiles (`pair_tile`):
//
//   grid (i-tiles, j-splits, column splits), 256 threads a block;
//   block (bi, s, z) walks the j-tiles of split s in ascending order, and
//   for each computes P, then W into shared memory, then the tile's share
//   W.b_J of its column slice z (2 rows x 4 columns a thread, in
//   registers), added to the split's running share in `share[s]` (s, N, D);
//   a second pass adds the splits' shares in ascending s and finishes.
//
// The forwards need P alone (`dot_tile`): 16 x 16 tiles with 64 threads
// (256 tiles at N = 256, 16 at N = 64); each block reduces its tile to
// partials and a second pass adds them in a fixed order.
//
// Staging: a cp.async ring (2 stages for the backwards, 4 for the forwards)
// of chunks of 64 columns of the tile's i rows of a and j rows of b (the
// backward's ring then carries the chunks of b's j rows in the column
// slice, so W.b's first loads are in flight while P finishes); 16-byte
// copies where D % 4 == 0 and the rows are 16-byte aligned, 4-byte copies
// otherwise; zero outside the rows and columns.
//
// What bounds a block on an H100 is shared memory's bandwidth into
// registers: P reads 4 floats a thread for 4 FMAs a column, W.b 6 for 8,
// and a warp's 16-byte read seems to hold the pipe about 4 cycles whatever
// its broadcast (the rate of the forwards' FMA loop run alone, staging left
// out; PERF.md). Measured on the card (PERF.md): for the backwards a ring
// deeper than 2 stages, a 64-thread block of 4 x 4 micro-tiles (too few
// warps to hide latency) and register-staged d-major copies (load latency
// a chunk) were all slower; for the forwards 16 x 16 tiles beat 32 x 32 at
// N = 256 and at N = 64, and staging and the FMA loop each take about half
// the first pass.
//
// No atomics: every sum, across threads, tiles or blocks, runs in an order
// fixed by the shapes, so two runs agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {
namespace pair {

constexpr int kTile = 32;          // rows i and rows j of a backward tile
constexpr int kThreads = 256;      // a 16 x 16 thread grid over the tile, 2 x 2 entries each
constexpr int kChunk = 64;         // D columns a stage
constexpr int kStages = 2;         // the cp.async ring's depth
constexpr int kLd = kChunk + 4;    // 16-byte rows; 8 rows at one column hit distinct banks
constexpr int kWLd = kTile + 4;    // W's row stride: 16-byte rows
constexpr int kQuads = kChunk / 4;
constexpr int kMaxSplits = 8;      // at most 8 shares a row for the second pass to add
constexpr int kFillBlocks = 128;   // split D's columns until about this many blocks run
constexpr unsigned kFullMask = 0xffffffffu;

template <int K>
using StageOf = float[2][K][kLd];  // [0: i rows of a, 1: j rows of b][row][column]
using Stage = StageOf<kTile>;

// threads of a K x K tile: a (K/2) x (K/2) grid, 2 x 2 entries each
template <int K>
constexpr int kThreadsOf = K * K / 4;

struct __align__(16) Smem {
  Stage stage[kStages];
  float wt[kTile][kWLd];           // the tile's W, transposed: wt[j][i]
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Grid and scratch of one call, from the shapes alone.
struct Plan {
  int tiles;    // 32-row tiles of N
  int splits;   // j-splits: shares a row
  int zs;       // column splits of the second product
  int z_cols;   // columns a column split, a multiple of kChunk
  dim3 grid() const { return dim3(tiles, splits, zs); }
  size_t share_floats(int n, int d) const { return (size_t)splits * n * d; }
};

inline Plan plan(int n, int d) {
  Plan p;
  p.tiles = (n + kTile - 1) / kTile;
  p.splits = p.tiles < kMaxSplits ? p.tiles : kMaxSplits;
  const int chunks = (d + kChunk - 1) / kChunk;
  int zs = kFillBlocks / (p.tiles * p.splits);
  zs = zs < 1 ? 1 : zs > chunks ? chunks : zs;
  p.z_cols = (chunks + zs - 1) / zs * kChunk;
  p.zs = (d + p.z_cols - 1) / p.z_cols;  // no empty slice
  return p;
}

// The j-tiles [*begin, *end) of split s.
__device__ __forceinline__ void split_range(int tiles, int splits, int s, int* begin, int* end) {
  *begin = s * tiles / splits;
  *end = (s + 1) * tiles / splits;
}

// Rows [row0, row0 + K) and columns [c0, c0 + kChunk) of x (N, D) into dst
// by cp.async, zero outside x; the caller commits.
template <int K = kTile>
__device__ __forceinline__ void stage(float (*dst)[kLd], const float* __restrict__ x, int row0,
                                      int c0, int N, int D, bool vec) {
  if (vec) {
    for (unsigned k = threadIdx.x; k < K * kQuads; k += kThreadsOf<K>) {
      const int r = k / kQuads, c = 4 * (k % kQuads);
      const int row = row0 + r, col = c0 + c;
      const bool full = row < N && col < D;  // D % 4 == 0: a quad is whole or out
      cp_async16(&dst[r][c], full ? x + (int64_t)row * D + col : x, full);
    }
  } else {
    for (unsigned k = threadIdx.x; k < K * kChunk; k += kThreadsOf<K>) {
      const int r = k / kChunk, c = k % kChunk;
      const int row = row0 + r, col = c0 + c;
      const bool full = row < N && col < D;
      cp_async4(&dst[r][c], full ? x + (int64_t)row * D + col : x, full);
    }
  }
}

// p[u][v] += a_i . b_j over one staged chunk of w columns, d ascending,
// for i = ti + (K/2) u, j = tj + (K/2) v of the tile (ti = tid / (K/2),
// tj = tid % (K/2)).
template <int K = kTile>
__device__ __forceinline__ void dot_chunk(const StageOf<K>& buf, int w, bool vec,
                                          float (&p)[2][2]) {
  const int ti = threadIdx.x / (K / 2), tj = threadIdx.x % (K / 2);
  const float* a0 = buf[0][ti];
  const float* a1 = buf[0][ti + K / 2];
  const float* b0 = buf[1][tj];
  const float* b1 = buf[1][tj + K / 2];
  if (vec) {  // w % 4 == 0
#pragma unroll 4
    for (int d = 0; d < w; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
      const float4 y0 = *reinterpret_cast<const float4*>(b0 + d);
      const float4 y1 = *reinterpret_cast<const float4*>(b1 + d);
      p[0][0] = fmaf(x0.x, y0.x, p[0][0]);
      p[0][1] = fmaf(x0.x, y1.x, p[0][1]);
      p[1][0] = fmaf(x1.x, y0.x, p[1][0]);
      p[1][1] = fmaf(x1.x, y1.x, p[1][1]);
      p[0][0] = fmaf(x0.y, y0.y, p[0][0]);
      p[0][1] = fmaf(x0.y, y1.y, p[0][1]);
      p[1][0] = fmaf(x1.y, y0.y, p[1][0]);
      p[1][1] = fmaf(x1.y, y1.y, p[1][1]);
      p[0][0] = fmaf(x0.z, y0.z, p[0][0]);
      p[0][1] = fmaf(x0.z, y1.z, p[0][1]);
      p[1][0] = fmaf(x1.z, y0.z, p[1][0]);
      p[1][1] = fmaf(x1.z, y1.z, p[1][1]);
      p[0][0] = fmaf(x0.w, y0.w, p[0][0]);
      p[0][1] = fmaf(x0.w, y1.w, p[0][1]);
      p[1][0] = fmaf(x1.w, y0.w, p[1][0]);
      p[1][1] = fmaf(x1.w, y1.w, p[1][1]);
    }
  } else {
    for (int d = 0; d < w; ++d) {
      p[0][0] = fmaf(a0[d], b0[d], p[0][0]);
      p[0][1] = fmaf(a0[d], b1[d], p[0][1]);
      p[1][0] = fmaf(a1[d], b0[d], p[1][0]);
      p[1][1] = fmaf(a1[d], b1[d], p[1][1]);
    }
  }
}

// share[i][c] = (first ? 0 : share[i][c]) + sum_{j = 0..31, ascending}
// wt[j][i - i0] * bj[j][c - c0] for the tile's rows i < N and the staged
// chunk's columns c = c0.. < D; a thread owns rows i0 + 2 tr + {0, 1} and
// columns c0 + 4 tq.. (tr = tid / 16, tq = tid % 16). `share` is (N, D)
// row-major.
__device__ __forceinline__ void product_chunk(const float (&wt)[kTile][kWLd],
                                              const float (&bj)[kTile][kLd], int N, int D,
                                              int i0, int c0, float* __restrict__ share,
                                              bool first, bool vec) {
  const int tr = threadIdx.x / 16, tq = threadIdx.x % 16;
  const int c = c0 + 4 * tq;
  float acc[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + 2 * tr + u;
    const float* row = share + (int64_t)i * D + c;
    if (first || i >= N || c >= D) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    } else if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(row);
      acc[u][0] = v.x, acc[u][1] = v.y, acc[u][2] = v.z, acc[u][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = c + e < D ? row[e] : 0.f;
    }
  }
#pragma unroll 8
  for (int j = 0; j < kTile; ++j) {
    const float2 w = *reinterpret_cast<const float2*>(&wt[j][2 * tr]);
    const float4 v = *reinterpret_cast<const float4*>(&bj[j][4 * tq]);
    acc[0][0] = fmaf(w.x, v.x, acc[0][0]);
    acc[0][1] = fmaf(w.x, v.y, acc[0][1]);
    acc[0][2] = fmaf(w.x, v.z, acc[0][2]);
    acc[0][3] = fmaf(w.x, v.w, acc[0][3]);
    acc[1][0] = fmaf(w.y, v.x, acc[1][0]);
    acc[1][1] = fmaf(w.y, v.y, acc[1][1]);
    acc[1][2] = fmaf(w.y, v.z, acc[1][2]);
    acc[1][3] = fmaf(w.y, v.w, acc[1][3]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + 2 * tr + u;
    float* row = share + (int64_t)i * D + c;
    if (i >= N || c >= D) continue;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < D) row[e] = acc[u][e];
    }
  }
}

// One tile (rows i0.., rows j0..) of the pair block, start to end, over one
// ring of kStages cp.async stages. The ring first carries D's chunks of a's
// i rows and b's j rows, then the chunks of b's j rows in the column slice
// [c_begin, c_end), so the second product's first loads are in flight while
// the dot products finish.
//   1. p[u][v] = a_i . b_j for i = i0 + ti + 16u, j = j0 + tj + 16v (ti =
//      tid / 16, tj = tid % 16), each one fmaf chain over d = 0..D-1 in
//      ascending order; `on_chunk(buf, c0)` sees each staged chunk first
//      (buf[0] the i rows, buf[1] the j rows, columns c0..).
//   2. `weight(p)` writes W into sm.wt (wt[j - j0][i - i0]) and ends with a
//      barrier, so that every thread sees it.
//   3. share[i][c] = (first ? 0 : share[i][c]) + sum_{j ascending} W_ij b_jc
//      (`product_chunk`) for the slice's columns.
// Ends with a barrier: the ring and wt are free again.
template <class OnChunk, class Weight>
__device__ __forceinline__ void pair_tile(Smem& sm, const float* __restrict__ a,
                                          const float* __restrict__ b, int N, int D, int i0,
                                          int j0, int c_begin, int c_end,
                                          float* __restrict__ share, bool first, bool vec,
                                          OnChunk on_chunk, Weight weight) {
  const int n_dot = (D + kChunk - 1) / kChunk;
  const int total = n_dot + (c_end - c_begin + kChunk - 1) / kChunk;
  const auto issue = [&](int k) {
    if (k >= total) return;
    auto& buf = sm.stage[k % kStages];
    if (k < n_dot) {
      stage(buf[0], a, i0, k * kChunk, N, D, vec);
      stage(buf[1], b, j0, k * kChunk, N, D, vec);
    } else {
      stage(buf[1], b, j0, c_begin + (k - n_dot) * kChunk, N, D, vec);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    issue(k);
    cp_async_commit();  // empty groups keep the count uniform
  }
  // chunk k, once it has landed for every thread; chunk k - 1's buffer,
  // which every thread has consumed, takes chunk k + kStages - 1
  const auto advance = [&](int k) -> const Stage& {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(k + kStages - 1);
    cp_async_commit();
    return sm.stage[k % kStages];
  };
  float p[2][2] = {};
  for (int k = 0; k < n_dot; ++k) {
    const Stage& buf = advance(k);
    on_chunk(buf, k * kChunk);
    dot_chunk(buf, min(kChunk, D - k * kChunk), vec, p);
  }
  weight(p);
  for (int k = n_dot; k < total; ++k) {
    product_chunk(sm.wt, advance(k)[1], N, D, i0, c_begin + (k - n_dot) * kChunk, share, first,
                  vec);
  }
  __syncthreads();
}

// The forwards' tiles: 16 x 16, 64 threads a block (256 blocks at N = 256,
// 16 at N = 64), over a 4-stage cp.async ring of 34.8 KB.
constexpr int kFwdTile = 16;
constexpr int kFwdThreads = kThreadsOf<kFwdTile>;
constexpr int kFwdStages = 4;

using FwdStage = StageOf<kFwdTile>;

struct __align__(16) FwdRing {
  FwdStage stage[kFwdStages];
};

// p[u][v] = a_i . b_j for i = i0 + ti + 8 u, j = j0 + tj + 8 v (as
// `dot_chunk`), each one fmaf chain over d = 0..D-1 in ascending order from
// p = 0, the chain `pair_tile` computes; `on_chunk(buf, c0)` sees each
// staged chunk first. Ends with a barrier: the ring is free again.
template <class OnChunk>
__device__ __forceinline__ void dot_tile(FwdRing& ring, const float* __restrict__ a,
                                         const float* __restrict__ b, int N, int D, int i0,
                                         int j0, bool vec, OnChunk on_chunk, float (&p)[2][2]) {
  const int total = (D + kChunk - 1) / kChunk;
  const auto issue = [&](int k) {
    if (k >= total) return;
    auto& buf = ring.stage[k % kFwdStages];
    stage<kFwdTile>(buf[0], a, i0, k * kChunk, N, D, vec);
    stage<kFwdTile>(buf[1], b, j0, k * kChunk, N, D, vec);
  };
#pragma unroll
  for (int k = 0; k < kFwdStages - 1; ++k) {
    issue(k);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int k = 0; k < total; ++k) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // chunk k has landed for every thread, chunk k - 1 is consumed
    issue(k + kFwdStages - 1);
    cp_async_commit();
    const FwdStage& buf = ring.stage[k % kFwdStages];
    on_chunk(buf, k * kChunk);
    dot_chunk<kFwdTile>(buf, min(kChunk, D - k * kChunk), vec, p);
  }
  __syncthreads();
}

// Whether the 16-byte path holds: D % 4 == 0 and every row pointer aligned.
__host__ __forceinline__ bool vec_ok(int d, const void* p, const void* q, const void* r) {
  const auto aligned = [](const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; };
  return d % 4 == 0 && aligned(p) && aligned(q) && aligned(r);
}

}  // namespace pair
}  // namespace
