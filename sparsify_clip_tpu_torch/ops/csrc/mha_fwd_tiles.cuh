// The attention forward shared by both routes over the packed qkv
// projection: the whole-width route, which also writes the row LSE the
// backward rebuilds P from, and the head-group route, no LSE. `mha_fwd.cu`
// includes this file once and holds both C entry points, each a call of
// `attn_fwd::launch` with its row policy (with or without the LSE).
//
// Replaces the TPU kernels of sparsify_clip_tpu/ops/pallas_attention.py
// `_fwd_kernel` (driven by `_run_fwd`) and `_fwd_kernel_head_group`
// (driven by `_run_fwd_per_head`): the same function, the same packed
// layout, the same fp32 softmax and fp32-grade P.V.
//
//   qkv (B, L, 3W), bf16 or fp32 (W = H * D): q at column h*D, k at
//       W + h*D, v at 2W + h*D, read in place (16-byte aligned);
//   out (B, L, W), qkv's type: head h's context at column h*D;
//   lse (B, L, H) fp32, or null: each row's natural-log log-sum-exp.
//
// Scores are (q . k) * D^-0.5 in fp32; the causal mask drops col > row;
// softmax and P.V accumulate in fp32 and the context is rounded once. A
// block takes one (batch, head) and a tile of query rows and walks the keys
// in stages of 64 with an online softmax: the running row max m of the raw
// scores, the sum l of 2^((s - m) * D^-0.5 * log2 e) (one FFMA and one 2^x
// on the SFU a score), the context rescaled when m grows, and one
// reciprocal of l a row at the end. K and V stages come by cp.async, in
// bf16 double-buffered (stage t + 1 in flight while stage t computes), in
// fp32 one at a time (three blocks an SM overlap them instead). Masks are
// applied on edge stages only (the stage that reaches past L; under the
// causal mask, the stages that cross a row's diagonal). A block of one
// (batch, head) is the whole sequence when L <= 128, so K and V are read
// once and a 77-token causal text row has no dead second tile.
//
// bf16 (`mha_fwd_bf16_kernel`, templated on the largest head_dim, 64 or
// 128): 16 query rows a warp, ceil(L / 16) warps a block up to 8 (128
// rows). Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate): bf16 products are exact in fp32, so S equals the fp32
// scores up to the order of the sum; P enters P.V as two bf16 terms (P = hi
// + lo, |P - hi - lo| <= 2^-16 |P|), so P keeps the fp32 grade of the TPU
// kernels' fp32 P.V where a single bf16 P would round it to 2^-8. Q's A
// fragments are loaded once by ldmatrix, K's B fragments by ldmatrix from
// the row-major stage, V's by ldmatrix.trans: no scalar transpose. A warp
// skips its products when its 16 rows all lie past L, and, in an edge
// stage, the 16-key groups that no row of it can see. The context leaves
// through shared memory as 16-byte stores. At head_dim 64 past 128 rows
// (the ViT-L-14-336 vision tower) the same stage runs on Hopper's
// warpgroup MMA instead (`mha_fwd_wgmma_kernel`, below), 64 rows a block.
//
// fp32 (`mha_fwd_fp32_kernel`): plain fp32 FMAs (TF32 would round the
// inputs), register-blocked the SGEMM way: 128 threads take 64 query rows;
// thread (ty, tx) owns rows ty + 8i (i < 8), keys tx + 16j (j < 4) of the
// scores and head columns 4tx + 64c of the context. Q.K^T reads one float4
// of Q (a half-warp broadcast) and one of K for every 16 FMAs; P goes to
// shared memory (its rows are the half-warp's own), and P.V reads a float4
// of P and of V for every 16 FMAs. The row max and sum are reduced over the
// 16 lanes that share a row.
//
// What bounds it on an H100. bf16 at the ViT-L-14-336 vision shape (64,
// 577, 3072), 16 heads of 64: 87 GFLOP of Q.K^T and P.V (130 with the lo
// term) against 0.30 GB of qkv read and context written, so the tensor
// cores (88 us at 989 TFLOP/s) and memory (90 us) meet, and the 341 M
// exponentials take about as long again on the SFU. At the CLIP text and
// ViT-B-32 lengths (50, 77) the operations are small and the bytes bound
// it. fp32 is bounded by FMA issue and shared-memory bandwidth (67 TFLOP/s
// of fp32 at best). PERF.md has the times, and the registers, shared
// memory and spills of each instance (nvcc -Xptxas -v).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {
namespace attn_fwd {

constexpr int kMaxHeadDim = 128;
constexpr int kKeys = 64;          // keys a pipeline stage
constexpr int kKeyN = kKeys / 8;   // 8-wide n-tiles of a stage's scores
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// bf16
constexpr int kMaxWarps = 8;       // 16 query rows a warp, at most 128 a block
// fp32
constexpr int kF32Rows = 64;       // query rows a block
constexpr int kF32Threads = 128;   // (ty, tx) = (tid / 16, tid % 16)
constexpr int kF32RowsPer = kF32Rows / 8;  // rows a thread owns
constexpr int kF32KeysPer = kKeys / 16;    // keys a thread owns in a stage
constexpr int kPStride = kKeys + 16;       // P row, floats: a half-warp's two rows 16 banks apart

// 2^x on the SFU, one instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// ------------------------------------------------------------------ bf16

// The online softmax over one stage's scores in accumulator layout (n-tile
// n holds keys 8n..8n+7; lane (g, t) holds rows g and g + 8, keys 2t and
// 2t + 1): in an edge stage (kEdge) the scores are masked by index first;
// then the row max m and the row sum l are updated, the scores are
// replaced by P = 2^((s - m) * scale2), and alpha = 2^((m_old - m) *
// scale2) is left for the context's rescale.
template <bool kEdge, int kN = kKeyN>
__device__ __forceinline__ void softmax_stage(float (&s)[kN][4], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], float scale2, int k0, int row0,
                                              int L, int causal) {
  const int t = threadIdx.x & 3;
  if (kEdge) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1), r = row0 + 8 * (e >> 1);
        if (key >= L || (causal && key > r)) s[n][e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float ms[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    // every row sees key 0 in the first stage, so m is finite from then on
    const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
    alpha[hr] = exp2_ftz((m[hr] - m_new) * scale2);  // 0 on the first stage
    m[hr] = m_new;
    ms[hr] = m_new * scale2;
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2_ftz(fmaf(s[n][e], scale2, -ms[e >> 1]));  // masked: 2^-inf = 0
      l[e >> 1] += s[n][e];
    }
}

template <int kCols>
__device__ __forceinline__ void rescale(float (&o)[kCols][4], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < kCols; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// P's keys 16kk..16kk+15 (two n-tiles) as mma's A fragment, hi + lo
template <int kN>
__device__ __forceinline__ void p_fragments(const float (&p)[kN][4], int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
  split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
  split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
}

// One warp's 16 rows against one 64-key stage on mma.sync: S = Q.K^T, the
// online softmax, O += P.V. kt and vt carry this lane's ldmatrix offsets.
// In an edge stage (kEdge) only the first `live16` 16-key groups, those
// holding a key some row of the warp sees, are computed. The products are
// ordered so that neighbouring mma.sync write other accumulators.
template <int kMaxD, bool kEdge>
__device__ __forceinline__ void bf16_stage(float (&o)[kMaxD / 8][4], float (&m)[2],
                                           float (&l)[2], const uint32_t (&qf)[kMaxD / 16][4],
                                           const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                                           int vecs, int pad_vecs, float scale2, int k0,
                                           int row0, int L, int causal, int live16) {
  constexpr int kStride = kMaxD + 8;
  float s[kKeyN][4];
#pragma unroll
  for (int n = 0; n < kKeyN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (2 * ks >= pad_vecs) continue;
#pragma unroll
    for (int np = 0; np < kKeyN / 2; ++np) {
      if (kEdge && np >= live16) continue;
      uint32_t bf[4];
      ldmatrix_x4(bf, kt + np * 16 * kStride + ks * 16);
      mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
    }
  }
  float alpha[2];
  softmax_stage<kEdge>(s, m, l, alpha, scale2, k0, row0, L, causal);
  rescale(o, alpha);
  // O += P.V: one ldmatrix.trans gives two 8-column B fragments; two of
  // them feed four hi products, then four lo products
#pragma unroll
  for (int kk = 0; kk < kKeyN / 2; ++kk) {
    if (kEdge && kk >= live16) continue;
    uint32_t hi[4], lo[4];
    p_fragments(s, kk, hi, lo);
#pragma unroll
    for (int np = 0; np < kMaxD / 16; np += 2) {
      if (2 * np >= vecs) continue;
      uint32_t bv[2][4];
      ldmatrix_x4_trans(bv[0], vt + kk * 16 * kStride + np * 16);
      ldmatrix_x4_trans(bv[1], vt + kk * 16 * kStride + (np + 1) * 16);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
          if (2 * (np + x) + y < vecs) mma_bf16(o[2 * (np + x) + y], hi, bv[x][2 * y], bv[x][2 * y + 1]);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
          if (2 * (np + x) + y < vecs) mma_bf16(o[2 * (np + x) + y], lo, bv[x][2 * y], bv[x][2 * y + 1]);
    }
  }
}

// Query rows a bf16 block takes: the whole sequence up to 128 rows.
inline int bf16_rows(int L) { return 16 * min((L + 15) / 16, kMaxWarps); }

// Q (rows) and `nbuf` K/V stage pairs, bf16 rows of kMaxD + 8 (the +8 puts
// the 8 rows an ldmatrix reads on 8 distinct groups of 4 banks).
inline size_t bf16_smem_bytes(int rows, int nbuf, int max_d) {
  return (size_t)(rows + nbuf * 2 * kKeys) * (max_d + 8) * sizeof(__nv_bfloat16);
}

// Grid (ceil(L / rows), H, B), 2 * rows threads. At head_dim <= 64 the
// registers are held to 128 a thread: two 8-warp blocks an SM.
template <int kMaxD, bool kWithLse>
__global__ void __launch_bounds__(kMaxWarps * 32, kMaxD <= 64 ? 2 : 1)
mha_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int L, int H, int D, int causal, float scale2) {
  constexpr int kStride = kMaxD + 8;
  constexpr int kSteps = kMaxD / 16;
  constexpr int kCols = kMaxD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;  // 16 a warp
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + rows * kStride;  // [nbuf][K, V][kKeys][kStride]

  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const __nv_bfloat16* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int vecs = D / 8;                     // 16-byte vectors in a head row
  const int pad_vecs = ((D + 15) & ~15) / 8;  // Q.K^T's k extent, zero-filled past D

  // rows [r0, r0 + n) of one head's columns at `src` into `dst`, zero past
  // L and past D
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int n) {
    for (int i = tid; i < n * pad_vecs; i += nthreads) {
      const int r = i / pad_vecs, c = i - r * pad_vecs;
      const int row = r0 + r;
      const bool full = row < L && c < vecs;
      cp_async16(dst + r * kStride + c * 8, full ? src + row * row_stride + c * 8 : src, full);
    }
  };
  auto load_kv = [&](int buf, int k0) {
    __nv_bfloat16* kd = kv_s + buf * 2 * kKeys * kStride;
    stage(kd, base + W, k0, kKeys);
    stage(kd + kKeys * kStride, base + 2 * W, k0, kKeys);
  };

  const int key_end = causal ? min(L, q0 + rows) : L;
  const int n_stages = (key_end + kKeys - 1) / kKeys;
  stage(q_s, base, q0, rows);
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V stage

  // the warp's rows: a warp wholly past L computes nothing; under the
  // causal mask it sees keys below key_lim only
  const int slab0 = q0 + warp * 16;
  const bool live = slab0 < L;
  const int key_lim = causal ? min(L, slab0 + 16) : L;
  const int row0 = slab0 + (lane >> 2);  // this lane's rows: row0 and row0 + 8
  float m[2] = {-INFINITY, -INFINITY};   // raw-score row max
  float l[2] = {0.f, 0.f};               // this lane's share of the row sum
  float o[kCols][4];
#pragma unroll
  for (int n = 0; n < kCols; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[kSteps][4];

  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) {
      // the other buffer was consumed in the previous stage (its closing
      // barrier): fill it with the next stage while this one computes
      load_kv(buf ^ 1, (st + 1) * kKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, on the first, Q) is visible to every warp
    if (st == 0 && live) {
      const __nv_bfloat16* qa = q_s + warp * 16 * kStride + frag_offset<kStride>(lane);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (2 * ks < pad_vecs) {
          ldmatrix_x4(qf[ks], qa + ks * 16);
        } else {
          qf[ks][0] = qf[ks][1] = qf[ks][2] = qf[ks][3] = 0u;
        }
      }
    }
    const int k0 = st * kKeys;
    if (live && k0 < key_lim) {
      const __nv_bfloat16* kt = kv_s + buf * 2 * kKeys * kStride;
      const __nv_bfloat16* vt = kt + kKeys * kStride;
      const bool edge = k0 + kKeys > L || (causal && k0 + kKeys - 1 > slab0);
      if (edge) {
        const int live16 = min(kKeyN / 2, (key_lim - k0 + 15) / 16);
        bf16_stage<kMaxD, true>(o, m, l, qf, kt + nk_offset<kStride>(lane),
                                vt + frag_offset<kStride>(lane), vecs, pad_vecs, scale2, k0,
                                row0, L, causal, live16);
      } else {
        bf16_stage<kMaxD, false>(o, m, l, qf, kt + nk_offset<kStride>(lane),
                                 vt + frag_offset<kStride>(lane), vecs, pad_vecs, scale2, k0,
                                 row0, L, causal, kKeyN / 2);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!live) return;

  // the context, rounded once, through the warp's own Q rows (read only by
  // it, before the first stage's closing barrier) to 16-byte stores
  const int t = lane & 3;
  __nv_bfloat16* stage_o = q_s + warp * 16 * kStride;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lsum = quad_sum(l[hr]);
    const float inv = 1.f / lsum;
    __nv_bfloat16* orow = stage_o + ((lane >> 2) + 8 * hr) * kStride;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      if (n < vecs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
      }
    }
    const int row = row0 + 8 * hr;
    if (kWithLse && t == 0 && row < L)
      lse[(b * L + row) * H + h] = (m[hr] * scale2 + log2f(lsum)) * kLn2;
  }
  __syncwarp();
  for (int i = lane; i < 16 * vecs; i += 32) {
    const int r = i / vecs, c = i - r * vecs;
    const int row = slab0 + r;
    if (row < L) {
      *reinterpret_cast<uint4*>(out + (b * L + row) * W + (int64_t)h * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage_o + r * kStride + c * 8);
    }
  }
}

// ------------------------------------------------------------------ wgmma

// bf16 at head_dim 64 past 128 rows (`mha_fwd_wgmma_kernel`): the products on
// Hopper's warpgroup MMA. A block is one warpgroup and 64 query rows (four
// blocks an SM; two warpgroups sharing the K/V stages were 1 % slower).
// S = Q.K^T reads Q and K from 128-byte-swizzled shared memory (a row of 64
// bf16 is one 128-byte swizzle row); P.V takes P's hi and lo as register A
// fragments (each warp's 16 rows in mma.sync's layout, which the S
// accumulators already have) and V as the transposed (MN-major) B operand
// of the same swizzled layout. A last stage of at most 16 keys (L = 577 =
// 9 * 64 + 1 ends in one) runs S on 16 key columns and one P.V step. The S
// of the next stage is not issued before this stage's softmax: holding two
// score tiles and P for the overlap (FlashAttention-3's order) filled the
// registers and was 5 % slower.
constexpr int kWgThreads = 128;                 // one warpgroup, 64 query rows
constexpr int kSwTile = kKeys * 128;            // 64 rows of 64 bf16, bytes

// D (64 x 64 fp32, the warpgroup's accumulator fragment) = A . B, plus D
// when `accumulate` is non-zero: A 64 x 16 and B 16 x 64 bf16, both from
// shared memory through descriptors, both K-major (row-major A; B as its
// row-major (n, k) transpose).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same for a 16-column B (m64n16k16): D is 64 x 16 fp32.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Grid (ceil(L / 64), H, B), 128 threads; head_dim 64. Registers held to
// 128 a thread: four blocks an SM.
template <bool kWithLse>
__global__ void __launch_bounds__(kWgThreads, 4)
mha_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int L, int H, int causal, float scale2) {
  constexpr int D = 64;
  extern __shared__ __align__(1024) unsigned char smem_sw[];
  // the swizzle pattern repeats every 1024 bytes of the shared address
  unsigned char* q_s =
      smem_sw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_sw)) & 1023)) &
                 1023);
  unsigned char* kv_s = q_s + kSwTile;  // [2][K, V][kSwTile]

  const int q0 = blockIdx.x * kKeys;   // 64 query rows
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const __nv_bfloat16* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // rows [r0, r0 + 64) of one head's columns into a swizzled tile: 16-byte
  // chunk c of row r lands at chunk c ^ (r % 8); zero past L
  auto stage = [&](unsigned char* dst, const __nv_bfloat16* src, int r0) {
    for (int i = tid; i < kKeys * 8; i += kWgThreads) {
      const int r = i >> 3, c = i & 7;
      const int row = r0 + r;
      const bool full = row < L;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), full ? src + row * row_stride + c * 8 : src,
                 full);
    }
  };
  auto load_kv = [&](int buf, int k0) {
    unsigned char* kd = kv_s + buf * 2 * kSwTile;
    stage(kd, base + W, k0);
    stage(kd + kSwTile, base + 2 * W, k0);
  };

  // under the causal mask the rows see keys below key_end only
  const int key_end = causal ? min(L, q0 + kKeys) : L;
  const int n_stages = (key_end + kKeys - 1) / kKeys;
  stage(q_s, base, q0);
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V stage

  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0 and row0 + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const uint64_t dq = sw128_desc(q_s);

  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) {
      load_kv(buf ^ 1, (st + 1) * kKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // this stage (and, on the first, Q) is visible to the warpgroup
    const int k0 = st * kKeys;
    const unsigned char* kt = kv_s + buf * 2 * kSwTile;
    const uint64_t dk = sw128_desc(kt), dv = sw128_desc(kt + kSwTile);
    if (key_end - k0 <= 16) {
      // a stage of at most 16 keys (L = 577 ends in one): S on 16 key
      // columns, P.V on one 16-key step
      float s[2][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n16(reinterpret_cast<float(&)[8]>(s), dq + 2 * ks, dk + 2 * ks, ks);
      wgmma_commit();
      wgmma_wait<0>();
      float alpha[2];
      softmax_stage<true, 2>(s, m, l, alpha, scale2, k0, row0, L, causal);
      rescale(o, alpha);
      uint32_t hi[4], lo[4];
      p_fragments(s, 0, hi, lo);
      wgmma_fence();
      wgmma_rs<1>(reinterpret_cast<float(&)[32]>(o), hi, dv, 1);
      wgmma_rs<1>(reinterpret_cast<float(&)[32]>(o), lo, dv, 1);
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();
      continue;
    }
    float s[kKeyN][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)  // 16 columns = 32 bytes = 2 descriptor units
      wgmma_ss(reinterpret_cast<float(&)[32]>(s), dq + 2 * ks, dk + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait<0>();
    float alpha[2];
    if (k0 + kKeys > L || (causal && k0 + kKeys - 1 > q0)) {
      softmax_stage<true>(s, m, l, alpha, scale2, k0, row0, L, causal);
    } else {
      softmax_stage<false>(s, m, l, alpha, scale2, k0, row0, L, causal);
    }
    rescale(o, alpha);
    uint32_t hi[kKeyN / 2][4], lo[kKeyN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kKeyN / 2; ++kk) p_fragments(s, kk, hi[kk], lo[kk]);
    // all 64 keys, with no branch between the products of one group (ptxas
    // would wait on each): masked keys carry P = 0, and V past L is 0
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeyN / 2; ++kk) {  // 16 keys = 2048 bytes = 128 descriptor units
      wgmma_rs<1>(reinterpret_cast<float(&)[32]>(o), hi[kk], dv + 128 * kk, 1);
      wgmma_rs<1>(reinterpret_cast<float(&)[32]>(o), lo[kk], dv + 128 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // the warpgroup is done with this buffer before it is refilled
  }

  // the context, rounded once, through the swizzled Q tile (its reads
  // completed) to 16-byte stores; each warp its own 16 rows
  const int t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lsum = quad_sum(l[hr]);
    const float inv = 1.f / lsum;
    const int r = warp * 16 + (lane >> 2) + 8 * hr;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(q_s + r * 128 + ((n ^ (r & 7)) << 4) + 4 * t) =
          __floats2bfloat162_rn(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
    const int row = row0 + 8 * hr;
    if (kWithLse && t == 0 && row < L)
      lse[(b * L + row) * H + h] = (m[hr] * scale2 + log2f(lsum)) * kLn2;
  }
  __syncwarp();
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = warp * 16 + (i >> 3), c = i & 7;
    const int row = q0 + r;
    if (row < L) {
      *reinterpret_cast<uint4*>(out + (b * L + row) * W + (int64_t)h * D + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + r * 128 + ((c ^ (r & 7)) << 4));
    }
  }
}

// ------------------------------------------------------------------ fp32

// Q (64 rows), one K/V stage pair (kMaxD + 4 floats a row: 8 lanes reading
// float4s of 8 neighbouring rows land on 8 distinct groups of 4 banks) and
// the P tile: 107.5 KB at head_dim 64 with a second K/V pair, two blocks an
// SM; 72.7 KB with one, three blocks, which hide the copies better than
// the double buffer did.
inline size_t fp32_smem_bytes(int max_d) {
  return ((size_t)(kF32Rows + 2 * kKeys) * (max_d + 4) + (size_t)kF32Rows * kPStride) *
         sizeof(float);
}

// Grid (ceil(L / 64), H, B), 128 threads.
template <int kMaxD, bool kWithLse>
__global__ void __launch_bounds__(kF32Threads)
mha_fwd_fp32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int L, int H, int D, int causal, float scale2) {
  constexpr int kSd = kMaxD + 4;
  constexpr int kC = kMaxD / 64;  // float4 context columns a thread owns
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;
  float* kv_s = q_s + kF32Rows * kSd;  // [K, V][kKeys][kSd]
  float* p_s = kv_s + 2 * kKeys * kSd;

  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const float* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int vecs = D / 4;            // 16-byte vectors in a head row
  constexpr int kVecs = kMaxD / 4;   // staged a row, zero past D

  auto stage = [&](float* dst, const float* src, int r0) {
    for (int i = tid; i < kKeys * kVecs; i += kF32Threads) {
      const int r = i / kVecs, c = i - r * kVecs;
      const int row = r0 + r;
      const bool full = row < L && c < vecs;
      cp_async16(dst + r * kSd + c * 4, full ? src + row * row_stride + c * 4 : src, full);
    }
  };
  auto load_kv = [&](int k0) {
    stage(kv_s, base + W, k0);
    stage(kv_s + kKeys * kSd, base + 2 * W, k0);
  };

  const int key_end = causal ? min(L, q0 + kF32Rows) : L;
  const int n_stages = (key_end + kKeys - 1) / kKeys;
  stage(q_s, base, q0);  // kF32Rows == kKeys
  load_kv(0);
  cp_async_commit();

  float m[kF32RowsPer], l[kF32RowsPer], o[kF32RowsPer][kC][4];
#pragma unroll
  for (int i = 0; i < kF32RowsPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  }
  float* p_rows = p_s + ty * kPStride;  // row ty + 8i at p_rows + 8i * kPStride

  for (int st = 0; st < n_stages; ++st) {
    if (st > 0) {
      load_kv(st * kKeys);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const float* kt = kv_s;
    const float* vt = kt + kKeys * kSd;
    const int k0 = st * kKeys;

    // S: rows ty + 8i by keys tx + 16j, one FMA chain over d each
    float s[kF32RowsPer][kF32KeysPer];
#pragma unroll
    for (int i = 0; i < kF32RowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kF32KeysPer; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 kv[kF32KeysPer];
#pragma unroll
      for (int j = 0; j < kF32KeysPer; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * kSd + d);
#pragma unroll
      for (int i = 0; i < kF32RowsPer; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (ty + 8 * i) * kSd + d);
#pragma unroll
        for (int j = 0; j < kF32KeysPer; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    const bool edge = k0 + kKeys > L || (causal && k0 + kKeys - 1 > q0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < kF32RowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kF32KeysPer; ++j) {
          const int key = k0 + tx + 16 * j, r = q0 + ty + 8 * i;
          if (key >= L || (causal && key > r)) s[i][j] = -INFINITY;
        }
    }
    // the online softmax; P to the half-warp's own rows of the P tile
#pragma unroll
    for (int i = 0; i < kF32RowsPer; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      // every row sees key 0 in the first stage, so m is finite from then on
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = exp2f((m[i] - m_new) * scale2);  // 0 on the first stage
      const float ms = m_new * scale2;
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kF32KeysPer; ++j) {
        const float p = exp2f(fmaf(s[i][j], scale2, -ms));  // masked: 2^-inf = 0
        sum += p;
        p_rows[8 * i * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        o[i][c][0] *= alpha;
        o[i][c][1] *= alpha;
        o[i][c][2] *= alpha;
        o[i][c][3] *= alpha;
      }
    }
    __syncwarp();

    // O += P.V over the keys of the stage that any row can see
    const int k_end = min(kKeys, key_end - k0);
    for (int k = 0; k < k_end; k += 4) {
      float4 vv[4][kC];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          vv[kk][c] = *reinterpret_cast<const float4*>(vt + (k + kk) * kSd + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < kF32RowsPer; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(p_rows + 8 * i * kPStride + k);
        const float pk[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            o[i][c][0] = fmaf(pk[kk], vv[kk][c].x, o[i][c][0]);
            o[i][c][1] = fmaf(pk[kk], vv[kk][c].y, o[i][c][1]);
            o[i][c][2] = fmaf(pk[kk], vv[kk][c].z, o[i][c][2]);
            o[i][c][3] = fmaf(pk[kk], vv[kk][c].w, o[i][c][3]);
          }
      }
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < kF32RowsPer; ++i) {
    const float lsum = half_sum(l[i]);
    const int row = q0 + ty + 8 * i;
    if (row >= L) continue;
    const float inv = 1.f / lsum;
    float* orow = out + (b * L + row) * W + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 4 * tx + 64 * c;
      if (d < D)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(o[i][c][0] * inv, o[i][c][1] * inv, o[i][c][2] * inv, o[i][c][3] * inv);
    }
    if (kWithLse && tx == 0) lse[(b * L + row) * H + h] = (m[i] * scale2 + log2f(lsum)) * kLn2;
  }
}

// ------------------------------------------------------------------ launch

template <bool kWithLse>
int launch_wgmma(const void* qkv, void* out, float* lse, int batch, int seq, int heads,
                 int causal, float scale2, cudaStream_t stream) {
  const size_t smem = 5 * kSwTile + 1024;  // Q and two K/V stages, + 1024-byte alignment
  const cudaError_t err =
      cudaFuncSetAttribute(mha_fwd_wgmma_kernel<kWithLse>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kKeys - 1) / kKeys, heads, batch);
  mha_fwd_wgmma_kernel<kWithLse><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), lse, seq, heads,
      causal, scale2);
  return (int)cudaGetLastError();
}

template <int kMaxD, bool kWithLse>
int launch_bf16(const void* qkv, void* out, float* lse, int batch, int seq, int heads,
                int head_dim, int causal, float scale2, cudaStream_t stream) {
  if (head_dim == 64 && seq > kMaxWarps * 16)
    return launch_wgmma<kWithLse>(qkv, out, lse, batch, seq, heads, causal, scale2, stream);
  const int rows = bf16_rows(seq);
  const size_t smem = bf16_smem_bytes(rows, seq > kKeys ? 2 : 1, kMaxD);
  const cudaError_t err =
      cudaFuncSetAttribute(mha_fwd_bf16_kernel<kMaxD, kWithLse>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + rows - 1) / rows, heads, batch);
  mha_fwd_bf16_kernel<kMaxD, kWithLse><<<grid, 2 * rows, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), lse, seq, heads,
      head_dim, causal, scale2);
  return (int)cudaGetLastError();
}

template <int kMaxD, bool kWithLse>
int launch_fp32(const void* qkv, void* out, float* lse, int batch, int seq, int heads,
                int head_dim, int causal, float scale2, cudaStream_t stream) {
  const size_t smem = fp32_smem_bytes(kMaxD);
  const cudaError_t err =
      cudaFuncSetAttribute(mha_fwd_fp32_kernel<kMaxD, kWithLse>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kF32Rows - 1) / kF32Rows, heads, batch);
  mha_fwd_fp32_kernel<kMaxD, kWithLse><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), lse, seq, heads, head_dim,
      causal, scale2);
  return (int)cudaGetLastError();
}

// Launch the forward on `stream`; the CUDA error of the launch (0 on
// success): a refused launch never runs, and a later synchronise would not
// report it. dtype: 0 = fp32, 1 = bf16 (qkv and out). The row policy
// kWithLse: write the row LSE to `lse` (the whole-width route) or not.
template <bool kWithLse>
int launch(const void* qkv, void* out, float* lse, int batch, int seq, int heads, int head_dim,
           int causal, int dtype, float scale, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  if (head_dim <= 0 || head_dim > kMaxHeadDim || head_dim % 8 != 0 || seq <= 0 || heads <= 0 ||
      batch <= 0 || batch > 65535 || heads > 65535 || (dtype != 0 && dtype != 1) || !aligned)
    return (int)cudaErrorInvalidValue;
  const float scale2 = scale * kLog2e;
  if (dtype == 1) {
    return head_dim <= 64 ? launch_bf16<64, kWithLse>(qkv, out, lse, batch, seq, heads, head_dim,
                                                      causal, scale2, stream)
                          : launch_bf16<128, kWithLse>(qkv, out, lse, batch, seq, heads,
                                                       head_dim, causal, scale2, stream);
  }
  return head_dim <= 64 ? launch_fp32<64, kWithLse>(qkv, out, lse, batch, seq, heads, head_dim,
                                                    causal, scale2, stream)
                        : launch_fp32<128, kWithLse>(qkv, out, lse, batch, seq, heads, head_dim,
                                                     causal, scale2, stream);
}

}  // namespace attn_fwd
}  // namespace
