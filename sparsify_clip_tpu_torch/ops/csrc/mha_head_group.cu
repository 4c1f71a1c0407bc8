// Long-sequence attention over the packed qkv projection: the forward
// without a row LSE, and the backward that recomputes the softmax from q
// and k.
//
// Replaces the TPU kernels of sparsify_clip_tpu/ops/pallas_attention.py on
// their head-group route (`_use_per_head`, taken when one sample's packed
// qkv is over 3 MB and head_dim packs into 128 lanes: the 577-token
// ViT-L-14-336 vision tower in bf16 and fp32, ViT-L-14's in fp32):
//   `_fwd_kernel_head_group` (driven by `_run_fwd_per_head`): the context,
//     no LSE, with p = e / sum(e) in fp32 and P.V in fp32;
//   `_bwd_kernel_head_group` (driven by `_vjp_bwd`): dq, dk and dv from
//     qkv and dout alone, m, e and p = e / sum(e) rebuilt from q.k.
// The TPU kernels walk a (batch, 128-lane head group) grid because a whole
// 577-token block overflows the TPU's scoped VMEM. That limit is not the
// card's; what carries over is the function and its residuals (qkv only),
// so the port keeps the route and not the blocks.
//
//   qkv  (B, L, 3W), bf16 or fp32 (W = H * D): q at column h*D, k at
//        W + h*D, v at 2W + h*D, read in place;
//   out  (B, L, W), qkv's type;
//   dout (B, L, W), qkv's type; dqkv (B, L, 3W), qkv's type.
//
// Forward. A block takes one (batch, head) and a tile of query rows and
// walks the keys in tiles of 32 with an online softmax (running max m, sum
// l, context rescaled by exp(m_old - m_new)), then divides by l once. At
// L = 577 that is 19 key tiles, so the K/V tiles are double-buffered in
// shared memory: cp.async copies tile t + 1 while tile t computes.
//   bf16, `mha_headgroup_fwd_bf16_kernel`: 4 warps, 64 query rows, 16 a
//     warp. Q.K^T and P.V on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate), P split into two bf16 terms (P = hi + lo, |P - hi -
//     lo| <= 2^-16 |P|) so that P keeps fp32-grade precision, as the TPU
//     kernel's fp32 P.V does. K and V stay row-major in shared memory;
//     V's B fragments come from ldmatrix.trans.
//   fp32, `mha_headgroup_fwd_fp32_kernel`: plain fp32 FMAs (TF32 would round
//     the inputs), 4 warps, 16 query rows, lane j scoring key j.
// What bounds it. At (64, 577, 3072) bf16, 16 heads of 64, the work is
// 4 * 64 * 16 * 577^2 * 64 = 87 GFLOP (Q.K^T and P.V) against 0.30 GB of
// qkv read and context written: 88 us of tensor-core time at 989 TFLOP/s,
// 90 us of memory at 3.35 TB/s, so the two floors meet. This kernel is not
// at them: P.V takes two mma.sync a product (hi and lo), mma.sync runs at
// about half of wgmma's rate, and 577 = 9 * 64 + 1 leaves the last query
// tile one row. Its time stands in PERF.md.
//
// Backward (`sparsify_mha_bwd_head_group`, one entry point, two kernels on
// one stream, no atomics, deterministic): the dQ and the dK/dV kernels of
// `mha_bwd_tiles.cuh` with the `HeadGroupRows` policy. The dQ kernel's
// first sweep over the keys keeps, per row, the running max m, l = sum
// exp(s - m) and a = sum exp(s - m) dP, both rescaled by exp(m_old - m_new)
// when m grows, and writes m and l (B, L, H) and Dr = a / l = rowsum(dP o
// P) (B, H, L) to scratch the wrapper allocates; its second sweep and the
// dK/dV kernel rebuild P = exp(S - m) / l, normalised by the row sum as the
// TPU kernel does (the bf16 route keeps m in log2 units and 1 / l).
// Nine L^2.D products a head (S and dP in each of three sweeps, then dQ,
// dK and dV); in bf16 all on the tensor cores, dQ, dK and dV with P and dS
// split into hi + lo (twelve products' worth). What bounds it: at
// (64, 577, 3072) bf16 the least work is five products, 2 * 5 * 64 * 16 *
// 577^2 * 64 = 218 GFLOP, 0.22 ms on the tensor cores against 0.16 ms for
// the 0.53 GB of qkv, dout and dqkv, so the floor is the operations; this
// design spends 12/5 of them, on mma.sync (about half of wgmma's rate), so
// it sits several times above the floor (PERF.md). The fp32 route stays on
// plain FMAs: no main path takes its gradient.

#include "mha_bwd_tiles.cuh"

namespace {

constexpr int kFwdThreads = 128;             // 4 warps
constexpr int kKeyTile = 32;                 // keys a pipeline stage
constexpr int kBf16Rows = 64;                // query rows a bf16 block, 16 a warp
constexpr int kF32Rows = 16;                 // query rows an fp32 block, 4 a warp
constexpr int kF32RowsPerWarp = kF32Rows / 4;

// Shared memory of the bf16 forward: Q (64 rows) and two K and two V tiles
// (32 rows each), bf16 rows of kMaxD + 8 (the +8 puts the 8 rows an
// ldmatrix or a fragment load reads on 8 distinct groups of 4 banks).
template <int kMaxD>
constexpr size_t bf16_fwd_smem_bytes() {
  return (size_t)(kBf16Rows + 4 * kKeyTile) * (kMaxD + 8) * sizeof(__nv_bfloat16);
}

template <int kMaxD>
__global__ void __launch_bounds__(kFwdThreads)
mha_headgroup_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                              __nv_bfloat16* __restrict__ out, int L, int H, int D, int causal,
                              float scale) {
  constexpr int kStride = kMaxD + 8;
  constexpr int kSteps = kMaxD / 16;  // 16-wide k steps of Q.K^T
  constexpr int kCols = kMaxD / 8;    // 8-wide column tiles of the context
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBf16Rows * kStride;  // [2][kKeyTile][kStride]
  __nv_bfloat16* v_s = k_s + 2 * kKeyTile * kStride;

  const int q0 = blockIdx.x * kBf16Rows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const __nv_bfloat16* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int vecs = D / 8;                     // 16-byte vectors in a head row
  const int pad_vecs = ((D + 15) & ~15) / 8;  // Q.K^T's k extent, zero-filled past D

  for (int i = tid; i < kBf16Rows * pad_vecs; i += kFwdThreads) {
    const int r = i / pad_vecs, c = i - r * pad_vecs;
    const int row = q0 + r;
    const bool full = row < L && c < vecs;
    cp_async16(q_s + r * kStride + c * 8, full ? base + row * row_stride + c * 8 : base, full);
  }
  auto load_kv = [&](int buf, int k0) {
    __nv_bfloat16* kd = k_s + buf * kKeyTile * kStride;
    __nv_bfloat16* vd = v_s + buf * kKeyTile * kStride;
    for (int i = tid; i < kKeyTile * pad_vecs; i += kFwdThreads) {
      const int j = i / pad_vecs, c = i - j * pad_vecs;
      const int key = k0 + j;
      const bool full = key < L && c < vecs;
      const __nv_bfloat16* src = full ? base + key * row_stride + c * 8 : base;
      cp_async16(kd + j * kStride + c * 8, full ? src + W : base, full);
      cp_async16(vd + j * kStride + c * 8, full ? src + 2 * W : base, full);
    }
  };

  const int key_end = causal ? min(L, q0 + kBf16Rows) : L;
  const int n_tiles = (key_end + kKeyTile - 1) / kKeyTile;
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  // Rows past L (the ragged last query tile) are masked as copies of row
  // L-1 and never stored, so key 0 is valid for every row in the first key
  // tile and m is finite from then on.
  const int r_a = warp * 16 + g;  // this lane's rows: r_a and r_a + 8
  const int mask_row[2] = {min(q0 + r_a, L - 1), min(q0 + r_a + 8, L - 1)};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[kCols][4];
#pragma unroll
  for (int n = 0; n < kCols; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[kSteps][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      // the other buffer was consumed in the previous iteration (its last
      // __syncthreads): fill it with the next tile while this one computes
      load_kv(buf ^ 1, (tile + 1) * kKeyTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, on the first, Q) is visible to every warp

    if (tile == 0) {
      // the warp's 16 query rows as A fragments, one set per 16-wide k step
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int c = ks * 16 + 2 * t;
        const bool live = 2 * ks < pad_vecs;
        qf[ks][0] = live ? load_u32(q_s + r_a * kStride + c) : 0u;
        qf[ks][1] = live ? load_u32(q_s + (r_a + 8) * kStride + c) : 0u;
        qf[ks][2] = live ? load_u32(q_s + r_a * kStride + c + 8) : 0u;
        qf[ks][3] = live ? load_u32(q_s + (r_a + 8) * kStride + c + 8) : 0u;
      }
    }
    const __nv_bfloat16* kt = k_s + buf * kKeyTile * kStride;
    const __nv_bfloat16* vt = v_s + buf * kKeyTile * kStride;
    const int k0 = tile * kKeyTile;

    // S = Q.K^T for 32 keys: 4 n-tiles of 8 keys
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (2 * ks < pad_vecs) {
          const __nv_bfloat16* kr = kt + (n * 8 + g) * kStride + ks * 16 + 2 * t;
          mma_bf16(s[n], qf[ks], load_u32(kr), load_u32(kr + 8));
        }
      }
    }

    // scale, mask, online softmax; a row's 32 scores sit in one lane quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int hr = e >> 1;
        const bool valid = key < L && (!causal || key <= mask_row[hr]);
        s[n][e] = valid ? s[n][e] * scale : -INFINITY;
        mx[hr] = fmaxf(mx[hr], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFullMask, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFullMask, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = expf(m[hr] - m_new);  // 0 on the first tile
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);  // masked: exp(-inf) = 0
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V: the score fragments of two key n-tiles form one A fragment;
    // one ldmatrix.trans gives the B fragments of two 8-column tiles
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const __nv_bfloat16* vrow = vt + (kk * 16 + mrow + (mat & 1) * 8) * kStride + (mat >> 1) * 8;
#pragma unroll
      for (int np = 0; np < kCols / 2; ++np) {
        if (2 * np < vecs) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + np * 16);
          mma_bf16(o[2 * np], hi, bv[0], bv[1]);
          mma_bf16(o[2 * np], lo, bv[0], bv[1]);
          if (2 * np + 1 < vecs) {
            mma_bf16(o[2 * np + 1], hi, bv[2], bv[3]);
            mma_bf16(o[2 * np + 1], lo, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFullMask, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFullMask, l[hr], 2);
    const int row = q0 + r_a + 8 * hr;
    if (row >= L) continue;
    __nv_bfloat16* orow = out + (b * L + row) * W + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      if (n < vecs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * hr] / l[hr], o[n][2 * hr + 1] / l[hr]);
      }
    }
  }
}

// Shared memory of the fp32 forward: Q (16 rows) and two K and two V tiles
// (32 rows each), fp32 rows of D + 4 (8 neighbouring lanes reading float4s
// of 8 rows land on 8 distinct groups of 4 banks).
inline size_t fp32_fwd_smem_bytes(int head_dim) {
  return (size_t)(kF32Rows + 4 * kKeyTile) * (head_dim + 4) * sizeof(float);
}

__global__ void __launch_bounds__(kFwdThreads)
mha_headgroup_fwd_fp32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L,
                              int H, int D, int causal, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int sd = D + 4;
  float* q_s = smem_f;
  float* k_s = q_s + kF32Rows * sd;  // [2][kKeyTile][sd]
  float* v_s = k_s + 2 * kKeyTile * sd;

  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const float* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int vecs = D / 4;  // 16-byte vectors in a head row

  for (int i = tid; i < kF32Rows * vecs; i += kFwdThreads) {
    const int r = i / vecs, c = i - r * vecs;
    const int row = q0 + r;
    cp_async16(q_s + r * sd + c * 4, row < L ? base + row * row_stride + c * 4 : base, row < L);
  }
  auto load_kv = [&](int buf, int k0) {
    float* kd = k_s + buf * kKeyTile * sd;
    float* vd = v_s + buf * kKeyTile * sd;
    for (int i = tid; i < kKeyTile * vecs; i += kFwdThreads) {
      const int j = i / vecs, c = i - j * vecs;
      const int key = k0 + j;
      const bool full = key < L;
      const float* src = full ? base + key * row_stride + c * 4 : base;
      cp_async16(kd + j * sd + c * 4, full ? src + W : base, full);
      cp_async16(vd + j * sd + c * 4, full ? src + 2 * W : base, full);
    }
  };

  const int key_end = causal ? min(L, q0 + kF32Rows) : L;
  const int n_tiles = (key_end + kKeyTile - 1) / kKeyTile;
  load_kv(0, 0);
  cp_async_commit();

  // rows past L are masked as copies of row L-1 and never stored
  int mask_row[kF32RowsPerWarp];
  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    mask_row[rr] = min(q0 + warp * kF32RowsPerWarp + rr, L - 1);
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] = 0.f;
  }
  const float* q_rows = q_s + warp * kF32RowsPerWarp * sd;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_kv(buf ^ 1, (tile + 1) * kKeyTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = k_s + buf * kKeyTile * sd;
    const float* vt = v_s + buf * kKeyTile * sd;
    const int k0 = tile * kKeyTile;

    // scores of key (k0 + lane) against the warp's rows
    float s[kF32RowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) s[rr] = 0.f;
    const float* kl = kt + lane * sd;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kl + d);
#pragma unroll
      for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(q_rows + rr * sd + d);
        s[rr] = fmaf(qv.x, kv.x, s[rr]);
        s[rr] = fmaf(qv.y, kv.y, s[rr]);
        s[rr] = fmaf(qv.z, kv.z, s[rr]);
        s[rr] = fmaf(qv.w, kv.w, s[rr]);
      }
    }

    const int key = k0 + lane;
    float p[kF32RowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      const bool valid = key < L && (!causal || key <= mask_row[rr]);
      const float sc = valid ? s[rr] * scale : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      p[rr] = valid ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);  // 0 on the first tile
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] *= alpha;
    }

    const int n_keys = min(kKeyTile, key_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      float v[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        v[c] = d < D ? vt[j * sd + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
        const float pj = __shfl_sync(kFullMask, p[rr], j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] = fmaf(pj, v[c], acc[rr][c]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    const int row = q0 + warp * kF32RowsPerWarp + rr;
    if (row >= L) continue;
    float* o = out + (b * L + row) * W + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[rr][c] / l[rr];
    }
  }
}

template <int kMaxD>
int launch_fwd_bf16(const void* qkv, void* out, int batch, int seq, int heads, int head_dim,
                    int causal, float scale, cudaStream_t stream) {
  const size_t smem = bf16_fwd_smem_bytes<kMaxD>();
  const cudaError_t err = cudaFuncSetAttribute(
      mha_headgroup_fwd_bf16_kernel<kMaxD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBf16Rows - 1) / kBf16Rows, heads, batch);
  mha_headgroup_fwd_bf16_kernel<kMaxD><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), seq, heads,
      head_dim, causal, scale);
  return (int)cudaGetLastError();
}

bool valid_shape(int batch, int seq, int heads, int head_dim, int dtype) {
  return head_dim > 0 && head_dim <= kMaxHeadDim && head_dim % 8 == 0 && seq > 0 && heads > 0 &&
         batch > 0 && batch <= 65535 && heads <= 65535 && (dtype == 0 || dtype == 1);
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 on success): a refused launch never runs, and a
// later synchronise would not report it. dtype: 0 = fp32, 1 = bf16 (qkv,
// out, dout and dqkv alike).

// The forward: context only. qkv must start on a 16-byte boundary (cp.async
// copies 16-byte vectors); the wrapper checks it.
extern "C" int sparsify_mha_fwd_head_group(const void* qkv, void* out, int batch, int seq,
                                           int heads, int head_dim, int causal, int dtype,
                                           float scale, void* stream) {
  if (!valid_shape(batch, seq, heads, head_dim, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return head_dim <= 64
               ? launch_fwd_bf16<64>(qkv, out, batch, seq, heads, head_dim, causal, scale, s)
               : launch_fwd_bf16<128>(qkv, out, batch, seq, heads, head_dim, causal, scale, s);
  }
  const size_t smem = fp32_fwd_smem_bytes(head_dim);
  const cudaError_t err = cudaFuncSetAttribute(
      mha_headgroup_fwd_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kF32Rows - 1) / kF32Rows, heads, batch);
  mha_headgroup_fwd_fp32_kernel<<<grid, kFwdThreads, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), seq, heads, head_dim, causal,
      scale);
  return (int)cudaGetLastError();
}

// The backward: the dQ kernel (which also writes each row's max, sum and
// Dr), then the dK/dV kernel. row_max and row_sum are (B, L, H) fp32 and
// drow (B, H, L) fp32 scratch that the wrapper allocates. The bf16 route
// copies 16-byte vectors: qkv and dout must start on a 16-byte boundary
// (the wrapper copies a misaligned dout first).
extern "C" int sparsify_mha_bwd_head_group(const void* qkv, const void* dout, void* dqkv,
                                           float* row_max, float* row_sum, float* drow,
                                           int batch, int seq, int heads, int head_dim,
                                           int causal, int dtype, float scale, void* stream) {
  return launch_dq_dkv<HeadGroupRows>(qkv, row_max, row_sum, dout, dqkv, drow, batch, seq, heads,
                                      head_dim, causal, dtype, scale,
                                      static_cast<cudaStream_t>(stream));
}
