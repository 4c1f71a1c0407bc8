// Fused multi-head self-attention forward over the packed qkv projection.
//
// Replaces the TPU kernel sparsify_clip_tpu/ops/pallas_attention.py
// `_fwd_kernel` (driven by `_run_fwd` under `mha_pallas`): the same math,
// the same packed layout, the same fp32 softmax.
//
//   qkv (B, L, 3W), bf16 or fp32; W = H * D. For head h, q sits at column
//   h*D, k at W + h*D, v at 2W + h*D. The kernels read that layout in
//   place: no (B, H, L, D) copy is made.
//   out (B, L, W), the input's type: head h's context at column h*D.
//   lse (B, L, H) fp32, optional (null skips it): per-head row
//   log-sum-exp, which the attention backward rebuilds P from.
//
// Scores are (q . k) * D^-0.5 in fp32; the causal mask drops col > row;
// softmax and P.V accumulate in fp32; the context is rounded once to the
// output type. Both kernels walk the keys in tiles of 32 with an online
// softmax (running max m, running sum l, context rescaled by
// exp(m_old - m_new)), so any L works: the slice needs 50 and 77, the
// model zoo reaches 577, where a whole K/V pair would not fit in a block's
// shared memory. head_dim may be any multiple of 8 up to 128.
//
// What bounds it on an H100. At CLIP lengths the arithmetic is small: the
// ViT-B-32 vision tower at batch 256 does 2 * 256 * 12 * 50 * 50 * 64 * 2
// ~ 2 GFLOP per layer and moves ~79 MB of bf16 qkv + context, so a kernel
// that keeps the scores on chip is bounded by device memory (79 MB at
// 3.35 TB/s) once its arithmetic runs on the tensor cores. This version is
// not at that floor yet (PERF.md): its loads are not pipelined (no
// cp.async or TMA double buffer), 166 registers a thread leave 3 blocks
// on an SM, and a 50-token sequence fills 50 of a block's 64 query rows.
//
// bf16 (the serving path): `mha_fwd_bf16_kernel`. A block of 4 warps takes
// one (batch, head) pair and 64 query rows, 16 per warp. Q.K^T runs on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate): bf16
// products are exact in fp32, so the scores equal fp32 scores up to the
// order of the sum. P.V runs on them too, with P split into two bf16 terms
// (P = hi + lo, |P - hi - lo| <= 2^-16 |P|), so P keeps fp32-grade
// precision where a single bf16 P (FlashAttention's choice, and the JAX
// einsum path's) would round it to 2^-8. Scores, P and the context stay in
// registers; K and V^T tiles pass through shared memory.
//
// fp32: `mha_fwd_fp32_kernel`, plain fp32 FMAs out of shared memory (no
// tensor cores: TF32 would round the inputs). One block of 4 warps takes
// 16 query rows, 4 per warp; lane j scores key j against the warp's rows
// and owns context columns lane + 32c. It is bounded by shared-memory
// bandwidth and instruction issue. It serves fp32 towers (tests, fp32
// evaluation), not the bf16 serving path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kKeyTile = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// fp32 kernel
constexpr int kRowsPerWarp = 4;
constexpr int kQueryTile = kWarps * kRowsPerWarp;  // 16 query rows a block
constexpr int kColsPerLane = kMaxHeadDim / 32;      // context columns a lane owns

// bf16 kernel
constexpr int kMmaQueryTile = 16 * kWarps;  // 64 query rows a block, 16 a warp
constexpr int kQkStride = kMaxHeadDim + 8;  // Q/K smem row, bf16: +8 spreads banks
constexpr int kVtStride = kKeyTile + 8;     // V^T smem row, bf16

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_fp32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int L, int H, int D, int causal, float scale) {
  __shared__ float q_s[kQueryTile][kMaxHeadDim];
  // +1 column: lane j reads row j of K, so rows must fall in distinct banks
  __shared__ float k_s[kKeyTile][kMaxHeadDim + 1];
  __shared__ float v_s[kKeyTile][kMaxHeadDim];

  const int q0 = blockIdx.x * kQueryTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const float* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kQueryTile * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    q_s[r][d] = row < L ? base[row * row_stride + d] : 0.f;
  }

  // Rows past L (the ragged last query tile) are computed as copies of row
  // L-1 for masking purposes and never stored, so every row sees key 0 as
  // valid in the first tile and m stays finite from then on.
  int mask_row[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    mask_row[rr] = min(q0 + warp * kRowsPerWarp + rr, L - 1);
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] = 0.f;
  }

  const int key_end = causal ? min(L, q0 + kQueryTile) : L;
  for (int k0 = 0; k0 < key_end; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed; q_s is visible
    for (int i = tid; i < kKeyTile * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < L) {
        const float* p = base + key * row_stride + d;
        kx = p[W];
        vx = p[2 * W];
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();

    // scores of key (k0 + lane) against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* q_rows = &q_s[warp * kRowsPerWarp][0];
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        s[rr] = fmaf(q_rows[rr * kMaxHeadDim + d], kd, s[rr]);
    }

    const int key = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
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

    const int n_keys = min(kKeyTile, L - k0);
    for (int j = 0; j < n_keys; ++j) {
      float v[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int d = lane + 32 * c;
        v[c] = d < D ? v_s[j][d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = __shfl_sync(kFullMask, p[rr], j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[rr][c] = fmaf(pj, v[c], acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= L) continue;
    const float inv = 1.f / l[rr];
    float* o = out + (b * L + row) * W + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[rr][c] * inv;
    }
    if (lse != nullptr && lane == 0) lse[(b * L + row) * H + h] = m[rr] + logf(l[rr]);
  }
}

// D = A.B + D for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 fp32. Fragment of lane (g = lane / 4, t = lane % 4), two bf16 a
// register, lower column (or k) in the low half:
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   d0, d1 (g, 2t..2t+1)  d2, d3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x, y) -> bf16 pairs hi and lo with hi + lo = (x, y) to ~2^-16 relative
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int L, int H, int D, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kMmaQueryTile][kQkStride];
  __shared__ __align__(16) __nv_bfloat16 k_s[kKeyTile][kQkStride];
  __shared__ __align__(16) __nv_bfloat16 vt_s[kMaxHeadDim][kVtStride];

  const int q0 = blockIdx.x * kMmaQueryTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int W = H * D;
  const int64_t row_stride = 3 * (int64_t)W;
  const __nv_bfloat16* base = qkv + b * L * row_stride + (int64_t)h * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int vecs = D / 8;                    // 16-byte vectors in a head row
  const int pad_vecs = ((D + 15) & ~15) / 8;  // Q.K^T's k extent, zero-filled past D
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kMmaQueryTile * pad_vecs; i += blockDim.x) {
    const int r = i / pad_vecs, c = i - r * pad_vecs;
    const int row = q0 + r;
    const uint4 v =
        row < L && c < vecs ? *reinterpret_cast<const uint4*>(base + row * row_stride + c * 8)
                            : zero;
    *reinterpret_cast<uint4*>(&q_s[r][c * 8]) = v;
  }
  __syncthreads();

  // the warp's 16 query rows as A fragments, one set per 16-wide k step
  const int r_a = warp * 16 + g;  // this lane's rows: r_a and r_a + 8
  uint32_t qf[kMaxHeadDim / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxHeadDim / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    const bool live = 2 * ks < pad_vecs;
    qf[ks][0] = live ? load_u32(&q_s[r_a][c]) : 0u;
    qf[ks][1] = live ? load_u32(&q_s[r_a + 8][c]) : 0u;
    qf[ks][2] = live ? load_u32(&q_s[r_a][c + 8]) : 0u;
    qf[ks][3] = live ? load_u32(&q_s[r_a + 8][c + 8]) : 0u;
  }

  // Rows past L (the ragged last query tile) are masked as copies of row
  // L-1 and never stored, so key 0 is valid for every row in the first key
  // tile and m is finite from then on.
  const int mask_row[2] = {min(q0 + r_a, L - 1), min(q0 + r_a + 8, L - 1)};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[kMaxHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxHeadDim / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int key_end = causal ? min(L, q0 + kMmaQueryTile) : L;
  for (int k0 = 0; k0 < key_end; k0 += kKeyTile) {
    __syncthreads();  // the previous K/V tile is consumed
    // K: neighbouring threads take neighbouring 16-byte vectors of a key row
    for (int i = tid; i < kKeyTile * pad_vecs; i += blockDim.x) {
      const int j = i / pad_vecs, c = i - j * pad_vecs;
      const int key = k0 + j;
      *reinterpret_cast<uint4*>(&k_s[j][c * 8]) =
          key < L && c < vecs
              ? *reinterpret_cast<const uint4*>(base + key * row_stride + W + c * 8)
              : zero;
    }
    // V, stored transposed: neighbouring threads take neighbouring keys, so
    // a warp's 2-byte stores into a V^T row fall in distinct banks
    for (int i = tid; i < kKeyTile * pad_vecs; i += blockDim.x) {
      const int j = i % kKeyTile, c = i / kKeyTile;
      const int key = k0 + j;
      const uint4 vv =
          key < L && c < vecs
              ? *reinterpret_cast<const uint4*>(base + key * row_stride + 2 * W + c * 8)
              : zero;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[c * 8 + e][j] = ve[e];
    }
    __syncthreads();

    // S = Q.K^T for 32 keys: 4 n-tiles of 8 keys
    float s[kKeyTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kMaxHeadDim / 16; ++ks) {
        if (2 * ks < pad_vecs) {
          const __nv_bfloat16* kr = &k_s[n * 8 + g][ks * 16 + 2 * t];
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
    for (int n = 0; n < kMaxHeadDim / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V: the score fragments of two key n-tiles form one A fragment
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < kMaxHeadDim / 8; ++n) {
        if (n < vecs) {
          const __nv_bfloat16* vr = &vt_s[n * 8 + g][kk * 16 + 2 * t];
          const uint32_t b0 = load_u32(vr), b1 = load_u32(vr + 8);
          mma_bf16(o[n], hi, b0, b1);
          mma_bf16(o[n], lo, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFullMask, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFullMask, l[hr], 2);
    const int row = q0 + r_a + 8 * hr;
    if (row >= L) continue;
    const float inv = 1.f / l[hr];
    __nv_bfloat16* orow = out + (b * L + row) * W + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < kMaxHeadDim / 8; ++n) {
      if (n < vecs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
      }
    }
    if (lse != nullptr && t == 0) lse[(b * L + row) * H + h] = m[hr] + logf(l[hr]);
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success): a refused launch
// never runs, and a later synchronise would not report it.
// dtype: 0 = fp32, 1 = bf16 (both qkv and out).
extern "C" int sparsify_mha_fwd(const void* qkv, void* out, float* lse, int batch, int seq,
                                int heads, int head_dim, int causal, int dtype, float scale,
                                void* stream) {
  if (head_dim <= 0 || head_dim > kMaxHeadDim || head_dim % 8 != 0 || seq <= 0 || heads <= 0 ||
      batch <= 0 || batch > 65535 || heads > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((seq + kMmaQueryTile - 1) / kMmaQueryTile, heads, batch);
    mha_fwd_bf16_kernel<<<grid, block, 0, s>>>(static_cast<const __nv_bfloat16*>(qkv),
                                               static_cast<__nv_bfloat16*>(out), lse, seq, heads,
                                               head_dim, causal, scale);
  } else {
    const dim3 grid((seq + kQueryTile - 1) / kQueryTile, heads, batch);
    mha_fwd_fp32_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(qkv),
                                               static_cast<float*>(out), lse, seq, heads,
                                               head_dim, causal, scale);
  }
  return (int)cudaGetLastError();
}
