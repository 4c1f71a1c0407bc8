// LayerNorm fused into the packed qkv projection, forward:
//
//   qkv = LN_fp32(x) . W^T + b
//
// Replaces the TPU kernel `_fwd_kernel` of
// sparsify_clip_tpu/ops/pallas_ln_qkv.py (driven by `_run_fwd` under
// `ln_qkv_pallas`). Its arithmetic, term for term:
//   mean = sum(x) / W and var = sum(x*x) / W - mean^2 in fp32 (the fast
//   variance, not clipped at 0), y = ((x - mean) * rsqrt(var + eps)) * scale
//   + bias in fp32, y rounded to the output type; one product of y and the
//   weight with fp32 accumulation, rounded to the output type; the bias,
//   already in the output type, added in fp32 and rounded once more (the
//   TPU kernel's `dot(...).astype(dtype) + kb`).
//
//   x     (N, W) row-major, bf16 or fp32, the output's type;
//   scale, bias (W,) fp32, the LayerNorm's;
//   w     (3W, W) row-major in the output's type: open_clip's in_proj_weight,
//         so a weight row is k-contiguous (the JAX kernel's (W, 3W)
//         transposed);
//   kb    (3W,) in the output's type;
//   out   (N, 3W) in the output's type.
// W is a multiple of 8 (16-byte vectors) up to 1664 (ViT-bigG); N is any.
//
// bf16, `ln_qkv_bf16_kernel<kBM>`: a block owns kBM rows (64, or 32 where
// 64 normalized rows of W would not fit in shared memory beside the weight
// stages: W > 1216). It reads each row once, takes its mean and E[x^2] with
// a warp reduction, and writes the normalized rows, rounded to bf16, into
// shared memory once, zero-padded to a multiple of 64 in k. Then it walks
// its columns in tiles of 128 and k in stages of 64: (128, 64) weight
// stages stream from L2 through a ring of four shared buffers with
// cp.async, three in flight while one is multiplied (mma.sync m16n8k16,
// bf16 in, fp32 accumulate; 8 warps as 2 x 4, a warp 32 (or 16) rows by 32
// columns). A weight row is k-contiguous, so ldmatrix without transpose
// gives the B fragments as it gives the A fragments of the row-major y;
// shared rows are padded by 8 elements so that the 8 rows an ldmatrix
// reads fall on distinct banks. After a column tile's last k stage the warp
// rounds its accumulators, adds the bias and stores. Where the rows give fewer than four waves of resident
// blocks (the text tower: 77 row tiles on 132 SMs), the columns are split
// over grid.y and each split normalizes its rows again (x is read once a
// split; its bytes are 1/3 of the output's for one split).
//
// fp32, `ln_qkv_fp32_kernel`: plain fp32 FMAs, no TF32 (TF32 would round
// the inputs). A block owns 32 rows: a first pass takes each row's mean and
// rstd, then the block walks its 128-column tiles in k stages of 32, and
// normalizes each x stage as it stages it (a resident fp32 row tile of W
// 1664 would not fit): x and weight stages go through registers into
// shared memory transposed (k-major), double-buffered, and each thread
// accumulates a 4 x 4 tile from two 16-byte shared loads a k.
//
// What bounds it. At the ViT-L-14-336 vision shape in bf16, (36928, 1024)
// against (3072, 1024), the work is 2 * 36928 * 1024 * 3072 = 232 GFLOP,
// 0.235 ms on the tensor cores at 989 TFLOP/s, against 0.31 GB of x,
// weight and output, 0.092 ms at 3.35 TB/s: the operations. This kernel is
// not at that floor: mma.sync runs at about half of wgmma's rate, each
// 64-row block streams the whole 6 MB weight from L2 (64 FLOP a weight
// byte), and the epilogue stores are not overlapped with the next tile's
// product. In fp32 the floor is 3.47 ms at 67 TFLOP/s; the FMA loop does
// two shared loads a 16 FMAs. Times in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxWidth = 1664;
constexpr size_t kMaxSmem = 232448;  // what a block can opt into on sm_90
constexpr int kBN = 128;              // output columns a tile
// bf16
constexpr int kBK = 64;               // k a weight stage
constexpr int kStages = 4;            // weight stages in the shared ring
constexpr int kWStride = kBK + 8;     // bf16 elements a weight-stage row in shared memory
// fp32
constexpr int kF32BM = 32;
constexpr int kF32BK = 32;
constexpr int kF32YStride = kF32BM + 4;
constexpr int kF32WStride = kBN + 4;

__host__ __device__ __forceinline__ int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// bf16 shared memory: kBM normalized rows of kpad + 8, then the weight ring
size_t bf16_smem_bytes(int bm, int kpad) {
  return (size_t)bm * (kpad + 8) * sizeof(__nv_bfloat16) +
         (size_t)kStages * kBN * kWStride * sizeof(__nv_bfloat16);
}

// Grid (row tiles, column splits); a split walks `tiles_per_split` column
// tiles (the last one fewer), and no split is empty.
template <int kBM>
__global__ void __launch_bounds__(kThreads)
ln_qkv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ kb, __nv_bfloat16* __restrict__ out, int N,
                   int W, float eps, int tiles_per_split) {
  constexpr int kMT = kBM / 32;  // 16-row m-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kpad = round_up(W, kBK);
  const int ys = kpad + 8;  // bf16 elements a normalized row in shared memory
  __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w_s = y_s + kBM * ys;  // [kStages][kBN][kWStride]

  const int W3 = 3 * W;
  const int row0 = blockIdx.x * kBM;
  const int n_col_tiles = (W3 + kBN - 1) / kBN;
  const int j0 = blockIdx.y * tiles_per_split;
  const int j1 = min(n_col_tiles, j0 + tiles_per_split);
  const int nk = kpad / kBK;
  const int steps = (j1 - j0) * nk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warps as 2 (rows) x 4 (columns)
  // this lane's ldmatrix rows: A (row lane % 16, k half lane / 16) and B
  // (n row lane % 8 of n-tile pair half lane / 16, k half (lane / 8) % 2)
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;

  auto load_w = [&](int buf, int step) {
    const int j = j0 + step / nk, kt = step % nk;
    __nv_bfloat16* dst = w_s + buf * kBN * kWStride;
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const int n = j * kBN + r, k = kt * kBK + c * 8;
      const bool full = n < W3 && k < W;
      cp_async16(dst + r * kWStride + c * 8, full ? w + (int64_t)n * W + k : w, full);
    }
  };
  // the first stages fly while the rows are normalized; one commit group
  // a stage, empty past the end, so that the wait counts stay uniform
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_w(st, st);
    cp_async_commit();
  }

  // Normalize: a warp takes rows warp, warp + 8, ...; x goes to shared
  // memory as it is, then is rewritten in place as y (each lane rereads the
  // vectors it wrote, so no barrier is needed between the two passes).
  const int vecs = W / 8, pad_vecs = kpad / 8;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = row0 + r;
    uint4* yrow = reinterpret_cast<uint4*>(y_s + r * ys);
    if (row >= N) {
      for (int c = lane; c < pad_vecs; c += 32) yrow[c] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint4* xrow = reinterpret_cast<const uint4*>(x + (int64_t)row * W);
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < vecs; c += 32) {
      const uint4 v = xrow[c];
      yrow[c] = v;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s += f.x + f.y;
        ss += f.x * f.x + f.y * f.y;
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / W;
    const float rstd = rsqrtf(ss / W - mean * mean + eps);
    for (int c = lane; c < vecs; c += 32) {
      uint4 v = yrow[c];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c * 8 + 2 * e;
        const float2 f = __bfloat1622float2(h[e]);
        const float y0 = ((f.x - mean) * rstd) * __ldg(scale + k) + __ldg(bias + k);
        const float y1 = ((f.y - mean) * rstd) * __ldg(scale + k + 1) + __ldg(bias + k + 1);
        h[e] = __floats2bfloat162_rn(y0, y1);
      }
      yrow[c] = v;
    }
    for (int c = vecs + lane; c < pad_vecs; c += 32) yrow[c] = make_uint4(0u, 0u, 0u, 0u);
  }

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
    // every thread's have, every normalized row is written (on the first
    // step), and every warp is done with the buffer the prefetch refills,
    // which held stage s - 1
    __syncthreads();
    const int pre = s + kStages - 1;
    if (pre < steps) load_w(pre % kStages, pre);
    cp_async_commit();

    const int kt = s % nk;
    const __nv_bfloat16* wt = w_s + (s % kStages) * kBN * kWStride;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(a[mt], y_s + (wm * (kBM / 2) + mt * 16 + a_row) * ys + kt * kBK + ks * 16 + a_k);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];  // b0, b1 of n-tile 2 np, then of n-tile 2 np + 1
        ldmatrix_x4(b, wt + (wn * 32 + np * 16 + b_row) * kWStride + ks * 16 + b_k);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    if (kt == nk - 1) {
      // the column tile is complete: round, add the bias, round, store
      const int j = j0 + s / nk;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = j * kBN + wn * 32 + nt * 8 + 2 * t;  // even; 3W is a multiple of 8
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + wm * (kBM / 2) + mt * 16 + g + 8 * hr;
            if (row < N && col < W3) {
              const float v0 = __bfloat162float(__float2bfloat16_rn(acc[mt][nt][2 * hr])) +
                               __bfloat162float(kb[col]);
              const float v1 = __bfloat162float(__float2bfloat16_rn(acc[mt][nt][2 * hr + 1])) +
                               __bfloat162float(kb[col + 1]);
              *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * W3 + col) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ln_qkv_fp32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, const float* __restrict__ w,
                   const float* __restrict__ kb, float* __restrict__ out, int N, int W, float eps,
                   int tiles_per_split) {
  // k-major stages: y_s[k][row], w_s[k][column]
  __shared__ __align__(16) float y_s[2][kF32BK][kF32YStride];
  __shared__ __align__(16) float w_s[2][kF32BK][kF32WStride];
  __shared__ float mean_s[kF32BM], rstd_s[kF32BM];

  const int W3 = 3 * W;
  const int row0 = blockIdx.x * kF32BM;
  const int n_col_tiles = (W3 + kBN - 1) / kBN;
  const int j0 = blockIdx.y * tiles_per_split;
  const int j1 = min(n_col_tiles, j0 + tiles_per_split);
  const int nk = (W + kF32BK - 1) / kF32BK;
  const int steps = (j1 - j0) * nk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 31, ty = tid >> 5;  // this thread's 4 columns and 4 rows

  // row statistics: a warp takes 4 rows
#pragma unroll
  for (int i = 0; i < kF32BM / 8; ++i) {
    const int r = warp * (kF32BM / 8) + i, row = row0 + r;
    float s = 0.f, ss = 0.f;
    if (row < N) {
      const float4* xr = reinterpret_cast<const float4*>(x + (int64_t)row * W);
      for (int c = lane; c < W / 4; c += 32) {
        const float4 v = xr[c];
        s += (v.x + v.y) + (v.z + v.w);
        ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mean = s / W;
      mean_s[r] = mean;
      rstd_s[r] = row < N ? rsqrtf(ss / W - mean * mean + eps) : 0.f;
    }
  }
  __syncthreads();

  // a stage in registers: one x vector and four weight vectors a thread
  // (8 threads cover a row's 32 k: global reads in 128-byte runs)
  float4 xv, wv[4];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int step) {
    const int j = j0 + step / nk, kt = step % nk;
    const int c = tid & 7, k = kt * kF32BK + c * 4;  // k < W implies k + 3 < W
    const int row = row0 + (tid >> 3);
    xv = row < N && k < W ? *reinterpret_cast<const float4*>(x + (int64_t)row * W + k) : zero;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = j * kBN + ((tid + q * kThreads) >> 3);
      wv[q] = n < W3 && k < W ? *reinterpret_cast<const float4*>(w + (int64_t)n * W + k) : zero;
    }
  };
  auto store = [&](int buf, int step) {
    const int kt = step % nk;
    const int c = tid & 7, k = kt * kF32BK + c * 4;
    const int r = tid >> 3, row = row0 + r;
    const float v[4] = {xv.x, xv.y, xv.z, xv.w};
    const float mean = mean_s[r], rstd = rstd_s[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = row < N && k + e < W;
      y_s[buf][c * 4 + e][r] =
          live ? ((v[e] - mean) * rstd) * __ldg(scale + k + e) + __ldg(bias + k + e) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = (tid + q * kThreads) >> 3;
      w_s[buf][c * 4 + 0][n] = wv[q].x;
      w_s[buf][c * 4 + 1][n] = wv[q].y;
      w_s[buf][c * 4 + 2][n] = wv[q].z;
      w_s[buf][c * 4 + 3][n] = wv[q].w;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  load(0);
  store(0, 0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(s + 1);  // global reads fly during the product
#pragma unroll 8
    for (int k = 0; k < kF32BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&y_s[buf][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&w_s[buf][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    // the other buffer was last read in the previous step, before its barrier
    if (s + 1 < steps) store(buf ^ 1, s + 1);
    if (s % nk == nk - 1) {
      const int col = (j0 + s / nk) * kBN + tx * 4;  // a multiple of 4; so is 3W
      if (col < W3) {
        const float b4[4] = {__ldg(kb + col), __ldg(kb + col + 1), __ldg(kb + col + 2),
                             __ldg(kb + col + 3)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + ty * 4 + i;
          if (row < N) {
            *reinterpret_cast<float4*>(out + (int64_t)row * W3 + col) =
                make_float4(acc[i][0] + b4[0], acc[i][1] + b4[1], acc[i][2] + b4[2],
                            acc[i][3] + b4[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    __syncthreads();
  }
}

// Column tiles a split walks: one split where the row tiles alone give four
// waves of resident blocks, else as many as it takes (every split non-empty).
int column_tiles_per_split(int row_tiles, int col_tiles, int resident) {
  const long want = 4L * (resident > 0 ? resident : 1);
  long splits = (want + row_tiles - 1) / row_tiles;
  splits = splits < 1 ? 1 : (splits > col_tiles ? col_tiles : splits);
  return (int)((col_tiles + splits - 1) / splits);
}

template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

template <int kBM>
int launch_bf16(const void* x, const float* scale, const float* bias, const void* w,
                const void* kb, void* out, int n, int width, float eps, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(kBM, round_up(width, kBK));
  const cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_bf16_kernel<kBM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = resident_blocks(ln_qkv_bf16_kernel<kBM>, smem);
  if (resident < 0) return -resident;
  const int row_tiles = (n + kBM - 1) / kBM, col_tiles = (3 * width + kBN - 1) / kBN;
  const int per = column_tiles_per_split(row_tiles, col_tiles, resident);
  const dim3 grid(row_tiles, (col_tiles + per - 1) / per);
  ln_qkv_bf16_kernel<kBM><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), scale, bias, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(kb), static_cast<__nv_bfloat16*>(out), n, width, eps, per);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` and returns the
// first CUDA error (0 on success): a refused launch never runs, and a later
// synchronise would not report it. dtype: 0 = fp32, 1 = bf16 (x, w, kb and
// out alike; scale and bias are fp32). x and w must start on a 16-byte
// boundary (16-byte loads and cp.async); the wrapper checks it.
extern "C" int sparsify_ln_qkv_fwd(const void* x, const float* scale, const float* bias,
                                   const void* w, const void* kb, void* out, int n, int width,
                                   float eps, int dtype, void* stream) {
  if (n <= 0 || width <= 0 || width % 8 || width > kMaxWidth || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return bf16_smem_bytes(64, round_up(width, kBK)) <= kMaxSmem
               ? launch_bf16<64>(x, scale, bias, w, kb, out, n, width, eps, s)
               : launch_bf16<32>(x, scale, bias, w, kb, out, n, width, eps, s);
  }
  const int resident = resident_blocks(ln_qkv_fp32_kernel, 0);
  if (resident < 0) return -resident;
  const int row_tiles = (n + kF32BM - 1) / kF32BM, col_tiles = (3 * width + kBN - 1) / kBN;
  const int per = column_tiles_per_split(row_tiles, col_tiles, resident);
  const dim3 grid(row_tiles, (col_tiles + per - 1) / per);
  ln_qkv_fp32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), scale, bias, static_cast<const float*>(w),
      static_cast<const float*>(kb), static_cast<float*>(out), n, width, eps, per);
  return (int)cudaGetLastError();
}
