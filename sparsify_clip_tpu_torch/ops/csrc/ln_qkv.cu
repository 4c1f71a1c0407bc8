// LayerNorm fused into the packed qkv projection: the forward, and the
// backward's LayerNorm gradient.
//
//   qkv = LN_fp32(x) . W^T + b
//
// The forward replaces the TPU kernel `_fwd_kernel` of
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
//   out   (N, 3W) in the output's type;
//   stats (N, 2) fp32 scratch: each row's mean and rstd.
// W is a multiple of 8 (16-byte vectors) up to 1664 (ViT-bigG); N is any.
//
// Row statistics (`ln_row_stats_kernel`): a first pass, a warp a row, reads
// x once and writes each row's mean and rstd (0.3 MB at the ViT-L-14-336
// vision shape), so the product kernels read them instead of reducing rows
// they see only a k stage at a time.
//
// bf16 (`ln_qkv_wgmma_kernel`): Hopper's warpgroup MMA. A tile is 128 rows
// (two consumer warpgroups of 64) by 192 output columns (m64n192k16; 192
// divides 3W at W 768, 1024 and 1664), and one block an SM walks tiles t,
// t + grid, ... with the columns fastest, so the blocks in flight share
// their rows and the weight stays in L2. k moves in stages of 64 (one
// 128-byte swizzle row of bf16): a producer warpgroup (one thread, its
// registers given to the consumers by setmaxnreg) loads each stage's x
// (128, 64) and weight (192, 64) boxes by TMA, through tensor maps in the
// 128-byte swizzle that zero-fill past the edges, into a ring of four
// buffers with a full and an empty mbarrier each; the tensor cores read the
// weight K-major through a descriptor. The normalized rows never land in
// memory: each consumer warp reads its 16 rows of the x stage by ldmatrix,
// which gives mma.sync's A layout, normalizes them in fp32 with its rows'
// mean and rstd and the stage's scale and bias, rounds to bf16 and hands
// them to wgmma as its register A fragment. A stage's normalization runs
// while the previous stage's products are in flight (two sets of A
// registers; a stage is handed back once its products are done), and the
// ring runs on across tiles, so the next tile's loads fly during a tile's
// epilogue, which rounds the accumulators, adds the bias, rounds again and
// leaves through a swizzled shared tile as 16-byte stores. Edges: rows past
// N are zero-filled with rstd 0 and not stored; weight rows past 3W and k
// past W are zero-filled, with scale and bias 0 there, so a k tail adds
// exactly 0. (Staging by cp.async from the consumers, with a block barrier
// a stage, was far slower on an H100: the consumers' instruction issue
// bound it.)
//
// fp32 (`ln_qkv_fp32_kernel`): plain fp32 FMAs (TF32 would round the
// inputs), register-blocked: a 128 x 128 tile of 256 threads, each owning
// an 8 x 8 micro-tile (rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and
// 64 + tx*4 + j), so two float4 loads of y and two of the weight feed 64
// FMAs. k moves in stages of 16, double-buffered: x is normalized as it is
// staged k-major, and the weight rows are transposed k-major as they land.
//
// What bounds it. At the ViT-L-14-336 vision shape in bf16, (36928, 1024)
// against (3072, 1024), the work is 2 * 36928 * 1024 * 3072 = 232 GFLOP,
// 0.235 ms on the tensor cores at 989 TFLOP/s, against 0.31 GB of x,
// weight and output, 0.092 ms at 3.35 TB/s: the operations. A 128 x 192
// tile serves 85 FLOP per byte it stages from L2, and the normalization
// runs under the stage's products. In fp32 the floor is 3.47 ms at 67
// TFLOP/s of FMA issue. Times in PERF.md.
//
// The backward's LayerNorm (`ln_fast_bwd_kernel`): the gradient of the
// fast-variance LayerNorm above, which the JAX package takes by XLA's vjp of
// the twin `ln_qkv_reference` (pallas_ln_qkv.py:135-140; no pallas_call).
// Given x and dy = dL/dy (the normalized rows' gradient, (N, W) in the
// output's type), one block of 64 rows: a warp a row takes mean and rstd
// as the forward does, then mean(dyh) and mean(dyh * xh) with xh = (x -
// mean) * rstd and dyh = dy * scale; then the block walks its rows by
// column vectors and writes y (recomputed, rounded to the output type, for
// dW = g^T . y), dx = rstd * (dyh - mean(dyh) - xh * mean(dyh * xh)) in
// x's type, and its fp32 partials of dscale = sum(dy * xh) and dbias =
// sum(dy). A second kernel (`ln_fast_bwd_reduce_kernel`) sums the partials
// over the blocks in a fixed order: no atomics, so two runs agree bit for
// bit. Bound by bytes: x and dy read, y and dx written (0.30 GB at the
// vision shape, 0.090 ms).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWidth = 1664;
// row statistics
constexpr int kStatsThreads = 256;     // a warp a row
// bf16, wgmma
constexpr int kWarpgroupWarps = 4;
constexpr int kWgThreads = 384;        // two consumer warpgroups and a producer
constexpr int kWgRows = 128;           // 64 a warpgroup
constexpr int kWgCols = 192;           // m64n192k16
constexpr int kWgK = 64;               // k a stage: a 128-byte row of bf16
constexpr int kWgStages = 4;           // ring of x + weight stages
constexpr int kXStageBytes = kWgRows * 128;
constexpr int kWStageBytes = kWgCols * 128;
constexpr int kStageBytes = kXStageBytes + kWStageBytes;  // 40 KB, a multiple of 1024
constexpr int kOutChunks = kWgCols / 8;                   // 16-byte chunks an output row
constexpr int kOutRowBytes = kWgCols * 2;
constexpr int kOutBytes = kWgRows * kOutRowBytes;
// fp32
constexpr int kF32Threads = 256;       // (ty, tx) = (tid / 16, tid % 16)
constexpr int kF32Tile = 128;          // rows and columns a block
constexpr int kF32K = 16;              // k a stage
constexpr int kF32Stride = kF32Tile + 4;
// backward
constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 64;           // rows a block, one set of partials
constexpr int kRedCols = 32, kRedSlices = 32;  // the partials' reduction block

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int round_up(int a, int b) { return cdiv(a, b) * b; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 consecutive elements (16 or 32 bytes, 16-byte aligned) as floats, and back
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = bf2_to_f2(w[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]),
                                            f2_to_bf2(v[4], v[5]), f2_to_bf2(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ------------------------------------------------------------ row statistics

// Grid ceil(N / 8), 256 threads: a warp a row.
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
ln_row_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int N, int W,
                    float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kStatsThreads / 32) + (threadIdx.x >> 5);
  if (row >= N) return;
  const T* xr = x + (int64_t)row * W;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < W; c += 32 * 8) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      s += v[e] + v[e + 1];
      ss += v[e] * v[e] + v[e + 1] * v[e + 1];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mean = s / W;
    stats[row] = make_float2(mean, rsqrtf(ss / W - mean * mean + eps));
  }
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// the consumers' wait for the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// the producer's: one of ~10 s traps (the launch then fails) instead of
// hanging the card (a trap on the consumers' side would make ptxas wait on
// every product before it)
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}
// box (c0, c1) of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// two bf16 of x -> ((x - mean) * rstd) * scale + bias in fp32 -> two bf16
__device__ __forceinline__ uint32_t normalize2(uint32_t v, float mean, float rstd, float2 s,
                                               float2 b) {
  const float2 f = bf2_to_f2(v);
  return f2_to_bf2(((f.x - mean) * rstd) * s.x + b.x, ((f.y - mean) * rstd) * s.y + b.y);
}

// 1024 bytes of slack to align the ring, the ring, the output tile, the
// LayerNorm's scale and bias zero-padded to kpad, and a full and an empty
// barrier a stage
size_t wgmma_smem_bytes(int kpad) {
  return 1024 + (size_t)kWgStages * kStageBytes + kOutBytes + 2 * (size_t)kpad * sizeof(float) +
         2 * kWgStages * sizeof(uint64_t);
}

// Grid min(tiles, SMs), 384 threads, one block an SM. Warpgroup 2 is the
// producer: one thread walks the steps (a step is a tile's k stage) and
// loads each stage's x (128, 64) and weight (192, 64) boxes by TMA into
// the ring, once the stage's empty barrier says both consumers are done
// with its last use; the full barrier counts the bytes in. Warpgroups 0 and
// 1 consume, 64 rows each.
__global__ void __launch_bounds__(kWgThreads, 1)
ln_qkv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w, const float2* __restrict__ stats,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ kb, __nv_bfloat16* __restrict__ out, int N,
                    int W, int W3) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of the shared address
  unsigned char* ring =
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) &
                  1023);
  unsigned char* out_s = ring + kWgStages * kStageBytes;  // [128][24 chunks], chunk c at c ^ (r % 8)
  const int kpad = round_up(W, kWgK);
  float* scale_s = reinterpret_cast<float*>(out_s + kOutBytes);
  float* bias_s = scale_s + kpad;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + kpad);
  uint64_t* empty = full + kWgStages;

  const int nk = kpad / kWgK;
  const int col_tiles = cdiv(W3, kWgCols);
  const int tiles = cdiv(N, kWgRows) * col_tiles;
  const int steps = cdiv(tiles - (int)blockIdx.x, (int)gridDim.x) * nk;  // grid <= tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kpad; i += kWgThreads) {
    scale_s[i] = i < W ? scale[i] : 0.f;
    bias_s[i] = i < W ? bias[i] : 0.f;
  }
  if (tid == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the origin of this block's tile tl (tiles blockIdx.x + tl * gridDim.x,
  // the columns fastest)
  auto tile_origin = [&](int tl, int& r0, int& c0) {
    const int tile = blockIdx.x + tl * gridDim.x;
    r0 = (tile / col_tiles) * kWgRows;
    c0 = (tile % col_tiles) * kWgCols;
  };

  if (warp >= 2 * kWarpgroupWarps) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * kWarpgroupWarps * 32) {
      int r0 = 0, c0 = 0;
      for (int s = 0, kt = 0, tl = 0; s < steps; ++s) {
        const int st = s % kWgStages, use = s / kWgStages;
        if (use > 0) mbar_wait_or_trap(empty + st, (use - 1) & 1);
        if (kt == 0) tile_origin(tl, r0, c0);
        unsigned char* xs = ring + st * kStageBytes;
        mbar_expect_tx(full + st, kStageBytes);
        tma_load_2d(xs, &tmap_x, kt * kWgK, r0, full + st);
        tma_load_2d(xs + kXStageBytes, &tmap_w, kt * kWgK, c0, full + st);
        if (++kt == nk) kt = 0, ++tl;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;  // this warp's 16 rows of the tile (warpgroup warp / 4)
  float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};  // rows wrow + g and wrow + g + 8

  // the A fragments of step s (stage kt of tile tl): this warp's 16 rows of
  // the x stage, normalized, once the stage has landed
  auto prep = [&](uint32_t (&a)[kWgK / 16][4], int s, int kt, int tl) {
    if (kt == 0) {
      int r0, c0;
      tile_origin(tl, r0, c0);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + wrow + g + 8 * hr;
        const float2 st = row < N ? stats[row] : make_float2(0.f, 0.f);
        mean[hr] = st.x;
        rstd[hr] = st.y;
      }
    }
    mbar_wait(full + s % kWgStages, (s / kWgStages) & 1);
    const unsigned char* xs = ring + (s % kWgStages) * kStageBytes;
    const int r = wrow + (lane & 15);
#pragma unroll
    for (int ks = 0; ks < kWgK / 16; ++ks) {
      uint32_t raw[4];  // (row g, k 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
      ldmatrix_x4(raw, reinterpret_cast<const __nv_bfloat16*>(
                           xs + r * 128 + (((2 * ks + (lane >> 4)) ^ (r & 7)) << 4)));
      const int k = kt * kWgK + ks * 16 + 2 * t;
      const float2 s0 = *reinterpret_cast<const float2*>(scale_s + k);
      const float2 s1 = *reinterpret_cast<const float2*>(scale_s + k + 8);
      const float2 b0 = *reinterpret_cast<const float2*>(bias_s + k);
      const float2 b1 = *reinterpret_cast<const float2*>(bias_s + k + 8);
      a[ks][0] = normalize2(raw[0], mean[0], rstd[0], s0, b0);
      a[ks][1] = normalize2(raw[1], mean[1], rstd[1], s0, b0);
      a[ks][2] = normalize2(raw[2], mean[0], rstd[0], s1, b1);
      a[ks][3] = normalize2(raw[3], mean[1], rstd[1], s1, b1);
    }
  };

  float acc[kWgCols / 2];
#pragma unroll
  for (int i = 0; i < kWgCols / 2; ++i) acc[i] = 0.f;

  // step s's products: four m64n192k16, the first of a tile overwriting acc
  auto issue = [&](const uint32_t (&a)[kWgK / 16][4], int s, int kt) {
    const uint64_t dw = sw128_desc(ring + (s % kWgStages) * kStageBytes + kXStageBytes);
    const int carry = kt != 0;
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWgK / 16; ++ks)  // 16 k = 32 bytes = 2 descriptor units
      wgmma_rs<0>(acc, a[ks], dw + 2 * ks, ks > 0 ? 1 : carry);
    wgmma_commit();
    fence_operand(acc);
  };

  // tile tl is complete: round, add the bias, round, and store through
  // this warp's 16 rows of the output tile
  auto epilogue = [&](int tl) {
    int r0, c0;
    tile_origin(tl, r0, c0);
#pragma unroll
    for (int j = 0; j < kOutChunks; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      const float2 kbv = col < W3 ? bf2_to_f2(*reinterpret_cast<const uint32_t*>(kb + col))
                                  : make_float2(0.f, 0.f);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wrow + g + 8 * hr;
        const float v0 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * hr])) + kbv.x;
        const float v1 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * hr + 1])) + kbv.y;
        *reinterpret_cast<uint32_t*>(out_s + r * kOutRowBytes + ((j ^ (r & 7)) << 4) + 4 * t) =
            f2_to_bf2(v0, v1);
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * kOutChunks; i += 32) {
      const int rr = i / kOutChunks, c = i - rr * kOutChunks;
      const int r = wrow + rr, row = r0 + r, col = c0 + c * 8;  // W3 is a multiple of 8
      if (row < N && col < W3) {
        *reinterpret_cast<uint4*>(out + (int64_t)row * W3 + col) =
            *reinterpret_cast<const uint4*>(out_s + r * kOutRowBytes + ((c ^ (r & 7)) << 4));
      }
    }
    __syncwarp();
  };

  // Step s: issue its products, free step s - 1's stage once they are done
  // (one arrival a warpgroup: its four warps' A fragments went into them),
  // normalize step s + 1 under them, and at a tile's last stage store it.
  auto step = [&](uint32_t (&cur)[kWgK / 16][4], uint32_t (&nxt)[kWgK / 16][4], int s, int& kt,
                  int& tl) {
    issue(cur, s, kt);
    wgmma_wait<1>();
    if (s > 0 && (tid & 127) == 0) mbar_arrive(empty + (s - 1) % kWgStages);
    const bool last = kt == nk - 1;
    const int kt1 = last ? 0 : kt + 1, tl1 = last ? tl + 1 : tl;
    if (s + 1 < steps) prep(nxt, s + 1, kt1, tl1);
    if (last) {
      wgmma_wait<0>();
      fence_operand(acc);
      epilogue(tl);
    }
    kt = kt1;
    tl = tl1;
  };
  uint32_t a0[kWgK / 16][4], a1[kWgK / 16][4];
  int kt = 0, tl = 0;
  prep(a0, 0, 0, 0);
  for (int s = 0; s < steps; s += 2) {
    step(a0, a1, s, kt, tl);
    if (s + 1 < steps) step(a1, a0, s + 1, kt, tl);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, W) bf16 row-major matrix in boxes of (box_rows, 64): 128-byte
// swizzle, zero past its edges
bool bf16_tensor_map(CUtensorMap* map, const void* ptr, int rows, int width, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kWgK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------ fp32

// Grid (ceil(3W / 128), ceil(N / 128)), 256 threads: the columns fastest,
// so the blocks in flight share their rows. Two blocks an SM (128
// registers): on an H100, one block an SM, or 128-thread blocks of 8 x 16
// micro-tiles (six float4 loads a 128 FMAs), were slower.
__global__ void __launch_bounds__(kF32Threads, 2)
ln_qkv_fp32_kernel(const float* __restrict__ x, const float2* __restrict__ stats,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ w, const float* __restrict__ kb,
                   float* __restrict__ out, int N, int W, int W3) {
  __shared__ __align__(16) float a_s[2][kF32K][kF32Stride];  // normalized rows, k-major
  __shared__ __align__(16) float b_s[2][kF32K][kF32Stride];  // weight rows, k-major
  __shared__ float2 st_s[kF32Tile];

  const int c0 = blockIdx.x * kF32Tile, r0 = blockIdx.y * kF32Tile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nk = cdiv(W, kF32K);
  if (tid < kF32Tile) {
    const int row = r0 + tid;
    st_s[tid] = row < N ? stats[row] : make_float2(0.f, 0.f);
  }

  // a stage in registers: two float4 of x and two of the weight a thread
  // (4 threads cover a row's 16 k)
  constexpr int kQ = kF32Tile * kF32K / 4 / kF32Threads, kRowVecs = kF32K / 4;
  float4 xv[kQ], wv[kQ];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int kt) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = tid + q * kF32Threads, lr = i / kRowVecs, k = kt * kF32K + (i % kRowVecs) * 4;
      const int row = r0 + lr, n = c0 + lr;  // k < W implies k + 3 < W
      xv[q] = row < N && k < W ? *reinterpret_cast<const float4*>(x + (int64_t)row * W + k) : zero;
      wv[q] = n < W3 && k < W ? *reinterpret_cast<const float4*>(w + (int64_t)n * W + k) : zero;
    }
  };
  auto store = [&](int buf, int kt) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = tid + q * kF32Threads, lr = i / kRowVecs, kc = (i % kRowVecs) * 4;
      const int k = kt * kF32K + kc;
      const float2 st = st_s[lr];
      const bool live = k < W;
      const float4 sc4 = live ? __ldg(reinterpret_cast<const float4*>(scale + k)) : zero;
      const float4 bi4 = live ? __ldg(reinterpret_cast<const float4*>(bias + k)) : zero;
      const float v[4] = {xv[q].x, xv[q].y, xv[q].z, xv[q].w};
      const float u[4] = {wv[q].x, wv[q].y, wv[q].z, wv[q].w};
      const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w}, bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a_s[buf][kc + e][lr] = live ? ((v[e] - st.x) * st.y) * sc[e] + bi[e] : 0.f;
        b_s[buf][kc + e][lr] = u[e];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the row statistics
  load(0);
  store(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);  // global reads fly during the products
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in the previous stage, before its barrier
    if (kt + 1 < nk) store(buf ^ 1, kt + 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h * 64 + tx * 4;  // a multiple of 4; so is W3
      if (col < W3) {
        *reinterpret_cast<float4*>(out + (int64_t)row * W3 + col) = make_float4(
            acc[i][4 * h] + __ldg(kb + col), acc[i][4 * h + 1] + __ldg(kb + col + 1),
            acc[i][4 * h + 2] + __ldg(kb + col + 2), acc[i][4 * h + 3] + __ldg(kb + col + 3));
      }
    }
  }
}

// ------------------------------------------------------------------ backward

// Grid ceil(N / 64), 256 threads. partial: (grid, 2W) fp32, the block's
// dscale then dbias over its rows.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ln_fast_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   T* __restrict__ y, T* __restrict__ dx, float* __restrict__ partial, int N,
                   int W, float eps) {
  __shared__ float4 row_s[kBwdRows];               // mean, rstd, mean(dyh), mean(dyh * xh)
  __shared__ float red_s[kBwdThreads * 16];        // each thread's column sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kBwdRows;

  // a warp a row: the forward's statistics, then the two row means of dx
  for (int r = warp; r < kBwdRows && r0 + r < N; r += kBwdThreads / 32) {
    const T* xr = x + (int64_t)(r0 + r) * W;
    const T* dr = dy + (int64_t)(r0 + r) * W;
    float s = 0.f, ss = 0.f;
    for (int c = lane * 8; c < W; c += 32 * 8) {
      float v[8];
      load8(xr + c, v);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        s += v[e] + v[e + 1];
        ss += v[e] * v[e] + v[e + 1] * v[e + 1];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / W;
    const float rstd = rsqrtf(ss / W - mean * mean + eps);
    float sd = 0.f, sdx = 0.f;
    for (int c = lane * 8; c < W; c += 32 * 8) {
      float v[8], d[8], sc[8];
      load8(xr + c, v);
      load8(dr + c, d);
      load8(scale + c, sc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dh = d[e] * sc[e];
        sd += dh;
        sdx += dh * ((v[e] - mean) * rstd);
      }
    }
    sd = warp_sum(sd);
    sdx = warp_sum(sdx);
    if (lane == 0) row_s[r] = make_float4(mean, rstd, sd / W, sdx / W);
  }
  __syncthreads();

  // by column vectors: thread (q, v) takes vector v of rows q, q + groups, ...
  const int nvec = W / 8;
  const int groups = kBwdThreads / nvec;  // >= 1: nvec <= 208
  const int v = tid % nvec, q = tid / nvec;
  float ps[8], pb[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ps[e] = pb[e] = 0.f;
  if (q < groups) {
    float sc[8], bi[8];
    load8(scale + v * 8, sc);
    load8(bias + v * 8, bi);
#pragma unroll 2
    for (int r = q; r < kBwdRows && r0 + r < N; r += groups) {
      const float4 st = row_s[r];
      const int64_t off = (int64_t)(r0 + r) * W + v * 8;
      float xv[8], dv[8], yv[8], gv[8];
      load8(x + off, xv);
      load8(dy + off, dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (xv[e] - st.x) * st.y;
        yv[e] = xh * sc[e] + bi[e];
        gv[e] = st.y * (dv[e] * sc[e] - st.z - xh * st.w);
        ps[e] += dv[e] * xh;
        pb[e] += dv[e];
      }
      store8(y + off, yv);
      store8(dx + off, gv);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red_s[tid * 16 + e] = ps[e];
    red_s[tid * 16 + 8 + e] = pb[e];
  }
  __syncthreads();
  if (tid < nvec) {  // the groups' sums, in order
    float s16[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s16[e] = red_s[tid * 16 + e];
    for (int qq = 1; qq < groups; ++qq) {
#pragma unroll
      for (int e = 0; e < 16; ++e) s16[e] += red_s[(qq * nvec + tid) * 16 + e];
    }
    float* p = partial + (int64_t)blockIdx.x * 2 * W + tid * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = s16[e];
      p[W + e] = s16[8 + e];
    }
  }
}

// Grid ceil(2W / 32), (32, 32) threads: column j of the partials summed over
// the blocks b = slice, slice + 32, ..., then over the 32 slices, in order.
__global__ void __launch_bounds__(kRedCols * kRedSlices)
ln_fast_bwd_reduce_kernel(const float* __restrict__ partial, int blocks, int cols,
                          float* __restrict__ out) {
  __shared__ float part_s[kRedSlices][kRedCols + 1];
  const int j = blockIdx.x * kRedCols + threadIdx.x, slice = threadIdx.y;
  float acc = 0.f;
  if (j < cols) {
#pragma unroll 4
    for (int b = slice; b < blocks; b += kRedSlices) acc += partial[(int64_t)b * cols + j];
  }
  part_s[slice][threadIdx.x] = acc;
  __syncthreads();
  if (slice == 0 && j < cols) {
    float s = 0.f;
    for (int i = 0; i < kRedSlices; ++i) s += part_s[i][threadIdx.x];
    out[j] = s;
  }
}

// ------------------------------------------------------------------ launch

int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? sms : -(int)err;
}

template <typename T>
int launch_stats(const void* x, float2* stats, int n, int width, float eps, cudaStream_t stream) {
  ln_row_stats_kernel<T><<<cdiv(n, kStatsThreads / 32), kStatsThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, n, width, eps);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* x, const float2* stats, const float* scale, const float* bias,
                 const void* w, const void* kb, void* out, int n, int width, int cols,
                 cudaStream_t stream) {
  CUtensorMap mx, mw;
  if (!bf16_tensor_map(&mx, x, n, width, kWgRows) ||
      !bf16_tensor_map(&mw, w, cols, width, kWgCols))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(round_up(width, kWgK));
  const cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const int tiles = cdiv(n, kWgRows) * cdiv(cols, kWgCols);
  ln_qkv_wgmma_kernel<<<tiles < sms ? tiles : sms, kWgThreads, smem, stream>>>(
      mx, mw, stats, scale, bias, static_cast<const __nv_bfloat16*>(kb),
      static_cast<__nv_bfloat16*>(out), n, width, cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const float* scale, const float* bias, void* y,
               void* dx, float* partial, float* dscale_dbias, int n, int width, float eps,
               cudaStream_t stream) {
  const int blocks = cdiv(n, kBwdRows);
  ln_fast_bwd_kernel<T><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias, static_cast<T*>(y),
      static_cast<T*>(dx), partial, n, width, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_fast_bwd_reduce_kernel<<<cdiv(2 * width, kRedCols), dim3(kRedCols, kRedSlices), 0, stream>>>(
      partial, blocks, 2 * width, dscale_dbias);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int width, int dtype) {
  return n <= 0 || width <= 0 || width % 8 || width > kMaxWidth || (dtype != 0 && dtype != 1);
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 on success): a refused launch never runs, and a
// later synchronise would not report it. dtype: 0 = fp32, 1 = bf16 (x, w,
// kb and out alike; scale and bias are fp32). Pointers start on a 16-byte
// boundary (16-byte loads and TMA); the wrapper checks it.

// The forward: the row statistics into `stats` ((N, 2) fp32 scratch), then
// the product with the (cols, W) weight: cols is 3W, or a tensor-parallel
// rank's 3W / tp, a multiple of 8.
extern "C" int sparsify_ln_qkv_fwd(const void* x, const float* scale, const float* bias,
                                   const void* w, const void* kb, void* out, void* stats, int n,
                                   int width, int cols, float eps, int dtype, void* stream) {
  if (bad_shape(n, width, dtype) || cols <= 0 || cols % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  if (dtype == 1) {
    const int err = launch_stats<__nv_bfloat16>(x, st, n, width, eps, s);
    return err ? err : launch_wgmma(x, st, scale, bias, w, kb, out, n, width, cols, s);
  }
  const int err = launch_stats<float>(x, st, n, width, eps, s);
  if (err) return err;
  const dim3 grid(cdiv(cols, kF32Tile), cdiv(n, kF32Tile));
  ln_qkv_fp32_kernel<<<grid, kF32Threads, 0, s>>>(
      static_cast<const float*>(x), st, scale, bias, static_cast<const float*>(w),
      static_cast<const float*>(kb), static_cast<float*>(out), n, width, cols);
  return (int)cudaGetLastError();
}

// fp32 elements of the backward's `partial` scratch for (N, W)
extern "C" long long sparsify_ln_fast_bwd_scratch(int n, int width) {
  return (long long)cdiv(n, kBwdRows) * 2 * width;
}

// The backward's LayerNorm: from x (N, W) and dy (N, W), both in the dtype,
// and the fp32 scale and bias, y and dx (N, W) in the dtype and
// dscale_dbias (2W,) fp32: dscale, then dbias.
extern "C" int sparsify_ln_fast_bwd(const void* x, const void* dy, const float* scale,
                                    const float* bias, void* y, void* dx, float* partial,
                                    float* dscale_dbias, int n, int width, float eps, int dtype,
                                    void* stream) {
  if (bad_shape(n, width, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd<__nv_bfloat16>(x, dy, scale, bias, y, dx, partial, dscale_dbias, n,
                                         width, eps, s)
             : launch_bwd<float>(x, dy, scale, bias, y, dx, partial, dscale_dbias, n, width,
                                 eps, s);
}
