// Long-sequence attention over the packed qkv projection: the backward
// that recomputes the softmax from q and k. (The route's forward, which
// writes no row LSE, is `sparsify_mha_fwd_head_group` in `mha_fwd.cu`.)
//
// Replaces the TPU kernel of sparsify_clip_tpu/ops/pallas_attention.py on
// its head-group route (`_use_per_head`, taken when one sample's packed
// qkv is over 3 MB and head_dim packs into 128 lanes: the 577-token
// ViT-L-14-336 vision tower in bf16 and fp32, ViT-L-14's in fp32):
//   `_bwd_kernel_head_group` (driven by `_vjp_bwd`): dq, dk and dv from
//     qkv and dout alone, m, e and p = e / sum(e) rebuilt from q.k.
// The TPU kernels walk a (batch, 128-lane head group) grid because a whole
// 577-token block overflows the TPU's scoped VMEM. That limit is not the
// card's; what carries over is the function and its residuals (qkv only),
// so the port keeps the route and not the blocks.
//
//   qkv  (B, L, 3W), bf16 or fp32 (W = H * D): q at column h*D, k at
//        W + h*D, v at 2W + h*D, read in place;
//   dout (B, L, W), qkv's type; dqkv (B, L, 3W), qkv's type.
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

// C entry point, bound with ctypes: the dQ kernel (which also writes each
// row's max, sum and Dr), then the dK/dV kernel. Launches on `stream` and
// returns the first CUDA error (0 on success): a refused launch never runs,
// and a later synchronise would not report it. dtype: 0 = fp32, 1 = bf16
// (qkv, dout and dqkv alike). row_max and row_sum are (B, L, H) fp32 and
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
