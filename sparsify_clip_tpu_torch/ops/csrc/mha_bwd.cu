// Fused multi-head self-attention backward over the packed qkv projection.
//
// Replaces the TPU kernel sparsify_clip_tpu/ops/pallas_attention.py
// `_bwd_kernel` (driven by `_vjp_bwd` under `mha_pallas`): the same math
// from the same residuals.
//
//   qkv  (B, L, 3W), bf16 or fp32, as the forward read it (W = H * D);
//   lse  (B, L, H) fp32, the forward's per-head row log-sum-exp;
//   dout (B, L, W), qkv's type, the context's gradient;
//   dqkv (B, L, 3W), qkv's type: dQ at column h*D, dK at W + h*D, dV at
//        2W + h*D, the packed layout in_proj's backward reads.
//
// With S = Q.K^T * s (s = D^-0.5), the causal mask col > row, and
// P = exp(S - LSE) rebuilt from the saved LSE:
//   dV = P^T.dO,  dP = dO.V^T,  Dr = rowsum(dP o P),  dS = P o (dP - Dr),
//   dQ = dS.K * s,  dK = dS^T.Q * s.
// Dr is taken as rowsum(dP o P), as the TPU kernel takes it, and not as
// FlashAttention's rowsum(dO o O): O was rounded to bf16 on the way out of
// the forward, and that shortcut would carry the rounding into dS. All
// products accumulate in fp32 and each gradient is rounded once to the
// output type.
//
// Design: two kernels on one stream, no atomics, deterministic, both in
// `mha_bwd_tiles.cuh` (shared with the head-group backward), instantiated
// here with the `SavedLse` row policy.
//   the dQ kernel: a block takes one (batch, head) and a tile of query rows.
//     Its first sweep over the keys sums Dr; its second forms dS and
//     accumulates dQ. It stores Dr for the second kernel.
//   the dK/dV kernel: a block takes one (batch, head) and a tile of keys,
//     walks the query rows (from its own first key on when causal), and
//     accumulates dK and dV.
// Any L takes the same kernels (the slice needs 50 and 77, the zoo 197, 257
// and 577; the ragged last tile is masked by index), and head_dim may be
// any multiple of 8 up to 128 (zero-filled up to the mma's k of 16).
//
// What bounds it on an H100. At ViT-B-32's shapes (B = 256, L = 50 and 77,
// D = 64) the five products are ~5 GFLOP a layer against ~0.14 GB of qkv,
// dout and dqkv: 5 us on the tensor cores, 41 us of memory, so the floor is
// the bytes. The bf16 kernels run every product on mma.sync (64-row tiles,
// 16 rows a warp, cp.async staging), which keeps the arithmetic well below
// the memory floor even with S and dP recomputed and the hi + lo split;
// what is left above the floor is the two sweeps' second read of K and V
// and the 64-row tile's padding at L = 50 (PERF.md has the times). The fp32
// route (the eval twin takes no gradient, so no main path runs it) stays on
// plain FMAs out of shared memory.

#include "mha_bwd_tiles.cuh"

// C entry point, bound with ctypes. Launches both kernels on `stream` and
// returns the first CUDA error (0 on success): a refused launch never runs,
// and a later synchronise would not report it.
// dtype: 0 = fp32, 1 = bf16 (qkv, dout and dqkv). drow is (B, H, L) fp32
// scratch that the wrapper allocates. The bf16 route copies 16-byte vectors
// with cp.async: qkv and dout must start on a 16-byte boundary (the wrapper
// copies a misaligned dout first).
extern "C" int sparsify_mha_bwd(const void* qkv, const float* lse, const void* dout, void* dqkv,
                                float* drow, int batch, int seq, int heads, int head_dim,
                                int causal, int dtype, float scale, void* stream) {
  // SavedLse only reads row_a (the LSE) and never writes it
  return launch_dq_dkv<SavedLse>(qkv, const_cast<float*>(lse), nullptr, dout, dqkv, drow, batch,
                                 seq, heads, head_dim, causal, dtype, scale,
                                 static_cast<cudaStream_t>(stream));
}
