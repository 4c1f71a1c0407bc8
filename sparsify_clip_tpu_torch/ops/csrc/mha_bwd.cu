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
//   `mha_bwd_dq_kernel`: a block takes one (batch, head) and 32 query rows.
//     Pass 1 walks the keys in tiles of 32 and sums Dr; pass 2 walks them
//     again, forms dS and accumulates dQ. It stores Dr for the second kernel.
//   `mha_bwd_dkv_kernel`: a block takes one (batch, head) and 32 keys, walks
//     the query rows in tiles of 32 (from its own first key on when causal),
//     and accumulates dK and dV.
// S and dP are recomputed in each pass (nine L^2.D products a head instead
// of five); in exchange a block's shared memory is four 32-row tiles, so any
// L takes the same kernel (the slice needs 50 and 77, the zoo 197, 257 and
// 577) and head_dim may be any multiple of 8 up to 128. Both kernels
// compute S and dP with the same fp32 FMAs in the same order, so pass 2 and
// the dK/dV kernel see bitwise the P that Dr was summed over.
//
// What bounds it on an H100. At ViT-B-32's shapes (B = 256, L = 50 and 77,
// D = 64) the arithmetic is ~5 GFLOP a layer and the bytes ~0.3 GB, so a
// kernel on the tensor cores would be bound by device memory. This one is
// not: it runs plain fp32 FMAs out of shared memory (the bf16 inputs are
// widened on the way in), 128 threads a block, each thread 8 rows by one
// key for S and dP and 8 rows by 4 columns for the gradients; it is bound
// by FMA issue and shared-memory loads, and it pads L = 50 to two 32-row
// tiles. Its time stands in PERF.md; mma.sync or wgmma for the bf16 path is
// later work.

#include "mha_bwd_tiles.cuh"

// C entry point, bound with ctypes. Launches both kernels on `stream` and
// returns the first CUDA error (0 on success): a refused launch never runs,
// and a later synchronise would not report it.
// dtype: 0 = fp32, 1 = bf16 (qkv, dout and dqkv). drow is (B, H, L) fp32
// scratch that the wrapper allocates.
extern "C" int sparsify_mha_bwd(const void* qkv, const float* lse, const void* dout, void* dqkv,
                                float* drow, int batch, int seq, int heads, int head_dim,
                                int causal, int dtype, float scale, void* stream) {
  if (head_dim <= 0 || head_dim > kMaxHeadDim || head_dim % 8 != 0 || seq <= 0 || heads <= 0 ||
      batch <= 0 || batch > 65535 || heads > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dq_dkv<__nv_bfloat16, SavedLse>(qkv, lse, nullptr, dout, dqkv, drow, batch, seq,
                                                  heads, head_dim, causal, scale, s);
  return launch_dq_dkv<float, SavedLse>(qkv, lse, nullptr, dout, dqkv, drow, batch, seq, heads,
                                        head_dim, causal, scale, s);
}
