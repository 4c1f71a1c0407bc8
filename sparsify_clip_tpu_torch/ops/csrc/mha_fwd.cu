// The attention forwards over the packed qkv projection, both routes: the
// whole-width route's context and row LSE, and the head-group route's
// context alone.
//
// Replaces the TPU kernels of sparsify_clip_tpu/ops/pallas_attention.py
// `_fwd_kernel` (driven by `_run_fwd` under `mha_pallas`) and
// `_fwd_kernel_head_group` (driven by `_run_fwd_per_head`). The kernels are
// the shared forward of `mha_fwd_tiles.cuh` (its note has the design and
// what bounds it). The whole-width route writes the (B, L, H) fp32 row LSE
// that the whole-width backward (`mha_bwd.cu`) rebuilds P from, when asked;
// the head-group route writes none, and its backward (`mha_head_group.cu`)
// recomputes the softmax from q and k. Its context is e / sum(e) times V in
// fp32 grade, as the TPU kernel computes it: one reciprocal of the row sum
// a row, applied to the fp32 context before it is rounded.

#include "mha_fwd_tiles.cuh"

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success): a refused launch
// never runs, and a later synchronise would not report it.
// dtype: 0 = fp32, 1 = bf16 (both qkv and out). qkv must start on a
// 16-byte boundary (cp.async copies 16-byte vectors); the wrappers check it.

// The whole-width forward; lse may be null (no LSE).
extern "C" int sparsify_mha_fwd(const void* qkv, void* out, float* lse, int batch, int seq,
                                int heads, int head_dim, int causal, int dtype, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lse != nullptr ? attn_fwd::launch<true>(qkv, out, lse, batch, seq, heads, head_dim,
                                                 causal, dtype, scale, s)
                        : attn_fwd::launch<false>(qkv, out, lse, batch, seq, heads, head_dim,
                                                  causal, dtype, scale, s);
}

// The head-group forward: context only.
extern "C" int sparsify_mha_fwd_head_group(const void* qkv, void* out, int batch, int seq,
                                           int heads, int head_dim, int causal, int dtype,
                                           float scale, void* stream) {
  return attn_fwd::launch<false>(qkv, out, nullptr, batch, seq, heads, head_dim, causal, dtype,
                                 scale, static_cast<cudaStream_t>(stream));
}
