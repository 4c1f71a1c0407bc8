// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels:
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix fragment loads and
// their lane offsets, reductions over an accumulator row's lane quad, the
// hi + lo split that keeps an fp32 operand at fp32 grade, and cp.async
// staging. Included by `mha_fwd_tiles.cuh` and `mha_bwd_tiles.cuh` (for
// `mha_fwd.cu`, `mha_bwd.cu` and `mha_head_group.cu`) and `ln_qkv.cu`; the anonymous
// namespace keeps each translation unit's copy apart at link time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// D = A.B + D for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 fp32. Fragment of lane (g = lane / 4, t = lane % 4), two bf16 a
// register, lower column (or k) in the low half:
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   d0, d1 (g, 2t..2t+1)  d2, d3 (g+8, 2t..2t+1)
// So the accumulators of two neighbouring 8-column tiles, packed in pairs,
// are the A fragment of a product whose k runs over those 16 columns.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of matrix i's rows, and register i of lane (g, t) holds
// elements (row g, cols 2t, 2t+1) of matrix i. A row-major (m, k) tile
// gives mma's A fragment (matrices: rows 0-7 / 8-15 by k 0-7 / 8-15); an
// (n, k) tile, k contiguous, gives its B fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, transposed: register i of lane (g, t) holds elements (row 2t,
// col g) and (row 2t+1, col g) of matrix i. A (k, n) tile, n contiguous
// (rows = keys, cols = head columns of row-major V), gives B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The ldmatrix row address of this lane, as an offset into a tile of row
// stride kStride: for mma's A fragment from a row-major (m, k) tile, and for
// B fragments from a (k, n) tile (transposed load), matrices rows 0-7 /
// 8-15 by columns 0-7 / 8-15; for two 8-wide n-tiles of B fragments from an
// (n, k) tile (plain load), matrices n 0-7 by k 0-7 / 8-15, then n 8-15.
template <int kStride>
__device__ __forceinline__ int frag_offset(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
}
template <int kStride>
__device__ __forceinline__ int nk_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
}

// the sum and the max over a lane quad (the four lanes that share a row of
// an mma accumulator)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// (x, y) -> bf16 pairs hi and lo with hi + lo = (x, y) to ~2^-16 relative
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16 bytes from global to shared memory, asynchronously; with `full` false
// nothing is read and the 16 bytes are zero-filled (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way (zero-filled when `full` is false)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
