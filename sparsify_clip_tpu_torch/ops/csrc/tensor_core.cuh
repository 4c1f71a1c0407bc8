// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels:
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix fragment loads and
// their lane offsets, reductions over an accumulator row's lane quad, the
// hi + lo split that keeps an fp32 operand at fp32 grade, cp.async
// staging, and Hopper's warpgroup MMA (wgmma) with A from registers: its
// fences, the descriptor of a 128-byte-swizzled shared tile, and the issue
// at n64 and n192. Included by `mha_fwd_tiles.cuh` and `mha_bwd_tiles.cuh`
// (for `mha_fwd.cu`, `mha_bwd.cu` and `mha_head_group.cu`) and `ln_qkv.cu`;
// the anonymous namespace keeps each translation unit's copy apart at link
// time.

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

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins an accumulator fragment in place: no instruction that reads or
// writes it moves across this point (the wgmma waits are asm the compiler
// cannot see the accumulators in).
template <int kN>
__device__ __forceinline__ void fence_operand(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// this thread's generic-proxy shared-memory writes (cp.async), made visible
// to the async proxy the tensor cores read through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared-memory matrix descriptor of a 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart: start address (bits 0-13), leading
// byte offset (16-29, unused by these tiles), stride byte offset (32-45),
// layout 1 = 128-byte swizzle (62-63); addresses and offsets in 16 bytes.
// In such a tile, 16-byte chunk c of row r lies at r * 128 + (c ^ (r % 8))
// * 16 from a 1024-byte-aligned base; k16 step s of a K-major tile (a row
// of 64 bf16) is the descriptor plus 2 s.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D = A . B (+ D when scale_d is non-zero), m64nNk16, bf16 in, fp32
// accumulate: A 64 x 16 from registers (each warp of the warpgroup gives
// its 16 rows in mma.sync's m16n8k16 A layout), B 16 x N from shared memory
// through a descriptor, K-major (kTransB 0: a row-major (n, k) tile) or
// MN-major (kTransB 1: a row-major (k, n) tile). D is the warpgroup's
// accumulator fragment, N / 2 floats a thread: for 8-column n-tile j, d[4j],
// d[4j + 1] hold (row 16 warp + g, columns 8j + 2t, 8j + 2t + 1) and d[4j +
// 2], d[4j + 3] row + 8, lane = 4g + t. N is 64 (32 floats) or 192 (96).
template <int kTransB, int kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(kAcc == 32 || kAcc == 96, "wgmma_rs takes n64 or n192");
  if constexpr (kAcc == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
}

}  // namespace
