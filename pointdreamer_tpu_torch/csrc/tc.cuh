// Tensor-core building blocks shared by the bf16 kernels (attention.cu,
// winograd.cu) and the int8 one (quant.cu), sm_80+ PTX that Hopper runs as
// is: cp.async copies into shared memory, ldmatrix fragment loads,
// mma.sync m16n8k16 bf16 products with fp32 accumulators and m16n8k32 s8
// products with int32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A 16x16 (row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                        a3 (g+8, 2t+8..)
//   B 16x8  (k x n):     b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C 16x8  (fp32):      c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// ldmatrix .x4 reads four 8x8 b16 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i; each lane receives (row g, cols 2t..2t+1) of each
// (with .trans: rows 2t..2t+1, col g), i.e. an A fragment from a row-major
// [m][k] tile, a B fragment from an [n][k] tile (plain) or a [k][n] tile
// (.trans).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with valid == false the 16
// bytes are zero-filled and src is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b on the tensor cores (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores (s8 in, s32 accumulate), m16n8k32.  Its
// fragments hold the same bytes as m16n8k16 bf16's (4 int8 where bf16 has
// 2), so the ldmatrix loads above serve it unchanged on 32-byte rows:
//   A 16x32: a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..), a3 (g+8, ..)
//   B 32x8:  b0 (k = 4t..4t+3, n = g), b1 (k = 16+4t.., n = g)
//   C 16x8:  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1), int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
