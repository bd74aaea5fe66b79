// Building blocks shared by the attention kernels: cp.async copies, and
// for the bf16 kernels the staging of bf16 row tiles, ldmatrix fragment
// loads and the mma.sync m16n8k16 bf16 product with f32 accumulators.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for a
// lane with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 = (row g,     cols 2t, 2t+1)   a2 = (row g,     cols 8+2t, 8+2t+1)
//     a1 = (row g + 8, cols 2t, 2t+1)   a3 = (row g + 8, cols 8+2t, 8+2t+1)
//   B (16 x 8, k x n), 2 registers:
//     b0 = (k 2t, 2t+1; col g)          b1 = (k 8+2t, 8+2t+1; col g)
//   C (16 x 8, f32), 4 registers:
//     c0, c1 = (row g, cols 2t, 2t+1)   c2, c3 = (row g + 8, cols 2t, 2t+1)
// So the accumulator of two neighbouring n-blocks, rounded to bf16, is
// the A fragment of one k-step of the next product (pack_a), which keeps
// P and dS in registers.
//
// Tiles live in shared memory as bf16 rows of D values padded to a stride
// of D + 8: a row is then 16 bytes (4 banks) further along the banks than
// the one before, so the 8 rows an ldmatrix phase reads hit 8 distinct
// 4-bank groups and the loads are free of bank conflicts, and every row
// start stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

// Row stride, in bf16 values, of a shared-memory tile of head dim D.
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 8;
}

// 16-byte async copy global -> shared; `src_bytes` < 16 zero-fills the
// rest (0 writes 16 zero bytes and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// 4-byte async copy (one f32), zero-filled when `ok` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + ROWS) of a contiguous (rows, D) bf16 matrix into a
// ROWS x row_stride<D>() tile with 16-byte cp.async, NT threads sharing
// the work; rows at or past `rows` are zero-filled by the copy itself.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int rows) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
  for (int j = 0; j < ROWS * CPR / NT; ++j) {
    const int i = j * NT + threadIdx.x;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < rows;
    const bf16* g = ok ? src + (int64_t)(r0 + r) * D + c * 8 : src;
    cp_async16(dst + r * row_stride<D>() + c * 8, g, ok ? 16 : 0);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major
// tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of a product X . Y^T where Y is stored row-major (n, k):
// rows [n0, n0 + 16) of Y (two n-blocks) x cols [k0, k0 + 16) (one
// k-step).  b[0], b[1] feed n-block n0, b[2], b[3] n-block n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of a product X . Y where Y is stored row-major (k, n):
// rows [k0, k0 + 16) (one k-step) x cols [n0, n0 + 16) (two n-blocks),
// through ldmatrix.trans.  b[0], b[1] feed n-block n0, b[2], b[3] n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           n0 + (lane >> 4) * 8);
}

// c += a . b on the tensor cores (bf16 inputs, f32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one 16-wide k-step from the f32 accumulators of the
// two 8-wide n-blocks that make it up, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Max and sum over the 4 lanes of a quad (the lanes that share a row of
// an accumulator).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store two neighbouring f32 values as one bf16 pair.
__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

}  // namespace mma
