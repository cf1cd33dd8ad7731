// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (sm_90a): warp-level mma.sync on bf16 with f32 accumulation, ldmatrix
// fragment loads from shared memory, and cp.async copies that zero-fill.
//
// Fragments of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and q = lane % 4:
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 = A[g][2q, 2q+1], a1 = A[g+8][2q, 2q+1],
//     a2 = A[g][2q+8, 2q+9], a3 = A[g+8][2q+8, 2q+9]
//   B (16 x 8, k by n), two registers: b0 = B[2q, 2q+1][g], b1 = B[2q+8, 2q+9][g]
//   C (16 x 8, f32): c0, c1 = C[g][2q, 2q+1], c2, c3 = C[g+8][2q, 2q+1]
// The lower-indexed element of each pair sits in the low 16 bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// The widest copy unit of 16, 8, 4 or 2 bytes that divides `a`, the OR of a
// row's bytes, its base addresses and its strides in bytes; 0 where none
// does. The gather, the attention and the head move their rows in it.
inline int copy_unit(unsigned long long a) {
  for (int u = 16; u >= 2; u >>= 1) {
    if (a % u == 0) return u;
  }
  return 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// c += a . b on the tensor cores (bf16 products, f32 sums).
__device__ __forceinline__ void bf16_16x8x16(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (two) 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i (16-byte aligned rows), and each lane receives row g, columns
// 2q, 2q+1 of each matrix (of its transpose with `_trans`).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `bytes` (16, 8 or 4) from global to shared memory, reading `src_bytes`
// of them (0 or all) and zero-filling the rest: a piece past the end of a
// tensor is copied from a valid address with src_bytes = 0.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `kPending` of the committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace mma
