// The f32 SIMT GEMM main loop of the f32 sampled-softmax head
// (softmax_head.cu head_f32_kernel) and of rnn.cuh's xproj_f32_kernel: the
// f32 projection below kXpF32FmaDepth and the f32 step GEMM up to
// kStepSimtRows rows (sm_90a). f32 products on the CUDA cores, no TF32.
// (The f32 projections from kXpF32FmaDepth and the larger step GEMMs run
// fma_gemm.cuh.)
//
// A kTileM x 128 output tile on kTileM * 2 threads of 8 x 8 outputs each:
// thread (tm, tn) owns rows 4 tm .. +3 and kTileM / 2 + 4 tm .. +3 and
// columns 4 tn .. +3 and 64 + 4 tn .. +3; a warp's lanes are 4 (tm) by 8
// (tn). Both operands sit in shared memory k-major (A as aT [k][m], B as
// [k][n]), so per k a thread reads 2 float4 of A and 2 of B for 64 FMAs (4
// a float read): a warp's A read is 4 distinct float4 (broadcast) and its B
// read 8 consecutive float4, no bank conflicts. The caller owns the ring
// of k chunks, its barriers and the epilogue; this header gives the
// thread's place, the transposing copy and the FMAs of one chunk.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace simt {
namespace {

constexpr int kTileN = 128;  // columns of a tile

struct Place {
  int tm, tn;
};

__device__ __forceinline__ Place place() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {(warp >> 1) * 4 + (lane >> 3), (warp & 1) * 8 + (lane & 7)};
}

// The tile row of the thread's output r (0..7) and the tile column of its
// output j (0..7).
template <int kTileM>
__device__ __forceinline__ int row_of(int r, int tm) {
  return r < 4 ? 4 * tm + r : kTileM / 2 + 4 * tm + r - 4;
}
__device__ __forceinline__ int col_of(int j, int tn) { return j < 4 ? 4 * tn + j : 60 + 4 * tn + j; }

// Rows [r0, r0 + kRows) x columns [k0, k0 + kTileK) of a row-major [R, K]
// f32 matrix, transposed into dst[k][r] (row stride ld floats), by NT
// threads: one 4-byte cp.async an element, a warp's 32 copies 4 rows by 8
// k (each row's 8 k one 32-byte sector; into 32 distinct banks when
// ld % 32 == 4); zero past R and K. Commits nothing.
template <int kRows, int kTileK, int NT>
__device__ __forceinline__ void copy_transposed(float* dst, int ld, const float* src, int R,
                                                int K, int r0, int k0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kRows * kTileK / NT; ++q) {
    const int g = q * (NT / 32) + warp;  // 4 rows x 8 k a warp
    const int m = g % (kRows / 4) * 4 + (lane & 3), k = g / (kRows / 4) * 8 + (lane >> 2);
    const bool in = r0 + m < R && k0 + k < K;
    mma::cp_async4_zfill(dst + k * ld + m,
                         in ? src + static_cast<size_t>(r0 + m) * K + k0 + k : src, in ? 4 : 0);
  }
}

// acc[r][j] += a[k][row_of(r)] * b[k][col_of(j)] for k = 0 .. kTileK - 1 in
// order: a is aT [kTileK][LDA], b is [kTileK][LDB], both in shared memory.
template <int kTileM, int kTileK, int LDA, int LDB>
__device__ __forceinline__ void fma_chunk(float (&acc)[8][8], const float* a, const float* b,
                                          Place p) {
#pragma unroll 4
  for (int k = 0; k < kTileK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * LDA + 4 * p.tm);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * LDA + kTileM / 2 + 4 * p.tm);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * LDB + 4 * p.tn);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * LDB + 64 + 4 * p.tn);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
}

}  // namespace
}  // namespace simt
