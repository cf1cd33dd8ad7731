// What the bf16 recurrences of gru.cu and lstm.cu share (sm_90a): the input
// projection GEMM that takes x @ W_x off their serial chain, and the fast
// gate nonlinearities.
//
// The input projection, xp [M, N] f32 = x [M, D] @ w_x [D, N] + b, all bf16
// in: it does not depend on h, so one tensor-core GEMM over all B*T rows
// computes it before the scan, which then loads each lane's values a step
// ahead. 64 x 64 output tiles, four warps of 16 rows, mma.sync.m16n8k16
// from ldmatrix fragments of x and (transposed) W_x, staged by cp.async in
// 8-byte pieces with zero-fill past D and N (D = 100 in bf16 is a 200-byte,
// 8-byte-aligned row). N is 3H (GRU) or 4H (LSTM).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

// An unnamed namespace inside: each library that includes this header
// keeps its own copy of the kernel, and exports none of it.
namespace rnn {
namespace {

constexpr int kProjTile = 64;           // rows and columns of an xp tile, and its k chunk
constexpr int kProjLd = kProjTile + 8;  // bf16 elements a shared row
constexpr int kProjThreads = 128;       // 4 warps x 16 rows

// xp [M, N] f32 = x [M, D] @ w_x [D, N] + b; D % 4 == 0 and N % 4 == 0, so
// 8-byte pieces are whole in or whole out of range.
__global__ void __launch_bounds__(kProjThreads)
xproj_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_x,
             const float* __restrict__ b, float* __restrict__ xp, int M, int D, int N) {
  __shared__ __align__(16) __nv_bfloat16 xs[kProjTile * kProjLd];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 ws[kProjTile * kProjLd];  // [k][col]
  const int r0 = blockIdx.x * kProjTile, c0 = blockIdx.y * kProjTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kProjTile) {
    for (int c = threadIdx.x; c < kProjTile * 16; c += kProjThreads) {
      const int r = c >> 4, j = (c & 15) * 4;
      const bool xin = r0 + r < M && k0 + j < D;
      mma::cp_async8_zfill(xs + r * kProjLd + j,
                           xin ? x + static_cast<size_t>(r0 + r) * D + k0 + j : x, xin ? 8 : 0);
      const bool win = k0 + r < D && c0 + j < N;
      mma::cp_async8_zfill(ws + r * kProjLd + j,
                           win ? w_x + static_cast<size_t>(k0 + r) * N + c0 + j : w_x,
                           win ? 8 : 0);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kProjTile / 16; ++st) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, xs + (warp * 16 + (lane & 15)) * kProjLd + st * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, ws + (st * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kProjLd +
                                       np * 16 + (lane >> 4) * 8);
        mma::bf16_16x8x16(acc[2 * np], a, bf[0], bf[1]);
        mma::bf16_16x8x16(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the tiles are refilled next chunk
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * tq;
    if (col >= N) continue;
    const float b0 = b[col], b1 = b[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + warp * 16 + gr + 8 * h;
      if (row < M) {
        *reinterpret_cast<float2*>(xp + static_cast<size_t>(row) * N + col) =
            make_float2(acc[j][2 * h] + b0, acc[j][2 * h + 1] + b1);
      }
    }
  }
}

// Launch the projection on `s`; a CUDA error code (0: launched).
int launch_xproj(const void* x, const void* w_x, const void* b, void* xp, int M, int D,
                 int N, cudaStream_t s) {
  if (M <= 0 || D <= 0 || N <= 0 || D % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((M + kProjTile - 1) / kProjTile, (N + kProjTile - 1) / kProjTile);
  xproj_kernel<<<grid, kProjThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_x),
      static_cast<const float*>(b), static_cast<float*>(xp), M, D, N);
  return static_cast<int>(cudaGetLastError());
}

// The gate nonlinearities in f32 from the hardware exp2 and a fast divide
// (a few ulp; h is rounded to bf16 after them).
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float fast_tanh(float v) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));
}

}  // namespace
}  // namespace rnn
