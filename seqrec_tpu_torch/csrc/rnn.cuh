// What the bf16 recurrences of gru.cu and lstm.cu share (sm_90a): the input
// projection GEMM that takes x @ W_x off their serial chain, the fast gate
// nonlinearities, and the block layout of the tensor-core recurrences (8
// batch rows a block, a lane's (unit, row) positions, packed A fragments,
// and the per-step staging of [B, T, H] planes).
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

constexpr int kRows = 8;    // batch rows a recurrence block: mma's N, one n8 tile
constexpr int kStages = 3;  // ring stages of the per-step operands in shared memory

// Packed A fragments: the wrappers lay W_h out as mma.sync.m16n8k16 A
// fragments, [warp][k16 step][...][32 lanes][8 bf16] (ops/cuda/lstm.py
// forward_fragments and backward_fragments, ops/cuda/gru.py
// backward_fragments), zero past the real rows and columns, so a lane loads
// its four fragment registers of one tile in one 16-byte read and a warp
// reads 512 consecutive bytes.
__device__ __forceinline__ void load_frag(uint32_t a[4], const uint4* p) {
  const uint4 v = *p;
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// A lane's C positions, the same in every m16 tile of its warp: units
// u + gr + 8 m (m = 0, 1) of rows 2 tq + e (e = 0, 1); p = 2 m + e is the C
// register.
struct Positions {
  bool unit_ok[2], row_ok[2];
  size_t row_base[2];  // b * T of the lane's rows
  int u, gr, tq;
  __device__ Positions(int B, int Tn, int H) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    gr = lane >> 2;
    tq = lane & 3;
    u = 16 * warp;
#pragma unroll
    for (int m = 0; m < 2; ++m) unit_ok[m] = u + gr + 8 * m < H;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = blockIdx.x * kRows + 2 * tq + e;
      row_ok[e] = b < B;
      row_base[e] = static_cast<size_t>(b) * Tn;
    }
  }
  __device__ int unit(int m) const { return u + gr + 8 * m; }
  __device__ bool ok(int m, int e) const { return unit_ok[m] && row_ok[e]; }
  // Offset of (row e, unit m) in a [B, T, W] plane at step t.
  __device__ size_t at(int m, int e, int t, int W) const {
    return (row_base[e] + t) * W + unit(m);
  }
};

// This thread's piece of four consecutive values of an 8-row block of
// [B, T, W] rows: row r, columns 4k .. 4k+3 of the first H (H / 4 pieces a
// row; 8 H / 4 <= 2 Hp, the block's threads, so one piece a thread at most).
struct RowPiece {
  bool has;
  int r, k;
  size_t base;  // b * T of the row
  __device__ RowPiece(int B, int Tn, int H) {
    const int per_row = H / 4;
    const int rows = min(kRows, B - static_cast<int>(blockIdx.x) * kRows);
    has = static_cast<int>(threadIdx.x) < rows * per_row;
    r = threadIdx.x / per_row;
    k = threadIdx.x % per_row;
    base = (static_cast<size_t>(blockIdx.x) * kRows + r) * Tn;
  }
  // Offset of the piece at step t in a [B, T, W] plane (W = H, or a gate
  // count times H with the gate's column added by the caller).
  __device__ size_t src(int t, int W) const { return (base + t) * W + 4 * k; }
};

__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int c = threadIdx.x; c < bytes / 16; c += blockDim.x) {
    reinterpret_cast<uint4*>(p)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace
}  // namespace rnn
