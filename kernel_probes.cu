// The CUDA side of `kernel_probes.py xproj` and `kernel_probes.py head`
// (built by it with nvcc, never by the package): variants of the f32 input
// projection (csrc/rnn.cuh xproj_f32_kernel: tile rows, k chunk, ring
// stages, CTAs a SM), the card's f32 FMA rate on independent register
// chains, and an 8 x 8 outer-product projection loop (128 x 128 tiles, x
// transposed in shared memory, 3 stages, 2 CTAs a SM) whose refills,
// shared-memory reads in the loop and stores can each be switched off, to
// see what its time is made of; variants of the f32 sampled-softmax head
// (csrc/softmax_head.cu head_f32_kernel: rows a block, k chunk, ring
// stages, CTAs a SM).
#include "seqrec_tpu_torch/csrc/rnn.cuh"
#include "seqrec_tpu_torch/csrc/softmax_head.cu"

namespace {

// The 8 x 8 loop with switches: kCopy (refill the ring), kLds (read the
// operands of each k from shared memory) and kStore (write xp).
template <int kStagesT, int kMinCtas, bool kCopy = true, bool kLds = true, bool kStore = true>
__global__ void __launch_bounds__(256, kMinCtas)
xproj_t_kernel(const float* __restrict__ x, const float* __restrict__ w_x,
               const float* __restrict__ b, float* __restrict__ xp, int M, int D, int N) {
  constexpr int BM = 128, BN = 128, KC = 32, LDT = BM + 4;
  constexpr int SF = KC * LDT + KC * BN;
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tm = (warp >> 1) * 4 + (lane >> 3), tn = (warp & 1) * 8 + (lane & 7);
  const int n_tiles = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * n_tiles;
  const int chunks = (D + KC - 1) / KC, G = gridDim.x;
  const int iters = (tiles - static_cast<int>(blockIdx.x) + G - 1) / G * chunks;
  auto stage = [&](int i) {
    if (i < iters && (kCopy || i < kStagesT - 1)) {
      const int tile = blockIdx.x + (i / chunks) * G, k0 = (i % chunks) * KC;
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
      float* xs = fsm + (i % kStagesT) * SF;
      float* ws = xs + KC * LDT;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int g = q * 8 + warp;  // 4 rows x 8 k a warp
        const int m = (g & 31) * 4 + (lane & 3), k = (g >> 5) * 8 + (lane >> 2);
        const bool in = m0 + m < M && k0 + k < D;
        mma::cp_async4_zfill(xs + k * LDT + m, in ? x + static_cast<size_t>(m0 + m) * D + k0 + k : x,
                             in ? 4 : 0);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = tid + q * 256;
        const int kr = c >> 5, n = (c & 31) * 4;
        const bool in = k0 + kr < D && n0 + n < N;
        mma::cp_async16_zfill(ws + kr * BN + n, in ? w_x + static_cast<size_t>(k0 + kr) * N + n0 + n : w_x,
                              in ? 16 : 0);
      }
    }
    mma::cp_async_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kStagesT - 1; ++i) stage(i);
  for (int i = 0; i < iters; ++i) {
    mma::cp_async_wait<kStagesT - 2>();
    __syncthreads();
    stage(i + kStagesT - 1);
    const float* xs = fsm + (i % kStagesT) * SF;
    const float* ws = xs + KC * LDT;
    float4 h0 = *reinterpret_cast<const float4*>(xs + 4 * tm);
    float4 h1 = *reinterpret_cast<const float4*>(xs + 64 + 4 * tm);
    float4 g0 = *reinterpret_cast<const float4*>(ws + 4 * tn);
    float4 g1 = *reinterpret_cast<const float4*>(ws + 64 + 4 * tn);
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 a0 = kLds ? *reinterpret_cast<const float4*>(xs + k * LDT + 4 * tm) : h0;
      const float4 a1 = kLds ? *reinterpret_cast<const float4*>(xs + k * LDT + 64 + 4 * tm) : h1;
      const float4 b0 = kLds ? *reinterpret_cast<const float4*>(ws + k * BN + 4 * tn) : g0;
      const float4 b1 = kLds ? *reinterpret_cast<const float4*>(ws + k * BN + 64 + 4 * tn) : g1;
      if (!kLds) { h0.x += 1e-7f; g1.w += 1e-7f; }
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], bb[j], acc[r][j]);
    }
    if (i % chunks == chunks - 1) {
      const int tile = blockIdx.x + (i / chunks) * G;
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 64 * h + 4 * tn;
        if (col < N) {
          const float4 bias = *reinterpret_cast<const float4*>(b + col);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int row = m0 + (r < 4 ? 4 * tm + r : 64 + 4 * tm + r - 4);
            if (row < M && (kStore || acc[r][0] == 1.2345f))
              *reinterpret_cast<float4*>(xp + static_cast<size_t>(row) * N + col) =
                  make_float4(acc[r][4 * h] + bias.x, acc[r][4 * h + 1] + bias.y,
                              acc[r][4 * h + 2] + bias.z, acc[r][4 * h + 3] + bias.w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
    }
  }
  mma::cp_async_wait<0>();
}

__global__ void ffma_bench(float* out, int iters) {
  float a = threadIdx.x * 1e-3f, b = 0.999f;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(acc[j], b, a);
  }
  float s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += acc[j];
  if (s == 1.2345f) out[0] = s;
}


template <bool CP, bool LD, bool STO>
int launch_t(const void* x, const void* w, const void* b, void* xp, int M, int D, int N,
             cudaStream_t s) {
  constexpr int smem = 3 * (32 * 132 + 32 * 128) * 4;
  auto k = xproj_t_kernel<3, 2, CP, LD, STO>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = static_cast<long long>((M + 127) / 128) * ((N + 127) / 128);
  const int grid = static_cast<int>(tiles < 2 * sms ? tiles : 2 * sms);
  k<<<grid, 256, smem, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                            static_cast<const float*>(b), static_cast<float*>(xp), M, D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PROJ(name, call)                                                                 \
  int name(const void* x, const void* w, const void* b, void* xp, int M, int D, int N,   \
           void* s) {                                                                    \
    return call(x, w, b, xp, M, D, N, static_cast<cudaStream_t>(s));                     \
  }

extern "C" {
PROJ(m128_k32_s3_c2, (rnn::launch_xproj_f32_variant<128, 32, 3, 2>))
PROJ(m64_k32_s2_c4, (rnn::launch_xproj_f32_variant<64, 32, 2, 4>))
PROJ(m64_k32_s3_c3, (rnn::launch_xproj_f32_variant<64, 32, 3, 3>))
PROJ(m64_k16_s3_c4, (rnn::launch_xproj_f32_variant<64, 16, 3, 4>))
PROJ(m64_k16_s4_c4, (rnn::launch_xproj_f32_variant<64, 16, 4, 4>))
PROJ(loop_no_refill, (launch_t<false, true, true>))
PROJ(loop_no_smem_reads, (launch_t<false, false, true>))
PROJ(loop_no_stores, (launch_t<false, true, false>))
PROJ(loop_bare, (launch_t<false, false, false>))
PROJ(loop_full, (launch_t<true, true, true>))

#define HEAD(name, call)                                                                  \
  int name(const void* h, const void* pos, const void* neg, const void* t, const void* ni, \
           const void* plq, const void* nlq, void* nll, int N, int S, int H, void* s) {    \
    return call(h, pos, neg, t, ni, plq, nlq, nll, N, S, H, static_cast<cudaStream_t>(s));  \
  }
HEAD(head_m64_k32_s2_c3, (launch_head_f32_variant<64, 32, 2, 3>))
HEAD(head_m64_k16_s2_c4, (launch_head_f32_variant<64, 16, 2, 4>))
HEAD(head_m64_k32_s3_c2, (launch_head_f32_variant<64, 32, 3, 2>))
HEAD(head_m64_k32_s2_c4, (launch_head_f32_variant<64, 32, 2, 4>))
HEAD(head_m128_k32_s2_c2, (launch_head_f32_variant<128, 32, 2, 2>))
HEAD(head_m128_k16_s2_c2, (launch_head_f32_variant<128, 16, 2, 2>))

int ffma_rate(float* out, int iters, int blocks) {
  ffma_bench<<<blocks, 256>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
}
