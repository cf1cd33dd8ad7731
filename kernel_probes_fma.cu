// The CUDA side of `kernel_probes.py fma` and of the card tests' TMA control
// (built by kernel_probes.probe_build with nvcc, never by the package): the
// f32 FMA GEMM of csrc/fma_gemm.cuh at a probe's own plan, whose K splits
// are forced (0: fma_plan's); the same kernel with its A box asked at its
// two coordinates exchanged, a control that must give wrong sums; and the
// projection's contract written plainly (fma_reference: each output its
// products summed by FMA in k order from 0, then b added), which the
// package's kernel must equal bit for bit.
#include "seqrec_tpu_torch/csrc/fma_gemm.cuh"

namespace {

// One thread an output of out [M, N] = a [M, K] @ w [K, N] + b.
__global__ void fma_reference_kernel(const float* __restrict__ a, const float* __restrict__ w,
                                     const float* __restrict__ b, float* __restrict__ out, int M,
                                     int K, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x, m = blockIdx.y;
  if (n >= N) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = fmaf(a[static_cast<size_t>(m) * K + k], w[static_cast<size_t>(k) * N + n], acc);
  }
  out[static_cast<size_t>(m) * N + n] = __fadd_rn(acc, b[n]);
}

// The probe's plan: fma_plan's, its K splits replaced where given (0: the
// rule's), computed as fma_plan computes its own. `warps` is the kernel's
// (0 or 8: its consumer warps).
int probe_plan(int M, int K, int N, bool split, int warps, int splits, rnn::FmaPlan* p) {
  if ((warps != 0 && warps != rnn::kFmWarps) || splits < 0 || (!split && splits > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = rnn::fma_plan(M, K, N, split, p);
  if (rc != 0 || splits == 0) return rc;
  const int sms = rnn::sg_sms();
  const int chunks = (K + rnn::kFmK - 1) / rnn::kFmK;
  const int n_tiles = (N + rnn::kFmTileN - 1) / rnn::kFmTileN;
  p->per = (chunks + splits - 1) / splits;
  p->splits = (chunks + p->per - 1) / p->per;
  const long long items =
      static_cast<long long>((M + rnn::kFmRows - 1) / rnn::kFmRows) * n_tiles * p->splits;
  p->grid = static_cast<int>(items < sms ? items : sms);
  p->ws_bytes = split ? static_cast<size_t>(p->splits) * M * N * 4 : 0;
  return 0;
}

// out = a [M, K] @ w [K, N] (+ b where `split` is 0 and b is given) on the
// probe's plan with `splits`; the plan used into plan[4]: consumer warps,
// splits, grid, smem. kSwap: the control (A's box coordinates exchanged).
template <bool kSwap>
int run(const void* a, const void* w, const void* b, void* out, int M, int K, int N, int split,
        int warps, int splits, int* plan, cudaStream_t s) {
  rnn::FmaPlan p;
  int rc = probe_plan(M, K, N, split != 0, warps, splits, &p);
  if (rc != 0) return rc;
  const int used[4] = {rnn::kFmWarps, p.splits, p.grid, p.smem};
  for (int i = 0; i < 4; ++i) plan[i] = used[i];
  rnn::FmaMaps maps;
  rc = rnn::fma_maps(p, a, w, M, K, N, &maps);
  if (rc != 0) return rc;
  const void* bias = split ? nullptr : b;
  return kSwap ? rnn::launch_fma_variant<true>(p, maps, bias, out, M, K, N, s)
               : rnn::launch_fma_gemm(p, maps, bias, out, M, K, N, s);
}

// The GEMM's consumer loop alone (8 warps, one CTA a SM, 8 x 16 outputs a
// thread, fm_group's reads and FMAs), on one chunk held in shared memory
// `chunks` times over: no TMA, no barriers, no stores; kA / kB: read A / B
// from shared memory every group (else the registers of the first read).
// `zero` (0 at run time) moves the reads with the chunk, so that the
// compiler cannot hoist them out of the loop.
template <bool kA, bool kB>
__global__ void __launch_bounds__(256, 1) fma_loop_kernel(float* out, int chunks, int zero) {
  constexpr int AF = 256 * rnn::kFmBoxK;  // A's floats
  extern __shared__ __align__(16) float lsm[];
  for (int i = threadIdx.x; i < AF + rnn::kFmK * rnn::kFmTileN; i += blockDim.x) {
    lsm[i] = 1e-3f * (i % 97);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* as = lsm + (warp * 32 + (lane >> 3)) * rnn::kFmBoxK;
  const float* bs = lsm + AF + 4 * (lane & 7);
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
  float4 ak[8], bk[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) ak[i] = *reinterpret_cast<const float4*>(as + i * 4 * rnn::kFmBoxK);
#pragma unroll
  for (int c = 0; c < 4; ++c) bk[c] = *reinterpret_cast<const float4*>(bs + 32 * c);
  for (int c = 0; c < chunks; ++c) {
    const float* ac = as + zero * c;
    const float* bc = bs + zero * c;
#pragma unroll
    for (int g = 0; g < rnn::kFmK / 4; ++g) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = kA ? *reinterpret_cast<const float4*>(ac + i * 4 * rnn::kFmBoxK + 4 * g) : ak[i];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bv[q] = kB ? *reinterpret_cast<const float4*>(bc + (4 * g + kk) * rnn::kFmTileN + 32 * q)
                     : bk[q];
        }
        const float b16[16] = {bv[0].x, bv[0].y, bv[0].z, bv[0].w, bv[1].x, bv[1].y, bv[1].z,
                               bv[1].w, bv[2].x, bv[2].y, bv[2].z, bv[2].w, bv[3].x, bv[3].y,
                               bv[3].z, bv[3].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(ai, b16[j], acc[i][j]);
        }
      }
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) sum += acc[i][j];
  if (sum == 1.2345f) out[0] = sum;
}

// The same loop with its reads one step ahead of their FMAs: B's four
// reads of k + 1 before the FMAs of k, A's eight of the next group before
// the FMAs of the group's last k (software pipelining by hand).
__global__ void __launch_bounds__(256, 1) fma_loop_ahead_kernel(float* out, int chunks, int zero) {
  constexpr int AF = 256 * rnn::kFmBoxK;
  extern __shared__ __align__(16) float lsm[];
  for (int i = threadIdx.x; i < AF + rnn::kFmK * rnn::kFmTileN; i += blockDim.x) {
    lsm[i] = 1e-3f * (i % 97);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* as = lsm + (warp * 32 + (lane >> 3)) * rnn::kFmBoxK;
  const float* bs = lsm + AF + 4 * (lane & 7);
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
  float4 av[8], bv[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(as + i * 4 * rnn::kFmBoxK);
#pragma unroll
  for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(bs + 32 * q);
  for (int c = 0; c < chunks; ++c) {
    const float* ac = as + zero * c;
    const float* bc = bs + zero * c;
#pragma unroll
    for (int s = 0; s < rnn::kFmK; ++s) {  // k step s: group s / 4, kk s % 4
      const int kk = s & 3, nxt = (s + 1) & (rnn::kFmK - 1);
      float4 bn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bn[q] = *reinterpret_cast<const float4*>(bc + nxt * rnn::kFmTileN + 32 * q);
      }
      float4 an[8];
      if (kk == 3) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          an[i] = *reinterpret_cast<const float4*>(ac + i * 4 * rnn::kFmBoxK + 4 * (nxt >> 2));
        }
      }
      const float b16[16] = {bv[0].x, bv[0].y, bv[0].z, bv[0].w, bv[1].x, bv[1].y, bv[1].z,
                             bv[1].w, bv[2].x, bv[2].y, bv[2].z, bv[2].w, bv[3].x, bv[3].y,
                             bv[3].z, bv[3].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(ai, b16[j], acc[i][j]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bn[q];
      if (kk == 3) {
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = an[i];
      }
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) sum += acc[i][j];
  if (sum == 1.2345f) out[0] = sum;
}

template <bool kA, bool kB>
int launch_loop(void* out, int chunks, int blocks, cudaStream_t s) {
  constexpr int smem = (256 * rnn::kFmBoxK + rnn::kFmK * rnn::kFmTileN) * 4;
  auto k = fma_loop_kernel<kA, kB>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<blocks, 256, smem, s>>>(static_cast<float*>(out), chunks, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
// The consumer loop alone (fma_loop_kernel) on `blocks` CTAs: mode 0 reads
// A and B every group, 1 only B, 2 only A, 3 neither; 4 both, a step ahead
// (fma_loop_ahead_kernel).
int fma_loop(void* out, int chunks, int blocks, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 4) {
    constexpr int smem = (256 * rnn::kFmBoxK + rnn::kFmK * rnn::kFmTileN) * 4;
    cudaError_t e = cudaFuncSetAttribute(fma_loop_ahead_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fma_loop_ahead_kernel<<<blocks, 256, smem, s>>>(static_cast<float*>(out), chunks, 0);
    return static_cast<int>(cudaGetLastError());
  }
  switch (mode) {
    case 0: return launch_loop<true, true>(out, chunks, blocks, s);
    case 1: return launch_loop<false, true>(out, chunks, blocks, s);
    case 2: return launch_loop<true, false>(out, chunks, blocks, s);
    default: return launch_loop<false, false>(out, chunks, blocks, s);
  }
}

int fma_variant(const void* a, const void* w, const void* b, void* out, int M, int K, int N,
                int split, int warps, int splits, int* plan, void* stream) {
  return run<false>(a, w, b, out, M, K, N, split, warps, splits, plan,
                    static_cast<cudaStream_t>(stream));
}

int fma_reference(const void* a, const void* w, const void* b, void* out, int M, int K, int N,
                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * 64) return static_cast<int>(cudaErrorInvalidValue);
  fma_reference_kernel<<<dim3((N + 127) / 128, M), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

int fma_control(const void* a, const void* w, const void* b, void* out, int M, int K, int N,
                int split, int warps, int splits, int* plan, void* stream) {
  return run<true>(a, w, b, out, M, K, N, split, warps, splits, plan,
                   static_cast<cudaStream_t>(stream));
}
}
