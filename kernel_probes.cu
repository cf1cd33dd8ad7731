// The CUDA side of `kernel_probes.py xproj` and `kernel_probes.py head`
// (built by it with nvcc, never by the package): variants of the f32 input
// projection (csrc/rnn.cuh xproj_f32_kernel: tile rows, k chunk, ring
// stages, CTAs a SM), the card's f32 FMA rate on independent register
// chains, and an 8 x 8 outer-product projection loop (128 x 128 tiles, x
// transposed in shared memory, 3 stages, 2 CTAs a SM) whose refills,
// shared-memory reads in the loop and stores can each be switched off, to
// see what its time is made of; variants of the f32 sampled-softmax head
// (csrc/softmax_head.cu head_f32_kernel: rows a block, k chunk, ring
// stages, CTAs a SM); and for `kernel_probes.py step_gemm`, variants of the
// stepped layouts' bf16 step GEMM (csrc/step_gemm.cuh's kernel: rows a
// block, ring stages, copy unit, TMA or cp.async, K splits); and for
// `kernel_probes.py xproj_bf16`, the bf16 input projection's (csrc/rnn.cuh:
// tile, stages, band, TMA or cp.async, 8-byte rows padded onto TMA, and its
// descriptor control).
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

// 8-byte rows by TMA: x zero-padded to [M, Dp] and W_x to [Dp, Np] (Dp and
// Np multiples of 8) by the caller, the kernel's TMA route on maps of the
// padded operands and the real M, D, N (its chunks, tiles, bias and output
// stride), planned as the padded shape; TMA's bounds and the pads' zeros
// fill past D and N. The plan used into plan[7], as xp_bf16.
template <int BM, int BN>
int xp_padded_launch(const rnn::XprojPlan& p, const void* x, const void* w, const void* b,
                     void* xp, int M, int D, int N, int Dp, int Np, cudaStream_t s) {
  rnn::StepGemmMaps maps{};
  int rc = rnn::sg_map(&maps.a, x, Dp, M, static_cast<uint64_t>(Dp) * 2, BM);
  if (rc == 0) rc = rnn::sg_map(&maps.w, w, Np, Dp, static_cast<uint64_t>(Np) * 2, rnn::kWgK);
  if (rc != 0) return rc;
  auto kernel = rnn::xproj_wgmma_kernel<BM, BN, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rnn::xp_max_stages(BM, BN) * rnn::xp_stage_bytes(BM, BN) + 1024);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<p.grid, rnn::kXpThreads, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<float*>(xp), M, D, N, p.stages, p.band, maps);
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

// The step GEMM's variants (csrc/step_gemm.cuh): the package's plan
// (step_gemm_plan) at `bm` rows a block and `splits` K splits (0: the
// plan's rule at that bm), with the variant's shared memory; the splits
// used into *used.
rnn::StepGemmPlan sg_plan(int bm, int terms, int M, int K, int N, int splits, int smem,
                          int* used) {
  rnn::StepGemmPlan p;
  if (rnn::step_gemm_plan(M, K, N, terms, &p, bm, splits) != 0) return p;
  p.smem = smem;
  *used = p.splits;
  return p;
}

// A variant of the package's wgmma kernel, by TMA (`tma`) or cp.async.
int sg_run_wg(void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, float*, int, int, int,
                             int, int, rnn::StepGemmMaps),
              int smem, int bm, bool tma, int terms, const void* a, const void* w, void* out,
              int M, int K, int N, int splits, int* used, cudaStream_t s) {
  rnn::StepGemmPlan p = sg_plan(bm, terms, M, K, N, splits, smem, used);
  if (p.unit == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.tma = tma;
  rnn::StepGemmMaps maps;
  int rc = rnn::step_gemm_maps(p, a, w, M, K, N, terms, &maps);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<p.grid_tiles * p.splits, rnn::kSgThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), M, K, N, p.per, p.grid_tiles, maps);
  return static_cast<int>(cudaGetLastError());
}

#define SG_SW(name, BM, T, U, ST, TMA)                                                        \
  int name(const void* a, const void* w, void* out, int M, int K, int N, int splits,        \
           int* used, void* s) {                                                             \
    return sg_run_wg(rnn::step_gemm_wgmma_kernel<BM, T, U, TMA, ST>, rnn::wg_smem(BM, T, ST), \
                     BM, TMA, T, a, w, out, M, K, N, splits, used,                          \
                     static_cast<cudaStream_t>(s));                                          \
  }
SG_SW(sg_rev_sw_m128_s3_u16, 128, 2, 16, 3, false)
SG_SW(sg_rev_sw_m128_s3_u8, 128, 2, 8, 3, false)
SG_SW(sg_rev_sw_m128_s4_u16, 128, 2, 16, 4, false)
SG_SW(sg_rev_sw_m128_s4_u8, 128, 2, 8, 4, false)
SG_SW(sg_rev_sw_m256_s2_u16, 256, 2, 16, 2, false)
SG_SW(sg_fwd_sw_m128_s3_u16, 128, 1, 16, 3, false)
SG_SW(sg_fwd_sw_m128_s3_u8, 128, 1, 8, 3, false)
SG_SW(sg_fwd_sw_m128_s4_u16, 128, 1, 16, 4, false)
SG_SW(sg_fwd_sw_m256_s3_u16, 256, 1, 16, 3, false)
SG_SW(sg_fwd_sw_m256_s3_u8, 256, 1, 8, 3, false)
SG_SW(sg_fwd_sw_m256_s4_u16, 256, 1, 16, 4, false)
SG_SW(sg_fwd_sw_m128_s4_u8, 128, 1, 8, 4, false)
SG_SW(sg_fwd_sw_m256_s4_u8, 256, 1, 8, 4, false)
SG_SW(sg_rev_tma_m128_s3_u16, 128, 2, 16, 3, true)
SG_SW(sg_rev_tma_m128_s4_u16, 128, 2, 16, 4, true)
SG_SW(sg_fwd_tma_m128_s3_u16, 128, 1, 16, 3, true)
SG_SW(sg_fwd_tma_m256_s3_u16, 256, 1, 16, 3, true)
SG_SW(sg_fwd_tma_m256_s4_u16, 256, 1, 16, 4, true)

// The bf16 input projection's variants (csrc/rnn.cuh xproj_wgmma_kernel):
// the package's plan (xproj_plan) with `tile_m`, `tile_n` and `stages`
// replaced (0: the rule's; the rest completed by xp_complete), `band`
// replaced (0: the plan's), and the route forced (`tma` 1: TMA, refused
// where a row stride is no 16-byte multiple; 0: cp.async); `swap` 1: the
// control, the W_x descriptor's two byte offsets exchanged, which must fail
// its check. The plan used into plan[7]: tile_m, tile_n, stages, tma,
// grid, band, smem.
int xp_bf16(const void* x, const void* w, const void* b, void* xp, int M, int D, int N,
            int tile_m, int tile_n, int stages, int band, int tma, int swap, int* plan,
            void* stream) {
  rnn::XprojPlan p;
  int rc = rnn::xproj_plan(M, D, N, &p);
  if (rc != 0) return rc;
  if (tile_m > 0 || tile_n > 0 || stages > 0) {
    if (tile_m > 0) p.tile_m = tile_m;
    if (tile_n > 0) p.tile_n = tile_n;
    if (stages > 0) p.stages = stages;
    rc = rnn::xp_complete(M, D, N, rnn::sg_sms(), &p);
    if (rc != 0) return rc;
  }
  if (band > 0) {
    if (band > (N + p.tile_n - 1) / p.tile_n) return static_cast<int>(cudaErrorInvalidValue);
    p.band = band;
  }
  if (tma && !p.tma) return static_cast<int>(cudaErrorInvalidValue);
  p.tma = tma != 0;
  const int out[7] = {p.tile_m, p.tile_n, p.stages, static_cast<int>(p.tma), p.grid, p.band,
                      p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XP_VARIANT(BM, BN, TMA, SWAP)                                                     \
  if (p.tile_m == BM && p.tile_n == BN && p.tma == TMA && (swap != 0) == SWAP)            \
    return rnn::launch_xproj_variant<BM, BN, TMA, SWAP>(p, x, w, b, xp, M, D, N, s);
  XP_VARIANT(128, 256, true, false) XP_VARIANT(128, 256, false, false)
  XP_VARIANT(256, 128, true, false) XP_VARIANT(256, 128, false, false)
  XP_VARIANT(128, 128, true, false) XP_VARIANT(128, 128, false, false)
  XP_VARIANT(128, 64, true, false) XP_VARIANT(128, 64, false, false)
  XP_VARIANT(128, 256, true, true) XP_VARIANT(256, 128, true, true)
  XP_VARIANT(128, 64, true, true)
#undef XP_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

int xp_bf16_padded(const void* x, const void* w, const void* b, void* xp, int M, int D, int N,
                   int Dp, int Np, int* plan, void* stream) {
  rnn::XprojPlan p;
  if (Dp < D || Np < N || Dp % 8 != 0 || Np % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = rnn::xproj_plan(M, Dp, Np, &p);
  if (rc != 0) return rc;
  const int out[7] = {p.tile_m, p.tile_n, p.stages, static_cast<int>(p.tma), p.grid, p.band,
                      p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.tile_m == 256) return xp_padded_launch<256, 128>(p, x, w, b, xp, M, D, N, Dp, Np, s);
  if (p.tile_n == 64) return xp_padded_launch<128, 64>(p, x, w, b, xp, M, D, N, Dp, Np, s);
  return p.tile_n == 256 ? xp_padded_launch<128, 256>(p, x, w, b, xp, M, D, N, Dp, Np, s)
                         : xp_padded_launch<128, 128>(p, x, w, b, xp, M, D, N, Dp, Np, s);
}

int ffma_rate(float* out, int iters, int blocks) {
  ffma_bench<<<blocks, 256>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
}
