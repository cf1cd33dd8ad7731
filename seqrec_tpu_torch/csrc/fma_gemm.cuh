// The f32 FMA GEMM of the GRU and LSTM scans (sm_90a), for both of its roles:
//
//   the input projection xp [M, N] = x [M, K] @ W_x [K, N] + b of every f32
//   forward from K = D = 256 (rnn.cuh launch_xproj_f32; no K split), and
//   the f32 stepped layouts' step GEMM (rnn.cuh step_gemm) above
//   kStepSimtRows rows: h @ W_h forward, d @ W_h^T reverse, K split into
//   f32 partial planes [splits][M][N] that the gate kernel sums in split
//   order (rnn::step_product; no bias here). Up to them rnn.cuh's SIMT
//   kernel writes the same planes at the same split (fm_splits).
//
// It replaces no TPU kernel alone: it is the jnp.dot(x, w_x) + b_x and
// jnp.dot(h_in, w_h) of seqrec_tpu/ops/pallas/gru.py:110-117 and lstm.py:89-93
// (f32 sums), taken out of the step body. f32 products on the CUDA cores,
// no TF32: what bounds it is its 2 M K N operations at 67 TFLOP/s (w3's
// projection, M = 51,200, K = 2,304, N = 6,912: 24.3 ms; a step at M = 256:
// 0.122 ms).
//
// Why the design (kernel_probes.py xproj, "ceiling", on an H100): the SM
// clock holds its 1,980 MHz under an FFMA load, register chains reach 98%
// of the FMA peak, and an 8 x 8 outer-product loop with no copies, reads or
// stores 77% at the wide shape (95.5% of its loop's instructions FFMAs);
// with its 4-byte transposing cp.asyncs, shared-memory reads and stores it
// falls to 55%. So the FMA warps must spend their issue slots on FFMAs and
// read fewer shared-memory bytes an FMA:
// - Copies off the FMA warps: a producer warpgroup of its own, whose
//   thread 0 asks the tensor memory accelerator (TMA) for each chunk's two
//   boxes (two instructions a chunk) into a ring of kFmStages stages,
//   counted on the stage's full mbarrier, once every consumer warp gave the
//   stage back on its empty mbarrier (one arrival a warp); the consumer
//   warps wait only on the full barriers. setmaxnreg gives the producer's
//   registers to the consumers: 128 x 24 + 256 x 240 = 384 x 168, what the
//   launch holds (ptxas: 168 at launch, no spill). Every f32 row stride is
//   a 16-byte multiple (K % 4 == N % 4 == 0), so TMA always can; it
//   zero-fills past M, K and N. (kernel_probes.py fma on an H100: 1.14-1.23x
//   faster than thread 0 of the first consumer warp producing, which
//   waited on the empty barriers and so paced its warp by the slowest.)
// - x is read as stored, [m][k]: no transpose. A thread takes 8 rows x 16
//   columns (128 sums): rows warp * 32 + (lane / 8) + 4 i, columns
//   4 (lane % 8) + 32 c + 0..3; for each 4 k of a row one 16-byte read of A,
//   for each k four 16-byte reads of B: 24 shared-memory reads for 512
//   FFMAs (simt_gemm.cuh's 8 x 8 loop: 16 for 256). An A box row is
//   kFmBoxK = 36 values (144 bytes; the last 4 unused), so the four rows a
//   warp reads at one k fall in four distinct bank groups; B's 8 lanes read
//   128 contiguous bytes.
// - 8 consumer warps of 32 rows each, BM = 256, one CTA a SM: two FMA
//   warps a scheduler.
// - Persistent: CTA c takes items c, c + grid, ...; an item is a tile and a
//   K split; tiles go in bands of kFmRowGroup row blocks, every column block
//   of a band before the next, so a band's rows stay in L2.
// - The step GEMM's K split is planned from K, N and the SMs alone (never
//   M, so a row's bits do not depend on its batch): the fewest waves of
//   item-chunks, with each split's plane costed as traffic.
// On an H100 (kernel_probes.py fma) the loop alone, its reads from shared
// memory included, runs at 75% of the f32 peak (its FFMAs alone 78%:
// operand stalls), the whole kernel at 68-72%, cuBLAS's f32 GEMM at 74%.
// Each output (each plane's output) sums its products by FMA in k order
// from 0; the projection then adds b: the bits of rnn.cuh's SIMT
// projection, the function torch.matmul(x, w_x) + b computes in f32.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_gemm.cuh"

namespace rnn {
namespace {

constexpr int kFmTileN = 128;    // columns a tile
constexpr int kFmK = 32;         // k a chunk
constexpr int kFmBoxK = 36;      // k an A box row (144 bytes: see the file note)
constexpr int kFmMaxSplits = 16;
constexpr int kFmMinChunks = 8;  // chunks a split at least, where K has them
constexpr int kFmRowGroup = 8;   // row blocks a band of the tile order

constexpr int kFmWarps = 8;                   // consumer warps, 32 rows each
constexpr int kFmRows = 32 * kFmWarps;        // rows a tile
constexpr int kFmThreads = 128 + 32 * kFmWarps;  // the producer warpgroup, then the consumers
constexpr int kFmStages = 4;
constexpr int kFmProducerRegs = 24, kFmConsumerRegs = 240;  // setmaxnreg: 384 x 168 in all
constexpr int kFmStageBytes = kFmRows * kFmBoxK * 4 + kFmK * kFmTileN * 4;
constexpr int kFmSmem = kFmStages * kFmStageBytes + 1024;  // the ring and 1,024 to align it

struct FmaPlan {
  int splits = 1, per = 0, grid = 0, smem = 0;
  size_t ws_bytes = 0;  // the split step GEMM's partial planes (the projection: 0)
};

// The step GEMM's K splits for K x N on `sms` SMs (one CTA of 256 rows a
// SM): of 1 .. kFmMaxSplits, each split at least kFmMinChunks chunks deep
// where K has them, the one of least waves x chunks a split x 1,024 plus
// N / 8 a split (a plane written and read), the fewest on a tie.
inline int fm_splits(int K, int N, int sms) {
  const int chunks = (K + kFmK - 1) / kFmK, n_tiles = (N + kFmTileN - 1) / kFmTileN;
  const int floor_per = chunks < kFmMinChunks ? chunks : kFmMinChunks;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= kFmMaxSplits; ++s) {
    const int per = (chunks + s - 1) / s, used = (chunks + per - 1) / per;
    if (used != s || (s > 1 && per < floor_per)) continue;
    const long long waves = (static_cast<long long>(n_tiles) * s + sms - 1) / sms;
    const long long cost = waves * per * 1024 + static_cast<long long>(s) * N / 8;
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// The plan of out = a [M, K] @ w [K, N] (`split`: the step GEMM's partial
// planes; else the projection, one plane with b); a CUDA error code.
inline int fma_plan(int M, int K, int N, bool split, FmaPlan* p) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sg_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int chunks = (K + kFmK - 1) / kFmK, n_tiles = (N + kFmTileN - 1) / kFmTileN;
  FmaPlan q;
  const int s = split ? fm_splits(K, N, sms) : 1;
  q.per = (chunks + s - 1) / s;
  q.splits = (chunks + q.per - 1) / q.per;  // no split empty
  const long long items =
      static_cast<long long>((M + kFmRows - 1) / kFmRows) * n_tiles * q.splits;
  q.grid = static_cast<int>(items < sms ? items : sms);
  q.smem = kFmSmem;
  q.ws_bytes = split ? static_cast<size_t>(q.splits) * M * N * 4 : 0;
  *p = q;
  return 0;
}

// The kernel's tensor maps: A [M][K] in boxes of BM rows x kFmBoxK k, W
// [K][N] in boxes of kFmK k x kFmTileN n; f32, no swizzle, zero outside.
struct FmaMaps {
  CUtensorMap a, w;
};

inline int fm_map(CUtensorMap* m, const void* base, uint64_t inner, uint64_t outer,
                  uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled encode = sg_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 4};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The maps of a and w for the plan (once for the many steps of a scan that
// reuse the same buffers).
inline int fma_maps(const FmaPlan& p, const void* a, const void* w, int M, int K, int N,
                    FmaMaps* maps) {
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = fm_map(&maps->a, a, K, M, kFmBoxK, kFmRows);
  return rc != 0 ? rc : fm_map(&maps->w, w, N, K, kFmTileN, kFmK);
}

// One item of a CTA's walk: rows [m0, m0 + BM), columns [n0, n0 + 128),
// chunks [c0, c1) of K, written to plane `split`.
struct FmItem {
  int m0, n0, c0, c1, split;
};

__device__ __forceinline__ FmItem fm_item(long long it, int BM, int splits, int per, int chunks,
                                          int m_tiles, int n_tiles) {
  const int split = static_cast<int>(it % splits);
  const long long tile = it / splits, band = static_cast<long long>(kFmRowGroup) * n_tiles;
  const int first = static_cast<int>(tile / band) * kFmRowGroup;
  const int rows = min(m_tiles - first, kFmRowGroup), r = static_cast<int>(tile % band);
  const int c0 = split * per;
  return {(first + r % rows) * BM, r / rows * kFmTileN, c0, min(chunks, c0 + per), split};
}

// One group of 4 k (g within the chunk) into the thread's 8 x 16 sums: a
// its rows' A (row i at a + i 4 kFmBoxK), b its columns' B (column group c
// at b + 32 c, k rows kFmTileN apart).
__device__ __forceinline__ void fm_group(float (&acc)[8][16], const float* a, const float* b,
                                         int g) {
  float4 av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * 4 * kFmBoxK + 4 * g);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float4 bv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bv[c] = *reinterpret_cast<const float4*>(b + (4 * g + kk) * kFmTileN + 32 * c);
    }
    const float bs[16] = {bv[0].x, bv[0].y, bv[0].z, bv[0].w, bv[1].x, bv[1].y, bv[1].z, bv[1].w,
                          bv[2].x, bv[2].y, bv[2].z, bv[2].w, bv[3].x, bv[3].y, bv[3].z, bv[3].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(ai, bs[j], acc[i][j]);
    }
  }
}

// out (plane `split` of [splits][M][N], or [M, N] + b where b is given) =
// a @ w over the plan's items. Warpgroup 0 gives back its registers and its
// thread 0 asks for every chunk of the CTA's items in turn, each into the
// stage the consumers last gave back; warpgroups 1 and 2 take the
// registers and run the 8 consumer warps. kSwap (a control for the tests,
// never shipped): A's box asked at its two coordinates exchanged, which
// must give wrong sums.
template <bool kSwap = false>
__global__ void __launch_bounds__(kFmThreads, 1)
fma_gemm_kernel(const float* __restrict__ b, float* __restrict__ out, int M, int K, int N,
                int per, int splits, const __grid_constant__ FmaMaps maps) {
  constexpr int BM = kFmRows, ST = kFmStages, SB = kFmStageBytes;
  constexpr int AB = BM * kFmBoxK * 4;
  extern __shared__ __align__(16) unsigned char fm_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  // The ring, 1,024-byte aligned, addressed from the shared array itself so
  // that its reads stay shared-memory loads (LDS).
  unsigned char* ring = fm_raw + ((1024u - (mma::smem_addr(fm_raw) & 1023u)) & 1023u);
  const int chunks = (K + kFmK - 1) / kFmK, n_tiles = (N + kFmTileN - 1) / kFmTileN;
  const int m_tiles = (M + BM - 1) / BM;
  const long long items = static_cast<long long>(m_tiles) * n_tiles * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], kFmWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kFmProducerRegs));
    if (threadIdx.x == 0) {
      int seq = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const FmItem t = fm_item(it, BM, splits, per, chunks, m_tiles, n_tiles);
        for (int c = t.c0; c < t.c1; ++c, ++seq) {
          const int s = seq % ST, k0 = c * kFmK;
          mbar_wait(&empty[s], ((seq / ST) & 1) ^ 1);  // every consumer warp is done with it
          mbar_expect(&full[s], SB);
          unsigned char* st = ring + s * SB;
          tma_load(st, &maps.a, kSwap ? t.m0 : k0, kSwap ? k0 : t.m0, &full[s]);
          tma_load(st + AB, &maps.w, t.n0, k0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kFmConsumerRegs));
    const int warp = (threadIdx.x - 128) >> 5, lane = threadIdx.x & 31;
    const int lm = lane >> 3, ln = lane & 7, row = warp * 32 + lm;
    int seq = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const FmItem t = fm_item(it, BM, splits, per, chunks, m_tiles, n_tiles);
      float acc[8][16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
      for (int c = t.c0; c < t.c1; ++c, ++seq) {
        const int s = seq % ST;
        mbar_wait(&full[s], (seq / ST) & 1);  // chunk c has landed
        const float* as = reinterpret_cast<const float*>(ring + s * SB) + row * kFmBoxK;
        const float* bs = reinterpret_cast<const float*>(ring + s * SB + AB) + 4 * ln;
        const int kv = K - c * kFmK;
        if (kv >= kFmK) {
#pragma unroll
          for (int g = 0; g < kFmK / 4; ++g) fm_group(acc, as, bs, g);
        } else {  // the last chunk: only its k (K % 4 == 0), not padded to 32
#pragma unroll 1
          for (int g = 0; g < kv / 4; ++g) fm_group(acc, as, bs, g);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      float* o = out + static_cast<size_t>(t.split) * M * N;
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) {
        const int col = t.n0 + 32 * cg + 4 * ln;
        if (col >= N) continue;
        const float4 bias = b != nullptr ? *reinterpret_cast<const float4*>(b + col)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = t.m0 + row + 4 * i;
          if (r >= M) continue;
          float4 v = make_float4(acc[i][4 * cg], acc[i][4 * cg + 1], acc[i][4 * cg + 2],
                                 acc[i][4 * cg + 3]);
          if (b != nullptr) {
            v = make_float4(__fadd_rn(v.x, bias.x), __fadd_rn(v.y, bias.y),
                            __fadd_rn(v.z, bias.z), __fadd_rn(v.w, bias.w));
          }
          *reinterpret_cast<float4*>(o + static_cast<size_t>(r) * N + col) = v;
        }
      }
    }
  }
}

template <bool kSwap = false>
int launch_fma_variant(const FmaPlan& p, const FmaMaps& maps, const void* b, void* out, int M,
                       int K, int N, cudaStream_t s) {
  auto kernel = fma_gemm_kernel<kSwap>;
  static unsigned long long ready = 0;  // a bit a device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready |= 1ull << dev;
  }
  kernel<<<p.grid, kFmThreads, p.smem, s>>>(static_cast<const float*>(b),
                                            static_cast<float*>(out), M, K, N, p.per, p.splits,
                                            maps);
  return static_cast<int>(cudaGetLastError());
}

// Launch a planned GEMM on `s` through `maps` (fma_maps of the same a and
// w): b [N] is added where given (the projection, one plane); a CUDA error
// code. out and b must be 16-byte aligned.
inline int launch_fma_gemm(const FmaPlan& p, const FmaMaps& maps, const void* b, void* out, int M,
                           int K, int N, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(b)) % 16 != 0 ||
      (b != nullptr && p.splits != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_fma_variant(p, maps, b, out, M, K, N, s);
}

}  // namespace
}  // namespace rnn
