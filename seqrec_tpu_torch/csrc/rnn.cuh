// What the recurrences of gru.cu and lstm.cu share (sm_90a).
//
// bf16: the input projection GEMM that takes x @ W_x off their serial
// chain (xproj_wgmma_kernel: wgmma, warp-specialised and persistent, on
// step_gemm.cuh's swizzle, descriptors and tensor maps), the fast gate
// nonlinearities, and the block layout of the tensor-core recurrences (8
// batch rows a block, a lane's (unit, row) positions, packed A fragments,
// and the per-step staging of [B, T, H] planes).
//
// f32: the same projection on the CUDA cores (xproj_f32_kernel: a
// persistent SIMT GEMM on simt_gemm.cuh's main loop, f32 products, no
// TF32), and what the cluster
// recurrences share: the cluster
// primitives (rank, distributed shared memory stores, the cluster barrier),
// the k-sliced layout of a CTA's weights and of the exchanged vector, the
// reduce-scatter that turns a unit's partial sums into one owner lane's
// gate sums, and the cluster launch.
//
// Above H = 256, both: the grid-persistent layouts' barrier, place,
// workspace sizing, checks and cooperative launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "simt_gemm.cuh"
#include "step_gemm.cuh"

// An unnamed namespace inside: each library that includes this header
// keeps its own copy of the kernel, and exports none of it.
namespace rnn {
namespace {

// ---------------------------------------------------------------------------
// bf16: the input projection on wgmma
// ---------------------------------------------------------------------------

// xp [M, N] f32 = x [M, D] @ w_x [D, N] + b, x and w_x bf16, b f32; N is 3H
// (GRU) or 4H (LSTM), M = B T: the x @ W_x + b_x of gru.py:110-113 and
// lstm.py:89-93 for every step at once, off the scan's serial chain.
//
// What bounds it: its operations where D is wide (w3, M = 51,200,
// D = 2,304, N = 6,912: 1.63 TFLOP, 1.65 ms at 989 TFLOP/s, beside 1.68 GB
// moved, 0.50 ms), its f32 output where D is narrow (D = 128: 4 bytes an
// output against 2 D = 256 operations, under the card's ~295 operations a
// byte). The design (hopper-kernels "the usual shape of a fast kernel"):
// - Persistent: one CTA a SM (grid = min(tiles, SMs)) walks output tiles
//   t, t + grid, ... of 256 x 128, 128 x 256 or 128 x 128 (xp_rule: the
//   larger tiles where they fill the SMs as evenly, 128 x 128 where they
//   would not); where K is at most two chunks (D <= 128: the narrow,
//   rsc15 and d = 52 shapes, bound by their f32 output) two CTAs a SM
//   walk 128 x 64 tiles (grid = min(tiles, 2 SMs)), so that one CTA's
//   epilogue overlaps the other's loads. Tiles go in bands of `band` column tiles, each band
//   walked down M, so that the band's W_x (at most kXpL2Budget) stays in L2
//   while each x row block is read once a band.
// - Warp-specialised: warpgroup 0 produces, warpgroups 1 and 2 consume, on
//   a ring of `stages` stages (3, or 4 where K is deep) with a full and an
//   empty mbarrier each. The producer fills a stage with a 64-deep chunk
//   of the tile's x rows and of W_x's 64 k-lines of its columns, in
//   step_gemm.cuh's 128-byte swizzle (W_x as stored, MN-major): by TMA
//   where every row stride is a 16-byte multiple (D % 8 == 0, N % 8 == 0;
//   one thread, counted in bytes on the full barrier), else by cp.async in
//   8-byte pieces from all 128 producer threads, each of which has its
//   copies counted on the stage's full barrier as they land
//   (cp.async.mbarrier.arrive: the producer never waits for a copy, only
//   for a free stage); the consumers fence what landed to the async proxy
//   before their wgmma read it. Zero past M, N and D either way. At one
//   CTA a SM setmaxnreg gives the producer's registers to the consumers
//   (xp_regs).
// - Each consumer warpgroup computes half the tile's rows (one or two m64
//   blocks) with wgmma.m64n256k16 / m64n128k16 / m64n64k16 from shared
//   memory, one
//   chunk's group kept in flight (wgmma.wait_group 1): a stage is handed
//   back on its empty barrier once the next chunk's products are issued.
// - The epilogue adds b in f32 and stores 16 bytes a thread (4 columns of
//   one row, a pair of lanes trading halves), while the producer already
//   fills the next tile's stages.
// - Each output sums its products in k order, then adds b, as
//   torch.matmul(x, w_x) + b does: the same bits run to run, no atomics.
// xproj_plan computes the configuration, as ops/cuda/gru.py's
// xproj_config does; the entry points refuse a caller whose plan differs.
// kernel_probes.py xproj_bf16 times the variants (tile, stages, bands, TMA
// or cp.async, and the step GEMM's kernel, which has no producer warp).
constexpr int kXpThreads = 384;                // a producer and two consumer warpgroups
constexpr int kXpMaxStages = 8;
constexpr int kXpSmemLimit = 232448;           // dynamic shared memory a CTA may opt in to
constexpr int kXpSmSmem = 233472;              // shared memory of a SM (1,024 reserved a CTA)
constexpr long long kXpL2Budget = 12ll << 20;  // W_x bytes a band may keep in L2
// setmaxnreg's registers a thread of the producer and of a consumer, by
// route (the cp.async producer computes its pieces' addresses): 128 x the
// one + 256 x the other = 384 x 168, what the launch holds. (ptxas
// compiles every path within the launch's 168; a consumer's at most 128
// accumulators fit.)
// Two CTAs a SM (128 x 64 tiles) take no setmaxnreg: the launch's 80
// registers a thread hold every path (a consumer's 32 accumulators).
__host__ __device__ constexpr int xp_regs(bool tma, bool consumer) {
  return consumer ? (tma ? 232 : 224) : (tma ? 40 : 56);
}

// CTAs a SM of a tile: two of 128 x 64, else one.
__host__ __device__ constexpr int xp_ctas(int bm, int bn) { return bm * bn == 128 * 64 ? 2 : 1; }

// Bytes of a stage: bm x rows and W_x's 64 k-lines of bn columns; the most
// stages a CTA's share of shared memory holds beside 1,024 bytes to align.
__host__ __device__ constexpr int xp_stage_bytes(int bm, int bn) { return (bm + bn) * kWgK * 2; }
__host__ __device__ constexpr int xp_smem_limit(int bm, int bn) {
  return xp_ctas(bm, bn) == 1 ? kXpSmemLimit : kXpSmSmem / 2 - 1024;
}
__host__ __device__ constexpr int xp_max_stages(int bm, int bn) {
  return (xp_smem_limit(bm, bn) - 1024) / xp_stage_bytes(bm, bn) < kXpMaxStages
             ? (xp_smem_limit(bm, bn) - 1024) / xp_stage_bytes(bm, bn)
             : kXpMaxStages;
}

// Tile t of the walk: (first row, first column), in bands of `band`
// column tiles each walked down the m_tiles row blocks.
__device__ __forceinline__ void xp_place(int t, int band, int m_tiles, int n_tiles, int bm,
                                         int bn, int& m0, int& n0) {
  const int per = band * m_tiles, bi = t / per, r = t - bi * per;
  const int wb = min(band, n_tiles - bi * band);
  m0 = r / wb * bm;
  n0 = (bi * band + r % wb) * bn;
}

// BM x BN tiles: each consumer warpgroup BM / 2 rows, in BM / 128 m64
// blocks; xp_ctas(BM, BN) CTAs a SM. kSwap: the W_x descriptor's byte
// offsets exchanged (128 x 64, one atom of W_x: the 8-line groups' offset
// 0), a control that must fail its check (kernel_probes.py xproj_bf16);
// never in the package.
template <int BM, int BN, bool kTma, bool kSwap = false>
__global__ void __launch_bounds__(kXpThreads, xp_ctas(BM, BN))
xproj_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_x,
                   const float* __restrict__ b, float* __restrict__ xp, int M, int D, int N,
                   int stages, int band, const __grid_constant__ StepGemmMaps maps) {
  static_assert((BM == 128 && (BN == 64 || BN == 128 || BN == 256)) ||
                    (BM == 256 && BN == 128),
                "128 x 64, 128 x 128, 128 x 256 or 256 x 128 tiles: at most 128 accumulators "
                "a thread");
  constexpr int kCtas = xp_ctas(BM, BN);
  constexpr int MB = BM / 128;        // m64 blocks a consumer warpgroup
  constexpr int AB = BM * 128;        // the x tile: BM rows of 64 k
  constexpr int SB = AB + BN * 128;   // then W_x: BN / 64 atoms of 64 k-lines
  extern __shared__ __align__(1024) unsigned char xp_raw[];
  unsigned char* sm = xp_raw + ((1024 - (mma::smem_addr(xp_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[kXpMaxStages], empty[kXpMaxStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&empty[s], 2);  // a thread of each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, chunks = (D + kWgK - 1) / kWgK;
  const int wgi = threadIdx.x >> 7, tid = threadIdx.x & 127;

  if (wgi == 0) {
    // The producer: the ring in one sequence across this CTA's tiles;
    // chunk c of its i-th tile is number i chunks + c, its stage that mod
    // stages, its round that / stages.
    if constexpr (kCtas == 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(xp_regs(kTma, false)));
    }
    if (kTma && tid != 0) return;
    int seq = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      xp_place(t, band, m_tiles, n_tiles, BM, BN, m0, n0);
      for (int c = 0; c < chunks; ++c, ++seq) {
        const int s = seq % stages, k0 = c * kWgK;
        mbar_wait(&empty[s], ((seq / stages) & 1) ^ 1);
        unsigned char* st = sm + s * SB;
        if constexpr (kTma) {
          const int atoms = min(BN / 64, (N - n0 + 63) / 64);  // W_x's atoms inside N
          mbar_expect(&full[s], AB + atoms * 8192);
          tma_load(st, &maps.a, k0, m0, &full[s]);
          for (int q = 0; q < atoms; ++q) {
            tma_load(st + AB + q * 8192, &maps.w, n0 + 64 * q, k0, &full[s]);
          }
        } else {
          auto at = [](unsigned char* tile, int r, int j) {  // step_gemm.cuh's swizzle
            return tile + r * 128 + (((j >> 3) ^ (r & 7)) << 4) + (j & 7) * 2;
          };
#pragma unroll 4
          for (int q = tid; q < BM * 16; q += 128) {  // x: BM rows of 16 pieces
            const int r = q >> 4, j = (q & 15) * 4;
            const bool in = m0 + r < M && k0 + j < D;
            mma::cp_async8_zfill(at(st, r, j),
                                 in ? x + static_cast<size_t>(m0 + r) * D + k0 + j : x,
                                 in ? 8 : 0);
          }
#pragma unroll 4
          for (int q = tid; q < kWgK * BN / 4; q += 128) {  // W_x: 64 k-lines of BN / 4
            const int r = q / (BN / 4), n = q % (BN / 4) * 4;
            const bool in = k0 + r < D && n0 + n < N;
            mma::cp_async8_zfill(at(st + AB + (n >> 6) * 8192, r, n & 63),
                                 in ? w_x + static_cast<size_t>(k0 + r) * N + n0 + n : w_x,
                                 in ? 8 : 0);
          }
          cp_async_arrive(&full[s]);  // once this thread's copies so far have landed
        }
      }
    }
    if (!kTma) {  // no copy outlives its thread
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
    }
  } else {
    if constexpr (kCtas == 1) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(xp_regs(kTma, true)));
    }
    const int g = wgi - 1, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
    constexpr unsigned lbo = kSwap ? 1024 : 8192, sbo = kSwap ? (BN == 64 ? 0 : 8192) : 1024;
    int seq = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      xp_place(t, band, m_tiles, n_tiles, BM, BN, m0, n0);
      float acc[MB][BN / 2];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[mb][e] = 0.0f;
      for (int c = 0; c < chunks; ++c, ++seq) {
        const int s = seq % stages;
        mbar_wait(&full[s], (seq / stages) & 1);
        if constexpr (!kTma) wg::fence_proxy_async();  // the landed copies, visible to wgmma
        const unsigned st = mma::smem_addr(sm + s * SB);
        wg::fence();
#pragma unroll
        for (int ks = 0; ks < kWgK / 16; ++ks) {
          // W_x: 16 k-lines down its atoms; x: this warpgroup's m64 blocks,
          // 32 bytes into each line.
          const uint64_t db = wg::desc_sw128_mn(st + AB + ks * 16 * 128, lbo, sbo);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            const uint64_t da = wg::desc_sw128(st + (g * MB + mb) * 64 * 128 + ks * 32);
            if constexpr (BN == 256) {
              wg::m64n256k16_mn(acc[mb], da, db);
            } else if constexpr (BN == 128) {
              wg::m64n128k16<1>(acc[mb], da, db);
            } else {
              wg::m64n64k16_mn(acc[mb], da, db);
            }
          }
        }
        wg::commit();
        wg::wait<1>();  // chunk c - 1's products are done: its stage is free
        if (c > 0 && tid == 0) mbar_arrive(&empty[(seq - 1) % stages]);
      }
      wg::wait<0>();
      if (tid == 0) mbar_arrive(&empty[(seq - 1) % stages]);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) asm volatile("" : "+f"(acc[mb][e])::"memory");
      // Lane pairs (tq, tq ^ 1) trade halves: the even lane stores row gr's
      // columns 4 (tq / 2) .. + 3 of each n8 block, the odd lane row gr + 8's.
      const bool odd = tq & 1;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int row = m0 + (g * MB + mb) * 64 + warp * 16 + gr + (odd ? 8 : 0);
        const float* a = acc[mb];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float s0 = odd ? a[4 * j] : a[4 * j + 2];
          const float s1 = odd ? a[4 * j + 1] : a[4 * j + 3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const int col = n0 + 8 * j + 4 * (tq >> 1);
          if (row < M && col < N) {
            const float4 bb = *reinterpret_cast<const float4*>(b + col);
            const float4 v = odd ? make_float4(r0 + bb.x, r1 + bb.y, a[4 * j + 2] + bb.z,
                                               a[4 * j + 3] + bb.w)
                                 : make_float4(a[4 * j] + bb.x, a[4 * j + 1] + bb.y,
                                               r0 + bb.z, r1 + bb.w);
            *reinterpret_cast<float4*>(xp + static_cast<size_t>(row) * N + col) = v;
          }
        }
      }
    }
  }
}

// The rule of xproj_plan: the tile and stages of x [M, D] @ w_x [D, N] on
// `sms` SMs (kernel_probes.py xproj_bf16 chose it). Tiles: 128 x 64 (two
// CTAs a SM) where K is at most two chunks deep; else 128 x 128 where a
// CTA's (one a SM) most tiles times their area is under 0.9 of the larger
// tiles', or no more where the larger tiles are under two a SM (the small
// ones balance the last wave); else of 256 x 128 and 128 x 256 the one
// with the smaller such cost, 256 x 128 on a tie. Stages: 4 where K is
// more than 8 chunks deep, else 3; within what shared memory holds.
void xp_rule(int M, int D, int N, int sms, int* tile_m, int* tile_n, int* stages) {
  if ((D + kWgK - 1) / kWgK <= 2) {
    *tile_m = 128;
    *tile_n = 64;
    *stages = 3;
    return;
  }
  auto tiles = [&](int bm, int bn) {
    return static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  auto cost = [&](int bm, int bn) { return (tiles(bm, bn) + sms - 1) / sms * bm * bn; };
  const long long tall = cost(256, 128), wide = cost(128, 256), small = cost(128, 128);
  const bool tall_first = tall <= wide;
  const long long big = tall_first ? tall : wide;
  const long long big_tiles = tall_first ? tiles(256, 128) : tiles(128, 256);
  const bool use_small = 10 * small < 9 * big || (small <= big && big_tiles < 2ll * sms);
  *tile_m = use_small || !tall_first ? 128 : 256;
  *tile_n = use_small || tall_first ? 128 : 256;
  const int want = (D + kWgK - 1) / kWgK > 8 ? 4 : 3, most = xp_max_stages(*tile_m, *tile_n);
  *stages = want < most ? want : most;
}

// The projection's configuration (ops/cuda/gru.py xproj_config): rows and
// columns a tile, ring stages, the copy route, CTAs, column tiles a band and
// shared memory.
struct XprojPlan {
  int tile_m = 0, tile_n = 0, stages = 0, grid = 0, band = 0, smem = 0;
  bool tma = false;  // every row stride a 16-byte multiple
};

// The rest of a plan whose tile and stages are set, on `sms` SMs: the
// route, CTAs, the band and shared memory; a CUDA error code
// (cudaErrorInvalidValue for a tile or stages the kernel cannot take).
// xproj_plan's second half (kernel_probes.cu completes its variants so).
int xp_complete(int M, int D, int N, int sms, XprojPlan* q) {
  const bool shape_ok =
      (q->tile_m == 128 && (q->tile_n == 64 || q->tile_n == 128 || q->tile_n == 256)) ||
      (q->tile_m == 256 && q->tile_n == 128);
  if (!shape_ok || q->stages < 2 || q->stages > xp_max_stages(q->tile_m, q->tile_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  q->tma = D % 8 == 0 && N % 8 == 0;
  const long long m_tiles = (M + q->tile_m - 1) / q->tile_m;
  const int n_tiles = (N + q->tile_n - 1) / q->tile_n;
  const long long tiles = m_tiles * n_tiles;
  const long long ctas = static_cast<long long>(xp_ctas(q->tile_m, q->tile_n)) * sms;
  q->grid = static_cast<int>(tiles < ctas ? tiles : ctas);
  const long long w_bytes = 2ll * D * n_tiles * q->tile_n;
  const long long bands = (w_bytes + kXpL2Budget - 1) / kXpL2Budget;
  q->band = static_cast<int>((n_tiles + bands - 1) / bands);
  q->smem = q->stages * xp_stage_bytes(q->tile_m, q->tile_n) + 1024;
  return 0;
}

// The plan of xp [M, N] = x [M, D] @ w_x [D, N] + b on the current card; a
// CUDA error code (cudaErrorInvalidValue for an empty shape or D or N not a
// multiple of 4). The rule: xp_rule, then xp_complete.
int xproj_plan(int M, int D, int N, XprojPlan* p) {
  if (M <= 0 || D <= 0 || N <= 0 || D % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sg_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  XprojPlan q;
  xp_rule(M, D, N, sms, &q.tile_m, &q.tile_n, &q.stages);
  const int rc = xp_complete(M, D, N, sms, &q);
  if (rc == 0) *p = q;
  return rc;
}

template <int BM, int BN, bool kTma, bool kSwap = false>
int launch_xproj_variant(const XprojPlan& p, const void* x, const void* w_x, const void* b,
                         void* xp, int M, int D, int N, cudaStream_t s) {
  StepGemmMaps maps{};
  if (kTma) {  // x in boxes of 64 k x BM rows, W_x of 64 columns x 64 k-lines
    int rc = sg_map(&maps.a, x, D, M, static_cast<uint64_t>(D) * 2, BM);
    if (rc == 0) rc = sg_map(&maps.w, w_x, N, D, static_cast<uint64_t>(N) * 2, kWgK);
    if (rc != 0) return rc;
  }
  auto kernel = xproj_wgmma_kernel<BM, BN, kTma, kSwap>;
  static unsigned long long ready = 0;  // a bit a device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             xp_max_stages(BM, BN) * xp_stage_bytes(BM, BN) + 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready |= 1ull << dev;
  }
  kernel<<<p.grid, kXpThreads, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_x),
      static_cast<const float*>(b), static_cast<float*>(xp), M, D, N, p.stages, p.band, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_xproj_route(const XprojPlan& p, const void* x, const void* w_x, const void* b,
                       void* xp, int M, int D, int N, cudaStream_t s) {
  return p.tma ? launch_xproj_variant<BM, BN, true>(p, x, w_x, b, xp, M, D, N, s)
               : launch_xproj_variant<BM, BN, false>(p, x, w_x, b, xp, M, D, N, s);
}

// Launch a planned projection on `s`; a CUDA error code (0: launched). x
// and w_x must be aligned to the route's unit (16 bytes by TMA, 8 by
// cp.async), b and xp to 16 bytes.
int launch_xproj(const XprojPlan& p, const void* x, const void* w_x, const void* b, void* xp,
                 int M, int D, int N, cudaStream_t s) {
  const uintptr_t unit = p.tma ? 16 : 8;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_x)) % unit != 0 ||
      (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(xp)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.tile_m == 256) return launch_xproj_route<256, 128>(p, x, w_x, b, xp, M, D, N, s);
  if (p.tile_n == 64) return launch_xproj_route<128, 64>(p, x, w_x, b, xp, M, D, N, s);
  return p.tile_n == 256 ? launch_xproj_route<128, 256>(p, x, w_x, b, xp, M, D, N, s)
                         : launch_xproj_route<128, 128>(p, x, w_x, b, xp, M, D, N, s);
}

// The entry points' projection: the caller's plan (tile_m, tile_n, stages,
// tma, grid, band, smem_bytes) checked against xproj_plan's, then the
// launch.
inline int checked_xproj(const void* x, const void* w_x, const void* b, void* xp, int M, int D,
                         int N, int tile_m, int tile_n, int stages, int tma, int grid, int band,
                         long long smem_bytes, cudaStream_t s) {
  XprojPlan p;
  const int rc = xproj_plan(M, D, N, &p);
  if (rc != 0) return rc;
  if (p.tile_m != tile_m || p.tile_n != tile_n || p.stages != stages ||
      static_cast<int>(p.tma) != tma || p.grid != grid || p.band != band ||
      p.smem != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_xproj(p, x, w_x, b, xp, M, D, N, s);
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


// ---------------------------------------------------------------------------
// f32: the input projection on the CUDA cores
// ---------------------------------------------------------------------------

// xp [M, N] f32 = x [M, D] @ w_x [D, N] + b, all f32, f32 products (no TF32).
// What bounds it: its operations (3.36 GFLOP at M = 25,600, D = 128,
// N = 512: 0.050 ms at 67 TFLOP/s; 1.26 GFLOP at M = 12,800, N = 384),
// issued from operands in shared memory. The design:
// - kTileM x 128 output tiles, 8 x 8 outputs a thread: simt_gemm.cuh's
//   main loop (shared with the f32 sampled-softmax head).
// - x is transposed on its way into shared memory (simt::copy_transposed:
//   xT [k][m], one 4-byte cp.async an element), so a thread's rows of one
//   k are float4 reads; W_x [k][n] arrives in 16-byte pieces. Zero past M,
//   D and N (multiples of 4). k chunks of kTileK in a ring of kStagesT
//   stages filled kStagesT - 1 chunks ahead; one barrier a chunk.
// - Persistent: grid = min(tiles, kMinCtas x the SMs), CTA c takes tiles
//   c, c + G, c + 2G, ... (tile j: row block j % m_tiles, column block
//   j / m_tiles), so every SM gets within one tile of the same work, and
//   the ring runs straight across a CTA's tiles: the next tile's first
//   chunks load while this one's last chunk computes and its outputs are
//   stored. Column blocks go one after another over all rows, so the last
//   ones written, still in L2, hold a block of every row: the recurrence
//   that reads xp next starts at t = 0 of every row.
// Each output sums its products in k order, then adds b, as
// torch.matmul(x, w_x) + b does.
constexpr int kF32TileN = simt::kTileN;  // columns of an xp tile

template <int kTileM, int kTileK, int kStagesT>
constexpr int f32_proj_smem() {
  return kStagesT * kTileK * (kTileM + 4 + kF32TileN) * 4;
}

template <int kTileM, int kTileK, int kStagesT, int kMinCtas>
__global__ void __launch_bounds__(kTileM * 2, kMinCtas)
xproj_f32_kernel(const float* __restrict__ x, const float* __restrict__ w_x,
                 const float* __restrict__ b, float* __restrict__ xp, int M, int D, int N) {
  constexpr int NT = kTileM * 2;          // threads
  constexpr int LDT = kTileM + 4;         // floats a k row of xT (the pad: distinct banks)
  constexpr int SF = kTileK * (LDT + kF32TileN);  // floats a stage: xT, then W_x
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x;
  const simt::Place p = simt::place();
  const int m_tiles = (M + kTileM - 1) / kTileM;
  const int tiles = m_tiles * ((N + kF32TileN - 1) / kF32TileN);
  const int chunks = (D + kTileK - 1) / kTileK;
  const int G = gridDim.x;
  // This CTA's (tile, chunk) iterations, flat: iteration i is chunk i % chunks
  // of its tile blockIdx.x + (i / chunks) G.
  const int iters = (tiles - static_cast<int>(blockIdx.x) + G - 1) / G * chunks;

  auto stage = [&](int i) {
    if (i < iters) {
      const int tile = blockIdx.x + (i / chunks) * G, k0 = (i % chunks) * kTileK;
      const int m0 = tile % m_tiles * kTileM, n0 = tile / m_tiles * kF32TileN;
      float* xs = fsm + (i % kStagesT) * SF;
      float* ws = xs + kTileK * LDT;
      simt::copy_transposed<kTileM, kTileK, NT>(xs, LDT, x, M, D, m0, k0);
#pragma unroll
      for (int q = 0; q < kTileK * kF32TileN / 4 / NT; ++q) {
        const int c = tid + q * NT;
        const int kr = c >> 5, n = (c & 31) * 4;  // W_x: kTileK rows of 32 float4
        const bool in = k0 + kr < D && n0 + n < N;
        mma::cp_async16_zfill(ws + kr * kF32TileN + n,
                              in ? w_x + static_cast<size_t>(k0 + kr) * N + n0 + n : w_x,
                              in ? 16 : 0);
      }
    }
    mma::cp_async_commit();  // an empty group past the last keeps the count
  };

  float acc[8][8];
  simt::zero(acc);
#pragma unroll
  for (int i = 0; i < kStagesT - 1; ++i) stage(i);
  for (int i = 0; i < iters; ++i) {
    mma::cp_async_wait<kStagesT - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();                     // ... everyone's; chunk i - 1's stage is free
    stage(i + kStagesT - 1);
    const float* xs = fsm + (i % kStagesT) * SF;
    simt::fma_chunk<kTileM, kTileK, LDT, kF32TileN>(acc, xs, xs + kTileK * LDT, p);
    if (i % chunks == chunks - 1) {  // the tile's last chunk: b, then store
      const int tile = blockIdx.x + (i / chunks) * G;
      const int m0 = tile % m_tiles * kTileM, n0 = tile / m_tiles * kF32TileN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 64 * h + 4 * p.tn;
        if (col < N) {
          const float4 bias = *reinterpret_cast<const float4*>(b + col);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int row = m0 + simt::row_of<kTileM>(r, p.tm);
            if (row < M) {
              *reinterpret_cast<float4*>(xp + static_cast<size_t>(row) * N + col) =
                  make_float4(acc[r][4 * h] + bias.x, acc[r][4 * h + 1] + bias.y,
                              acc[r][4 * h + 2] + bias.z, acc[r][4 * h + 3] + bias.w);
            }
          }
        }
      }
      simt::zero(acc);
    }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
}

// Launch variant <kTileM, kTileK, kStagesT, kMinCtas> of the projection on
// at most kMinCtas CTAs a SM; a CUDA error code.
template <int kTileM, int kTileK, int kStagesT, int kMinCtas>
int launch_xproj_f32_variant(const void* x, const void* w_x, const void* b, void* xp, int M,
                             int D, int N, cudaStream_t s) {
  if (M <= 0 || D <= 0 || N <= 0 || D % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int smem = f32_proj_smem<kTileM, kTileK, kStagesT>();
  auto kernel = xproj_f32_kernel<kTileM, kTileK, kStagesT, kMinCtas>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>((M + kTileM - 1) / kTileM) *
                          ((N + kF32TileN - 1) / kF32TileN);
  const int grid = static_cast<int>(tiles < kMinCtas * sms ? tiles : kMinCtas * sms);
  kernel<<<grid, kTileM * 2, smem, s>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(w_x),
                                        static_cast<const float*>(b), static_cast<float*>(xp),
                                        M, D, N);
  return static_cast<int>(cudaGetLastError());
}

// Launch the f32 projection on `s`; a CUDA error code (0: launched). 64-row
// tiles, 32-deep chunks, 2 stages, 4 CTAs a SM: of the variants
// kernel_probes.py xproj times (kernel_probes.cu), the fastest or within 3%
// of it at the f32 paths' shapes (M = 12,800 and 25,600, N = 384 and 512).
// On an H100 it stays 1.0-1.14x torch.addmm f32 there: an 8 x 8
// outer-product loop of the same kind (kernel_probes.cu) with no copies, no
// shared-memory reads and no stores runs at ~60% of the FMA peak (PERF.md).
int launch_xproj_f32(const void* x, const void* w_x, const void* b, void* xp, int M, int D,
                     int N, cudaStream_t s) {
  return launch_xproj_f32_variant<64, 32, 2, 4>(x, w_x, b, xp, M, D, N, s);
}

// ---------------------------------------------------------------------------
// f32: the cluster recurrences
// ---------------------------------------------------------------------------
//
// A cluster of C CTAs on neighbouring SMs owns R batch rows for the whole
// scan; CTA c owns hidden units [c U, c U + U) (U = ceil(H / C)) and keeps
// its slice of W_h in its own shared memory. The threads of a unit (the GRU
// and LSTM forwards: S consecutive lanes, thread = S ul + s) or of 4 units
// (the LSTM and GRU reverses: a warp) each sum the products of one slice of the K
// inputs of the step's vector (h, K = H; the LSTM's dz, K = 4H; the GRU's
// d_hproj, K = 3H), and a reduce-scatter among them
// leaves each (unit, row) pair the full sums in one owner lane. Each owner
// lane then computes its pairs and stores its results into every CTA's copy
// of the next step's vector, through distributed shared memory; an mbarrier
// a buffer makes the stores visible (the exchange below). The vector is
// double-buffered: a lane
// stores into buffer (t+1) & 1 only after its CTA received every CTA's
// values of step t-1, which each produced after its last reads of that
// buffer (a CTA's lanes of padded units read it late, into results nobody
// uses). Only stores cross CTAs, none after a CTA's last fill, and a
// cluster barrier ends the kernel.
namespace cluster {

__device__ __forceinline__ unsigned rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
// The address of `p` (this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ unsigned map(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(mma::smem_addr(p)), "r"(rank));
  return r;
}
// The cluster barrier, every thread of every CTA: what a thread stored
// (shared or distributed) before it is visible to every thread after it.
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The step's exchange: an mbarrier in each CTA's shared memory counts the
// bytes of the next vector that have landed there. A producer lane stores
// each value into every CTA with st.async, which also signals that CTA's
// mbarrier (complete_tx); it is a one-way store, with no release fence to
// wait for the lane's other memory operations, and no barrier across the
// cluster. One thread of the consuming CTA arms the mbarrier for the bytes
// of a fill (arrive.expect_tx) and waits for its phase.
__device__ __forceinline__ void mbar_init(uint64_t* mb) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mma::smem_addr(mb)) : "memory");
}
// The inits visible to the cluster's st.async before the first cluster sync.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(mma::smem_addr(mb)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* mb, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(mma::smem_addr(mb)), "r"(parity) : "memory");
}
// v into `addr` (a map()ped address) of a CTA whose mbarrier is at `mbar`
// (map()ped too), counting 4 bytes there.
__device__ __forceinline__ void store_async(unsigned addr, float v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
}

}  // namespace cluster

// Values of a k-slice: K split into S slices of L values, L a multiple of 4
// (K pads to S L with zeros).
__host__ __device__ __forceinline__ int slice_len(int K, int S) {
  return (K + 4 * S - 1) / (4 * S) * 4;
}
// Where input k sits in a vector of S L floats laid out so that four values
// j of slice s are float4 number j S + s: the S threads of a unit read S
// consecutive float4s, which no two of a quarter warp share a bank in.
__device__ __forceinline__ int slice_pos(int k, int L, int S) {
  const int s = k / L, o = k - s * L;
  return ((o >> 2) * S + s) * 4 + (o & 3);
}

// Reduce-scatter among the lanes that share a group of units (the low bits
// of the lane index, masks M = lanes / 2 .. 1): v[R][UT][G] holds this
// lane's partial sums of R rows, UT units and G gates. Each level halves the
// rows a lane keeps while more than one is left (the lane whose bit is set
// keeps the upper half), then its units, then sums what is left whole; the
// gates stay together. Afterwards v[k][m] (k < Owner::NR, m < Owner::NU)
// holds the full sums of the (row, unit) pairs Owner names.
template <int N, int NU, int M, int R, int UT, int G>
__device__ __forceinline__ void reduce_scatter(float (&v)[R][UT][G], int lane) {
  if constexpr (M >= 1) {
    const bool hi = (lane & M) != 0;
    if constexpr (N > 1) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
#pragma unroll
        for (int m = 0; m < NU; ++m)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float send = hi ? v[i][m][g] : v[i + N / 2][m][g];
            const float keep = hi ? v[i + N / 2][m][g] : v[i][m][g];
            v[i][m][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
          }
      reduce_scatter<N / 2, NU, M / 2, R, UT, G>(v, lane);
    } else if constexpr (NU > 1) {
#pragma unroll
      for (int m = 0; m < NU / 2; ++m)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float send = hi ? v[0][m][g] : v[0][m + NU / 2][g];
          const float keep = hi ? v[0][m + NU / 2][g] : v[0][m][g];
          v[0][m][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
        }
      reduce_scatter<1, NU / 2, M / 2, R, UT, G>(v, lane);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) v[0][0][g] += __shfl_xor_sync(0xffffffffu, v[0][0][g], M);
      reduce_scatter<1, 1, M / 2, R, UT, G>(v, lane);
    }
  }
}

// The pairs a lane holds after reduce_scatter over `Lanes` lanes: rows
// row0 + k (k < NR) of units ut0 + m (m < NU) of its group; LR levels split
// rows, LU units, A sum whole, and the lanes with the low A bits clear own
// the pairs (the others hold copies).
constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

template <int R, int UT, int Lanes>
struct Owner {
  static constexpr int LL = log2i(Lanes);
  static constexpr int LR = log2i(R) < LL ? log2i(R) : LL;
  static constexpr int LU = log2i(UT) < LL - LR ? log2i(UT) : LL - LR;
  static constexpr int A = LL - LR - LU;
  static constexpr int NR = R >> LR, NU = UT >> LU;
  int row0, ut0;
  bool owner;
  __device__ explicit Owner(int lane)
      : row0((lane >> (LL - LR)) * NR), ut0(((lane >> A) & ((1 << LU) - 1)) * NU),
        owner((lane & ((1 << A) - 1)) == 0) {}
};

// Launch `kernel` on `clusters` clusters of C CTAs of `threads` threads
// each, with `smem` bytes of dynamic shared memory; a CUDA error code.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int clusters, int C, int threads, size_t smem,
                    cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The per-step operands of a cluster recurrence's lane (the forwards' xp,
// the LSTM reverse's gate planes, the GRU reverse's projections) arrive by
// cp.async into its own slots of a ring of kClusterRing stages in shared
// memory, kClusterAhead steps ahead of their use: a load into registers
// would be waited for by the next arrive's release, which cp.async copies
// are not.
constexpr int kClusterAhead = 3;
constexpr int kClusterRing = kClusterAhead + 1;

// The rows (R) and k-slices (S) a cluster kernel is instantiated for.
constexpr bool cluster_shape_ok(int R, int S) {
  return (R == 4 || R == 8 || R == 16) && (S == 8 || S == 16);
}
constexpr int kClusterMaxThreads = 512;
constexpr int kClusterMax = 8;  // the portable cluster size

// ---------------------------------------------------------------------------
// Above H = 256: what the grid-persistent layouts of gru.cu and lstm.cu share
// ---------------------------------------------------------------------------
//
// W_h of 1.5 MB and more fits no cluster of CTAs. One cooperative launch
// keeps every CTA of the grid resident for the whole scan (cudaLaunchKernelEx
// with the cooperative attribute: the runtime refuses a grid that would not
// be resident at once, so no CTA spins on one that never runs). CTA (tile,
// group) owns a slice of the hidden units, kGridUnits(dtype) of them (16 in
// bf16: one m16 tile; 8 in f32), with W_h's values of those units, every
// gate, resident in its shared memory (32 x gates x Kp bytes, Kp = H padded
// to kGridK(dtype)), and a group of batch rows; the row groups split the
// rows as far as the card's SMs allow beside the unit slices (the wrappers'
// grid_config). The step's vector on the serial chain goes through global
// memory, read through L2 only (ld.global.cg: never a stale L1 line),
// double-buffered, with one grid-wide barrier a step (grid_sync). The
// counter and the planes are a workspace the wrapper zeroes on the stream
// before each launch (no host synchronisation, so a CUDA graph could
// capture it). Each CTA owns whole units, so no output needs a cross-CTA
// sum, nothing is added atomically, and the bits are the same from run to
// run.

constexpr int kGridAbove = 256;     // the grid layouts take H past this (the block and cluster layouts' widest)
constexpr int kGridThreads = 256;   // 8 warps a CTA
constexpr int kGridCounter = 256;   // workspace bytes before the planes: the barrier's counter
__host__ __device__ constexpr int kGridUnits(bool bf16) { return bf16 ? 16 : 8; }
__host__ __device__ constexpr int kGridK(bool bf16) { return bf16 ? 32 : 128; }
__host__ __device__ constexpr int kGridRowTile(bool bf16) { return bf16 ? 16 : 4; }
__host__ __device__ inline int grid_kpad(int H, bool bf16) {
  return (H + kGridK(bf16) - 1) / kGridK(bf16) * kGridK(bf16);
}
__host__ __device__ inline int grid_rows(int B, bool bf16) {
  return (B + kGridRowTile(bf16) - 1) / kGridRowTile(bf16) * kGridRowTile(bf16);
}
// Shared memory of a grid kernel (bytes): W_h's values of the CTA's units,
// `gates` gates (bf16: 16 units x gates x Kp x 2 bytes; f32: 8 x gates x Kp x 4).
__host__ __device__ inline int grid_smem(int H, bool bf16, int gates) {
  return 32 * gates * grid_kpad(H, bf16);
}
// Workspace bytes: the counter, then `plane_bytes` bytes for each (row, k)
// of the [rows][Kp] plane (each kernel's buffers and carries).
__host__ inline size_t grid_workspace(int B, int H, bool bf16, int plane_bytes) {
  const size_t plane = static_cast<size_t>(grid_rows(B, bf16)) * grid_kpad(H, bf16);
  return kGridCounter + static_cast<size_t>(plane_bytes) * plane;
}

// The grid barrier: every CTA adds one to *ctr and waits until it holds
// `target` (gridDim.x times the barriers passed so far, this one included).
// What any thread of any CTA wrote before it is visible to every thread
// after it (the CTA barrier, then a release add and acquire reads at gpu
// scope, with the fences cooperative groups' grid sync uses). A barrier
// that never completes (a fault, not a slow CTA: the launch is cooperative)
// traps after ~2^28 reads, tens of seconds, so that the caller gets an
// error and not a hung card.
__device__ __forceinline__ void grid_sync(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
    unsigned v, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
      if (++spins == (1u << 28)) __trap();
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float ldcg_bf16(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// The CTA's place: unit slice `tile` of `tiles`, row group `group` of
// `groups`; its row tiles [r0, r1) of `row_tiles` (kGridRowTile rows each).
struct GridPlace {
  int tile, r0, r1;
  __device__ GridPlace(int tiles, int row_tiles, int groups) {
    tile = blockIdx.x % tiles;
    const int group = blockIdx.x / tiles, per = (row_tiles + groups - 1) / groups;
    r0 = group * per;
    r1 = min(row_tiles, r0 + per);
  }
};

// The CTA's packed weights (`words` 16-byte words from `src`) into shared memory.
__device__ __forceinline__ void grid_load_weights(uint4* dst, const uint4* src, int words) {
  for (int i = threadIdx.x; i < words; i += kGridThreads) dst[i] = src[i];
  __syncthreads();
}

// Launch `kernel` on `grid` CTAs of kGridThreads threads with `smem` bytes
// of dynamic shared memory, cooperatively (every CTA resident at once, or
// the launch fails); a CUDA error code.
template <typename... Params, typename... Args>
int launch_grid(void (*kernel)(Params...), int grid, int smem, cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the grid entry points check: H past kGridAbove (the grid layouts are
// chosen only there), H % 4 == 0, the unit slices and row groups within the
// card's SMs, the shared memory of `gates` gates within the 227 KB a CTA
// may have, and the caller's shared-memory size and workspace size (`ws_want`
// as the kernel's file computes it).
int grid_check(int B, int Tn, int H, bool bf16, int gates, int groups, long long smem_bytes,
               long long ws_bytes, size_t ws_want, int* grid) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Tn <= 0 || H <= kGridAbove || H % 4 != 0 || groups <= 0) return bad;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (H + kGridUnits(bf16) - 1) / kGridUnits(bf16);
  const int row_tiles = grid_rows(B, bf16) / kGridRowTile(bf16);
  *grid = tiles * groups;
  if (groups > row_tiles || *grid > sms || grid_smem(H, bf16, gates) > 232448 ||
      smem_bytes != grid_smem(H, bf16, gates) || ws_bytes != static_cast<long long>(ws_want)) {
    return bad;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Past the grid layouts' limits, both dtypes: the stepped layout
// ---------------------------------------------------------------------------
//
// Above grid_max_hidden no grid of unit slices fits the card at once, so the
// serial chain goes back to the host's stream: each step of a scan is two
// launches, a GEMM of the whole [B, K] vector (f32 out: h @ W_h forward,
// d_hproj @ W_h^T reverse) and an elementwise gate kernel of the file's cell
// (one thread a (row, unit)). No H is too wide for it; 2T launches a scan
// cost a few us each beside a step's GEMM of 2 B H 3H (GRU) or 4H (LSTM)
// operations. bf16: step_gemm.cuh's kernel, K split into `splits` partial
// planes that the gate kernel sums where it reads the product (step_product;
// the GRU forward's b_h added there); the reverse's takes the f32 cotangent
// as two bf16 terms, hi and lo, on the same W_h tiles, summed in f32, as every
// reverse recurrence does. f32: the CUDA-core projection above, one plane
// (splits = 1), b added inside; the reverse multiplies a W_h^T copy.
constexpr int kStepThreads = 256;  // a gate kernel's block

// The entry points' check of the caller's GEMM configuration (bf16: the
// step GEMM's plan, rows a block `block_m` and `splits`; f32: one plane,
// block_m 0) and of its workspace bytes; a CUDA error code.
inline int stepped_plan(bool bf16, int M, int K, int N, int terms, int splits, int block_m,
                        long long ws_bytes, StepGemmPlan* p) {
  if (bf16) {
    const int rc = step_gemm_plan(M, K, N, terms, p);
    if (rc != 0) return rc;
  } else {
    *p = StepGemmPlan{};
    p->ws_bytes = static_cast<size_t>(M) * N * 4;
  }
  if (p->splits != splits || p->bm != block_m || static_cast<long long>(p->ws_bytes) != ws_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The step's product into `out` (p.ws_bytes): bf16 the step GEMM's
// partials of a [M, terms K] @ w (w [K, N] forward, [N, K] reverse; b
// unused, the gate kernel adds it; `maps` step_gemm_maps of a and w); f32
// out [M, N] = a [M, K] @ w [K, N] + b on the CUDA cores; K % 4 == 0,
// N % 4 == 0.
inline int step_gemm(bool bf16, const StepGemmPlan& p, const StepGemmMaps& maps, const void* a,
                     const void* w, const void* b, void* out, int M, int K, int N, int terms,
                     cudaStream_t s) {
  return bf16 ? launch_step_gemm(p, maps, a, w, out, M, K, N, terms, s)
              : launch_xproj_f32(a, w, b, out, M, K, N, s);
}

// The step's product at `i` of a [M, N] plane: the sum of its `splits`
// partial planes (`plane` floats apart), in split order.
__device__ __forceinline__ float step_product(const float* p, int splits, size_t plane,
                                              size_t i) {
  float v = p[i];
  for (int s = 1; s < splits; ++s) v += p[s * plane + i];
  return v;
}

// The gate nonlinearities of a step in the dtype's numerics: bf16 the fast
// ones (h is rounded to bf16 after them), f32 the accurate ones.
template <typename T>
__device__ __forceinline__ float step_sigmoid(float v) {
  if constexpr (sizeof(T) == 2) {
    return fast_sigmoid(v);
  } else {
    return 1.0f / (1.0f + expf(-v));
  }
}
template <typename T>
__device__ __forceinline__ float step_tanh(float v) {
  if constexpr (sizeof(T) == 2) {
    return fast_tanh(v);
  } else {
    return tanhf(v);
  }
}

__device__ __forceinline__ float step_load(float v) { return v; }
__device__ __forceinline__ float step_load(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T step_round(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// A reverse step's cotangent column `col` of row `row` into the GEMM's A:
// bf16 [B][2 K] (hi = bf16(d) at col, lo = bf16(d - hi) at K + col), f32
// [B][K] as it is.
template <typename W>
__device__ __forceinline__ void step_store_d(W* a, int row, int K, int col, float d) {
  if constexpr (sizeof(W) == 2) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(d);
    a[static_cast<size_t>(row) * 2 * K + col] = hi;
    a[static_cast<size_t>(row) * 2 * K + K + col] = __float2bfloat16_rn(d - __bfloat162float(hi));
  } else {
    a[static_cast<size_t>(row) * K + col] = d;
  }
}

// Launch a gate kernel over B H (row, unit) pairs; a CUDA error code.
template <typename... Params, typename... Args>
int launch_step(void (*kernel)(Params...), int B, int H, cudaStream_t s, Args... args) {
  const long long pairs = static_cast<long long>(B) * H;
  kernel<<<static_cast<unsigned>((pairs + kStepThreads - 1) / kStepThreads), kStepThreads, 0, s>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace rnn
