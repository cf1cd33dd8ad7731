// The stepped layouts' bf16 step GEMM (sm_90a), past the grid layouts'
// limits (rnn.cuh, "the stepped layout"): each step of a GRU or LSTM scan
// multiplies the whole [B, K] vector on its serial chain by W_h.
//
//   forward (kTerms 1): p = h [M, K] @ W_h [K, N], W_h as stored ([H, G H]:
//     K = H, N = G H; B MN-major);
//   reverse (kTerms 2): p = hi @ W_h^T + lo @ W_h^T, A [M][2 K] holding the
//     f32 cotangent's two bf16 terms (hi at k, lo at K + k), W_h as stored,
//     read as [N][K] (N = H, K = G H; B K-major): no transposed or stacked
//     copy.
//
// It replaces no TPU kernel alone: it is the h @ W_h / d @ W_h^T of
// seqrec_tpu/ops/pallas/gru.py:177 and :190 (`_gru_bwd_math`) and lstm.py:153
// and :209 (`_lstm_bwd_math`) once the recurrences run step by step. What
// bounds it: at M = B = 256 a step is 2 M K N (x 2 terms) operations on
// W_h's K N bf16 values read once (the GRU reverse at H = 2,304: 16.3 GFLOP,
// 16.5 us at 989 TFLOP/s, beside 31.85 MB of W_h, 9.5 us at 3.35 TB/s), so
// the operations, if W_h is read once a step and the card is full. The
// design does that:
// - wgmma.m64n128k16 reads both operands from shared memory through matrix
//   descriptors (the tensor cores' full rate; no ldmatrix): A K-major, W
//   K-major (reverse) or MN-major (forward, the transpose flag), all in the
//   128-byte swizzle: a row's (or a k-line's) 64 values one 128-byte line,
//   its 16-byte piece p at p ^ line % 8, 8-line groups 1,024 bytes apart,
//   every tile 1,024-byte aligned.
// - A CTA of two warpgroups computes BM rows x 128 columns: forward BM 256
//   at M > 128 (two m64 blocks a warpgroup, so at M <= 256 each W_h tile
//   goes into shared memory once a step), else 128; reverse BM 128 (its two
//   A tiles leave no room for three stages at 256: at M = 256 a W tile's
//   second read comes from L2). The reverse's hi and lo tiles multiply the
//   same W tile into one f32 accumulator.
// - K in 64-deep chunks through a ring of kWgStages stages filled
//   kWgStages - 1 chunks ahead. Where every row stride and base is a
//   16-byte multiple (K % 8 == 0, and N % 8 == 0 forward) by TMA (template
//   flag kTma): one thread asks for the chunk's boxes through tensor maps
//   encoded once a scan, counted on the stage's mbarrier, which every thread
//   waits on. Otherwise (H = 2,116 has 4,232-byte rows) by cp.async in
//   8-byte pieces, each thread fencing its landed copies to the async proxy.
//   Zero past M, N and K either way; then one barrier, the warpgroup's wgmma
//   on the chunk, and wgmma.wait_group 0 before its stage is refilled.
// - K split into `splits` ranges of whole chunks so that the tiles times
//   the splits fill the card's SMs in one wave (at most kSgMaxSplits, each
//   at least kSgMinChunks chunks). Split s writes its f32 partial into plane
//   s of the workspace [splits][M][N]; the gate kernel that follows sums the
//   planes in split order where it reads the product (rnn::step_product):
//   no atomics, no extra launch, the same bits run to run.
// - More tiles than SMs (N or M past one wave): splits = 1 and one CTA a SM
//   walks tiles c, c + SMs, ...
// kernel_probes.py step_gemm times this kernel's variants (TMA or
// cp.async, rows a block, ring stages, K splits) at the stepped shapes;
// PERF.md §6 has the choice and the designs it was held against.
// step_gemm_plan computes the configuration, as ops/cuda/gru.py's
// step_gemm_config does; the entry points check that both agree.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace rnn {
namespace {

constexpr int kSgThreads = 256;   // two warpgroups
constexpr int kSgTileN = 128;     // output columns a CTA: wgmma's n128
constexpr int kWgK = 64;          // k a chunk: one 128-byte line
constexpr int kWgStages = 3;      // ring stages
constexpr int kSgMaxSplits = 8;   // K splits at most
constexpr int kSgMinChunks = 8;   // chunks a split at least, where K allows

template <int kUnit>
__device__ __forceinline__ void sg_copy(void* dst, const void* src, bool in) {
  if constexpr (kUnit == 16) {
    mma::cp_async16_zfill(dst, src, in ? 16 : 0);
  } else {
    mma::cp_async8_zfill(dst, src, in ? 8 : 0);
  }
}

namespace wg {

// The thread's shared-memory writes (cp.async landed) visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// At most kPending of this warpgroup's committed groups still in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// d += A (64 x 16, K-major) . B (16 x 128; K-major, or MN-major with
// kTransB), f32 sums.
template <int kTransB = 0>
__device__ __forceinline__ void m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

// d += A (64 x 16, K-major) . B (16 x 256, MN-major), f32 sums: the
// input projection's (rnn.cuh) 128-register accumulator. The B descriptor's
// LBO steps from one 64-column atom to the next, as m64n128k16's.
__device__ __forceinline__ void m64n256k16_mn(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 16, K-major) . B (16 x 64, MN-major), f32 sums: the input
// projection's (rnn.cuh) 64-column tile, one atom of B.
__device__ __forceinline__ void m64n64k16_mn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// A K-major shared-memory matrix descriptor in the 128-byte swizzle: the
// start address in 16-byte units, the leading byte offset unused (1), the
// 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// The same for an MN-major B (the forward's W [K][N]): 64-column atoms
// of 8 k-lines, the next 64 columns 8,192 bytes on (LBO), the next 8
// k-lines 1,024 bytes on (SBO). (rnn.cuh's projection passes the two
// exchanged for its control.)
__device__ __forceinline__ uint64_t desc_sw128_mn(unsigned addr, unsigned lbo = 8192,
                                                  unsigned sbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

}  // namespace wg

// The TMA route (kTma): one thread asks the tensor memory accelerator for a
// chunk's tiles, which it writes in the same 128-byte swizzle and counts on
// the stage's mbarrier; every thread waits for the stage's phase.
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mma::smem_addr(b)), "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(mma::smem_addr(b)) : "memory");
}
// One arrival on `b` once every cp.async this thread issued before has
// landed (counted against the arrivals `b` was made with).
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(mma::smem_addr(b))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(mma::smem_addr(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(mma::smem_addr(b)), "r"(parity) : "memory");
}
// The box of `map` at (c0 inner, c1 outer) into `dst`, counted on `b`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(mma::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(mma::smem_addr(b)) : "memory");
}

// The TMA route's tensor maps: A [M][terms K] in boxes of BM rows x 64 k;
// W [N][K] (reverse) in boxes of 128 n x 64 k, or [K][N] (forward) in
// boxes of 64 k x 64 n; all bf16 in the 128-byte swizzle, zero past the
// tensor. Unused (not encoded) on the cp.async route.
struct StepGemmMaps {
  CUtensorMap a, w;
};

// Shared memory: `stages` x (`terms` A tiles of BM rows and the W tile,
// 128 bytes a row or k-line, 16 KB), and 1,024 bytes to align.
__host__ __device__ constexpr int wg_smem(int bm, int terms, int stages = kWgStages) {
  return stages * (terms * bm + kSgTileN) * 128 + 1024;
}

// Plane `split` of out [splits][M][N] f32 = the chunks [split per, (split +
// 1) per) of the product (see the file note); grid = grid_tiles x splits;
// BM = 128 (one m64 block a warpgroup) or 256 (two); kTma: the chunks come
// by TMA through `maps` (16-byte rows only), else by cp.async.
template <int BM, int kTerms, int kUnit, bool kTma = false, int ST = kWgStages>
__global__ void __launch_bounds__(kSgThreads, 1)
step_gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                       float* __restrict__ out, int M, int K, int N, int per, int grid_tiles,
                       const __grid_constant__ StepGemmMaps maps) {
  static_assert(!kTma || kUnit == 16, "TMA needs 16-byte row strides");
  constexpr int MB = BM / 128;
  constexpr int UE = kUnit / 2, KP = kWgK / UE;
  constexpr int AB = BM * 128;
  constexpr int SB = kTerms * AB + kSgTileN * 128;  // W: 128 n x 64 k either way
  extern __shared__ __align__(1024) unsigned char sw_raw[];
  unsigned char* sws = sw_raw + ((1024 - (mma::smem_addr(sw_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t bars[ST];  // the TMA route's: one a stage
  if (kTma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < ST; ++s) mbar_init(&bars[s]);
      mbar_init_fence();
    }
    __syncthreads();
  }
  const int tid = threadIdx.x, wgi = tid >> 7, wwarp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int n_tiles = (N + kSgTileN - 1) / kSgTileN;
  const int tiles = n_tiles * ((M + BM - 1) / BM);
  const int split = blockIdx.x / grid_tiles;
  const int chunks = (K + kWgK - 1) / kWgK;
  const int c0 = split * per, nc = min(chunks, c0 + per) - c0;
  const size_t lda = static_cast<size_t>(kTerms) * K;
  float* part = out + static_cast<size_t>(split) * M * N;
  // Element (row r, column j < 64) of a tile of 128-byte lines, swizzled.
  auto at = [](unsigned char* tile, int r, int j) {
    return tile + r * 128 + (((j >> 3) ^ (r & 7)) << 4) + (j & 7) * 2;
  };
  // The forward's W [K][N] tile, MN-major: two 64-column halves of 64
  // k-lines, 8,192 bytes apart.
  auto at_mn = [&](unsigned char* tile, int k, int n) {
    return at(tile + (n >> 6) * 8192, k, n & 63);
  };

  // A CTA's chunks run through the ring in one sequence across its tiles:
  // chunk i of its t-th tile is number t nc + i, its stage that mod ST and
  // its mbarrier phase that / ST (TMA route).
  int seq = 0;
  for (int tile = blockIdx.x % grid_tiles; tile < tiles; tile += grid_tiles, seq += nc) {
    const int n0 = tile % n_tiles * kSgTileN, m0 = tile / n_tiles * BM;
    auto load = [&](int i) {
      if (kTma) {
        if (threadIdx.x == 0 && i < nc) {
          const int slot = (seq + i) % ST, k0 = (c0 + i) * kWgK;
          unsigned char* st = sws + slot * SB;
          mbar_expect(&bars[slot], SB);
#pragma unroll
          for (int term = 0; term < kTerms; ++term) {
            tma_load(st + term * AB, &maps.a, term * K + k0, m0, &bars[slot]);
          }
          if (kTerms == 2) {
            tma_load(st + 2 * AB, &maps.w, k0, n0, &bars[slot]);
          } else {
            tma_load(st + AB, &maps.w, n0, k0, &bars[slot]);
            tma_load(st + AB + 8192, &maps.w, n0 + 64, k0, &bars[slot]);
          }
        }
        return;
      }
      if (i < nc) {
        unsigned char* st = sws + (seq + i) % ST * SB;
        const int k0 = (c0 + i) * kWgK;
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
#pragma unroll
          for (int q = 0; q < BM * KP / kSgThreads; ++q) {
            const int c = tid + q * kSgThreads;
            const int r = c / KP, j = c % KP * UE;
            const bool in = m0 + r < M && k0 + j < K;
            sg_copy<kUnit>(at(st + term * AB, r, j),
                           in ? a + (m0 + r) * lda + static_cast<size_t>(term) * K + k0 + j : a,
                           in);
          }
        }
        if constexpr (kTerms == 2) {  // W [N][K]: 128 n-lines of 64 k
#pragma unroll
          for (int q = 0; q < kSgTileN * KP / kSgThreads; ++q) {
            const int c = tid + q * kSgThreads;
            const int r = c / KP, j = c % KP * UE;
            const bool in = n0 + r < N && k0 + j < K;
            sg_copy<kUnit>(at(st + 2 * AB, r, j),
                           in ? w + static_cast<size_t>(n0 + r) * K + k0 + j : w, in);
          }
        } else {  // W [K][N]: 64 k-rows of 128 n
          constexpr int NP = kSgTileN / UE;
#pragma unroll
          for (int q = 0; q < kWgK * NP / kSgThreads; ++q) {
            const int c = tid + q * kSgThreads;
            const int r = c / NP, j = c % NP * UE;
            const bool in = k0 + r < K && n0 + j < N;
            sg_copy<kUnit>(at_mn(st + AB, r, j),
                           in ? w + static_cast<size_t>(k0 + r) * N + n0 + j : w, in);
          }
        }
      }
      mma::cp_async_commit();
    };

    float acc[MB][64];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[mb][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) load(i);
    for (int i = 0; i < nc; ++i) {
      if (kTma) {
        mbar_wait(&bars[(seq + i) % ST], (seq + i) / ST & 1);  // chunk i has landed
      } else {
        mma::cp_async_wait<ST - 2>();  // this thread's copies of chunk i have landed
        wg::fence_proxy_async();       // ... and are visible to wgmma
      }
      __syncthreads();  // every thread's; chunk i - 1's stage is free
      load(i + ST - 1);
      const unsigned st = mma::smem_addr(sws + (seq + i) % ST * SB);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < kWgK / 16; ++ks) {
        // W's k16 step: 32 bytes into each n-line, or 16 k-lines down.
        const uint64_t db = kTerms == 2 ? wg::desc_sw128(st + 2 * AB + ks * 32)
                                        : wg::desc_sw128_mn(st + AB + ks * 16 * 128);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            wg::m64n128k16<kTerms == 1>(
                acc[mb], wg::desc_sw128(st + term * AB + (wgi * MB + mb) * 64 * 128 + ks * 32),
                db);
          }
        }
      }
      wg::commit();
      wg::wait_all();
    }
    mma::cp_async_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int row0 = m0 + (wgi * MB + mb) * 64 + wwarp * 16 + gr;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < M) {
            *reinterpret_cast<float2*>(part + static_cast<size_t>(row) * N + col) =
                make_float2(acc[mb][4 * j + 2 * h], acc[mb][4 * j + 2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// A step GEMM's configuration (ops/cuda/gru.py step_gemm_config): rows a
// block, K splits and chunks a split, CTAs a split, the copy unit, shared
// memory and the workspace [splits][M][N] f32.
struct StepGemmPlan {
  int bm = 0, splits = 1, per = 0, grid_tiles = 0, unit = 0, smem = 0;
  bool tma = false;  // the TMA route: every row stride a 16-byte multiple
  size_t ws_bytes = 0;
};

// The current device's SMs, read at every plan as ops/cuda/gru.py's
// card_sms reads them (so both sides plan for the same card); 0 where they
// cannot be read.
int sg_sms() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? sms : 0;
}

// The plan of p [M, N] = a @ w with `terms` A terms (1 forward, 2 reverse);
// a CUDA error code (cudaErrorInvalidValue outside the limits: an empty
// shape, K or N not a multiple of 4, terms not 1 or 2). `bm` and `splits`
// other than 0 replace the rule's rows a block and K splits (kernel_probes.cu
// plans its variants so; the package passes neither).
int step_gemm_plan(int M, int K, int N, int terms, StepGemmPlan* p, int bm = 0, int splits = 0) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0 || (terms != 1 && terms != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sg_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  StepGemmPlan q;
  q.bm = bm > 0 ? bm : terms == 1 && M > 128 ? 256 : 128;
  const long long tiles = static_cast<long long>((N + kSgTileN - 1) / kSgTileN) *
                          ((M + q.bm - 1) / q.bm);
  const int chunks = (K + kWgK - 1) / kWgK;
  int s = splits;
  if (s <= 0) {
    s = 1;
    if (tiles < sms) {
      const int by_sms = static_cast<int>(sms / tiles), by_k = chunks / kSgMinChunks;
      s = by_sms < kSgMaxSplits ? by_sms : kSgMaxSplits;
      if (by_k < s) s = by_k > 1 ? by_k : 1;
    }
  }
  q.per = (chunks + s - 1) / s;
  q.splits = (chunks + q.per - 1) / q.per;  // no split empty
  // One split: at most one CTA a SM, walking the tiles.
  q.grid_tiles = static_cast<int>(q.splits == 1 && tiles > sms ? sms : tiles);
  q.unit = K % 8 == 0 && (terms == 2 || N % 8 == 0) ? 16 : 8;
  q.tma = q.unit == 16;
  q.smem = wg_smem(q.bm, terms);
  q.ws_bytes = static_cast<size_t>(q.splits) * M * N * 4;
  *p = q;
  return 0;
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled sg_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map of `outer` rows of `inner` values, `stride` bytes
// apart, in boxes of 64 x `box_rows`, the 128-byte swizzle, zero outside.
int sg_map(CUtensorMap* m, const void* base, uint64_t inner, uint64_t outer, uint64_t stride,
           uint32_t box_rows) {
  const EncodeTiled encode = sg_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWgK), box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The TMA route's maps of a and w (StepGemmMaps), once for the many steps
// of a scan that reuse the same buffers; nothing on the cp.async route. In
// the reverse the hi box past K reads lo values into rows of W that the map
// fills with zeros, so they add nothing.
int step_gemm_maps(const StepGemmPlan& p, const void* a, const void* w, int M, int K, int N,
                   int terms, StepGemmMaps* maps) {
  *maps = StepGemmMaps{};
  if (!p.tma) return 0;
  const uint64_t ka = static_cast<uint64_t>(terms) * K;
  const int rc = sg_map(&maps->a, a, ka, M, ka * 2, p.bm);
  if (rc != 0) return rc;
  return terms == 2 ? sg_map(&maps->w, w, K, N, static_cast<uint64_t>(K) * 2, kSgTileN)
                    : sg_map(&maps->w, w, N, K, static_cast<uint64_t>(N) * 2, kWgK);
}

template <int BM, int kTerms, int kUnit, bool kTma = false>
int launch_step_gemm_variant(const StepGemmPlan& p, const StepGemmMaps& maps, const void* a,
                             const void* w, void* out, int M, int K, int N, cudaStream_t s) {
  auto kernel = step_gemm_wgmma_kernel<BM, kTerms, kUnit, kTma>;
  static unsigned long long ready = 0;  // a bit a device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready |= 1ull << dev;
  }
  kernel<<<p.grid_tiles * p.splits, kSgThreads, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), M, K, N, p.per, p.grid_tiles, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int kTerms>
int launch_step_gemm_bm(const StepGemmPlan& p, const StepGemmMaps& maps, const void* a,
                        const void* w, void* out, int M, int K, int N, cudaStream_t s) {
  return p.tma ? launch_step_gemm_variant<BM, kTerms, 16, true>(p, maps, a, w, out, M, K, N, s)
               : launch_step_gemm_variant<BM, kTerms, 8>(p, maps, a, w, out, M, K, N, s);
}

// Launch a planned step GEMM on `s` into the workspace `out` (plan.ws_bytes
// bytes), the TMA route through `maps` (step_gemm_maps of the same a and
// w); a CUDA error code. a and w must be aligned to the plan's unit.
int launch_step_gemm(const StepGemmPlan& p, const StepGemmMaps& maps, const void* a,
                     const void* w, void* out, int M, int K, int N, int terms, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w)) % p.unit != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (terms == 2) return launch_step_gemm_bm<128, 2>(p, maps, a, w, out, M, K, N, s);
  return p.bm == 256 ? launch_step_gemm_bm<256, 1>(p, maps, a, w, out, M, K, N, s)
                     : launch_step_gemm_bm<128, 1>(p, maps, a, w, out, M, K, N, s);
}

}  // namespace
}  // namespace rnn
