// Causal self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/attention.py
// (_attn_kernel via _attn_forward_pallas): the blockwise causal flash
// forward with an online softmax, which never writes the [T, T] scores.
//
// Math per query row t of one (batch, head) pair g, as _attn_kernel:
//   s_j = (q_t . k_j) * scale                     products summed in f32
//   s_j = -1e30 where j > t                        (the causal mask)
//   online over key tiles: m' = max(m, max_j s_j), a = exp(m - m'),
//   p_j = exp(s_j - m'), l = a l + sum_j p_j (the unrounded f32 p),
//   acc = a acc + sum_j round_T(p_j) v_j           (p cast to v's dtype)
//   o_t = round_T(acc / max(l, 1e-30))
//
// Layout: q, k, v are [B, T, N, Dh] views with any row strides (the slices
// of the qkv projection [B, T, 3, N, Dh] are read as they are, no copy);
// Dh is contiguous. o is a contiguous [B, T, N, Dh]. T need not be a
// multiple of the tile: rows past T are zero-filled in shared memory and
// never written, where the TPU wrapper pads T to its 128-row tile in
// device memory. Both designs below take one block per (query tile, g),
// read key tiles 0..qi only (tiles wholly above the diagonal are skipped),
// and start the blocks with the most key tiles first.
//
// What bounds it: at the training shape (B*N = 128, T = 200, Dh = 64) the
// causal products are ~0.66 GFLOP and q, k, v and o move 13 MB in bf16, so
// bytes bind at the card's rates (3.9 us); in f32 the operations do (9.8 us
// at the CUDA cores' 67 TFLOP/s). The bf16 kernel stays several times above
// its bound: the longest query tile of each (b, n) walks its 4 key tiles
// (T = 200) one after another, each a chain of loads, a barrier, mma.sync,
// shuffles and exp2, and the warp-level mma.sync path has a fraction of
// wgmma's rate; wgmma with TMA-fed tiles is the next step (PERF.md).
//
// bf16: FlashAttention-2 on the tensor cores (attention_mma_kernel). Four
// warps, each owning 16 query rows of the tile. S = Q K^T and O += P V are
// mma.sync.m16n8k16 (bf16 products, f32 sums; fragments in mma.cuh). Q's A
// fragments are loaded once with ldmatrix and stay in registers for the
// whole key loop (in shared memory above Dh = 128, where the O accumulator
// needs the registers); K's B fragments come from shared memory through
// ldmatrix, V's through ldmatrix.trans. The softmax runs on the S
// accumulators in registers (exp as exp2 of x log2 e): a row's 64 scores
// sit on the 4 lanes that share g, so its max and sum take two xor-shuffles
// each; only the diagonal tile is masked. The S accumulators of two
// n8 key blocks, rounded to bf16, are exactly the A fragment of P V for
// those 16 keys, so P never goes through shared memory. K and V tiles arrive
// by cp.async into a double-buffered ring: tile kt+1 loads while tile kt
// computes (one wait and two barriers a tile). Padding: the head dim is
// padded to kD in {16, 32, 64, 128, 256} (mma's depth is 16), with zero
// columns; rows at or past T are zero (cp.async with a source size of 0), so
// a masked score's p = 0 meets a zero v row, never garbage. Shared rows are
// kD + 8 elements long, so ldmatrix's eight 16-byte rows fall on distinct
// banks.
//
// Past Dh = 256 two layouts take over, each with a kernel a dtype: the
// Dh-cluster layout up to 2,048 (one thread block cluster of ceil(Dh / 256)
// CTAs a query tile, S computed once and its partial sums exchanged through
// distributed shared memory; bf16 on wgmma with TMA-fed tiles) and past it
// the Dh-sliced layout (one CTA a 256-column slice, S recomputed in each);
// see their sections below.
//
// f32: FlashAttention-2's structure on the CUDA cores (attention_f32_kernel),
// because TF32 tensor cores keep ~3 digits and the f32 contract is f32
// products. What bounds it at the training shape is its operations: a
// block's products are FMAs fed from shared memory, so the design counts
// shared-memory wavefronts (128 bytes a cycle an SM) against FMA issue (4
// warp instructions a cycle an SM), and the longest query tile's serial
// walk over its key tiles against the grid. A block owns 32 query rows
// (7 x 128 = 896 blocks at B*N = 128, T = 200: the 132 SMs fill, and the
// causal triangle wastes less than with 64-row tiles) and walks key tiles
// of 32. Its warps own 2 R rows each, lane (rg, c) of a warp rows
// R rg .. R rg + R - 1 of them (R = `kLR` = 4, four warps a block; 8 rows a
// lane, two warps, was slower on every shape measured: PERF.md).
// S = Q K^T: the lane's R rows against keys c and c + 16 (the 16 lanes of a
// row group share each Q read, a broadcast, and read 16 distinct K rows):
// 8 R FMAs per R + 2 float4 reads. The softmax runs on those registers (a
// row's max over its 16 lanes by xor-shuffles; the running sum l stays a
// lane's partial and is summed once at the end). P goes to a per-warp
// key-major tile in shared memory (conflict-free 16-byte stores; S
// spreads keys over lanes and P V needs them in the loop), and O += P V
// gives the lane its R rows of the float4 column groups c, c + 16, ...: a
// key's p float4s (broadcasts) and one v float4 feed 4 R FMAs. Q, and K
// and V double-buffered, arrive by cp.async: tile kt+1 loads while tile kt
// computes (one wait and one barrier a tile). Rows at or past T are zero
// in shared memory (cp.async with a source size of 0); a warp whose rows
// are all past T only helps to load.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "step_gemm.cuh"  // wgmma, mbarriers, TMA and the tensor-map encoder (rnn::)

namespace {

constexpr int kTile = 64;  // query rows per block and key rows per tile
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kWarpRows = 16;     // query rows a warp owns

// Start the copy of rows [t0, t0 + 64) of one (b, n) slice into a [64][kD + 8]
// tile in pieces of kU bytes (16, 8 or 4 by cp.async; 2, one bf16, by a
// plain load and store); rows at or past T and columns at or past Dh are
// zero-filled.
template <int kD, int kU>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride_t, int t0, int Tn,
                                           int Dh) {
  constexpr int kLd = kD + 8, kE = kU / 2, kPieces = kD / kE;  // kU-byte pieces a row
  for (int c = threadIdx.x; c < kTile * kPieces; c += kMmaThreads) {
    const int r = c / kPieces, j = (c % kPieces) * kE;
    const bool real = t0 + r < Tn && j < Dh;
    const __nv_bfloat16* from = real ? src + (t0 + r) * stride_t + j : src;
    if constexpr (kU == 16) {
      mma::cp_async16_zfill(dst + r * kLd + j, from, real ? 16 : 0);
    } else if constexpr (kU == 8) {
      mma::cp_async8_zfill(dst + r * kLd + j, from, real ? 8 : 0);
    } else if constexpr (kU == 4) {
      mma::cp_async4_zfill(dst + r * kLd + j, from, real ? 4 : 0);
    } else {
      dst[r * kLd + j] = real ? *from : __ushort_as_bfloat16(0);
    }
  }
}

// kD: the padded head dim; kQRegs: Q's fragments held in registers; kU:
// the bytes a piece of q, k and v is staged in (16 where rows, strides and
// bases are 16-byte multiples, as they always were before; else 8, 4 or 2).
template <int kD, bool kQRegs, int kU = 16>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int N, int Tn, int Dh,
                     long long sq_b, long long sq_t, long long sk_b,
                     long long sk_t, long long sv_b, long long sv_t,
                     float scale) {
  constexpr int kLd = kD + 8;  // bf16 elements a shared row
  constexpr int kKs = kD / 16;  // k16 steps of Q K^T, n16 pairs of P V
  constexpr int kTileElems = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][kLd]
  // The ring: [2 stages][K, V][64][kLd].
  __nv_bfloat16* ring = qs + kTileElems;
  auto tile_at = [&](int stage, int kv) { return ring + (stage * 2 + kv) * kTileElems; };

  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int qi = n_tiles - 1 - blockIdx.x;  // the longest tiles first
  const int g = blockIdx.y, b = g / N, n = g % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  // Column offsets of the (b, n) slice; the head stride is Dh.
  const __nv_bfloat16* qg = q + b * sq_b + static_cast<long long>(n) * Dh;
  const __nv_bfloat16* kg = k + b * sk_b + static_cast<long long>(n) * Dh;
  const __nv_bfloat16* vg = v + b * sv_b + static_cast<long long>(n) * Dh;

  auto stage_kv = [&](int kt) {  // key tile kt into stage kt % 2
    stage_tile<kD, kU>(tile_at(kt & 1, 0), kg, sk_t, kt * kTile, Tn, Dh);
    stage_tile<kD, kU>(tile_at(kt & 1, 1), vg, sv_t, kt * kTile, Tn, Dh);
  };
  stage_tile<kD, kU>(qs, qg, sq_t, qi * kTile, Tn, Dh);
  stage_kv(0);
  mma::cp_async_commit();

  // This lane's ldmatrix row addresses: A (Q) rows warp*16 + lane % 16 at
  // column 8 (lane / 16); K pairs of key blocks; V pairs of column blocks.
  const __nv_bfloat16* q_row = qs + (warp * kWarpRows + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + ((lane >> 4) << 3);
  const int q_pos = qi * kTile + warp * kWarpRows + gr;  // rows q_pos and q_pos + 8
  constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  uint32_t qf[kQRegs ? kKs : 1][4];
  float acc[2 * kKs][4];
#pragma unroll
  for (int d = 0; d < 2 * kKs; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt <= qi; ++kt) {
    if (kt < qi) stage_kv(kt + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // everything but tile kt + 1 has landed
    __syncthreads();
    if (kQRegs && kt == 0) {
#pragma unroll
      for (int s = 0; s < kKs; ++s) mma::ldmatrix_x4(qf[kQRegs ? s : 0], q_row + s * 16);
    }
    const __nv_bfloat16* kb = tile_at(kt & 1, 0);
    const __nv_bfloat16* vb = tile_at(kt & 1, 1);

    // S = Q K^T: 8 key blocks of 8, as C fragments.
    float s[8][4];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) s[jb][0] = s[jb][1] = s[jb][2] = s[jb][3] = 0.0f;
#pragma unroll
    for (int st = 0; st < kKs; ++st) {
      uint32_t a[4];
      if (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQRegs ? st : 0][e];
      } else {
        mma::ldmatrix_x4(a, q_row + st * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        mma::ldmatrix_x4(bk, kb + np * 16 * kLd + k_off + st * 16);
        mma::bf16_16x8x16(s[2 * np], a, bk[0], bk[1]);
        mma::bf16_16x8x16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Online softmax; s[jb][2 h + e] is row q_pos + 8 h, key 8 jb + 2 tq + e.
    // Only the diagonal tile (kt == qi) has keys past a row to mask.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tile_max = kNegInf;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = s[jb][2 * h + e];
          sv = kt == qi && kt * kTile + 8 * jb + 2 * tq + e > q_pos + 8 * h ? kNegInf
                                                                             : sv * scale;
          tile_max = fmaxf(tile_max, sv);
        }
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const float m_new = fmaxf(m[h], tile_max);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      const float mc = m_new * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[jb][2 * h + e], kLog2e, -mc));
          sum += p;
          s[jb][2 * h + e] = p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = alpha[h] * l[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int d = 0; d < 2 * kKs; ++d) {
      acc[d][0] *= alpha[0]; acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1]; acc[d][3] *= alpha[1];
    }

    // O += P V: the p of key blocks 2 kk and 2 kk + 1, rounded to bf16, are
    // the A fragment of keys 16 kk .. 16 kk + 15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kKs; ++dp) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(bv, vb + kk * 16 * kLd + v_off + dp * 16);
        mma::bf16_16x8x16(acc[2 * dp], pa, bv[0], bv[1]);
        mma::bf16_16x8x16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // tile kt's buffers are refilled next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q_pos + 8 * h;
    if (t >= Tn) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * Tn + t) * N + n) * Dh + 2 * tq;
#pragma unroll
    for (int d = 0; d < 2 * kKs; ++d) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(acc[d][2 * h] / denom, acc[d][2 * h + 1] / denom);
      if constexpr (kU == 16) {  // Dh % 8 == 0: whole 8-column blocks
        if (8 * d < Dh) *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) = pair;
      } else if (Dh % 2 == 0) {  // o's rows are 4-byte aligned: pairs
        if (8 * d + 2 * tq < Dh) *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) = pair;
      } else {  // an odd Dh: o's rows are 2-byte aligned, one bf16 a store
        if (8 * d + 2 * tq < Dh) orow[8 * d] = pair.x;
        if (8 * d + 2 * tq + 1 < Dh) orow[8 * d + 1] = pair.y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 32;  // query rows a block, keys a tile

// A block's layout: each lane owns kLR query rows, a warp 2 kLR rows (two
// row groups of 16 lanes), the block kF32Rows / (2 kLR) warps, and each warp
// a key-major P tile [32 keys][2 kLR + 4] (the pad keeps a quarter warp's
// 16-byte stores on distinct banks).
constexpr int kLR = 4;
constexpr int kF32WarpRows = 2 * kLR;
constexpr int kF32Warps = kF32Rows / kF32WarpRows;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kLdP = kF32WarpRows + 4;
constexpr int kPFloats = kF32Warps * kF32Rows * kLdP;

// Start the copy of rows [t0, t0 + kF32Rows) of one (b, n) slice into a
// [kF32Rows][dh4 + 4] f32 tile in pieces of kU bytes (16, 8 or 4) by
// cp.async; rows at or past T, and columns from Dh to dh4 (Dh rounded up to
// the float4 groups), are zero-filled.
template <int kU>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          long long stride_t, int t0, int Tn, int Dh,
                                          int dh4) {
  constexpr int kE = kU / 4;  // floats a piece
  const int pieces = dh4 / kE;
  for (int c = threadIdx.x; c < kF32Rows * pieces; c += blockDim.x) {
    const int r = c / pieces, j = (c - r * pieces) * kE;
    const bool real = t0 + r < Tn && (kU == 16 || j < Dh);
    const float* from = real ? src + (t0 + r) * stride_t + j : src;
    if constexpr (kU == 16) {
      mma::cp_async16_zfill(dst + r * ld + j, from, real ? 16 : 0);
    } else if constexpr (kU == 8) {
      mma::cp_async8_zfill(dst + r * ld + j, from, real ? 8 : 0);
    } else {
      mma::cp_async4_zfill(dst + r * ld + j, from, real ? 4 : 0);
    }
  }
}

// kGroups: float4 column groups of the output a lane owns (Dh <= 64 kGroups).
// kU: the bytes a piece of q, k and v is staged in (16 as before; 8 or 4
// where a row, a stride or a base is not a 16-byte multiple: Dh is then
// padded with zeros to dh4, a multiple of 4, in shared memory, and o is
// stored a float at a time). Block i takes query tile
// n_tiles - 1 - i / (B N) of (b, n) = i % (B N): the blocks with the most
// key tiles start first.
template <int kGroups, int kU = 16>
__global__ void __launch_bounds__(kF32Threads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int N,
                     int Tn, int Dh, long long sq_b, long long sq_t,
                     long long sk_b, long long sk_t, long long sv_b,
                     long long sv_t, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh4 = kU == 16 ? Dh : (Dh + 3) & ~3;  // the head dim in float4 groups
  const int ld = dh4 + 4;  // a tile row: rows 4 banks apart
  float* qs = reinterpret_cast<float*>(smem);  // [32][ld]
  float* kvs = qs + kF32Rows * ld;             // [2 stages][K, V][32][ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = kvs + 4 * kF32Rows * ld + warp * kF32Rows * kLdP;  // this warp's P
  auto tile_at = [&](int stage, int which) { return kvs + (stage * 2 + which) * kF32Rows * ld; };

  const int n_tiles = (Tn + kF32Rows - 1) / kF32Rows;
  const int groups_bn = gridDim.x / n_tiles;
  const int qi = n_tiles - 1 - static_cast<int>(blockIdx.x) / groups_bn;
  const int g = static_cast<int>(blockIdx.x) % groups_bn, b = g / N, n = g % N;
  const int rg = lane >> 4, c = lane & 15;
  const int row0 = warp * kF32WarpRows + rg * kLR;  // the lane's first row in the tile
  const int q_pos = qi * kF32Rows + row0;              // ... and in the sequence
  const bool live = qi * kF32Rows + warp * kF32WarpRows < Tn;  // a row of the warp's before T
  const int groups = dh4 / 4;
  // Column offsets of the (b, n) slice; the head stride is Dh.
  const float* qg = q + b * sq_b + static_cast<long long>(n) * Dh;
  const float* kg = k + b * sk_b + static_cast<long long>(n) * Dh;
  const float* vg = v + b * sv_b + static_cast<long long>(n) * Dh;

  auto stage_kv = [&](int kt) {  // key tile kt into stage kt % 2
    stage_f32<kU>(tile_at(kt & 1, 0), ld, kg, sk_t, kt * kF32Rows, Tn, Dh, dh4);
    stage_f32<kU>(tile_at(kt & 1, 1), ld, vg, sv_t, kt * kF32Rows, Tn, Dh, dh4);
  };
  stage_f32<kU>(qs, ld, qg, sq_t, qi * kF32Rows, Tn, Dh, dh4);
  stage_kv(0);
  mma::cp_async_commit();

  float acc[kLR][kGroups][4];
#pragma unroll
  for (int i = 0; i < kLR; ++i)
#pragma unroll
    for (int cg = 0; cg < kGroups; ++cg)
      acc[i][cg][0] = acc[i][cg][1] = acc[i][cg][2] = acc[i][cg][3] = 0.0f;
  float m[kLR], l[kLR];  // l: this lane's share of the row's sum
#pragma unroll
  for (int i = 0; i < kLR; ++i) m[i] = kNegInf, l[i] = 0.0f;

  for (int kt = 0; kt <= qi; ++kt) {
    if (kt < qi) stage_kv(kt + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // everything but tile kt + 1 has landed
    __syncthreads();
    if (live) {
      const float* kb = tile_at(kt & 1, 0);
      const float* vb = tile_at(kt & 1, 1);
      // s[i][e]: query row row0 + i against key c + 16 e of the tile.
      float s[kLR][2];
#pragma unroll
      for (int i = 0; i < kLR; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < dh4; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(kb + c * ld + d);
        const float4 k1 = *reinterpret_cast<const float4*>(kb + (c + 16) * ld + d);
#pragma unroll
        for (int i = 0; i < kLR; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (row0 + i) * ld + d);
          s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
          s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
          s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
          s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
          s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
          s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
          s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
          s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
        }
      }
      // Online softmax; only the diagonal tile (kt == qi) masks.
#pragma unroll
      for (int i = 0; i < kLR; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool masked = kt == qi && kt * kF32Rows + c + 16 * e > q_pos + i;
          s[i][e] = masked ? kNegInf : s[i][e] * scale;
        }
        float tile_max = fmaxf(s[i][0], s[i][1]);
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
        const float m_new = fmaxf(m[i], tile_max);
        const float alpha = expf(m[i] - m_new);
        s[i][0] = expf(s[i][0] - m_new);
        s[i][1] = expf(s[i][1] - m_new);
        l[i] = alpha * l[i] + (s[i][0] + s[i][1]);
        m[i] = m_new;
#pragma unroll
        for (int cg = 0; cg < kGroups; ++cg) {
          acc[i][cg][0] *= alpha; acc[i][cg][1] *= alpha;
          acc[i][cg][2] *= alpha; acc[i][cg][3] *= alpha;
        }
      }
      // P, key-major: [key][the warp's rows].
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* prow = ps + (c + 16 * e) * kLdP + kLR * rg;
#pragma unroll
        for (int i = 0; i < kLR; i += 4) {
          *reinterpret_cast<float4*>(prow + i) =
              make_float4(s[i][e], s[i + 1][e], s[i + 2][e], s[i + 3][e]);
        }
      }
      __syncwarp();
      // O += P V over the tile's 32 keys.
#pragma unroll 4
      for (int j = 0; j < kF32Rows; ++j) {
        float pr[kLR];
#pragma unroll
        for (int i = 0; i < kLR; i += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(ps + j * kLdP + kLR * rg + i);
          pr[i] = pv.x, pr[i + 1] = pv.y, pr[i + 2] = pv.z, pr[i + 3] = pv.w;
        }
#pragma unroll
        for (int cg = 0; cg < kGroups; ++cg) {
          const int grp = c + 16 * cg;
          if (grp < groups) {
            const float4 vv = *reinterpret_cast<const float4*>(vb + j * ld + 4 * grp);
#pragma unroll
            for (int i = 0; i < kLR; ++i) {
              acc[i][cg][0] = fmaf(pr[i], vv.x, acc[i][cg][0]);
              acc[i][cg][1] = fmaf(pr[i], vv.y, acc[i][cg][1]);
              acc[i][cg][2] = fmaf(pr[i], vv.z, acc[i][cg][2]);
              acc[i][cg][3] = fmaf(pr[i], vv.w, acc[i][cg][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // tile kt's stage and the P tiles are refilled next iteration
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < kLR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int t = q_pos + i;
    if (t >= Tn) continue;
    const float denom = fmaxf(sum, 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Tn + t) * N + n) * Dh;
#pragma unroll
    for (int cg = 0; cg < kGroups; ++cg) {
      const int grp = c + 16 * cg;
      if (grp < groups) {
        const float4 ov = make_float4(acc[i][cg][0] / denom, acc[i][cg][1] / denom,
                                      acc[i][cg][2] / denom, acc[i][cg][3] / denom);
        if constexpr (kU == 16) {
          *reinterpret_cast<float4*>(orow + 4 * grp) = ov;
        } else {  // the first Dh columns, a float a store
          const float vals[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * grp + e < Dh) orow[4 * grp + e] = vals[e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Above Dh = 2,048, both dtypes: the Dh-sliced layout
// ---------------------------------------------------------------------------
//
// Past kMaxDh neither design above holds a query tile's O accumulator (nor,
// in bf16, Q's fragments) on chip. From 257 to 2,048 the Dh-cluster layout
// below takes Dh; past 2,048, where a cluster would need more than 8 CTAs,
// these two kernels do. They add a third grid axis:
// slice z of the output's columns, [256 z, 256 z + 256). Each CTA computes
// the whole of S = Q K^T for its (query tile, b n) pair, over all of Dh, in
// chunks of kSlChunk columns of Q and K staged together through a two-stage
// cp.async ring (as the head's K split stages its chunks), keeps the online
// softmax's m and l, and accumulates O only over its own slice of V's
// columns (V's slice of a key tile staged beside the chunks). Every slice
// runs the same S code over the same chunks in the same order, so every
// slice gets the same m and l bits, and the output is the same bits from run
// to run. Their cost: S is computed once a slice (ceil(Dh / 256) times),
// the price of needing no cluster. Columns past Dh are zero-filled in shared
// memory, rows past T as above.
constexpr int kSliceCols = 256;  // output columns a CTA
constexpr int kSlChunk = 64;     // columns of Q and K a ring stage

// Start the copy of rows [t0, t0 + kRowsT) and columns [c0, c0 + kW) of one
// (b, n) slice into a [kRowsT][ld] tile in pieces of kU bytes (16, 8, 4 by
// cp.async; 2, one bf16, by a plain load and store); rows at or past T and
// columns at or past Dh are zero-filled. `kU` divides a head's row, so a
// piece is wholly in or wholly past Dh.
template <typename T, int kRowsT, int kW, int kU>
__device__ __forceinline__ void stage_cols(T* dst, int ld, const T* src, long long stride_t,
                                           int t0, int Tn, int c0, int Dh) {
  constexpr int kE = kU / static_cast<int>(sizeof(T)), kPieces = kW / kE;
  for (int c = threadIdx.x; c < kRowsT * kPieces; c += blockDim.x) {
    const int r = c / kPieces, j = (c % kPieces) * kE;
    const bool real = t0 + r < Tn && c0 + j < Dh;
    const T* from = real ? src + (t0 + r) * stride_t + c0 + j : src;
    if constexpr (kU == 16) {
      mma::cp_async16_zfill(dst + r * ld + j, from, real ? 16 : 0);
    } else if constexpr (kU == 8) {
      mma::cp_async8_zfill(dst + r * ld + j, from, real ? 8 : 0);
    } else if constexpr (kU == 4) {
      mma::cp_async4_zfill(dst + r * ld + j, from, real ? 4 : 0);
    } else {
      dst[r * ld + j] = real ? *from : __ushort_as_bfloat16(0);  // kU == 2: bf16 only
    }
  }
}

// bf16 sliced: attention_mma_kernel's warps, fragments, softmax and P V on a
// 256-column slice of V and O (kKs = 16 n16 pairs); S over Dh in chunks of
// 64 from the ring [2][Q, K][64][72] bf16; V's slice [64][264] bf16.
constexpr int kSlLd = kSlChunk + 8;
constexpr int kSlVLd = kSliceCols + 8;

template <int kU>
__global__ void __launch_bounds__(kMmaThreads)
attention_sliced_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int N, int Tn, int Dh,
                            long long sq_b, long long sq_t, long long sk_b,
                            long long sk_t, long long sv_b, long long sv_t,
                            float scale) {
  constexpr int kKs = kSliceCols / 16;
  constexpr int kChunkElems = kTile * kSlLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][Q, K][64][kSlLd]
  __nv_bfloat16* vs = ring + 4 * kChunkElems;                       // [64][kSlVLd]
  auto chunk_at = [&](int stage, int which) { return ring + (stage * 2 + which) * kChunkElems; };

  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int qi = n_tiles - 1 - blockIdx.x;  // the longest tiles first
  const int g = blockIdx.y, b = g / N, n = g % N;
  const int c0 = blockIdx.z * kSliceCols;  // this CTA's output columns
  const int chunks = (Dh + kSlChunk - 1) / kSlChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* qg = q + b * sq_b + static_cast<long long>(n) * Dh;
  const __nv_bfloat16* kg = k + b * sk_b + static_cast<long long>(n) * Dh;
  const __nv_bfloat16* vg = v + b * sv_b + static_cast<long long>(n) * Dh;

  auto stage_chunk = [&](int kt, int c) {  // Q's and K's columns of chunk c into stage c % 2
    stage_cols<__nv_bfloat16, kTile, kSlChunk, kU>(chunk_at(c & 1, 0), kSlLd, qg, sq_t,
                                                    qi * kTile, Tn, c * kSlChunk, Dh);
    stage_cols<__nv_bfloat16, kTile, kSlChunk, kU>(chunk_at(c & 1, 1), kSlLd, kg, sk_t,
                                                    kt * kTile, Tn, c * kSlChunk, Dh);
  };

  const int q_off = (warp * kWarpRows + (lane & 15)) * kSlLd + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * kSlLd + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kSlVLd + ((lane >> 4) << 3);
  const int q_pos = qi * kTile + warp * kWarpRows + gr;  // rows q_pos and q_pos + 8
  constexpr float kLog2e = 1.4426950408889634f;

  float acc[2 * kKs][4];
#pragma unroll
  for (int d = 0; d < 2 * kKs; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt <= qi; ++kt) {
    stage_cols<__nv_bfloat16, kTile, kSliceCols, kU>(vs, kSlVLd, vg, sv_t, kt * kTile, Tn, c0,
                                                      Dh);
    stage_chunk(kt, 0);
    mma::cp_async_commit();  // V's slice and chunk 0
    float s[8][4];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) s[jb][0] = s[jb][1] = s[jb][2] = s[jb][3] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) stage_chunk(kt, c + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();  // everything but chunk c + 1 has landed
      __syncthreads();
      const __nv_bfloat16* qb = chunk_at(c & 1, 0);
      const __nv_bfloat16* kb = chunk_at(c & 1, 1);
#pragma unroll
      for (int st = 0; st < kSlChunk / 16; ++st) {
        uint32_t a[4];
        mma::ldmatrix_x4(a, qb + q_off + st * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          mma::ldmatrix_x4(bk, kb + np * 16 * kSlLd + k_off + st * 16);
          mma::bf16_16x8x16(s[2 * np], a, bk[0], bk[1]);
          mma::bf16_16x8x16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      __syncthreads();  // stage c % 2 is refilled with chunk c + 2
    }

    // Online softmax, as attention_mma_kernel's.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tile_max = kNegInf;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = s[jb][2 * h + e];
          sv = kt == qi && kt * kTile + 8 * jb + 2 * tq + e > q_pos + 8 * h ? kNegInf
                                                                             : sv * scale;
          tile_max = fmaxf(tile_max, sv);
        }
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const float m_new = fmaxf(m[h], tile_max);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      const float mc = m_new * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[jb][2 * h + e], kLog2e, -mc));
          sum += p;
          s[jb][2 * h + e] = p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = alpha[h] * l[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int d = 0; d < 2 * kKs; ++d) {
      acc[d][0] *= alpha[0]; acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1]; acc[d][3] *= alpha[1];
    }
    // O += P V over the slice's columns (V's slice landed with chunk 0).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kKs; ++dp) {
        uint32_t bv[4];
        mma::ldmatrix_x4_trans(bv, vs + kk * 16 * kSlVLd + v_off + dp * 16);
        mma::bf16_16x8x16(acc[2 * dp], pa, bv[0], bv[1]);
        mma::bf16_16x8x16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // V's slice and chunk 0's stage are refilled next tile
  }
  mma::cp_async_wait<0>();  // no copy outlives the block (the last, empty group)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q_pos + 8 * h;
    if (t >= Tn) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * Tn + t) * N + n) * Dh + c0 + 2 * tq;
#pragma unroll
    for (int d = 0; d < 2 * kKs; ++d) {
      const int col = c0 + 8 * d + 2 * tq;  // this pair's first output column
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(acc[d][2 * h] / denom, acc[d][2 * h + 1] / denom);
      if (Dh % 2 == 0) {  // o's rows and the pair are 4-byte aligned
        if (col < Dh) *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) = pair;
      } else {  // an odd Dh: one bf16 a store
        if (col < Dh) orow[8 * d] = pair.x;
        if (col + 1 < Dh) orow[8 * d + 1] = pair.y;
      }
    }
  }
}

// f32 sliced: attention_f32_kernel's lanes, softmax, P tiles and P V on a
// 256-column slice (kGroups = 4 float4 groups a lane); S over Dh in chunks
// of 64 from the ring [2][Q, K][32][68] f32; V's slice [32][260] f32.
constexpr int kSlF32Ld = kSlChunk + 4;
constexpr int kSlF32VLd = kSliceCols + 4;

template <int kU>
__global__ void __launch_bounds__(kF32Threads)
attention_sliced_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int N,
                            int Tn, int Dh, long long sq_b, long long sq_t,
                            long long sk_b, long long sk_t, long long sv_b,
                            long long sv_t, float scale) {
  constexpr int kGroups = kSliceCols / 64;  // float4 groups a lane: c + 16 cg
  constexpr int kChunkFloats = kF32Rows * kSlF32Ld;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [2][Q, K][32][kSlF32Ld]
  float* vs = ring + 4 * kChunkFloats;           // [32][kSlF32VLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = vs + kF32Rows * kSlF32VLd + warp * kF32Rows * kLdP;  // this warp's P
  auto chunk_at = [&](int stage, int which) { return ring + (stage * 2 + which) * kChunkFloats; };

  const int n_tiles = (Tn + kF32Rows - 1) / kF32Rows;
  const int groups_bn = gridDim.x / n_tiles;
  const int qi = n_tiles - 1 - static_cast<int>(blockIdx.x) / groups_bn;
  const int g = static_cast<int>(blockIdx.x) % groups_bn, b = g / N, n = g % N;
  const int c0 = blockIdx.y * kSliceCols;
  const int chunks = (Dh + kSlChunk - 1) / kSlChunk;
  const int rg = lane >> 4, c = lane & 15;
  const int row0 = warp * kF32WarpRows + rg * kLR;
  const int q_pos = qi * kF32Rows + row0;
  const bool live = qi * kF32Rows + warp * kF32WarpRows < Tn;
  const float* qg = q + b * sq_b + static_cast<long long>(n) * Dh;
  const float* kg = k + b * sk_b + static_cast<long long>(n) * Dh;
  const float* vg = v + b * sv_b + static_cast<long long>(n) * Dh;

  auto stage_chunk = [&](int kt, int ch) {
    stage_cols<float, kF32Rows, kSlChunk, kU>(chunk_at(ch & 1, 0), kSlF32Ld, qg, sq_t,
                                              qi * kF32Rows, Tn, ch * kSlChunk, Dh);
    stage_cols<float, kF32Rows, kSlChunk, kU>(chunk_at(ch & 1, 1), kSlF32Ld, kg, sk_t,
                                              kt * kF32Rows, Tn, ch * kSlChunk, Dh);
  };

  float acc[kLR][kGroups][4];
#pragma unroll
  for (int i = 0; i < kLR; ++i)
#pragma unroll
    for (int cg = 0; cg < kGroups; ++cg)
      acc[i][cg][0] = acc[i][cg][1] = acc[i][cg][2] = acc[i][cg][3] = 0.0f;
  float m[kLR], l[kLR];
#pragma unroll
  for (int i = 0; i < kLR; ++i) m[i] = kNegInf, l[i] = 0.0f;

  for (int kt = 0; kt <= qi; ++kt) {
    stage_cols<float, kF32Rows, kSliceCols, kU>(vs, kSlF32VLd, vg, sv_t, kt * kF32Rows, Tn, c0,
                                                Dh);
    stage_chunk(kt, 0);
    mma::cp_async_commit();  // V's slice and chunk 0
    float s[kLR][2];
#pragma unroll
    for (int i = 0; i < kLR; ++i) s[i][0] = s[i][1] = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) stage_chunk(kt, ch + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();  // everything but chunk ch + 1 has landed
      __syncthreads();
      if (live) {
        const float* qb = chunk_at(ch & 1, 0);
        const float* kb = chunk_at(ch & 1, 1);
#pragma unroll 4
        for (int d = 0; d < kSlChunk; d += 4) {
          const float4 k0 = *reinterpret_cast<const float4*>(kb + c * kSlF32Ld + d);
          const float4 k1 = *reinterpret_cast<const float4*>(kb + (c + 16) * kSlF32Ld + d);
#pragma unroll
          for (int i = 0; i < kLR; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qb + (row0 + i) * kSlF32Ld + d);
            s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
            s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
            s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
            s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
            s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
            s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
            s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
            s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
          }
        }
      }
      __syncthreads();  // stage ch % 2 is refilled with chunk ch + 2
    }
    if (live) {
      // Online softmax, as attention_f32_kernel's.
#pragma unroll
      for (int i = 0; i < kLR; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool masked = kt == qi && kt * kF32Rows + c + 16 * e > q_pos + i;
          s[i][e] = masked ? kNegInf : s[i][e] * scale;
        }
        float tile_max = fmaxf(s[i][0], s[i][1]);
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
        const float m_new = fmaxf(m[i], tile_max);
        const float alpha = expf(m[i] - m_new);
        s[i][0] = expf(s[i][0] - m_new);
        s[i][1] = expf(s[i][1] - m_new);
        l[i] = alpha * l[i] + (s[i][0] + s[i][1]);
        m[i] = m_new;
#pragma unroll
        for (int cg = 0; cg < kGroups; ++cg) {
          acc[i][cg][0] *= alpha; acc[i][cg][1] *= alpha;
          acc[i][cg][2] *= alpha; acc[i][cg][3] *= alpha;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* prow = ps + (c + 16 * e) * kLdP + kLR * rg;
        *reinterpret_cast<float4*>(prow) = make_float4(s[0][e], s[1][e], s[2][e], s[3][e]);
      }
      __syncwarp();
      // O += P V over the tile's 32 keys and the slice's columns.
#pragma unroll 4
      for (int j = 0; j < kF32Rows; ++j) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + j * kLdP + kLR * rg);
        const float pr[kLR] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int cg = 0; cg < kGroups; ++cg) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * kSlF32VLd + 4 * (c + 16 * cg));
#pragma unroll
          for (int i = 0; i < kLR; ++i) {
            acc[i][cg][0] = fmaf(pr[i], vv.x, acc[i][cg][0]);
            acc[i][cg][1] = fmaf(pr[i], vv.y, acc[i][cg][1]);
            acc[i][cg][2] = fmaf(pr[i], vv.z, acc[i][cg][2]);
            acc[i][cg][3] = fmaf(pr[i], vv.w, acc[i][cg][3]);
          }
        }
      }
    }
    __syncthreads();  // V's slice, chunk 0's stage and the P tiles are refilled next tile
  }
  mma::cp_async_wait<0>();  // no copy outlives the block (the last, empty group)

  if (!live) return;
#pragma unroll
  for (int i = 0; i < kLR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int t = q_pos + i;
    if (t >= Tn) continue;
    const float denom = fmaxf(sum, 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Tn + t) * N + n) * Dh;
#pragma unroll
    for (int cg = 0; cg < kGroups; ++cg) {
      const int col = c0 + 4 * (c + 16 * cg);
      const float vals[4] = {acc[i][cg][0] / denom, acc[i][cg][1] / denom,
                             acc[i][cg][2] / denom, acc[i][cg][3] / denom};
      if constexpr (kU == 16) {  // Dh % 4 == 0: whole float4 groups, 16-byte aligned
        if (col < Dh) {
          *reinterpret_cast<float4*>(orow + col) = make_float4(vals[0], vals[1], vals[2], vals[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < Dh) orow[col + e] = vals[e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 256 < Dh <= 2,048, both dtypes: the Dh-cluster layout
// ---------------------------------------------------------------------------
//
// A thread block cluster of `slices` = ceil(Dh / 256) CTAs on neighbouring
// SMs works one (query tile, b n) item at a time; CTA rank z owns columns
// [256 z, 256 z + 256) of Q, K, V and O. Each CTA stages its Q slice once
// an item and streams only its K and V slices of each key tile through a
// two-stage ring. It computes the partial S_z = Q[:, z] K[:, z]^T over its
// own columns and publishes it in its shared memory; after a cluster
// barrier every CTA reads every rank's partial through distributed shared
// memory and sums them in rank order 0, 1, ..., so every CTA holds the same
// S bits and computes the same m, l and P bits (the determinism the sliced
// kernels above have by recomputing S in every slice). Each CTA then
// accumulates O_z += P V_z for its slice. So S is computed once in all, Q,
// K and V are read once a query tile, and the exchange costs each CTA
// slices - 1 partials of distributed reads a key tile. The slots are
// double-buffered: a CTA overwrites slot s % 2 at step s + 2 only after the
// cluster barrier of step s + 1, which every peer reaches after its reads
// of step s; one more cluster barrier ends the kernel, so no CTA leaves
// while a peer reads its slot.
//
// The clusters are persistent: as many as the card holds at once (the
// caller's `clusters`), each walking its share of the items, dealt in
// rounds forward and backward (cluster_item), with its key tiles as one
// sequence of steps through the ring and the slots: a step's loads (after
// an item's last, the next item's Q, double-buffered, and first key tile)
// are issued once the cluster barrier of the step before has freed their
// stage, and land while the rest of that step computes. The items come in
// bands of `band` (b, n) pairs, each band from its longest query tiles
// down (cluster_place); the caller picks the band (attention.py
// cluster_band) whose deal leaves the busiest cluster the fewest key tiles,
// preferring bands whose K and V stay in L2 for their shorter query tiles.
// Columns past Dh are zero in shared memory, rows past T as above. Past 8
// slices (the portable cluster size) the Dh-sliced layout above takes Dh.
//
// What bounds it: at w1's step (B = 256, T = 200, Dh = 512) the bytes (q,
// k, v and o once: 0.0626 ms in bf16) and, in f32, the operations (0.157
// ms). Neither binds: one CTA an SM runs each step's phases one after
// another (the phase clocks of kernel_probes.py attention, PERF.md): in
// bf16 the cluster barrier and the exchange's distributed reads take about
// as long as both wgmma products, and an item's epilogue (128 divides a
// thread) as long as two steps; in f32 the wait for the step's tiles and
// the two FMA phases, each held to shared memory's rate.
constexpr int kClusterMaxSlices = 8;
constexpr int kClusterMaxDh = kClusterMaxSlices * kSliceCols;

#ifdef SEQREC_ATTN_PHASE_CLOCKS
// A probe build's clocks: cycles of each phase of the cluster kernels in
// CTA 0's thread 0, summed over its steps.
__device__ unsigned long long g_attn_phase[16];
#define ATTN_PHASE_START long long phase_t = clock64()
#define ATTN_PHASE(i)                                   \
  do {                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) {          \
      const long long now = clock64();                  \
      g_attn_phase[i] += now - phase_t;                 \
      phase_t = now;                                    \
    }                                                   \
  } while (0)
#else
#define ATTN_PHASE_START
#define ATTN_PHASE(i)
#endif

namespace dsm {

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
// The address of `p` (this CTA's shared memory) in CTA `r`'s.
__device__ __forceinline__ unsigned map(const void* p, unsigned r) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(mma::smem_addr(p)), "r"(r));
  return a;
}
// The cluster barrier, every thread of every CTA: what a thread stored
// before it is visible to every thread of the cluster after it.
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ float4 load4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float load(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

}  // namespace dsm

// Item w's query tile qi and (b, n) pair g: bands of `band` pairs, each
// from its longest query tiles down, a tile of every pair of the band in
// turn.
__device__ __forceinline__ void cluster_place(int w, int band, int n_tiles, int BN, int& qi,
                                              int& g) {
  const int per = band * n_tiles, bi = w / per, r = w - bi * per;
  const int wb = min(band, BN - bi * band);
  qi = n_tiles - 1 - r / wb;
  g = bi * band + r % wb;
}

// Item j of cluster c of `clusters`, or -1 past its last: rounds of
// `clusters` items dealt forward and backward in turn, so that every
// cluster's key tiles add up to about the same.
__device__ __forceinline__ int cluster_item(int c, int j, int clusters, int items) {
  const int w = j * clusters + (j & 1 ? clusters - 1 - c : c);
  return w < items ? w : -1;
}

// bf16: one warpgroup a CTA (128 threads; 225 KB of shared memory, one CTA
// an SM). A 64-row tile's 256-column slice of Q, K or V is four atoms of 64
// lines of 128 bytes in the 128-byte swizzle (8 KB each, 1,024-byte
// aligned), written by TMA through 4-D tensor maps [B][T][N][Dh] in boxes
// of 64 rows x 64 columns (TMA zero-fills past T and Dh; lane 0 of warp a
// asks for atom a's boxes) where every row stride and base is a 16-byte
// multiple, else by cp.async in 8- or 4-byte pieces (2: plain loads) into
// the same layout; an atom wholly past Dh is zeroed once and never loaded.
// An item's output goes back the same way: into its Q buffer in Q's layout,
// then to o by TMA (the copy route stores it from registers). Partial S:
// wgmma.m64n64k16, Q (A) and K (B)
// K-major from shared memory, f32 sums, its 32 accumulators a thread laid
// out as mma.sync's C fragments (n8 block j: d[4 j + 2 h + e] = row
// 16 warp + g + 8 h, column 8 j + 2 tq + e), so the online softmax is
// attention_mma_kernel's. O += P V: wgmma.m64n256k16 with P as the register
// A operand (two n8 blocks of p rounded to bf16 are a k16 fragment, as with
// mma.sync) and V MN-major from shared memory: O, 64 rows x 256 columns, in
// the warpgroup's 128 accumulators a thread. A partial is published as 8
// float4 groups a thread, group e of thread t at [e][t], so that a warp's
// stores and its peers' loads are 512 contiguous bytes. kSwap: every
// descriptor's two byte offsets exchanged, a control that must fail its
// check (kernel_probes.py attention); never in the package.
constexpr int kClThreads = 128;
constexpr int kClAtom = kTile * 128;        // 64 lines of 64 bf16
constexpr int kClTile = 4 * kClAtom;        // a 64-row tile's slice: 32 KB
constexpr int kClSlot = kTile * kTile * 4;  // a partial S, 64 x 64 f32: 16 KB
// Q of two items, the ring [2 stages][K, V], two slots; 1,024 bytes to align.
constexpr int kClSmem = 6 * kClTile + 2 * kClSlot + 1024;

struct AttnMaps {  // the TMA route's maps of q, k, v (and bf16's o); unused on the copy route
  CUtensorMap q, k, v, o;
};

namespace wga {

// Pin the accumulators `d` here: the compiler may not move an instruction
// that defines one across a wgmma's fence or wait (ptxas serializes every
// wgmma of a stage where one does).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16) . B (16 x 64) (+ d where `accumulate`),
// both K-major from shared memory; `da` and `db` are their descriptors.
__device__ __forceinline__ void m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, f32) += A (64 x 16, bf16 fragments in registers, mma.sync's
// A layout a warp) . B (16 x 256, MN-major from shared memory).
__device__ __forceinline__ void m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %133, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(db));
}

// The box of `map` at (c0, c1, c2, c3), innermost first, from `src` (the
// box's layout in shared memory) to global memory; part of this thread's
// next bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(mma::smem_addr(src)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// This thread's bulk groups have read their shared memory (may be refilled).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// ... and have written global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The box of `map` at (c0, c1, c2, c3), innermost first, into `dst`,
// counted on `b`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(mma::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(mma::smem_addr(b)) : "memory");
}

}  // namespace wga

// Rows [t0, t0 + 64) of one (b, n) slice, columns [c0, c0 + 64 atoms), into
// the first `atoms` atoms at `dst`, in pieces of kU bytes (8 or 4 by
// cp.async; 2 by a plain load and store); rows past T and columns past Dh
// zero.
template <int kU>
__device__ __forceinline__ void cluster_stage(unsigned char* dst, const __nv_bfloat16* src,
                                              long long stride_t, int t0, int Tn, int c0, int Dh,
                                              int atoms) {
  constexpr int kE = kU / 2, kP = 64 / kE;  // values a piece, pieces an atom's line
  for (int i = threadIdx.x; i < atoms * kTile * kP; i += kClThreads) {
    const int a = i / (kTile * kP), r = i / kP % kTile, j = i % kP * kE;
    const int col = c0 + 64 * a + j;
    const bool real = t0 + r < Tn && col < Dh;
    const __nv_bfloat16* from = real ? src + (t0 + r) * stride_t + col : src;
    unsigned char* to = dst + a * kClAtom + r * 128 + (((j >> 3) ^ (r & 7)) << 4) + (j & 7) * 2;
    if constexpr (kU == 8) {
      mma::cp_async8_zfill(to, from, real ? 8 : 0);
    } else if constexpr (kU == 4) {
      mma::cp_async4_zfill(to, from, real ? 4 : 0);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(to) = real ? *from : __ushort_as_bfloat16(0);
    }
  }
}

// The bf16 Dh-cluster epilogue's quotient RN(a / den) from inv =
// RN(1 / den): q = RN(a inv), then one FMA correction (Markstein's: with
// inv = RN(1 / den) and q within an ulp, RN(q + (a - den q) inv) =
// RN(a / den)). kernel_probes_attention.cu holds it against __fdiv_rn.
__device__ __forceinline__ float markstein_quotient(float a, float den, float inv) {
  const float q0 = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q0, den, a), inv, q0);
}

template <bool kTma, int kU, bool kSwap = false>
__global__ void __launch_bounds__(kClThreads, 1)
attention_cluster_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, int BN, int N, int Tn, int Dh,
                             long long sq_b, long long sq_t, long long sk_b, long long sk_t,
                             long long sv_b, long long sv_t, float scale, int band,
                             const __grid_constant__ AttnMaps maps) {
  static_assert(kTma == (kU == 16), "TMA where every stride is a 16-byte multiple");
  extern __shared__ __align__(1024) unsigned char cl_raw[];
  unsigned char* sm = cl_raw + ((1024 - (mma::smem_addr(cl_raw) & 1023)) & 1023);
  unsigned char* qbuf = sm;                // [2 items][Q's slice]
  unsigned char* ring = sm + 2 * kClTile;  // [2 stages][K, V]
  float4* slots = reinterpret_cast<float4*>(sm + 6 * kClTile);  // [2][8 groups][128 threads]
  __shared__ __align__(8) uint64_t bars[2];  // a stage's loads (an item's Q with its tile 0)

  const unsigned z = dsm::rank(), slices = dsm::size();
  const int n_tiles = (Tn + kTile - 1) / kTile, items = n_tiles * BN;
  const int clusters = gridDim.x / slices, cid = blockIdx.x / slices;
  const int c0 = z * kSliceCols;
  const int atoms = min(4, (Dh - c0 + 63) / 64);  // this slice's atoms with a column < Dh
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;

  // The atoms wholly past Dh, in both Q buffers and every ring tile, zeroed once.
  const int past = (4 - atoms) * kClAtom / 16;  // uint4s a tile
  for (int i = tid; i < 6 * past; i += kClThreads) {
    reinterpret_cast<uint4*>(sm + i / past * kClTile + atoms * kClAtom)[i % past] =
        make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    rnn::mbar_init(&bars[0], kTma ? 1 : kClThreads);
    rnn::mbar_init(&bars[1], kTma ? 1 : kClThreads);
    rnn::mbar_init_fence();
  }
  rnn::wg::fence_proxy_async();  // the zeros, visible to TMA and wgmma
  __syncthreads();

  // Key tile kt of item w into stage `step` % 2; with kt == 0, the item's Q
  // slice into Q buffer `qslot` too.
  auto load = [&](int w, int kt, int step, int qslot) {
    int qi, g;
    cluster_place(w, band, n_tiles, BN, qi, g);
    const int b = g / N, n = g % N;
    uint64_t* bar = &bars[step & 1];
    unsigned char* qd = qbuf + qslot * kClTile;
    unsigned char* kd = ring + (step & 1) * 2 * kClTile;
    unsigned char* vd = kd + kClTile;
    if constexpr (kTma) {  // lane 0 of warp a asks for atom a's boxes
      if (tid == 0) rnn::mbar_expect(bar, (kt == 0 ? 3 : 2) * atoms * kClAtom);
      if (lane == 0 && warp < atoms) {
        const int col = c0 + 64 * warp, a = warp * kClAtom;
        if (kt == 0) wga::tma_load_4d(qd + a, &maps.q, col, n, qi * kTile, b, bar);
        wga::tma_load_4d(kd + a, &maps.k, col, n, kt * kTile, b, bar);
        wga::tma_load_4d(vd + a, &maps.v, col, n, kt * kTile, b, bar);
      }
    } else {
      const long long head = static_cast<long long>(n) * Dh;
      if (kt == 0) {
        cluster_stage<kU>(qd, q + b * sq_b + head, sq_t, qi * kTile, Tn, c0, Dh, atoms);
      }
      cluster_stage<kU>(kd, k + b * sk_b + head, sk_t, kt * kTile, Tn, c0, Dh, atoms);
      cluster_stage<kU>(vd, v + b * sv_b + head, sv_t, kt * kTile, Tn, c0, Dh, atoms);
      if constexpr (kU == 2) {
        rnn::mbar_arrive(bar);  // this thread's plain stores are done
      } else {
        rnn::cp_async_arrive(bar);  // once this thread's copies have landed
      }
    }
  };

  // K-major (Q, K): the 8-line groups 1,024 bytes apart, the leading offset
  // unused; MN-major (V): the next 64 columns 8,192 bytes on, the next 8
  // key lines 1,024.
  constexpr unsigned kLbo = kSwap ? 1024 : 16, kSbo = kSwap ? 16 : 1024;
  constexpr unsigned kVLbo = kSwap ? 1024 : 8192, kVSbo = kSwap ? 8192 : 1024;
  constexpr float kLog2e = 1.4426950408889634f;

  // The cluster walks its items (cluster_item); its key tiles are steps seq
  // of one sequence through the ring and the slots, the next step's loads
  // (the next item's Q and first tile after an item's last) in flight while
  // a step computes.
  int seq = 0;
  ATTN_PHASE_START;
  load(cid, 0, 0, 0);
  for (int it = 0, w = cid; w >= 0; w = cluster_item(cid, ++it, clusters, items)) {
    const int next = cluster_item(cid, it + 1, clusters, items);
    int qi, g;
    cluster_place(w, band, n_tiles, BN, qi, g);
    const int b = g / N, n = g % N;
    const int q_pos = qi * kTile + warp * kWarpRows + gr;  // rows q_pos and q_pos + 8
    const unsigned qa = mma::smem_addr(qbuf + (it & 1) * kClTile);
    float acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    for (int kt = 0; kt <= qi; ++kt, ++seq) {
      ATTN_PHASE(0);
      rnn::mbar_wait(&bars[seq & 1], (seq >> 1) & 1);
      ATTN_PHASE(1);
      if constexpr (!kTma) rnn::wg::fence_proxy_async();  // the landed copies, visible to wgmma
      const unsigned ka = mma::smem_addr(ring + (seq & 1) * 2 * kClTile), va = ka + kClTile;

      // The partial S_z: 4 k16 steps an atom, 32 bytes into its lines (an
      // atom past Dh is zero).
      float s[32];
      rnn::wg::fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        const unsigned off = (ks >> 2) * kClAtom + (ks & 3) * 32;
        wga::m64n64k16_ss(s, rnn::wg::desc_sw128_mn(qa + off, kLbo, kSbo),
                          rnn::wg::desc_sw128_mn(ka + off, kLbo, kSbo), ks > 0);
      }
      rnn::wg::commit();
      rnn::wg::wait_all();
      wga::fence_operands(s);
      ATTN_PHASE(2);

      // Publish it; then S = the cluster's partials summed in rank order.
      float4* slot = slots + (seq & 1) * 8 * kClThreads;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        slot[e * kClThreads + tid] =
            make_float4(s[4 * e], s[4 * e + 1], s[4 * e + 2], s[4 * e + 3]);
      }
      ATTN_PHASE(3);
      if (kTma && tid == 0) wga::bulk_wait_read();  // the last item's o has left its buffer
      dsm::sync();
      // Every warp's products of step seq - 1 are done: its stage takes
      // step seq + 1's loads (issued here, not before the barrier: 0.198
      // against 0.216 ms at w1's step, PERF.md).
      if (kt < qi) {
        load(w, kt + 1, seq + 1, 0);
      } else if (next >= 0) {
        load(next, 0, seq + 1, (it + 1) & 1);
      }
      ATTN_PHASE(4);
      for (unsigned r = 0; r < slices; ++r) {
        const unsigned base = dsm::map(slot, r) + tid * 16;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 p = r == z ? slot[e * kClThreads + tid]
                                  : dsm::load4(base + e * kClThreads * 16);
          if (r == 0) {
            s[4 * e] = p.x, s[4 * e + 1] = p.y, s[4 * e + 2] = p.z, s[4 * e + 3] = p.w;
          } else {
            s[4 * e] += p.x, s[4 * e + 1] += p.y, s[4 * e + 2] += p.z, s[4 * e + 3] += p.w;
          }
        }
      }

      ATTN_PHASE(5);
      // Online softmax, as attention_mma_kernel's; s[4 jb + 2 h + e] is row
      // q_pos + 8 h, key 8 jb + 2 tq + e of the tile.
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tile_max = kNegInf;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& sv = s[4 * jb + 2 * h + e];
            sv = kt == qi && kt * kTile + 8 * jb + 2 * tq + e > q_pos + 8 * h ? kNegInf
                                                                               : sv * scale;
            tile_max = fmaxf(tile_max, sv);
          }
        }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        const float m_new = fmaxf(m[h], tile_max);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        const float mc = m_new * kLog2e;
        float sum = 0.0f;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[4 * jb + 2 * h + e], kLog2e, -mc));
            sum += p;
            s[4 * jb + 2 * h + e] = p;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[h] = alpha[h] * l[h] + sum;
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j] *= alpha[0], acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1], acc[4 * j + 3] *= alpha[1];
      }

      // O_z += P V_z: the p of n8 blocks 2 kk and 2 kk + 1, rounded to bf16,
      // are the A fragment of keys 16 kk .. 16 kk + 15, V's lines 16 kk on.
      ATTN_PHASE(6);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = mma::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        }
      }
      wga::fence_operands(acc);
      rnn::wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wga::m64n256k16_rs(acc, pa[kk],
                           rnn::wg::desc_sw128_mn(va + kk * 16 * 128, kVLbo, kVSbo));
      }
      rnn::wg::commit();
      rnn::wg::wait_all();
      wga::fence_operands(acc);
      ATTN_PHASE(7);
    }

    // o = acc / l, each quotient correctly rounded as a divide gives it:
    // the reciprocal of l rounded once a row, then q = acc y and one FMA
    // correction (Markstein's: with y = RN(1 / l) and q within an ulp,
    // RN(q + (acc - l q) y) = RN(acc / l)), a third of a divide's work.
    float inv[2], den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      den[h] = fmaxf(l[h], 1e-30f);
      inv[h] = __frcp_rn(den[h]);
    }
    auto quotient = [&](float a, int h) { return markstein_quotient(a, den[h], inv[h]); };
    if constexpr (kTma) {
      // Into this item's Q buffer (its last S is done), in Q's layout, then
      // to o by TMA: rows past T and columns past Dh are clipped there. The
      // buffer is read by the copy until a thread 0's wait before the next
      // cluster barrier, after which the loads may refill it.
      unsigned char* ob = qbuf + (it & 1) * kClTile;
      const int r0 = warp * kWarpRows + gr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = 8 * j + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (col >> 6) * kClAtom + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) +
              (col & 7) * 2) = __floats2bfloat162_rn(quotient(acc[4 * j + 2 * h], h),
                                                     quotient(acc[4 * j + 2 * h + 1], h));
        }
      }
      rnn::wg::fence_proxy_async();  // the stores, visible to the copy
      __syncthreads();
      if (tid == 0) {
        for (int a = 0; a < atoms; ++a) {
          wga::tma_store_4d(&maps.o, ob + a * kClAtom, c0 + 64 * a, n, qi * kTile, b);
        }
        wga::bulk_commit();
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = q_pos + 8 * h;
        if (t >= Tn) continue;
        __nv_bfloat16* orow =
            o + ((static_cast<long long>(b) * Tn + t) * N + n) * Dh + c0 + 2 * tq;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = c0 + 8 * j + 2 * tq;  // this pair's first output column
          const __nv_bfloat162 pair = __floats2bfloat162_rn(quotient(acc[4 * j + 2 * h], h),
                                                            quotient(acc[4 * j + 2 * h + 1], h));
          if (Dh % 2 == 0) {  // o's rows and the pair are 4-byte aligned
            if (col < Dh) *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = pair;
          } else {  // an odd Dh: one bf16 a store
            if (col < Dh) orow[8 * j] = pair.x;
            if (col + 1 < Dh) orow[8 * j + 1] = pair.y;
          }
        }
      }
    }
    ATTN_PHASE(8);
  }
  if (kTma && tid == 0) wga::bulk_wait();  // the last o written
  dsm::sync();  // no CTA leaves while a peer may still read its slot
}

// f32: 16 warps a CTA (512 threads; 224 KB of shared memory, one CTA an
// SM), attention_f32_kernel's FlashAttention-2 structure on the CUDA cores
// (32-row query tiles, key tiles of 32, f32 FMAs, no TF32) with each key
// tile's work split over the block three ways: the partial S_z as four
// 64-column quarters, each on four warps in attention_f32_kernel's lanes
// (4 rows x 2 keys a lane), summed in quarter order into the CTA's partial;
// the softmax a row to 16 lanes (keys c and c + 16); O += P V as 8 rows x
// 4 columns a thread, the tile's 32 keys halved between the block's two
// halves, whose sums are added at the end. A 32-row tile's 256-column slice
// of Q, K or V is eight chunks of 32 lines of 128 bytes (32 floats) in the
// 128-byte swizzle (float4 p of line r at p ^ r % 8: the 16 rows a K read
// takes and the 32 columns a V read takes fall on distinct banks), written
// by TMA through 4-D tensor maps in boxes of 32 rows x 32 columns where
// every row stride and base is a 16-byte multiple, else by cp.async in 8-
// or 4-byte pieces; a chunk wholly past Dh is zeroed once and never
// loaded. K and V double-buffered, Q double-buffered across items.
constexpr int kClF32Threads = 512;
constexpr int kClF32Chunk = kF32Rows * 32;        // floats of a chunk: 4 KB
constexpr int kClF32Tile = 8 * kClF32Chunk;       // a 32-row tile's slice: 32 KB
constexpr int kClPLd = kF32Rows + 4;              // a quarter partial's row, and P's
// Q of two items, the ring [2 stages][K, V], four quarter partials, two
// slots, P and two rows of 32 (a row's rescale, its sum); 1,024 bytes to
// align.
constexpr int kClF32Floats = 6 * kClF32Tile + 4 * kF32Rows * kClPLd + 2 * kF32Rows * kF32Rows +
                             kF32Rows * kClPLd + 2 * kF32Rows + 256;

// The float (row, col) of a swizzled f32 tile.
__device__ __forceinline__ int sw32(int row, int col) {
  return (col >> 5) * kClF32Chunk + row * 32 + ((((col & 31) >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// Rows [t0, t0 + 32) of one (b, n) slice, columns [c0, c0 + 32 chunks),
// into the first `chunks` chunks at `dst` in pieces of kU bytes (8 or 4)
// by cp.async; rows past T and columns past Dh zero.
template <int kU>
__device__ __forceinline__ void cluster_stage_f32(float* dst, const float* src,
                                                  long long stride_t, int t0, int Tn, int c0,
                                                  int Dh, int chunks) {
  constexpr int kE = kU / 4, kP = 32 / kE;  // floats a piece, pieces a chunk's line
  for (int i = threadIdx.x; i < chunks * kF32Rows * kP; i += kClF32Threads) {
    const int a = i / (kF32Rows * kP), r = i / kP % kF32Rows, j = i % kP * kE;
    const int col = c0 + 32 * a + j;
    const bool real = t0 + r < Tn && col < Dh;
    const float* from = real ? src + (t0 + r) * stride_t + col : src;
    float* to = dst + sw32(r, 32 * a + j);
    if constexpr (kU == 8) {
      mma::cp_async8_zfill(to, from, real ? 8 : 0);
    } else {
      mma::cp_async4_zfill(to, from, real ? 4 : 0);
    }
  }
}

template <int kU>
__global__ void __launch_bounds__(kClF32Threads, 1)
attention_cluster_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, int BN, int N,
                             int Tn, int Dh, long long sq_b, long long sq_t, long long sk_b,
                             long long sk_t, long long sv_b, long long sv_t, float scale,
                             int band, const __grid_constant__ AttnMaps maps) {
  constexpr bool kTma = kU == 16;
  extern __shared__ __align__(1024) float cf_raw[];
  float* cf = cf_raw + ((1024 - (mma::smem_addr(cf_raw) & 1023)) & 1023) / 4;
  float* qbuf = cf;                                  // [2 items][Q's slice]
  float* ring = qbuf + 2 * kClF32Tile;               // [2 stages][K, V]
  float* quarters = ring + 4 * kClF32Tile;           // [4][32 rows][kClPLd]
  float* slots = quarters + 4 * kF32Rows * kClPLd;   // [2][32 rows][32 keys]
  float* ps = slots + 2 * kF32Rows * kF32Rows;       // P, key-major: [32 keys][kClPLd]
  float* alphas = ps + kF32Rows * kClPLd;            // a row's rescale this tile
  float* ls = alphas + kF32Rows;                     // a row's sum at the end
  __shared__ __align__(8) uint64_t bars[2];  // a stage's loads (an item's Q with its tile 0)

  const unsigned z = dsm::rank(), slices = dsm::size();
  const int n_tiles = (Tn + kF32Rows - 1) / kF32Rows, items = n_tiles * BN;
  const int clusters = gridDim.x / slices, cid = blockIdx.x / slices;
  const int c0 = z * kSliceCols;
  const int chunks = min(8, (Dh - c0 + 31) / 32);  // this slice's chunks with a column < Dh
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // S: quarter qq of the columns, attention_f32_kernel's lane (rg, c) of it.
  const int qq = warp >> 2, rg = lane >> 4, c = lane & 15;
  const int row0 = (warp & 3) * kF32WarpRows + rg * kLR;
  // The softmax: row sr, keys sc and sc + 16.
  const int sr = tid >> 4, sc = tid & 15;
  // P V: key half kh, rows 8 pr .. 8 pr + 7, columns 4 cg .. 4 cg + 3.
  const int kh = tid >> 8, pr = (tid >> 6) & 3, cg = tid & 63;

  // The chunks wholly past Dh, in both Q buffers and every ring tile, zeroed once.
  const int past = (8 - chunks) * kClF32Chunk / 4;  // float4s a tile
  for (int i = tid; i < 6 * past; i += kClF32Threads) {
    reinterpret_cast<float4*>(cf + i / past * kClF32Tile + chunks * kClF32Chunk)[i % past] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (tid == 0) {
    rnn::mbar_init(&bars[0], kTma ? 1 : kClF32Threads);
    rnn::mbar_init(&bars[1], kTma ? 1 : kClF32Threads);
    rnn::mbar_init_fence();
  }
  rnn::wg::fence_proxy_async();  // the zeros, before any TMA
  __syncthreads();

  // Key tile kt of item w into stage `step` % 2; with kt == 0, the item's Q
  // slice into Q buffer `qslot` too.
  auto load = [&](int w, int kt, int step, int qslot) {
    int qi, g;
    cluster_place(w, band, n_tiles, BN, qi, g);
    const int b = g / N, n = g % N;
    uint64_t* bar = &bars[step & 1];
    float* qd = qbuf + qslot * kClF32Tile;
    float* kd = ring + (step & 1) * 2 * kClF32Tile;
    float* vd = kd + kClF32Tile;
    if constexpr (kTma) {  // lane 0 of warp a asks for chunk a's boxes
      if (tid == 0) rnn::mbar_expect(bar, (kt == 0 ? 3 : 2) * chunks * kClF32Chunk * 4);
      if (lane == 0 && warp < chunks) {
        const int col = c0 + 32 * warp, a = warp * kClF32Chunk;
        if (kt == 0) wga::tma_load_4d(qd + a, &maps.q, col, n, qi * kF32Rows, b, bar);
        wga::tma_load_4d(kd + a, &maps.k, col, n, kt * kF32Rows, b, bar);
        wga::tma_load_4d(vd + a, &maps.v, col, n, kt * kF32Rows, b, bar);
      }
    } else {
      const long long head = static_cast<long long>(n) * Dh;
      if (kt == 0) {
        cluster_stage_f32<kU>(qd, q + b * sq_b + head, sq_t, qi * kF32Rows, Tn, c0, Dh, chunks);
      }
      cluster_stage_f32<kU>(kd, k + b * sk_b + head, sk_t, kt * kF32Rows, Tn, c0, Dh, chunks);
      cluster_stage_f32<kU>(vd, v + b * sv_b + head, sv_t, kt * kF32Rows, Tn, c0, Dh, chunks);
      rnn::cp_async_arrive(bar);  // once this thread's copies have landed
    }
  };

  // The cluster walks its items (cluster_item); its key tiles are steps seq
  // of one sequence through the ring and the slots, the next step's loads
  // (the next item's Q and first tile after an item's last) in flight while
  // a step computes.
  int seq = 0;
  ATTN_PHASE_START;
  load(cid, 0, 0, 0);
  for (int it = 0, w = cid; w >= 0; w = cluster_item(cid, ++it, clusters, items)) {
    const int next = cluster_item(cid, it + 1, clusters, items);
    int qi, g;
    cluster_place(w, band, n_tiles, BN, qi, g);
    const int b = g / N, n = g % N;
    const float* qs = qbuf + (it & 1) * kClF32Tile;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    float m = kNegInf, l = 0.0f;  // row sr's running max; this lane's share of its sum

    for (int kt = 0; kt <= qi; ++kt, ++seq) {
      __syncthreads();  // every thread is past step seq - 1's P V: its stage is free
      ATTN_PHASE(9);
      if (kt < qi) {
        load(w, kt + 1, seq + 1, 0);
      } else if (next >= 0) {
        load(next, 0, seq + 1, (it + 1) & 1);
      }
      rnn::mbar_wait(&bars[seq & 1], (seq >> 1) & 1);
      ATTN_PHASE(10);
      const float* kb = ring + (seq & 1) * 2 * kClF32Tile;
      const float* vb = kb + kClF32Tile;
      {  // this quarter's partial: rows row0 .. row0 + 3 against keys c and c + 16
        float s[kLR][2];
#pragma unroll
        for (int i = 0; i < kLR; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 4
        for (int d = 64 * qq; d < 64 * qq + 64; d += 4) {
          const float4 k0 = *reinterpret_cast<const float4*>(kb + sw32(c, d));
          const float4 k1 = *reinterpret_cast<const float4*>(kb + sw32(c + 16, d));
#pragma unroll
          for (int i = 0; i < kLR; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + sw32(row0 + i, d));
            s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
            s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
            s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
            s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
            s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
            s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
            s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
            s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
          }
        }
        float* qp = quarters + qq * kF32Rows * kClPLd;
#pragma unroll
        for (int i = 0; i < kLR; ++i) {
          qp[(row0 + i) * kClPLd + c] = s[i][0];
          qp[(row0 + i) * kClPLd + c + 16] = s[i][1];
        }
      }
      ATTN_PHASE(11);
      __syncthreads();
      // The CTA's partial, quarters summed in order, into slot seq % 2.
      float* slot = slots + (seq & 1) * kF32Rows * kF32Rows;
      for (int e = tid; e < kF32Rows * kF32Rows; e += kClF32Threads) {
        const float* qp = quarters + (e >> 5) * kClPLd + (e & 31);
        constexpr int kQ = kF32Rows * kClPLd;
        slot[e] = ((qp[0] + qp[kQ]) + qp[2 * kQ]) + qp[3 * kQ];
      }
      ATTN_PHASE(12);
      dsm::sync();
      ATTN_PHASE(13);
      // S: the cluster's partials summed in rank order.
      float sv[2];
      for (unsigned r = 0; r < slices; ++r) {
        const unsigned base = dsm::map(slot, r) + (sr * kF32Rows + sc) * 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = r == z ? slot[sr * kF32Rows + sc + 16 * e] : dsm::load(base + 64 * e);
          sv[e] = r == 0 ? p : sv[e] + p;
        }
      }
      // Online softmax, as attention_f32_kernel's.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool masked = kt == qi && kt * kF32Rows + sc + 16 * e > qi * kF32Rows + sr;
        sv[e] = masked ? kNegInf : sv[e] * scale;
      }
      float tile_max = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      }
      const float m_new = fmaxf(m, tile_max);
      const float alpha = expf(m - m_new);
      sv[0] = expf(sv[0] - m_new);
      sv[1] = expf(sv[1] - m_new);
      l = alpha * l + (sv[0] + sv[1]);
      m = m_new;
      ps[sc * kClPLd + sr] = sv[0];
      ps[(sc + 16) * kClPLd + sr] = sv[1];
      if (sc == 0) alphas[sr] = alpha;
      ATTN_PHASE(14);
      __syncthreads();
      // O += P V over this half's 16 keys.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = alphas[8 * pr + i];
        acc[i][0] *= a, acc[i][1] *= a, acc[i][2] *= a, acc[i][3] *= a;
      }
#pragma unroll 4
      for (int j = 16 * kh; j < 16 * kh + 16; ++j) {
        const float4 p0 = *reinterpret_cast<const float4*>(ps + j * kClPLd + 8 * pr);
        const float4 p1 = *reinterpret_cast<const float4*>(ps + j * kClPLd + 8 * pr + 4);
        const float4 vv = *reinterpret_cast<const float4*>(vb + sw32(j, 4 * cg));
        const float pj[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(pj[i], vv.x, acc[i][0]);
          acc[i][1] = fmaf(pj[i], vv.y, acc[i][1]);
          acc[i][2] = fmaf(pj[i], vv.z, acc[i][2]);
          acc[i][3] = fmaf(pj[i], vv.w, acc[i][3]);
        }
      }
      ATTN_PHASE(15);
    }

    // The item's output: the two key halves' sums added, over the row's sum.
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (sc == 0) ls[sr] = l;
    __syncthreads();  // every thread is past the last P V: its K tile is free
    // The second half's sums in the last step's K tile, in its layout: the
    // sums of columns past Dh are 0, so that tile's zeroed chunks stay zero.
    float* hi = ring + ((seq - 1) & 1) * 2 * kClF32Tile;
    if (kh == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<float4*>(hi + sw32(8 * pr + i, 4 * cg)) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();
    if (kh == 0) {
      const int col = c0 + 4 * cg;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = qi * kF32Rows + 8 * pr + i;
        if (t >= Tn) continue;
        const float4 h = *reinterpret_cast<const float4*>(hi + sw32(8 * pr + i, 4 * cg));
        const float denom = fmaxf(ls[8 * pr + i], 1e-30f);
        const float vals[4] = {(acc[i][0] + h.x) / denom, (acc[i][1] + h.y) / denom,
                               (acc[i][2] + h.z) / denom, (acc[i][3] + h.w) / denom};
        float* orow = o + ((static_cast<long long>(b) * Tn + t) * N + n) * Dh;
        if constexpr (kU == 16) {  // Dh % 4 == 0: whole float4 groups, 16-byte aligned
          if (col < Dh) {
            *reinterpret_cast<float4*>(orow + col) =
                make_float4(vals[0], vals[1], vals[2], vals[3]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e < Dh) orow[col + e] = vals[e];
          }
        }
      }
    }
    rnn::wg::fence_proxy_async();  // the stores into that tile, before its next load
  }
  dsm::sync();  // no CTA leaves while a peer may still read its slot
}

// The head dim the bf16 kernel pads Dh to.
int padded_head_dim(int Dh) {
  int d = 16;
  while (d < Dh) d *= 2;
  return d;
}

// The layout a Dh takes: 0 the designs above (Dh <= 256), 2 the Dh-cluster
// layout (up to 2,048), 1 the Dh-sliced layout past it.
int layout_of(int Dh) { return Dh <= kMaxDh ? 0 : Dh <= kClusterMaxDh ? 2 : 1; }

size_t smem_bytes(int Dh, int dtype) {
  if (layout_of(Dh) == 2) {
    return dtype == 1 ? static_cast<size_t>(kClSmem) : static_cast<size_t>(kClF32Floats) * 4;
  }
  if (Dh > kMaxDh) {  // the sliced layout: the chunk ring, V's slice (and f32's P tiles)
    return dtype == 1 ? (4 * static_cast<size_t>(kTile) * kSlLd + kTile * kSlVLd) * 2
                      : (4 * static_cast<size_t>(kF32Rows) * kSlF32Ld + kF32Rows * kSlF32VLd +
                         kPFloats) * 4;
  }
  if (dtype == 1) {  // Q, and K and V double-buffered: [64][kD + 8] bf16 each
    return 5 * static_cast<size_t>(kTile) * (padded_head_dim(Dh) + 8) * 2;
  }
  // Q, K and V double-buffered: [32][dh4 + 4] f32 each (Dh rounded up to a
  // multiple of 4); the warps' P tiles.
  return (5 * static_cast<size_t>(kF32Rows) * (((Dh + 3) & ~3) + 4) + kPFloats) * 4;
}

// The bytes a piece of q, k and v is staged in: the widest of 16, 8, 4 and 2
// that divides a head's row (Dh * es), every base address and every batch
// and time stride in bytes; 0 where none does.
int stage_unit(int Dh, int es, const void* q, const void* k, const void* v, long long sq_b,
               long long sq_t, long long sk_b, long long sk_t, long long sv_b, long long sv_t) {
  return mma::copy_unit(
      static_cast<unsigned long long>(Dh * es) | reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
      static_cast<unsigned long long>((sq_b | sq_t | sk_b | sk_t | sv_b | sv_t) * es));
}

// bf16: a (64-row query tile, b n) grid; f32: one dimension of 32-row
// query tiles, the longest first across every (b, n). Past kClusterMaxDh one more
// axis: the output's 256-column slices.
template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, const void* q, const void* k,
           const void* v, void* o, int B, int N, int Tn, int Dh,
           long long sq_b, long long sq_t, long long sk_b, long long sk_t,
           long long sv_b, long long sv_t, float scale, size_t smem,
           cudaStream_t s) {
  const unsigned slices = Dh > kMaxDh ? (Dh + kSliceCols - 1) / kSliceCols : 1;
  const dim3 grid = sizeof(T) == 4
                        ? dim3(static_cast<unsigned>((Tn + kF32Rows - 1) / kF32Rows) * B * N,
                               slices)
                        : dim3((Tn + kTile - 1) / kTile, B * N, slices);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, Tn, Dh, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch `kernel` on `clusters` clusters of `slices` CTAs along x, each of
// `threads` threads with `smem` bytes of dynamic shared memory; a CUDA
// error code.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int slices, int clusters, int threads, size_t smem,
                    cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters) * slices);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// A 4-D tensor map of a [B, T, N, Dh] operand of element size `es` (2:
// bf16, 4: float; Dh contiguous, the head stride Dh, the time and batch
// strides st and sb in elements) in boxes of 128 bytes of columns x `rows`
// rows of one (b, n), the 128-byte swizzle, zero outside.
int attn_map(CUtensorMap* m, const void* base, int es, int B, int N, int Tn, int Dh,
             long long st, long long sb, int rows) {
  const rnn::EncodeTiled encode = rnn::sg_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(Tn), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Dh) * es,
                                 static_cast<cuuint64_t>(st) * es,
                                 static_cast<cuuint64_t>(sb) * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / es), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(m, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            4, const_cast<void*>(base), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The TMA route's maps of q, k and v.
int attn_maps(AttnMaps* maps, const void* q, const void* k, const void* v, int es, int B, int N,
              int Tn, int Dh, long long sq_b, long long sq_t, long long sk_b, long long sk_t,
              long long sv_b, long long sv_t, int rows) {
  int rc = attn_map(&maps->q, q, es, B, N, Tn, Dh, sq_t, sq_b, rows);
  if (rc == 0) rc = attn_map(&maps->k, k, es, B, N, Tn, Dh, sk_t, sk_b, rows);
  if (rc == 0) rc = attn_map(&maps->v, v, es, B, N, Tn, Dh, sv_t, sv_b, rows);
  return rc;
}

// The Dh-cluster layout in bf16: the maps (TMA route), then `clusters`
// persistent clusters over the (64-row query tile, b n) items.
template <bool kTma, int kU, bool kSwap = false>
int launch_cluster_bf16(const void* q, const void* k, const void* v, void* o, int B, int N,
                        int Tn, int Dh, long long sq_b, long long sq_t, long long sk_b,
                        long long sk_t, long long sv_b, long long sv_t, float scale, int band,
                        int clusters, cudaStream_t s) {
  AttnMaps maps{};
  if constexpr (kTma) {
    int rc = attn_maps(&maps, q, k, v, 2, B, N, Tn, Dh, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t,
                       kTile);
    if (rc == 0) {
      rc = attn_map(&maps.o, o, 2, B, N, Tn, Dh, static_cast<long long>(N) * Dh,
                    static_cast<long long>(Tn) * N * Dh, kTile);
    }
    if (rc != 0) return rc;
  }
  using bf = __nv_bfloat16;
  return launch_clusters(attention_cluster_mma_kernel<kTma, kU, kSwap>,
                         (Dh + kSliceCols - 1) / kSliceCols, clusters, kClThreads, kClSmem, s,
                         static_cast<const bf*>(q), static_cast<const bf*>(k),
                         static_cast<const bf*>(v), static_cast<bf*>(o), B * N, N, Tn, Dh, sq_b,
                         sq_t, sk_b, sk_t, sv_b, sv_t, scale, band, maps);
}

// The Dh-cluster layout in f32: the maps (TMA route), then `clusters`
// persistent clusters over the (32-row query tile, b n) items.
template <int kU>
int launch_cluster_f32(const void* q, const void* k, const void* v, void* o, int B, int N,
                       int Tn, int Dh, long long sq_b, long long sq_t, long long sk_b,
                       long long sk_t, long long sv_b, long long sv_t, float scale, int band,
                       int clusters, cudaStream_t s) {
  AttnMaps maps{};
  if constexpr (kU == 16) {
    const int rc = attn_maps(&maps, q, k, v, 4, B, N, Tn, Dh, sq_b, sq_t, sk_b, sk_t, sv_b,
                             sv_t, kF32Rows);
    if (rc != 0) return rc;
  }
  return launch_clusters(attention_cluster_f32_kernel<kU>, (Dh + kSliceCols - 1) / kSliceCols,
                         clusters, kClF32Threads, static_cast<size_t>(kClF32Floats) * 4, s,
                         static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<float*>(o), B * N, N, Tn, Dh,
                         sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, scale, band, maps);
}

}  // namespace

extern "C" {

// q, k, v: [B, T, N, Dh] of the working dtype (0 = float, 1 = bf16), Dh
// contiguous and the head stride Dh; the batch and time strides of each
// (s*_b, s*_t) in elements. `unit` (16, 8, 4 or, in bf16, 2
// bytes) is the widest that divides Dh * es, the pointers and the strides in
// bytes, as the caller computed it, checked again here. o: a contiguous
// [B, T, N, Dh]. smem_bytes as the caller computed it, checked again here.
// bf16 runs the tensor-core kernel, f32 the CUDA-core one; (Tn / 32 rounded
// up) B N slices < 2^31. Any Dh: the designs above up to 256 (layout 0),
// the Dh-cluster layout up to 2,048 (layout 2), the Dh-sliced layout past
// it (layout 1), as the caller chose it (layout_of), checked again here.
// The designs' grids are Tn-tiles x B N (x the slices past 2,048); the
// cluster layout's `clusters` clusters of slices CTAs (1 .. its items,
// Tn-tiles x B N; as many as the card holds at once, the caller's
// seqrec_attention_max_active_clusters) walk the items in bands of `band`
// (1 .. B N) pairs; both are read by layout 2 only.
int seqrec_attention_forward(const void* q, const void* k, const void* v,
                             void* o, int B, int N, int Tn, int Dh, int dtype,
                             long long sq_b, long long sq_t, long long sk_b,
                             long long sk_t, long long sv_b, long long sv_t,
                             float scale, long long smem_bytes_in, int unit, int layout,
                             int band, int clusters, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  const long long items = static_cast<long long>((Tn + (dtype == 1 ? kTile : kF32Rows) - 1) /
                                                 (dtype == 1 ? kTile : kF32Rows)) * B * N;
  if (B <= 0 || N <= 0 || Tn <= 0 || Dh <= 0 || (dtype != 0 && dtype != 1) ||
      layout != layout_of(Dh) ||
      (layout == 2 && (band < 1 || band > B * N || clusters < 1 || clusters > items)) ||
      unit < es || unit != stage_unit(Dh, es, q, k, v, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(Dh, dtype);
  if (static_cast<long long>(smem) != smem_bytes_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEQREC_CLUSTER_ARGS \
  q, k, v, o, B, N, Tn, Dh, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, scale, band, clusters, s
  if (layout == 2) {  // the Dh-cluster layout
    switch (dtype * 100 + unit) {
      case 16: return launch_cluster_f32<16>(SEQREC_CLUSTER_ARGS);
      case 8: return launch_cluster_f32<8>(SEQREC_CLUSTER_ARGS);
      case 4: return launch_cluster_f32<4>(SEQREC_CLUSTER_ARGS);
      case 116: return launch_cluster_bf16<true, 16>(SEQREC_CLUSTER_ARGS);
      case 108: return launch_cluster_bf16<false, 8>(SEQREC_CLUSTER_ARGS);
      case 104: return launch_cluster_bf16<false, 4>(SEQREC_CLUSTER_ARGS);
      case 102: return launch_cluster_bf16<false, 2>(SEQREC_CLUSTER_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef SEQREC_CLUSTER_ARGS
#define SEQREC_ATTN_ARGS q, k, v, o, B, N, Tn, Dh, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, scale, smem, s
  if (Dh > kMaxDh) {  // the Dh-sliced layout
    using bf = __nv_bfloat16;
    switch (dtype * 100 + unit) {
      case 16: return launch<float>(attention_sliced_f32_kernel<16>, kF32Threads, SEQREC_ATTN_ARGS);
      case 8: return launch<float>(attention_sliced_f32_kernel<8>, kF32Threads, SEQREC_ATTN_ARGS);
      case 4: return launch<float>(attention_sliced_f32_kernel<4>, kF32Threads, SEQREC_ATTN_ARGS);
      case 116: return launch<bf>(attention_sliced_mma_kernel<16>, kMmaThreads, SEQREC_ATTN_ARGS);
      case 108: return launch<bf>(attention_sliced_mma_kernel<8>, kMmaThreads, SEQREC_ATTN_ARGS);
      case 104: return launch<bf>(attention_sliced_mma_kernel<4>, kMmaThreads, SEQREC_ATTN_ARGS);
      case 102: return launch<bf>(attention_sliced_mma_kernel<2>, kMmaThreads, SEQREC_ATTN_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    const int groups = ((Dh + 3) / 4 + 15) / 16;  // float4 groups a lane owns
    const int g = groups <= 1 ? 1 : groups <= 2 ? 2 : 4;
    switch (g * 100 + unit) {
#define SEQREC_F32(G, U) \
  case G * 100 + U: return launch<float>(attention_f32_kernel<G, U>, kF32Threads, SEQREC_ATTN_ARGS);
      SEQREC_F32(1, 16) SEQREC_F32(1, 8) SEQREC_F32(1, 4)
      SEQREC_F32(2, 16) SEQREC_F32(2, 8) SEQREC_F32(2, 4)
      SEQREC_F32(4, 16) SEQREC_F32(4, 8) SEQREC_F32(4, 4)
#undef SEQREC_F32
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  using bf = __nv_bfloat16;
  switch (padded_head_dim(Dh) * 100 + unit) {
#define SEQREC_BF16(D, R, U) \
  case D * 100 + U: return launch<bf>(attention_mma_kernel<D, R, U>, kMmaThreads, SEQREC_ATTN_ARGS);
#define SEQREC_BF16_UNITS(D, R) \
  SEQREC_BF16(D, R, 16) SEQREC_BF16(D, R, 8) SEQREC_BF16(D, R, 4) SEQREC_BF16(D, R, 2)
    SEQREC_BF16_UNITS(16, true)
    SEQREC_BF16_UNITS(32, true)
    SEQREC_BF16_UNITS(64, true)
    SEQREC_BF16_UNITS(128, true)
    SEQREC_BF16_UNITS(256, false)
#undef SEQREC_BF16_UNITS
#undef SEQREC_BF16
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SEQREC_ATTN_ARGS
}

// The most clusters of the Dh-cluster layout at Dh (dtype 0 = float, 1 =
// bf16 on its TMA route) the current device holds at once
// (cudaOccupancyMaxActiveClusters); minus a CUDA error code where it cannot
// say (Dh outside 257 .. 2,048).
int seqrec_attention_max_active_clusters(int dtype, int Dh) {
  if (layout_of(Dh) != 2 || (dtype != 0 && dtype != 1)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (Dh + kSliceCols - 1) / kSliceCols;
  const size_t smem = smem_bytes(Dh, dtype);
  auto bf16_kernel = attention_cluster_mma_kernel<true, 16>;
  auto f32_kernel = attention_cluster_f32_kernel<16>;
  cudaError_t e = dtype == 1 ? cudaFuncSetAttribute(bf16_kernel,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem))
                             : cudaFuncSetAttribute(f32_kernel,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(slices) * 1024);
  cfg.blockDim = dim3(dtype == 1 ? kClThreads : kClF32Threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = dtype == 1 ? cudaOccupancyMaxActiveClusters(&clusters, bf16_kernel, &cfg)
                 : cudaOccupancyMaxActiveClusters(&clusters, f32_kernel, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

const char* seqrec_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
