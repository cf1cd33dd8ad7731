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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

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
// Above Dh = 256, both dtypes: the Dh-sliced layout
// ---------------------------------------------------------------------------
//
// Past kMaxDh neither design above holds a query tile's O accumulator (nor,
// in bf16, Q's fragments) on chip. The sliced kernels add a third grid axis:
// slice z of the output's columns, [256 z, 256 z + 256). Each CTA computes
// the whole of S = Q K^T for its (query tile, b n) pair, over all of Dh, in
// chunks of kSlChunk columns of Q and K staged together through a two-stage
// cp.async ring (as the head's K split stages its chunks), keeps the online
// softmax's m and l, and accumulates O only over its own slice of V's
// columns (V's slice of a key tile staged beside the chunks). Every slice
// runs the same S code over the same chunks in the same order, so every
// slice gets the same m and l bits, and the output is the same bits from run
// to run. The simple cost: S is computed once a slice (ceil(Dh / 256) times).
// Columns past Dh are zero-filled in shared memory, rows past T as above.
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

// The head dim the bf16 kernel pads Dh to.
int padded_head_dim(int Dh) {
  int d = 16;
  while (d < Dh) d *= 2;
  return d;
}

size_t smem_bytes(int Dh, int dtype) {
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
// query tiles, the longest first across every (b, n). Above kMaxDh one more
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

}  // namespace

extern "C" {

// q, k, v: [B, T, N, Dh] of the working dtype (0 = float, 1 = bf16), Dh
// contiguous and the head stride Dh; the batch and time strides of each
// (s*_b, s*_t) in elements. `unit` (16, 8, 4 or, in bf16, 2
// bytes) is the widest that divides Dh * es, the pointers and the strides in
// bytes, as the caller computed it, checked again here. o: a contiguous
// [B, T, N, Dh]. smem_bytes as the caller computed it, checked again here.
// bf16 runs the tensor-core kernel, f32 the CUDA-core one; (Tn / 32 rounded
// up) B N < 2^31. Any Dh: above 256 the Dh-sliced layout (layout 1, as the
// caller chose it, checked again here), else the designs above (layout 0).
// Every kernel's grid is Tn-tiles x B N (x the slices above 256).
int seqrec_attention_forward(const void* q, const void* k, const void* v,
                             void* o, int B, int N, int Tn, int Dh, int dtype,
                             long long sq_b, long long sq_t, long long sk_b,
                             long long sk_t, long long sv_b, long long sv_t,
                             float scale, long long smem_bytes_in, int unit, int layout,
                             void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (B <= 0 || N <= 0 || Tn <= 0 || Dh <= 0 || (dtype != 0 && dtype != 1) ||
      (Dh > kMaxDh && layout != 1) || (Dh <= kMaxDh && layout != 0) ||
      unit < es || unit != stage_unit(Dh, es, q, k, v, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(Dh, dtype);
  if (static_cast<long long>(smem) != smem_bytes_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

const char* seqrec_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
