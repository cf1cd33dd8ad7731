// Sampled-softmax head forward for Hopper (sm_90a): per-row NLL of a
// positive against S shared negatives, never writing the [N, S] logits.
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/softmax_head.py
// (_head_kernel via _head_pallas), which keeps the [S, H] negatives in VMEM
// across a grid over row tiles and fuses the [BN, H] x [H, S] product, the
// logQ correction, the accidental-hit mask, the logsumexp and the NLL.
//
// Math per row r (as ops/reference.py::sampled_softmax_nll):
//   pos   = sum_k h[r,k] * pos[r,k] - pos_log_q[r]                (f32)
//   s_j   = sum_k h[r,k] * neg[j,k] - neg_log_q[j],  j < S        (f32 acc)
//   s_j   = -1e30 where neg_ids[j] == targets[r]   (accidental hit)
//   m     = max(max_j s_j, pos)
//   nll   = m + log(sum_j exp(s_j - m) + exp(pos - m)) - pos
//
// What bounds it in bf16: bytes. At the training shape (N = 25,600 rows,
// S = 256, H = 128) the kernel must read h and pos (13.1 MB) and write 100 KB;
// the 2*N*S*H = 1.68 GFLOP are 1.7 us at the bf16 tensor-core rate against
// 4.0 us of bytes. Two designs, chosen by dtype:
//
// bf16 (head_mma_kernel, every shipped config): FlashAttention-2's pattern
// (csrc/attention.cu) with the negatives as the keys. bf16 inputs multiply
// exactly in f32, so mma.sync.m16n8k16 with f32 sums is the TPU kernel's
// numerics. A block of 8 warps owns 128 rows, a warp 16: its h rows are A
// fragments in registers for the whole walk (loaded once from global
// memory, zero past H), and the same loads give the positive logit, an f32
// dot with pos summed over the quad of lanes that share a row. The
// negatives stream through shared memory in S-tiles of 64 rows, by
// cp.async, in a ring of three stages (tile j + 2 loads while tile j
// computes), with their ids and logQ; B fragments come by ldmatrix straight
// from the tiles' [S, H] row-major layout (rows padded by 16 bytes: no bank
// conflicts). Each tile's accumulators get -logQ and the hit mask (each
// lane keeps its two rows' targets in registers), then an online (m, l)
// per row: the tile's max over the quad by two xor-shuffles, the lane's
// partial sum rescaled, and the quad's partial sums added at the end.
// Streaming, not one staged copy per block, makes any S launchable (shared
// memory holds three tiles whatever S is) and lets two blocks share an SM;
// each block reads the negatives from L2 (13 MB over the grid at the
// training shape, N / 128 blocks), not from device memory. Columns past S
// score -inf (exp 0); rows past N are computed and never written; H pads
// with zeros to Hp in {16, 32, 64, 128, 256} (mma's depth is 16).
//
// f32 (head_f32_kernel): a SIMT GEMM, [N, H] x [H, S], on the CUDA cores
// (TF32 keeps ~3 digits and the f32 contract is f32 products), with a
// row-wise online logsumexp as its epilogue. Bound by its operations: at
// N = 25,600, S = 256, H = 128 the 1.68 GFLOP take 0.025 ms at 67 TFLOP/s,
// the 26 MB of h and pos 0.008 ms. A block owns 64 rows (128 threads,
// three blocks an SM at H <= 128, two at 256) or, at H <= 128 where N
// gives enough blocks, 128 rows (256 threads, two an SM: 200 blocks fill
// the card in one wave at N = 25,600, where 400 of 64 rows leave a second
// wave of 4) and walks all of S:
// - its h rows stay resident in shared memory for the whole walk,
//   transposed once on the way in, a k chunk with each of the first stages
//   (hT [H][rows + 4], zero past N and H: 35 KB at 64 rows and H = 128, 70
//   KB at H = 256, 68 KB at 128 rows);
// - the negatives stream through a cp.async ring in S-tiles of 128, one
//   32-deep k chunk a stage, transposed on the way in ([32][132]: 17 KB a
//   stage), so shared memory does not grow with S: any S, any H <= 256
//   with H % 4 == 0;
// - the FMAs are simt_gemm.cuh's main loop, which the f32 input projection
//   (rnn.cuh) runs too: 8 x 8 outputs a thread, 4 FMAs a float read from
//   shared memory;
// - after a tile's last chunk each thread takes -logQ, the hit mask and
//   -inf past S on its 8 x 8 logits; the 8 lanes of a warp that share 8
//   rows find each row's max and sum of exponentials by xor-shuffles, and
//   one of them, the row's owner, folds them into the row's running
//   (m, l): 2 registers a thread, not 16. At the end the warp pair's two
//   halves of S join through shared memory;
// - the positive logit is an f32 dot of h and pos, 8 lanes a row, summed
//   by shuffles, taken while the first copies are in flight.
// The negatives are read from L2 once a block (128 KB at S = 256, H = 128).
// Rows past N are computed and never written.
//
// Above H = 256 (the wide GRU4Rec's D = H = 512, and wider) neither design
// keeps a row on chip as it is: bf16 takes head_mma_ksplit_kernel (below:
// the block's h rows resident in shared memory, H walked in chunks of 128
// through the negatives' ring, each S-tile's logits summed in f32 across the
// chunks, then the same epilogue), f32 the same SIMT design on 32-row
// blocks, whose transposed h fits shared memory up to H = 1,376 (its k
// chunks are already a K split).
//
// The C interface returns cudaGetLastError() after the launch; the launch is
// asynchronous on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "simt_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32: a SIMT GEMM with an online-logsumexp epilogue
// ---------------------------------------------------------------------------

constexpr int kF32MaxH = 256;

// Shared memory of head_f32_kernel<kTileM, kTileK, kStages> at width H
// (bytes): hT, the ring, then the positive logits, the odd warps' (m, l)
// and the rows' targets.
template <int kTileM, int kTileK, int kStages>
__host__ __device__ constexpr int head_f32_smem(int H) {
  return ((H + kTileK - 1) / kTileK * kTileK * (kTileM + 4) +
          kStages * kTileK * (simt::kTileN + 4) + 4 * kTileM) * 4;
}

// l_a e^(m_a - M) + l_b e^(m_b - M), M = max(m_a, m_b), with an empty
// partial (m = -inf) contributing nothing.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float M = fmaxf(m, m2);
  l = (m == -INFINITY ? 0.0f : l * exp2f((m - M) * kLog2e)) +
      (m2 == -INFINITY ? 0.0f : l2 * exp2f((m2 - M) * kLog2e));
  m = M;
}

// kVec4: h and pos rows are read in float4s for the positive logit (H % 4
// == 0, both 16-byte aligned: every shape the kernel took before); else a
// float at a time, the same products summed in the same order.
template <int kTileM, int kTileK, int kStages, int kMinCtas, bool kVec4 = true>
__global__ void __launch_bounds__(kTileM * 2, kMinCtas)
head_f32_kernel(const float* __restrict__ h, const float* __restrict__ pos,
                const float* __restrict__ neg, const int* __restrict__ targets,
                const int* __restrict__ neg_ids, const float* __restrict__ pos_log_q,
                const float* __restrict__ neg_log_q, float* __restrict__ nll, int N, int S,
                int H) {
  constexpr int NT = kTileM * 2, LDT = kTileM + 4, LDN = simt::kTileN + 4;
  constexpr int kStage = kTileK * LDN;  // floats a stage
  extern __shared__ __align__(16) float fsm[];
  const int chunks = (H + kTileK - 1) / kTileK;
  float* hT = fsm;                                  // [chunks * kTileK][LDT]
  float* ring = hT + chunks * kTileK * LDT;         // kStages x [kTileK][LDN]
  float* pdot = ring + kStages * kStage;            // [kTileM] positive logits
  float* part = pdot + kTileM;                      // [kTileM][2] odd warps' (m, l)
  int* tgt = reinterpret_cast<int*>(part + 2 * kTileM);  // [kTileM] targets
  const int row0 = blockIdx.x * kTileM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int iters = (S + simt::kTileN - 1) / simt::kTileN * chunks;
  const simt::Place p = simt::place();

  // Iteration i: k chunk i % chunks of S-tile i / chunks; its group also
  // brings the block's h rows of chunk i while i < chunks, so the first
  // FMAs wait for one chunk of h, not all of it.
  auto stage = [&](int i) {
    if (i < chunks) {
      simt::copy_transposed<kTileM, kTileK, NT>(hT + i * kTileK * LDT, LDT, h, N, H, row0,
                                                i * kTileK);
    }
    if (i < iters) {
      simt::copy_transposed<simt::kTileN, kTileK, NT>(ring + (i % kStages) * kStage, LDN, neg,
                                                       S, H, i / chunks * simt::kTileN,
                                                       i % chunks * kTileK);
    }
    mma::cp_async_commit();  // an empty group past the last keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  // The positive logits while the copies fly: 8 lanes a row, each lane 4
  // of every 32 k, all of a warp's loads issued before its sums.
  {
    constexpr int kRowsPerWarp = kTileM / (NT / 32);  // 16
    const int sub = lane >> 3, kl = 4 * (lane & 7);
    float dot[kRowsPerWarp / 4];
#pragma unroll
    for (int g = 0; g < kRowsPerWarp / 4; ++g) {
      const int row = row0 + warp * kRowsPerWarp + 4 * g + sub;
      dot[g] = 0.0f;
      if (row < N) {
        const float* hr = h + static_cast<size_t>(row) * H;
        const float* pr = pos + static_cast<size_t>(row) * H;
#pragma unroll 2
        for (int k = kl; k < H; k += 32) {
          if constexpr (kVec4) {
            const float4 a = *reinterpret_cast<const float4*>(hr + k);
            const float4 b = *reinterpret_cast<const float4*>(pr + k);
            dot[g] = fmaf(a.x, b.x, dot[g]);
            dot[g] = fmaf(a.y, b.y, dot[g]);
            dot[g] = fmaf(a.z, b.z, dot[g]);
            dot[g] = fmaf(a.w, b.w, dot[g]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (k + e < H) dot[g] = fmaf(hr[k + e], pr[k + e], dot[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kRowsPerWarp / 4; ++g) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      const int lr = warp * kRowsPerWarp + 4 * g + sub, row = row0 + lr;
      if ((lane & 7) == 0) pdot[lr] = row < N ? dot[g] - pos_log_q[row] : 0.0f;
    }
  }

  for (int r = threadIdx.x; r < kTileM; r += NT) tgt[r] = row0 + r < N ? targets[row0 + r] : 0;
  // The 8 lanes that share 8 rows (lane / 8) each keep the running (m, l)
  // of one of them, row_of(lane % 8), over the warp's 64 columns of S.
  const int group = lane & ~7, me = lane & 7;
  float m_own = -INFINITY, l_own = 0.0f;

  float acc[8][8];
  simt::zero(acc);
  for (int i = 0; i < iters; ++i) {
    mma::cp_async_wait<kStages - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();                    // ... everyone's; chunk i - 1's stage is free
    stage(i + kStages - 1);
    const int c = i % chunks;
    simt::fma_chunk<kTileM, kTileK, LDT, LDN>(acc, hT + c * kTileK * LDT,
                                              ring + (i % kStages) * kStage, p);
    if (c != chunks - 1) continue;
    // The S-tile's logits are whole: minus logQ, the hit mask, -inf past S;
    // then, row by row, the 8 lanes' max and sum of exponentials by
    // shuffles, folded into the row owner's (m, l).
    const int col0 = i / chunks * simt::kTileN;
    float q[8];
    int id[8];
    bool in[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + simt::col_of(j, p.tn);
      in[j] = col < S;
      q[j] = in[j] ? neg_log_q[col] : 0.0f;
      id[j] = in[j] ? neg_ids[col] : 0;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int target = tgt[simt::row_of<kTileM>(r, p.tm)];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = !in[j] ? -INFINITY : (id[j] == target ? kNegInf : acc[r][j] - q[j]);
        acc[r][j] = v;
        tmax = fmaxf(tmax, v);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      const float m_old = __shfl_sync(0xffffffffu, m_own, group + r);
      const float m_new = fmaxf(m_old, tmax);  // -inf only if no column is real yet
      float sum = 0.0f;
      if (m_new != -INFINITY) {
        // The difference first: at a row of hits (v = m = -1e30) it is 0.
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += exp2f((acc[r][j] - m_new) * kLog2e);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (me == r && m_new != -INFINITY) {
        l_own = l_own * exp2f((m_old - m_new) * kLog2e) + sum;
        m_own = m_new;
      }
    }
    simt::zero(acc);
  }
  mma::cp_async_wait<0>();  // no copy outlives the block

  // Each lane owns one row's (m, l) over its warp's half of S: the odd
  // warp's half joins the even one's.
  const int lr = simt::row_of<kTileM>(me, p.tm), row = row0 + lr;
  if (warp & 1) {
    part[2 * lr] = m_own;
    part[2 * lr + 1] = l_own;
  }
  __syncthreads();
  if ((warp & 1) || row >= N) return;
  merge(m_own, l_own, part[2 * lr], part[2 * lr + 1]);
  const float pl = pdot[lr], M = fmaxf(m_own, pl);
  nll[row] = M + logf(l_own * expf(m_own - M) + expf(pl - M)) - pl;
}

// Launch variant <kTileM, kTileK, kStages, kMinCtas, kVec4> of the f32 head;
// a CUDA error code (0: launched). H <= kF32MaxH (H % 4 == 0 with kVec4), any
// S >= 1.
template <int kTileM, int kTileK, int kStages, int kMinCtas, bool kVec4 = true>
int launch_head_f32_variant(const void* h, const void* pos, const void* neg,
                            const void* targets, const void* neg_ids, const void* pos_log_q,
                            const void* neg_log_q, void* nll, int N, int S, int H,
                            cudaStream_t stream) {
  if (N <= 0 || S <= 0 || H <= 0 || (kVec4 && H % 4 != 0) || (kTileM > 32 && H > kF32MaxH)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = head_f32_smem<kTileM, kTileK, kStages>(H);
  auto kernel = head_f32_kernel<kTileM, kTileK, kStages, kMinCtas, kVec4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(N + kTileM - 1) / kTileM, kTileM * 2, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(pos),
      static_cast<const float*>(neg), static_cast<const int*>(targets),
      static_cast<const int*>(neg_ids), static_cast<const float*>(pos_log_q),
      static_cast<const float*>(neg_log_q), static_cast<float*>(nll), N, S, H);
  return static_cast<int>(cudaGetLastError());
}

// The shipped variants: 32-deep k chunks in a 2-stage ring, and 128-row
// blocks of 256 threads, two an SM (H <= 128), or 64-row blocks of 128
// threads, three an SM at H <= 128 (two at 256); registers for that many.
constexpr int kF32KChunk = 32, kF32Stages = 2;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16 * kWarps;  // rows a block: 16 a warp
constexpr int kSTile = 64;             // negatives a stage
constexpr int kHeadStages = 3;         // the negatives' ring

// A stage: the tile's negatives [kSTile][Hp + 8] bf16, then their ids
// [kSTile] int and logQ [kSTile] f32 (bytes).
__host__ __device__ constexpr int stage_bytes(int Hp) {
  return kSTile * (Hp + 8) * 2 + kSTile * 8;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// kKS: Hp / 16, the k16 steps of a row (H padded to Hp with zeros; Hp in
// {16, 32, 64, 128, 256}). kU: the bytes a negative's row is copied in
// (16 where H % 8 == 0 and the bases are 16-byte aligned, every shape the
// kernel took before; 8 or 4 by cp.async; 2, one bf16, by a plain load and
// store), and h and pos are read as bf16 pairs where kU >= 4 (H even, the
// bases 4-byte aligned), else one bf16 at a time.
template <int kKS, int kU = 16>
__global__ void __launch_bounds__(kThreads, kKS <= 8 ? 2 : 1)
head_mma_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ pos,
                const __nv_bfloat16* __restrict__ neg, const int* __restrict__ targets,
                const int* __restrict__ neg_ids, const float* __restrict__ pos_log_q,
                const float* __restrict__ neg_log_q, float* __restrict__ nll, int N, int S,
                int H) {
  constexpr int Hp = 16 * kKS, ld = Hp + 8;
  constexpr int kStage = stage_bytes(Hp);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kMmaRows + warp * 16;

  // Zero the ring once: the columns past H are never copied.
  for (int c = threadIdx.x; c < kHeadStages * kStage / 16; c += kThreads) {
    reinterpret_cast<uint4*>(smem)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int tiles = (S + kSTile - 1) / kSTile;
  constexpr int kE = kU / 2;  // bf16 a piece
  const int pieces = H / kE;  // kU-byte pieces of a negative's row
  auto stage_tile = [&](int j) {
    if (j < tiles) {
      unsigned char* st = smem + (j % kHeadStages) * kStage;
      __nv_bfloat16* ns = reinterpret_cast<__nv_bfloat16*>(st);
      for (int c = threadIdx.x; c < kSTile * pieces; c += kThreads) {
        const int r = c / pieces, k = kE * (c - r * pieces), jr = j * kSTile + r;
        const bool in = jr < S;
        const __nv_bfloat16* from = in ? neg + static_cast<size_t>(jr) * H + k : neg;
        if constexpr (kU == 16) {
          mma::cp_async16_zfill(ns + r * ld + k, from, in ? 16 : 0);
        } else if constexpr (kU == 8) {
          mma::cp_async8_zfill(ns + r * ld + k, from, in ? 8 : 0);
        } else if constexpr (kU == 4) {
          mma::cp_async4_zfill(ns + r * ld + k, from, in ? 4 : 0);
        } else {
          ns[r * ld + k] = in ? *from : __ushort_as_bfloat16(0);
        }
      }
      int* ids = reinterpret_cast<int*>(st + kSTile * ld * 2);
      float* lq = reinterpret_cast<float*>(ids + kSTile);
      for (int c = threadIdx.x; c < 2 * kSTile; c += kThreads) {
        const int r = c % kSTile, jr = j * kSTile + r;
        const bool in = jr < S;
        if (c < kSTile) {
          mma::cp_async4_zfill(ids + r, in ? neg_ids + jr : neg_ids, in ? 4 : 0);
        } else {
          mma::cp_async4_zfill(lq + r, in ? neg_log_q + jr : neg_log_q, in ? 4 : 0);
        }
      }
    }
    mma::cp_async_commit();  // an empty group past the last tile keeps the count
  };
  stage_tile(0);
  stage_tile(1);

  // The warp's h rows as A fragments (rows row0 + gr + 8 mh, register
  // 2 kh + mh of k-step st), and the positive logit's f32 products from the
  // same positions; zero past N and H.
  uint32_t a[kKS][4];
  float pdot[2] = {0.0f, 0.0f};
  int tgt[2];
#pragma unroll
  for (int mh = 0; mh < 2; ++mh) {
    const int row = row0 + gr + 8 * mh;
    const bool row_in = row < N;
    tgt[mh] = row_in ? targets[row] : 0;
#pragma unroll
    for (int st = 0; st < kKS; ++st)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int k = 16 * st + 8 * kh + 2 * tq;
        uint32_t hv = 0u, pv = 0u;
        if (row_in && k < H) {
          const size_t at = static_cast<size_t>(row) * H + k;
          if constexpr (kU >= 4) {  // H even: k + 1 < H too
            hv = *reinterpret_cast<const uint32_t*>(h + at);
            pv = *reinterpret_cast<const uint32_t*>(pos + at);
          } else {  // an element tail: k + 1 may be past H
            const unsigned short* hs = reinterpret_cast<const unsigned short*>(h + at);
            const unsigned short* ps = reinterpret_cast<const unsigned short*>(pos + at);
            const bool two = k + 1 < H;
            hv = hs[0] | (two ? static_cast<uint32_t>(hs[1]) << 16 : 0u);
            pv = ps[0] | (two ? static_cast<uint32_t>(ps[1]) << 16 : 0u);
          }
        }
        a[st][2 * kh + mh] = hv;
        pdot[mh] = fmaf(bf16_lo(hv), bf16_lo(pv), pdot[mh]);
        pdot[mh] = fmaf(bf16_hi(hv), bf16_hi(pv), pdot[mh]);
      }
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  // The lane's ldmatrix row of a tile: matrices (n-tile 2 np, k lo),
  // (2 np, k hi), (2 np + 1, k lo), (2 np + 1, k hi) from lanes 0-7, 8-15,
  // 16-23, 24-31.
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  for (int j = 0; j < tiles; ++j) {
    mma::cp_async_wait<1>();  // tile j has landed (this thread's pieces)
    __syncthreads();          // ... everyone's; tile j - 1's slot is free
    stage_tile(j + 2);
    const unsigned char* st = smem + (j % kHeadStages) * kStage;
    const __nv_bfloat16* ns = reinterpret_cast<const __nv_bfloat16*>(st);
    const int* ids = reinterpret_cast<const int*>(st + kSTile * ld * 2);
    const float* lq = reinterpret_cast<const float*>(ids + kSTile);

    float acc[kSTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kSTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int s = 0; s < kKS; ++s)
#pragma unroll
      for (int np = 0; np < kSTile / 16; ++np) {
        uint32_t b[4];
        mma::ldmatrix_x4(b, ns + 16 * np * ld + 16 * s + b_off);
        mma::bf16_16x8x16(acc[2 * np], a[s], b[0], b[1]);
        mma::bf16_16x8x16(acc[2 * np + 1], a[s], b[2], b[3]);
      }

    // Logits minus logQ, the hit mask, columns past S at -inf; then the
    // online (m, l) of the lane's two rows.
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kSTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nt + 2 * tq + e;
        const bool in = j * kSTile + c < S;
        const int id = ids[c];
        const float q = lq[c];
#pragma unroll
        for (int mh = 0; mh < 2; ++mh) {
          float v = acc[nt][2 * mh + e] - q;
          v = !in ? -INFINITY : (id == tgt[mh] ? kNegInf : v);
          acc[nt][2 * mh + e] = v;
          tmax[mh] = fmaxf(tmax[mh], v);
        }
      }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      tmax[mh] = fmaxf(tmax[mh], __shfl_xor_sync(0xffffffffu, tmax[mh], 1));
      tmax[mh] = fmaxf(tmax[mh], __shfl_xor_sync(0xffffffffu, tmax[mh], 2));
      // Every tile holds a real column, so the new max is finite. The
      // difference comes first: at a row of hits (v = m = -1e30) it is 0,
      // where v log2e - m log2e would keep m log2e's rounding (~1e23).
      const float m_new = fmaxf(m_run[mh], tmax[mh]);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kSTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += exp2f((acc[nt][2 * mh + e] - m_new) * kLog2e);
      l_run[mh] = l_run[mh] * exp2f((m_run[mh] - m_new) * kLog2e) + sum;
      m_run[mh] = m_new;
    }
  }

#pragma unroll
  for (int mh = 0; mh < 2; ++mh) {
    float l = l_run[mh], dot = pdot[mh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    const int row = row0 + gr + 8 * mh;
    if (tq == 0 && row < N) {
      const float pl = dot - pos_log_q[row];
      const float m = m_run[mh], M = fmaxf(m, pl);
      const float lse = M + logf(l * expf(m - M) + expf(pl - M));
      nll[row] = lse - pl;
    }
  }
}

template <int kKS, int kU>
int launch_mma_ks(const void* h, const void* pos, const void* neg, const int* targets,
                  const int* neg_ids, const float* pos_log_q, const float* neg_log_q,
                  float* nll, int N, int S, int H, size_t smem, cudaStream_t stream) {
  auto kernel = head_mma_kernel<kKS, kU>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kMmaRows - 1) / kMmaRows), block(kThreads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(pos),
      static_cast<const __nv_bfloat16*>(neg), targets, neg_ids, pos_log_q, neg_log_q, nll, N,
      S, H);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 above H = 256: the K split
// ---------------------------------------------------------------------------
//
// Past H = 256 a warp's h rows no longer fit its registers as A fragments
// (64 registers a lane at 256). head_mma_ksplit_kernel keeps the block's h
// rows in shared memory instead ([kKsRows][Hp + 8] bf16, Hp = H padded to
// the chunk, zero past H and N: 129 KB at Hp = 1,024) and walks H in chunks
// of kKsChunk = 128: the negatives stream through the ring as (S-tile, k
// chunk) stages of [64][128 + 8] bf16 with the tile's ids and logQ, the A
// fragments of a chunk come by ldmatrix from the resident rows, and each
// S-tile's logits accumulate in f32 across its chunks; after a tile's last
// chunk the epilogue is head_mma_kernel's (logQ, the hit mask, the online
// logsumexp), unchanged. 64 rows a block (4 warps of 16): 128 would need
// 258 KB of h at Hp = 1,024. The positive logit is an f32 dot of the
// resident h row and pos, 4 lanes a row as in head_mma_kernel.
constexpr int kKsRows = 64;
constexpr int kKsThreads = 2 * kKsRows;  // 4 warps
constexpr int kKsChunk = 128;            // k a stage
constexpr int kKsLd = kKsChunk + 8;      // bf16 a stage's row
__host__ __device__ constexpr int ksplit_stage_bytes() { return kSTile * kKsLd * 2 + kSTile * 8; }
__host__ __device__ inline int ksplit_hp(int H) { return (H + kKsChunk - 1) / kKsChunk * kKsChunk; }
__host__ __device__ inline int ksplit_smem(int H) {
  return kKsRows * (ksplit_hp(H) + 8) * 2 + kHeadStages * ksplit_stage_bytes();
}

// kU as head_mma_kernel's: the bytes a row of h, pos and the negatives is
// copied and read in (16, 8, 4 by cp.async; 2, one bf16, by plain loads).
template <int kU>
__global__ void __launch_bounds__(kKsThreads, 1)
head_mma_ksplit_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ pos,
                       const __nv_bfloat16* __restrict__ neg, const int* __restrict__ targets,
                       const int* __restrict__ neg_ids, const float* __restrict__ pos_log_q,
                       const float* __restrict__ neg_log_q, float* __restrict__ nll, int N,
                       int S, int H) {
  constexpr int kE = kU / 2;  // bf16 a piece
  const int Hp = ksplit_hp(H), ldh = Hp + 8, chunks = Hp / kKsChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kKsRows][ldh]
  unsigned char* ring = smem + kKsRows * ldh * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int blk0 = blockIdx.x * kKsRows, row0 = blk0 + warp * 16;

  // Zero the resident rows once: columns past H and rows past N stay zero.
  for (int c = threadIdx.x; c < kKsRows * ldh / 8; c += kKsThreads) {
    reinterpret_cast<uint4*>(hs)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // A piece of kU bytes from `from` (valid or not) into `to`.
  auto copy = [&](__nv_bfloat16* to, const __nv_bfloat16* from, bool in) {
    if constexpr (kU == 16) {
      mma::cp_async16_zfill(to, from, in ? 16 : 0);
    } else if constexpr (kU == 8) {
      mma::cp_async8_zfill(to, from, in ? 8 : 0);
    } else if constexpr (kU == 4) {
      mma::cp_async4_zfill(to, from, in ? 4 : 0);
    } else {
      *to = in ? *from : __ushort_as_bfloat16(0);
    }
  };
  const int row_pieces = H / kE;
  for (int c = threadIdx.x; c < kKsRows * row_pieces; c += kKsThreads) {
    const int r = c / row_pieces, k = kE * (c - r * row_pieces);
    const bool in = blk0 + r < N;
    copy(hs + r * ldh + k, in ? h + static_cast<size_t>(blk0 + r) * H + k : h, in);
  }
  const int tiles = (S + kSTile - 1) / kSTile, iters = tiles * chunks;
  // Iteration i: k chunk i % chunks of S-tile i / chunks. Pieces past H or
  // S are zero-filled: a slot holds other chunks before.
  auto stage = [&](int i) {
    if (i < iters) {
      const int j = i / chunks, k0 = (i % chunks) * kKsChunk;
      unsigned char* st = ring + (i % kHeadStages) * ksplit_stage_bytes();
      __nv_bfloat16* ns = reinterpret_cast<__nv_bfloat16*>(st);
      constexpr int kPieces = kKsChunk / kE;
      for (int c = threadIdx.x; c < kSTile * kPieces; c += kKsThreads) {
        const int r = c / kPieces, k = kE * (c - r * kPieces), jr = j * kSTile + r;
        const bool in = jr < S && k0 + k < H;
        copy(ns + r * kKsLd + k, in ? neg + static_cast<size_t>(jr) * H + k0 + k : neg, in);
      }
      int* ids = reinterpret_cast<int*>(st + kSTile * kKsLd * 2);
      float* lq = reinterpret_cast<float*>(ids + kSTile);
      for (int c = threadIdx.x; c < 2 * kSTile; c += kKsThreads) {
        const int r = c % kSTile, jr = j * kSTile + r;
        const bool in = jr < S;
        if (c < kSTile) {
          mma::cp_async4_zfill(ids + r, in ? neg_ids + jr : neg_ids, in ? 4 : 0);
        } else {
          mma::cp_async4_zfill(lq + r, in ? neg_log_q + jr : neg_log_q, in ? 4 : 0);
        }
      }
    }
    mma::cp_async_commit();  // an empty group past the last keeps the count
  };
  stage(0);  // its group carries the resident rows too
  stage(1);
  mma::cp_async_wait<1>();
  __syncthreads();

  // The positive logit: rows gr and gr + 8 of the warp, the quad's lanes
  // over k = 2 tq + 8 m (pairs) or tq + 4 m (one bf16 at a time).
  float pdot[2] = {0.0f, 0.0f};
  int tgt[2];
#pragma unroll
  for (int mh = 0; mh < 2; ++mh) {
    const int lr = warp * 16 + gr + 8 * mh, row = blk0 + lr;
    tgt[mh] = row < N ? targets[row] : 0;
    if (row >= N) continue;
    const __nv_bfloat16* hr = hs + lr * ldh;
    const __nv_bfloat16* pr = pos + static_cast<size_t>(row) * H;
    if constexpr (kU >= 4) {  // H even: pairs
      for (int k = 2 * tq; k < H; k += 8) {
        const uint32_t hv = *reinterpret_cast<const uint32_t*>(hr + k);
        const uint32_t pv = *reinterpret_cast<const uint32_t*>(pr + k);
        pdot[mh] = fmaf(bf16_lo(hv), bf16_lo(pv), pdot[mh]);
        pdot[mh] = fmaf(bf16_hi(hv), bf16_hi(pv), pdot[mh]);
      }
    } else {
      for (int k = tq; k < H; k += 4) {
        pdot[mh] = fmaf(__bfloat162float(hr[k]), __bfloat162float(pr[k]), pdot[mh]);
      }
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  const int a_off = (warp * 16 + (lane & 15)) * ldh + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kKsLd + ((lane >> 3) & 1) * 8;
  float acc[kSTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kSTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    mma::cp_async_wait<1>();  // iteration i's stage has landed (this thread's pieces)
    __syncthreads();          // ... everyone's; iteration i - 1's slot is free
    stage(i + 2);
    const int j = i / chunks, c = i % chunks;
    const unsigned char* st = ring + (i % kHeadStages) * ksplit_stage_bytes();
    const __nv_bfloat16* ns = reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
    for (int s = 0; s < kKsChunk / 16; ++s) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, hs + a_off + c * kKsChunk + 16 * s);
#pragma unroll
      for (int np = 0; np < kSTile / 16; ++np) {
        uint32_t b[4];
        mma::ldmatrix_x4(b, ns + 16 * np * kKsLd + 16 * s + b_off);
        mma::bf16_16x8x16(acc[2 * np], a, b[0], b[1]);
        mma::bf16_16x8x16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (c != chunks - 1) continue;
    // The S-tile's logits are whole: head_mma_kernel's epilogue.
    const int* ids = reinterpret_cast<const int*>(st + kSTile * kKsLd * 2);
    const float* lq = reinterpret_cast<const float*>(ids + kSTile);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kSTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * tq + e;
        const bool in = j * kSTile + col < S;
        const int id = ids[col];
        const float q = lq[col];
#pragma unroll
        for (int mh = 0; mh < 2; ++mh) {
          float v = acc[nt][2 * mh + e] - q;
          v = !in ? -INFINITY : (id == tgt[mh] ? kNegInf : v);
          acc[nt][2 * mh + e] = v;
          tmax[mh] = fmaxf(tmax[mh], v);
        }
      }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      tmax[mh] = fmaxf(tmax[mh], __shfl_xor_sync(0xffffffffu, tmax[mh], 1));
      tmax[mh] = fmaxf(tmax[mh], __shfl_xor_sync(0xffffffffu, tmax[mh], 2));
      const float m_new = fmaxf(m_run[mh], tmax[mh]);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kSTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += exp2f((acc[nt][2 * mh + e] - m_new) * kLog2e);
      l_run[mh] = l_run[mh] * exp2f((m_run[mh] - m_new) * kLog2e) + sum;
      m_run[mh] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kSTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  }
  mma::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int mh = 0; mh < 2; ++mh) {
    float l = l_run[mh], dot = pdot[mh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    const int row = row0 + gr + 8 * mh;
    if (tq == 0 && row < N) {
      const float pl = dot - pos_log_q[row];
      const float m = m_run[mh], M = fmaxf(m, pl);
      const float lse = M + logf(l * expf(m - M) + expf(pl - M));
      nll[row] = lse - pl;
    }
  }
}

template <int kU>
int launch_ksplit(const void* h, const void* pos, const void* neg, const int* targets,
                  const int* neg_ids, const float* pos_log_q, const float* neg_log_q,
                  float* nll, int N, int S, int H, int smem, cudaStream_t stream) {
  auto kernel = head_mma_ksplit_kernel<kU>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(N + kKsRows - 1) / kKsRows, kKsThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(pos),
      static_cast<const __nv_bfloat16*>(neg), targets, neg_ids, pos_log_q, neg_log_q, nll, N,
      S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The f32 design. h, pos [N, H], neg [S, H] float; targets [N], neg_ids
// [S] int32; pos_log_q [N], neg_log_q [S] float; nll [N] float. All
// contiguous; H <= 256 with 64 rows a block (H <= 128 with 128), H > 256
// with 32 (as far as hT fits shared memory); any S > 0.
// pos_unit: 16 where H % 4 == 0 and h, pos and neg are 16-byte aligned (the
// positive logit in float4s), else 4, as the caller computed it, checked
// again here. rows: 64 or 128 rows a block; smem_bytes as the caller
// computed it for this layout, checked again here.
int seqrec_head_forward(const void* h, const void* pos, const void* neg,
                        const void* targets, const void* neg_ids,
                        const void* pos_log_q, const void* neg_log_q, void* nll,
                        int N, int S, int H, int rows, long long smem_bytes, int pos_unit,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = mma::copy_unit(static_cast<unsigned long long>(H) * 4 |
                                   reinterpret_cast<uintptr_t>(h) |
                                   reinterpret_cast<uintptr_t>(pos) |
                                   reinterpret_cast<uintptr_t>(neg)) == 16;
  if (pos_unit != (vec4 ? 16 : 4) ||
      (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(pos) |
       reinterpret_cast<uintptr_t>(neg)) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SEQREC_HEAD_ARGS h, pos, neg, targets, neg_ids, pos_log_q, neg_log_q, nll, N, S, H, s
  // Above kF32MaxH: 32-row blocks, so that hT stays resident (the same
  // kernel, its k chunks the K split); at and below it the shipped variants.
  if (H > kF32MaxH && rows == 32 && head_f32_smem<32, kF32KChunk, kF32Stages>(H) <= 232448 &&
      head_f32_smem<32, kF32KChunk, kF32Stages>(H) == smem_bytes) {
    return vec4 ? launch_head_f32_variant<32, kF32KChunk, kF32Stages, 1>(SEQREC_HEAD_ARGS)
                : launch_head_f32_variant<32, kF32KChunk, kF32Stages, 1, false>(SEQREC_HEAD_ARGS);
  }
  if (H > 0 && H <= 128 && rows == 128 &&
      head_f32_smem<128, kF32KChunk, kF32Stages>(H) == smem_bytes) {
    return vec4 ? launch_head_f32_variant<128, kF32KChunk, kF32Stages, 2>(SEQREC_HEAD_ARGS)
                : launch_head_f32_variant<128, kF32KChunk, kF32Stages, 2, false>(SEQREC_HEAD_ARGS);
  }
  if (H > 0 && H <= kF32MaxH && rows == 64 &&
      head_f32_smem<64, kF32KChunk, kF32Stages>(H) == smem_bytes) {
    return vec4 ? launch_head_f32_variant<64, kF32KChunk, kF32Stages, 3>(SEQREC_HEAD_ARGS)
                : launch_head_f32_variant<64, kF32KChunk, kF32Stages, 3, false>(SEQREC_HEAD_ARGS);
  }
#undef SEQREC_HEAD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 design (tensor cores). h, pos [N, H], neg [S, H] bf16; targets
// [N], neg_ids [S] int32; pos_log_q [N], neg_log_q [S] float; nll [N]
// float. All contiguous; any H (past 256 the K split, as far as its
// resident rows fit shared memory); any S > 0. unit: the widest of 16,
// 8, 4 and 2 bytes that divides H * 2 and the bases of h, pos and neg, as
// the caller computed it, checked again here. smem_bytes (the ring: 3 stages
// of stage_bytes(Hp), Hp = H padded to 16, 32, 64, 128 or 256; past 256
// ksplit_smem(H)) as the caller computed it, checked again here.
int seqrec_head_forward_mma(const void* h, const void* pos, const void* neg,
                            const void* targets, const void* neg_ids,
                            const void* pos_log_q, const void* neg_log_q, void* nll,
                            int N, int S, int H, long long smem_bytes, int unit, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 ||
      unit != mma::copy_unit(static_cast<unsigned long long>(H) * 2 |
                             reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(pos) |
                             reinterpret_cast<uintptr_t>(neg))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H > 256) {  // the K split (head_mma_ksplit_kernel), only past 256
    const int smem = ksplit_smem(H);
    if (smem > 232448 || smem != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
    const int* t = static_cast<const int*>(targets);
    const int* ni = static_cast<const int*>(neg_ids);
    const float* plq = static_cast<const float*>(pos_log_q);
    const float* nlq = static_cast<const float*>(neg_log_q);
    float* out = static_cast<float*>(nll);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (unit) {
      case 16: return launch_ksplit<16>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
      case 8: return launch_ksplit<8>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
      case 4: return launch_ksplit<4>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
      case 2: return launch_ksplit<2>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int ks = H <= 16 ? 1 : H <= 32 ? 2 : H <= 64 ? 4 : H <= 128 ? 8 : 16;
  const size_t smem = static_cast<size_t>(kHeadStages) * stage_bytes(16 * ks);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = static_cast<const int*>(targets);
  const int* ni = static_cast<const int*>(neg_ids);
  const float* plq = static_cast<const float*>(pos_log_q);
  const float* nlq = static_cast<const float*>(neg_log_q);
  float* out = static_cast<float*>(nll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ks * 100 + unit) {
#define SEQREC_MMA(KS, U) \
  case KS * 100 + U: return launch_mma_ks<KS, U>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
#define SEQREC_MMA_UNITS(KS) SEQREC_MMA(KS, 16) SEQREC_MMA(KS, 8) SEQREC_MMA(KS, 4) SEQREC_MMA(KS, 2)
    SEQREC_MMA_UNITS(1)
    SEQREC_MMA_UNITS(2)
    SEQREC_MMA_UNITS(4)
    SEQREC_MMA_UNITS(8)
    SEQREC_MMA_UNITS(16)
#undef SEQREC_MMA_UNITS
#undef SEQREC_MMA
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* seqrec_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
