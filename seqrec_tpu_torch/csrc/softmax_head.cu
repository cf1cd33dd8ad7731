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
// What bounds it: bytes. At the training shape (N = 25,600 rows, S = 256,
// H = 128, bf16) the kernel must read h and pos (13.1 MB) and write 100 KB;
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
// f32: the CUDA-core design of the first port (head_forward_kernel), kept,
// because TF32 tensor cores keep ~3 digits and the f32 contract is f32
// products. One block of 8 warps owns 64 rows. The negatives are staged
// once per block into shared memory, TRANSPOSED ([H][S]: 128 KB at S=256,
// H=128), with their logQ and ids; the 64 h rows are staged too. Each warp
// owns 8 rows; lane l owns negatives j = l + 32m, so a warp's reads of
// negT[k][j] are consecutive (no bank conflicts) and its reads of h[row][k]
// are broadcasts. Each lane keeps an 8 x 8 register tile of logits and
// folds it into a running (max, sum of exp) per row, 256 negatives at a
// time; the lanes' partial (max, sum) pairs are combined by warp shuffles.
// The positive logit is a warp-wide dot product. Rows past N are masked
// here; nothing is padded.
//
// The C interface returns cudaGetLastError() after the launch; the launch is
// asynchronous on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows per block
constexpr int kNJ = 8;                         // negatives per lane per chunk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }

// exp(m - M) * s, with an empty partial (m = -inf) contributing nothing.
__device__ __forceinline__ float rescale(float s, float m, float M) {
  return m == -INFINITY ? 0.0f : s * expf(m - M);
}

// The f32 design (CUDA cores).
template <typename T>
__global__ void __launch_bounds__(kThreads)
head_forward_kernel(const T* __restrict__ h, const T* __restrict__ pos,
                    const T* __restrict__ neg, const int* __restrict__ targets,
                    const int* __restrict__ neg_ids,
                    const float* __restrict__ pos_log_q,
                    const float* __restrict__ neg_log_q,
                    float* __restrict__ nll, int N, int S, int Sp, int ld,
                    int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);          // [kRows][H] f32
  float* nlq = hs + kRows * H;                          // [Sp]
  int* nid = reinterpret_cast<int*>(nlq + Sp);          // [Sp]
  T* negT = reinterpret_cast<T*>(nid + Sp);             // [H][ld], ld >= Sp

  const int row0 = blockIdx.x * kRows;
  // Coalesced global reads (k fastest); the row stride ld = Sp + 4 bytes'
  // worth of elements spreads the transposed writes over the banks.
  for (int c = threadIdx.x; c < Sp * H; c += kThreads) {
    const int j = c / H, k = c - j * H;
    negT[k * ld + j] = j < S ? neg[static_cast<size_t>(j) * H + k] : zero<T>();
  }
  for (int j = threadIdx.x; j < Sp; j += kThreads) {
    nlq[j] = j < S ? neg_log_q[j] : 0.0f;
    nid[j] = j < S ? neg_ids[j] : 0;
  }
  for (int c = threadIdx.x; c < kRows * H; c += kThreads) {
    const int r = c / H, k = c - r * H;
    const int row = row0 + r;
    hs[c] = row < N ? to_f(h[static_cast<size_t>(row) * H + k]) : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr0 = warp * kRowsPerWarp;  // this warp's first local row
  if (row0 + lr0 >= N) return;          // no barrier follows

  int tgt[kRowsPerWarp];
  float m_run[kRowsPerWarp], s_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + lr0 + r;
    tgt[r] = row < N ? targets[row] : 0;
    m_run[r] = -INFINITY;
    s_run[r] = 0.0f;
  }

  for (int jb = 0; jb < Sp; jb += 32 * kNJ) {
    float acc[kRowsPerWarp][kNJ];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int m = 0; m < kNJ; ++m) acc[r][m] = 0.0f;

    for (int k = 0; k < H; ++k) {
      float nv[kNJ];
#pragma unroll
      for (int m = 0; m < kNJ; ++m) {
        const int j = jb + 32 * m + lane;
        nv[m] = (jb + 32 * m < Sp) ? to_f(negT[k * ld + j]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float hv = hs[(lr0 + r) * H + k];
#pragma unroll
        for (int m = 0; m < kNJ; ++m) acc[r][m] = fmaf(hv, nv[m], acc[r][m]);
      }
    }

#pragma unroll
    for (int m = 0; m < kNJ; ++m) {
      const int j = jb + 32 * m + lane;
      if (j >= S) continue;
      const float q = nlq[j];
      const int id = nid[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float v = id == tgt[r] ? kNegInf : acc[r][m] - q;
        if (v > m_run[r]) {
          s_run[r] = rescale(s_run[r], m_run[r], v) + 1.0f;
          m_run[r] = v;
        } else {
          s_run[r] += expf(v - m_run[r]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    // Combine the lanes' (max, sum) pairs.
    float m = m_run[r], s = s_run[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      const float M = fmaxf(m, m2);
      s = rescale(s, m, M) + rescale(s2, m2, M);
      m = M;
    }
    const int row = row0 + lr0 + r;
    if (row >= N) continue;  // uniform across the warp
    float dot = 0.0f;
    const T* p = pos + static_cast<size_t>(row) * H;
    for (int k = lane; k < H; k += 32) dot = fmaf(hs[(lr0 + r) * H + k], to_f(p[k]), dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float pl = dot - pos_log_q[row];
    const float M = fmaxf(m, pl);
    const float lse = M + logf(rescale(s, m, M) + expf(pl - M));
    if (lane == 0) nll[row] = lse - pl;
  }
}

template <typename T>
int launch(const void* h, const void* pos, const void* neg, const int* targets,
           const int* neg_ids, const float* pos_log_q, const float* neg_log_q,
           float* nll, int N, int S, int Sp, int ld, int H, size_t smem,
           cudaStream_t stream) {
  auto kernel = head_forward_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kRows - 1) / kRows), block(kThreads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(pos),
      static_cast<const T*>(neg), targets, neg_ids, pos_log_q, neg_log_q, nll,
      N, S, Sp, ld, H);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16 * kWarps;  // rows a block: 16 a warp
constexpr int kSTile = 64;             // negatives a stage
constexpr int kHeadStages = 3;         // the negatives' ring
constexpr float kLog2e = 1.4426950408889634f;

// A stage: the tile's negatives [kSTile][Hp + 8] bf16, then their ids
// [kSTile] int and logQ [kSTile] f32 (bytes).
__host__ __device__ constexpr int stage_bytes(int Hp) {
  return kSTile * (Hp + 8) * 2 + kSTile * 8;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// kKS: Hp / 16, the k16 steps of a row (H padded to Hp with zeros; Hp in
// {16, 32, 64, 128, 256}).
template <int kKS>
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
  const int pieces = H / 8;  // 16-byte pieces of a negative's row
  auto stage_tile = [&](int j) {
    if (j < tiles) {
      unsigned char* st = smem + (j % kHeadStages) * kStage;
      __nv_bfloat16* ns = reinterpret_cast<__nv_bfloat16*>(st);
      for (int c = threadIdx.x; c < kSTile * pieces; c += kThreads) {
        const int r = c / pieces, k = 8 * (c - r * pieces), jr = j * kSTile + r;
        const bool in = jr < S;
        mma::cp_async16_zfill(ns + r * ld + k, in ? neg + static_cast<size_t>(jr) * H + k : neg,
                              in ? 16 : 0);
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
          hv = *reinterpret_cast<const uint32_t*>(h + at);
          pv = *reinterpret_cast<const uint32_t*>(pos + at);
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

template <int kKS>
int launch_mma_ks(const void* h, const void* pos, const void* neg, const int* targets,
                  const int* neg_ids, const float* pos_log_q, const float* neg_log_q,
                  float* nll, int N, int S, int H, size_t smem, cudaStream_t stream) {
  auto kernel = head_mma_kernel<kKS>;
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

}  // namespace

extern "C" {

// The f32 design. h, pos [N, H], neg [S, H] float (dtype 0); targets [N],
// neg_ids [S] int32; pos_log_q [N], neg_log_q [S] float; nll [N] float. All
// contiguous. Sp = S rounded up to 32; ld = the transposed negatives' row
// stride in elements; smem_bytes as the caller computed it for this layout,
// checked again here.
int seqrec_head_forward(const void* h, const void* pos, const void* neg,
                        const void* targets, const void* neg_ids,
                        const void* pos_log_q, const void* neg_log_q, void* nll,
                        int N, int S, int Sp, int ld, int H, int dtype,
                        long long smem_bytes, void* stream) {
  const size_t es = 4;
  if (N <= 0 || S <= 0 || H <= 0 || dtype != 0 || Sp != (S + 31) / 32 * 32 || ld < Sp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kRows) * H * 4 +
                      static_cast<size_t>(Sp) * 8 +
                      static_cast<size_t>(H) * ld * es;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<float>(h, pos, neg, static_cast<const int*>(targets),
                       static_cast<const int*>(neg_ids), static_cast<const float*>(pos_log_q),
                       static_cast<const float*>(neg_log_q), static_cast<float*>(nll), N, S,
                       Sp, ld, H, smem, static_cast<cudaStream_t>(stream));
}

// The bf16 design (tensor cores). h, pos [N, H], neg [S, H] bf16; targets
// [N], neg_ids [S] int32; pos_log_q [N], neg_log_q [S] float; nll [N]
// float. All contiguous, 16-byte aligned; H % 8 == 0, H <= 256; any S > 0.
// smem_bytes (the ring: 3 stages of stage_bytes(Hp), Hp = H padded to 16,
// 32, 64, 128 or 256) as the caller computed it, checked again here.
int seqrec_head_forward_mma(const void* h, const void* pos, const void* neg,
                            const void* targets, const void* neg_ids,
                            const void* pos_log_q, const void* neg_log_q, void* nll,
                            int N, int S, int H, long long smem_bytes, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || H % 8 != 0 || H > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
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
  switch (ks) {
    case 1: return launch_mma_ks<1>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
    case 2: return launch_mma_ks<2>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
    case 4: return launch_mma_ks<4>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
    case 8: return launch_mma_ks<8>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
    case 16: return launch_mma_ks<16>(h, pos, neg, t, ni, plq, nlq, out, N, S, H, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* seqrec_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
