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
// What bounds it here: bytes. At the training shape (N = 25,600 rows, S = 256,
// H = 128, bf16) the kernel must read h and pos (13.1 MB) and write 100 KB;
// the 2*N*S*H = 1.68 GFLOP are 1.7 us at the bf16 tensor-core rate against
// 4.0 us of bytes. This first version multiplies on the CUDA cores in f32
// (no tensor cores yet), so in practice the FMAs bind it.
//
// Design: one block of 8 warps owns 64 rows. The negatives are staged once
// per block into shared memory, TRANSPOSED ([H][S], in the working dtype:
// 64 KB at S=256, H=128 in bf16), with their logQ and ids; the 64 h rows
// are staged as f32. Each warp owns 8 rows; lane l owns negatives
// j = l + 32m, so a warp's reads of negT[k][j] are consecutive (no bank
// conflicts) and its reads of h[row][k] are broadcasts. Each lane keeps an
// 8 x 8 register tile of logits and folds it into a running (max, sum of
// exp) per row, 256 negatives at a time, so any S works (not only multiples
// of 8 or 32); the lanes' partial (max, sum) pairs are combined by warp
// shuffles. The positive logit is a warp-wide dot product. Rows past N are
// masked here; nothing is padded.
//
// The C interface returns cudaGetLastError() after the launch; the launch is
// asynchronous on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows per block
constexpr int kNJ = 8;                         // negatives per lane per chunk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// exp(m - M) * s, with an empty partial (m = -inf) contributing nothing.
__device__ __forceinline__ float rescale(float s, float m, float M) {
  return m == -INFINITY ? 0.0f : s * expf(m - M);
}

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

}  // namespace

extern "C" {

// h, pos [N, H], neg [S, H] of the working dtype (0 = float, 1 = bf16);
// targets [N], neg_ids [S] int32; pos_log_q [N], neg_log_q [S] float;
// nll [N] float. All contiguous. Sp = S rounded up to 32; ld = the
// transposed negatives' row stride in elements; smem_bytes as the caller
// computed it for this layout, checked again here.
int seqrec_head_forward(const void* h, const void* pos, const void* neg,
                        const void* targets, const void* neg_ids,
                        const void* pos_log_q, const void* neg_log_q, void* nll,
                        int N, int S, int Sp, int ld, int H, int dtype,
                        long long smem_bytes, void* stream) {
  const size_t es = dtype == 0 ? 4 : 2;
  if (N <= 0 || S <= 0 || H <= 0 || (dtype != 0 && dtype != 1) ||
      Sp != (S + 31) / 32 * 32 || ld < Sp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kRows) * H * 4 +
                      static_cast<size_t>(Sp) * 8 +
                      static_cast<size_t>(H) * ld * es;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = static_cast<const int*>(targets);
  const int* ni = static_cast<const int*>(neg_ids);
  const float* plq = static_cast<const float*>(pos_log_q);
  const float* nlq = static_cast<const float*>(neg_log_q);
  float* out = static_cast<float*>(nll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(h, pos, neg, t, ni, plq, nlq, out, N, S, Sp, ld, H, smem, s);
  }
  return launch<__nv_bfloat16>(h, pos, neg, t, ni, plq, nlq, out, N, S, Sp, ld, H,
                               smem, s);
}

const char* seqrec_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
