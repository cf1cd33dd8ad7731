// Causal self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/attention.py
// (_attn_kernel via _attn_forward_pallas): the blockwise causal flash
// forward with an online softmax, which never writes the [T, T] scores.
//
// Math per query row t of one (batch, head) pair g, as _attn_kernel:
//   s_j = (q_t . k_j) * scale                     f32 products and sums
//   s_j = -1e30 where j > t                        (the causal mask)
//   online over key tiles: m' = max(m, max_j s_j), a = exp(m - m'),
//   p_j = exp(s_j - m'), l = a l + sum_j p_j (f32 p),
//   acc = a acc + sum_j round_T(p_j) v_j           (p cast to v's dtype)
//   o_t = round_T(acc / max(l, 1e-30))
//
// Layout: q, k, v are [B, T, N, Dh] views with any row strides (the slices
// of the qkv projection [B, T, 3, N, Dh] are taken as they are, no copy);
// Dh is contiguous. o is a contiguous [B, T, N, Dh]. T need not be a
// multiple of the tile: rows past T are masked here, never padded in memory
// (the TPU wrapper pads T to its 128-row tile in device memory).
//
// What bounds it: at the training shape (B*N = 128, T = 200, Dh = 64) the
// causal products are ~0.66 GFLOP and q, k, v and o move 13 MB in bf16, so
// bytes bind at the card's rates (3.9 us). This first version runs its
// products in f32 on CUDA cores from shared memory and is far from that.
//
// Design: one block per (64-query tile, g), 256 threads. Thread (ty, tx) =
// (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3 of the tile: their
// scores against keys tx, tx + 16, tx + 32, tx + 48 of a key tile (a 4 x 4
// register tile: 8 float4 shared-memory reads feed 64 FMAs) and, of the
// output, the float4 column groups tx, tx + 16, ... A row's max and sum
// combine over the 16 lanes of its half-warp with four shuffles. The query
// tile, each key and value tile and the rounded probabilities (stored
// transposed, so p.v reads the four rows' p of one key as one float4) sit
// in shared memory as f32 with padded rows, so a warp's float4 reads fall on
// distinct banks or broadcast. Key tiles wholly above the diagonal are
// skipped: query tile qi reads key tiles 0..qi, and blocks with the most
// work start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows per block and key rows per tile
constexpr int kThreads = 256;  // 4 lanes per query row
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Eight (bf16) or four (f32) values of one 16-byte global load, as floats.
__device__ __forceinline__ void unpack16(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* out) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Copy rows [t0, t0 + 64) of one (b, n) slice into a padded f32 tile;
// rows at or past T are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride_t, int t0, int Tn,
                                          int Dh) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = Dh / kVec;
  for (int c = threadIdx.x; c < kTile * per_row; c += kThreads) {
    const int r = c / per_row, j = (c % per_row) * kVec;
    float v[kVec];
    if (t0 + r < Tn) {
      unpack16(src + (t0 + r) * stride_t + j, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + j + e] = v[e];
  }
}

// kGroups: float4 groups of the output columns a thread owns (Dh <= 64 kGroups).
template <typename T, int kGroups>
__global__ void __launch_bounds__(kThreads)
attention_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int N,
                         int Tn, int Dh, long long sq_b, long long sq_t,
                         long long sk_b, long long sk_t, long long sv_b,
                         long long sv_t, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 4;           // padded row of the q, k and v tiles
  constexpr int kLdP = kTile + 4;  // padded row of the probability tile
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;  // [64 keys][kLdP]: p transposed

  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int qi = n_tiles - 1 - blockIdx.x;  // the longest tiles first
  const int g = blockIdx.y, b = g / N, n = g % N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int groups = Dh / 4;
  const int q_pos = qi * kTile + 4 * ty;  // the thread's first query row
  // Column offsets of the (b, n) slice; the head stride is Dh.
  const T* qg = q + b * sq_b + static_cast<long long>(n) * Dh;
  const T* kg = k + b * sk_b + static_cast<long long>(n) * Dh;
  const T* vg = v + b * sv_b + static_cast<long long>(n) * Dh;

  load_tile(qs, ld, qg, sq_t, qi * kTile, Tn, Dh);

  float acc[4][kGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kGroups; ++c)
      acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;

  for (int kt = 0; kt <= qi; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, ld, kg, sk_t, kt * kTile, Tn, Dh);
    load_tile(vs, ld, vg, sv_t, kt * kTile, Tn, Dh);
    __syncthreads();

    // s[i][j]: query row 4 ty + i against key tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    for (int d = 0; d < Dh; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // A row's 64 scores sit on the 16 lanes of one half-warp (same ty).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = kt * kTile + tx + 16 * j;
        s[i][j] = k_pos <= q_pos + i ? s[i][j] * scale : kNegInf;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = to_f(from_f<T>(p));  // p cast to v's dtype for p.v
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        acc[i][c][0] *= alpha; acc[i][c][1] *= alpha;
        acc[i][c][2] *= alpha; acc[i][c][3] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * kLdP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();  // a row group's 16 lanes share one warp

    for (int j = 0; j < kTile; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * kLdP + 4 * ty);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = vs + j * ld;
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        const int grp = tx + 16 * c;
        if (grp < groups) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * grp);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (q_pos + i < Tn) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = o + ((static_cast<long long>(b) * Tn + q_pos + i) * N + n) * Dh;
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        const int grp = tx + 16 * c;
        if (grp < groups) {
#pragma unroll
          for (int e = 0; e < 4; ++e) orow[4 * grp + e] = from_f<T>(acc[i][c][e] / denom);
        }
      }
    }
  }
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int B,
             int N, int Tn, int Dh, long long sq_b, long long sq_t,
             long long sk_b, long long sk_t, long long sv_b, long long sv_t,
             float scale, size_t smem, cudaStream_t s) {
  const dim3 grid((Tn + kTile - 1) / kTile, B * N), block(kThreads);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), N, Tn, Dh, sq_b, sq_t,
        sk_b, sk_t, sv_b, sv_t, scale);
    return static_cast<int>(cudaGetLastError());
  };
  const int groups = (Dh / 4 + 15) / 16;  // float4 groups a thread owns
  if (groups <= 1) return launch(attention_forward_kernel<T, 1>);
  if (groups <= 2) return launch(attention_forward_kernel<T, 2>);
  return launch(attention_forward_kernel<T, 4>);
}

}  // namespace

extern "C" {

// q, k, v: [B, T, N, Dh] of the working dtype (0 = float, 1 = bf16), Dh
// contiguous and the head stride Dh; the batch and time strides of each
// (s*_b, s*_t) in elements, each a multiple of 16 bytes, as are the
// pointers. o: a
// contiguous [B, T, N, Dh]. smem_bytes as the caller computed it, checked
// again here.
int seqrec_attention_forward(const void* q, const void* k, const void* v,
                             void* o, int B, int N, int Tn, int Dh, int dtype,
                             long long sq_b, long long sq_t, long long sk_b,
                             long long sk_t, long long sv_b, long long sv_t,
                             float scale, long long smem_bytes, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (B <= 0 || N <= 0 || Tn <= 0 || Dh <= 0 || Dh > kMaxDh ||
      (dtype != 0 && dtype != 1) || (Dh * es) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (3 * static_cast<size_t>(kTile) * (Dh + 4) +
                       static_cast<size_t>(kTile) * (kTile + 4)) * 4;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_t<float>(q, k, v, o, B, N, Tn, Dh, sq_b, sq_t, sk_b, sk_t,
                           sv_b, sv_t, scale, smem, s);
  }
  return launch_t<__nv_bfloat16>(q, k, v, o, B, N, Tn, Dh, sq_b, sq_t, sk_b,
                                 sk_t, sv_b, sv_t, scale, smem, s);
}

const char* seqrec_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
