// GRU scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/gru.py (_gru_step_body via
// _gru_forward_pallas, no-reset variant), which walks a sequential grid over
// T with h and both weight matrices held in VMEM and the input projection
// x[t] @ W_x computed inside each step.
//
// Math per step (gate blocks r|z|n, as ops/reference.py::gru_scan):
//   xp = x[t] @ W_x + b_x,  hp = h @ W_h + b_h          (f32 accumulation)
//   r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n),  h' = (1 - z) * n + z * h  (f32 gate math)
//   h' is rounded to the working dtype T (float or bf16) every step, is
//   written to ys[:, t], and is the next step's h.
//
// What bounds it here: neither bytes nor operations. At the serving shape
// (B=64, T=200, D=H=128) the scan reads 3.3 MB and does 2.5 GFLOP, microseconds
// of the card's rates, but step t+1 needs all of step t's h: 200 dependent
// [rows, 256] x [256, 384] products, each followed by a block-wide barrier.
// The serial chain binds, and a block can only shorten each link.
//
// Design: blocks run in no order, so the TPU's sequential grid becomes a
// `for t` loop inside one block. A block owns R batch rows for the whole scan
// and has one thread per hidden unit i; that thread computes the r, z and n
// columns of unit i for its R rows, so the gate math needs no exchange, and
// only the new h goes through shared memory (double-buffered: one barrier a
// step). W_h lives in shared memory for the whole scan. W_x does too when it
// fits: in bf16 at D=H=128 both are 96 KB, 200 KB with the buffers, inside
// the 227 KB a block may opt in to. In f32 W_h alone is 192 KB, so W_x is
// read from global memory, where it stays in L2 (192 KB for every block):
// the projection is still computed here, inside the step, never up front.
// x[t+1] is copied to shared memory with cp.async while step t computes.
// Weights are read once per k and reused across the R rows held in
// registers; products are plain f32 FMAs (no tensor cores yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One thread per hidden unit; the bound leaves the compiler room for the
// R-row register tiles.
constexpr int kMaxHidden = 256;

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
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Four consecutive values from shared memory (16-byte aligned for float,
// 8-byte aligned for bf16), as floats.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Copy `bytes` (a multiple of 16) from global to shared memory.
__device__ __forceinline__ void copy_to_smem(void* dst, const void* src,
                                             size_t bytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (size_t c = threadIdx.x; c < bytes / 16; c += blockDim.x) d[c] = s[c];
}

// Start the copy of x[b0 .. b0+R, t, :] into the staging buffer `xs`.
// Rows past B are left as they are (zero from the start).
template <typename T, int R>
__device__ __forceinline__ void stage_x(T* xs, const T* x, int b0, int B,
                                        int Tn, int D, int t) {
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;
  for (int c = threadIdx.x; c < R * chunks; c += blockDim.x) {
    const int r = c / chunks, j = c % chunks;
    if (b0 + r < B) {
      const T* src = x + (static_cast<size_t>(b0 + r) * Tn + t) * D;
      cp_async16(reinterpret_cast<uint4*>(xs + r * D) + j,
                 reinterpret_cast<const uint4*>(src) + j);
    }
  }
  cp_async_commit();
}

template <typename T, int R, bool kWxInSmem>
__global__ void __launch_bounds__(kMaxHidden)
gru_forward_kernel(const T* __restrict__ x, const T* __restrict__ h0,
                   const T* __restrict__ w_x, const T* __restrict__ w_h,
                   const float* __restrict__ b_x, const float* __restrict__ b_h,
                   T* __restrict__ ys, int B, int Tn, int D, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H;
  float* hbuf = reinterpret_cast<float*>(smem);        // [2][R][H]
  T* xbuf = reinterpret_cast<T*>(hbuf + 2 * R * H);    // [2][R][D]
  T* wh_s = xbuf + 2 * R * D;                          // [H][3H]
  T* wx_s = wh_s + static_cast<size_t>(H) * H3;        // [D][3H] if in smem

  const int i = threadIdx.x;  // hidden unit; blockDim.x == H
  const int b0 = blockIdx.x * R;

  for (int c = i; c < 2 * R * H; c += blockDim.x) hbuf[c] = 0.0f;
  for (int c = i; c < 2 * R * D; c += blockDim.x) xbuf[c] = from_f<T>(0.0f);
  __syncthreads();
  stage_x<T, R>(xbuf, x, b0, B, Tn, D, 0);
  copy_to_smem(wh_s, w_h, static_cast<size_t>(H) * H3 * sizeof(T));
  if (kWxInSmem) copy_to_smem(wx_s, w_x, static_cast<size_t>(D) * H3 * sizeof(T));
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) hbuf[r * H + i] = to_f(h0[static_cast<size_t>(b0 + r) * H + i]);
  }
  const float bxr = b_x[i], bxz = b_x[H + i], bxn = b_x[2 * H + i];
  const float bhr = b_h[i], bhz = b_h[H + i], bhn = b_h[2 * H + i];
  cp_async_wait_all();
  __syncthreads();

  const T* wx = kWxInSmem ? wx_s : w_x;
  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t + 1 < Tn) stage_x<T, R>(xbuf + nxt * R * D, x, b0, B, Tn, D, t + 1);
    const T* xc = xbuf + cur * R * D;
    const float* hc = hbuf + cur * R * H;

    float ar[R], az[R], axn[R], ahn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ar[r] = az[r] = axn[r] = ahn[r] = 0.0f;

    // x[t] @ W_x, columns i, H+i, 2H+i.
    for (int k = 0; k < D; k += 4) {
      float xv[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) load4(xc + r * D + k, xv[r]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* w = wx + static_cast<size_t>(k + kk) * H3 + i;
        const float wr = to_f(w[0]), wz = to_f(w[H]), wn = to_f(w[2 * H]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ar[r] = fmaf(xv[r][kk], wr, ar[r]);
          az[r] = fmaf(xv[r][kk], wz, az[r]);
          axn[r] = fmaf(xv[r][kk], wn, axn[r]);
        }
      }
    }
    // h @ W_h, the same columns.
    for (int k = 0; k < H; k += 4) {
      float hv[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) load4(hc + r * H + k, hv[r]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* w = wh_s + (k + kk) * H3 + i;
        const float wr = to_f(w[0]), wz = to_f(w[H]), wn = to_f(w[2 * H]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ar[r] = fmaf(hv[r][kk], wr, ar[r]);
          az[r] = fmaf(hv[r][kk], wz, az[r]);
          ahn[r] = fmaf(hv[r][kk], wn, ahn[r]);
        }
      }
    }

    float* hn_buf = hbuf + nxt * R * H;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float rg = sigmoidf(ar[r] + bxr + bhr);
      const float zg = sigmoidf(az[r] + bxz + bhz);
      const float ng = tanhf(axn[r] + bxn + rg * (ahn[r] + bhn));
      const float hp = hc[r * H + i];
      const T hq = from_f<T>((1.0f - zg) * ng + zg * hp);
      hn_buf[r * H + i] = to_f(hq);
      if (b0 + r < B) ys[(static_cast<size_t>(b0 + r) * Tn + t) * H + i] = hq;
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename T, int R>
int launch_r(const void* x, const void* h0, const void* w_x, const void* w_h,
             const float* b_x, const float* b_h, void* ys, int B, int Tn, int D,
             int H, int wx_in_smem, size_t smem, cudaStream_t s) {
  const dim3 grid((B + R - 1) / R), block(H);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(h0),
        static_cast<const T*>(w_x), static_cast<const T*>(w_h), b_x, b_h,
        static_cast<T*>(ys), B, Tn, D, H);
    return static_cast<int>(cudaGetLastError());
  };
  return wx_in_smem ? launch(gru_forward_kernel<T, R, true>)
                    : launch(gru_forward_kernel<T, R, false>);
}

template <typename T>
int launch_t(int rows_per_block, const void* x, const void* h0, const void* w_x,
             const void* w_h, const float* b_x, const float* b_h, void* ys,
             int B, int Tn, int D, int H, int wx_in_smem, size_t smem,
             cudaStream_t s) {
  switch (rows_per_block) {
    case 1: return launch_r<T, 1>(x, h0, w_x, w_h, b_x, b_h, ys, B, Tn, D, H, wx_in_smem, smem, s);
    case 2: return launch_r<T, 2>(x, h0, w_x, w_h, b_x, b_h, ys, B, Tn, D, H, wx_in_smem, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x [B, T, D], h0 [B, H], w_x [D, 3H], w_h [H, 3H], ys [B, T, H]: all of the
// working dtype (dtype 0 = float, 1 = bf16), contiguous, 16-byte aligned;
// b_x, b_h [3H] float. smem_bytes is what the caller computed for this
// layout; it is checked again here.
int seqrec_gru_forward(const void* x, const void* h0, const void* w_x,
                       const void* w_h, const void* b_x, const void* b_h,
                       void* ys, int B, int Tn, int D, int H, int dtype,
                       int rows_per_block, int wx_in_smem, long long smem_bytes,
                       void* stream) {
  const size_t es = dtype == 0 ? 4 : 2;
  const int R = rows_per_block;
  if (B <= 0 || Tn <= 0 || D <= 0 || H <= 0 || H > kMaxHidden || (dtype != 0 && dtype != 1) ||
      (D * es) % 16 != 0 || H % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(R) * H * 4 + 2 * static_cast<size_t>(R) * D * es +
                      static_cast<size_t>(H) * 3 * H * es +
                      (wx_in_smem ? static_cast<size_t>(D) * 3 * H * es : 0);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bx = static_cast<const float*>(b_x);
  const float* bh = static_cast<const float*>(b_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_t<float>(R, x, h0, w_x, w_h, bx, bh, ys, B, Tn, D, H, wx_in_smem, smem, s);
  }
  return launch_t<__nv_bfloat16>(R, x, h0, w_x, w_h, bx, bh, ys, B, Tn, D, H, wx_in_smem, smem, s);
}

const char* seqrec_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
