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
//
// Backward (seqrec_gru_backward): the reverse recurrence of the analytic
// BPTT. Replaces the `lax.scan(step, ..., reverse=True)` inside
// seqrec_tpu/ops/pallas/gru.py::_gru_bwd_math (the TPU package's backward
// runs it as XLA ops; its hoisted products stay outside, here as
// torch.matmul). Given the recomputed gate planes r, z, n, hn [B, T, H] f32,
// the consumed states h_in and the output cotangents g_ys [B, T, H], per step
// t = T-1 .. 0 with an f32 carry dh_next:
//   dh = dh_next + g_y
//   dpre_n = dh (1-z) (1-n^2),  dpre_z = dh (h_in-n) z (1-z),
//   dpre_r = dpre_n hn r (1-r)
//   d_xp[t] = [dpre_r | dpre_z | dpre_n]                      (written, f32)
//   d_hproj = [dpre_r | dpre_z | dpre_n r]
//   dh_next = dh z + d_hproj @ W_h^T
// What bounds it: as the forward, the 200-step serial chain; the bytes
// (four f32 gate planes, h_in, g_ys, d_xp: ~105 MB at B=128, T=200, H=128
// in bf16) are ~31 us and the operations ~2.5 us of the card's rates.
// Design: the forward's, mirrored. A block owns R batch rows for the whole
// reverse loop with one thread per hidden unit i, which keeps its row's
// carry dh[i] in a register; only d_hproj (3H floats a row) is exchanged,
// through a double-buffered shared array: one barrier a step. W_h^T [3H, H]
// lives in shared memory when it fits (96 KB in bf16 at H=128) and is read
// through L2 otherwise, so thread i's reads W_h^T[c][i] are consecutive
// across the warp. The next step's six gate-plane values are loaded into
// registers while the current step computes.

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

template <typename T, int R, bool kWInSmem>
__global__ void __launch_bounds__(kMaxHidden)
gru_backward_kernel(const float* __restrict__ rg, const float* __restrict__ zg,
                    const float* __restrict__ ng, const float* __restrict__ hng,
                    const T* __restrict__ h_in, const T* __restrict__ g_ys,
                    const T* __restrict__ w_h_t, float* __restrict__ d_xp,
                    float* __restrict__ dh0, int B, int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H;
  float* dbuf = reinterpret_cast<float*>(smem);     // [2][R][3H] d_hproj
  T* wt_s = reinterpret_cast<T*>(dbuf + 2 * R * H3);  // [3H][H] if in smem

  const int i = threadIdx.x;  // hidden unit; blockDim.x == H
  const int b0 = blockIdx.x * R;
  if (kWInSmem) copy_to_smem(wt_s, w_h_t, static_cast<size_t>(H3) * H * sizeof(T));
  const T* wt = kWInSmem ? wt_s : w_h_t;

  // Gate-plane values of the step about to run: r, z, n, hn, h_in, g_y.
  float nx[R][6];
  auto load_step = [&](int t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (b0 + r < B) {
        const size_t idx = (static_cast<size_t>(b0 + r) * Tn + t) * H + i;
        nx[r][0] = rg[idx]; nx[r][1] = zg[idx]; nx[r][2] = ng[idx];
        nx[r][3] = hng[idx]; nx[r][4] = to_f(h_in[idx]); nx[r][5] = to_f(g_ys[idx]);
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) nx[r][q] = 0.0f;
      }
    }
  };
  load_step(Tn - 1);
  float carry[R];
#pragma unroll
  for (int r = 0; r < R; ++r) carry[r] = 0.0f;
  __syncthreads();

  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    float cur[R][6];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 6; ++q) cur[r][q] = nx[r][q];
    if (t > 0) load_step(t - 1);

    float* dhp = dbuf + (s & 1) * R * H3;
    float dhz[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float rv = cur[r][0], zv = cur[r][1], nv = cur[r][2];
      const float hnv = cur[r][3], hin = cur[r][4];
      const float dh = carry[r] + cur[r][5];
      const float dpre_n = dh * (1.0f - zv) * (1.0f - nv * nv);
      const float dz = dh * (hin - nv);
      const float dpre_z = dz * zv * (1.0f - zv);
      const float dr = dpre_n * hnv;
      const float dpre_r = dr * rv * (1.0f - rv);
      if (b0 + r < B) {
        float* out = d_xp + (static_cast<size_t>(b0 + r) * Tn + t) * H3;
        out[i] = dpre_r; out[H + i] = dpre_z; out[2 * H + i] = dpre_n;
      }
      dhp[r * H3 + i] = dpre_r;
      dhp[r * H3 + H + i] = dpre_z;
      dhp[r * H3 + 2 * H + i] = dpre_n * rv;
      dhz[r] = dh * zv;
    }
    __syncthreads();

    // (d_hproj @ W_h^T)[i] for the R rows.
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int c = 0; c < H3; c += 4) {
      float dv[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) load4(dhp + r * H3 + c, dv[r]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float w = to_f(wt[static_cast<size_t>(c + cc) * H + i]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(dv[r][cc], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) carry[r] = dhz[r] + acc[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) dh0[static_cast<size_t>(b0 + r) * H + i] = carry[r];
  }
}

template <typename T, int R>
int launch_bwd_r(const float* rg, const float* zg, const float* ng,
                 const float* hng, const void* h_in, const void* g_ys,
                 const void* w_h_t, float* d_xp, float* dh0, int B, int Tn,
                 int H, int w_in_smem, size_t smem, cudaStream_t s) {
  const dim3 grid((B + R - 1) / R), block(H);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        rg, zg, ng, hng, static_cast<const T*>(h_in), static_cast<const T*>(g_ys),
        static_cast<const T*>(w_h_t), d_xp, dh0, B, Tn, H);
    return static_cast<int>(cudaGetLastError());
  };
  return w_in_smem ? launch(gru_backward_kernel<T, R, true>)
                   : launch(gru_backward_kernel<T, R, false>);
}

template <typename T>
int launch_bwd_t(int rows_per_block, const float* rg, const float* zg,
                 const float* ng, const float* hng, const void* h_in,
                 const void* g_ys, const void* w_h_t, float* d_xp, float* dh0,
                 int B, int Tn, int H, int w_in_smem, size_t smem,
                 cudaStream_t s) {
  switch (rows_per_block) {
    case 1: return launch_bwd_r<T, 1>(rg, zg, ng, hng, h_in, g_ys, w_h_t, d_xp, dh0, B, Tn, H, w_in_smem, smem, s);
    case 2: return launch_bwd_r<T, 2>(rg, zg, ng, hng, h_in, g_ys, w_h_t, d_xp, dh0, B, Tn, H, w_in_smem, smem, s);
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

// r, z, n, hn [B, T, H] float; h_in, g_ys [B, T, H] and w_h_t [3H, H] of the
// working dtype (dtype 0 = float, 1 = bf16); d_xp [B, T, 3H] and dh0 [B, H]
// float. All contiguous, 16-byte aligned. smem_bytes as the caller computed
// it for this layout, checked again here.
int seqrec_gru_backward(const void* r, const void* z, const void* n,
                        const void* hn, const void* h_in, const void* g_ys,
                        const void* w_h_t, void* d_xp, void* dh0, int B, int Tn,
                        int H, int dtype, int rows_per_block, int w_in_smem,
                        long long smem_bytes, void* stream) {
  const size_t es = dtype == 0 ? 4 : 2;
  const int R = rows_per_block;
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(R) * 3 * H * 4 +
                      (w_in_smem ? static_cast<size_t>(3) * H * H * es : 0);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* rg = static_cast<const float*>(r);
  const float* zg = static_cast<const float*>(z);
  const float* ngp = static_cast<const float*>(n);
  const float* hng = static_cast<const float*>(hn);
  float* dxp = static_cast<float*>(d_xp);
  float* dh = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_t<float>(R, rg, zg, ngp, hng, h_in, g_ys, w_h_t, dxp, dh, B, Tn, H, w_in_smem, smem, s);
  }
  return launch_bwd_t<__nv_bfloat16>(R, rg, zg, ngp, hng, h_in, g_ys, w_h_t, dxp, dh, B, Tn, H, w_in_smem, smem, s);
}

const char* seqrec_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
