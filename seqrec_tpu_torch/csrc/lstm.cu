// LSTM scan forward and its reverse recurrence for Hopper (sm_90a).
//
// Forward (seqrec_lstm_forward) replaces the TPU kernel
// seqrec_tpu/ops/pallas/lstm.py (_lstm_step_body via _lstm_forward_pallas,
// both variants: _lstm_step_kernel and, with a keep plane,
// _lstm_step_kernel_reset): a sequential grid over T with h, an f32 c and
// both weight matrices held in VMEM, the input projection computed inside
// each step. Math per step (gate blocks i|f|g|o, as
// ops/reference.py::lstm_scan):
//   h, c *= keep[t]              (session-parallel variant; keep = 1 - reset)
//   z = x[t] @ W_x + h @ W_h + b                       (f32 accumulation)
//   i = sigmoid(z_i), f = sigmoid(z_f), g = tanh(z_g), o = sigmoid(z_o)
//   c' = f c + i g  (f32, never rounded),  h' = o tanh(c')
//   h' is rounded to the working dtype T (float or bf16) every step, is
//   written to ys[:, t], and is the next step's h.
// It also writes c_T, and, when the caller asks (training), the f32 cell
// plane c_1..c_T, so the backward needs no serial recompute of the cells.
// The reset variant keeps the design below: at the end of step t each thread
// scales what it hands to step t+1 by keep[t+1], the h' it writes to the
// next step's shared buffer and the c' in its register, after ys, the cell
// plane and (at t = T-1) c_T took the unscaled values. keep is a [B, T] f32
// plane, one scalar a row a step.
//
// What bounds it: the 200-step serial chain, as the GRU's (csrc/gru.cu). At
// the training shape (B=128, T=200, D=H=128) the scan reads and writes
// 13 MB and does 6.7 GFLOP, microseconds of the card's rates, but each
// step's [rows, 256] x [256, 512] product waits on the one before.
//
// Design: csrc/gru.cu's, with 4H gate columns. A block owns R batch rows
// for the whole scan and has one thread per hidden unit i, which computes
// the i, f, g and o columns of unit i for its R rows and keeps its c in a
// register; only h goes through shared memory, double-buffered (one barrier
// a step); x[t+1] is staged with cp.async while step t computes. W_h lives
// in shared memory when it fits: in bf16 at H=128 it is 128 KB, and W_x
// (another 128 KB) does not fit beside it, so W_x is read from global memory
// where it stays in L2, with R=2 so that half as many blocks read it. In f32
// W_h alone is 256 KB, over the 227 KB a block may have: then both matrices
// are read through L2 (off the bf16 main path). Both matrices come k-packed
// ([K/P][4H][P], P = 16 / sizeof(T), packed by the wrapper), so each thread
// reads its four columns in 16-byte loads and keeps 16 of them in flight
// ahead of its FMAs; 2-byte loads column by column leave the step bound by
// L2 latency (W_x) and shared-memory instruction count (W_h).
//
// Backward (seqrec_lstm_backward): the reverse recurrence of the analytic
// BPTT, replacing the reverse `lax.scan` inside
// seqrec_tpu/ops/pallas/lstm.py::_lstm_bwd_math (XLA in the TPU package;
// its hoisted products stay outside, here as torch.matmul). Given the gate
// planes i, f, g, o, tanh(c) and c_in (= c_{t-1}) [B, T, H] f32 and the
// output cotangents g_ys [B, T, H], per step t = T-1 .. 0 with f32 carries
// dh, dc (dc starts at the cotangent of c_T):
//   dh += g_y;  dc += dh o (1 - tanh_c^2)
//   dz = [dc g i(1-i) | dc c_in f(1-f) | dc i (1-g^2) | dh tanh_c o(1-o)]
//   d_xp[t] = dz (written, f32);  dh = dz @ W_h^T;  dc = dc f
// What bounds it: the serial chain again; the bytes (six f32 planes, g_ys
// and d_xp: ~137 MB at B=128, T=200, H=128 in bf16) are ~41 us of the
// card's rate. Design: the forward's, mirrored. A thread per hidden unit
// keeps its row's dh and dc in registers; only dz (4H floats a row) goes
// through a double-buffered shared array, one barrier a step; W_h^T [4H, H]
// sits in shared memory when it fits (128 KB in bf16 at H=128) and is read
// through L2 otherwise (f32), laid out so a warp's reads are consecutive.
// The next step's plane values are loaded while the current step computes.
// Reset variant (the keep path of _lstm_bwd_math, lstm.py:265-269): dh_prev
// and dc_prev *= keep[t], read with the step's planes; c_in arrives already
// scaled (reference.lstm_bwd_hoist).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHidden = 256;  // one thread per hidden unit

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

// Four consecutive values from shared memory, as floats.
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

// Sixteen bytes as floats: four f32 or eight bf16 values.
__device__ __forceinline__ void unpack16(uint4 q, float* out, float) {
  out[0] = __uint_as_float(q.x); out[1] = __uint_as_float(q.y);
  out[2] = __uint_as_float(q.z); out[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(uint4 q, float* out, __nv_bfloat16) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// acc[r][0..3] += sum_k v[r][k] * W[k][{i, H+i, 2H+i, 3H+i}], v in shared
// memory ([R][K], float or T), W k-packed as [K/P][4H][P] (P = 16 /
// sizeof(T)) in shared or global memory: one 16-byte load brings P
// consecutive k rows of one column, and a warp's loads are consecutive (no
// bank conflicts in shared memory, whole sectors from L2). kGroup packs (4
// kGroup loads) are in flight while the previous group's FMAs run: from L2
// the reads are latency, not bandwidth, so that depth sets the step time.
template <int R, typename V, typename T>
__device__ __forceinline__ void gate_product(float acc[R][4], const V* v,
                                             const T* __restrict__ wp, int K,
                                             int H, int i) {
  constexpr int P = 16 / sizeof(T);
  constexpr int kGroup = 4;
  const int H4 = 4 * H, KB = K / P;
  const uint4* base = reinterpret_cast<const uint4*>(wp) + i;
  uint4 cur[kGroup][4], nxt[kGroup][4];
  auto fetch = [&](uint4 (&w)[kGroup][4], int kb0) {
#pragma unroll
    for (int b = 0; b < kGroup; ++b)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (kb0 + b < KB) w[b][g] = base[static_cast<size_t>(kb0 + b) * H4 + g * H];
  };
  fetch(cur, 0);
  for (int kb0 = 0; kb0 < KB; kb0 += kGroup) {
    if (kb0 + kGroup < KB) fetch(nxt, kb0 + kGroup);
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      if (kb0 + b < KB) {
        float wf[4][P];
#pragma unroll
        for (int g = 0; g < 4; ++g) unpack16(cur[b][g], wf[g], T());
        const int k = (kb0 + b) * P;
#pragma unroll
        for (int p = 0; p < P; p += 4) {
          float vv[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r) load4(v + r * K + k + p, vv[r]);
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int g = 0; g < 4; ++g)
                acc[r][g] = fmaf(vv[r][pp], wf[g][p + pp], acc[r][g]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kGroup; ++b)
#pragma unroll
      for (int g = 0; g < 4; ++g) cur[b][g] = nxt[b][g];
  }
}

// kReset: the session-parallel variant, which reads keep, a [B, T] f32 plane
// of 1 - reset (null otherwise). A template flag, so that the no-reset
// variant compiles to the same code as without it.
template <typename T, int R, bool kWxInSmem, bool kWhInSmem, bool kReset>
__global__ void __launch_bounds__(kMaxHidden)
lstm_forward_kernel(const T* __restrict__ x, const T* __restrict__ h0,
                    const T* __restrict__ c0, const T* __restrict__ w_x,
                    const T* __restrict__ w_h, const float* __restrict__ bias,
                    const float* __restrict__ keep, T* __restrict__ ys,
                    float* __restrict__ c_last, float* __restrict__ cs, int B,
                    int Tn, int D, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = 4 * H;
  float* hbuf = reinterpret_cast<float*>(smem);        // [2][R][H]
  T* xbuf = reinterpret_cast<T*>(hbuf + 2 * R * H);    // [2][R][D]
  T* wh_s = xbuf + 2 * R * D;                          // [H][4H] if in smem
  T* wx_s = wh_s + (kWhInSmem ? static_cast<size_t>(H) * H4 : 0);  // [D][4H]

  const int i = threadIdx.x;  // hidden unit; blockDim.x == H
  const int b0 = blockIdx.x * R;

  for (int c = i; c < 2 * R * H; c += blockDim.x) hbuf[c] = 0.0f;
  for (int c = i; c < 2 * R * D; c += blockDim.x) xbuf[c] = from_f<T>(0.0f);
  __syncthreads();
  stage_x<T, R>(xbuf, x, b0, B, Tn, D, 0);
  if (kWhInSmem) copy_to_smem(wh_s, w_h, static_cast<size_t>(H) * H4 * sizeof(T));
  if (kWxInSmem) copy_to_smem(wx_s, w_x, static_cast<size_t>(D) * H4 * sizeof(T));
  float cell[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cell[r] = 0.0f;
    if (b0 + r < B) {
      const size_t idx = static_cast<size_t>(b0 + r) * H + i;
      const float k0 = kReset ? keep[static_cast<size_t>(b0 + r) * Tn] : 1.0f;
      hbuf[r * H + i] = kReset ? to_f(h0[idx]) * k0 : to_f(h0[idx]);
      cell[r] = kReset ? to_f(c0[idx]) * k0 : to_f(c0[idx]);
    }
  }
  const float bi = bias[i], bf = bias[H + i], bg = bias[2 * H + i], bo = bias[3 * H + i];
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t + 1 < Tn) stage_x<T, R>(xbuf + nxt * R * D, x, b0, B, Tn, D, t + 1);
    // keep[t+1] scales the h' and c' this step hands to the next one.
    float kn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      kn[r] = (kReset && t + 1 < Tn && b0 + r < B)
                  ? keep[static_cast<size_t>(b0 + r) * Tn + t + 1]
                  : 1.0f;
    }
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
    gate_product<R>(acc, xbuf + cur * R * D, kWxInSmem ? wx_s : w_x, D, H, i);
    gate_product<R>(acc, hbuf + cur * R * H, kWhInSmem ? wh_s : w_h, H, H, i);

    float* hn_buf = hbuf + nxt * R * H;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float ig = sigmoidf(acc[r][0] + bi);
      const float fg = sigmoidf(acc[r][1] + bf);
      const float gg = tanhf(acc[r][2] + bg);
      const float og = sigmoidf(acc[r][3] + bo);
      cell[r] = fg * cell[r] + ig * gg;
      const T hq = from_f<T>(og * tanhf(cell[r]));
      hn_buf[r * H + i] = kReset ? to_f(hq) * kn[r] : to_f(hq);
      if (b0 + r < B) {
        const size_t idx = (static_cast<size_t>(b0 + r) * Tn + t) * H + i;
        ys[idx] = hq;
        if (cs != nullptr) cs[idx] = cell[r];
      }
      if (kReset) cell[r] *= kn[r];  // 1 after the last step: c_T stays
    }
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) c_last[static_cast<size_t>(b0 + r) * H + i] = cell[r];
  }
}

template <typename T, int R>
int launch_fwd_r(const void* x, const void* h0, const void* c0, const void* w_x,
                 const void* w_h, const float* bias, const float* keep, void* ys,
                 float* c_last, float* cs, int B, int Tn, int D, int H,
                 int wx_in_smem, int wh_in_smem, size_t smem, cudaStream_t s) {
  const dim3 grid((B + R - 1) / R), block(H);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(h0),
        static_cast<const T*>(c0), static_cast<const T*>(w_x),
        static_cast<const T*>(w_h), bias, keep, static_cast<T*>(ys), c_last, cs,
        B, Tn, D, H);
    return static_cast<int>(cudaGetLastError());
  };
  if (wx_in_smem && !wh_in_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (keep == nullptr) {
    if (wh_in_smem) {
      return wx_in_smem ? launch(lstm_forward_kernel<T, R, true, true, false>)
                        : launch(lstm_forward_kernel<T, R, false, true, false>);
    }
    return launch(lstm_forward_kernel<T, R, false, false, false>);
  }
  if (wh_in_smem) {
    return wx_in_smem ? launch(lstm_forward_kernel<T, R, true, true, true>)
                      : launch(lstm_forward_kernel<T, R, false, true, true>);
  }
  return launch(lstm_forward_kernel<T, R, false, false, true>);
}

template <typename T>
int launch_fwd_t(int rows_per_block, const void* x, const void* h0,
                 const void* c0, const void* w_x, const void* w_h,
                 const float* bias, const float* keep, void* ys, float* c_last,
                 float* cs, int B, int Tn, int D, int H, int wx_in_smem,
                 int wh_in_smem, size_t smem, cudaStream_t s) {
  switch (rows_per_block) {
    case 1: return launch_fwd_r<T, 1>(x, h0, c0, w_x, w_h, bias, keep, ys, c_last, cs, B, Tn, D, H, wx_in_smem, wh_in_smem, smem, s);
    case 2: return launch_fwd_r<T, 2>(x, h0, c0, w_x, w_h, bias, keep, ys, c_last, cs, B, Tn, D, H, wx_in_smem, wh_in_smem, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kReset: the session-parallel variant, which reads keep ([B, T] f32, 1 -
// reset; null otherwise), as the forward's template flag.
template <typename T, int R, bool kWInSmem, bool kReset>
__global__ void __launch_bounds__(kMaxHidden)
lstm_backward_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                     const float* __restrict__ gg, const float* __restrict__ og,
                     const float* __restrict__ tcg, const float* __restrict__ cing,
                     const T* __restrict__ g_ys, const T* __restrict__ w_h_t,
                     const float* __restrict__ keep,
                     const float* __restrict__ dc_last, float* __restrict__ d_xp,
                     float* __restrict__ dh0, float* __restrict__ dc0, int B,
                     int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = 4 * H;
  float* dbuf = reinterpret_cast<float*>(smem);       // [2][R][4H] dz
  T* wt_s = reinterpret_cast<T*>(dbuf + 2 * R * H4);  // [4H][H] if in smem

  const int i = threadIdx.x;  // hidden unit; blockDim.x == H
  const int b0 = blockIdx.x * R;
  if (kWInSmem) copy_to_smem(wt_s, w_h_t, static_cast<size_t>(H4) * H * sizeof(T));
  const T* wt = kWInSmem ? wt_s : w_h_t;

  // Values of the step about to run: i, f, g, o, tanh c, c_in, g_y (and keep).
  constexpr int kVals = kReset ? 8 : 7;
  float nx[R][kVals];
  auto load_step = [&](int t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (b0 + r < B) {
        const size_t idx = (static_cast<size_t>(b0 + r) * Tn + t) * H + i;
        nx[r][0] = ig[idx]; nx[r][1] = fg[idx]; nx[r][2] = gg[idx];
        nx[r][3] = og[idx]; nx[r][4] = tcg[idx]; nx[r][5] = cing[idx];
        nx[r][6] = to_f(g_ys[idx]);
        if (kReset) nx[r][kVals - 1] = keep[static_cast<size_t>(b0 + r) * Tn + t];
      } else {
#pragma unroll
        for (int q = 0; q < kVals; ++q) nx[r][q] = 0.0f;
      }
    }
  };
  load_step(Tn - 1);
  float dh_c[R], dc_c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dh_c[r] = 0.0f;
    dc_c[r] = b0 + r < B ? dc_last[static_cast<size_t>(b0 + r) * H + i] : 0.0f;
  }
  __syncthreads();

  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    float cur[R][kVals];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < kVals; ++q) cur[r][q] = nx[r][q];
    if (t > 0) load_step(t - 1);

    float* dz = dbuf + (s & 1) * R * H4;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float iv = cur[r][0], fv = cur[r][1], gv = cur[r][2], ov = cur[r][3];
      const float tc = cur[r][4], cin = cur[r][5];
      const float dh = dh_c[r] + cur[r][6];
      const float dc = dc_c[r] + dh * ov * (1.0f - tc * tc);
      const float dzi = dc * gv * iv * (1.0f - iv);
      const float dzf = dc * cin * fv * (1.0f - fv);
      const float dzg = dc * iv * (1.0f - gv * gv);
      const float dzo = dh * tc * ov * (1.0f - ov);
      if (b0 + r < B) {
        float* out = d_xp + (static_cast<size_t>(b0 + r) * Tn + t) * H4;
        out[i] = dzi; out[H + i] = dzf; out[2 * H + i] = dzg; out[3 * H + i] = dzo;
      }
      dz[r * H4 + i] = dzi;
      dz[r * H4 + H + i] = dzf;
      dz[r * H4 + 2 * H + i] = dzg;
      dz[r * H4 + 3 * H + i] = dzo;
      dc_c[r] = dc * fv;
      if (kReset) dc_c[r] *= cur[r][kVals - 1];  // dc_prev *= keep[t]
    }
    __syncthreads();

    // (dz @ W_h^T)[i] for the R rows.
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int c = 0; c < H4; c += 4) {
      float dv[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) load4(dz + r * H4 + c, dv[r]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float w = to_f(wt[static_cast<size_t>(c + cc) * H + i]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(dv[r][cc], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dh_c[r] = acc[r];
      if (kReset) dh_c[r] *= cur[r][kVals - 1];  // dh_prev *= keep[t]
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) {
      dh0[static_cast<size_t>(b0 + r) * H + i] = dh_c[r];
      dc0[static_cast<size_t>(b0 + r) * H + i] = dc_c[r];
    }
  }
}

template <typename T, int R>
int launch_bwd_r(const float* const* planes, const void* g_ys, const void* w_h_t,
                 const float* keep, const float* dc_last, float* d_xp,
                 float* dh0, float* dc0, int B, int Tn, int H, int w_in_smem,
                 size_t smem, cudaStream_t s) {
  const dim3 grid((B + R - 1) / R), block(H);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        planes[0], planes[1], planes[2], planes[3], planes[4], planes[5],
        static_cast<const T*>(g_ys), static_cast<const T*>(w_h_t), keep,
        dc_last, d_xp, dh0, dc0, B, Tn, H);
    return static_cast<int>(cudaGetLastError());
  };
  if (keep == nullptr) {
    return w_in_smem ? launch(lstm_backward_kernel<T, R, true, false>)
                     : launch(lstm_backward_kernel<T, R, false, false>);
  }
  return w_in_smem ? launch(lstm_backward_kernel<T, R, true, true>)
                   : launch(lstm_backward_kernel<T, R, false, true>);
}

template <typename T>
int launch_bwd_t(int rows_per_block, const float* const* planes,
                 const void* g_ys, const void* w_h_t, const float* keep,
                 const float* dc_last, float* d_xp, float* dh0, float* dc0,
                 int B, int Tn, int H, int w_in_smem, size_t smem,
                 cudaStream_t s) {
  switch (rows_per_block) {
    case 1: return launch_bwd_r<T, 1>(planes, g_ys, w_h_t, keep, dc_last, d_xp, dh0, dc0, B, Tn, H, w_in_smem, smem, s);
    case 2: return launch_bwd_r<T, 2>(planes, g_ys, w_h_t, keep, dc_last, d_xp, dh0, dc0, B, Tn, H, w_in_smem, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x [B, T, D], h0, c0 [B, H], w_x [D, 4H], w_h [H, 4H], ys [B, T, H]: all of
// the working dtype (dtype 0 = float, 1 = bf16), contiguous, 16-byte
// aligned, except that w_x and w_h come k-packed as [K/P][4H][P], P = 16 /
// element size. bias [4H], keep [B, T] (1 - reset; null: the no-reset
// variant), c_last [B, H] and cs [B, T, H] (null: not written) float.
// smem_bytes as the caller computed it for this layout, checked again here.
int seqrec_lstm_forward(const void* x, const void* h0, const void* c0,
                        const void* w_x, const void* w_h, const void* bias,
                        const void* keep, void* ys, void* c_last, void* cs,
                        int B, int Tn, int D, int H, int dtype,
                        int rows_per_block, int wx_in_smem, int wh_in_smem,
                        long long smem_bytes, void* stream) {
  const size_t es = dtype == 0 ? 4 : 2;
  const int R = rows_per_block;
  if (B <= 0 || Tn <= 0 || D <= 0 || H <= 0 || H > kMaxHidden ||
      (dtype != 0 && dtype != 1) || (D * es) % 16 != 0 || H % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(R) * H * 4 + 2 * static_cast<size_t>(R) * D * es +
                      (wh_in_smem ? static_cast<size_t>(H) * 4 * H * es : 0) +
                      (wx_in_smem ? static_cast<size_t>(D) * 4 * H * es : 0);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* b = static_cast<const float*>(bias);
  const float* kp = static_cast<const float*>(keep);
  float* cl = static_cast<float*>(c_last);
  float* cp = static_cast<float*>(cs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd_t<float>(R, x, h0, c0, w_x, w_h, b, kp, ys, cl, cp, B, Tn, D, H,
                               wx_in_smem, wh_in_smem, smem, s);
  }
  return launch_fwd_t<__nv_bfloat16>(R, x, h0, c0, w_x, w_h, b, kp, ys, cl, cp, B, Tn,
                                     D, H, wx_in_smem, wh_in_smem, smem, s);
}

// i, f, g, o, tanh_c, c_in [B, T, H] float; g_ys [B, T, H] and w_h_t
// [4H, H] of the working dtype (dtype 0 = float, 1 = bf16); keep [B, T]
// (1 - reset; null: the no-reset variant), dc_last, dh0, dc0 [B, H] and
// d_xp [B, T, 4H] float. All contiguous, 16-byte aligned. smem_bytes as the
// caller computed it for this layout, checked again here.
int seqrec_lstm_backward(const void* i, const void* f, const void* g,
                         const void* o, const void* tanh_c, const void* c_in,
                         const void* g_ys, const void* w_h_t, const void* keep,
                         const void* dc_last, void* d_xp, void* dh0, void* dc0,
                         int B, int Tn, int H, int dtype, int rows_per_block,
                         int w_in_smem, long long smem_bytes, void* stream) {
  const size_t es = dtype == 0 ? 4 : 2;
  const int R = rows_per_block;
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(R) * 4 * H * 4 +
                      (w_in_smem ? static_cast<size_t>(4) * H * H * es : 0);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* planes[6] = {
      static_cast<const float*>(i), static_cast<const float*>(f),
      static_cast<const float*>(g), static_cast<const float*>(o),
      static_cast<const float*>(tanh_c), static_cast<const float*>(c_in)};
  const float* kp = static_cast<const float*>(keep);
  const float* dcl = static_cast<const float*>(dc_last);
  float* dxp = static_cast<float*>(d_xp);
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_t<float>(R, planes, g_ys, w_h_t, kp, dcl, dxp, dh, dc, B, Tn, H,
                               w_in_smem, smem, s);
  }
  return launch_bwd_t<__nv_bfloat16>(R, planes, g_ys, w_h_t, kp, dcl, dxp, dh, dc, B,
                                     Tn, H, w_in_smem, smem, s);
}

const char* seqrec_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
