// GRU scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/gru.py (_gru_step_body via
// _gru_forward_pallas, both variants: _gru_step_kernel and, with a keep
// plane, _gru_step_kernel_reset), which walks a sequential grid over T with
// h and both weight matrices held in VMEM and the input projection
// x[t] @ W_x computed inside each step.
//
// Math per step (gate blocks r|z|n, as ops/reference.py::gru_scan):
//   h_in = keep[t] * h            (session-parallel variant; keep = 1 - reset)
//   xp = x[t] @ W_x + b_x,  hp = h_in @ W_h + b_h       (f32 accumulation)
//   r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n),  h' = (1 - z) * n + z * h_in  (f32 gate math)
//   h' is rounded to the working dtype T (float or bf16) every step, is
//   written to ys[:, t], and is the next step's h.
// Reset variant (a template flag, so that the no-reset instantiations
// compile as without it): the thread that hands unit i of h' to the next
// step hands over keep[t+1] * h' (rounded to T, as the TPU kernel's h_in is
// in x's dtype), so the one scaled state feeds both h_in @ W_h and
// z * h_in, with no extra barrier; ys keeps the unscaled h'. keep is a
// [B, T] f32 plane, one scalar a row a step, read a step ahead.
//
// What bounds it: neither bytes nor operations. At the serving shape
// (B=64, T=200, D=H=128) the scan reads 3.3 MB and does 2.5 GFLOP,
// microseconds of the card's rates, but step t+1 needs all of step t's h:
// 200 dependent [rows, H] x [H, 3H] products, each followed by a
// block-wide barrier. The latency of one step, times T, binds. In the bf16
// design below a step takes about 1 us on an H100 (PERF.md), and it grows
// with the rows a block computes (an H100 sweep found 16 rows a block
// 1.5-1.8x slower than 8): one SM's share of the step's work, its mma.sync
// products and its gate math, sets it.
//
// bf16 (every shipped config): two kernels.
// 1. rnn::xproj_wgmma_kernel (csrc/rnn.cuh, shared with lstm.cu), the
//    input projection off the serial chain: it does not depend on h, so one
//    tensor-core GEMM over all B*T rows (wgmma, warp-specialised,
//    persistent) computes xp = x @ W_x + b_x into an f32 [B, T, 3H] plane
//    before the scan (it stays in L2: 20 MB at B=64, T=200, H=128).
// 2. gru_forward_mma_kernel, the recurrence, transposed: hp^T = W_h^T h^T,
//    so the hidden units are mma.sync.m16n8k16's M and the batch rows its
//    N. A block owns 8 batch rows (one n8 tile) for the whole scan. H is
//    padded to Hp = 16 ceil(H / 16) (100 -> 112); the block has Hp / 16 warps;
//    warp w owns units [16w, 16w + 16) of each gate: three m16 tiles (r, z,
//    n), so the r, z and n sums of one (unit, row) land in the same
//    register of the same lane and the gate math needs no exchange. W_h^T's
//    A fragments are loaded once, with zeros past H, and held in registers
//    for the whole scan (96 registers a lane at H=128). Above Hp = 128 they
//    do not fit one SM, and gru_forward_wide_kernel (below) splits W_h^T
//    between the CTAs of a thread block cluster instead. h^T's
//    B fragments come by ldmatrix.trans from a unit-major [Hp][8] bf16
//    buffer in shared memory (double-buffered: one barrier a step; a unit's
//    8 rows are one 16-byte ldmatrix row), into which each lane writes its
//    own units of the new h, two rows in one 4-byte store. A lane keeps its
//    h_in values in registers for z * h_in, and loads its xp values (and
//    keep) for step t+1 while step t computes. Per step and block at
//    H=128: 8 warps x 24 mma.sync, and 1,024 (unit, row) gate evaluations
//    from the hardware exp2 and a fast divide (a few ulp in f32; h is then
//    rounded to bf16).
//    Padded units have zero weights and biases, so h' = 0.5 * h_in = 0
//    there, always; padded rows (past B) are computed and never written.
//
// f32: two kernels as well, on the CUDA cores, because TF32 tensor cores
// keep ~3 digits and the f32 contract is f32 products.
// 1. rnn::launch_xproj_f32 (csrc/rnn.cuh), the same projection off the
//    serial chain: from D = 256 csrc/fma_gemm.cuh's persistent FMA GEMM
//    (TMA-fed, 8 x 16 outputs a thread, x read as stored), below it a
//    persistent SIMT GEMM (x transposed into shared memory by cp.async).
// 2. gru_forward_cluster_kernel, the recurrence on a thread block cluster.
//    One SM cannot hold both weight matrices in f32 (196 KB each at H=128),
//    and the first port's one-block design re-read W_x through L2 every
//    step (~11.9 us a step). Here a cluster of C CTAs on neighbouring SMs
//    owns R batch rows for the whole scan, each CTA a slice of the hidden
//    units with its W_h columns (48 KB at H=128, C=4) resident in its
//    shared memory (and, at 16 k values a thread, in its registers), and
//    the step's new h values go to every CTA through distributed shared
//    memory, st.async counted by an mbarrier a buffer (the layout, the
//    reduce-scatter and the exchange in rnn.cuh). A cluster barrier a step
//    cost ~1.6 us of fixed latency on an H100 (PERF.md). What sets a step
//    now: that exchange's latency, the reduce-scatter and the f32 gate math
//    on the serial chain, then one CTA's FMAs and shared-memory reads for
//    its rows and units; C and R follow B and H (ops/cuda/gru.py
//    launch_config).
//
// Backward (seqrec_gru_backward_mma, seqrec_gru_backward): the reverse
// recurrence of the analytic BPTT. Replaces the `lax.scan(step, ...,
// reverse=True)` inside seqrec_tpu/ops/pallas/gru.py::_gru_bwd_math (the TPU
// package's backward runs it as XLA ops; its hoisted products stay outside,
// here as torch.matmul). Given the recomputed gates r, z, n, hn [B, T, H]
// f32, the consumed states h_in and the output cotangents g_ys [B, T, H],
// per step t = T-1 .. 0 with an f32 carry dh_next:
//   dh = dh_next + g_y
//   dpre_n = dh (1-z) (1-n^2),  dpre_z = dh (h_in-n) z (1-z),
//   dpre_r = dpre_n hn r (1-r)
//   d_xp[t] = [dpre_r | dpre_z | dpre_n]                      (written, f32)
//   d_hproj = [dpre_r | dpre_z | dpre_n r]
//   dh_next = dh z + d_hproj @ W_h^T
// Reset variant (the keep path of _gru_bwd_math, gru.py:255-258): after the
// W_h^T product, dh_next *= keep[t], read with the step's planes.
// What bounds it: as the forward, the 200-step serial chain; the bytes
// (two f32 projections, h_in, g_ys, d_xp and dn_r: ~144 MB at B=128,
// T=200, H=128 in bf16) are ~43 us of the card's rate, more than its
// operations take.
// Two designs, chosen by W_h's dtype:
//
// bf16 weights (gru_backward_mma_kernel; every shipped config, both
// variants): csrc/lstm.cu's reverse recurrence with three gates.
// dh_prev^T = W_h d_hproj^T on mma.sync, the hidden units as M and 8 batch
// rows as N, K = 3 Hp (the gate columns, each gate padded to Hp = 16
// ceil(H / 16); H = 100 pads to 112 with zero weights). The contract is an f32
// d_hproj times bf16-valued weights summed in f32 (_gru_bwd_math's d_hproj
// is in x_proj's f32), and one bf16 product would round the cotangent to 8
// bits every step, so d_hproj is split, hi = bf16(d) and lo = bf16(d - hi),
// and the two products share the A fragments (one ldmatrix.x4.trans brings
// both B fragments): W_h is exact in bf16, so only d's tail below 2^-17 of
// it is lost. W_h's A fragments come packed by the wrapper
// (ops/cuda/gru.py backward_fragments) and stay in registers (96 a lane at
// H=128); above Hp = 128 gru_backward_wide_kernel (below) splits K between
// the CTAs of a cluster, each with its slice of W_h in registers.
// A lane computes the gate cotangents of its own (unit, row) pairs with no
// exchange, writes d_xp and dn_r = dpre_n r (the n-block of d_hproj, for
// the weight gradients), and keeps dh in f32 registers (with dh z for the
// step's end). Each warp computes its own tile over all of K, reading all
// of d_hproj^T from shared memory (double-buffered: one barrier a step).
// lstm.cu's reverse recurrence splits K between warp pairs, because there
// those reads set the step; here a version with that split measured slower
// (PERF.md). The gate recompute is folded in:
// the kernel reads the two f32 projections xp = x W_x + b_x and
// hp = h_in W_h + b_h (products outside, as torch.matmul) and computes r, z,
// n and hn itself, one step ahead of their use, while the step's products
// finish, in place of four elementwise passes and their planes. The step's
// projections, h_in and g_ys arrive by cp.async in a ring of shared-memory
// stages two steps ahead of their use. h_in is read in its own dtype: bf16
// as the forward wrote it, or f32 on the keep path, where
// reference.gru_bwd_project hands it over already scaled by keep in f32 (it
// enters the step only in dh (h_in - n)). B not a multiple of 8 leaves
// ragged rows, computed on zeros and never written.
//
// f32 weights (gru_backward_cluster_kernel, both variants): csrc/lstm.cu's
// f32 reverse recurrence with three gates, on thread block clusters, the
// gate recompute folded in. W_h (192 KB at H=128) fits no SM beside the
// rest, and the first port's one-block design re-read it every step with one thread
// a unit and one FMA chain over K = 3H (~4 us a step). Here a cluster of C
// CTAs owns R batch rows, CTA c the units [c U, c U + U) with W_h's rows of
// those units (48 KB at H=128, C=4) resident in its shared memory; each
// owner lane computes the gate cotangents of its (unit, row) pairs and keeps
// dh in a register, its three d_hproj values go to every CTA through
// distributed shared memory (st.async, counted by an mbarrier a buffer),
// and each CTA then sums d_hproj W_h^T for its units, a warp's 32 lanes
// over slices of the 3H columns for 8 units (each value read serves 8).
// The gates come from the two f32 projections, one step ahead, with the
// accurate f32 sigmoid and tanh, in place of four torch passes and their
// planes.
//
// Above H = 256 (the wide GRU4Rec at D = H = 512, GRU4Rec's 1,000 units) no
// cluster holds W_h: both recurrences, in both dtypes, run the
// grid-persistent layout at the end of this file (one cooperative launch,
// each CTA a slice of the units with their W_h values in its shared memory,
// the step's vector through L2 and one grid barrier a step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "rnn.cuh"

namespace {

constexpr int kMaxHidden = 256;  // the widest H of the block and cluster layouts (wider: the grid layout)
constexpr int kMaxMmaBlock = 128;  // the widest H of the bf16 one-block designs

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc += h . w, in k order.
__device__ __forceinline__ void dot4(float& acc, float4 h, float4 w) {
  acc = fmaf(h.x, w.x, acc);
  acc = fmaf(h.y, w.y, acc);
  acc = fmaf(h.z, w.z, acc);
  acc = fmaf(h.w, w.w, acc);
}

// ---------------------------------------------------------------------------
// f32 forward: the input projection (rnn.cuh), then the recurrence on a
// thread block cluster
// ---------------------------------------------------------------------------

// The recurrence (rnn.cuh's cluster layout, K = H): CTA c of a cluster of C
// owns units [c U, c U + U) of the cluster's R rows. Its shared memory holds
// W_h's columns of its units, all three gates, k-sliced as
// [L/4][3][threads][4] (thread S ul + s reads its slice's four k rows of
// gate g as one float4, consecutive threads consecutive float4s), and h of
// step t in two buffers [2][R][S L + 4] laid out by rnn::slice_pos (a row's
// 4 extra floats put the rows' copies of one unit in different banks). A
// step: every thread sums h[r][k] W_h[k][g H + u] over its slice for its R
// rows and three gates (f32 FMAs; each W_h float4 serves R rows), the
// reduce-scatter leaves the owner lane of (u, r) its r, z and n sums, it
// computes h' in f32, writes ys and stores h' (times keep[t+1] in the reset
// variant) into every CTA's next buffer with st.async, counted by that
// CTA's mbarrier of the buffer, for which one thread waits (then a CTA
// barrier) before the next step reads it. xp (b_x included) and keep
// arrive by cp.async in the lane's slots of a ring, kClusterAhead steps
// ahead. Padded k rows, padded units and rows past B hold zeros and
// are never written.
template <int R, int S, bool kReset, int kRegChunks>
__global__ void __launch_bounds__(rnn::kClusterMaxThreads)
gru_forward_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                           const float* __restrict__ w_h, const float* __restrict__ b_h,
                           const float* __restrict__ keep, float* __restrict__ ys, int B,
                           int Tn, int H, int U) {
  using Own = rnn::Owner<R, 1, S>;
  constexpr int NR = Own::NR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, Up = NT / S;
  const int L = rnn::slice_len(H, S), ld = S * L + 4, H3 = 3 * H;
  float* ws = reinterpret_cast<float*>(smem);  // [L/4][3][NT][4]
  float* hs = ws + 3 * L * NT;                 // [2][R][ld]
  const unsigned C = rnn::cluster::size();
  const int u0 = static_cast<int>(rnn::cluster::rank()) * U;
  const int b0 = static_cast<int>(rnn::cluster::id()) * R;
  const int tid = threadIdx.x, s = tid % S, ul = tid / S, u = u0 + ul;
  const bool unit_ok = ul < U && u < H;
  const Own own(s);

  // W_h's columns of this CTA's units (reads of consecutive units coalesce).
  for (int idx = tid; idx < S * L * 3 * Up; idx += NT) {
    const int k = idx / (3 * Up), g = (idx / Up) % 3, vl = idx % Up;
    const bool in = k < H && vl < U && u0 + vl < H;
    const int ks = k / L, o = k - ks * L;
    ws[(((o >> 2) * 3 + g) * NT + vl * S + ks) * 4 + (o & 3)] =
        in ? w_h[static_cast<size_t>(k) * H3 + g * H + u0 + vl] : 0.0f;
  }
  for (int c = tid; c < 2 * R * ld; c += NT) hs[c] = 0.0f;
  __syncthreads();
  // h_in of step 0 (keep[0] h0) for every unit of the cluster's rows.
  for (int c = tid; c < R * H; c += NT) {
    const int r = c / H, k = c - r * H, b = b0 + r;
    if (b < B) {
      const float h = h0[static_cast<size_t>(b) * H + k];
      hs[r * ld + rnn::slice_pos(k, L, S)] = kReset ? __fmul_rn(h, keep[static_cast<size_t>(b) * Tn]) : h;
    }
  }
  float bh[3], hin[NR];
#pragma unroll
  for (int g = 0; g < 3; ++g) bh[g] = unit_ok ? b_h[g * H + u] : 0.0f;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int b = b0 + own.row0 + k;
    hin[k] = 0.0f;
    if (unit_ok && b < B) {
      const float h = h0[static_cast<size_t>(b) * H + u];
      hin[k] = kReset ? __fmul_rn(h, keep[static_cast<size_t>(b) * Tn]) : h;
    }
  }
  // Step t's operands of the lane's rows into ring stage t % kClusterRing,
  // [stage][NR][threads][4]: xp's r, z and n columns (b_x included) and
  // keep[t+1] (the scale of the h' step t hands on); zeros where there is
  // no such row, unit or step. One commit group a step.
  float* ring = hs + 2 * R * ld;
  auto issue = [&](int t) {
    float* st = ring + (t % rnn::kClusterRing) * NR * NT * 4;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int b = b0 + own.row0 + k;
      const bool in = unit_ok && b < B && t < Tn;
      const float* src = xp + ((static_cast<size_t>(b) * Tn + t) * H3 + u);
      float* dst = st + (k * NT + tid) * 4;
#pragma unroll
      for (int g = 0; g < 3; ++g) mma::cp_async4_zfill(dst + g, in ? src + g * H : xp, in ? 4 : 0);
      const bool kin = kReset && b < B && t + 1 < Tn;
      mma::cp_async4_zfill(dst + 3, kin ? keep + static_cast<size_t>(b) * Tn + t + 1 : xp,
                           kin ? 4 : 0);
    }
    mma::cp_async_commit();
  };
  for (int t = 0; t < rnn::kClusterAhead; ++t) issue(t);
  // h'(t) lands in buffer (t+1) & 1: H R values a fill, from every CTA.
  uint64_t* mb = reinterpret_cast<uint64_t*>(ring + rnn::kClusterRing * NR * NT * 4);
  const unsigned fill_bytes = static_cast<unsigned>(H * R * 4);
  if (tid == 0) {
    rnn::cluster::mbar_init(&mb[0]);
    rnn::cluster::mbar_init(&mb[1]);
    rnn::cluster::mbar_init_fence();
    if (Tn >= 2) rnn::cluster::mbar_expect(&mb[1], fill_bytes);  // h'(0)
    if (Tn >= 3) rnn::cluster::mbar_expect(&mb[0], fill_bytes);  // h'(1)
  }
  rnn::cluster::sync();  // every CTA of the cluster is running, its buffers set

  const float4* w4 = reinterpret_cast<const float4*>(ws);
  // kRegChunks > 0 (L = 4 kRegChunks): the thread's slice of W_h stays in
  // registers for the whole scan, and a step reads only h from shared memory.
  constexpr int kRC = kRegChunks > 0 ? kRegChunks : 1;
  float4 wreg[kRC][3];
  if constexpr (kRegChunks > 0) {
#pragma unroll
    for (int j = 0; j < kRC; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) wreg[j][g] = w4[(j * 3 + g) * NT + tid];
  }
  for (int t = 0; t < Tn; ++t) {
    if (t > 0) {  // wait for h'(t-1): fill n of buffer t & 1
      const int q = t & 1;
      const unsigned n = q ? (t - 1) >> 1 : (t >> 1) - 1;
      if (tid == 0) {
        rnn::cluster::mbar_wait(&mb[q], n & 1);
        if (t + 2 < Tn) rnn::cluster::mbar_expect(&mb[q], fill_bytes);  // h'(t+1)
      }
      __syncthreads();
    }
    const float4* h4 = reinterpret_cast<const float4*>(hs + (t & 1) * R * ld);
    float acc[R][1][3];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0][0] = acc[r][0][1] = acc[r][0][2] = 0.0f;
    if constexpr (kRegChunks > 0) {
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 h = h4[r * (ld / 4) + j * S + s];
          dot4(acc[r][0][0], h, wreg[j][0]);
          dot4(acc[r][0][1], h, wreg[j][1]);
          dot4(acc[r][0][2], h, wreg[j][2]);
        }
      }
    } else {
      for (int j = 0; j < L / 4; ++j) {
        const float4 wr = w4[(j * 3 + 0) * NT + tid];
        const float4 wz = w4[(j * 3 + 1) * NT + tid];
        const float4 wn = w4[(j * 3 + 2) * NT + tid];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 h = h4[r * (ld / 4) + j * S + s];
          dot4(acc[r][0][0], h, wr);
          dot4(acc[r][0][1], h, wz);
          dot4(acc[r][0][2], h, wn);
        }
      }
    }
    rnn::reduce_scatter<R, 1, S / 2, R, 1, 3>(acc, s);

    issue(t + rnn::kClusterAhead);
    mma::cp_async_wait<rnn::kClusterAhead>();  // step t's operands are in
    const float4* cur = reinterpret_cast<const float4*>(ring) + (t % rnn::kClusterRing) * NR * NT;
    float* hn = hs + ((t + 1) & 1) * R * ld;
    float hq[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int row = own.row0 + k;
      const float4 x = cur[k * NT + tid];
      const float rg = sigmoidf(x.x + (acc[k][0][0] + bh[0]));
      const float zg = sigmoidf(x.y + (acc[k][0][1] + bh[1]));
      const float ng = tanhf(x.z + rg * (acc[k][0][2] + bh[2]));
      hq[k] = (1.0f - zg) * ng + zg * hin[k];
      if (t + 1 < Tn) {
        // keep[t+1] scales the h' this step hands to the next one.
        const float hk = kReset ? __fmul_rn(hq[k], x.w) : hq[k];
        hin[k] = hk;
        if (own.owner && unit_ok) {
          const float* dst = hn + row * ld + rnn::slice_pos(u, L, S);
          for (unsigned p = 0; p < C; ++p) {
            rnn::cluster::store_async(rnn::cluster::map(dst, p), hk,
                                      rnn::cluster::map(&mb[(t + 1) & 1], p));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int b = b0 + own.row0 + k;
      if (own.owner && unit_ok && b < B) ys[(static_cast<size_t>(b) * Tn + t) * H + u] = hq[k];
    }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  rnn::cluster::sync();
}

// W_h's slice in registers where it is 16 k values a thread (kGruRegSlice)
// with 8 slices a unit and up to 8 rows (H = 100 on 2 CTAs, H = 128 on 4):
// 48 registers beside the rows' sums.
constexpr int kGruRegSlice = 16;

template <bool kReset>
int launch_cluster_fwd(int R, int S, bool w_in_regs, int clusters, int C, int threads,
                       size_t smem, cudaStream_t st, const float* xp, const float* h0,
                       const float* w_h, const float* b_h, const float* keep, float* ys, int B,
                       int Tn, int H, int U) {
  auto go = [&](auto kernel) {
    return rnn::launch_clusters(kernel, clusters, C, threads, smem, st, xp, h0, w_h, b_h, keep,
                                ys, B, Tn, H, U);
  };
  constexpr int kRC = kGruRegSlice / 4;
  switch (R * 1000 + S * 10 + w_in_regs) {
    case 4080: return go(gru_forward_cluster_kernel<4, 8, kReset, 0>);
    case 4081: return go(gru_forward_cluster_kernel<4, 8, kReset, kRC>);
    case 4160: return go(gru_forward_cluster_kernel<4, 16, kReset, 0>);
    case 8080: return go(gru_forward_cluster_kernel<8, 8, kReset, 0>);
    case 8081: return go(gru_forward_cluster_kernel<8, 8, kReset, kRC>);
    case 8160: return go(gru_forward_cluster_kernel<8, 16, kReset, 0>);
    case 16080: return go(gru_forward_cluster_kernel<16, 8, kReset, 0>);
    case 16160: return go(gru_forward_cluster_kernel<16, 16, kReset, 0>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: the input projection, then the recurrence on tensor cores
// ---------------------------------------------------------------------------

// W_h[k][gate H + unit] and W_h[k + 1][...] as one bf16 pair (the low half
// the lower k): a fragment register of W_h^T, read once at the start of the
// scan; zero past H (k even, H % 4 == 0).
__device__ __forceinline__ uint32_t wh_pair(const __nv_bfloat16* w_h, int H,
                                            int k, int gate, int unit) {
  if (k >= H || unit >= H) return 0u;
  const __nv_bfloat16* p = w_h + static_cast<size_t>(k) * 3 * H + gate * H + unit;
  const uint32_t lo = __bfloat16_as_ushort(p[0]), hi = __bfloat16_as_ushort(p[3 * H]);
  return lo | (hi << 16);
}

// The A fragment of W_h^T for gate `gate`, units u .. u+15 (u = 16 warp)
// and k-step st: a0 = (unit u+g, k 2q, 2q+1), a1 = unit u+g+8,
// a2 = k + 8, a3 = both.
__device__ __forceinline__ void wh_frag(uint32_t a[4], const __nv_bfloat16* w_h, int H,
                                        int st, int gate, int u, int gr, int tq) {
  const int k = 16 * st + 2 * tq;
  a[0] = wh_pair(w_h, H, k, gate, u + gr);
  a[1] = wh_pair(w_h, H, k, gate, u + gr + 8);
  a[2] = wh_pair(w_h, H, k + 8, gate, u + gr);
  a[3] = wh_pair(w_h, H, k + 8, gate, u + gr + 8);
}

// The recurrence, transposed: hp^T = W_h^T h_in^T, so the hidden units are
// mma's M (one m16 tile of each gate a warp) and the batch rows its N (one
// n8 tile: kRows rows a block, none idle). kKS: Hp / 16 (k16 steps and
// warps, Hp <= 128), with W_h^T's A fragments in registers. kReset as the
// f32 kernel's. Wider Hp: gru_forward_wide_kernel.
using rnn::kRows;
template <int kKS, bool kReset>
__global__ void __launch_bounds__(32 * kKS, 1)
gru_forward_mma_kernel(const float* __restrict__ xp,
                       const __nv_bfloat16* __restrict__ h0,
                       const __nv_bfloat16* __restrict__ w_h,
                       const float* __restrict__ b_h,
                       const float* __restrict__ keep,
                       __nv_bfloat16* __restrict__ ys, int B, int Tn, int H) {
  constexpr int R = kRows;
  constexpr int KS = kKS;
  constexpr int Hp = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  // h^T, unit-major: [2][Hp][R] bf16 (a unit's 8 rows are 16 bytes).
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int b0 = blockIdx.x * R, H3 = 3 * H, u = 16 * warp;
  // This lane's C positions, the same in each gate's tile: units
  // u + gr + 8 m (m = 0, 1) of rows 2 tq + e (e = 0, 1); index p = 2 m + e,
  // the C register.
  bool unit_ok[2], row_ok[2];
  size_t row_base[2];  // (b * T) of the lane's rows
#pragma unroll
  for (int m = 0; m < 2; ++m) unit_ok[m] = u + gr + 8 * m < H;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = b0 + 2 * tq + e;
    row_ok[e] = b < B;
    row_base[e] = static_cast<size_t>(b) * Tn;
  }

  uint32_t whf[kKS][3][4];
#pragma unroll
  for (int st = 0; st < kKS; ++st)
#pragma unroll
    for (int q = 0; q < 3; ++q) wh_frag(whf[st][q], w_h, H, st, q, u, gr, tq);
  float bh[3][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int m = 0; m < 2; ++m) bh[q][m] = unit_ok[m] ? b_h[q * H + u + gr + 8 * m] : 0.0f;

  // h_in of step 0 (keep[0] * h0, rounded to bf16): in registers, and in
  // buffer 0 (every row and padded unit of it, zeros where there is none).
  // A lane's two rows of one unit are adjacent: one 4-byte store.
  float hreg[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int unit = u + gr + 8 * m;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 2 * tq + e;
      float h = 0.0f;
      if (row_ok[e] && unit_ok[m]) {
        h = __bfloat162float(h0[static_cast<size_t>(b0 + row) * H + unit]);
        if (kReset) h = __bfloat162float(__float2bfloat16(h * keep[row_base[e]]));
      }
      hreg[2 * m + e] = h;
    }
    *reinterpret_cast<__nv_bfloat162*>(hs + unit * R + 2 * tq) =
        __floats2bfloat162_rn(hreg[2 * m], hreg[2 * m + 1]);
  }

  // xp (and keep) of step t for the lane's positions: [gate][p].
  auto load_step = [&](int t, float (&xv)[3][4], float (&kv)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kv[e] = kReset && row_ok[e] ? keep[row_base[e] + t] : 1.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          xv[q][2 * m + e] = row_ok[e] && unit_ok[m]
                                 ? xp[(row_base[e] + t) * H3 + q * H + u + gr + 8 * m]
                                 : 0.0f;
        }
    }
  };
  float xc[3][4], keep0[2];  // keep[0] is already in h_in of step 0
  load_step(0, xc, keep0);
  __syncthreads();

  // The lane's ldmatrix.trans row of the B fragment (h^T): unit lane % 16 of
  // the k-step (lanes 16-31 repeat 0-15; x2 reads only the first 16).
  const int b_off = (lane & 15) * R;
  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1;
    float xn[3][4], kn[2] = {};  // the last step hands nothing on
    if (t + 1 < Tn) load_step(t + 1, xn, kn);

    const __nv_bfloat16* hc = hs + cur * Hp * R;
    float acc[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      uint32_t b[2];
      mma::ldmatrix_x2_trans(b, hc + 16 * st * R + b_off);
#pragma unroll
      for (int q = 0; q < 3; ++q) mma::bf16_16x8x16(acc[q], whf[st][q], b[0], b[1]);
    }

    __nv_bfloat16* hn = hs + (cur ^ 1) * Hp * R;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int unit = u + gr + 8 * m;
      __nv_bfloat16 hk[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 2 * m + e;
        const float rg = rnn::fast_sigmoid(xc[0][p] + (acc[0][p] + bh[0][m]));
        const float zg = rnn::fast_sigmoid(xc[1][p] + (acc[1][p] + bh[1][m]));
        const float ng = rnn::fast_tanh(xc[2][p] + rg * (acc[2][p] + bh[2][m]));
        const __nv_bfloat16 hq = __float2bfloat16((1.0f - zg) * ng + zg * hreg[p]);
        if (row_ok[e] && unit_ok[m]) ys[(row_base[e] + t) * H + unit] = hq;
        // keep[t+1] scales the h' this step hands to the next one.
        hk[e] = kReset ? __float2bfloat16(__bfloat162float(hq) * kn[e]) : hq;
        hreg[p] = __bfloat162float(hk[e]);
      }
      *reinterpret_cast<__nv_bfloat162*>(hn + unit * R + 2 * tq) = __halves2bfloat162(hk[0], hk[1]);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) xc[q][p] = xn[q][p];
    __syncthreads();
  }
}

template <bool kReset>
int launch_mma(const float* xp, const void* h0, const void* w_h,
               const float* b_h, const float* keep, void* ys, int B, int Tn,
               int H, size_t smem, cudaStream_t s) {
  const int ks = (H + 15) / 16;
  const dim3 grid((B + kRows - 1) / kRows), block(32 * ks);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        xp, static_cast<const __nv_bfloat16*>(h0), static_cast<const __nv_bfloat16*>(w_h),
        b_h, keep, static_cast<__nv_bfloat16*>(ys), B, Tn, H);
    return static_cast<int>(cudaGetLastError());
  };
  switch (ks) {
    case 1: return launch(gru_forward_mma_kernel<1, kReset>);
    case 2: return launch(gru_forward_mma_kernel<2, kReset>);
    case 3: return launch(gru_forward_mma_kernel<3, kReset>);
    case 4: return launch(gru_forward_mma_kernel<4, kReset>);
    case 5: return launch(gru_forward_mma_kernel<5, kReset>);
    case 6: return launch(gru_forward_mma_kernel<6, kReset>);
    case 7: return launch(gru_forward_mma_kernel<7, kReset>);
    case 8: return launch(gru_forward_mma_kernel<8, kReset>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 reverse recurrence on a thread block cluster: lstm.cu's
// lstm_backward_cluster_kernel with three gates and the gate recompute
// folded in (rnn.cuh's cluster layout, K = 3H). CTA c of a cluster of C owns
// units [c U, c U + U) of the cluster's R rows. Its shared memory holds W_h's
// rows of its units (all 3H columns, k-sliced as [L/4][kBwdUnits][threads][4]:
// a warp's 32 lanes each sum one slice of the columns for kBwdUnits units, so
// each d_hproj value read serves them all) and d_hproj of the step in two buffers
// [2][R][S L + 4] laid out by rnn::slice_pos. The step's operands of a lane's
// (unit, row) pairs (the two projections' r, z and n columns, h_in, g_y and
// keep[t]) arrive by cp.async in its slots of a ring, kClusterAhead steps
// ahead, and the lane turns them into the gates r, z, n and hn (and the
// factors the cotangents take from them) one step ahead of their use, while
// the exchange of the step before is in flight, so the serial chain holds
// only the multiplies by the carry. A step, for t = T-1 .. 0: the owner lane
// of (u, r) adds g_y to its dh carry, computes dpre_r, dpre_z, dpre_n, writes
// d_xp and dn_r = dpre_n r, and stores the three d_hproj values into every
// CTA's buffer with st.async (counted by that CTA's mbarrier of the buffer);
// one thread waits for the buffer's fill, then a CTA barrier; then every
// thread sums d_hproj[r][col] W_h[u][col] over its slice for the R rows and
// the reduce-scatter leaves the owner dh_prev = dh z + that sum (times
// keep[t]).
// Units a warp sums for: with 8, the 32 lanes of 4 rows own one (unit, row)
// pair each (with 4, half the lanes repeat their partner's gate work) and a
// CTA has half the warps (kernel_probes.py clusters: 0.52 -> 0.43 ms at
// B=128, T=200, H=128 on 2 CTAs of 4 rows, on an H100).
constexpr int kBwdUnits = 8;
constexpr int kBwdOperands = 12;  // ring floats a pair a step: 9 used, three float4

template <int R, bool kReset>
__global__ void __launch_bounds__(rnn::kClusterMaxThreads)
gru_backward_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ hp,
                            const float* __restrict__ h_in, const float* __restrict__ g_ys,
                            const float* __restrict__ w_h, const float* __restrict__ keep,
                            float* __restrict__ d_xp, float* __restrict__ dn_r,
                            float* __restrict__ dh0, int B, int Tn, int H, int U) {
  constexpr int S = 32, UT = kBwdUnits;
  using Own = rnn::Owner<R, UT, 32>;
  constexpr int NRo = Own::NR, NUo = Own::NU, NP = NRo * NUo;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, Up = NT / S * UT, H3 = 3 * H;
  const int L = rnn::slice_len(H3, S), ld = S * L + 4;
  float* ws = reinterpret_cast<float*>(smem);  // [L/4][UT][NT][4]
  float* dps = ws + UT * L * NT;               // [2][R][ld]
  float* ring = dps + 2 * R * ld;              // [stage][NP][NT][kBwdOperands]
  const unsigned C = rnn::cluster::size();
  const int u0 = static_cast<int>(rnn::cluster::rank()) * U;
  const int b0 = static_cast<int>(rnn::cluster::id()) * R;
  const int tid = threadIdx.x, lane = tid & 31, ug = tid >> 5;
  const Own own(lane);
  // The lane's (unit, row) pairs: units u0 + UT ug + ut0 + m, rows row0 + k.
  int unit[NUo];
  bool unit_ok[NUo];
#pragma unroll
  for (int m = 0; m < NUo; ++m) {
    const int vl = UT * ug + own.ut0 + m;
    unit[m] = u0 + vl;
    unit_ok[m] = vl < U && unit[m] < H;
  }

  // W_h's rows of this CTA's units (a row's columns are contiguous): unit
  // UT g + ut's columns of slice s sit at [j][ut][32 g + s][4].
  for (int idx = tid; idx < Up * S * L; idx += NT) {
    const int vl = idx / (S * L), col = idx - vl * S * L;
    const bool in = col < H3 && vl < U && u0 + vl < H;
    const int ks = col / L, o = col - ks * L;
    ws[((((o >> 2) * UT + vl % UT) * NT) + (vl / UT) * S + ks) * 4 + (o & 3)] =
        in ? w_h[static_cast<size_t>(u0 + vl) * H3 + col] : 0.0f;
  }
  for (int c = tid; c < 2 * R * ld; c += NT) dps[c] = 0.0f;

  // Step t = T-1-it's operands of the lane's pairs into ring stage
  // it % kClusterRing: xp's r, z, n, hp's r | hp's z, n, h_in, g_y | keep[t];
  // zeros where there is no such row, unit or step. One commit group a step.
  auto issue = [&](int it) {
    const int t = Tn - 1 - it;
    float* st = ring + (it % rnn::kClusterRing) * NP * NT * kBwdOperands;
#pragma unroll
    for (int k = 0; k < NRo; ++k) {
      const int b = b0 + own.row0 + k;
#pragma unroll
      for (int m = 0; m < NUo; ++m) {
        const bool in = unit_ok[m] && b < B && t >= 0;
        const size_t bt = static_cast<size_t>(b) * Tn + t;
        const size_t i3 = bt * H3 + unit[m], i1 = bt * H + unit[m];
        float* dst = st + ((k * NUo + m) * NT + tid) * kBwdOperands;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          mma::cp_async4_zfill(dst + q, in ? xp + i3 + q * H : xp, in ? 4 : 0);
          mma::cp_async4_zfill(dst + 3 + q, in ? hp + i3 + q * H : xp, in ? 4 : 0);
        }
        mma::cp_async4_zfill(dst + 6, in ? h_in + i1 : xp, in ? 4 : 0);
        mma::cp_async4_zfill(dst + 7, in ? g_ys + i1 : xp, in ? 4 : 0);
        const bool kin = kReset && b < B && t >= 0;
        mma::cp_async4_zfill(dst + 8, kin ? keep + bt : xp, kin ? 4 : 0);
      }
    }
    mma::cp_async_commit();
  };
  // The gates of step T-1-it from its stage (this lane's own copies), as
  // reference.gru_bwd_gates computes them, and the factors the step's
  // cotangents take from them: r, z, 1 - z, 1 - n^2, h_in - n, z (1 - z), hn,
  // r (1 - r), g_y, keep.
  float gf[NRo][NUo][10];
  auto gates = [&](int it) {
    const float4* st = reinterpret_cast<const float4*>(ring) +
                       (it % rnn::kClusterRing) * NP * NT * (kBwdOperands / 4);
#pragma unroll
    for (int k = 0; k < NRo; ++k)
#pragma unroll
      for (int m = 0; m < NUo; ++m) {
        const float4* p = st + ((k * NUo + m) * NT + tid) * (kBwdOperands / 4);
        const float4 a = p[0], c = p[1];
        const float kp = reinterpret_cast<const float*>(p)[8];
        const float r = sigmoidf(a.x + a.w);
        const float z = sigmoidf(a.y + c.x);
        const float hn = c.y;
        const float n = tanhf(a.z + r * hn);
        float* f = gf[k][m];
        f[0] = r;
        f[1] = z;
        f[2] = 1.0f - z;
        f[3] = 1.0f - n * n;
        f[4] = c.z - n;
        f[5] = z * (1.0f - z);
        f[6] = hn;
        f[7] = r * (1.0f - r);
        f[8] = c.w;
        f[9] = kp;
      }
  };
  for (int it = 0; it < rnn::kClusterAhead; ++it) issue(it);
  // d_hproj of iteration it lands in buffer it & 1: 3 H R values a fill.
  uint64_t* mb = reinterpret_cast<uint64_t*>(ring + rnn::kClusterRing * NP * NT * kBwdOperands);
  const unsigned fill_bytes = static_cast<unsigned>(H3 * R * 4);
  if (tid == 0) {
    rnn::cluster::mbar_init(&mb[0]);
    rnn::cluster::mbar_init(&mb[1]);
    rnn::cluster::mbar_init_fence();
    rnn::cluster::mbar_expect(&mb[0], fill_bytes);
    if (Tn >= 2) rnn::cluster::mbar_expect(&mb[1], fill_bytes);
  }
  rnn::cluster::sync();  // every CTA of the cluster is running, its buffers zero
  mma::cp_async_wait<rnn::kClusterAhead - 1>();  // step T-1's operands are in
  gates(0);

  float dh_c[NRo][NUo];
#pragma unroll
  for (int k = 0; k < NRo; ++k)
#pragma unroll
    for (int m = 0; m < NUo; ++m) dh_c[k][m] = 0.0f;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (int t = Tn - 1, it = 0; t >= 0; --t, ++it) {
    float* dp = dps + (it & 1) * R * ld;
    issue(it + rnn::kClusterAhead);
    float keep_t[NRo][NUo], dhz[NRo][NUo];
#pragma unroll
    for (int k = 0; k < NRo; ++k) {
      const int row = own.row0 + k, b = b0 + row;
#pragma unroll
      for (int m = 0; m < NUo; ++m) {
        const float* f = gf[k][m];
        const float dh = dh_c[k][m] + f[8];
        const float dpre_n = dh * f[2] * f[3];
        const float dpre_z = dh * f[4] * f[5];
        const float dpre_r = dpre_n * f[6] * f[7];
        const float d[3] = {dpre_r, dpre_z, dpre_n * f[0]};
        if (own.owner && unit_ok[m]) {
          float* row_dp = dp + row * ld;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float* dst = row_dp + rnn::slice_pos(q * H + unit[m], L, S);
            for (unsigned p = 0; p < C; ++p) {
              rnn::cluster::store_async(rnn::cluster::map(dst, p), d[q],
                                        rnn::cluster::map(&mb[it & 1], p));
            }
          }
          if (b < B) {
            const size_t bt = static_cast<size_t>(b) * Tn + t;
            float* out = d_xp + bt * H3 + unit[m];
            out[0] = dpre_r;
            out[H] = dpre_z;
            out[2 * H] = dpre_n;
            dn_r[bt * H + unit[m]] = d[2];
          }
        }
        dhz[k][m] = __fmul_rn(dh, f[1]);
        keep_t[k][m] = f[9];
      }
    }
    // The next step's gates while this step's exchange is in flight.
    if (t > 0) {
      mma::cp_async_wait<rnn::kClusterAhead - 1>();  // step t-1's operands are in
      gates(it + 1);
    }
    if (tid == 0) {  // wait for d_hproj of this step: fill it >> 1 of buffer it & 1
      rnn::cluster::mbar_wait(&mb[it & 1], (it >> 1) & 1);
      if (it + 2 < Tn) rnn::cluster::mbar_expect(&mb[it & 1], fill_bytes);
    }
    __syncthreads();

    // d_hproj @ W_h^T for this warp's UT units: each d_hproj float4 serves
    // UT units.
    const float4* d4 = reinterpret_cast<const float4*>(dp);
    float acc[R][UT][1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int ut = 0; ut < UT; ++ut) acc[r][ut][0] = 0.0f;
    for (int j = 0; j < L / 4; ++j) {
      float4 w[UT];
#pragma unroll
      for (int ut = 0; ut < UT; ++ut) w[ut] = w4[(j * UT + ut) * NT + tid];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = d4[r * (ld / 4) + j * S + lane];
#pragma unroll
        for (int ut = 0; ut < UT; ++ut) dot4(acc[r][ut][0], v, w[ut]);
      }
    }
    rnn::reduce_scatter<R, UT, 16, R, UT, 1>(acc, lane);
#pragma unroll
    for (int k = 0; k < NRo; ++k)
#pragma unroll
      for (int m = 0; m < NUo; ++m) {  // dh_prev = dh z + d_hproj W_h^T, times keep[t]
        const float dn = __fadd_rn(dhz[k][m], acc[k][m][0]);
        dh_c[k][m] = kReset ? __fmul_rn(dn, keep_t[k][m]) : dn;
      }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  rnn::cluster::sync();
#pragma unroll
  for (int k = 0; k < NRo; ++k) {
    const int b = b0 + own.row0 + k;
#pragma unroll
    for (int m = 0; m < NUo; ++m) {
      if (own.owner && unit_ok[m] && b < B) dh0[static_cast<size_t>(b) * H + unit[m]] = dh_c[k][m];
    }
  }
}

template <bool kReset>
int launch_cluster_bwd(int R, int clusters, int C, int threads, size_t smem, cudaStream_t st,
                       const float* xp, const float* hp, const float* h_in, const float* g_ys,
                       const float* w_h, const float* keep, float* d_xp, float* dn_r,
                       float* dh0, int B, int Tn, int H, int U) {
  auto go = [&](auto kernel) {
    return rnn::launch_clusters(kernel, clusters, C, threads, smem, st, xp, hp, h_in, g_ys,
                                w_h, keep, d_xp, dn_r, dh0, B, Tn, H, U);
  };
  switch (R) {
    case 4: return go(gru_backward_cluster_kernel<4, kReset>);
    case 8: return go(gru_backward_cluster_kernel<8, kReset>);
    case 16: return go(gru_backward_cluster_kernel<16, kReset>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 weights: the reverse recurrence on tensor cores
// ---------------------------------------------------------------------------

using rnn::kStages;
using rnn::load_frag;
using rnn::Positions;
using rnn::RowPiece;
using rnn::zero_smem;
constexpr int kGates = 3;  // r, z, n

// The reverse recurrence's shared memory (bytes): the d_hproj^T double
// buffer [2][hi, lo][3 Hp][8] bf16, then the ring of per-step stages. A
// stage holds the six gate blocks of the two projections, x_r, x_z, x_n,
// h_r, h_z, h_n [6][8][Hp + 4] f32, h_in [8][Hp + 4] f32 or [8][Hp + 8] bf16
// (at byte `hin`), and g_ys [8][Hp + 8] bf16 (at `gy`); the pads keep a
// lane's reads free of bank conflicts.
struct BwdSmem {
  int part, sp, sg, sh, hin, gy, ring, stage, total;
  __host__ __device__ BwdSmem(int Hp, int hin_bytes)
      : part(kGates * Hp * kRows), sp(Hp + 4), sg(Hp + 8), sh(hin_bytes == 4 ? sp : sg),
        hin(6 * kRows * sp * 4), gy(hin + kRows * sh * hin_bytes),
        ring(2 * 2 * part * 2),
        stage(gy + kRows * sg * 2), total(ring + kStages * stage) {}
};

// dh_prev^T = W_h d_hproj^T, K = 3 Hp (Hp = 16 ceil(H / 16) <= 128; wider:
// gru_backward_wide_kernel). kMT = Hp / 16 (warps, m16 tiles of units, each
// warp its own tile over all 3 kMT k-steps), with W_h's A fragments in
// registers. w_frag: [Hp/16 tiles][3 Hp/16 k-steps][32 lanes] x 16 bytes.
// The gates come from the two f32 projections xp = x W_x + b_x and hp = h_in W_h + b_h ([B, T, 3H]),
// one step ahead of their use; the kernel writes d_xp and the n-block of
// d_hproj (dn_r = dpre_n r, [B, T, H]) for the weight gradients. kReset as
// the f32 kernel's; HT is h_in's dtype (float or bf16).
template <int kMT, bool kReset, typename HT>
__global__ void __launch_bounds__(32 * kMT, 1)
gru_backward_mma_kernel(const float* __restrict__ xp, const float* __restrict__ hp,
                        const HT* __restrict__ h_in, const __nv_bfloat16* __restrict__ g_ys,
                        const uint4* __restrict__ w_frag, const float* __restrict__ keep,
                        float* __restrict__ d_xp, float* __restrict__ dn_r,
                        float* __restrict__ dh0, int B, int Tn, int H) {
  constexpr int R = kRows;
  constexpr int MT = kMT;
  constexpr int Hp = 16 * MT, KS = kGates * MT;
  const int H3 = kGates * H;
  const BwdSmem L(Hp, sizeof(HT));
  extern __shared__ __align__(16) unsigned char smem[];
  // d_hproj^T, k-major (k = gate Hp + unit): [2][hi, lo][3 Hp][R] bf16.
  __nv_bfloat16* dbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Positions pos(B, Tn, H);
  const int b0 = blockIdx.x * R;

  const uint4* wf = w_frag + static_cast<size_t>(warp) * KS * 32 + lane;
  uint32_t wr[KS][4];
#pragma unroll
  for (int st = 0; st < KS; ++st) load_frag(wr[st], wf + st * 32);

  // The step's operands arrive in a ring of kStages stages, by cp.async,
  // kStages - 1 steps ahead of their use. Rows past B and units past H are
  // never copied and stay zero, so their cotangents are zero. A thread
  // copies at most one piece of each plane's 8-row block.
  zero_smem(smem, L.total);
  __syncthreads();
  const RowPiece piece(B, Tn, H);
  auto stage_step = [&](int t, int slot) {
    if (t >= 0 && piece.has) {
      unsigned char* st = smem + L.ring + slot * L.stage;
      float* ps = reinterpret_cast<float*>(st);
      const size_t pj = piece.src(t, H3), src = piece.src(t, H);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        mma::cp_async16_zfill(ps + (j * R + piece.r) * L.sp + 4 * piece.k,
                              (j < 3 ? xp : hp) + pj + (j % 3) * H, 16);
      }
      HT* hs = reinterpret_cast<HT*>(st + L.hin) + piece.r * L.sh + 4 * piece.k;
      if (sizeof(HT) == 4) {
        mma::cp_async16_zfill(hs, h_in + src, 16);
      } else {
        mma::cp_async8_zfill(hs, h_in + src, 8);
      }
      __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(st + L.gy);
      mma::cp_async8_zfill(gs + piece.r * L.sg + 4 * piece.k, g_ys + src, 8);
    }
    mma::cp_async_commit();  // an empty group past t = 0 keeps the count
  };
  stage_step(Tn - 1, 0);
  stage_step(Tn - 2, 1);

  // keep[t] (dh_prev *= keep[t]), loaded a step ahead.
  auto load_keep = [&](int t, float (&kv)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) kv[e] = kReset && pos.row_ok[e] ? keep[pos.row_base[e] + t] : 1.0f;
  };
  float nk[2];
  load_keep(Tn - 1, nk);
  float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma::cp_async_wait<1>();
  __syncthreads();

  // r, z, n, hn of the lane's positions p from a stage's projections
  // (rnn.cuh's fast gate functions, as the forward's). Rows past B and units
  // past H read zeros, and their cotangents stay zero.
  auto gates = [&](int slot, float (&g)[4][4]) {
    const float* ps = reinterpret_cast<const float*>(smem + L.ring + slot * L.stage);
    const int blk = R * L.sp;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* x = ps + (2 * pos.tq + e) * L.sp + pos.unit(m);
        const float r = rnn::fast_sigmoid(x[0] + x[3 * blk]);
        const float hn = x[5 * blk];
        g[2 * m + e][0] = r;
        g[2 * m + e][1] = rnn::fast_sigmoid(x[blk] + x[4 * blk]);
        g[2 * m + e][2] = rnn::fast_tanh(x[2 * blk] + r * hn);
        g[2 * m + e][3] = hn;
      }
  };
  float gt[4][4];  // the gates of the step about to run
  gates(0, gt);

  // The lane's ldmatrix.trans row: lanes 0-15 address hi's k rows 0-15 of a
  // k-step, lanes 16-31 lo's, so one x4 brings both B fragments.
  const int b_off = (lane & 15) * R + (lane >> 4) * L.part;
  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    stage_step(t - 2, (s + 2) % kStages);
    const float ck[2] = {nk[0], nk[1]};
    if (t > 0) load_keep(t - 1, nk);
    const unsigned char* st = smem + L.ring + (s % kStages) * L.stage;
    const HT* hs = reinterpret_cast<const HT*>(st + L.hin);
    const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(st + L.gy);
    __nv_bfloat16* db = dbuf + (s & 1) * 2 * L.part;  // this step's d_hproj^T

    float dhz[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float dp[kGates][2];  // d_hproj of (unit m, rows e)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 2 * m + e, row = 2 * pos.tq + e, unit = pos.unit(m);
        const float rv = gt[p][0], zv = gt[p][1], nv = gt[p][2], hnv = gt[p][3];
        const float hin = to_f(hs[row * L.sh + unit]);
        const float dh = carry[p] + __bfloat162float(gs[row * L.sg + unit]);
        const float dpre_n = dh * (1.0f - zv) * (1.0f - nv * nv);
        const float dpre_z = dh * (hin - nv) * zv * (1.0f - zv);
        const float dpre_r = dpre_n * hnv * rv * (1.0f - rv);
        dp[0][e] = dpre_r;
        dp[1][e] = dpre_z;
        dp[2][e] = dpre_n * rv;
        if (pos.ok(m, e)) {
          float* out = d_xp + (pos.row_base[e] + t) * H3 + unit;
          out[0] = dpre_r;
          out[H] = dpre_z;
          out[2 * H] = dpre_n;
          dn_r[pos.at(m, e, t, H)] = dp[2][e];
        }
        dhz[p] = dh * zv;
      }
      // d_hproj split for the product: hi = bf16(d), lo = bf16(d - hi).
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(dp[q][0], dp[q][1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(dp[q][0] - __low2float(hi),
                                                       dp[q][1] - __high2float(hi));
        __nv_bfloat16* row = db + (q * Hp + pos.unit(m)) * R + 2 * pos.tq;
        *reinterpret_cast<__nv_bfloat162*>(row) = hi;
        *reinterpret_cast<__nv_bfloat162*>(row + L.part) = lo;
      }
    }
    mma::cp_async_wait<1>();  // step t-1's operands have landed (this thread's)
    __syncthreads();          // ... everyone's, and d_hproj^T is whole

    // Two independent chains (hi, lo) over the warp's KS k-steps; the B
    // fragments are loaded a k-step ahead of their products.
    float acc[2][4] = {};
    const __nv_bfloat16* dk = db + b_off;
    uint32_t bq[2][4];
    mma::ldmatrix_x4_trans(bq[0], dk);
#pragma unroll
    for (int st2 = 0; st2 < KS; st2 += 2) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int k = st2 + par;
        if (k < KS) {
          if (k + 1 < KS) mma::ldmatrix_x4_trans(bq[par ^ 1], dk + 16 * (k + 1) * R);
          mma::bf16_16x8x16(acc[0], wr[k], bq[par][0], bq[par][1]);
          mma::bf16_16x8x16(acc[1], wr[k], bq[par][2], bq[par][3]);
        }
      }
    }
    // Step t-1's gates (its stage landed before this step's barrier), while
    // the products finish.
    if (t > 0) gates((s + 1) % kStages, gt);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      carry[p] = dhz[p] + (acc[0][p] + acc[1][p]);
      if (kReset) carry[p] *= ck[p & 1];  // dh_prev *= keep[t]
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (pos.ok(m, e)) {
        dh0[static_cast<size_t>(b0 + 2 * pos.tq + e) * H + pos.unit(m)] = carry[2 * m + e];
      }
}

template <bool kReset, typename HT>
int launch_bwd_mma(const float* xp, const float* hp, const void* h_in, const void* g_ys,
                   const void* w_frag, const float* keep, float* d_xp, float* dn_r, float* dh0,
                   int B, int Tn, int H, size_t smem, cudaStream_t s) {
  const int mt = (H + 15) / 16;
  const dim3 grid((B + kRows - 1) / kRows), block(32 * mt);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        xp, hp, static_cast<const HT*>(h_in), static_cast<const __nv_bfloat16*>(g_ys),
        static_cast<const uint4*>(w_frag), keep, d_xp, dn_r, dh0, B, Tn, H);
    return static_cast<int>(cudaGetLastError());
  };
  switch (mt) {
    case 1: return launch(gru_backward_mma_kernel<1, kReset, HT>);
    case 2: return launch(gru_backward_mma_kernel<2, kReset, HT>);
    case 3: return launch(gru_backward_mma_kernel<3, kReset, HT>);
    case 4: return launch(gru_backward_mma_kernel<4, kReset, HT>);
    case 5: return launch(gru_backward_mma_kernel<5, kReset, HT>);
    case 6: return launch(gru_backward_mma_kernel<6, kReset, HT>);
    case 7: return launch(gru_backward_mma_kernel<7, kReset, HT>);
    case 8: return launch(gru_backward_mma_kernel<8, kReset, HT>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 above Hp = 128: both recurrences on thread block clusters
// ---------------------------------------------------------------------------
//
// At Hp = 256, W_h is 384 KB of bf16: more than one SM's registers (256 KB)
// or shared memory (227 KB). The block designs above hold it in registers
// only up to Hp = 128, and reading its fragments from global memory every
// step costs ~16.5 us a step at B=128, H=256 (PERF.md). Here a cluster of
// kWideCluster = 4 CTAs owns 8 batch rows (one n8 tile, as the block
// designs) and splits W_h between its CTAs, each CTA's quarter held in its
// registers for the whole scan, so that a step reads no weight from L2 (an
// H100 probe found 4 CTAs 31-39% faster than 2 CTAs of 128 units, half of
// whose fragments must sit in shared memory; PERF.md). Each layout pads
// units and k to kWide = 256 (zero weights, biases and operands; a padded
// unit stays 0), so one instantiation takes every 128 < Hp <= 256. Per step
// the CTAs exchange the smaller of the two vectors on the serial chain
// through distributed shared memory (st.async, counted by an mbarrier a
// buffer, rnn.cuh): the forward its units of h (bf16, 4 KB a step a
// cluster), the reverse its partial sums of dh_prev (f32, 8 KB), never the
// 3H-wide projections or cotangents.

constexpr int kWide = 256;        // units and k the cluster layouts pad to (kMaxHidden)
constexpr int kWideCluster = 4;   // CTAs a cluster
constexpr int kWideUnits = kWide / kWideCluster;  // units a CTA owns: 64
constexpr int kWideWarps = 8;     // a CTA of either recurrence
constexpr int kWideThreads = 32 * kWideWarps;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// (a, b) into `addr` (a map()ped address, 8-byte aligned) of a CTA whose
// mbarrier is at `mbar`, counting 8 bytes there.
__device__ __forceinline__ void store_async2(unsigned addr, float a, float b, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
      ::"r"(addr), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(mbar) : "memory");
}

// The wide forward's shared memory (bytes): h^T's two buffers [2][kWide][8]
// bf16 (unit-major, as the block design's), the K halves' partial sums
// [4 tiles][2 halves][3 gates x 2 rows][32 lanes] f32, then two mbarriers.
constexpr int kWideFwdRed = 2 * kWide * kRows * 2;
constexpr int kWideFwdMbar = kWideFwdRed + 4 * 2 * 6 * 32 * 4;
constexpr int kWideFwdSmem = kWideFwdMbar + 2 * 8;

// The forward recurrence for 128 < Hp <= 256, hp^T = W_h^T h_in^T as in the
// block design (units as M, 8 rows as N), on a cluster of kWideCluster
// CTAs: CTA c owns units [c U, c U + U), U = kWideUnits, of all three gates,
// so the r, z and n sums of a (unit, row) pair land in one lane and the gate
// math needs no exchange. 8 warps, two a tile of 16 units, each over half of
// K (8 k-steps: 96 fragment registers a lane); the pair adds its partial
// sums through shared memory (a named barrier a tile) and each warp takes
// the gate math of one of the tile's two 8-unit halves. w_frag: W_h^T's A
// fragments [16 tiles][16 k-steps][3 gates][32 lanes] x 16 bytes
// (ops/cuda/gru.py forward_fragments), zero past H. A step: every thread
// waits for the mbarrier of h(t)'s buffer, loads its xp (and keep) of step
// t+1, runs the products from that buffer, computes h' of its pairs, writes
// ys and stores h' (times keep[t+1] in the reset variant; two rows a 4-byte
// st.async) into the next buffer of every CTA of the cluster. No CTA
// barrier on the chain: a CTA's warps read buffer t & 1 before they store
// their units of h'(t), and no CTA refills that buffer (with h'(t+1)) before
// it has all of h'(t). The numerics are the block design's: products and
// gate math in f32, h rounded to bf16 every step.
template <bool kReset>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_forward_wide_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ h0,
                        const uint4* __restrict__ w_frag, const float* __restrict__ b_h,
                        const float* __restrict__ keep, __nv_bfloat16* __restrict__ ys, int B,
                        int Tn, int H) {
  constexpr int R = kRows;
  constexpr int kTiles = kWideUnits / 16;  // m16 tiles of units a CTA: 4, two warps each
  constexpr int kKS = kWide / 16 / 2;      // k-steps a warp, half of K: 8
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kWide][R]
  float* red = reinterpret_cast<float*>(smem + kWideFwdRed);
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + kWideFwdMbar);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int tile = warp % kTiles, half = warp / kTiles;
  const int gtile = static_cast<int>(rnn::cluster::rank()) * kTiles + tile;
  const int b0 = static_cast<int>(rnn::cluster::id()) * R;
  const int H3 = 3 * H;
  // The lane's gate-math pairs: unit `unit` (in the warp's 8-unit half of
  // its tile) of rows 2 tq + e.
  const int unit = 16 * gtile + 8 * half + gr;
  const bool unit_ok = unit < H;
  bool row_ok[2];
  size_t row_base[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = b0 + 2 * tq + e;
    row_ok[e] = b < B;
    row_base[e] = static_cast<size_t>(b) * Tn;
  }

  // W_h^T's fragments of the warp's tile and half of K, into registers.
  const uint4* wf = w_frag + (static_cast<size_t>(gtile) * (kWide / 16) + half * kKS) * 3 * 32 + lane;
  uint32_t wr[kKS][3][4];
#pragma unroll
  for (int j = 0; j < kKS; ++j)
#pragma unroll
    for (int q = 0; q < 3; ++q) rnn::load_frag(wr[j][q], wf + (j * 3 + q) * 32);
  float bh[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) bh[q] = unit_ok ? b_h[q * H + unit] : 0.0f;

  // h_in of step 0 (keep[0] h0, rounded to bf16) of every unit of the
  // cluster's rows into buffer 0 (zeros past H and B), and of the lane's
  // pairs into registers.
  for (int c = tid; c < kWide * R; c += kWideThreads) {
    const int k = c / R, b = b0 + c % R;
    float h = 0.0f;
    if (k < H && b < B) {
      h = __bfloat162float(h0[static_cast<size_t>(b) * H + k]);
      if (kReset) h = __bfloat162float(__float2bfloat16(h * keep[static_cast<size_t>(b) * Tn]));
    }
    hs[c] = __float2bfloat16(h);
  }
  float hreg[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float h = 0.0f;
    if (row_ok[e] && unit_ok) {
      h = __bfloat162float(h0[static_cast<size_t>(b0 + 2 * tq + e) * H + unit]);
      if (kReset) h = __bfloat162float(__float2bfloat16(h * keep[row_base[e]]));
    }
    hreg[e] = h;
  }

  // h'(t) lands in buffer (t+1) & 1: every unit of every row, kWide R bf16 a fill.
  const unsigned fill = kWide * R * 2;
  if (tid == 0) {
    rnn::cluster::mbar_init(&mb[0]);
    rnn::cluster::mbar_init(&mb[1]);
    rnn::cluster::mbar_init_fence();
    if (Tn >= 2) rnn::cluster::mbar_expect(&mb[1], fill);  // h'(0)
    if (Tn >= 3) rnn::cluster::mbar_expect(&mb[0], fill);  // h'(1)
  }
  rnn::cluster::sync();  // every CTA running, its mbarriers set and buffer 0 written
  unsigned hs_at[kWideCluster], mb_at[kWideCluster];  // the cluster's CTAs' buffers and mbarriers
#pragma unroll
  for (int p = 0; p < kWideCluster; ++p) {
    hs_at[p] = rnn::cluster::map(hs, p);
    mb_at[p] = rnn::cluster::map(mb, p);
  }

  // xp (and keep) of step t for the lane's pairs: [gate][e].
  auto load_step = [&](int t, float (&xv)[3][2], float (&kv)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kv[e] = kReset && row_ok[e] ? keep[row_base[e] + t] : 1.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        xv[q][e] = row_ok[e] && unit_ok ? xp[(row_base[e] + t) * H3 + q * H + unit] : 0.0f;
      }
    }
  };
  float xc[3][2], keep0[2];  // keep[0] is already in h_in of step 0
  load_step(0, xc, keep0);

  // The pair of warps over K's two halves: each hands the other its partial
  // sums of the other's 8-unit half and adds the other's of its own.
  float* mine = red + (tile * 2 + half) * 6 * 32 + lane;
  const float* theirs = red + (tile * 2 + (half ^ 1)) * 6 * 32 + lane;
  const int b_off = (lane & 15) * R + half * kKS * 16 * R;  // the lane's ldmatrix row
  for (int t = 0; t < Tn; ++t) {
    if (t > 0) {  // wait for h'(t-1): fill n of buffer t & 1
      const int q = t & 1;
      const unsigned n = q ? (t - 1) >> 1 : (t >> 1) - 1;
      rnn::cluster::mbar_wait(&mb[q], n & 1);
      if (tid == 0 && t + 2 < Tn) rnn::cluster::mbar_expect(&mb[q], fill);  // h'(t+1)
    }
    float xn[3][2], kn[2] = {};  // the last step hands nothing on
    if (t + 1 < Tn) load_step(t + 1, xn, kn);

    const __nv_bfloat16* hc = hs + (t & 1) * kWide * R + b_off;
    float acc[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < kKS; ++j) {
      uint32_t b[2];
      mma::ldmatrix_x2_trans(b, hc + 16 * j * R);
#pragma unroll
      for (int q = 0; q < 3; ++q) mma::bf16_16x8x16(acc[q], wr[j][q], b[0], b[1]);
    }
    // The tile's full sums of the lane's pairs: [gate][e]. (A select, not
    // acc[q][2 half + e]: a runtime index would put acc in local memory.)
    float s[3][2];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) mine[(q * 2 + e) * 32] = half ? acc[q][e] : acc[q][2 + e];
    named_sync(1 + tile, 64);
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[q][e] = (half ? acc[q][2 + e] : acc[q][e]) + theirs[(q * 2 + e) * 32];
      }

    const unsigned nb = ((t + 1) & 1) * kWide * R * 2;  // the next buffer's byte offset
    __nv_bfloat16 hk[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float rg = rnn::fast_sigmoid(xc[0][e] + (s[0][e] + bh[0]));
      const float zg = rnn::fast_sigmoid(xc[1][e] + (s[1][e] + bh[1]));
      const float ng = rnn::fast_tanh(xc[2][e] + rg * (s[2][e] + bh[2]));
      const __nv_bfloat16 hq = __float2bfloat16((1.0f - zg) * ng + zg * hreg[e]);
      if (row_ok[e] && unit_ok) ys[(row_base[e] + t) * H + unit] = hq;
      // keep[t+1] scales the h' this step hands to the next one.
      hk[e] = kReset ? __float2bfloat16(__bfloat162float(hq) * kn[e]) : hq;
      hreg[e] = __bfloat162float(hk[e]);
    }
    if (t + 1 < Tn) {
      const __nv_bfloat162 v = __halves2bfloat162(hk[0], hk[1]);
      const float bits = __uint_as_float(*reinterpret_cast<const uint32_t*>(&v));
      const unsigned off = nb + (unit * R + 2 * tq) * 2;
#pragma unroll
      for (int p = 0; p < kWideCluster; ++p) {
        rnn::cluster::store_async(hs_at[p] + off, bits, mb_at[p] + ((t + 1) & 1) * 8);
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) xc[q][e] = xn[q][e];
  }
  rnn::cluster::sync();  // no CTA leaves while the cluster may still address it
}

template <bool kReset>
int launch_fwd_wide(cudaStream_t s, const float* xp, const void* h0, const void* w_frag,
                    const float* b_h, const float* keep, void* ys, int B, int Tn, int H) {
  const int clusters = (B + kRows - 1) / kRows;
  return rnn::launch_clusters(gru_forward_wide_kernel<kReset>, clusters, kWideCluster,
                              kWideThreads, kWideFwdSmem, s, xp,
                              static_cast<const __nv_bfloat16*>(h0),
                              static_cast<const uint4*>(w_frag), b_h, keep,
                              static_cast<__nv_bfloat16*>(ys), B, Tn, H);
}

// The wide reverse recurrence's shared memory (bytes), U = kWideUnits units
// a CTA: d_hproj^T of the CTA's own gate columns [hi, lo][3 U][8] bf16 (one
// buffer: a CTA barrier a step orders its reads and the next step's
// writes), the partial sums of dh_prev for the CTA's units from every CTA
// [2][kWideCluster][U][8] f32 (double-buffered), the ring of kStages stages
// of the CTA's units' operands (as BwdSmem's, U wide: the six gate blocks
// [6][8][U + 4] f32, h_in [8][U + 4] f32 or [8][U + 8] bf16 at byte `hin`,
// g_ys [8][U + 8] bf16 at `gy`), then two mbarriers.
struct WideBwdSmem {
  int part, sp, sg, sh, recv, ring, hin, gy, stage, mbar, total;
  __host__ __device__ explicit WideBwdSmem(int hin_bytes)
      : part(kGates * kWideUnits * kRows), sp(kWideUnits + 4), sg(kWideUnits + 8),
        sh(hin_bytes == 4 ? sp : sg), recv(2 * part * 2), ring(recv + 2 * kWide * kRows * 4),
        hin(6 * kRows * sp * 4), gy(hin + kRows * sh * hin_bytes), stage(gy + kRows * sg * 2),
        mbar(ring + kStages * stage), total(mbar + 2 * 8) {}
};

// The reverse recurrence for 128 < Hp <= 256, dh_prev^T = W_h d_hproj^T
// (units as M, 8 rows as N, K = the 3 Hp gate columns), on a cluster of
// kWideCluster CTAs, K split between them: CTA c owns units [c U, c U + U),
// U = kWideUnits, computes their gate cotangents (d_hproj of its own 3 U
// gate columns, no exchange of d_hproj), and multiplies W_h's rows of ALL
// kWide units over those columns (A fragments [kWideCluster][16 tiles]
// [12 k-steps][32] x 16 bytes, ops/cuda/gru.py wide_backward_fragments): 8
// warps, each two tiles of 16 units, all 12 k-steps in registers (96 a
// lane). Each warp stores its two tiles' partial sums (hi + lo) into the
// owner CTA of those units (two rows an 8-byte st.async), and each CTA adds
// the kWideCluster partials of its units in CTA order. d_hproj goes to the
// tensor cores as hi = bf16(d) and lo = bf16(d - hi), as in the block
// design. A step, t = T-1 .. 0: each thread's kP (unit, row) pairs (unit
// tid / (8 / kP), kP consecutive rows) take their gate cotangents from the
// gates computed a step ahead, write d_xp and dn_r, and d_hproj's terms
// into shared memory; a CTA barrier; the products; the partials to their
// owners; the next step's gates from the ring (while the exchange is in
// flight); one thread waits for the mbarrier of this step's partials, then
// a CTA barrier; each thread adds its pairs' partials: dh_prev = dh z + sum
// (times keep[t]). The ring holds only the CTA's units' operands, filled by
// cp.async two steps ahead. HT is h_in's dtype.
template <bool kReset, typename HT>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_backward_wide_kernel(const float* __restrict__ xp, const float* __restrict__ hp,
                         const HT* __restrict__ h_in, const __nv_bfloat16* __restrict__ g_ys,
                         const uint4* __restrict__ w_frag, const float* __restrict__ keep,
                         float* __restrict__ d_xp, float* __restrict__ dn_r,
                         float* __restrict__ dh0, int B, int Tn, int H) {
  constexpr int R = kRows;
  constexpr int U = kWideUnits;                // units a CTA owns: 64
  constexpr int kKS = kGates * U / 16;         // k-steps of its gate columns: 12
  constexpr int kP = U * R / kWideThreads;     // pairs a thread: 2
  constexpr int kPerUnit = R / kP;             // threads a unit: 4
  const WideBwdSmem L(sizeof(HT));
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* db = reinterpret_cast<__nv_bfloat16*>(smem);  // [hi, lo][3 U][R]
  float* recv = reinterpret_cast<float*>(smem + L.recv);       // [2][kWideCluster][U][R]
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + L.mbar);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int rank = static_cast<int>(rnn::cluster::rank());
  const int b0 = static_cast<int>(rnn::cluster::id()) * R;
  const int H3 = kGates * H;
  // The thread's pairs: local unit ul (unit rank U + ul) of rows r0 .. r0 + kP - 1.
  const int ul = tid / kPerUnit, r0 = (tid % kPerUnit) * kP, unit = rank * U + ul;
  const bool unit_ok = unit < H;
  bool row_ok[kP];
  size_t row_base[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int b = b0 + r0 + i;
    row_ok[i] = b < B;
    row_base[i] = static_cast<size_t>(b) * Tn;
  }

  // W_h's rows of the warp's tiles 2 warp, 2 warp + 1 (units 32 warp ..) over
  // this CTA's gate columns; the owner CTA of those units and their place there.
  const uint4* wf = w_frag + (static_cast<size_t>(rank) * 16 + 2 * warp) * kKS * 32 + lane;
  uint32_t wr[2][kKS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kKS; ++j) rnn::load_frag(wr[i][j], wf + (i * kKS + j) * 32);
  const int owner = 32 * warp / U, ou = 32 * warp % U;

  // The ring: step t's operands of the CTA's units into a stage, by
  // cp.async, 4 values a piece; zeros past B and H. (Nothing else needs
  // zeros: every step writes all of d_hproj^T, every fill all of recv.)
  auto stage_step = [&](int t, int slot) {
    if (t >= 0) {
      unsigned char* st = smem + L.ring + slot * L.stage;
      for (int c = tid; c < 8 * R * (U / 4); c += kWideThreads) {
        const int j = c / (R * (U / 4)), rem = c % (R * (U / 4));
        const int r = rem / (U / 4), k = 4 * (rem % (U / 4));
        const int b = b0 + r, col = rank * U + k;
        const bool in = b < B && col < H;
        const size_t bt = static_cast<size_t>(b) * Tn + t;
        if (j < 6) {
          float* dst = reinterpret_cast<float*>(st) + (j * R + r) * L.sp + k;
          mma::cp_async16_zfill(dst, in ? (j < 3 ? xp : hp) + bt * H3 + (j % 3) * H + col : xp,
                                in ? 16 : 0);
        } else if (j == 6) {
          HT* dst = reinterpret_cast<HT*>(st + L.hin) + r * L.sh + k;
          if (sizeof(HT) == 4) {
            mma::cp_async16_zfill(dst, in ? h_in + bt * H + col : h_in, in ? 16 : 0);
          } else {
            mma::cp_async8_zfill(dst, in ? h_in + bt * H + col : h_in, in ? 8 : 0);
          }
        } else {
          __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(st + L.gy) + r * L.sg + k;
          mma::cp_async8_zfill(dst, in ? g_ys + bt * H + col : g_ys, in ? 8 : 0);
        }
      }
    }
    mma::cp_async_commit();  // an empty group past t = 0 keeps the count
  };
  stage_step(Tn - 1, 0);
  stage_step(Tn - 2, 1);

  auto load_keep = [&](int t, float (&kv)[kP]) {
#pragma unroll
    for (int i = 0; i < kP; ++i) kv[i] = kReset && row_ok[i] ? keep[row_base[i] + t] : 1.0f;
  };
  float nk[kP];
  load_keep(Tn - 1, nk);

  // Iteration s's partials land in recv[s & 1]: kWide R floats a fill, from every CTA.
  const unsigned fill = kWide * R * 4;
  if (tid == 0) {
    rnn::cluster::mbar_init(&mb[0]);
    rnn::cluster::mbar_init(&mb[1]);
    rnn::cluster::mbar_init_fence();
    rnn::cluster::mbar_expect(&mb[0], fill);
    if (Tn >= 2) rnn::cluster::mbar_expect(&mb[1], fill);
  }
  rnn::cluster::sync();  // every CTA running, its buffers zero and its mbarriers set
  const unsigned recv_at = rnn::cluster::map(recv, owner) +
                           ((rank * U + ou + gr) * R + 2 * tq) * 4;  // + slot, tile, half
  const unsigned mb_at = rnn::cluster::map(mb, owner);
  mma::cp_async_wait<1>();
  __syncthreads();

  // r, z, n, hn of the thread's pairs from a stage (rnn.cuh's fast gate
  // functions, as the block design's).
  auto gates = [&](int slot, float (&g)[kP][4]) {
    const float* ps = reinterpret_cast<const float*>(smem + L.ring + slot * L.stage);
    const int blk = R * L.sp;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const float* x = ps + (r0 + i) * L.sp + ul;
      const float r = rnn::fast_sigmoid(x[0] + x[3 * blk]);
      const float hn = x[5 * blk];
      g[i][0] = r;
      g[i][1] = rnn::fast_sigmoid(x[blk] + x[4 * blk]);
      g[i][2] = rnn::fast_tanh(x[2 * blk] + r * hn);
      g[i][3] = hn;
    }
  };
  float gt[kP][4];
  gates(0, gt);

  float carry[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) carry[i] = 0.0f;
  // lanes 0-15 address hi's k rows 0-15 of a k-step, lanes 16-31 lo's.
  const __nv_bfloat16* dk = db + (lane & 15) * R + (lane >> 4) * L.part;
  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    stage_step(t - 2, (s + 2) % kStages);
    float ck[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) ck[i] = nk[i];
    if (t > 0) load_keep(t - 1, nk);
    const unsigned char* st = smem + L.ring + (s % kStages) * L.stage;
    const HT* hs = reinterpret_cast<const HT*>(st + L.hin);
    const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(st + L.gy);

    float dhz[kP], dq[kGates][kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int row = r0 + i;
      const float rv = gt[i][0], zv = gt[i][1], nv = gt[i][2], hnv = gt[i][3];
      const float hin = to_f(hs[row * L.sh + ul]);
      const float dh = carry[i] + __bfloat162float(gs[row * L.sg + ul]);
      const float dpre_n = dh * (1.0f - zv) * (1.0f - nv * nv);
      const float dpre_z = dh * (hin - nv) * zv * (1.0f - zv);
      const float dpre_r = dpre_n * hnv * rv * (1.0f - rv);
      dq[0][i] = dpre_r;
      dq[1][i] = dpre_z;
      dq[2][i] = dpre_n * rv;
      if (unit_ok && row_ok[i]) {
        float* out = d_xp + (row_base[i] + t) * H3 + unit;
        out[0] = dpre_r;
        out[H] = dpre_z;
        out[2 * H] = dpre_n;
        dn_r[(row_base[i] + t) * H + unit] = dq[2][i];
      }
      dhz[i] = dh * zv;
    }
    // d_hproj split for the product: hi = bf16(d), lo = bf16(d - hi), two rows a word.
#pragma unroll
    for (int q = 0; q < kGates; ++q)
#pragma unroll
      for (int i = 0; i < kP; i += 2) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(dq[q][i], dq[q][i + 1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(dq[q][i] - __low2float(hi),
                                                       dq[q][i + 1] - __high2float(hi));
        __nv_bfloat16* row = db + (q * U + ul) * R + r0 + i;
        *reinterpret_cast<__nv_bfloat162*>(row) = hi;
        *reinterpret_cast<__nv_bfloat162*>(row + L.part) = lo;
      }
    mma::cp_async_wait<1>();  // step t-1's operands have landed (this thread's)
    __syncthreads();          // ... everyone's, and d_hproj^T is whole

    // Four independent chains (two tiles, hi and lo); B fragments a k-step ahead.
    float acc[2][2][4] = {};
    uint32_t bq[2][4];
    mma::ldmatrix_x4_trans(bq[0], dk);
#pragma unroll
    for (int j = 0; j < kKS; ++j) {
      if (j + 1 < kKS) mma::ldmatrix_x4_trans(bq[(j + 1) & 1], dk + 16 * (j + 1) * R);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma::bf16_16x8x16(acc[i][0], wr[i][j], bq[j & 1][0], bq[j & 1][1]);
        mma::bf16_16x8x16(acc[i][1], wr[i][j], bq[j & 1][2], bq[j & 1][3]);
      }
    }
    // This CTA's partial sums of the warp's 32 units into their owner.
    const unsigned slot = (s & 1) * kWideCluster * U * R * 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        store_async2(recv_at + slot + (16 * i + 8 * m) * R * 4,
                     acc[i][0][2 * m] + acc[i][1][2 * m],
                     acc[i][0][2 * m + 1] + acc[i][1][2 * m + 1], mb_at + (s & 1) * 8);
      }
    // Step t-1's gates (its stage landed before this step's barrier), while
    // the partials are in flight.
    if (t > 0) gates((s + 1) % kStages, gt);
    if (tid == 0) {  // every CTA's partials of this step: fill s >> 1 of buffer s & 1
      rnn::cluster::mbar_wait(&mb[s & 1], (s >> 1) & 1);
      if (s + 2 < Tn) rnn::cluster::mbar_expect(&mb[s & 1], fill);
    }
    __syncthreads();
    const float* got = recv + (s & 1) * kWideCluster * U * R + ul * R + r0;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      float sum = got[i];
#pragma unroll
      for (int c = 1; c < kWideCluster; ++c) sum += got[c * U * R + i];
      carry[i] = dhz[i] + sum;
      if (kReset) carry[i] *= ck[i];  // dh_prev *= keep[t]
    }
  }
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    if (unit_ok && row_ok[i]) dh0[static_cast<size_t>(b0 + r0 + i) * H + unit] = carry[i];
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  rnn::cluster::sync();
}

template <bool kReset, typename HT>
int launch_bwd_wide(size_t smem, cudaStream_t s, const float* xp, const float* hp,
                    const void* h_in, const void* g_ys, const void* w_frag, const float* keep,
                    float* d_xp, float* dn_r, float* dh0, int B, int Tn, int H) {
  const int clusters = (B + kRows - 1) / kRows;
  return rnn::launch_clusters(gru_backward_wide_kernel<kReset, HT>, clusters, kWideCluster,
                              kWideThreads, smem, s, xp, hp, static_cast<const HT*>(h_in),
                              static_cast<const __nv_bfloat16*>(g_ys),
                              static_cast<const uint4*>(w_frag), keep, d_xp, dn_r, dh0, B, Tn,
                              H);
}


// ---------------------------------------------------------------------------
// Above H = 256: both recurrences on a grid-persistent layout, both dtypes
// ---------------------------------------------------------------------------
//
// At H = 512 W_h is 1.5 MB of bf16 and at H = 1,000 6 MB (12 MB in f32): no
// cluster of CTAs holds it in registers or shared memory. rnn.cuh's grid
// layout (one cooperative launch, a CTA a slice of the units with W_h's
// values of those units, all three gates, resident in its shared memory: 96
// Kp bytes, 96 KB at Kp = 1,024; the step's vector through L2 under one grid
// barrier a step, in a workspace the wrapper zeroes) runs both directions.
//
// Forward, h' = GRU(xp[t], h_in): every CTA reads its rows of the whole
// h_in(t) from buffer t & 1, computes its units' r, z and n sums, then h',
// writes ys and keep[t+1] h' (rounded to the working dtype) into buffer
// (t+1) & 1, then the barrier. bf16: hp^T = W_h^T h_in^T on mma.sync (units
// as M, 8 rows as N), a warp 16 rows (two n8 tiles) at a time over all of
// K, W_h^T's A fragments from shared memory (packed by the wrapper,
// ops/cuda/gru.py grid_pack), h_in's B fragments straight from L2, one
// 16-byte read a lane for two k16 steps: K is permuted so that lane (g, q)
// reads k = 32 c + 8 q .. + 7 of its row g, and the wrapper packs W_h^T in
// the same order (a sum over k in any order is the same sum; mma's own order
// is fixed, so the bits repeat). The r, z and n sums of a (unit, row) land
// in one lane: the gate math needs no exchange. f32: a step's product is a
// CTA GEMM on the CUDA cores, [the CTA's rows x Kp] . [Kp x 8 units x 3
// gates] (rnn.cuh grid_f32_product): h's rows come from L2 once a CTA a
// step, in K chunks through a ring in shared memory (cp.async.cg), a
// thread sums 2 to 8 rows (the block's / 16) x 2 units x 3 gates over its
// warp's slice of each chunk, and the slices' partial sums go through shared memory to the
// gate math, which adds them in slice order; a thread owns its (row, unit)
// pairs in every step, so it reads their xp, h_in and keep[t+1] before the
// barrier. Accurate sigmoid and tanh, as the f32 cluster design.
//
// Reverse (the K split of the lead): a step is two phases with the barrier
// between. Phase A: each CTA computes the gate cotangents of its own (unit,
// row) pairs from the two f32 projections (the gates recomputed there), its
// dh carry (a per-pair f32 plane in the workspace, written only by the lane
// that owns the pair) and g_y, writes d_xp and dn_r, and publishes its
// units' d_hproj columns to global memory (bf16: two bf16 terms, hi =
// bf16(d) and lo = bf16(d - hi), the cotangent's contract; f32: as it is).
// Phase B: each CTA reads its rows of the whole d_hproj and forms
// dh_prev = dh z + d_hproj W_h^T for its units in a fixed order (bf16:
// units as M, K = the 3 Kp gate columns, hi and lo products sharing the A
// fragments; f32: a warp's lanes each over a slice of K, then rnn.cuh's
// reduce-scatter, one unit a lane), times keep[t]. The lane that owns a pair in phase B owns it in
// phase A, so the carry needs no exchange.
//
// What bounds them: as the other layouts, the serial chain, now one grid
// barrier (~1-3 us) and one CTA's share of the step's products a step. bf16
// at the wide demo (B = 256, H = 512): 128 CTAs, 64 rows each, 768 mma.sync
// a CTA a step. f32 at the wide demo: 128 CTAs of 128 rows, 1.57 M FMAs a
// CTA a step (6.2 us at 128 FMAs a clock and 1.98 GHz) and 256 KB of h from
// L2 a CTA (32 MB for the grid) a step. So h leaves L2 once a CTA a step,
// with `stages` - 1 chunks in flight while one is multiplied (a read a
// task would bring each row four times, on a chain of dependent L2 round
// trips), and a thread's 8 rows x 6 sums use each h float4 6 times and
// each W_h float4 8 times. What binds now (kernel_probes.py grid_f32): the products, at
// about 60% of the FFMA issue rate (this card's SIMT loops), then the first
// chunk's wait after the barrier (every CTA of the grid asks L2 for its h
// at once), the barrier and the gate math. Each row group waits on its own
// counter (a CTA reads only its group's rows), and a thread's next
// operands are read between the barrier's arrive and its wait.

using rnn::grid_kpad;
using rnn::grid_load_weights;
using rnn::grid_rows;
using rnn::grid_sync;
using rnn::GridPlace;
using rnn::kGridCounter;
using rnn::kGridThreads;
using rnn::ldcg_bf16;
constexpr int kGridGates = 3;  // r, z, n
// Workspace bytes a (row, k) of the [rows][Kp] plane: the forward's h buffers
// [2][rows][Kp]; the reverse's d_hproj buffers ([2][hi, lo][rows][3 Kp] bf16
// or [2][rows][3 Kp] f32: 24 bytes either way) and the carry [rows][Kp] f32.
__host__ inline size_t grid_workspace(int B, int H, bool bf16, bool reverse) {
  return rnn::grid_workspace(B, H, bf16, reverse ? 28 : 2 * (bf16 ? 2 : 4));
}

// bf16 forward. w_frag: W_h^T's A fragments [tiles][Kp/16 k-steps][3 gates]
// [32 lanes] x 16 bytes in the permuted K order (ops/cuda/gru.py grid_pack);
// ws: the counter, then h_in's buffers [2][rows][Kp] bf16.
template <bool kReset>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_forward_grid_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ h0,
                        const uint4* __restrict__ w_frag, const float* __restrict__ b_h,
                        const float* __restrict__ keep, __nv_bfloat16* __restrict__ ys,
                        unsigned char* __restrict__ ws, int B, int Tn, int H, int groups) {
  extern __shared__ __align__(16) uint4 wsm[];
  const int Kp = grid_kpad(H, true), KS = Kp / 16, H3 = 3 * H;
  const int tiles = (H + 15) / 16, pairs = grid_rows(B, true) / 16;
  const GridPlace at(tiles, pairs, groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(ws + kGridCounter);
  const size_t plane = static_cast<size_t>(pairs) * 16 * Kp;
  const unsigned G = gridDim.x;

  // h_in(0) of the CTA's units and rows (keep[0] h0, rounded to bf16) into buffer 0.
  for (int c = threadIdx.x; c < (at.r1 - at.r0) * 256; c += kGridThreads) {
    const int row = 16 * at.r0 + c / 16, unit = 16 * at.tile + c % 16;
    if (row < B && unit < H) {
      float h = __bfloat162float(h0[static_cast<size_t>(row) * H + unit]);
      if (kReset) h *= keep[static_cast<size_t>(row) * Tn];
      hbuf[static_cast<size_t>(row) * Kp + unit] = __float2bfloat16(h);
    }
  }
  grid_load_weights(wsm, w_frag + static_cast<size_t>(at.tile) * KS * 3 * 32, KS * 3 * 32);
  float bh[3][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      const int unit = 16 * at.tile + gr + 8 * mh;
      bh[q][mh] = unit < H ? b_h[q * H + unit] : 0.0f;
    }
  grid_sync(bar, G);

  for (int t = 0; t < Tn; ++t) {
    const __nv_bfloat16* hc = hbuf + (t & 1) * plane;
    __nv_bfloat16* hn = hbuf + ((t + 1) & 1) * plane;
    for (int p = at.r0 + warp; p < at.r1; p += kGridThreads / 32) {
      // The lane's C positions: unit 16 tile + gr + 8 (i >> 1), row
      // 16 p + 8 nt + 2 tq + (i & 1); their xp before the products.
      float xv[2][4][3];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), unit = 16 * at.tile + gr + 8 * (i >> 1);
          const bool ok = row < B && unit < H;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            xv[nt][i][q] = ok ? xp[(static_cast<size_t>(row) * Tn + t) * H3 + q * H + unit] : 0.0f;
          }
        }
      float acc[2][3][4] = {};
      const uint4* h4[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        h4[nt] = reinterpret_cast<const uint4*>(hc + static_cast<size_t>(16 * p + 8 * nt + gr) * Kp + 8 * tq);
      }
      for (int c = 0; c < Kp / 32; ++c) {
        uint4 hv[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) hv[nt] = __ldcg(h4[nt] + 4 * c);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t a[4];
            load_frag(a, wsm + ((2 * c + kk) * 3 + q) * 32 + lane);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma::bf16_16x8x16(acc[nt][q], a, kk ? hv[nt].z : hv[nt].x, kk ? hv[nt].w : hv[nt].y);
            }
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), mh = i >> 1;
          const int unit = 16 * at.tile + gr + 8 * mh;
          if (row >= B || unit >= H) continue;
          const size_t bt = static_cast<size_t>(row) * Tn + t;
          const float hin = ldcg_bf16(hc + static_cast<size_t>(row) * Kp + unit);
          const float rg = rnn::fast_sigmoid(xv[nt][i][0] + (acc[nt][0][i] + bh[0][mh]));
          const float zg = rnn::fast_sigmoid(xv[nt][i][1] + (acc[nt][1][i] + bh[1][mh]));
          const float ng = rnn::fast_tanh(xv[nt][i][2] + rg * (acc[nt][2][i] + bh[2][mh]));
          const __nv_bfloat16 hq = __float2bfloat16((1.0f - zg) * ng + zg * hin);
          ys[bt * H + unit] = hq;
          if (t + 1 < Tn) {  // keep[t+1] scales the h' this step hands to the next one
            hn[static_cast<size_t>(row) * Kp + unit] =
                kReset ? __float2bfloat16(__bfloat162float(hq) * keep[bt + 1]) : hq;
          }
        }
    }
    if (t + 1 < Tn) grid_sync(bar, G * (t + 2));
  }
}

// f32 forward. w4: W_h's values of each slice's 8 units, [tiles][Kp/4][3
// gates][8 units] float4 of k = 4 kk .. + 3 (ops/cuda/gru.py grid_pack); ws:
// the counters (a row group's at kGfCounterStride group), then h_in's
// buffers [2][rows][Kp] f32. Shared memory: W_h's
// values, then rnn::grid_f32_product's ring (GridF32Plan). The gate math: a
// thread owns unit threadIdx.x % 8 of block rows threadIdx.x / 8 + 32 i,
// in every step (and writes h_in(0) of them), so its own h_in entries, xp
// and keep[t+1] are read before the barrier that precedes the step.
template <bool kReset, int kBlock>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_forward_grid_f32_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                            const float4* __restrict__ w4, const float* __restrict__ b_h,
                            const float* __restrict__ keep, float* __restrict__ ys,
                            unsigned char* __restrict__ ws, int B, int Tn, int H, int groups) {
  extern __shared__ __align__(16) float4 wsm4[];
  constexpr int G = kGridGates, kSlots = rnn::GfShape<kBlock>::slots;
  const int Kp = grid_kpad(H, false), H3 = G * H;
  const int tiles = (H + 7) / 8, quads = grid_rows(B, false) / 4;
  const GridPlace at(tiles, quads, groups);
  const rnn::GridF32Plan plan(4 * ((quads + groups - 1) / groups), Kp, G);
  float* ring = reinterpret_cast<float*>(wsm4 + 2 * G * Kp);
  unsigned* bar = reinterpret_cast<unsigned*>(ws + rnn::kGfCounterStride * at.group);
  float* hbuf = reinterpret_cast<float*>(ws + kGridCounter);
  const size_t plane = static_cast<size_t>(quads) * 4 * Kp;
  const unsigned NG = tiles;  // the row group's CTAs
  const int row_lo = 4 * at.r0, row_hi = 4 * at.r1;
  const int u = threadIdx.x & 7, unit = 8 * at.tile + u, rt = threadIdx.x >> 3;

  for (int row = row_lo + rt; row < row_hi; row += kGridThreads / 8) {
    if (row < B && unit < H) {
      const float h = h0[static_cast<size_t>(row) * H + unit];
      hbuf[static_cast<size_t>(row) * Kp + unit] =
          kReset ? __fmul_rn(h, keep[static_cast<size_t>(row) * Tn]) : h;
    }
  }
  grid_load_weights(reinterpret_cast<uint4*>(wsm4),
                    reinterpret_cast<const uint4*>(w4) + static_cast<size_t>(at.tile) * 2 * G * Kp,
                    2 * G * Kp);
  float bh[G];
#pragma unroll
  for (int q = 0; q < G; ++q) bh[q] = unit < H ? b_h[q * H + unit] : 0.0f;

  // The pairs' operands of block b at step t: xp, h_in and keep[t+1].
  float xv[kSlots][G], hin[kSlots], kn[kSlots];
  auto operands = [&](int t, int b) {
    const float* hc = hbuf + (t & 1) * plane;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int row = row_lo + b * kBlock + rt + 32 * i;
      const bool ok = row < row_hi && row < B && unit < H;
      const size_t bt = static_cast<size_t>(row) * Tn + t;
#pragma unroll
      for (int q = 0; q < G; ++q) xv[i][q] = ok ? xp[bt * H3 + q * H + unit] : 0.0f;
      hin[i] = ok ? __ldcg(hc + static_cast<size_t>(row) * Kp + unit) : 0.0f;
      kn[i] = kReset && ok && t + 1 < Tn ? keep[bt + 1] : 1.0f;
    }
  };
  operands(0, 0);
  grid_sync(bar, NG);

  const int blocks = (row_hi - row_lo + kBlock - 1) / kBlock;
  unsigned long long phase_t = 0;  // the clock probes' (GRID_PHASE)
  GRID_PHASE(phase_t, 15);
  for (int t = 0; t < Tn; ++t) {
    const float* hc = hbuf + (t & 1) * plane;
    float* hn = hbuf + ((t + 1) & 1) * plane;
    for (int b = 0; b < blocks; ++b) {
      if (b > 0) operands(t, b);
      const int r0 = row_lo + b * kBlock;
      rnn::grid_f32_product<G, kBlock>(wsm4, ring, hc, Kp, r0, min(kBlock, row_hi - r0),
                                        plan.stages, phase_t);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int r = rt + 32 * i, row = r0 + r;
        if (row >= row_hi || row >= B || unit >= H) continue;
        const size_t bt = static_cast<size_t>(row) * Tn + t;
        // Every rounding spelled out: the three instantiations (blocks of 32,
        // 64, 128 rows) must give a row the same bits, and nvcc may contract
        // a product and a sum into an FMA either way in each.
        const float rg = sigmoidf(xv[i][0] + (rnn::grid_f32_sum<G, kBlock>(ring, r, 0, u) + bh[0]));
        const float zg = sigmoidf(xv[i][1] + (rnn::grid_f32_sum<G, kBlock>(ring, r, 1, u) + bh[1]));
        const float ng = tanhf(__fadd_rn(
            xv[i][2], __fmul_rn(rg, rnn::grid_f32_sum<G, kBlock>(ring, r, 2, u) + bh[2])));
        const float hq = __fadd_rn(__fmul_rn(1.0f - zg, ng), __fmul_rn(zg, hin[i]));
        ys[bt * H + unit] = hq;
        if (t + 1 < Tn) hn[static_cast<size_t>(row) * Kp + unit] = kReset ? __fmul_rn(hq, kn[i]) : hq;
      }
    }
    GRID_PHASE(phase_t, 4);
    if (t + 1 < Tn) {
      rnn::grid_arrive(bar);
      GRID_PHASE(phase_t, 5);
      operands(t + 1, 0);  // off the chain, and out of the arrive's fence
      GRID_PHASE(phase_t, 6);
      rnn::grid_wait(bar, NG * (t + 2));
      GRID_PHASE(phase_t, 7);
    }
  }
}

// bf16-weight reverse. w_frag: W_h's A fragments [tiles][3 Kp/16 k-steps]
// [32 lanes] x 16 bytes, A[unit][q Kp + j] = W_h[unit][q H + j] (zero past
// H) in the permuted K order; ws: the counter, d_hproj's buffers
// [2][hi, lo][rows][3 Kp] bf16, then the carry [rows][Kp] f32. HT: h_in's dtype.
template <bool kReset, typename HT>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_backward_grid_kernel(const float* __restrict__ xp, const float* __restrict__ hp,
                         const HT* __restrict__ h_in, const __nv_bfloat16* __restrict__ g_ys,
                         const uint4* __restrict__ w_frag, const float* __restrict__ keep,
                         float* __restrict__ d_xp, float* __restrict__ dn_r,
                         float* __restrict__ dh0, unsigned char* __restrict__ ws, int B, int Tn,
                         int H, int groups) {
  extern __shared__ __align__(16) uint4 wsm[];
  const int Kp = grid_kpad(H, true), Kc = 3 * Kp, H3 = 3 * H;
  const int tiles = (H + 15) / 16, rows = grid_rows(B, true), pairs = rows / 16;
  const GridPlace at(tiles, pairs, groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  const size_t term = static_cast<size_t>(rows) * Kc;
  __nv_bfloat16* dbuf = reinterpret_cast<__nv_bfloat16*>(ws + kGridCounter);
  float* carry = reinterpret_cast<float*>(dbuf + 4 * term);
  const unsigned G = gridDim.x;
  grid_load_weights(wsm, w_frag + static_cast<size_t>(at.tile) * (Kc / 16) * 32, (Kc / 16) * 32);

  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    __nv_bfloat16* db = dbuf + (s & 1) * 2 * term;
    // Phase A: the lane's pairs (phase B's C positions).
    for (int p = at.r0 + warp; p < at.r1; p += kGridThreads / 32) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), unit = 16 * at.tile + gr + 8 * (i >> 1);
          if (row >= B || unit >= H) continue;
          const size_t bt = static_cast<size_t>(row) * Tn + t;
          const float* x = xp + bt * H3 + unit;
          const float* hq = hp + bt * H3 + unit;
          const float rv = rnn::fast_sigmoid(x[0] + hq[0]);
          const float zv = rnn::fast_sigmoid(x[H] + hq[H]);
          const float hnv = hq[2 * H];
          const float nv = rnn::fast_tanh(x[2 * H] + rv * hnv);
          const float hin = to_f(h_in[bt * H + unit]);
          float* cr = carry + static_cast<size_t>(row) * Kp + unit;
          const float dh = *cr + __bfloat162float(g_ys[bt * H + unit]);
          const float dpre_n = dh * (1.0f - zv) * (1.0f - nv * nv);
          const float dpre_z = dh * (hin - nv) * zv * (1.0f - zv);
          const float dpre_r = dpre_n * hnv * rv * (1.0f - rv);
          float* out = d_xp + bt * H3 + unit;
          out[0] = dpre_r;
          out[H] = dpre_z;
          out[2 * H] = dpre_n;
          const float d[3] = {dpre_r, dpre_z, dpre_n * rv};
          dn_r[bt * H + unit] = d[2];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const __nv_bfloat16 hi = __float2bfloat16(d[q]);
            const size_t at_q = static_cast<size_t>(row) * Kc + q * Kp + unit;
            db[at_q] = hi;
            db[term + at_q] = __float2bfloat16(d[q] - __bfloat162float(hi));
          }
          *cr = dh * zv;
        }
    }
    grid_sync(bar, G * (s + 1));
    // Phase B: dh_prev^T = W_h d_hproj^T for the CTA's units.
    for (int p = at.r0 + warp; p < at.r1; p += kGridThreads / 32) {
      float acc[2][2][4] = {};  // [n8 tile][hi, lo]
      const uint4* d4[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        d4[nt] = reinterpret_cast<const uint4*>(db + static_cast<size_t>(16 * p + 8 * nt + gr) * Kc + 8 * tq);
      }
      for (int c = 0; c < Kc / 32; ++c) {
        uint4 v[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          v[nt][0] = __ldcg(d4[nt] + 4 * c);
          v[nt][1] = __ldcg(d4[nt] + term / 8 + 4 * c);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4];
          load_frag(a, wsm + (2 * c + kk) * 32 + lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              mma::bf16_16x8x16(acc[nt][e], a, kk ? v[nt][e].z : v[nt][e].x,
                                kk ? v[nt][e].w : v[nt][e].y);
            }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), unit = 16 * at.tile + gr + 8 * (i >> 1);
          if (row >= B || unit >= H) continue;
          float* cr = carry + static_cast<size_t>(row) * Kp + unit;
          float c = *cr + (acc[nt][0][i] + acc[nt][1][i]);
          if (kReset) c *= keep[static_cast<size_t>(row) * Tn + t];  // dh_prev *= keep[t]
          *cr = c;
          if (t == 0) dh0[static_cast<size_t>(row) * H + unit] = c;
        }
    }
  }
}

// f32 reverse. w4: W_h's rows of each slice's 8 units over the 3 Kp gate
// columns (column q Kp + j is W_h's q H + j, zero past H), [tiles][3 Kp/128]
// [8 units][32 lanes] float4; ws: the counter, d_hproj's buffers
// [2][rows][3 Kp] f32, then the carry [rows][Kp] f32.
template <bool kReset>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_backward_grid_f32_kernel(const float* __restrict__ xp, const float* __restrict__ hp,
                             const float* __restrict__ h_in, const float* __restrict__ g_ys,
                             const float4* __restrict__ w4, const float* __restrict__ keep,
                             float* __restrict__ d_xp, float* __restrict__ dn_r,
                             float* __restrict__ dh0, unsigned char* __restrict__ ws, int B,
                             int Tn, int H, int groups) {
  extern __shared__ __align__(16) float4 wsm4[];
  const int Kp = grid_kpad(H, false), Kc = 3 * Kp, J = Kc / 128, H3 = 3 * H;
  const int tiles = (H + 7) / 8, rows = grid_rows(B, false), quads = rows / 4;
  const GridPlace at(tiles, quads, groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  const size_t plane = static_cast<size_t>(rows) * Kc;
  float* dbuf = reinterpret_cast<float*>(ws + kGridCounter);
  float* carry = dbuf + 2 * plane;
  const unsigned G = gridDim.x;
  grid_load_weights(reinterpret_cast<uint4*>(wsm4),
                    reinterpret_cast<const uint4*>(w4) + static_cast<size_t>(at.tile) * J * 8 * 32,
                    J * 8 * 32);
  // A task: a quad of rows x the slice's 8 units; after the reduce-scatter
  // lane owns row lane >> 3 of unit lane & 7, in both phases.
  using Own = rnn::Owner<4, 8, 32>;
  const Own own(lane);
  const int unit = 8 * at.tile + own.ut0;

  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    float* db = dbuf + (s & 1) * plane;
    for (int rq = at.r0 + warp; rq < at.r1; rq += kGridThreads / 32) {
      const int row = 4 * rq + own.row0;
      if (row >= B || unit >= H) continue;
      const size_t bt = static_cast<size_t>(row) * Tn + t;
      const float* x = xp + bt * H3 + unit;
      const float* hq = hp + bt * H3 + unit;
      const float r = sigmoidf(x[0] + hq[0]);
      const float z = sigmoidf(x[H] + hq[H]);
      const float hn = hq[2 * H];
      const float n = tanhf(x[2 * H] + r * hn);
      float* cr = carry + static_cast<size_t>(row) * Kp + unit;
      const float dh = *cr + g_ys[bt * H + unit];
      const float dpre_n = dh * (1.0f - z) * (1.0f - n * n);
      const float dpre_z = dh * (h_in[bt * H + unit] - n) * (z * (1.0f - z));
      const float dpre_r = dpre_n * hn * (r * (1.0f - r));
      float* out = d_xp + bt * H3 + unit;
      out[0] = dpre_r;
      out[H] = dpre_z;
      out[2 * H] = dpre_n;
      const float dn = dpre_n * r;
      dn_r[bt * H + unit] = dn;
      float* dr = db + static_cast<size_t>(row) * Kc + unit;
      dr[0] = dpre_r;
      dr[Kp] = dpre_z;
      dr[2 * Kp] = dn;
      *cr = __fmul_rn(dh, z);
    }
    grid_sync(bar, G * (s + 1));
    for (int rq = at.r0 + warp; rq < at.r1; rq += kGridThreads / 32) {
      float acc[4][8][1] = {};
      const float4* d4 = reinterpret_cast<const float4*>(db + static_cast<size_t>(4 * rq) * Kc) + lane;
      const float4* wt = wsm4 + lane;
      for (int j = 0; j < J; ++j) {
        float4 dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = __ldcg(d4 + r * (Kc / 4) + 32 * j);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 w = wt[(j * 8 + u) * 32];
#pragma unroll
          for (int r = 0; r < 4; ++r) dot4(acc[r][u][0], dv[r], w);
        }
      }
      rnn::reduce_scatter<4, 8, 16, 4, 8, 1>(acc, lane);
      const int row = 4 * rq + own.row0;
      if (row >= B || unit >= H) continue;
      float* cr = carry + static_cast<size_t>(row) * Kp + unit;
      const float dn = __fadd_rn(*cr, acc[0][0][0]);
      const float c = kReset ? __fmul_rn(dn, keep[static_cast<size_t>(row) * Tn + t]) : dn;
      *cr = c;
      if (t == 0) dh0[static_cast<size_t>(row) * H + unit] = c;
    }
  }
}

// ---------------------------------------------------------------------------
// Past grid_max_hidden, both dtypes: the stepped layout (rnn.cuh)
// ---------------------------------------------------------------------------

// Forward step t of the GRU: the gates of (row, unit) from xp[:, t] and the
// step's hp = h_in @ W_h + b_h (the GEMM just before: its `splits` partial
// planes [splits][B][3H] summed in split order, then b_h added), h' rounded to T into
// ys[:, t], and into hbuf the next step's h_in: keep[t+1] * h' (rounded to
// T) in the reset variant, h' itself without. hbuf holds this step's h_in
// (h0, times keep[0] in the reset variant, before step 0): each thread reads
// its own element before it writes it.
template <typename T, bool kReset>
__global__ void __launch_bounds__(rnn::kStepThreads)
gru_step_kernel(const float* __restrict__ xp, const float* __restrict__ hp, int splits,
                const float* __restrict__ b_h, T* __restrict__ hbuf,
                const float* __restrict__ keep, T* __restrict__ ys, int B, int Tn, int H, int t) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * H) return;
  const int row = static_cast<int>(i / H), unit = static_cast<int>(i % H);
  const size_t bt = static_cast<size_t>(row) * Tn + t;
  const float* x = xp + bt * 3 * H + unit;
  const size_t plane = static_cast<size_t>(B) * 3 * H, o = static_cast<size_t>(row) * 3 * H + unit;
  float hq[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) hq[g] = rnn::step_product(hp, splits, plane, o + g * H) + b_h[g * H + unit];
  const float r = rnn::step_sigmoid<T>(x[0] + hq[0]);
  const float z = rnn::step_sigmoid<T>(x[H] + hq[1]);
  const float n = rnn::step_tanh<T>(x[2 * H] + r * hq[2]);
  const float h_in = rnn::step_load(hbuf[i]);
  const T h = rnn::step_round<T>((1.0f - z) * n + z * h_in);
  ys[bt * H + unit] = h;
  if (kReset && t + 1 < Tn) {
    hbuf[i] = rnn::step_round<T>(rnn::step_load(h) * keep[static_cast<size_t>(row) * Tn + t + 1]);
  } else {
    hbuf[i] = h;
  }
}

// Reverse step t of the GRU (t = T-1 .. 0), as reference.gru_bwd_scan: the
// carry dh_next = (z_buf + p) * keep[t+1] from step t+1 (z_buf: its dh z,
// p: its d_hproj @ W_h^T, the GEMM just before, its `splits` partial planes
// [splits][B][H] summed in split order; 0 at t = T-1), then the
// gates recomputed from the two f32 projections, d_xp[:, t] and dn_r[:, t],
// the GEMM's A (this step's d_hproj, bf16 as hi and lo terms with W's
// dtype bf16) and z_buf = dh z. At t = -1 only dh0 = the carry into step 0.
template <typename W, typename HIn, bool kKeep>
__global__ void __launch_bounds__(rnn::kStepThreads)
gru_step_backward_kernel(const float* __restrict__ xp, const float* __restrict__ hp,
                         const HIn* __restrict__ h_in, const W* __restrict__ g_ys,
                         const float* __restrict__ keep, const float* __restrict__ p, int splits,
                         float* __restrict__ z_buf, W* __restrict__ a, float* __restrict__ d_xp,
                         float* __restrict__ dn_r, float* __restrict__ dh0, int B, int Tn, int H,
                         int t) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * H) return;
  const int row = static_cast<int>(i / H), unit = static_cast<int>(i % H);
  float dh_next = 0.0f;
  if (t < Tn - 1) {
    dh_next = z_buf[i] + rnn::step_product(p, splits, static_cast<size_t>(B) * H, i);
    if (kKeep) dh_next *= keep[static_cast<size_t>(row) * Tn + t + 1];
  }
  if (t < 0) {
    dh0[i] = dh_next;
    return;
  }
  const size_t bt = static_cast<size_t>(row) * Tn + t;
  const float* x = xp + bt * 3 * H + unit;
  const float* hq = hp + bt * 3 * H + unit;
  const float r = sigmoidf(x[0] + hq[0]);
  const float z = sigmoidf(x[H] + hq[H]);
  const float hn = hq[2 * H];
  const float n = tanhf(x[2 * H] + r * hn);
  const float dh = dh_next + rnn::step_load(g_ys[bt * H + unit]);
  const float dpre_n = dh * (1.0f - z) * (1.0f - n * n);
  const float dpre_z = dh * (rnn::step_load(h_in[bt * H + unit]) - n) * (z * (1.0f - z));
  const float dpre_r = dpre_n * hn * (r * (1.0f - r));
  float* out = d_xp + bt * 3 * H + unit;
  out[0] = dpre_r;
  out[H] = dpre_z;
  out[2 * H] = dpre_n;
  const float dn = dpre_n * r;
  dn_r[bt * H + unit] = dn;
  rnn::step_store_d(a, row, 3 * H, unit, dpre_r);
  rnn::step_store_d(a, row, 3 * H, H + unit, dpre_z);
  rnn::step_store_d(a, row, 3 * H, 2 * H + unit, dn);
  z_buf[i] = dh * z;
}

// The forward scan: T x (the step's GEMM, then its gates).
template <typename T, bool kReset>
int stepped_forward(const float* xp, T* hbuf, const T* w_h, const float* b_h, const float* keep,
                    T* ys, float* hp, const rnn::StepPlan& plan, int B, int Tn, int H,
                    cudaStream_t s) {
  rnn::StepMaps maps;
  const int mrc = rnn::step_maps(plan, hbuf, w_h, B, H, 3 * H, 1, &maps);
  if (mrc != 0) return mrc;
  for (int t = 0; t < Tn; ++t) {
    int rc = rnn::step_gemm(plan, maps, hbuf, w_h, hp, B, H, 3 * H, 1, s);
    if (rc == 0) rc = rnn::launch_step(gru_step_kernel<T, kReset>, B, H, s, xp, hp,
                                       plan.splits(), b_h, hbuf, keep, ys, B, Tn, H, t);
    if (rc != 0) return rc;
  }
  return 0;
}

// The reverse recurrence: T x (the step's gates, then its GEMM), then dh0.
// w: bf16 W_h [H, 3H] as stored (the GEMM's [N][K]), f32 W_h^T [3H, H].
template <typename W, typename HIn, bool kKeep>
int stepped_backward(const float* xp, const float* hp, const HIn* h_in, const W* g_ys,
                     const W* w, const float* keep, float* d_xp, float* dn_r, float* dh0, W* a,
                     float* p, float* z_buf, const rnn::StepPlan& plan, int B, int Tn, int H,
                     cudaStream_t s) {
  constexpr int kTerms = sizeof(W) == 2 ? 2 : 1;
  auto gates = gru_step_backward_kernel<W, HIn, kKeep>;
  rnn::StepMaps maps;
  const int mrc = rnn::step_maps(plan, a, w, B, 3 * H, H, kTerms, &maps);
  if (mrc != 0) return mrc;
  for (int t = Tn - 1; t >= -1; --t) {
    int rc = rnn::launch_step(gates, B, H, s, xp, hp, h_in, g_ys, keep, p, plan.splits(), z_buf,
                              a, d_xp, dn_r, dh0, B, Tn, H, t);
    if (rc == 0 && t >= 0) rc = rnn::step_gemm(plan, maps, a, w, p, B, 3 * H, H, kTerms, s);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// The f32 input projection on the CUDA cores (rnn::launch_xproj_f32): xp
// [M, N3] = x [M, D] @ w_x [D, N3] + b_x, all float, contiguous, 16-byte
// aligned; D % 4 == 0 and N3 % 4 == 0. block_m, grid and smem_bytes as
// rnn::xproj_f32_plan computes them (ops/cuda/gru.py xproj_f32_config),
// checked here.
int seqrec_gru_xproj_f32(const void* x, const void* w_x, const void* b_x, void* xp, int M,
                         int D, int N3, int block_m, int grid, long long smem_bytes,
                         void* stream) {
  return rnn::launch_xproj_f32(x, w_x, b_x, xp, M, D, N3, block_m, grid, smem_bytes,
                               static_cast<cudaStream_t>(stream));
}

// The f32 recurrence on thread block clusters. xp [B, T, 3H] (the input
// projection, b_x included), h0 [B, H], w_h [H, 3H], b_h [3H], keep [B, T]
// (1 - reset) or null, ys [B, T, H]: all float, contiguous, 16-byte aligned;
// H % 4 == 0, H <= 256. Clusters of `cluster_size` CTAs of `threads`
// threads, each CTA `units` hidden units (cluster_size * units >= H) of
// `rows` batch rows, `slices` k-slices a unit (threads = slices * a padded
// unit count); w_in_regs: W_h's slice in registers (exactly where a slice
// is kGruRegSlice values, 8 slices a unit and rows <= 8). smem_bytes as the
// caller computed it, checked again here.
int seqrec_gru_forward(const void* xp, const void* h0, const void* w_h, const void* b_h,
                       const void* keep, void* ys, int B, int Tn, int H, int rows,
                       int slices, int cluster_size, int units, int threads, int w_in_regs,
                       long long smem_bytes, void* stream) {
  const int C = cluster_size, S = slices;
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      !rnn::cluster_shape_ok(rows, S) || C < 1 || C > rnn::kClusterMax || units <= 0 ||
      C * units < H || threads % 32 != 0 || threads % S != 0 || threads / S < units ||
      threads > rnn::kClusterMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = rnn::slice_len(H, S);
  const size_t nr = rows >= S ? rows / S : 1;
  const size_t smem = (3 * static_cast<size_t>(L) * threads + 2 * static_cast<size_t>(rows) * (S * L + 4) +
                       rnn::kClusterRing * nr * threads * 4) * 4 + 2 * sizeof(uint64_t);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int clusters = (B + rows - 1) / rows;
  if (w_in_regs != (L == kGruRegSlice && S == 8 && rows <= 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xp);
  const float* h = static_cast<const float*>(h0);
  const float* w = static_cast<const float*>(w_h);
  const float* bh = static_cast<const float*>(b_h);
  const float* kp = static_cast<const float*>(keep);
  float* y = static_cast<float*>(ys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kp == nullptr
             ? launch_cluster_fwd<false>(rows, S, w_in_regs, clusters, C, threads, smem, st, x, h, w, bh, kp, y, B, Tn, H, units)
             : launch_cluster_fwd<true>(rows, S, w_in_regs, clusters, C, threads, smem, st, x, h, w, bh, kp, y, B, Tn, H, units);
}

// The bf16 input projection on wgmma (rnn::xproj_wgmma_kernel): xp [M, N3]
// f32 = x [M, D] @ w_x [D, N3] + b_x, with x, w_x bf16 and b_x float; all
// contiguous, 16-byte aligned; D % 4 == 0 and N3 % 4 == 0. tile_m, tile_n,
// stages, tma, grid, band and smem_bytes as rnn::xproj_plan computes them
// (ops/cuda/gru.py xproj_config), checked here.
int seqrec_gru_xproj(const void* x, const void* w_x, const void* b_x, void* xp, int M, int D,
                     int N3, int tile_m, int tile_n, int stages, int tma, int grid,
                     int band, long long smem_bytes, void* stream) {
  return rnn::checked_xproj(x, w_x, b_x, xp, M, D, N3, tile_m, tile_n, stages, tma, grid,
                            band, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The stepped layouts' bf16 step GEMM alone (csrc/step_gemm.cuh): into out,
// ws_bytes of f32, its `splits` partial planes [splits][M][N] of a @ w;
// terms 1: a [M, K], w [K, N]; terms 2: a [M, 2K] ([hi | lo] a row), w
// [N, K]. block_m, splits and ws_bytes as step_gemm_plan computes them,
// checked here. All contiguous; K % 4 == 0, N % 4 == 0.
int seqrec_step_gemm(const void* a, const void* w, void* out, int M, int K, int N, int terms,
                     int splits, int block_m, long long ws_bytes, void* stream) {
  rnn::StepPlan plan;
  const int rc = rnn::stepped_plan(true, M, K, N, terms, splits, block_m, ws_bytes, &plan);
  if (rc != 0) return rc;
  rnn::StepMaps maps;
  const int mrc = rnn::step_maps(plan, a, w, M, K, N, terms, &maps);
  if (mrc != 0) return mrc;
  return rnn::step_gemm(plan, maps, a, w, out, M, K, N, terms, static_cast<cudaStream_t>(stream));
}

// The stepped layouts' f32 step GEMM alone (csrc/fma_gemm.cuh): into out,
// ws_bytes of f32, its `splits` partial planes [splits][M][N] of a [M, K] @
// w [K, N], all float, contiguous, 16-byte aligned; K % 4 == 0, N % 4 == 0.
// block_m, splits and ws_bytes as rnn::fma_plan computes them (ops/cuda/
// gru.py step_gemm_f32_config), checked here.
int seqrec_step_gemm_f32(const void* a, const void* w, void* out, int M, int K, int N,
                         int splits, int block_m, long long ws_bytes, void* stream) {
  rnn::StepPlan plan;
  const int rc = rnn::stepped_plan(false, M, K, N, 1, splits, block_m, ws_bytes, &plan);
  if (rc != 0) return rc;
  rnn::StepMaps maps;
  const int mrc = rnn::step_maps(plan, a, w, M, K, N, 1, &maps);
  if (mrc != 0) return mrc;
  return rnn::step_gemm(plan, maps, a, w, out, M, K, N, 1, static_cast<cudaStream_t>(stream));
}

// The bf16 recurrence on tensor cores, one block of 8 rows (Hp <= 128).
// xp [B, T, 3H] float (the input projection, b_x included), h0 [B, H] and
// w_h [H, 3H] bf16, b_h [3H] float, keep [B, T] float (1 - reset) or null,
// ys [B, T, H] bf16; contiguous, 16-byte aligned; H % 4 == 0, H <= 128.
// smem_bytes (the h double buffer, 2 Hp 8 bf16) as the caller computed it,
// checked again here.
int seqrec_gru_forward_mma(const void* xp, const void* h0, const void* w_h,
                           const void* b_h, const void* keep, void* ys, int B,
                           int Tn, int H, long long smem_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxMmaBlock || H % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = 16 * ((H + 15) / 16);
  const size_t smem = 2 * static_cast<size_t>(kRows) * hp * 2;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xp);
  const float* bh = static_cast<const float*>(b_h);
  const float* kp = static_cast<const float*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kp == nullptr ? launch_mma<false>(x, h0, w_h, bh, kp, ys, B, Tn, H, smem, s)
                       : launch_mma<true>(x, h0, w_h, bh, kp, ys, B, Tn, H, smem, s);
}

// The bf16 recurrence above Hp = 128, on clusters of kWideCluster CTAs of
// kWideThreads threads, a cluster 8 batch rows. xp, h0, b_h, keep and ys
// as seqrec_gru_forward_mma's; w_frag W_h^T's packed A fragments
// [16][16][3][32] x 16 bytes (units and k padded to 256); 128 < H <= 256,
// H % 4 == 0. smem_bytes (kWideFwdSmem) as the caller computed it, checked
// again here.
int seqrec_gru_forward_wide(const void* xp, const void* h0, const void* w_frag,
                            const void* b_h, const void* keep, void* ys, int B, int Tn, int H,
                            long long smem_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= kMaxMmaBlock || H > kMaxHidden || H % 4 != 0 ||
      smem_bytes != kWideFwdSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xp);
  const float* bh = static_cast<const float*>(b_h);
  const float* kp = static_cast<const float*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kp == nullptr ? launch_fwd_wide<false>(s, x, h0, w_frag, bh, kp, ys, B, Tn, H)
                       : launch_fwd_wide<true>(s, x, h0, w_frag, bh, kp, ys, B, Tn, H);
}

// The f32 reverse recurrence on thread block clusters, the gate recompute
// folded in. xp, hp [B, T, 3H] (x W_x + b_x and h_in W_h + b_h), h_in, g_ys
// [B, T, H], w_h [H, 3H]; keep [B, T] (1 - reset; null: the no-reset
// variant); d_xp [B, T, 3H], dn_r [B, T, H] and dh0 [B, H]. All float,
// contiguous, 16-byte aligned; H % 4 == 0, H <= 256. Clusters of
// `cluster_size` CTAs of `threads` threads, each CTA `units` hidden units
// (cluster_size * units >= H) of `rows` batch rows, `slices` k-slices (32:
// a warp's lanes for kBwdUnits units). smem_bytes as the caller computed
// it, checked again here.
int seqrec_gru_backward(const void* xp, const void* hp, const void* h_in, const void* g_ys,
                        const void* w_h, const void* keep, void* d_xp, void* dn_r, void* dh0,
                        int B, int Tn, int H, int rows, int slices, int cluster_size, int units,
                        int threads, long long smem_bytes, void* stream) {
  const int C = cluster_size, S = slices;
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      (rows != 4 && rows != 8 && rows != 16) || S != 32 || C < 1 || C > rnn::kClusterMax ||
      units <= 0 || C * units < H || threads % 32 != 0 || threads / 32 * kBwdUnits < units ||
      threads > rnn::kClusterMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = rnn::slice_len(3 * H, S);
  const size_t np = rows * kBwdUnits >= 32 ? rows * kBwdUnits / 32 : 1;  // pairs a lane
  const size_t smem = (static_cast<size_t>(kBwdUnits) * L * threads +
                       2 * static_cast<size_t>(rows) * (S * L + 4) +
                       rnn::kClusterRing * np * threads * kBwdOperands) * 4 +
                      2 * sizeof(uint64_t);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int clusters = (B + rows - 1) / rows;
  const float* x = static_cast<const float*>(xp);
  const float* hpr = static_cast<const float*>(hp);
  const float* hi = static_cast<const float*>(h_in);
  const float* gy = static_cast<const float*>(g_ys);
  const float* w = static_cast<const float*>(w_h);
  const float* kp = static_cast<const float*>(keep);
  float* dxp = static_cast<float*>(d_xp);
  float* dnr = static_cast<float*>(dn_r);
  float* dh = static_cast<float*>(dh0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kp == nullptr
             ? launch_cluster_bwd<false>(rows, clusters, C, threads, smem, st, x, hpr, hi, gy, w, kp, dxp, dnr, dh, B, Tn, H, units)
             : launch_cluster_bwd<true>(rows, clusters, C, threads, smem, st, x, hpr, hi, gy, w, kp, dxp, dnr, dh, B, Tn, H, units);
}

// The bf16-weight reverse recurrence on tensor cores, the gate recompute
// folded in, one block of 8 rows (Hp <= 128). xp, hp [B, T, 3H] float
// (x W_x + b_x and h_in W_h + b_h); h_in [B, T, H] of hin_dtype (0 = float,
// 1 = bf16); g_ys [B, T, H] bf16; w_frag W_h's packed A fragments
// [Hp/16][3 Hp/16][32] x 16 bytes (Hp = 16 ceil(H / 16)); keep [B, T] float
// (1 - reset) or null; d_xp [B, T, 3H], dn_r [B, T, H] and dh0 [B, H]
// float. All contiguous, 16-byte aligned; H % 4 == 0, H <= 128. smem_bytes
// (BwdSmem) as the caller computed it, checked again here.
int seqrec_gru_backward_mma(const void* xp, const void* hp, const void* h_in,
                            const void* g_ys, const void* w_frag, const void* keep,
                            void* d_xp, void* dn_r, void* dh0, int B, int Tn, int H,
                            int hin_dtype, long long smem_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxMmaBlock || H % 4 != 0 ||
      (hin_dtype != 0 && hin_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = BwdSmem(16 * ((H + 15) / 16), hin_dtype == 0 ? 4 : 2).total;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xp);
  const float* hpr = static_cast<const float*>(hp);
  const float* kp = static_cast<const float*>(keep);
  float* dxp = static_cast<float*>(d_xp);
  float* dnr = static_cast<float*>(dn_r);
  float* dh = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hin_dtype == 0) {
    return kp == nullptr
               ? launch_bwd_mma<false, float>(x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H, smem, s)
               : launch_bwd_mma<true, float>(x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H, smem, s);
  }
  return kp == nullptr
             ? launch_bwd_mma<false, __nv_bfloat16>(x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H, smem, s)
             : launch_bwd_mma<true, __nv_bfloat16>(x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H, smem, s);
}

// The bf16-weight reverse recurrence above Hp = 128, on clusters of
// kWideCluster CTAs of kWideThreads threads, a cluster 8 batch rows.
// Operands as seqrec_gru_backward_mma's but w_frag: W_h's packed A
// fragments [4][16][12][32] x 16 bytes (units and gate columns padded to
// 256); 128 < H <= 256, H % 4 == 0. smem_bytes (WideBwdSmem) as the caller
// computed it, checked again here.
int seqrec_gru_backward_wide(const void* xp, const void* hp, const void* h_in,
                             const void* g_ys, const void* w_frag, const void* keep,
                             void* d_xp, void* dn_r, void* dh0, int B, int Tn, int H,
                             int hin_dtype, long long smem_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= kMaxMmaBlock || H > kMaxHidden || H % 4 != 0 ||
      (hin_dtype != 0 && hin_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = WideBwdSmem(hin_dtype == 0 ? 4 : 2).total;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xp);
  const float* hpr = static_cast<const float*>(hp);
  const float* kp = static_cast<const float*>(keep);
  float* dxp = static_cast<float*>(d_xp);
  float* dnr = static_cast<float*>(dn_r);
  float* dh = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hin_dtype == 0) {
    return kp == nullptr
               ? launch_bwd_wide<false, float>(smem, s, x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H)
               : launch_bwd_wide<true, float>(smem, s, x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H);
  }
  return kp == nullptr
             ? launch_bwd_wide<false, __nv_bfloat16>(smem, s, x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H)
             : launch_bwd_wide<true, __nv_bfloat16>(smem, s, x, hpr, h_in, g_ys, w_frag, kp, dxp, dnr, dh, B, Tn, H);
}

// The grid-persistent forward above H = 256 (either dtype: 0 float, 1
// bf16), one cooperative launch of tiles x groups CTAs. xp [B, T, 3H] float
// (the input projection, b_x included), h0 [B, H] and ys [B, T, H] of the
// dtype, b_h [3H] float, keep [B, T] float (1 - reset) or null; w_pack the
// wrapper's packing of W_h (bf16: [tiles][Kp/16][3][32] x 16 bytes; float:
// [tiles][Kp/4][3][8] float4); ws a zeroed workspace of
// grid_workspace(B, H, dtype, forward) bytes. All contiguous, 16-byte
// aligned; H % 4 == 0, 256 < H. groups, smem_bytes (float: W_h and the
// ring, rnn::GridF32Plan) and ws_bytes as the caller computed them, checked
// again here (grid_check).
int seqrec_gru_forward_grid(const void* xp, const void* h0, const void* w_pack, const void* b_h,
                            const void* keep, void* ys, void* ws, int B, int Tn, int H,
                            int dtype, int groups, long long smem_bytes, long long ws_bytes,
                            void* stream) {
  int grid = 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 1;
  const int rc = rnn::grid_check(B, Tn, H, bf16, kGridGates, groups, smem_bytes, ws_bytes,
                                 grid_workspace(B, H, bf16, false), true, &grid);
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(xp);
  const float* bh = static_cast<const float*>(b_h);
  const float* kp = static_cast<const float*>(keep);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const int smem = static_cast<int>(smem_bytes);  // grid_check's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto* h = static_cast<const __nv_bfloat16*>(h0);
    const auto* wf = static_cast<const uint4*>(w_pack);
    auto* y = static_cast<__nv_bfloat16*>(ys);
    return kp == nullptr
               ? rnn::launch_grid(gru_forward_grid_kernel<false>, grid, smem, s, x, h, wf, bh, kp, y, w, B, Tn, H, groups)
               : rnn::launch_grid(gru_forward_grid_kernel<true>, grid, smem, s, x, h, wf, bh, kp, y, w, B, Tn, H, groups);
  }
  const auto* h = static_cast<const float*>(h0);
  const auto* wf = static_cast<const float4*>(w_pack);
  auto* y = static_cast<float*>(ys);
  using K = decltype(&gru_forward_grid_f32_kernel<false, 32>);
  static const K k[2][3] = {
      {gru_forward_grid_f32_kernel<false, 32>, gru_forward_grid_f32_kernel<false, 64>, gru_forward_grid_f32_kernel<false, 128>},
      {gru_forward_grid_f32_kernel<true, 32>, gru_forward_grid_f32_kernel<true, 64>, gru_forward_grid_f32_kernel<true, 128>}};
  return rnn::launch_grid_f32(rnn::grid_f32_plan(B, H, groups, kGridGates).block,
                              k[kp != nullptr], grid, smem, s, x, h, wf, bh, kp, y, w, B, Tn, H,
                              groups);
}

// The grid-persistent reverse recurrence above H = 256, the gate recompute
// folded in; dtype is W_h's (0 float, 1 bf16). xp, hp [B, T, 3H] float;
// h_in [B, T, H] of hin_dtype (float with float weights; float or bf16 with
// bf16 ones); g_ys [B, T, H] of the weights' dtype; w_pack the wrapper's
// packing of W_h (bf16: [tiles][3 Kp/16][32] x 16 bytes; float:
// [tiles][3 Kp/128][8][32] float4); keep [B, T] float or null; d_xp
// [B, T, 3H], dn_r [B, T, H], dh0 [B, H] float; ws a zeroed workspace of
// grid_workspace(B, H, dtype, reverse) bytes. As the forward otherwise.
int seqrec_gru_backward_grid(const void* xp, const void* hp, const void* h_in, const void* g_ys,
                             const void* w_pack, const void* keep, void* d_xp, void* dn_r,
                             void* dh0, void* ws, int B, int Tn, int H, int dtype, int hin_dtype,
                             int groups, long long smem_bytes, long long ws_bytes, void* stream) {
  int grid = 0;
  if ((dtype != 0 && dtype != 1) || (hin_dtype != 0 && hin_dtype != 1) ||
      (dtype == 0 && hin_dtype != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == 1;
  const int rc = rnn::grid_check(B, Tn, H, bf16, kGridGates, groups, smem_bytes, ws_bytes,
                                 grid_workspace(B, H, bf16, true), false, &grid);
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(xp);
  const float* hpr = static_cast<const float*>(hp);
  const float* kp = static_cast<const float*>(keep);
  float* dxp = static_cast<float*>(d_xp);
  float* dnr = static_cast<float*>(dn_r);
  float* dh = static_cast<float*>(dh0);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const int smem = rnn::grid_smem(H, bf16, kGridGates);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    const auto* hi = static_cast<const float*>(h_in);
    const auto* gy = static_cast<const float*>(g_ys);
    const auto* wf = static_cast<const float4*>(w_pack);
    return kp == nullptr
               ? rnn::launch_grid(gru_backward_grid_f32_kernel<false>, grid, smem, s, x, hpr, hi, gy, wf, kp, dxp, dnr, dh, w, B, Tn, H, groups)
               : rnn::launch_grid(gru_backward_grid_f32_kernel<true>, grid, smem, s, x, hpr, hi, gy, wf, kp, dxp, dnr, dh, w, B, Tn, H, groups);
  }
  const auto* gy = static_cast<const __nv_bfloat16*>(g_ys);
  const auto* wf = static_cast<const uint4*>(w_pack);
  if (hin_dtype == 0) {
    const auto* hi = static_cast<const float*>(h_in);
    return kp == nullptr
               ? rnn::launch_grid(gru_backward_grid_kernel<false, float>, grid, smem, s, x, hpr, hi, gy, wf, kp, dxp, dnr, dh, w, B, Tn, H, groups)
               : rnn::launch_grid(gru_backward_grid_kernel<true, float>, grid, smem, s, x, hpr, hi, gy, wf, kp, dxp, dnr, dh, w, B, Tn, H, groups);
  }
  const auto* hi = static_cast<const __nv_bfloat16*>(h_in);
  return kp == nullptr
             ? rnn::launch_grid(gru_backward_grid_kernel<false, __nv_bfloat16>, grid, smem, s, x, hpr, hi, gy, wf, kp, dxp, dnr, dh, w, B, Tn, H, groups)
             : rnn::launch_grid(gru_backward_grid_kernel<true, __nv_bfloat16>, grid, smem, s, x, hpr, hi, gy, wf, kp, dxp, dnr, dh, w, B, Tn, H, groups);
}

// The stepped layout past grid_max_hidden (either dtype, dtype 0 float, 1
// bf16): T launches of the step's GEMM (hbuf @ w_h into hp, f32) each
// followed by the step's gate kernel. xp [B, T, 3H] float (the input
// projection, b_x included); hbuf [B, H] of the dtype, holding h0 (times
// keep[:, 0] in the reset variant) and, after the scan, the last step's h
// handed on; w_h [H, 3H] of the dtype; b_h [3H] float; keep [B, T] float or
// null; ys [B, T, H] of the dtype; hp float scratch of ws_bytes: the step
// GEMM's [splits][B][3H] partial planes (rows a block `block_m`, as bf16
// step_gemm_plan, f32 fma_plan computes them). All contiguous, 16-byte
// aligned; H % 4 == 0.
int seqrec_gru_forward_stepped(const void* xp, void* hbuf, const void* w_h, const void* b_h,
                               const void* keep, void* ys, void* hp, int B, int Tn, int H,
                               int dtype, int splits, int block_m, long long ws_bytes,
                               void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H % 4 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rnn::StepPlan plan;
  const int rc = rnn::stepped_plan(dtype == 1, B, H, 3 * H, 1, splits, block_m, ws_bytes, &plan);
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(xp);
  const float* bh = static_cast<const float*>(b_h);
  const float* kp = static_cast<const float*>(keep);
  float* hq = static_cast<float*>(hp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto* hb = static_cast<bf*>(hbuf);
    const auto* w = static_cast<const bf*>(w_h);
    auto* y = static_cast<bf*>(ys);
    return kp == nullptr ? stepped_forward<bf, false>(x, hb, w, bh, kp, y, hq, plan, B, Tn, H, s)
                         : stepped_forward<bf, true>(x, hb, w, bh, kp, y, hq, plan, B, Tn, H, s);
  }
  auto* hb = static_cast<float*>(hbuf);
  const auto* w = static_cast<const float*>(w_h);
  auto* y = static_cast<float*>(ys);
  return kp == nullptr
             ? stepped_forward<float, false>(x, hb, w, bh, kp, y, hq, plan, B, Tn, H, s)
             : stepped_forward<float, true>(x, hb, w, bh, kp, y, hq, plan, B, Tn, H, s);
}

// The stepped reverse recurrence; dtype is W_h's (0 float, 1 bf16). xp, hp
// [B, T, 3H] float; h_in [B, T, H] of hin_dtype (float with float weights);
// g_ys [B, T, H] of the weights' dtype; w: bf16 W_h [H, 3H] as stored, f32
// W_h^T [3H, H]; keep [B, T] float or null; d_xp [B, T, 3H], dn_r [B, T,
// H], dh0 [B, H] float; scratch: a [B, 3H] float or [B, 6H] bf16 (the
// step's d_hproj; bf16 its hi and lo terms, [hi | lo] a row), p float of
// ws_bytes (the step GEMM's [splits][B][H] partial planes) and z [B, H]
// float. As the forward otherwise.
int seqrec_gru_backward_stepped(const void* xp, const void* hp, const void* h_in,
                                const void* g_ys, const void* w,
                                const void* keep, void* d_xp, void* dn_r, void* dh0, void* a,
                                void* p, void* z, int B, int Tn, int H, int dtype, int hin_dtype,
                                int splits, int block_m, long long ws_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H % 4 != 0 || (dtype != 0 && dtype != 1) ||
      (hin_dtype != 0 && hin_dtype != 1) || (dtype == 0 && hin_dtype != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rnn::StepPlan plan;
  const int rc = rnn::stepped_plan(dtype == 1, B, 3 * H, H, dtype == 1 ? 2 : 1, splits, block_m,
                                   ws_bytes, &plan);
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(xp);
  const float* hq = static_cast<const float*>(hp);
  const float* kp = static_cast<const float*>(keep);
  float* dx = static_cast<float*>(d_xp);
  float* dn = static_cast<float*>(dn_r);
  float* d0 = static_cast<float*>(dh0);
  float* pp = static_cast<float*>(p);
  float* zb = static_cast<float*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEQREC_STEP_BWD(W, HIn)                                                                  \
  (kp == nullptr                                                                                 \
       ? stepped_backward<W, HIn, false>(x, hq, static_cast<const HIn*>(h_in),                   \
                                         static_cast<const W*>(g_ys), static_cast<const W*>(w),   \
                                         kp, dx, dn, d0, static_cast<W*>(a), pp, zb, plan, B,     \
                                         Tn, H, s)                                               \
       : stepped_backward<W, HIn, true>(x, hq, static_cast<const HIn*>(h_in),                    \
                                        static_cast<const W*>(g_ys), static_cast<const W*>(w),    \
                                        kp, dx, dn, d0, static_cast<W*>(a), pp, zb, plan, B,      \
                                        Tn, H, s))
  if (dtype == 0) return SEQREC_STEP_BWD(float, float);
  if (hin_dtype == 0) return SEQREC_STEP_BWD(__nv_bfloat16, float);
  return SEQREC_STEP_BWD(__nv_bfloat16, __nv_bfloat16);
#undef SEQREC_STEP_BWD
}

const char* seqrec_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
