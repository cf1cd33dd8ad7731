// LSTM scan forward and its reverse recurrence for Hopper (sm_90a).
//
// Forward replaces the TPU kernel seqrec_tpu/ops/pallas/lstm.py
// (_lstm_step_body via _lstm_forward_pallas, both variants:
// _lstm_step_kernel and, with a keep plane, _lstm_step_kernel_reset): a
// sequential grid over T with h, an f32 c and both weight matrices held in
// VMEM, the input projection computed inside each step. Math per step (gate
// blocks i|f|g|o, as ops/reference.py::lstm_scan):
//   h, c *= keep[t]              (session-parallel variant; keep = 1 - reset)
//   z = x[t] @ W_x + h @ W_h + b                       (f32 accumulation)
//   i = sigmoid(z_i), f = sigmoid(z_f), g = tanh(z_g), o = sigmoid(z_o)
//   c' = f c + i g  (f32, never rounded),  h' = o tanh(c')
//   h' is rounded to the working dtype (float or bf16) every step, is
//   written to ys[:, t], and is the next step's h.
// It also writes c_T, and, when the caller asks (training), the f32 cell
// plane c_1..c_T, so the backward needs no serial recompute of the cells.
// Reset variant (a template flag, so that the no-reset instantiations
// compile as without it): at the end of step t the lane or thread that
// hands unit i of a row to step t+1 scales it by keep[t+1], the h' it
// writes to the next step's shared buffer and the c' in its register,
// after ys, the cell plane and (at t = T-1) c_T took the unscaled values.
// keep is a [B, T] f32 plane, one scalar a row a step, read a step ahead.
//
// What bounds it: the 200-step serial chain. At the training shape (B=128,
// T=200, D=H=128) the scan reads and writes 13 MB and does 6.7 GFLOP,
// microseconds of the card's rates, but each step's [rows, 128] x [128,
// 512] product waits on the one before: the latency of one step, times T.
//
// bf16 (every shipped config): two kernels, csrc/gru.cu's bf16 design with
// four gates.
// 1. rnn::xproj_wgmma_kernel (csrc/rnn.cuh), the input projection off the
//    serial chain: xp = x @ W_x + b for all B*T rows at once, one
//    tensor-core GEMM (wgmma, warp-specialised, persistent) into an f32
//    [B, T, 4H] plane (52 MB at B=128, T=200, H=128: about the
//    L2's size, so the scan's reads of it may come from HBM).
// 2. lstm_forward_mma_kernel, the recurrence, transposed: z^T = W_h^T h^T
//    on mma.sync.m16n8k16, the hidden units as M and a block's 8 batch rows
//    as N. H pads to Hp = 16 ceil(H / 16) with zero weights (a padded unit
//    keeps c = h = 0: xp and the products are 0 there, so c' = c / 2); the
//    block has Hp / 16 warps, and warp w owns units [16w, 16w + 16) of each
//    of the four gates, so the i, f, g and o sums of one (unit, row) land in
//    the same register of the same lane: no exchange for the gate math, and
//    the lane keeps its f32 cells in registers for the whole scan. W_h^T's
//    A fragments come packed by the wrapper (forward_fragments) and stay in registers
//    while Hp <= 128 (128 a lane at H=128); above that they are read from
//    global memory (L1/L2) every step. h goes through a double-buffered
//    unit-major [2][Hp][8] bf16 buffer (one barrier a step) and comes back
//    as B fragments by ldmatrix.trans, a k-step ahead of their products.
//    The step's xp arrives by cp.async in a ring of shared-memory stages two
//    steps ahead of its use, and keep[t+1] a step ahead in registers: loads
//    a step ahead in registers left the step waiting on them. Per step and
//    block at H=128: 8 warps x 32 mma.sync and 1,024 (unit, row) cell
//    updates from the hardware exp2 and a fast divide (a few ulp in f32; h
//    is then rounded to bf16).
//
// f32: two kernels on the CUDA cores, because TF32 tensor cores keep ~3
// digits and the f32 contract is f32 products; csrc/gru.cu's f32 design
// with four gates and a cell.
// 1. rnn::launch_xproj_f32 (csrc/rnn.cuh), the input projection off the
//    serial chain as the GRU's (the FMA GEMM from D = 256, SIMT below): xp =
//    x @ W_x + b into an f32 [B, T, 4H] plane (its operations bind: 3.36 GFLOP at B=128, T=200,
//    D=H=128, 0.050 ms at 67 TFLOP/s).
// 2. lstm_forward_cluster_kernel, the recurrence on a thread block cluster.
//    W_h is 256 KB at H=128, over the 227 KB one block may have, and the
//    first port's one-block design re-read it and W_x from L2 every step,
//    the x-product inside the serial chain (~7.7 us a step). Here a cluster
//    of C CTAs on neighbouring SMs owns R batch rows for the whole scan,
//    each CTA a slice of the hidden units with their W_h columns of all four
//    gates (64 KB at H=128, C=4) resident in its shared memory (and, at 16
//    k values a thread, in its registers: 64), and each step's new h values
//    go to every CTA through distributed shared memory, st.async counted by
//    an mbarrier a buffer (the layout, the reduce-scatter and the exchange
//    in rnn.cuh). The owner lane of a (unit, row) pair keeps its f32 cell in
//    a register for the whole scan. What sets a step: the exchange's
//    latency, the reduce-scatter and the accurate f32 gate math on the
//    serial chain, then one CTA's FMAs and shared-memory reads for its rows
//    and units; C and R follow B and H (ops/cuda/lstm.py launch_config).

// Backward: the reverse recurrence of the analytic BPTT, replacing the
// reverse `lax.scan` inside seqrec_tpu/ops/pallas/lstm.py::_lstm_bwd_math
// (XLA in the TPU package; its hoisted products stay outside, here as
// torch.matmul). Given the gate planes i, f, g, o, tanh(c) and c_in
// (= c_{t-1}) [B, T, H] f32 and the output cotangents g_ys [B, T, H], per
// step t = T-1 .. 0 with f32 carries dh, dc (dc starts at the cotangent of
// c_T):
//   dh += g_y;  dc += dh o (1 - tanh_c^2)
//   dz = [dc g i(1-i) | dc c_in f(1-f) | dc i (1-g^2) | dh tanh_c o(1-o)]
//   d_xp[t] = dz (written, f32);  dh = dz @ W_h^T;  dc = dc f
// Reset variant (the keep path of _lstm_bwd_math, lstm.py:265-269): dh_prev
// and dc_prev *= keep[t], read with the step's planes; c_in arrives already
// scaled (reference.lstm_bwd_hoist).
// What bounds it: the serial chain again; the bytes (six f32 planes, g_ys
// and d_xp: ~137 MB at B=128, T=200, H=128 in bf16) are ~41 us of the
// card's rate, more than its operations take.
//
// bf16 (lstm_backward_mma_kernel): the forward's design, mirrored:
// dh_prev^T = W_h dz^T on mma.sync, units as M, 8 rows as N, K = 4 Hp (the
// gate columns, each gate padded to Hp = 32 ceil(H / 32)). W_h's A
// fragments are pairs of adjacent elements of a W_h row, packed by the
// wrapper, in registers up to Hp = 128 (128 registers a lane). A lane
// computes the four dz values of each of its own (unit, row) pairs, writes
// them to d_xp and into a k-major [4 Hp][8] dz^T buffer in shared memory,
// and keeps dh and dc in f32 registers. The contract is an f32 dz times
// bf16-valued weights summed in f32 (the reference's dz is f32), and one
// bf16 product would round dz to 8 bits every step, which compounds over T.
// So dz is split, hi = bf16(dz) and lo = bf16(dz - hi), and the two
// products share the A fragments (one ldmatrix.x4.trans brings both B
// fragments): W_h is exact in bf16, so only dz's tail below 2^-17 of it is
// lost. Every warp reading all of dz^T for its products made shared memory
// the limit, so the warps split K in pairs: warp 2j + h computes tiles 2j
// and 2j + 1 over half h of K, and the pair exchanges partial sums through
// shared memory (a second barrier a step). The step's gate planes and g_ys
// arrive by cp.async in a ring of shared-memory stages two steps ahead of
// their use: one step ahead in registers left the step waiting on HBM.

// f32 (lstm_backward_cluster_kernel): the reverse recurrence on a thread
// block cluster, with f32 FMA products (no TF32). W_h (256 KB at H=128) fits
// no single SM, and the first port's one-block design re-read all of it
// from L2 every step (~17.6 us a step). Here a cluster of C CTAs owns R
// batch rows, CTA c the units [c U, c U + U) with W_h's rows of those units
// (64 KB at H=128, C=4) resident in its shared memory; each owner lane
// computes the dz of its (unit, row) pairs and keeps dh and dc in
// registers, the dz values go to every CTA through distributed shared memory
// (st.async, counted by an mbarrier a buffer), and each CTA then computes
// dh_prev for its units (csrc/rnn.cuh's cluster layout). What bounds the
// product is shared memory, not the FMAs: every thread group reads all of
// the step's dz (R x 4H floats), so a warp's 32 lanes split the 4H columns
// for 4 units (kBwdUnits) and each dz value read serves 4 units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "rnn.cuh"

namespace {

constexpr int kMaxHidden = 256;  // the widest H of the block and cluster layouts (wider: the grid layout)
// Units a warp of the f32 cluster reverse recurrence sums for (its 32 lanes
// split their K = 4H columns): each dz value read from shared memory serves
// this many units.
constexpr int kBwdUnits = 4;

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

// W_h's slice in registers where it is 16 k values a thread (kLstmRegSlice)
// with 8 slices a unit, up to 8 rows and 256 threads (H = 128 on 4 CTAs):
// 64 registers beside the rows' sums, under the 255 a thread of a
// 256-thread block may have.
constexpr int kLstmRegSlice = 16;
constexpr int kLstmRegThreads = 256;

// The recurrence (rnn.cuh's cluster layout, K = H): CTA c of a cluster of C
// owns units [c U, c U + U) of the cluster's R rows. Its shared memory holds
// W_h's columns of its units, all four gates, k-sliced as
// [L/4][4][threads][4] (thread S ul + s reads its slice's four k rows of
// gate q as one float4, consecutive threads consecutive float4s), and h of
// step t in two buffers [2][R][S L + 4] laid out by rnn::slice_pos (a row's
// 4 extra floats put the rows' copies of one unit in different banks). A
// step: every thread sums h[r][k] W_h[k][q H + u] over its slice for its R
// rows and four gates (f32 FMAs; each W_h float4 serves R rows, each h
// float4 four gates), the reduce-scatter leaves the owner lane of (u, r) its
// i, f, g and o sums, it computes c' and h' in f32 (expf, tanhf), writes ys
// (and the cell plane) and stores h' (times keep[t+1] in the reset variant)
// into every CTA's next buffer with st.async, counted by that CTA's
// mbarrier of the buffer, for which one thread waits (then a CTA barrier)
// before the next step reads it; c' (times keep[t+1]) stays in the lane's
// register. xp (b included) and keep arrive by cp.async in the lane's slots
// of a ring, kClusterAhead steps ahead. The lanes that share an owner's sums
// (the reduce-scatter's copies) compute the same cells and store nothing.
// Padded k rows, padded units and rows past B hold zeros and are never
// written.
template <int R, int S, bool kReset, int kRegChunks>
__global__ void __launch_bounds__(kRegChunks > 0 ? kLstmRegThreads : rnn::kClusterMaxThreads)
lstm_forward_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                            const float* __restrict__ c0, const float* __restrict__ w_h,
                            const float* __restrict__ keep, float* __restrict__ ys,
                            float* __restrict__ c_last, float* __restrict__ cs, int B, int Tn,
                            int H, int U) {
  using Own = rnn::Owner<R, 1, S>;
  constexpr int NR = Own::NR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, Up = NT / S;
  const int L = rnn::slice_len(H, S), ld = S * L + 4, H4 = 4 * H;
  float* ws = reinterpret_cast<float*>(smem);  // [L/4][4][NT][4]
  float* hs = ws + 4 * L * NT;                 // [2][R][ld]
  const unsigned C = rnn::cluster::size();
  const int u0 = static_cast<int>(rnn::cluster::rank()) * U;
  const int b0 = static_cast<int>(rnn::cluster::id()) * R;
  const int tid = threadIdx.x, s = tid % S, ul = tid / S, u = u0 + ul;
  const bool unit_ok = ul < U && u < H;
  const Own own(s);

  // W_h's columns of this CTA's units (reads of consecutive units coalesce).
  for (int idx = tid; idx < S * L * 4 * Up; idx += NT) {
    const int k = idx / (4 * Up), q = (idx / Up) % 4, vl = idx % Up;
    const bool in = k < H && vl < U && u0 + vl < H;
    const int ks = k / L, o = k - ks * L;
    ws[(((o >> 2) * 4 + q) * NT + vl * S + ks) * 4 + (o & 3)] =
        in ? w_h[static_cast<size_t>(k) * H4 + q * H + u0 + vl] : 0.0f;
  }
  for (int c = tid; c < 2 * R * ld; c += NT) hs[c] = 0.0f;
  __syncthreads();
  // h of step 0 (keep[0] h0) for every unit of the cluster's rows.
  for (int c = tid; c < R * H; c += NT) {
    const int r = c / H, k = c - r * H, b = b0 + r;
    if (b < B) {
      const float h = h0[static_cast<size_t>(b) * H + k];
      hs[r * ld + rnn::slice_pos(k, L, S)] =
          kReset ? __fmul_rn(h, keep[static_cast<size_t>(b) * Tn]) : h;
    }
  }
  // The lane's cells: keep[0] c0 of its rows at unit u.
  float cell[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int b = b0 + own.row0 + k;
    cell[k] = 0.0f;
    if (unit_ok && b < B) {
      const float c = c0[static_cast<size_t>(b) * H + u];
      cell[k] = kReset ? __fmul_rn(c, keep[static_cast<size_t>(b) * Tn]) : c;
    }
  }
  // Step t's operands of the lane's rows into ring stage t % kClusterRing:
  // xp's i, f, g and o columns (b included) as [stage][NR][threads][4], and
  // keep[t+1] (the scale of the h' and c' step t hands on) as
  // [stage][NR][threads]; zeros where there is no such row, unit or step.
  // One commit group a step.
  float* ring = hs + 2 * R * ld;
  float* kring = ring + rnn::kClusterRing * NR * NT * 4;
  auto issue = [&](int t) {
    const int st = t % rnn::kClusterRing;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int b = b0 + own.row0 + k;
      const bool in = unit_ok && b < B && t < Tn;
      const float* src = xp + ((static_cast<size_t>(b) * Tn + t) * H4 + u);
      float* dst = ring + ((st * NR + k) * NT + tid) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) mma::cp_async4_zfill(dst + q, in ? src + q * H : xp, in ? 4 : 0);
      if (kReset) {
        const bool kin = b < B && t + 1 < Tn;
        mma::cp_async4_zfill(kring + (st * NR + k) * NT + tid,
                             kin ? keep + static_cast<size_t>(b) * Tn + t + 1 : xp, kin ? 4 : 0);
      }
    }
    mma::cp_async_commit();
  };
  for (int t = 0; t < rnn::kClusterAhead; ++t) issue(t);
  // h'(t) lands in buffer (t+1) & 1: H R values a fill, from every CTA.
  uint64_t* mb = reinterpret_cast<uint64_t*>(kring + rnn::kClusterRing * NR * NT);
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
  float4 wreg[kRC][4];
  if constexpr (kRegChunks > 0) {
#pragma unroll
    for (int j = 0; j < kRC; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) wreg[j][q] = w4[(j * 4 + q) * NT + tid];
  }
  for (int t = 0; t < Tn; ++t) {
    if (t > 0) {  // wait for h'(t-1): fill n of buffer t & 1
      const int qb = t & 1;
      const unsigned n = qb ? (t - 1) >> 1 : (t >> 1) - 1;
      if (tid == 0) {
        rnn::cluster::mbar_wait(&mb[qb], n & 1);
        if (t + 2 < Tn) rnn::cluster::mbar_expect(&mb[qb], fill_bytes);  // h'(t+1)
      }
      __syncthreads();
    }
    const float4* h4 = reinterpret_cast<const float4*>(hs + (t & 1) * R * ld);
    float acc[R][1][4];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0][0] = acc[r][0][1] = acc[r][0][2] = acc[r][0][3] = 0.0f;
    if constexpr (kRegChunks > 0) {
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 h = h4[r * (ld / 4) + j * S + s];
#pragma unroll
          for (int q = 0; q < 4; ++q) dot4(acc[r][0][q], h, wreg[j][q]);
        }
      }
    } else {
      for (int j = 0; j < L / 4; ++j) {
        float4 w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = w4[(j * 4 + q) * NT + tid];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 h = h4[r * (ld / 4) + j * S + s];
#pragma unroll
          for (int q = 0; q < 4; ++q) dot4(acc[r][0][q], h, w[q]);
        }
      }
    }
    rnn::reduce_scatter<R, 1, S / 2, R, 1, 4>(acc, s);

    issue(t + rnn::kClusterAhead);
    mma::cp_async_wait<rnn::kClusterAhead>();  // step t's operands are in
    const int st = t % rnn::kClusterRing;
    float* hn = hs + ((t + 1) & 1) * R * ld;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int row = own.row0 + k, b = b0 + row;
      const float4 x = reinterpret_cast<const float4*>(ring)[(st * NR + k) * NT + tid];
      const float ig = sigmoidf(x.x + acc[k][0][0]);
      const float fg = sigmoidf(x.y + acc[k][0][1]);
      const float gg = tanhf(x.z + acc[k][0][2]);
      const float og = sigmoidf(x.w + acc[k][0][3]);
      const float c = fg * cell[k] + ig * gg;
      const float h = og * tanhf(c);
      if (own.owner && unit_ok && b < B) {
        const size_t idx = (static_cast<size_t>(b) * Tn + t) * H + u;
        ys[idx] = h;
        if (cs != nullptr) cs[idx] = c;
      }
      cell[k] = c;
      if (t + 1 < Tn) {
        // keep[t+1] scales the h' and c' this step hands to the next one.
        const float kn = kReset ? kring[(st * NR + k) * NT + tid] : 1.0f;
        const float hk = kReset ? __fmul_rn(h, kn) : h;
        if (kReset) cell[k] = __fmul_rn(c, kn);
        if (own.owner && unit_ok) {
          const float* dst = hn + row * ld + rnn::slice_pos(u, L, S);
          for (unsigned p = 0; p < C; ++p) {
            rnn::cluster::store_async(rnn::cluster::map(dst, p), hk,
                                      rnn::cluster::map(&mb[(t + 1) & 1], p));
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int b = b0 + own.row0 + k;
    if (own.owner && unit_ok && b < B) c_last[static_cast<size_t>(b) * H + u] = cell[k];
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  rnn::cluster::sync();
}

template <bool kReset>
int launch_cluster_fwd(int R, int S, bool w_in_regs, int clusters, int C, int threads,
                       size_t smem, cudaStream_t st, const float* xp, const float* h0,
                       const float* c0, const float* w_h, const float* keep, float* ys,
                       float* c_last, float* cs, int B, int Tn, int H, int U) {
  auto go = [&](auto kernel) {
    return rnn::launch_clusters(kernel, clusters, C, threads, smem, st, xp, h0, c0, w_h, keep,
                                ys, c_last, cs, B, Tn, H, U);
  };
  constexpr int kRC = kLstmRegSlice / 4;
  switch (R * 1000 + S * 10 + w_in_regs) {
    case 4080: return go(lstm_forward_cluster_kernel<4, 8, kReset, 0>);
    case 4081: return go(lstm_forward_cluster_kernel<4, 8, kReset, kRC>);
    case 4160: return go(lstm_forward_cluster_kernel<4, 16, kReset, 0>);
    case 8080: return go(lstm_forward_cluster_kernel<8, 8, kReset, 0>);
    case 8081: return go(lstm_forward_cluster_kernel<8, 8, kReset, kRC>);
    case 8160: return go(lstm_forward_cluster_kernel<8, 16, kReset, 0>);
    case 16080: return go(lstm_forward_cluster_kernel<16, 8, kReset, 0>);
    case 16160: return go(lstm_forward_cluster_kernel<16, 16, kReset, 0>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// f32 reverse recurrence on a thread block cluster
// ---------------------------------------------------------------------------

// rnn.cuh's cluster layout with K = 4H: CTA c of a cluster of C owns units
// [c U, c U + U) of the cluster's R rows. Its shared memory holds W_h's rows
// of its units (all 4H columns, k-sliced as [L/4][threads][4]: thread
// S ul + s reads four columns of its slice as one float4) and dz of the step
// in two buffers [2][R][S L + 4] laid out by rnn::slice_pos. A step, for
// t = T-1 .. 0: the owner lane of (u, r) adds g_y to its dh carry, computes
// dc and the four dz values of its pair from the gate planes (which arrive
// by cp.async in the lane's slots of a ring, kClusterAhead steps ahead),
// stores them into every CTA's buffer with st.async (counted by that CTA's
// mbarrier of the buffer), writes d_xp and keeps dc f (times keep[t]) in a
// register; one thread waits for the buffer's fill, then a CTA barrier;
// then every thread sums dz[r][col] W_h[u][col] over its slice for the R
// rows, and the reduce-scatter leaves the owner its dh carry (times
// keep[t]).
template <int R, bool kReset>
__global__ void __launch_bounds__(rnn::kClusterMaxThreads)
lstm_backward_cluster_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                             const float* __restrict__ gg, const float* __restrict__ og,
                             const float* __restrict__ tcg, const float* __restrict__ cing,
                             const float* __restrict__ g_ys, const float* __restrict__ w_h,
                             const float* __restrict__ keep, const float* __restrict__ dc_last,
                             float* __restrict__ d_xp, float* __restrict__ dh0,
                             float* __restrict__ dc0, int B, int Tn, int H, int U) {
  constexpr int S = 32, UT = kBwdUnits;
  using Own = rnn::Owner<R, UT, 32>;
  constexpr int NRo = Own::NR, NUo = Own::NU;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, Up = NT / S * UT, H4 = 4 * H;
  const int L = rnn::slice_len(H4, S), ld = S * L + 4;
  float* ws = reinterpret_cast<float*>(smem);  // [L/4][UT][NT][4]
  float* dzs = ws + UT * L * NT;               // [2][R][ld]
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
    const bool in = col < H4 && vl < U && u0 + vl < H;
    const int ks = col / L, o = col - ks * L;
    ws[((((o >> 2) * UT + vl % UT) * NT) + (vl / UT) * S + ks) * 4 + (o & 3)] =
        in ? w_h[static_cast<size_t>(u0 + vl) * H4 + col] : 0.0f;
  }
  for (int c = tid; c < 2 * R * ld; c += NT) dzs[c] = 0.0f;

  float dh_c[NRo][NUo], dc_c[NRo][NUo];
#pragma unroll
  for (int k = 0; k < NRo; ++k) {
    const int b = b0 + own.row0 + k;
#pragma unroll
    for (int m = 0; m < NUo; ++m) {
      dh_c[k][m] = 0.0f;
      dc_c[k][m] = unit_ok[m] && b < B ? dc_last[static_cast<size_t>(b) * H + unit[m]] : 0.0f;
    }
  }
  // Step t = T-1-it's operands of the lane's pairs into ring stage
  // it % kClusterRing, [stage][NRo NUo][threads][8]: i, f, g, o, tanh c,
  // c_in, g_y and keep[t]; zeros where there is no such row, unit or step.
  // One commit group a step.
  constexpr int NP = NRo * NUo;
  float* ring = dzs + 2 * R * ld;
  const float* planes[7] = {ig, fg, gg, og, tcg, cing, g_ys};
  auto issue = [&](int it) {
    const int t = Tn - 1 - it;
    float* st = ring + (it % rnn::kClusterRing) * NP * NT * 8;
#pragma unroll
    for (int k = 0; k < NRo; ++k) {
      const int b = b0 + own.row0 + k;
#pragma unroll
      for (int m = 0; m < NUo; ++m) {
        const bool in = unit_ok[m] && b < B && t >= 0;
        const size_t idx = (static_cast<size_t>(b) * Tn + t) * H + unit[m];
        float* dst = st + ((k * NUo + m) * NT + tid) * 8;
#pragma unroll
        for (int q = 0; q < 7; ++q) mma::cp_async4_zfill(dst + q, in ? planes[q] + idx : ig, in ? 4 : 0);
        const bool kin = kReset && b < B && t >= 0;
        mma::cp_async4_zfill(dst + 7, kin ? keep + static_cast<size_t>(b) * Tn + t : ig,
                             kin ? 4 : 0);
      }
    }
    mma::cp_async_commit();
  };
  for (int it = 0; it < rnn::kClusterAhead; ++it) issue(it);
  // dz of iteration it lands in buffer it & 1: 4 H R values a fill.
  uint64_t* mb = reinterpret_cast<uint64_t*>(ring + rnn::kClusterRing * NP * NT * 8);
  const unsigned fill_bytes = static_cast<unsigned>(H4 * R * 4);
  if (tid == 0) {
    rnn::cluster::mbar_init(&mb[0]);
    rnn::cluster::mbar_init(&mb[1]);
    rnn::cluster::mbar_init_fence();
    rnn::cluster::mbar_expect(&mb[0], fill_bytes);
    if (Tn >= 2) rnn::cluster::mbar_expect(&mb[1], fill_bytes);
  }
  rnn::cluster::sync();  // every CTA of the cluster is running, its buffers zero

  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (int t = Tn - 1, it = 0; t >= 0; --t, ++it) {
    float* dz = dzs + (it & 1) * R * ld;
    issue(it + rnn::kClusterAhead);
    mma::cp_async_wait<rnn::kClusterAhead>();  // step t's operands are in
    const float4* cur = reinterpret_cast<const float4*>(ring) + (it % rnn::kClusterRing) * NP * NT * 2;
    float keep_t[NRo][NUo];
#pragma unroll
    for (int k = 0; k < NRo; ++k) {
      const int row = own.row0 + k, b = b0 + row;
#pragma unroll
      for (int m = 0; m < NUo; ++m) {
        const float4 a = cur[((k * NUo + m) * NT + tid) * 2];
        const float4 c = cur[((k * NUo + m) * NT + tid) * 2 + 1];
        const float iv = a.x, fv = a.y, gv = a.z, ov = a.w;
        const float tc = c.x, cin = c.y;
        const float dh = dh_c[k][m] + c.z;
        const float dc = dc_c[k][m] + dh * ov * (1.0f - tc * tc);
        const float d[4] = {dc * gv * iv * (1.0f - iv), dc * cin * fv * (1.0f - fv),
                            dc * iv * (1.0f - gv * gv), dh * tc * ov * (1.0f - ov)};
        if (own.owner && unit_ok[m]) {
          float* row_dz = dz + row * ld;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* dst = row_dz + rnn::slice_pos(q * H + unit[m], L, S);
            for (unsigned p = 0; p < C; ++p) {
              rnn::cluster::store_async(rnn::cluster::map(dst, p), d[q],
                                        rnn::cluster::map(&mb[it & 1], p));
            }
          }
          if (b < B) {
            float* out = d_xp + (static_cast<size_t>(b) * Tn + t) * H4 + unit[m];
#pragma unroll
            for (int q = 0; q < 4; ++q) out[q * H] = d[q];
          }
        }
        dc_c[k][m] = __fmul_rn(dc, fv);
        if (kReset) dc_c[k][m] = __fmul_rn(dc_c[k][m], c.w);  // dc_prev *= keep[t]
        keep_t[k][m] = c.w;
      }
    }
    if (tid == 0) {  // wait for dz of this step: fill it >> 1 of buffer it & 1
      rnn::cluster::mbar_wait(&mb[it & 1], (it >> 1) & 1);
      if (it + 2 < Tn) rnn::cluster::mbar_expect(&mb[it & 1], fill_bytes);
    }
    __syncthreads();

    // dh_prev = dz @ W_h^T for this warp's UT units: each dz float4 serves
    // UT units.
    const float4* d4 = reinterpret_cast<const float4*>(dz);
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
        for (int ut = 0; ut < UT; ++ut) {
          acc[r][ut][0] = fmaf(v.x, w[ut].x, acc[r][ut][0]);
          acc[r][ut][0] = fmaf(v.y, w[ut].y, acc[r][ut][0]);
          acc[r][ut][0] = fmaf(v.z, w[ut].z, acc[r][ut][0]);
          acc[r][ut][0] = fmaf(v.w, w[ut].w, acc[r][ut][0]);
        }
      }
    }
    rnn::reduce_scatter<R, UT, 16, R, UT, 1>(acc, lane);
#pragma unroll
    for (int k = 0; k < NRo; ++k)
#pragma unroll
      for (int m = 0; m < NUo; ++m)  // dh_prev *= keep[t]
        dh_c[k][m] = kReset ? __fmul_rn(acc[k][m][0], keep_t[k][m]) : acc[k][m][0];
  }
  mma::cp_async_wait<0>();  // no copy outlives the block
  rnn::cluster::sync();
#pragma unroll
  for (int k = 0; k < NRo; ++k) {
    const int b = b0 + own.row0 + k;
#pragma unroll
    for (int m = 0; m < NUo; ++m) {
      if (own.owner && unit_ok[m] && b < B) {
        dh0[static_cast<size_t>(b) * H + unit[m]] = dh_c[k][m];
        dc0[static_cast<size_t>(b) * H + unit[m]] = dc_c[k][m];
      }
    }
  }
}

template <bool kReset>
int launch_cluster_bwd(int R, int clusters, int C, int threads, size_t smem, cudaStream_t st,
                       const float* const* planes, const float* g_ys, const float* w_h,
                       const float* keep, const float* dc_last, float* d_xp, float* dh0,
                       float* dc0, int B, int Tn, int H, int U) {
  auto go = [&](auto kernel) {
    return rnn::launch_clusters(kernel, clusters, C, threads, smem, st, planes[0], planes[1],
                                planes[2], planes[3], planes[4], planes[5], g_ys, w_h, keep,
                                dc_last, d_xp, dh0, dc0, B, Tn, H, U);
  };
  switch (R) {
    case 4: return go(lstm_backward_cluster_kernel<4, kReset>);
    case 8: return go(lstm_backward_cluster_kernel<8, kReset>);
    case 16: return go(lstm_backward_cluster_kernel<16, kReset>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: the input projection (rnn.cuh), then both recurrences on tensor cores
// ---------------------------------------------------------------------------

using rnn::kRows;  // batch rows a block: mma's N, one n8 tile
using rnn::kStages;
using rnn::load_frag;
using rnn::Positions;
using rnn::RowPiece;
using rnn::zero_smem;
constexpr int kGates = 4;  // i, f, g, o

// The reverse recurrence's shared memory (bytes): the dz^T buffer
// [hi, lo][4 Hp][8] bf16, the ring of gate-plane stages, then the partial
// sums two warps exchange, [Hp / 16 warps][32 lanes][4] f32.
struct BwdSmem {
  int part, sp, sg, ring, stage, xch, total;
  __host__ __device__ explicit BwdSmem(int Hp)
      : part(kGates * Hp * kRows), sp(Hp + 4), sg(Hp + 8), ring(2 * part * 2),
        stage(6 * kRows * sp * 4 + kRows * sg * 2), xch(ring + kStages * stage),
        total(xch + Hp / 16 * 32 * 16) {}
};

// The forward recurrence's shared memory (bytes): the h^T double buffer
// [2][Hp][8] bf16, then the ring of xp stages [8][4 Hp + 4] f32.
struct FwdSmem {
  int sx, ring, stage, total;
  __host__ __device__ explicit FwdSmem(int Hp)
      : sx(kGates * Hp + 4), ring(2 * Hp * kRows * 2), stage(kRows * sx * 4),
        total(ring + kStages * stage) {}
};

// The forward recurrence, transposed (z^T = W_h^T h^T): kMT = Hp / 16
// (warps, m16 tiles of units and k16 steps), with W_h^T's A fragments in
// registers; 0 for Hp > 128, where the count is `mt_rt` and the fragments
// are read from global memory every step. w_frag: [Hp/16 tiles][Hp/16
// k-steps][4 gates][32 lanes] x 16 bytes. kReset as the f32 kernel's.
template <int kMT, bool kReset>
__global__ void __launch_bounds__(kMT > 0 ? 32 * kMT : 32 * 16, 1)
lstm_forward_mma_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ h0,
                        const __nv_bfloat16* __restrict__ c0, const uint4* __restrict__ w_frag,
                        const float* __restrict__ keep, __nv_bfloat16* __restrict__ ys,
                        float* __restrict__ c_last, float* __restrict__ cs, int B, int Tn,
                        int H, int mt_rt) {
  constexpr bool kRegs = kMT > 0;
  constexpr int R = kRows;
  const int KS = kRegs ? kMT : mt_rt;
  const int Hp = 16 * KS, H4 = kGates * H;
  const FwdSmem L(Hp);
  extern __shared__ __align__(16) unsigned char smem[];
  // h^T, unit-major: [2][Hp][R] bf16 (a unit's 8 rows are 16 bytes).
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Positions pos(B, Tn, H);
  const int b0 = blockIdx.x * R;

  const uint4* wf = w_frag + static_cast<size_t>(warp) * KS * kGates * 32 + lane;
  uint32_t whf[kRegs ? kMT : 1][kGates][4];
  if (kRegs) {
#pragma unroll
    for (int st = 0; st < (kRegs ? kMT : 1); ++st)
#pragma unroll
      for (int q = 0; q < kGates; ++q) load_frag(whf[st][q], wf + (st * kGates + q) * 32);
  }

  // xp (the projection, b included) arrives in a ring of kStages
  // shared-memory stages, by cp.async, kStages - 1 steps ahead of its use:
  // [R][4 Hp + 4] f32 a stage, gate q at column q Hp (the pad keeps a lane's
  // reads free of bank conflicts). Rows past B and units past H are never
  // copied and stay zero. A thread copies at most one 16-byte piece of each
  // gate's 8 rows.
  zero_smem(smem + L.ring, L.total - L.ring);
  __syncthreads();
  const RowPiece piece(B, Tn, H);
  auto stage_step = [&](int t, int slot) {
    if (t < Tn && piece.has) {
      float* xs = reinterpret_cast<float*>(smem + L.ring + slot * L.stage);
      const size_t src = piece.src(t, H4);
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        mma::cp_async16_zfill(xs + piece.r * L.sx + q * Hp + 4 * piece.k, xp + src + q * H, 16);
      }
    }
    mma::cp_async_commit();  // an empty group past the last step keeps the count
  };
  stage_step(0, 0);
  stage_step(1, 1);

  // Step 0's state, keep[0] * (h0, c0): h rounded to bf16 into buffer 0
  // (every row and padded unit of it, zeros where there is none), c in f32
  // registers. A lane's two rows of one unit are adjacent: one 4-byte store.
  float cell[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      h[e] = cell[2 * m + e] = 0.0f;
      if (pos.ok(m, e)) {
        const size_t idx = static_cast<size_t>(b0 + 2 * pos.tq + e) * H + pos.unit(m);
        h[e] = __bfloat162float(h0[idx]);
        cell[2 * m + e] = __bfloat162float(c0[idx]);
        if (kReset) {
          const float k0 = keep[pos.row_base[e]];
          h[e] = __bfloat162float(__float2bfloat16(h[e] * k0));
          cell[2 * m + e] *= k0;
        }
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(hs + pos.unit(m) * R + 2 * pos.tq) =
        __floats2bfloat162_rn(h[0], h[1]);
  }
  // keep[t] for the lane's rows, 1 past the last step: step t scales what it
  // hands on by keep[t+1], loaded a step earlier.
  auto load_keep = [&](int t, float (&kv)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kv[e] = kReset && t < Tn && pos.row_ok[e] ? keep[pos.row_base[e] + t] : 1.0f;
    }
  };
  float kpre[2];
  load_keep(1, kpre);
  mma::cp_async_wait<1>();
  __syncthreads();

  // The lane's ldmatrix.trans row of the B fragment (h^T): unit lane % 16 of
  // the k-step (lanes 16-31 repeat 0-15; x2 reads only the first 16).
  const int b_off = (lane & 15) * R;
  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1;
    stage_step(t + 2, (t + 2) % kStages);
    const float kn[2] = {kpre[0], kpre[1]};
    load_keep(t + 2, kpre);

    // The B fragments are loaded a k-step ahead of their products.
    const __nv_bfloat16* hc = hs + cur * Hp * R;
    float acc[kGates][4];
#pragma unroll
    for (int q = 0; q < kGates; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    uint32_t bq[2][2];
    mma::ldmatrix_x2_trans(bq[0], hc + b_off);
#pragma unroll
    for (int st2 = 0; st2 < KS; st2 += 2) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int st = st2 + par;
        if (st < KS) {
          if (st + 1 < KS) mma::ldmatrix_x2_trans(bq[par ^ 1], hc + 16 * (st + 1) * R + b_off);
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            uint32_t a_mem[4];
            if (!kRegs) load_frag(a_mem, wf + (st * kGates + q) * 32);
            const uint32_t* a = kRegs ? whf[kRegs && st < kMT ? st : 0][q] : a_mem;
            mma::bf16_16x8x16(acc[q], a, bq[par][0], bq[par][1]);
          }
        }
      }
    }

    const float* xs = reinterpret_cast<const float*>(smem + L.ring + (t % kStages) * L.stage);
    __nv_bfloat16* hn = hs + (cur ^ 1) * Hp * R;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      __nv_bfloat16 hk[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 2 * m + e;
        const float* xr = xs + (2 * pos.tq + e) * L.sx + pos.unit(m);
        const float ig = rnn::fast_sigmoid(xr[0] + acc[0][p]);
        const float fg = rnn::fast_sigmoid(xr[Hp] + acc[1][p]);
        const float gg = rnn::fast_tanh(xr[2 * Hp] + acc[2][p]);
        const float og = rnn::fast_sigmoid(xr[3 * Hp] + acc[3][p]);
        const float c = fg * cell[p] + ig * gg;
        const __nv_bfloat16 hq = __float2bfloat16(og * rnn::fast_tanh(c));
        if (pos.ok(m, e)) {
          const size_t idx = pos.at(m, e, t, H);
          ys[idx] = hq;
          if (cs != nullptr) cs[idx] = c;
        }
        hk[e] = kReset ? __float2bfloat16(__bfloat162float(hq) * kn[e]) : hq;
        cell[p] = kReset ? c * kn[e] : c;
      }
      *reinterpret_cast<__nv_bfloat162*>(hn + pos.unit(m) * R + 2 * pos.tq) =
          __halves2bfloat162(hk[0], hk[1]);
    }
    mma::cp_async_wait<1>();  // step t+1's xp has landed (this thread's)
    __syncthreads();          // ... everyone's, and h' is whole
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (pos.ok(m, e)) {
        c_last[static_cast<size_t>(b0 + 2 * pos.tq + e) * H + pos.unit(m)] = cell[2 * m + e];
      }
}

template <bool kReset>
int launch_fwd_mma(const float* xp, const void* h0, const void* c0, const void* w_frag,
                   const float* keep, void* ys, float* c_last, float* cs, int B, int Tn,
                   int H, size_t smem, cudaStream_t s) {
  const int ks = (H + 15) / 16;
  const dim3 grid((B + kRows - 1) / kRows), block(32 * ks);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        xp, static_cast<const __nv_bfloat16*>(h0), static_cast<const __nv_bfloat16*>(c0),
        static_cast<const uint4*>(w_frag), keep, static_cast<__nv_bfloat16*>(ys), c_last, cs,
        B, Tn, H, ks);
    return static_cast<int>(cudaGetLastError());
  };
  // Fragments in registers up to Hp = 128, the generic instantiation above.
  switch (ks) {
    case 1: return launch(lstm_forward_mma_kernel<1, kReset>);
    case 2: return launch(lstm_forward_mma_kernel<2, kReset>);
    case 3: return launch(lstm_forward_mma_kernel<3, kReset>);
    case 4: return launch(lstm_forward_mma_kernel<4, kReset>);
    case 5: return launch(lstm_forward_mma_kernel<5, kReset>);
    case 6: return launch(lstm_forward_mma_kernel<6, kReset>);
    case 7: return launch(lstm_forward_mma_kernel<7, kReset>);
    case 8: return launch(lstm_forward_mma_kernel<8, kReset>);
    default: return launch(lstm_forward_mma_kernel<0, kReset>);
  }
}

// The reverse recurrence on tensor cores: dh_prev^T = W_h dz^T, K = 4 Hp
// (Hp = 32 ceil(H / 32) here: the warps pair up). kMT = Hp / 16 (warps, m16
// tiles of units), with W_h's A fragments in registers; 0 for Hp > 128
// (count `mt_rt`, fragments read from global memory every step). Each warp
// reads dz^T from shared memory for every product, so the warps split K:
// warp w = 2 j + h computes tiles 2 j and 2 j + 1 over half h of the k-steps
// (gates i, f or g, o), hands its partial sums of the pair's other tile to
// the other warp through shared memory, and owns tile w (its dz and carries).
// Each warp reads half of dz^T a step, and holds the same 128 fragment
// registers at H=128. w_frag: [Hp/16 warps][2 Hp/16 k-steps][2 tiles][32
// lanes] x 16 bytes. kReset as the f32 kernel's.
template <int kMT, bool kReset>
__global__ void __launch_bounds__(kMT > 0 ? 32 * kMT : 32 * 16, 1)
lstm_backward_mma_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                         const float* __restrict__ gg, const float* __restrict__ og,
                         const float* __restrict__ tcg, const float* __restrict__ cing,
                         const __nv_bfloat16* __restrict__ g_ys,
                         const uint4* __restrict__ w_frag, const float* __restrict__ keep,
                         const float* __restrict__ dc_last, float* __restrict__ d_xp,
                         float* __restrict__ dh0, float* __restrict__ dc0, int B, int Tn,
                         int H, int mt_rt) {
  constexpr bool kRegs = kMT > 0;
  constexpr int R = kRows;
  const int MT = kRegs ? kMT : mt_rt;
  const int Hp = 16 * MT, KH = kGates * MT / 2, H4 = kGates * H;
  const BwdSmem L(Hp);
  extern __shared__ __align__(16) unsigned char smem[];
  // dz^T, k-major (k = gate Hp + unit): [hi, lo][4 Hp][R] bf16. One buffer:
  // a step's second barrier (the exchange's) follows its last read.
  __nv_bfloat16* z = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Positions pos(B, Tn, H);
  const int b0 = blockIdx.x * R;

  const int half = warp & 1;  // this warp's half of K, and its tile of the pair
  const uint4* wf = w_frag + static_cast<size_t>(warp) * KH * 2 * 32 + lane;
  uint32_t wr[kRegs ? kGates * kMT / 2 : 1][2][4];
  if (kRegs) {
#pragma unroll
    for (int sl = 0; sl < (kRegs ? kGates * kMT / 2 : 1); ++sl)
#pragma unroll
      for (int i = 0; i < 2; ++i) load_frag(wr[sl][i], wf + (sl * 2 + i) * 32);
  }

  // The step's gate planes arrive in a ring of kStages shared-memory stages,
  // by cp.async, kStages - 1 steps ahead of their use: [6][R][Hp + 4] f32
  // and g_ys [R][Hp + 8] bf16 a stage (the pads keep a lane's reads free of
  // bank conflicts). Rows past B and units past H are never copied and stay
  // zero, so their dz is zero. A thread copies at most one 16-byte piece of
  // each plane row block (8 rows x H / 4 pieces <= 2 H threads).
  zero_smem(smem, L.total);
  __syncthreads();
  const float* const planes[6] = {ig, fg, gg, og, tcg, cing};
  const RowPiece piece(B, Tn, H);
  auto stage_step = [&](int t, int slot) {
    if (t >= 0 && piece.has) {
      float* ps = reinterpret_cast<float*>(smem + L.ring + slot * L.stage);
      const size_t src = piece.src(t, H);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        mma::cp_async16_zfill(ps + (j * R + piece.r) * L.sp + 4 * piece.k, planes[j] + src, 16);
      }
      __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(ps + 6 * R * L.sp);
      mma::cp_async8_zfill(gs + piece.r * L.sg + 4 * piece.k, g_ys + src, 8);
    }
    mma::cp_async_commit();  // an empty group past t = 0 keeps the count
  };
  stage_step(Tn - 1, 0);
  stage_step(Tn - 2, 1);

  // keep[t] (dh_prev, dc_prev *= keep[t]), loaded a step ahead.
  auto load_keep = [&](int t, float (&kv)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) kv[e] = kReset && pos.row_ok[e] ? keep[pos.row_base[e] + t] : 1.0f;
  };
  float nk[2];
  load_keep(Tn - 1, nk);
  float dh_c[4], dc_c[4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dh_c[2 * m + e] = 0.0f;
      dc_c[2 * m + e] =
          pos.ok(m, e) ? dc_last[static_cast<size_t>(b0 + 2 * pos.tq + e) * H + pos.unit(m)]
                       : 0.0f;
    }
  mma::cp_async_wait<1>();
  __syncthreads();

  // The lane's ldmatrix.trans row: lanes 0-15 address hi's k rows 0-15 of a
  // k-step, lanes 16-31 lo's, so one x4 brings both B fragments.
  const int b_off = (lane & 15) * R + (lane >> 4) * L.part;
  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    stage_step(t - 2, (s + 2) % kStages);
    const float ck[2] = {nk[0], nk[1]};
    if (t > 0) load_keep(t - 1, nk);
    const float* ps = reinterpret_cast<const float*>(smem + L.ring + (s % kStages) * L.stage);
    const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(ps + 6 * R * L.sp);

#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float dz[kGates][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 2 * m + e;
        const int at = (2 * pos.tq + e) * L.sp + pos.unit(m);
        const float iv = ps[at], fv = ps[R * L.sp + at], gv = ps[2 * R * L.sp + at];
        const float ov = ps[3 * R * L.sp + at], tc = ps[4 * R * L.sp + at];
        const float cin = ps[5 * R * L.sp + at];
        const float dh = dh_c[p] + __bfloat162float(gs[(2 * pos.tq + e) * L.sg + pos.unit(m)]);
        const float dc = dc_c[p] + dh * ov * (1.0f - tc * tc);
        dz[0][e] = dc * gv * iv * (1.0f - iv);
        dz[1][e] = dc * cin * fv * (1.0f - fv);
        dz[2][e] = dc * iv * (1.0f - gv * gv);
        dz[3][e] = dh * tc * ov * (1.0f - ov);
        if (pos.ok(m, e)) {
          float* out = d_xp + (pos.row_base[e] + t) * H4 + pos.unit(m);
#pragma unroll
          for (int q = 0; q < kGates; ++q) out[q * H] = dz[q][e];
        }
        dc_c[p] = dc * fv;
        if (kReset) dc_c[p] *= ck[e];  // dc_prev *= keep[t]
      }
      // dz split for the product: hi = bf16(dz), lo = bf16(dz - hi).
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(dz[q][0], dz[q][1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(dz[q][0] - __low2float(hi),
                                                       dz[q][1] - __high2float(hi));
        __nv_bfloat16* row = z + (q * Hp + pos.unit(m)) * R + 2 * pos.tq;
        *reinterpret_cast<__nv_bfloat162*>(row) = hi;
        *reinterpret_cast<__nv_bfloat162*>(row + L.part) = lo;
      }
    }
    mma::cp_async_wait<1>();  // step t-1's planes have landed (this thread's)
    __syncthreads();          // ... everyone's, and dz^T is whole

    // Four independent chains, tile x (hi, lo), over this warp's half of
    // K (KH k-steps, an even count); the B fragments are loaded a k-step
    // ahead of their products.
    float acc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.0f;
    const __nv_bfloat16* zk = z + 16 * half * KH * R + b_off;
    uint32_t bq[2][4];
    mma::ldmatrix_x4_trans(bq[0], zk);
#pragma unroll
    for (int sl2 = 0; sl2 < KH; sl2 += 2) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int sl = sl2 + par;
        if (sl + 1 < KH) mma::ldmatrix_x4_trans(bq[par ^ 1], zk + 16 * (sl + 1) * R);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t a_mem[4];
          if (!kRegs) load_frag(a_mem, wf + (sl * 2 + i) * 32);
          const uint32_t* a = kRegs ? wr[kRegs ? sl : 0][i] : a_mem;
          mma::bf16_16x8x16(acc[i][0], a, bq[par][0], bq[par][1]);
          mma::bf16_16x8x16(acc[i][1], a, bq[par][2], bq[par][3]);
        }
      }
    }
    // The pair's other tile goes to the other warp; this warp's tile comes
    // back from it: dh = (own hi + lo) + (its hi + lo).
    float own[4], give[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float s0 = acc[0][0][p] + acc[0][1][p], s1 = acc[1][0][p] + acc[1][1][p];
      own[p] = half ? s1 : s0;
      give[p] = half ? s0 : s1;
    }
    float4* xch = reinterpret_cast<float4*>(smem + L.xch);
    xch[(warp ^ 1) * 32 + lane] = make_float4(give[0], give[1], give[2], give[3]);
    __syncthreads();
    const float4 got = xch[warp * 32 + lane];
    const float theirs[4] = {got.x, got.y, got.z, got.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      dh_c[p] = own[p] + theirs[p];
      if (kReset) dh_c[p] *= ck[p & 1];  // dh_prev *= keep[t]
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (pos.ok(m, e)) {
        const size_t idx = static_cast<size_t>(b0 + 2 * pos.tq + e) * H + pos.unit(m);
        dh0[idx] = dh_c[2 * m + e];
        dc0[idx] = dc_c[2 * m + e];
      }
}

template <bool kReset>
int launch_bwd_mma(const float* const* planes, const void* g_ys, const void* w_frag,
                   const float* keep, const float* dc_last, float* d_xp, float* dh0,
                   float* dc0, int B, int Tn, int H, size_t smem, cudaStream_t s) {
  const int ks = 2 * ((H + 31) / 32);
  const dim3 grid((B + kRows - 1) / kRows), block(32 * ks);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, s>>>(
        planes[0], planes[1], planes[2], planes[3], planes[4], planes[5],
        static_cast<const __nv_bfloat16*>(g_ys), static_cast<const uint4*>(w_frag), keep,
        dc_last, d_xp, dh0, dc0, B, Tn, H, ks);
    return static_cast<int>(cudaGetLastError());
  };
  switch (ks) {
    case 2: return launch(lstm_backward_mma_kernel<2, kReset>);
    case 4: return launch(lstm_backward_mma_kernel<4, kReset>);
    case 6: return launch(lstm_backward_mma_kernel<6, kReset>);
    case 8: return launch(lstm_backward_mma_kernel<8, kReset>);
    default: return launch(lstm_backward_mma_kernel<0, kReset>);
  }
}


// ---------------------------------------------------------------------------
// Above H = 256: both recurrences on rnn.cuh's grid-persistent layout
// ---------------------------------------------------------------------------
//
// At H = 512 W_h is 2 MB of bf16 (4 MB in f32), at H = 1,000 8 MB: no
// cluster of CTAs holds it. rnn.cuh's grid layout, as gru.cu's: one
// cooperative launch of unit slices x row groups, CTA (tile, group) keeping
// W_h's values of its units, all four gates (i|f|g|o blocks), in its shared
// memory (128 Kp bytes: 64 KB at H = 512), the step's vector through L2 in
// a zeroed workspace, one grid barrier a step. Its limits (ops/cuda/lstm.py
// grid_max_hidden): in bf16 a CTA's 128 Kp bytes bind at H = 1,792; in f32
// the 132 SMs bind (132 slices of 8 units: H = 1,056).
//
// Forward, both dtypes: every CTA reads its rows of the whole h_in(t) from
// buffer t & 1, forms its units' four gate sums, c' and h', writes ys (and
// the f32 cell plane when the caller keeps it for the backward), and hands
// keep[t+1] h' (rounded to the working dtype) to buffer (t+1) & 1; then the
// barrier. The products are laid out so that the i, f, g and o sums of a
// (unit, row) pair land in one lane (bf16: a warp 16 rows x the CTA's 16
// units on mma.sync, four accumulators of one C position, W_h^T's A
// fragments gate by gate; f32: rnn.cuh's grid_f32_product, a CTA GEMM of
// its rows x 8 units x 4 gates with h's rows through a ring in shared
// memory, read from L2 once a CTA a step, and the slices' partial sums
// added in order by the thread that owns the pair in every step), so c'
// needs no exchange: the owner reads c from, and writes c' (times
// keep[t+1]) to, the workspace's [rows][Kp] f32 cell plane, which no other
// thread and no other CTA touches (f32: it reads c, xp and keep[t+1] before
// the barrier that precedes the step). c stays in f32 and is never rounded; c_T takes the
// unscaled c'. bf16 gate math from the hardware exp2 and a fast divide (as
// the one-block kernel); f32 accurate sigmoid and tanh (as the cluster
// kernel).
//
// Reverse, both dtypes (the K split of gru.cu's grid reverse, four gates): a
// step is two phases with the barrier between. Phase A: the owner lane of
// each (unit, row) pair adds g_y to its dh carry, forms dc, the four dz
// values and dc f (times keep[t]) from the step's gate planes, writes d_xp,
// and publishes its units' dz columns to the step's buffer (bf16: two bf16
// terms, hi = bf16(dz) and lo = bf16(dz - hi), the f32 cotangent's contract;
// f32: as it is). Phase B: each CTA forms dh_prev = dz W_h^T for its units
// from its rows of the whole dz in a fixed order (bf16: units as M, K = the
// 4 Kp gate columns, the hi and lo products sharing the A fragments; f32:
// a warp's lanes each over a slice of K, 8 units a task, and rnn.cuh's
// reduce-scatter), times
// keep[t]. dh and dc are carried per pair in f32 planes of the workspace
// (dc starts at the cotangent of c_T), each read and written only by the
// lane that owns the pair in both phases, so the bits repeat from run to
// run. dh0 and dc0 are the carries after t = 0.
//
// What bounds them: the serial chain, one grid barrier and one CTA's share
// of the step's products a step (bf16 at the wide LSTM, B = 256, H = 512:
// 128 CTAs of 64 rows, 1,024 mma.sync a CTA a step forward; f32 128 CTAs of
// 128 rows, 2.10 M FMAs a CTA a step, 8.3 us at 128 FMAs a clock and 1.98
// GHz, and 256 KB of h from L2: gru.cu's note says what the f32 forward's
// step product does about them).

using rnn::grid_kpad;
using rnn::grid_load_weights;
using rnn::grid_rows;
using rnn::grid_sync;
using rnn::GridPlace;
using rnn::kGridCounter;
using rnn::kGridThreads;
// Workspace bytes a (row, k) of the [rows][Kp] plane: the forward's h
// buffers [2][rows][Kp] of the dtype and the cell plane [rows][Kp] f32; the
// reverse's dz buffers ([2][hi, lo][rows][4 Kp] bf16 or [2][rows][4 Kp]
// f32: 32 bytes either way), then the dh and dc carries [2][rows][Kp] f32.
__host__ inline size_t grid_workspace(int B, int H, bool bf16, bool reverse) {
  return rnn::grid_workspace(B, H, bf16, reverse ? 40 : 2 * (bf16 ? 2 : 4) + 4);
}

// bf16 forward. w_frag: W_h^T's A fragments [tiles][Kp/16 k-steps][4 gates]
// [32 lanes] x 16 bytes in the permuted K order (ops/cuda/gru.py grid_pack);
// ws: the counter, h_in's buffers [2][rows][Kp] bf16, the cells [rows][Kp] f32.
template <bool kReset>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_forward_grid_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ h0,
                         const __nv_bfloat16* __restrict__ c0, const uint4* __restrict__ w_frag,
                         const float* __restrict__ keep, __nv_bfloat16* __restrict__ ys,
                         float* __restrict__ c_last, float* __restrict__ cs,
                         unsigned char* __restrict__ ws, int B, int Tn, int H, int groups) {
  extern __shared__ __align__(16) uint4 wsm[];
  const int Kp = grid_kpad(H, true), KS = Kp / 16, H4 = kGates * H;
  const int tiles = (H + 15) / 16, pairs = grid_rows(B, true) / 16;
  const GridPlace at(tiles, pairs, groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  const size_t plane = static_cast<size_t>(pairs) * 16 * Kp;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(ws + kGridCounter);
  float* cells = reinterpret_cast<float*>(hbuf + 2 * plane);
  const unsigned G = gridDim.x;

  // Step 0's state of the CTA's units and rows: keep[0] h0 rounded to bf16
  // into buffer 0, keep[0] c0 into the cell plane.
  for (int c = threadIdx.x; c < (at.r1 - at.r0) * 256; c += kGridThreads) {
    const int row = 16 * at.r0 + c / 16, unit = 16 * at.tile + c % 16;
    if (row < B && unit < H) {
      const size_t i = static_cast<size_t>(row) * H + unit;
      float h = __bfloat162float(h0[i]), cv = __bfloat162float(c0[i]);
      if (kReset) {
        const float k0 = keep[static_cast<size_t>(row) * Tn];
        h *= k0;
        cv *= k0;
      }
      hbuf[static_cast<size_t>(row) * Kp + unit] = __float2bfloat16(h);
      cells[static_cast<size_t>(row) * Kp + unit] = cv;
    }
  }
  grid_load_weights(wsm, w_frag + static_cast<size_t>(at.tile) * KS * kGates * 32,
                    KS * kGates * 32);
  grid_sync(bar, G);

  for (int t = 0; t < Tn; ++t) {
    const __nv_bfloat16* hc = hbuf + (t & 1) * plane;
    __nv_bfloat16* hn = hbuf + ((t + 1) & 1) * plane;
    for (int p = at.r0 + warp; p < at.r1; p += kGridThreads / 32) {
      // The lane's C positions: unit 16 tile + gr + 8 (i >> 1), row
      // 16 p + 8 nt + 2 tq + (i & 1); their xp before the products.
      float xv[2][4][kGates];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), unit = 16 * at.tile + gr + 8 * (i >> 1);
          const bool ok = row < B && unit < H;
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            xv[nt][i][q] = ok ? xp[(static_cast<size_t>(row) * Tn + t) * H4 + q * H + unit] : 0.0f;
          }
        }
      float acc[2][kGates][4] = {};
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
          for (int q = 0; q < kGates; ++q) {
            uint32_t a[4];
            load_frag(a, wsm + ((2 * c + kk) * kGates + q) * 32 + lane);
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
          const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), unit = 16 * at.tile + gr + 8 * (i >> 1);
          if (row >= B || unit >= H) continue;
          const size_t bt = static_cast<size_t>(row) * Tn + t;
          float* cell = cells + static_cast<size_t>(row) * Kp + unit;
          const float ig = rnn::fast_sigmoid(xv[nt][i][0] + acc[nt][0][i]);
          const float fg = rnn::fast_sigmoid(xv[nt][i][1] + acc[nt][1][i]);
          const float gg = rnn::fast_tanh(xv[nt][i][2] + acc[nt][2][i]);
          const float og = rnn::fast_sigmoid(xv[nt][i][3] + acc[nt][3][i]);
          const float c = fg * *cell + ig * gg;
          const __nv_bfloat16 hq = __float2bfloat16(og * rnn::fast_tanh(c));
          ys[bt * H + unit] = hq;
          if (cs != nullptr) cs[bt * H + unit] = c;
          if (t + 1 < Tn) {  // keep[t+1] scales the h' and c' this step hands to the next one
            const float kn = kReset ? keep[bt + 1] : 1.0f;
            hn[static_cast<size_t>(row) * Kp + unit] =
                kReset ? __float2bfloat16(__bfloat162float(hq) * kn) : hq;
            *cell = kReset ? c * kn : c;
          } else {
            c_last[static_cast<size_t>(row) * H + unit] = c;
          }
        }
    }
    if (t + 1 < Tn) grid_sync(bar, G * (t + 2));
  }
}

// f32 forward. w4: W_h's values of each slice's 8 units, [tiles][Kp/4][4
// gates][8 units] float4 of k = 4 kk .. + 3 (ops/cuda/gru.py grid_pack); ws:
// the counters (a row group's at kGfCounterStride group), h_in's buffers
// [2][rows][Kp] f32, the cells [rows][Kp] f32.
// Shared memory: W_h's values, then rnn::grid_f32_product's ring
// (GridF32Plan). A thread owns unit threadIdx.x % 8 of block rows
// threadIdx.x / 8 + 32 i in every step (and writes h_in(0) and c(0) of
// them), so its own h_in and c entries, xp and keep[t+1] are read before
// the barrier that precedes the step.
template <bool kReset, int kBlock>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_forward_grid_f32_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                             const float* __restrict__ c0, const float4* __restrict__ w4,
                             const float* __restrict__ keep, float* __restrict__ ys,
                             float* __restrict__ c_last, float* __restrict__ cs,
                             unsigned char* __restrict__ ws, int B, int Tn, int H, int groups) {
  extern __shared__ __align__(16) float4 wsm4[];
  constexpr int G = kGates, kSlots = rnn::GfShape<kBlock>::slots;
  const int Kp = grid_kpad(H, false), H4 = G * H;
  const int tiles = (H + 7) / 8, quads = grid_rows(B, false) / 4;
  const GridPlace at(tiles, quads, groups);
  const rnn::GridF32Plan plan(4 * ((quads + groups - 1) / groups), Kp, G);
  float* ring = reinterpret_cast<float*>(wsm4 + 2 * G * Kp);
  unsigned* bar = reinterpret_cast<unsigned*>(ws + rnn::kGfCounterStride * at.group);
  float* hbuf = reinterpret_cast<float*>(ws + kGridCounter);
  const size_t plane = static_cast<size_t>(quads) * 4 * Kp;
  float* cells = hbuf + 2 * plane;
  const unsigned NG = tiles;  // the row group's CTAs
  const int row_lo = 4 * at.r0, row_hi = 4 * at.r1;
  const int u = threadIdx.x & 7, unit = 8 * at.tile + u, rt = threadIdx.x >> 3;

  for (int row = row_lo + rt; row < row_hi; row += kGridThreads / 8) {
    if (row < B && unit < H) {
      const size_t i = static_cast<size_t>(row) * H + unit;
      const float k0 = kReset ? keep[static_cast<size_t>(row) * Tn] : 1.0f;
      hbuf[static_cast<size_t>(row) * Kp + unit] = kReset ? __fmul_rn(h0[i], k0) : h0[i];
      cells[static_cast<size_t>(row) * Kp + unit] = kReset ? __fmul_rn(c0[i], k0) : c0[i];
    }
  }
  grid_load_weights(reinterpret_cast<uint4*>(wsm4),
                    reinterpret_cast<const uint4*>(w4) + static_cast<size_t>(at.tile) * 2 * G * Kp,
                    2 * G * Kp);

  // The pairs' operands of block b at step t: xp, c and keep[t+1].
  float xv[kSlots][G], cin[kSlots], kn[kSlots];
  auto operands = [&](int t, int b) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int row = row_lo + b * kBlock + rt + 32 * i;
      const bool ok = row < row_hi && row < B && unit < H;
      const size_t bt = static_cast<size_t>(row) * Tn + t;
#pragma unroll
      for (int q = 0; q < G; ++q) xv[i][q] = ok ? xp[bt * H4 + q * H + unit] : 0.0f;
      cin[i] = ok ? cells[static_cast<size_t>(row) * Kp + unit] : 0.0f;
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
        const float ig = sigmoidf(xv[i][0] + rnn::grid_f32_sum<G, kBlock>(ring, r, 0, u));
        const float fg = sigmoidf(xv[i][1] + rnn::grid_f32_sum<G, kBlock>(ring, r, 1, u));
        const float gg = tanhf(xv[i][2] + rnn::grid_f32_sum<G, kBlock>(ring, r, 2, u));
        const float og = sigmoidf(xv[i][3] + rnn::grid_f32_sum<G, kBlock>(ring, r, 3, u));
        // Every rounding spelled out: the three instantiations (blocks of 32,
        // 64, 128 rows) must give a row the same bits, and nvcc may contract
        // a product and a sum into an FMA either way in each.
        const float c = __fadd_rn(__fmul_rn(fg, cin[i]), __fmul_rn(ig, gg));
        const float h = og * tanhf(c);
        ys[bt * H + unit] = h;
        if (cs != nullptr) cs[bt * H + unit] = c;
        if (t + 1 < Tn) {
          const size_t at_k = static_cast<size_t>(row) * Kp + unit;
          hn[at_k] = kReset ? __fmul_rn(h, kn[i]) : h;
          cells[at_k] = kReset ? __fmul_rn(c, kn[i]) : c;
        } else {
          c_last[static_cast<size_t>(row) * H + unit] = c;
        }
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

// bf16 reverse. w_frag: W_h's A fragments [tiles][4 Kp/16 k-steps][32 lanes]
// x 16 bytes, A[unit][q Kp + j] = W_h[unit][q H + j] (zero past H) in the
// permuted K order; ws: the counter, dz's buffers [2][hi, lo][rows][4 Kp]
// bf16, then the dh and dc carries [rows][Kp] f32 each.
template <bool kReset>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_backward_grid_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                          const float* __restrict__ gg, const float* __restrict__ og,
                          const float* __restrict__ tcg, const float* __restrict__ cing,
                          const __nv_bfloat16* __restrict__ g_ys,
                          const uint4* __restrict__ w_frag, const float* __restrict__ keep,
                          const float* __restrict__ dc_last, float* __restrict__ d_xp,
                          float* __restrict__ dh0, float* __restrict__ dc0,
                          unsigned char* __restrict__ ws, int B, int Tn, int H, int groups) {
  extern __shared__ __align__(16) uint4 wsm[];
  const int Kp = grid_kpad(H, true), Kc = kGates * Kp, H4 = kGates * H;
  const int tiles = (H + 15) / 16, rows = grid_rows(B, true), pairs = rows / 16;
  const GridPlace at(tiles, pairs, groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  const size_t term = static_cast<size_t>(rows) * Kc;
  __nv_bfloat16* dbuf = reinterpret_cast<__nv_bfloat16*>(ws + kGridCounter);
  float* dh_c = reinterpret_cast<float*>(dbuf + 4 * term);
  float* dc_c = dh_c + static_cast<size_t>(rows) * Kp;
  const unsigned G = gridDim.x;
  grid_load_weights(wsm, w_frag + static_cast<size_t>(at.tile) * (Kc / 16) * 32, (Kc / 16) * 32);
  // The dc carries of the lane's pairs start at the cotangent of c_T (dh's
  // at 0: the zeroed workspace); the lane that writes one is the one that
  // reads it.
  for (int p = at.r0 + warp; p < at.r1; p += kGridThreads / 32)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * p + 8 * nt + 2 * tq + (i & 1), unit = 16 * at.tile + gr + 8 * (i >> 1);
        if (row < B && unit < H) {
          dc_c[static_cast<size_t>(row) * Kp + unit] = dc_last[static_cast<size_t>(row) * H + unit];
        }
      }

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
          const size_t bt = static_cast<size_t>(row) * Tn + t, e = bt * H + unit;
          const float iv = ig[e], fv = fg[e], gv = gg[e], ov = og[e], tc = tcg[e], cin = cing[e];
          const size_t own = static_cast<size_t>(row) * Kp + unit;
          const float dh = dh_c[own] + __bfloat162float(g_ys[e]);
          const float dc = dc_c[own] + dh * ov * (1.0f - tc * tc);
          const float d[kGates] = {dc * gv * iv * (1.0f - iv), dc * cin * fv * (1.0f - fv),
                                   dc * iv * (1.0f - gv * gv), dh * tc * ov * (1.0f - ov)};
          float* out = d_xp + bt * H4 + unit;
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            out[q * H] = d[q];
            const __nv_bfloat16 hi = __float2bfloat16(d[q]);
            const size_t at_q = static_cast<size_t>(row) * Kc + q * Kp + unit;
            db[at_q] = hi;
            db[term + at_q] = __float2bfloat16(d[q] - __bfloat162float(hi));
          }
          float dcn = dc * fv;
          if (kReset) dcn *= keep[bt];  // dc_prev *= keep[t]
          dc_c[own] = dcn;
          if (t == 0) dc0[static_cast<size_t>(row) * H + unit] = dcn;
        }
    }
    grid_sync(bar, G * (s + 1));
    // Phase B: dh_prev^T = W_h dz^T for the CTA's units.
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
          float dh = acc[nt][0][i] + acc[nt][1][i];
          if (kReset) dh *= keep[static_cast<size_t>(row) * Tn + t];  // dh_prev *= keep[t]
          dh_c[static_cast<size_t>(row) * Kp + unit] = dh;
          if (t == 0) dh0[static_cast<size_t>(row) * H + unit] = dh;
        }
    }
  }
}

// f32 reverse. w4: W_h's rows of each slice's 8 units over the 4 Kp gate
// columns (column q Kp + j is W_h's q H + j, zero past H), [tiles][4 Kp/128]
// [8 units][32 lanes] float4; ws: the counter, dz's buffers [2][rows][4 Kp]
// f32, then the dh and dc carries [rows][Kp] f32 each.
template <bool kReset>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_backward_grid_f32_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                              const float* __restrict__ gg, const float* __restrict__ og,
                              const float* __restrict__ tcg, const float* __restrict__ cing,
                              const float* __restrict__ g_ys, const float4* __restrict__ w4,
                              const float* __restrict__ keep, const float* __restrict__ dc_last,
                              float* __restrict__ d_xp, float* __restrict__ dh0,
                              float* __restrict__ dc0, unsigned char* __restrict__ ws, int B,
                              int Tn, int H, int groups) {
  extern __shared__ __align__(16) float4 wsm4[];
  const int Kp = grid_kpad(H, false), Kc = kGates * Kp, J = Kc / 128, H4 = kGates * H;
  const int tiles = (H + 7) / 8, rows = grid_rows(B, false), quads = rows / 4;
  const GridPlace at(tiles, quads, groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  const size_t plane = static_cast<size_t>(rows) * Kc;
  float* dbuf = reinterpret_cast<float*>(ws + kGridCounter);
  float* dh_c = dbuf + 2 * plane;
  float* dc_c = dh_c + static_cast<size_t>(rows) * Kp;
  const unsigned G = gridDim.x;
  grid_load_weights(reinterpret_cast<uint4*>(wsm4),
                    reinterpret_cast<const uint4*>(w4) + static_cast<size_t>(at.tile) * J * 8 * 32,
                    J * 8 * 32);
  // A task: a quad of rows x the slice's 8 units; after the reduce-scatter
  // lane owns row lane >> 3 of unit lane & 7, in both phases.
  using Own = rnn::Owner<4, 8, 32>;
  const Own own(lane);
  const int unit = 8 * at.tile + own.ut0;
  for (int rq = at.r0 + warp; rq < at.r1; rq += kGridThreads / 32) {
    const int row = 4 * rq + own.row0;
    if (row < B && unit < H) {
      dc_c[static_cast<size_t>(row) * Kp + unit] = dc_last[static_cast<size_t>(row) * H + unit];
    }
  }

  for (int t = Tn - 1, s = 0; t >= 0; --t, ++s) {
    float* db = dbuf + (s & 1) * plane;
    for (int rq = at.r0 + warp; rq < at.r1; rq += kGridThreads / 32) {
      const int row = 4 * rq + own.row0;
      if (row >= B || unit >= H) continue;
      const size_t bt = static_cast<size_t>(row) * Tn + t, e = bt * H + unit;
      const float iv = ig[e], fv = fg[e], gv = gg[e], ov = og[e], tc = tcg[e], cin = cing[e];
      const size_t own_at = static_cast<size_t>(row) * Kp + unit;
      const float dh = dh_c[own_at] + g_ys[e];
      const float dc = dc_c[own_at] + dh * ov * (1.0f - tc * tc);
      const float d[kGates] = {dc * gv * iv * (1.0f - iv), dc * cin * fv * (1.0f - fv),
                               dc * iv * (1.0f - gv * gv), dh * tc * ov * (1.0f - ov)};
      float* out = d_xp + bt * H4 + unit;
      float* dr = db + static_cast<size_t>(row) * Kc + unit;
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        out[q * H] = d[q];
        dr[q * Kp] = d[q];
      }
      float dcn = __fmul_rn(dc, fv);
      if (kReset) dcn = __fmul_rn(dcn, keep[bt]);  // dc_prev *= keep[t]
      dc_c[own_at] = dcn;
      if (t == 0) dc0[static_cast<size_t>(row) * H + unit] = dcn;
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
      const float dh = kReset ? __fmul_rn(acc[0][0][0], keep[static_cast<size_t>(row) * Tn + t])
                              : acc[0][0][0];  // dh_prev *= keep[t]
      dh_c[static_cast<size_t>(row) * Kp + unit] = dh;
      if (t == 0) dh0[static_cast<size_t>(row) * H + unit] = dh;
    }
  }
}

// ---------------------------------------------------------------------------
// Past grid_max_hidden, both dtypes: the stepped layout (rnn.cuh)
// ---------------------------------------------------------------------------

// Forward step t of the LSTM: c = keep[t] c (the reset variant) from the
// f32 carry, the gates from xp[:, t] and the step's hp = h_in @ W_h (the
// GEMM just before: its `splits` partial planes [splits][B][4H] summed in
// split order), c' into the carry (and the cell plane), h' rounded to
// T into ys[:, t], and into hbuf the next step's h_in (keep[t+1] h' in the
// reset variant). Each thread reads its own elements before it writes them.
template <typename T, bool kReset>
__global__ void __launch_bounds__(rnn::kStepThreads)
lstm_step_kernel(const float* __restrict__ xp, const float* __restrict__ hp, int splits,
                 T* __restrict__ hbuf, float* __restrict__ c_buf, const float* __restrict__ keep,
                 T* __restrict__ ys, float* __restrict__ cs, int B, int Tn, int H, int t) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * H) return;
  const int row = static_cast<int>(i / H), unit = static_cast<int>(i % H);
  const size_t bt = static_cast<size_t>(row) * Tn + t;
  const float* x = xp + bt * 4 * H + unit;
  const size_t plane = static_cast<size_t>(B) * 4 * H, o = static_cast<size_t>(row) * 4 * H + unit;
  float hq[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) hq[g] = rnn::step_product(hp, splits, plane, o + g * H);
  float c = c_buf[i];
  if (kReset) c *= keep[bt];
  const float ig = rnn::step_sigmoid<T>(x[0] + hq[0]);
  const float fg = rnn::step_sigmoid<T>(x[H] + hq[1]);
  const float gg = rnn::step_tanh<T>(x[2 * H] + hq[2]);
  const float og = rnn::step_sigmoid<T>(x[3 * H] + hq[3]);
  c = fg * c + ig * gg;
  c_buf[i] = c;
  if (cs != nullptr) cs[bt * H + unit] = c;
  const T h = rnn::step_round<T>(og * rnn::step_tanh<T>(c));
  ys[bt * H + unit] = h;
  if (kReset && t + 1 < Tn) {
    hbuf[i] = rnn::step_round<T>(rnn::step_load(h) * keep[bt + 1]);
  } else {
    hbuf[i] = h;
  }
}

// Reverse step t of the LSTM (t = T-1 .. 0), as reference.lstm_bwd_scan:
// the carries from step t+1 (dh = p, its dz @ W_h^T, the GEMM just before,
// its `splits` partial planes [splits][B][H] summed in split order; dc =
// dc_buf), times keep[t+1]; at t = T-1 dh = 0 and dc = dc_last. Then
// dz[:, t], the GEMM's A (dz, bf16 as hi and lo terms with W's dtype bf16)
// and dc_buf = dc f. At t = -1 only dh0 and dc0, the carries into step 0.
template <typename W, bool kKeep>
__global__ void __launch_bounds__(rnn::kStepThreads)
lstm_step_backward_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                          const float* __restrict__ gg, const float* __restrict__ og,
                          const float* __restrict__ tanh_c, const float* __restrict__ c_in,
                          const W* __restrict__ g_ys, const float* __restrict__ keep,
                          const float* __restrict__ dc_last, const float* __restrict__ p,
                          int splits, float* __restrict__ dc_buf, W* __restrict__ a,
                          float* __restrict__ dz, float* __restrict__ dh0, float* __restrict__ dc0,
                          int B, int Tn, int H, int t) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * H) return;
  const int row = static_cast<int>(i / H), unit = static_cast<int>(i % H);
  float dh_next = 0.0f, dc_next = dc_last[i];
  if (t < Tn - 1) {
    dh_next = rnn::step_product(p, splits, static_cast<size_t>(B) * H, i);
    dc_next = dc_buf[i];
    if (kKeep) {
      const float k = keep[static_cast<size_t>(row) * Tn + t + 1];
      dh_next *= k;
      dc_next *= k;
    }
  }
  if (t < 0) {
    dh0[i] = dh_next;
    dc0[i] = dc_next;
    return;
  }
  const size_t o = (static_cast<size_t>(row) * Tn + t) * H + unit;
  const float i_t = ig[o], f_t = fg[o], g_t = gg[o], o_t = og[o], tc = tanh_c[o];
  const float dh = dh_next + rnn::step_load(g_ys[o]);
  const float dc = dc_next + dh * o_t * (1.0f - tc * tc);
  const float d[4] = {dc * g_t * i_t * (1.0f - i_t), dc * c_in[o] * f_t * (1.0f - f_t),
                      dc * i_t * (1.0f - g_t * g_t), dh * tc * o_t * (1.0f - o_t)};
  float* out = dz + (static_cast<size_t>(row) * Tn + t) * 4 * H + unit;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[q * H] = d[q];
    rnn::step_store_d(a, row, 4 * H, q * H + unit, d[q]);
  }
  dc_buf[i] = dc * f_t;
}

// The forward scan: T x (the step's GEMM, then its gates).
template <typename T, bool kReset>
int stepped_forward(const float* xp, T* hbuf, float* c_buf, const T* w_h, const float* keep,
                    T* ys, float* cs, float* hp, const rnn::StepPlan& plan, int B, int Tn, int H,
                    cudaStream_t s) {
  rnn::StepMaps maps;
  const int mrc = rnn::step_maps(plan, hbuf, w_h, B, H, 4 * H, 1, &maps);
  if (mrc != 0) return mrc;
  for (int t = 0; t < Tn; ++t) {
    int rc = rnn::step_gemm(plan, maps, hbuf, w_h, hp, B, H, 4 * H, 1, s);
    if (rc == 0) rc = rnn::launch_step(lstm_step_kernel<T, kReset>, B, H, s, xp, hp,
                                       plan.splits(), hbuf, c_buf, keep, ys, cs, B, Tn, H, t);
    if (rc != 0) return rc;
  }
  return 0;
}

// The reverse recurrence: T x (the step's gates, then its GEMM), then dh0, dc0.
// w: bf16 W_h [H, 4H] as stored (the GEMM's [N][K]), f32 W_h^T [4H, H].
template <typename W, bool kKeep>
int stepped_backward(const float* const* planes, const W* g_ys, const W* w, const float* keep,
                     const float* dc_last, float* dz, float* dh0, float* dc0, W* a, float* p,
                     float* dc_buf, const rnn::StepPlan& plan, int B, int Tn, int H,
                     cudaStream_t s) {
  constexpr int kTerms = sizeof(W) == 2 ? 2 : 1;
  auto gates = lstm_step_backward_kernel<W, kKeep>;
  rnn::StepMaps maps;
  const int mrc = rnn::step_maps(plan, a, w, B, 4 * H, H, kTerms, &maps);
  if (mrc != 0) return mrc;
  for (int t = Tn - 1; t >= -1; --t) {
    int rc = rnn::launch_step(gates, B, H, s, planes[0], planes[1], planes[2], planes[3],
                              planes[4], planes[5], g_ys, keep, dc_last, p, plan.splits(), dc_buf,
                              a, dz, dh0, dc0, B, Tn, H, t);
    if (rc == 0 && t >= 0) rc = rnn::step_gemm(plan, maps, a, w, p, B, 4 * H, H, kTerms, s);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// The f32 input projection on the CUDA cores (rnn::launch_xproj_f32): xp
// [M, N4] = x [M, D] @ w_x [D, N4] + b, all float, contiguous, 16-byte
// aligned; D % 4 == 0 and N4 % 4 == 0. block_m, grid and smem_bytes as
// rnn::xproj_f32_plan computes them (ops/cuda/gru.py xproj_f32_config),
// checked here.
int seqrec_lstm_xproj_f32(const void* x, const void* w_x, const void* b, void* xp, int M,
                          int D, int N4, int block_m, int grid, long long smem_bytes,
                          void* stream) {
  return rnn::launch_xproj_f32(x, w_x, b, xp, M, D, N4, block_m, grid, smem_bytes,
                               static_cast<cudaStream_t>(stream));
}

// The f32 recurrence on thread block clusters. xp [B, T, 4H] (the input
// projection, b included), h0, c0 [B, H], w_h [H, 4H], keep [B, T] (1 -
// reset; null: the no-reset variant), ys [B, T, H], c_last [B, H] and cs
// [B, T, H] (null: not written): all float, contiguous, 16-byte aligned;
// H % 4 == 0, H <= 256. Clusters of `cluster_size` CTAs of `threads`
// threads, each CTA `units` hidden units (cluster_size * units >= H) of
// `rows` batch rows, `slices` k-slices a unit (threads = slices * a padded
// unit count); w_in_regs: W_h's slice in registers (exactly where a slice
// is kLstmRegSlice values, 8 slices a unit, rows <= 8 and threads <=
// kLstmRegThreads). smem_bytes as the caller computed it, checked again
// here.
int seqrec_lstm_forward(const void* xp, const void* h0, const void* c0, const void* w_h,
                        const void* keep, void* ys, void* c_last, void* cs, int B, int Tn,
                        int H, int rows, int slices, int cluster_size, int units, int threads,
                        int w_in_regs, long long smem_bytes, void* stream) {
  const int C = cluster_size, S = slices;
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      !rnn::cluster_shape_ok(rows, S) || C < 1 || C > rnn::kClusterMax || units <= 0 ||
      C * units < H || threads % 32 != 0 || threads % S != 0 || threads / S < units ||
      threads > rnn::kClusterMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = rnn::slice_len(H, S);
  const size_t nr = rows >= S ? rows / S : 1;
  const size_t smem = (4 * static_cast<size_t>(L) * threads +
                       2 * static_cast<size_t>(rows) * (S * L + 4) +
                       rnn::kClusterRing * nr * threads * 5) * 4 + 2 * sizeof(uint64_t);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w_in_regs != (L == kLstmRegSlice && S == 8 && rows <= 8 && threads <= kLstmRegThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int clusters = (B + rows - 1) / rows;
  const float* x = static_cast<const float*>(xp);
  const float* h = static_cast<const float*>(h0);
  const float* c = static_cast<const float*>(c0);
  const float* w = static_cast<const float*>(w_h);
  const float* kp = static_cast<const float*>(keep);
  float* y = static_cast<float*>(ys);
  float* cl = static_cast<float*>(c_last);
  float* cp = static_cast<float*>(cs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kp == nullptr
             ? launch_cluster_fwd<false>(rows, S, w_in_regs, clusters, C, threads, smem, st, x, h, c, w, kp, y, cl, cp, B, Tn, H, units)
             : launch_cluster_fwd<true>(rows, S, w_in_regs, clusters, C, threads, smem, st, x, h, c, w, kp, y, cl, cp, B, Tn, H, units);
}

// The bf16 input projection on wgmma (rnn::xproj_wgmma_kernel): xp [M, N4]
// f32 = x [M, D] @ w_x [D, N4] + b, with x, w_x bf16 and b float; all
// contiguous, 16-byte aligned; D % 4 == 0 and N4 % 4 == 0. tile_m, tile_n,
// stages, tma, grid, band and smem_bytes as rnn::xproj_plan computes them
// (ops/cuda/gru.py xproj_config), checked here.
int seqrec_lstm_xproj(const void* x, const void* w_x, const void* b, void* xp, int M, int D,
                      int N4, int tile_m, int tile_n, int stages, int tma, int grid,
                      int band, long long smem_bytes, void* stream) {
  return rnn::checked_xproj(x, w_x, b, xp, M, D, N4, tile_m, tile_n, stages, tma, grid,
                            band, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The bf16 recurrence on tensor cores. xp [B, T, 4H] float (the input
// projection, b included), h0, c0 [B, H] bf16, w_frag W_h^T's packed A
// fragments [Hp/16][Hp/16][4][32] x 16 bytes (Hp = 16 ceil(H / 16)), keep
// [B, T] float (1 - reset) or null, ys [B, T, H] bf16, c_last [B, H] and cs
// [B, T, H] (null: not written) float; contiguous, 16-byte aligned;
// H % 4 == 0, H <= 256. smem_bytes (FwdSmem: the h double buffer and the
// xp ring) as the caller computed it, checked again here.
int seqrec_lstm_forward_mma(const void* xp, const void* h0, const void* c0,
                            const void* w_frag, const void* keep, void* ys, void* c_last,
                            void* cs, int B, int Tn, int H, long long smem_bytes,
                            void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = FwdSmem(16 * ((H + 15) / 16)).total;
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x = static_cast<const float*>(xp);
  const float* kp = static_cast<const float*>(keep);
  float* cl = static_cast<float*>(c_last);
  float* cp = static_cast<float*>(cs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kp == nullptr
             ? launch_fwd_mma<false>(x, h0, c0, w_frag, kp, ys, cl, cp, B, Tn, H, smem, s)
             : launch_fwd_mma<true>(x, h0, c0, w_frag, kp, ys, cl, cp, B, Tn, H, smem, s);
}

// The f32 reverse recurrence on thread block clusters. i, f, g, o, tanh_c,
// c_in, g_ys [B, T, H] and w_h [H, 4H] float; keep [B, T] (1 - reset; null:
// the no-reset variant), dc_last, dh0, dc0 [B, H] and d_xp [B, T, 4H] float.
// All contiguous, 16-byte aligned; H % 4 == 0, H <= 256. Clusters of
// `cluster_size` CTAs of `threads` threads, each CTA `units` hidden units
// (cluster_size * units >= H) of `rows` batch rows, `slices` k-slices a
// unit. smem_bytes as the caller computed it, checked again here.
int seqrec_lstm_backward(const void* i, const void* f, const void* g, const void* o,
                         const void* tanh_c, const void* c_in, const void* g_ys,
                         const void* w_h, const void* keep, const void* dc_last, void* d_xp,
                         void* dh0, void* dc0, int B, int Tn, int H, int rows, int slices,
                         int cluster_size, int units, int threads, long long smem_bytes,
                         void* stream) {
  const int C = cluster_size, S = slices;
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      (rows != 4 && rows != 8 && rows != 16) || S != 32 || C < 1 || C > rnn::kClusterMax ||
      units <= 0 || C * units < H || threads % 32 != 0 || threads / 32 * kBwdUnits < units ||
      threads > rnn::kClusterMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = rnn::slice_len(4 * H, S);
  const size_t np = rows * kBwdUnits >= 32 ? rows * kBwdUnits / 32 : 1;  // pairs a lane
  const size_t smem = (static_cast<size_t>(kBwdUnits) * L * threads +
                       2 * static_cast<size_t>(rows) * (S * L + 4) +
                       rnn::kClusterRing * np * threads * 8) * 4 + 2 * sizeof(uint64_t);
  if (static_cast<long long>(smem) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* planes[6] = {
      static_cast<const float*>(i), static_cast<const float*>(f),
      static_cast<const float*>(g), static_cast<const float*>(o),
      static_cast<const float*>(tanh_c), static_cast<const float*>(c_in)};
  const int clusters = (B + rows - 1) / rows;
  const float* gy = static_cast<const float*>(g_ys);
  const float* w = static_cast<const float*>(w_h);
  const float* kp = static_cast<const float*>(keep);
  const float* dcl = static_cast<const float*>(dc_last);
  float* dxp = static_cast<float*>(d_xp);
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kp == nullptr
             ? launch_cluster_bwd<false>(rows, clusters, C, threads, smem, st, planes, gy, w, kp, dcl, dxp, dh, dc, B, Tn, H, units)
             : launch_cluster_bwd<true>(rows, clusters, C, threads, smem, st, planes, gy, w, kp, dcl, dxp, dh, dc, B, Tn, H, units);
}

// The bf16 reverse recurrence on tensor cores. i, f, g, o, tanh_c, c_in
// [B, T, H] float; g_ys [B, T, H] bf16; w_frag W_h's packed A fragments
// [Hp/16][2 Hp/16][2][32] x 16 bytes (Hp = 32 ceil(H / 32)); keep [B, T] float (1 - reset) or null;
// dc_last, dh0, dc0 [B, H] and d_xp [B, T, 4H] float. All contiguous,
// 16-byte aligned; H % 4 == 0, H <= 256. smem_bytes (BwdSmem: the dz^T
// buffers and the gate-plane ring) as the caller computed it, checked again
// here.
int seqrec_lstm_backward_mma(const void* i, const void* f, const void* g,
                             const void* o, const void* tanh_c, const void* c_in,
                             const void* g_ys, const void* w_frag, const void* keep,
                             const void* dc_last, void* d_xp, void* dh0, void* dc0,
                             int B, int Tn, int H, long long smem_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = BwdSmem(32 * ((H + 31) / 32)).total;
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
  return kp == nullptr
             ? launch_bwd_mma<false>(planes, g_ys, w_frag, kp, dcl, dxp, dh, dc, B, Tn, H, smem, s)
             : launch_bwd_mma<true>(planes, g_ys, w_frag, kp, dcl, dxp, dh, dc, B, Tn, H, smem, s);
}

// The grid-persistent forward above H = 256 (either dtype: 0 float, 1
// bf16), one cooperative launch of tiles x groups CTAs. xp [B, T, 4H] float
// (the input projection, b included), h0, c0 [B, H] and ys [B, T, H] of the
// dtype, keep [B, T] float (1 - reset) or null, c_last [B, H] and cs
// [B, T, H] (null: not written) float; w_pack ops/cuda/gru.py grid_pack's
// packing of W_h (bf16: [tiles][Kp/16][4][32] x 16 bytes; float:
// [tiles][Kp/4][4][8] float4); ws a zeroed workspace of
// grid_workspace(B, H, dtype, forward) bytes. All contiguous, 16-byte
// aligned; H % 4 == 0, 256 < H. groups, smem_bytes (float: W_h and the
// ring, rnn::GridF32Plan) and ws_bytes as the caller computed them, checked
// again here (rnn::grid_check).
int seqrec_lstm_forward_grid(const void* xp, const void* h0, const void* c0, const void* w_pack,
                             const void* keep, void* ys, void* c_last, void* cs, void* ws, int B,
                             int Tn, int H, int dtype, int groups, long long smem_bytes,
                             long long ws_bytes, void* stream) {
  int grid = 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 1;
  const int rc = rnn::grid_check(B, Tn, H, bf16, kGates, groups, smem_bytes, ws_bytes,
                                 grid_workspace(B, H, bf16, false), true, &grid);
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(xp);
  const float* kp = static_cast<const float*>(keep);
  float* cl = static_cast<float*>(c_last);
  float* cp = static_cast<float*>(cs);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const int smem = static_cast<int>(smem_bytes);  // grid_check's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto* h = static_cast<const __nv_bfloat16*>(h0);
    const auto* c = static_cast<const __nv_bfloat16*>(c0);
    const auto* wf = static_cast<const uint4*>(w_pack);
    auto* y = static_cast<__nv_bfloat16*>(ys);
    return kp == nullptr
               ? rnn::launch_grid(lstm_forward_grid_kernel<false>, grid, smem, s, x, h, c, wf, kp, y, cl, cp, w, B, Tn, H, groups)
               : rnn::launch_grid(lstm_forward_grid_kernel<true>, grid, smem, s, x, h, c, wf, kp, y, cl, cp, w, B, Tn, H, groups);
  }
  const auto* h = static_cast<const float*>(h0);
  const auto* c = static_cast<const float*>(c0);
  const auto* wf = static_cast<const float4*>(w_pack);
  auto* y = static_cast<float*>(ys);
  using K = decltype(&lstm_forward_grid_f32_kernel<false, 32>);
  static const K k[2][3] = {
      {lstm_forward_grid_f32_kernel<false, 32>, lstm_forward_grid_f32_kernel<false, 64>, lstm_forward_grid_f32_kernel<false, 128>},
      {lstm_forward_grid_f32_kernel<true, 32>, lstm_forward_grid_f32_kernel<true, 64>, lstm_forward_grid_f32_kernel<true, 128>}};
  return rnn::launch_grid_f32(rnn::grid_f32_plan(B, H, groups, kGates).block, k[kp != nullptr],
                              grid, smem, s, x, h, c, wf, kp, y, cl, cp, w, B, Tn, H, groups);
}

// The grid-persistent reverse recurrence above H = 256 (dtype 0 float, 1
// bf16: g_ys's and the weights'). i, f, g, o, tanh_c, c_in [B, T, H] float;
// g_ys [B, T, H] of the dtype; w_pack grid_pack's packing of W_h (bf16:
// [tiles][4 Kp/16][32] x 16 bytes; float: [tiles][4 Kp/128][8][32] float4);
// keep [B, T] float or null; dc_last, dh0, dc0 [B, H] and d_xp [B, T, 4H]
// float; ws a zeroed workspace of grid_workspace(B, H, dtype, reverse)
// bytes. As the forward otherwise.
int seqrec_lstm_backward_grid(const void* i, const void* f, const void* g, const void* o,
                              const void* tanh_c, const void* c_in, const void* g_ys,
                              const void* w_pack, const void* keep, const void* dc_last,
                              void* d_xp, void* dh0, void* dc0, void* ws, int B, int Tn, int H,
                              int dtype, int groups, long long smem_bytes, long long ws_bytes,
                              void* stream) {
  int grid = 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 1;
  const int rc = rnn::grid_check(B, Tn, H, bf16, kGates, groups, smem_bytes, ws_bytes,
                                 grid_workspace(B, H, bf16, true), false, &grid);
  if (rc != 0) return rc;
  const float* pi = static_cast<const float*>(i);
  const float* pf = static_cast<const float*>(f);
  const float* pg = static_cast<const float*>(g);
  const float* po = static_cast<const float*>(o);
  const float* ptc = static_cast<const float*>(tanh_c);
  const float* pci = static_cast<const float*>(c_in);
  const float* kp = static_cast<const float*>(keep);
  const float* dcl = static_cast<const float*>(dc_last);
  float* dxp = static_cast<float*>(d_xp);
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  unsigned char* w = static_cast<unsigned char*>(ws);
  const int smem = rnn::grid_smem(H, bf16, kGates);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto* gy = static_cast<const __nv_bfloat16*>(g_ys);
    const auto* wf = static_cast<const uint4*>(w_pack);
    return kp == nullptr
               ? rnn::launch_grid(lstm_backward_grid_kernel<false>, grid, smem, s, pi, pf, pg, po, ptc, pci, gy, wf, kp, dcl, dxp, dh, dc, w, B, Tn, H, groups)
               : rnn::launch_grid(lstm_backward_grid_kernel<true>, grid, smem, s, pi, pf, pg, po, ptc, pci, gy, wf, kp, dcl, dxp, dh, dc, w, B, Tn, H, groups);
  }
  const auto* gy = static_cast<const float*>(g_ys);
  const auto* wf = static_cast<const float4*>(w_pack);
  return kp == nullptr
             ? rnn::launch_grid(lstm_backward_grid_f32_kernel<false>, grid, smem, s, pi, pf, pg, po, ptc, pci, gy, wf, kp, dcl, dxp, dh, dc, w, B, Tn, H, groups)
             : rnn::launch_grid(lstm_backward_grid_f32_kernel<true>, grid, smem, s, pi, pf, pg, po, ptc, pci, gy, wf, kp, dcl, dxp, dh, dc, w, B, Tn, H, groups);
}

// The stepped layout past grid_max_hidden (either dtype, dtype 0 float, 1
// bf16): T launches of the step's GEMM (hbuf @ w_h into hp, f32) each
// followed by the step's gate kernel. xp [B, T, 4H] float (the input
// projection, b included); hbuf [B, H] of the dtype, holding h0 (times
// keep[:, 0] in the reset variant); c_buf [B, H] float, holding c0 and,
// after the scan, c_T; w_h [H, 4H] of the dtype; keep [B, T] float or null;
// ys [B, T, H] of the dtype; cs [B, T, H] float (the cell plane) or null; hp
// float scratch of ws_bytes: the step GEMM's [splits][B][4H] partial planes
// (rows a block `block_m`, as bf16 step_gemm_plan, f32 fma_plan computes
// them). All contiguous, 16-byte aligned; H % 4 == 0.
int seqrec_lstm_forward_stepped(const void* xp, void* hbuf, void* c_buf, const void* w_h,
                                const void* keep, void* ys, void* cs,
                                void* hp, int B, int Tn, int H, int dtype, int splits,
                                int block_m, long long ws_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H % 4 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rnn::StepPlan plan;
  const int rc = rnn::stepped_plan(dtype == 1, B, H, 4 * H, 1, splits, block_m, ws_bytes, &plan);
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(xp);
  float* c = static_cast<float*>(c_buf);
  const float* kp = static_cast<const float*>(keep);
  float* cp = static_cast<float*>(cs);
  float* hq = static_cast<float*>(hp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto* hb = static_cast<bf*>(hbuf);
    const auto* w = static_cast<const bf*>(w_h);
    auto* y = static_cast<bf*>(ys);
    return kp == nullptr
               ? stepped_forward<bf, false>(x, hb, c, w, kp, y, cp, hq, plan, B, Tn, H, s)
               : stepped_forward<bf, true>(x, hb, c, w, kp, y, cp, hq, plan, B, Tn, H, s);
  }
  auto* hb = static_cast<float*>(hbuf);
  const auto* w = static_cast<const float*>(w_h);
  auto* y = static_cast<float*>(ys);
  return kp == nullptr
             ? stepped_forward<float, false>(x, hb, c, w, kp, y, cp, hq, plan, B, Tn, H, s)
             : stepped_forward<float, true>(x, hb, c, w, kp, y, cp, hq, plan, B, Tn, H, s);
}

// The stepped reverse recurrence; dtype is g_ys' (0 float, 1 bf16). i, f,
// g, o, tanh_c, c_in [B, T, H] float (c_in scaled by keep); g_ys [B, T, H]
// of the dtype; w: bf16 W_h [H, 4H] as stored, f32 W_h^T [4H, H]; keep
// [B, T] float or null; dc_last [B, H] float; dz [B, T, 4H], dh0, dc0 [B, H]
// float; scratch: a [B, 4H] float or [B, 8H] bf16 (the step's dz; bf16 its
// hi and lo terms, [hi | lo] a row), p float of ws_bytes (the step GEMM's
// [splits][B][H] partial planes) and dc [B, H] float. As the forward
// otherwise.
int seqrec_lstm_backward_stepped(const void* i, const void* f, const void* g, const void* o,
                                 const void* tanh_c, const void* c_in, const void* g_ys,
                                 const void* w, const void* keep,
                                 const void* dc_last, void* dz, void* dh0, void* dc0, void* a,
                                 void* p, void* dc, int B, int Tn, int H, int dtype, int splits,
                                 int block_m, long long ws_bytes, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || H % 4 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rnn::StepPlan plan;
  const int rc = rnn::stepped_plan(dtype == 1, B, 4 * H, H, dtype == 1 ? 2 : 1, splits, block_m,
                                   ws_bytes, &plan);
  if (rc != 0) return rc;
  const float* planes[6] = {static_cast<const float*>(i), static_cast<const float*>(f),
                            static_cast<const float*>(g), static_cast<const float*>(o),
                            static_cast<const float*>(tanh_c), static_cast<const float*>(c_in)};
  const float* kp = static_cast<const float*>(keep);
  const float* dcl = static_cast<const float*>(dc_last);
  float* out = static_cast<float*>(dz);
  float* d0 = static_cast<float*>(dh0);
  float* c0 = static_cast<float*>(dc0);
  float* pp = static_cast<float*>(p);
  float* cb = static_cast<float*>(dc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEQREC_STEP_BWD(W)                                                                      \
  (kp == nullptr                                                                                \
       ? stepped_backward<W, false>(planes, static_cast<const W*>(g_ys),                        \
                                    static_cast<const W*>(w), kp, dcl, out, d0, c0,              \
                                    static_cast<W*>(a), pp, cb, plan, B, Tn, H, s)               \
       : stepped_backward<W, true>(planes, static_cast<const W*>(g_ys),                         \
                                   static_cast<const W*>(w), kp, dcl, out, d0, c0,               \
                                   static_cast<W*>(a), pp, cb, plan, B, Tn, H, s))
  if (dtype == 0) return SEQREC_STEP_BWD(float);
  return SEQREC_STEP_BWD(__nv_bfloat16);
#undef SEQREC_STEP_BWD
}

const char* seqrec_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
