"""GRU scan kernels (`csrc/gru.cu`): the forward scan and the reverse
recurrence of its backward, joined by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/gru.py::gru_scan` (the TPU kernel
`_gru_step_body`, `_gru_step_kernel` :129 and `_gru_step_kernel_reset` :135,
launched at :177) and its custom VJP `_gru_core_bwd`, both variants: without
a reset mask, and with one (session-parallel training), where a keep plane
`1 - reset` [B, T] f32 goes to both kernels. The two variants count their
launches apart: `gru_scan.launches` / `gru_scan.reset_launches`, and the
same two on `gru_backward`; each also counts its launches of the cluster
layout above Hp = 128 (either variant) in `.wide_launches`, and of the grid
layout above H = 256 (either variant, either dtype) in `.grid_launches`.

Above H = 256 (the JAX package's wide GRU4Rec at D = H = 512, GRU4Rec's
1,000 units) no cluster holds W_h, and both directions in both dtypes run
csrc/gru.cu's grid-persistent layout (`grid_config`): one cooperative
launch, each CTA a slice of the units with their W_h values resident in its
shared memory (`grid_pack`) for a group of batch rows, the step's vector
through L2 in a zeroed workspace, one grid barrier a step; the reverse
publishes each step's d_hproj columns, then forms dh_prev from the whole
of it (the K split) with no atomics.

Past the grid layout's limit (`grid_max_hidden`: 2,112 in bf16, 1,056 in
f32) the stepped layout (`layout` "stepped", `stepped_config`; counted
again in `.stepped_launches`): every step of the scan is two launches, a
GEMM of the step's whole vector into f32 partial planes (K split) that
the gate kernel sums in split order (adding b_h), and an elementwise gate
kernel (csrc/gru.cu); 2T launches a scan, no H too wide. In bf16 the GEMM
is csrc/step_gemm.cuh's on wgmma (`step_gemm`, `step_gemm_config`): W_h as
stored, the reverse's d_hproj as two bf16 terms on the same W_h tiles; in
f32 csrc/fma_gemm.cuh's FMA GEMM (`step_gemm_f32`, `step_gemm_f32_config`),
the projection's kernel, its split from K and N alone.

Any H and D: the kernels need H % 4 == 0 and D % 4 == 0 (`launch_config`
keeps that check, the kernels' mechanical limit); the public entry points
(`gru_scan`, `gru_backward`, `gru_input_projection`) zero-pad the other
widths to the next multiple of 4, each gate block on its own (`pad_gates`),
launch the kernels on the padded tensors and slice the outputs back
(counted again in `.padded_launches`). This is exact: a padded unit has
zero weights and biases and starts from 0, so its gates are r = z = 1/2,
n = tanh(0) = 0 and h' = (1 - z) 0 + z 0 = 0 at every step, and its
cotangent stays 0; the padded rows and columns of W_h and W_x add only
exact zeros to every real sum (`padded_launch_config` names the padded
shape).

Forward, two hand-written designs chosen by dtype (each computes the whole
function in its own numerics; neither gives way to the other):

- bf16 (`design` "mma.sync", every shipped config): the input projection
  `x @ W_x + b_x` does not depend on h, so `gru_input_projection` computes
  it for all B*T rows first, on the tensor cores (a hand-written mma.sync
  GEMM into an f32 [B, T, 3H] plane; its own launch counter); the scan then
  runs only `h @ W_h` in its serial chain, transposed (W_h^T h^T) as
  mma.sync.m16n8k16 with the hidden units as M and a block's 8 batch rows
  as N. H pads to Hp = 16 ceil(H / 16) with zero weights and biases (a
  padded unit stays 0); Hp / 16 warps each own 16 units of every gate, so a
  lane holds the r, z and n sums of its own (unit, row) pairs; W_h^T's
  fragments stay in registers for the whole scan up to Hp = 128. One
  barrier a step; the step's latency times T binds. Above Hp = 128 W_h^T
  (384 KB at H = 256) fits no SM, so a thread block cluster of
  WIDE_CLUSTER CTAs owns the 8 rows, each CTA a quarter of the units with
  its slice of W_h^T in registers (`forward_fragments`), and the new h goes
  to every CTA through distributed shared memory (`st.async`, an mbarrier
  a buffer).
- f32 (`design` "cluster"): f32 FMAs on the CUDA cores (TF32 tensor cores
  would keep ~3 digits, not the f32 products of the contract). The
  projection goes off the serial chain here too, as a persistent f32 FMA
  GEMM fed by TMA (`gru_input_projection`, planned by `xproj_f32_config`,
  its own launch counter `.f32_launches`); the
  recurrence runs on
  thread block clusters: a cluster of C CTAs owns R batch rows for the
  whole scan, each CTA a slice of the hidden units with its W_h columns
  resident in its shared memory, and the new h slices go to every CTA of
  the cluster through distributed shared memory (`st.async`, counted by an
  mbarrier a buffer; `launch_config`, csrc/rnn.cuh).

Backward, as `_gru_core_bwd`: both projections are recomputed with
`torch.matmul` in parallel over T (`reference.gru_bwd_project`), the
reverse recurrence with the gate recompute folded in runs in the kernel
(`gru_backward`, plain version `reference.gru_bwd_fused`), and the weight
and input gradients are batched `torch.matmul`s and sums, where the JAX
package has XLA einsums. The reverse recurrence has two designs too, chosen
by W_h's dtype:

- bf16 weights (`design` "mma.sync", both variants): dh^T = W_h d_hproj^T
  on mma.sync (units as M, 8 rows as N, K = 3 Hp), the LSTM reverse
  recurrence's design with three gates and each warp over all of K (no
  split between warp pairs: it measured slower here); the kernel computes
  r, z, n and hn from the two projections itself, a step ahead, and writes
  the n-block of d_hproj beside d_xp. d_hproj is f32 in the contract, so it goes to the
  tensor cores as two bf16 terms, hi = bf16(d) and lo = bf16(d - hi); W_h's
  fragments are packed here (`backward_fragments`). Above Hp = 128, a
  cluster of WIDE_CLUSTER CTAs splits K: each CTA computes the
  cotangents of its units and multiplies W_h's rows of all units over its
  own gate columns (`wide_backward_fragments`, in registers), and the
  partial sums of dh_prev go to the units' owners through distributed
  shared memory.
- f32 weights (`design` "cluster", both variants): the f32 LSTM reverse
  recurrence's design with three gates, on thread block clusters (W_h's rows
  of a CTA's units in its shared memory, each step's d_hproj pushed to every
  CTA of the cluster by `st.async`); the kernel recomputes r, z, n and hn
  from the two projections a step ahead and writes dn_r beside d_xp, as the
  bf16 design does.

Both scans are bound by their serial chain over T, not by bytes or
operations; see the source note.

Numerics: forward products and gate math in f32, biases in f32, h rounded
to the working dtype (x.dtype: float32 or bfloat16) every step, as the TPU
kernel does; the plain version (ops/reference.py) works in x.dtype
throughout, so in bf16 the two differ by bf16 rounding of the gates. The
backward carries an f32 cotangent on both paths, and weight gradients are
rounded to the weights' working dtype, as the JAX package's VJP does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.gru_scan
plain_backward = reference.gru_bwd_fused

# Shared memory one block may opt in to on sm_90 (227 KB).
SMEM_LIMIT = 232_448
MAX_HIDDEN = 256  # kMaxHidden in csrc/gru.cu: the widest H of the block and cluster layouts
WH_REG_LIMIT = 128  # Hp up to which a bf16 recurrence runs in one block, W_h in registers
# The bf16 recurrences above WH_REG_LIMIT (csrc/gru.cu, the cluster layouts):
WIDE = 256  # kWide: units and k (and gate columns) padded to this width
WIDE_THREADS = 256  # kWideThreads: 8 warps a CTA
# kWideCluster: CTAs a cluster, each WIDE / 4 = 64 units with every fragment
# in registers (4 CTAs ran 31-39% faster than 2 on an H100, PERF.md).
WIDE_CLUSTER = 4
MMA_ROWS = 8  # kRows in csrc/rnn.cuh: batch rows a bf16 recurrence block, one n8 tile
RING_STAGES = 3  # kStages in csrc/rnn.cuh: per-step operands staged this deep
# The f32 cluster recurrences (csrc/rnn.cuh): a cluster of C CTAs owns R rows.
CLUSTER_THREADS = 512  # kClusterMaxThreads
CLUSTER_ROWS = (4, 8, 16)  # the rows a cluster the kernels are instantiated for
CLUSTER_RING = 4  # kClusterRing: stages of a lane's per-step operands
NUM_SMS = 132  # H100 SXM: the clusters of one launch should fit at once
# The f32 forward's (cluster size, rows a cluster), in the order preferred
# (kernel_probes.py clusters on an H100: fewer rows first, then 4 CTAs).
GRU_CLUSTERS = ((4, 4), (2, 4), (4, 8), (2, 8), (4, 16), (2, 16), (8, 4), (8, 8), (8, 16))
# The f32 projection below FMA_MIN_DEPTH (csrc/rnn.cuh xproj_f32_kernel, a
# persistent SIMT GEMM on simt_gemm.cuh's main loop):
F32_PROJ_TILE = (64, 128)  # rows and columns of an xp tile
F32_PROJ_THREADS = 128  # 8 x 8 outputs a thread
F32_PROJ_CTAS_PER_SM = 4
FMA_MIN_DEPTH = 256  # kXpF32FmaDepth: D from which the f32 projection runs the FMA GEMM
# The f32 FMA GEMM (csrc/fma_gemm.cuh) of the f32 projections from
# FMA_MIN_DEPTH and of the f32 stepped layouts' step GEMM:
FMA_TILE = (128, 32)  # kFmTileN, kFmK: a tile's columns and a chunk's depth
FMA_BOX_K = 36  # kFmBoxK: k an A box row (144 bytes: four rows' 16-byte reads, four bank groups)
FMA_WARPS = 8  # kFmWarps: consumer warps a CTA, each 32 rows of the tile; one CTA a SM
FMA_THREADS = 128 + 32 * FMA_WARPS  # kFmThreads: the producer warpgroup, then the consumers
FMA_STAGES = 4  # kFmStages: the ring's stages
FMA_MAX_SPLITS = 16  # kFmMaxSplits
FMA_MIN_CHUNKS = 8  # kFmMinChunks: chunks a split at least, where K has them
FMA_ROW_GROUP = 8  # kFmRowGroup: row blocks a band of the tile order
STEP_SIMT_ROWS = 128  # kStepSimtRows: M up to which the f32 step GEMM runs the SIMT kernel
# The f32 reverse recurrence's (cluster size, rows a cluster), in the order
# preferred (kernel_probes.py clusters on an H100): 2 CTAs of 4 rows are the
# fastest at B=128 and 256, T=200, H=128 and 100, and at rsc15's B=256,
# T=50, H=100 (PERF.md); at B=64, which no training path runs, 4 CTAs of 4
# rows are faster.
GRU_BWD_CLUSTERS = ((2, 4), (4, 4), (2, 8), (4, 8), (8, 4), (2, 16), (4, 16), (8, 8), (8, 16))
BWD_UNITS = 8  # kBwdUnits in csrc/gru.cu: units a warp of the f32 reverse recurrence sums for
BWD_OPERANDS = 12  # kBwdOperands: ring floats of a (unit, row) pair a step
GRU_REG_SLICE = 16  # kGruRegSlice in csrc/gru.cu: a W_h slice of this length stays in registers
# The grid-persistent layout above MAX_HIDDEN (csrc/gru.cu, both dtypes):
GRID_THREADS = 256  # kGridThreads: 8 warps a CTA
GRID_COUNTER = 256  # kGridCounter: workspace bytes before the planes (the barrier's counter)
# kGridUnits, kGridK, kGridRowTile: units a CTA (bf16 one m16 tile), the
# multiple K pads to (bf16 two k16 steps a 16-byte read; f32 a warp's 32
# float4s) and the rows a task (bf16 two n8 tiles; f32 a quad: the row
# groups' unit, and the reverse's task).
GRID_UNITS = {torch.bfloat16: 16, torch.float32: 8}
GRID_K = {torch.bfloat16: 32, torch.float32: 128}
GRID_ROW_TILE = {torch.bfloat16: 16, torch.float32: 4}
# The f32 forwards' step product (csrc/rnn.cuh grid_f32_product, GridF32Plan):
GRID_F32_MAX_BLOCK = 128  # kGfMaxBlock: rows a block at most
GRID_F32_K_SPLIT = 4  # kGfKSplit: K slices, the same in every block (a row's bits whatever its batch)
GRID_F32_SPAN = 16  # kGfSpan: a K slice's columns of a chunk
GRID_F32_MAX_STAGES = 8  # kGfMaxStages: the ring's chunks at most
GRID_F32_COUNTER_STRIDE = 64  # kGfCounterStride: a row group's barrier counter, bytes apart
GATE_THREADS = 256  # kStepThreads in csrc/rnn.cuh: a stepped layout's gate kernel block
# The stepped layouts' bf16 step GEMM (csrc/step_gemm.cuh):
STEP_GEMM_THREADS = 256  # kSgThreads: two warpgroups
STEP_GEMM_TILE = (128, 64)  # kSgTileN, kWgK: a CTA's columns and a chunk's depth (128 bytes)
STEP_GEMM_STAGES = 3  # kWgStages: the ring's stages
STEP_GEMM_MAX_SPLITS = 8  # kSgMaxSplits
STEP_GEMM_MIN_CHUNKS = 8  # kSgMinChunks: chunks a split at least, where K has them
# The bf16 input projection (csrc/rnn.cuh xproj_wgmma_kernel):
XPROJ_THREADS = 384  # kXpThreads: a producer and two consumer warpgroups
XPROJ_TILES = ((256, 128), (128, 256), (128, 128), (128, 64))  # rows x columns a tile may be
SM_SMEM = 233_472  # kXpSmSmem: shared memory of a SM, 1,024 bytes of it reserved a CTA
XPROJ_MAX_STAGES = 8  # kXpMaxStages
XPROJ_L2_BUDGET = 12 << 20  # kXpL2Budget: W_x bytes a band of column tiles may keep in L2
# The bf16 projection's entry points, seqrec_gru_xproj and seqrec_lstm_xproj
# alike: x, w_x, b, xp; M, D, N; `xproj_plan_args` (six ints, then the
# shared memory); the stream.
XPROJ_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_longlong,
                                                                ctypes.c_void_p])
# The f32 projection's, seqrec_gru_xproj_f32 and seqrec_lstm_xproj_f32: x,
# w_x, b, xp; M, D, N; `xproj_f32_plan_args` (rows a tile, CTAs, shared
# memory); the stream.
XPROJ_F32_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                                    ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru")
    fwd = lib.seqrec_gru_forward
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    proj = lib.seqrec_gru_xproj_f32
    proj.argtypes = XPROJ_F32_ARGTYPES
    proj.restype = ctypes.c_int
    proj = lib.seqrec_gru_xproj
    proj.argtypes = XPROJ_ARGTYPES
    proj.restype = ctypes.c_int
    mma = lib.seqrec_gru_forward_mma
    mma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    mma.restype = ctypes.c_int
    wide = lib.seqrec_gru_forward_wide
    wide.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    wide.restype = ctypes.c_int
    bwd = lib.seqrec_gru_backward
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd.restype = ctypes.c_int
    bwd_mma = lib.seqrec_gru_backward_mma
    bwd_mma.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd_mma.restype = ctypes.c_int
    bwd_wide = lib.seqrec_gru_backward_wide
    bwd_wide.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd_wide.restype = ctypes.c_int
    fwd_grid = lib.seqrec_gru_forward_grid
    fwd_grid.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    fwd_grid.restype = ctypes.c_int
    bwd_grid = lib.seqrec_gru_backward_grid
    bwd_grid.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    bwd_grid.restype = ctypes.c_int
    fwd_step = lib.seqrec_gru_forward_stepped
    fwd_step.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                                                      ctypes.c_void_p]
    fwd_step.restype = ctypes.c_int
    bwd_step = lib.seqrec_gru_backward_stepped
    bwd_step.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_longlong,
                                                                       ctypes.c_void_p]
    bwd_step.restype = ctypes.c_int
    gemm = lib.seqrec_step_gemm
    gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                                                  ctypes.c_void_p]
    gemm.restype = ctypes.c_int
    gemm_f32 = lib.seqrec_step_gemm_f32
    gemm_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                                      ctypes.c_void_p]
    gemm_f32.restype = ctypes.c_int
    lib.seqrec_gru_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_gru_error_string.restype = ctypes.c_char_p
    return lib


def _check_dims(B: int, T: int, H: int, dtype: torch.dtype, who: str = "gru") -> int:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{who}: dtype {dtype} not in float32/bfloat16")
    if min(B, T, H) <= 0:
        raise ValueError(f"{who}: empty shape B={B} T={T} H={H}")
    if H % 4 != 0:
        raise ValueError(f"{who}: the kernels need H % 4 == 0 (H={H}; the public entry points "
                         f"pad it, `padded_launch_config`)")
    return torch.empty((), dtype=dtype).element_size()


def padded_width(n: int) -> int:
    """n rounded up to the kernels' multiple of 4."""
    return -(-n // 4) * 4


def pad_gates(t: torch.Tensor, H: int, Hp: int, dim: int = -1) -> torch.Tensor:
    """Axis `dim` of `t`, G blocks of H (gate blocks; G = 1 for a state),
    zero-padded to G blocks of Hp, each block on its own (differentiable:
    the gradient of the padding is dropped)."""
    if Hp == H:
        return t
    dim %= t.dim()
    G = t.shape[dim] // H
    u = t.reshape(*t.shape[:dim], G, H, *t.shape[dim + 1:])
    u = torch.nn.functional.pad(u, [0, 0] * (t.dim() - dim - 1) + [0, Hp - H])
    return u.reshape(*t.shape[:dim], G * Hp, *t.shape[dim + 1:])


def unpad_gates(t: torch.Tensor, H: int, Hp: int, dim: int = -1) -> torch.Tensor:
    """`pad_gates` undone: the first H of each of axis `dim`'s blocks of Hp."""
    if Hp == H:
        return t
    dim %= t.dim()
    G = t.shape[dim] // Hp
    u = t.reshape(*t.shape[:dim], G, Hp, *t.shape[dim + 1:]).narrow(dim + 1, 0, H)
    return u.reshape(*t.shape[:dim], G * H, *t.shape[dim + 1:])


def pad_scan_operands(x: torch.Tensor, states, w_x: torch.Tensor, w_h: torch.Tensor,
                      biases) -> tuple:
    """The padded route's operands, in the order given: x [B, T, D] with D
    zero-padded to Dp, each state [B, H] and bias [G H] to Hp units a gate
    block, W_x [D, G H] to [Dp, G Hp] and W_h [H, G H] to [Hp, G Hp] (Dp, Hp
    = `padded_width` of D, H; zeros everywhere new; differentiable)."""
    D, H = x.shape[-1], w_h.shape[0]
    Dp, Hp = padded_width(D), padded_width(H)
    pad = torch.nn.functional.pad
    return (pad(x, (0, Dp - D)), [pad_gates(s, H, Hp) for s in states],
            pad(pad_gates(w_x, H, Hp), (0, 0, 0, Dp - D)),
            pad_gates(pad_gates(w_h, H, Hp), H, Hp, dim=0), [pad_gates(b, H, Hp) for b in biases])


def card_sms() -> int:
    """The current CUDA device's SMs (step_gemm.cuh's sg_sms reads the same
    at every plan), NUM_SMS where no card is present."""
    if not torch.cuda.is_available():
        return NUM_SMS
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def step_gemm_config(M: int, K: int, N: int, terms: int, sms: Optional[int] = None) -> Dict:
    """The stepped layouts' bf16 step GEMM (csrc/step_gemm.cuh, the C side's
    step_gemm_plan; the entry points check that both agree): the K-split
    partial planes [splits, M, N] f32 of a @ w on wgmma, forward (`terms` 1:
    a [M, K], w [K, N], W_h as stored, read MN-major) or reverse (2: a [M, 2K],
    the cotangent's hi and lo terms side by side, w [N, K], W_h as stored,
    read K-major: the two terms share each W tile). `block` [BM, BN, BK]: a
    CTA computes BM rows (forward 256 at M > 128, else 128; reverse 128) of
    BN = 128 columns in BK = 64-deep chunks (128-byte swizzled lines)
    through a ring of `stages` stages, filled by TMA (`tma`) where every
    row stride is a 16-byte multiple, else by cp.async. K splits into `splits`
    ranges of `chunks_per_split` chunks so that the `tiles` (column tiles
    times row blocks) times the splits fill the `sms` SMs (default
    `card_sms()`, the card the C side plans for) in one wave: at most
    STEP_GEMM_MAX_SPLITS, each of at least STEP_GEMM_MIN_CHUNKS chunks where
    K has them, none empty; with as many tiles as SMs or more, one split and
    one CTA a SM walking the tiles. `grid` CTAs of `threads`; `unit_bytes`
    16 where every row stride and base is a 16-byte multiple (K % 8 == 0,
    and forward N % 8 == 0: the TMA route), else 8 (cp.async's piece);
    `smem_bytes` the ring and 1 KB to align it; `workspace_bytes` the
    partial planes.
    ValueError for an empty shape, K or N not a multiple of 4, or terms not
    1 or 2."""
    if min(M, K, N) <= 0 or K % 4 or N % 4 or terms not in (1, 2):
        raise ValueError(f"step gemm: needs M, K, N > 0, K % 4 == N % 4 == 0 and 1 or 2 terms "
                         f"(M={M} K={K} N={N} terms={terms})")
    bn, bk = STEP_GEMM_TILE
    bm = 256 if terms == 1 and M > 128 else 128
    unit = 16 if K % 8 == 0 and (terms == 2 or N % 8 == 0) else 8
    tiles = -(-N // bn) * -(-M // bm)
    chunks = -(-K // bk)
    sms = card_sms() if sms is None else sms
    if tiles >= sms:
        splits, per, grid_tiles = 1, chunks, sms
    else:
        s = min(STEP_GEMM_MAX_SPLITS, sms // tiles, max(1, chunks // STEP_GEMM_MIN_CHUNKS))
        per = -(-chunks // s)
        splits, grid_tiles = -(-chunks // per), tiles
    return {"design": "wgmma", "terms": terms, "w_layout": "[N, K]" if terms == 2 else "[K, N]",
            "block": [bm, bn, bk], "threads": STEP_GEMM_THREADS, "stages": STEP_GEMM_STAGES,
            "tiles": tiles, "splits": splits, "chunks_per_split": per,
            "grid": grid_tiles * splits,
            "unit_bytes": unit, "tma": unit == 16,
            "smem_bytes": STEP_GEMM_STAGES * (terms * bm + bn) * bk * 2 + 1024,
            "workspace_bytes": splits * M * N * 4}


def xproj_ctas(bm: int, bn: int) -> int:
    """CTAs a SM of the bf16 projection's tile (csrc/rnn.cuh xp_ctas): two
    of 128 x 64, else one."""
    return 2 if bm * bn == 128 * 64 else 1


def xproj_max_stages(bm: int, bn: int) -> int:
    """The most ring stages a CTA's share of shared memory holds beside
    1,024 bytes to align (csrc/rnn.cuh xp_max_stages)."""
    limit = SMEM_LIMIT if xproj_ctas(bm, bn) == 1 else SM_SMEM // 2 - 1024
    return min(XPROJ_MAX_STAGES, (limit - 1024) // ((bm + bn) * STEP_GEMM_TILE[1] * 2))


def xproj_tile(M: int, D: int, N: int, sms: int) -> Tuple[int, int, int]:
    """The bf16 projection's tile rows, columns and ring stages on `sms` SMs
    (csrc/rnn.cuh xp_rule; kernel_probes.py xproj_bf16 chose it): 128 x 64
    (two CTAs a SM) where K is at most two chunks deep (D <= 128); else
    128 x 128 where a CTA's (one a SM) most tiles times their area is under
    0.9 of the larger tiles', or no more where the larger tiles are under
    two a SM (the small ones balance the last wave); else of 256 x 128 and
    128 x 256 the one with the smaller such cost, 256 x 128 on a tie. 4
    stages where K is more than 8 chunks deep, else 3, within what shared
    memory holds."""
    bk = STEP_GEMM_TILE[1]
    if -(-D // bk) <= 2:
        return 128, 64, 3

    def tiles(bm, bn):
        return -(-M // bm) * -(-N // bn)

    def cost(bm, bn):
        return -(-tiles(bm, bn) // sms) * bm * bn

    big = min(((256, 128), (128, 256)), key=lambda t: cost(*t))  # 256 x 128 on a tie
    small = cost(128, 128)
    if 10 * small < 9 * cost(*big) or (small <= cost(*big) and tiles(*big) < 2 * sms):
        big = (128, 128)
    bm, bn = big
    return bm, bn, min(4 if -(-D // bk) > 8 else 3, xproj_max_stages(bm, bn))


def xproj_config(M: int, D: int, N: int, sms: Optional[int] = None) -> Dict:
    """The bf16 input projection xp [M, N] f32 = x [M, D] @ W_x [D, N] + b
    (csrc/rnn.cuh xproj_wgmma_kernel, the C side's xproj_plan; the entry
    points refuse a caller whose plan differs): wgmma, warp-specialised and
    persistent. `block` [BM, BN, BK]: output tiles of BM rows (BM / 2 a
    consumer warpgroup) and BN columns (`xproj_tile`), K in BK = 64-deep
    chunks through a ring of `stages` stages; `grid` `ctas_per_sm` CTAs a
    SM (`xproj_ctas`: two of 128 x 64 tiles, else one), at most the
    `tiles`. `route` "tma" where every row stride is a 16-byte multiple
    (D % 8 == 0 and N % 8 == 0; one producer thread asks for each chunk),
    else "cp.async" (8-byte pieces from the producer warpgroup's 128
    threads, each thread's copies counted on the stage's barrier as they
    land); zero past M, N and D either way. Tiles are walked in bands of
    `band` column tiles, each band down M: the band's W_x in L2 (all of it
    where it fits XPROJ_L2_BUDGET, else the fewest even bands that fit).
    `registers` the setmaxnreg counts a thread of the producer and of a
    consumer warpgroup (two CTAs a SM take none: both the launch's 80).
    Planned for `sms` SMs (default `card_sms()`, the card the C side plans
    for). ValueError for an empty shape or D or N not a multiple of 4 (the
    wrappers pad them)."""
    if min(M, D, N) <= 0 or D % 4 or N % 4:
        raise ValueError(f"input projection: needs M, D, N > 0 and D % 4 == N % 4 == 0 "
                         f"(M={M} D={D} N={N}; the wrappers pad D and N)")
    sms = card_sms() if sms is None else sms
    bm, bn, stages = xproj_tile(M, D, N, sms)
    bk = STEP_GEMM_TILE[1]
    n_tiles = -(-N // bn)
    tiles = -(-M // bm) * n_tiles
    bands = -(-(2 * D * n_tiles * bn) // XPROJ_L2_BUDGET)
    tma = D % 8 == 0 and N % 8 == 0
    ctas = xproj_ctas(bm, bn)
    regs = ({"producer": 40 if tma else 56, "consumer": 232 if tma else 224} if ctas == 1 else
            {"producer": 80, "consumer": 80})
    return {"design": "wgmma", "layout": "persistent", "block": [bm, bn, bk],
            "threads": XPROJ_THREADS, "warpgroups": {"producer": 1, "consumers": 2},
            "stages": stages, "route": "tma" if tma else "cp.async", "tma": tma,
            "unit_bytes": 16 if tma else 8, "tiles": tiles, "band": -(-n_tiles // bands),
            "ctas_per_sm": ctas, "grid": min(tiles, ctas * sms),
            "smem_bytes": stages * (bm + bn) * bk * 2 + 1024, "registers": regs}


def xproj_plan_args(M: int, D: int, N: int) -> tuple:
    """`xproj_config`'s plan as the entry points take it (and check it):
    rows and columns a tile, stages, TMA, CTAs, column tiles a band, shared
    memory."""
    cfg = xproj_config(M, D, N)
    return (*cfg["block"][:2], cfg["stages"], int(cfg["tma"]), cfg["grid"], cfg["band"],
            cfg["smem_bytes"])


def fma_smem() -> int:
    """The ring's shared memory and 1,024 bytes to align it (kFmSmem): a
    stage holds A's box (the tile's rows x FMA_BOX_K k) and W's (a chunk's k
    x the tile's columns), all f32."""
    bn, bk = FMA_TILE
    return FMA_STAGES * (32 * FMA_WARPS * FMA_BOX_K + bk * bn) * 4 + 1024


def fma_splits(K: int, N: int, sms: int) -> int:
    """The f32 step GEMM's K splits (fm_splits), from K, N and the SMs alone
    (never M: a row's bits do not depend on its batch): of 1 ..
    FMA_MAX_SPLITS, each at least FMA_MIN_CHUNKS chunks deep where K has
    them, none empty, the one of least waves (one CTA of 256 rows a SM) x
    chunks a split x 1,024 plus N // 8 a split (its plane written and read),
    the fewest on a tie."""
    bn, bk = FMA_TILE
    chunks, n_tiles = -(-K // bk), -(-N // bn)
    floor_per = min(chunks, FMA_MIN_CHUNKS)
    best, best_cost = 1, None
    for s in range(1, FMA_MAX_SPLITS + 1):
        per = -(-chunks // s)
        if -(-chunks // per) != s or (s > 1 and per < floor_per):
            continue
        cost = -(-n_tiles * s // sms) * per * 1024 + s * N // 8
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def fma_gemm_config(M: int, K: int, N: int, split: bool, sms: Optional[int] = None) -> Dict:
    """The f32 FMA GEMM out = a [M, K] @ w [K, N] (csrc/fma_gemm.cuh, the C
    side's fma_plan; the entry points refuse a caller whose plan differs):
    f32 FMAs on the CUDA cores, no TF32; persistent, one CTA a SM of
    FMA_THREADS threads: a producer warpgroup whose thread 0 asks the TMA
    for each chunk's boxes (`route` "tma": every f32 row stride is a
    16-byte multiple) and `warps` consumer warps of 8 x 16 outputs a
    thread, the producer's registers handed to them (setmaxnreg). `block`
    [BM, BN, BK]: tiles of BM = 32 x warps rows and BN columns, K in
    BK-deep chunks through a ring of `stages`; `grid` at most the SMs, one
    an item (a tile and a K split). `split` (the stepped layouts' step
    GEMM): the partial planes [splits, M, N] of `fma_splits` (K, N and the
    SMs alone), `workspace_bytes` of them; else (the projection) one plane
    with b added. Planned for `sms` SMs (default `card_sms()`). ValueError
    for an empty shape or K or N not a multiple of 4."""
    if min(M, K, N) <= 0 or K % 4 or N % 4:
        raise ValueError(f"f32 gemm: needs M, K, N > 0 and K % 4 == N % 4 == 0 "
                         f"(M={M} K={K} N={N}; the wrappers pad D and N)")
    sms = card_sms() if sms is None else sms
    bn, bk = FMA_TILE
    bm = 32 * FMA_WARPS
    chunks, n_tiles = -(-K // bk), -(-N // bn)
    s = fma_splits(K, N, sms) if split else 1
    per = -(-chunks // s)
    s = -(-chunks // per)
    tiles = -(-M // bm) * n_tiles
    return {"design": "fma", "layout": "persistent", "route": "tma",
            "block": [bm, bn, bk], "box_k": FMA_BOX_K, "threads": FMA_THREADS,
            "warps": FMA_WARPS, "stages": FMA_STAGES, "ctas_per_sm": 1, "tiles": tiles,
            "splits": s, "chunks_per_split": per, "grid": min(tiles * s, sms),
            "smem_bytes": fma_smem(), "workspace_bytes": s * M * N * 4 if split else 0}


def xproj_f32_grid(M: int, N: int, sms: Optional[int] = None) -> int:
    """CTAs of the SIMT f32 projection: F32_PROJ_CTAS_PER_SM a SM of `sms`
    (default `card_sms()`), or one an xp tile (F32_PROJ_TILE) if there are
    fewer; CTA c computes tiles c, c + grid, c + 2 grid, ... (tile j: row
    block j % m_tiles, column block j // m_tiles)."""
    tm, tn = F32_PROJ_TILE
    sms = card_sms() if sms is None else sms
    return min(-(-M // tm) * -(-N // tn), F32_PROJ_CTAS_PER_SM * sms)


def xproj_f32_config(M: int, D: int, N: int, sms: Optional[int] = None) -> Dict:
    """The f32 input projection xp [M, N] = x [M, D] @ W_x [D, N] + b (the C
    side's xproj_f32_plan; the entry points refuse a caller whose plan
    differs): each output sums its products by FMA in k order from 0, then
    adds b, in either design. From D = FMA_MIN_DEPTH the FMA GEMM
    (`fma_gemm_config` without a split); below it (one to three waves of
    its tiles, where it lost to this one on an H100) the SIMT GEMM
    (`design` "simt": F32_PROJ_TILE tiles of F32_PROJ_THREADS threads, 8 x
    8 outputs a thread, x transposed into shared memory by cp.async,
    `xproj_f32_grid` CTAs), its k chunk 16 deep where that pads D less
    than 32 does (D = 100: 112, not 128; 3 stages), else 32 (2 stages).
    ValueError for an empty shape or D or N not a multiple of 4."""
    if D >= FMA_MIN_DEPTH or min(M, D, N) <= 0 or D % 4 or N % 4:
        return fma_gemm_config(M, D, N, False, sms)
    tm, tn = F32_PROJ_TILE
    bk = 16 if -(-D // 16) * 16 < -(-D // 32) * 32 else 32
    stages = 3 if bk == 16 else 2
    tiles = -(-M // tm) * -(-N // tn)
    return {"design": "simt", "layout": "persistent", "block": [tm, tn, bk],
            "threads": F32_PROJ_THREADS, "stages": stages, "ctas_per_sm": F32_PROJ_CTAS_PER_SM,
            "tiles": tiles, "splits": 1, "chunks_per_split": -(-D // bk),
            "grid": xproj_f32_grid(M, N, sms),
            "smem_bytes": stages * bk * (tm + 4 + tn) * 4, "workspace_bytes": 0}


def xproj_f32_plan_args(M: int, D: int, N: int) -> tuple:
    """`xproj_f32_config`'s plan as the entry points take it (and check
    it): rows a tile, CTAs, shared memory."""
    cfg = xproj_f32_config(M, D, N)
    return cfg["block"][0], cfg["grid"], cfg["smem_bytes"]


def step_gemm_f32_config(M: int, K: int, N: int, sms: Optional[int] = None) -> Dict:
    """The f32 stepped layouts' step GEMM (csrc/rnn.cuh stepped_plan):
    partial planes [splits, M, N] of a [M, K] @ w [K, N] that the gate
    kernel sums in split order, split by `fma_splits` (K, N and the SMs
    alone, never M). Above STEP_SIMT_ROWS rows the FMA GEMM
    (`fma_gemm_config` with the split); up to them the SIMT kernel of the
    narrow projections (`design` "simt": F32_PROJ_TILE tiles, 32-deep
    chunks, an item a tile and a split, `grid` at most F32_PROJ_CTAS_PER_SM
    a SM), where one 8 x 16 tile a thread would leave most of the card
    idle. Each plane sums its k range by FMA in k order from 0 in either,
    so a row's bits do not depend on its batch."""
    cfg = fma_gemm_config(M, K, N, True, sms)
    if M > STEP_SIMT_ROWS:
        return cfg
    tm, tn = F32_PROJ_TILE
    bk = FMA_TILE[1]
    sms = card_sms() if sms is None else sms
    tiles = -(-M // tm) * -(-N // tn)
    return {"design": "simt", "layout": "persistent", "block": [tm, tn, bk],
            "threads": F32_PROJ_THREADS, "stages": 2, "ctas_per_sm": F32_PROJ_CTAS_PER_SM,
            "tiles": tiles, "splits": cfg["splits"], "chunks_per_split": cfg["chunks_per_split"],
            "grid": min(tiles * cfg["splits"], F32_PROJ_CTAS_PER_SM * sms),
            "smem_bytes": 2 * bk * (tm + 4 + tn) * 4, "workspace_bytes": cfg["workspace_bytes"]}


def stepped_config(B: int, T: int, H: int, dtype: torch.dtype, gates: int,
                   reverse: bool) -> Dict:
    """The stepped layout past `grid_max_hidden(dtype, gates)` (csrc/rnn.cuh,
    either direction, the GRU's 3 gates or the LSTM's 4): each step a GEMM
    of the [B, K] vector into f32 (forward: h [B, H] @ W_h [H, G H], K = H;
    reverse: the cotangent [B, G H] @ W_h^T, K = G H), then a gate kernel of
    GATE_THREADS threads over the B H (row, unit) pairs; the reverse ends
    with one more gate launch (dh0, and the LSTM's dc0). `launches_per_scan`
    counts both. `gemm`, whose K-split partial planes the gate kernel sums
    (and the GRU forward's b_h adds): bf16 the step GEMM (`step_gemm_config`;
    the reverse's cotangent as `d_terms` (`dz_terms`) bf16 terms on W_h as
    stored); f32 the FMA GEMM (`step_gemm_f32_config`), the reverse on a
    W_h^T copy."""
    bf16 = dtype == torch.bfloat16
    K = gates * H if reverse else H
    N = H if reverse else gates * H
    gemm = (step_gemm_config(B, K, N, 2 if reverse else 1) if bf16 else
            step_gemm_f32_config(B, K, N))
    cfg = {"design": "wgmma" if bf16 else "fma", "layout": "stepped",
           "gemm_m": B, "gemm_k": K, "gemm_n": N, "gemm": gemm,
           "gate_grid": -(-(B * H) // GATE_THREADS), "threads": GATE_THREADS,
           "launches_per_scan": 2 * T + (1 if reverse else 0),
           "max_hidden": grid_max_hidden(dtype, gates)}
    if reverse and bf16:  # named as the GRU's (d_hproj) and the LSTM's (dz) other layouts name it
        return {**cfg, "d_terms" if gates == 3 else "dz_terms": 2}
    return cfg


def _grid_kpad(H: int, dtype: torch.dtype) -> int:
    return -(-H // GRID_K[dtype]) * GRID_K[dtype]


def _grid_smem(H: int, dtype: torch.dtype, gates: int = 3) -> int:
    """rnn::grid_smem in csrc/rnn.cuh: W_h's values of a CTA's units, 32
    gates Kp bytes in every grid kernel (bf16: 16 units x gates x Kp x 2
    bytes; f32: 8 units x gates x Kp x 4); 96 Kp for the GRU."""
    return 32 * gates * _grid_kpad(H, dtype)


@functools.lru_cache(maxsize=None)
def grid_max_hidden(dtype: torch.dtype, gates: int = 3) -> int:
    """The widest H (a multiple of 4) of a grid layout of `gates` gates: its
    unit slices (ceil(H / GRID_UNITS) CTAs, each at least one row group) fit
    the card's NUM_SMS in one cooperative wave, and a CTA's W_h values fit
    SMEM_LIMIT. The GRU's: 2,112 in bf16 (132 slices of 16 units), 1,056 in
    f32 (132 slices of 8)."""
    H = NUM_SMS * GRID_UNITS[dtype]
    while _grid_smem(H, dtype, gates) > SMEM_LIMIT:
        H -= 4
    return H


def grid_layout(B: int, H: int, dtype: torch.dtype, gates: int, plane_bytes: int) -> Dict:
    """csrc/rnn.cuh's grid-persistent layout above MAX_HIDDEN (either dtype,
    either direction, the GRU's 3 gates or the LSTM's 4): one cooperative
    launch of `unit_slices` x `row_groups` CTAs of GRID_THREADS threads, all
    resident at once. CTA (slice, group) owns GRID_UNITS units (their W_h
    values, every gate, in its shared memory: `smem_bytes`, 32 gates Kp bytes
    with K padded to `k_padded`) for the group's batch rows; the row groups
    split the rows into tasks of GRID_ROW_TILE rows as far as the card's
    NUM_SMS allow beside the slices (more groups, fewer rows a CTA), each
    group a whole number of tasks and none empty. `workspace_bytes`: the
    zeroed workspace the wrapper hands the kernel, the barrier's counter and
    then `plane_bytes` bytes for each (row, k) of the [rows][Kp] plane (each
    kernel's buffers and carries)."""
    units, tile = GRID_UNITS[dtype], GRID_ROW_TILE[dtype]
    slices = -(-H // units)
    row_tiles = -(-B // tile)
    per = -(-row_tiles // max(1, min(NUM_SMS // slices, row_tiles)))
    groups = -(-row_tiles // per)
    kp = _grid_kpad(H, dtype)
    return {"design": "mma.sync" if dtype == torch.bfloat16 else "fma", "layout": "grid",
            "grid": slices * groups, "threads": GRID_THREADS, "units_per_cta": units,
            "unit_slices": slices, "row_groups": groups, "rows_per_group": per * tile,
            "k_padded": kp, "smem_bytes": _grid_smem(H, dtype, gates),
            "workspace_bytes": GRID_COUNTER + plane_bytes * row_tiles * tile * kp,
            "max_hidden": grid_max_hidden(dtype, gates)}


def grid_f32_plan(rows: int, kp: int, gates: int) -> Dict:
    """The f32 grid forwards' step product (csrc/rnn.cuh GridF32Plan, which
    the C side computes again and checks against `smem_bytes`): a CTA's
    `rows` (its row group's, at most) go through the product in blocks of
    `ring_rows` (the smallest of 32, 64 and 128 that holds them; 128 past
    that, `row_blocks` of them). The 8 warps are 2 row warps x `k_split`
    (GRID_F32_K_SPLIT) slices of each `chunk` of K (GRID_F32_SPAN columns a
    slice); a warp is 8 row lanes x 4 column lanes, a thread `thread_rows`
    rows (ring_rows / 16) x 2 units x the gates. The slicing is the same in
    every block, so that a row's sums are the same bits whatever the batch
    around it. h's rows arrive through a ring of `stages` chunks (each row
    padded by 4 floats), as many as fit beside W_h's 32 gates Kp bytes, up
    to the chunks of a step and GRID_F32_MAX_STAGES. `smem_bytes`: W_h, then
    the larger of the ring and the partial sums (k_split x ring_rows rows of
    8 gates + 4 floats), whose bytes it shares. ValueError outside the plan
    (fewer than 2 stages, or over SMEM_LIMIT)."""
    block = 32
    while block < rows and block < GRID_F32_MAX_BLOCK:
        block *= 2
    k_split = GRID_F32_K_SPLIT
    chunk = GRID_F32_SPAN * k_split
    stage = block * (chunk + 4) * 4
    weights = 32 * gates * kp
    red = k_split * block * (8 * gates + 4) * 4
    stages = min((SMEM_LIMIT - weights) // stage, kp // chunk, GRID_F32_MAX_STAGES)
    smem = weights + max(stages * stage, red)
    if stages < 2 or smem > SMEM_LIMIT or rows <= 0 or kp % 128:
        raise ValueError(f"grid f32 forward: no plan for {rows} rows a CTA at Kp={kp} with "
                         f"{gates} gates ({stages} stages of {stage} bytes beside {weights} "
                         f"bytes of W_h; SMEM_LIMIT {SMEM_LIMIT})")
    return {"ring_rows": block, "row_blocks": -(-rows // block), "thread_rows": block // 16,
            "k_split": k_split, "chunk": chunk, "stages": stages, "smem_bytes": smem}


def grid_forward_layout(B: int, H: int, dtype: torch.dtype, gates: int,
                        plane_bytes: int) -> Dict:
    """`grid_layout` of a forward: in f32 with the step product's plan
    (`grid_f32_plan` at the row group's rows), whose shared memory it takes,
    and a barrier counter a row group (GRID_F32_COUNTER_STRIDE bytes apart
    in the workspace's GRID_COUNTER bytes: at most 4 groups, which the
    layout never passes beside 33 unit slices or more on NUM_SMS)."""
    cfg = grid_layout(B, H, dtype, gates, plane_bytes)
    if dtype == torch.float32:
        if cfg["row_groups"] * GRID_F32_COUNTER_STRIDE > GRID_COUNTER:
            raise ValueError(f"grid f32 forward: {cfg['row_groups']} row groups, each a barrier "
                             f"counter {GRID_F32_COUNTER_STRIDE} bytes apart, overrun the "
                             f"workspace's {GRID_COUNTER} counter bytes")
        cfg.update(grid_f32_plan(cfg["rows_per_group"], cfg["k_padded"], gates))
    return cfg


def grid_config(B: int, H: int, dtype: torch.dtype, reverse: bool) -> Dict:
    """The GRU's grid layout (`grid_layout` with three gates; the f32
    forward's `grid_forward_layout`): its workspace holds the forward's h
    buffers [2][rows][Kp] or the reverse's d_hproj buffers and carry
    (gru.cu's grid_workspace)."""
    if reverse:
        return grid_layout(B, H, dtype, 3, 28)
    return grid_forward_layout(B, H, dtype, 3, 2 * dtype.itemsize)


def not_cluster(rows_per_cluster, cluster_size, H: int, who: str = "gru") -> None:
    """The grid layout (above MAX_HIDDEN, the GRU's and the LSTM's) takes no
    f32 cluster options."""
    if rows_per_cluster is not None or cluster_size is not None:
        raise ValueError(f"{who}: rows_per_cluster and cluster_size are the f32 cluster design's; "
                         f"the grid layout above H = {MAX_HIDDEN} takes neither (H={H})")


def _slice_len(K: int, S: int) -> int:
    """rnn::slice_len: values of one of S k-slices of K inputs, a multiple of 4."""
    return -(-K // (4 * S)) * 4


def cluster_config(B: int, H: int, K: int, w_per_k: int, ring_floats: int,
                   cluster_size: Optional[int], rows: Optional[int], preference, who: str,
                   unit_block: int = 1) -> Dict:
    """The layout of an f32 cluster recurrence (csrc/rnn.cuh): K inputs of the
    step's vector (H for the GRU and LSTM forwards' h, 4H for the LSTM
    reverse's dz), `w_per_k` weights of a thread per input of its slice (3
    or 4 gates of one unit, or one gate of `unit_block` units), `ring_floats` operands
    of a lane's (unit, row) pair a step in the cp.async ring (xp's three or
    four gates and keep, or six gate planes, g_y and keep), `unit_block`
    units a group of threads shares (1, or 4: a warp's).

    C CTAs a cluster each own U = ceil(H / C) units. With one unit a group,
    a unit has S k-slices of L values: S = 8, or 16 where fewer than 32
    units (padded to whole warps) would leave a CTA under 256 threads; with
    4 or 8, a warp (S = 32 slices) sums for that many. A CTA keeps its weight slice
    (w_per_k L threads floats), the vector's two buffers [2][R][S L + 4]
    and the operand ring [CLUSTER_RING][max(R unit_block / S, 1)][threads]
    [ring_floats] in shared memory, then the two buffers' mbarriers. (C, R)
    is the first of `preference` (each kernel's order, measured on an H100:
    PERF.md), then of the other shapes, whose CTA fits (shared memory,
    CLUSTER_THREADS) and whose clusters all fit the card at once
    (ceil(B / R) C <= NUM_SMS), else the first that fits; `cluster_size`
    and `rows` narrow the choice to their value and raise if nothing
    fits."""
    if cluster_size is not None and cluster_size not in (1, 2, 4, 8):
        raise ValueError(f"{who}: cluster_size {cluster_size} not in 1, 2, 4, 8")
    if rows is not None and rows not in CLUSTER_ROWS:
        raise ValueError(f"{who}: rows_per_cluster {rows} not in {CLUSTER_ROWS}")

    def layout(C, R):
        U = -(-H // C)
        if unit_block > 1:
            S, threads = 32, 32 * -(-U // unit_block)
        else:
            S = 8 if 4 * -(-U // 4) >= 32 else 16
            threads = S * (4 * -(-U // 4) if S == 8 else 2 * -(-U // 2))
        L = _slice_len(K, S)
        ring = CLUSTER_RING * max(R * unit_block // S, 1) * threads * ring_floats
        smem = (w_per_k * L * threads + 2 * R * (S * L + 4) + ring) * 4 + 16  # 2 mbarriers
        return {"design": "cluster", "cluster_size": C, "rows_per_cluster": R,
                "clusters": -(-B // R), "grid": -(-B // R) * C, "threads": threads,
                "units_per_cta": U, "k_slices": S, "k_slice": L, "smem_bytes": smem}

    shapes = list(preference) + [(c, r) for c in (1, 2, 4, 8) for r in CLUSTER_ROWS
                                 if (c, r) not in preference]
    cands = [(c, r) for c, r in shapes if cluster_size in (None, c) and rows in (None, r)]
    fitting = [cfg for cfg in (layout(c, r) for c, r in cands)
               if cfg["smem_bytes"] <= SMEM_LIMIT and cfg["threads"] <= CLUSTER_THREADS]
    if not fitting:
        cfg = layout(*cands[0])
        raise ValueError(
            f"{who}: a CTA of a {cfg['cluster_size']}-CTA cluster needs {cfg['smem_bytes']} "
            f"bytes of shared memory and {cfg['threads']} threads, over the {SMEM_LIMIT} and "
            f"{CLUSTER_THREADS} it can have (H={H}, {cfg['rows_per_cluster']} rows a cluster)")
    return next((cfg for cfg in fitting if cfg["grid"] <= NUM_SMS), fitting[0])


def launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype,
                  rows_per_cluster: Optional[int] = None,
                  cluster_size: Optional[int] = None) -> Dict:
    """Design, grid, block and shared-memory layout for one forward launch;
    ValueError for a shape the kernels cannot take.

    bf16 ("mma.sync"): the projection (`xproj_config`, a plan of its own),
    then the scan: 8 batch rows a block, the N of each mma (one n8 tile),
    Hp = 16 ceil(H / 16) and Hp / 16 warps, W_h^T's fragments in registers,
    and the h double buffer [2][Hp][8] bf16 (unit-major) in shared memory, up to
    Hp = WH_REG_LIMIT. The latency of a step binds, and it grows with the
    rows a block computes: an H100 sweep at B=64 and 128, T=200, D=H=128
    and at B=256, T=50, D=H=100 found 8 rows 1.5-1.8x faster than 16
    (PERF.md), so the design has no other choice; `rows_per_cluster` and
    `cluster_size` are the f32 design's alone. Above Hp = WH_REG_LIMIT
    (`layout` "cluster"): the 8 rows go to a cluster of WIDE_CLUSTER CTAs
    of WIDE_THREADS threads, units and k padded to WIDE, each CTA WIDE /
    WIDE_CLUSTER units of all three gates with their W_h^T fragments in
    registers (two warps a 16-unit tile, each over half of K, the halves
    added through shared memory), h^T's two buffers [2][WIDE][8] bf16 and
    two mbarriers.

    f32 ("cluster"): the projection (`xproj_f32_config`, a plan of its own:
    f32 FMAs fed by TMA), then the recurrence on thread block clusters
    (`cluster_config` with K = H and three gates' weights a thread, in
    GRU_CLUSTERS' order): a cluster of `cluster_size` CTAs owns
    `rows_per_cluster` batch rows, each CTA ceil(H / C) units with their
    W_h columns in its shared memory, and in registers (`w_in_regs`) where
    a thread's slice is GRU_REG_SLICE values with 8 slices a unit and up to
    8 rows (H = 128 on 4 CTAs, H = 100 on 2), so that a step reads only h
    from shared memory. Its step is latency (the exchange, the gate math),
    then one CTA's FMAs and shared-memory reads for its rows and units: 4
    rows a cluster and 4 CTAs were fastest at B=64 and 128, D=H=128; at
    B=256 that is 256 CTAs, two waves, and 2 CTAs win.

    Above MAX_HIDDEN, either dtype (`layout` "grid", `grid_config`): the
    projection as above, then the grid-persistent recurrence, up to
    `grid_max_hidden(dtype)`; past it the projection, then the stepped
    layout (`stepped_config`). ValueError only for an empty shape, another
    dtype, or H or D not a multiple of 4 (`padded_launch_config`)."""
    es = _check_dims(B, T, H, dtype)
    if D <= 0 or D % 4 != 0:  # rows of x copied in 8- or 16-byte pieces
        raise ValueError(f"gru: needs D*{es} % {4 * es} == 0 (D={D}, H={H}; the public entry "
                         f"points pad it)")
    if H > MAX_HIDDEN:
        not_cluster(rows_per_cluster, cluster_size, H)
        if H > grid_max_hidden(dtype):
            return stepped_config(B, T, H, dtype, 3, reverse=False)
        return grid_config(B, H, dtype, reverse=False)
    if dtype == torch.bfloat16:
        if rows_per_cluster is not None or cluster_size is not None:
            raise ValueError(f"gru: rows_per_cluster and cluster_size are the f32 design's; "
                             f"bf16 takes {MMA_ROWS} rows a block")
        R = MMA_ROWS
        hp = 16 * -(-H // 16)
        if hp > WH_REG_LIMIT:
            return {**_wide_layout(B, hp), "k_split": 2, "wh_in_regs": 1,
                    "smem_bytes": _wide_forward_smem()}
        return {
            "design": "mma.sync",
            "grid": -(-B // R),
            "threads": 2 * hp,
            "rows_per_block": R,
            "hidden_padded": hp,
            "wh_in_regs": int(hp <= WH_REG_LIMIT),
            "smem_bytes": 2 * R * hp * 2,
        }
    cfg = cluster_config(B, H, H, 3, 4, cluster_size, rows_per_cluster, GRU_CLUSTERS, "gru")
    w_in_regs = cfg["k_slice"] == GRU_REG_SLICE and cfg["k_slices"] == 8 and \
        cfg["rows_per_cluster"] <= 8
    return {**cfg, "w_in_regs": int(w_in_regs)}


def padded_route(config, B: int, T: int, D: int, H: int, dtype: torch.dtype) -> Dict:
    """A forward's launch at any D and H: `config` (a module's launch_config)
    of the shape the public entry points pad it to (`padded_width`), with
    `route` "padded" where that differs from (D, H)."""
    Dp, Hp = padded_width(D), padded_width(H)
    cfg = config(B, T, Dp, Hp, dtype)
    if (Dp, Hp) == (D, H):
        return cfg
    return {**cfg, "route": "padded", "padded_from": [D, H], "padded_to": [Dp, Hp]}


def padded_launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype) -> Dict:
    """The GRU forward's launch at any D and H (`padded_route`)."""
    return padded_route(launch_config, B, T, D, H, dtype)


def padded_backward_route(config, B: int, T: int, H: int, dtype: torch.dtype, **kw) -> Dict:
    """A reverse recurrence's launch at any H: `config` (a module's
    backward_launch_config) of the width the wrapper pads H to, with `route`
    "padded" where that differs from H."""
    Hp = padded_width(H)
    cfg = config(B, T, Hp, dtype, **kw)
    return cfg if Hp == H else {**cfg, "route": "padded", "padded_from": H, "padded_to": Hp}


def padded_backward_launch_config(B: int, T: int, H: int, dtype: torch.dtype, **kw) -> Dict:
    """The GRU reverse recurrence's launch at any H (`padded_backward_route`)."""
    return padded_backward_route(backward_launch_config, B, T, H, dtype, **kw)


def _wide_layout(B: int, hp: int) -> Dict:
    """What the bf16 cluster layouts share: a cluster of WIDE_CLUSTER CTAs a
    block of MMA_ROWS rows, WIDE / WIDE_CLUSTER units a CTA."""
    clusters = -(-B // MMA_ROWS)
    return {"design": "mma.sync", "layout": "cluster", "cluster_size": WIDE_CLUSTER,
            "clusters": clusters, "grid": clusters * WIDE_CLUSTER, "threads": WIDE_THREADS,
            "rows_per_block": MMA_ROWS, "hidden_padded": hp, "width_padded": WIDE,
            "units_per_cta": WIDE // WIDE_CLUSTER}


def _wide_forward_smem() -> int:
    """kWideFwdSmem in csrc/gru.cu: h^T's buffers [2][WIDE][8] bf16, the K
    halves' partial sums [4 tiles][2][6][32] f32 and two mbarriers."""
    return 2 * WIDE * MMA_ROWS * 2 + 4 * 2 * 6 * 32 * 4 + 16


def _ring_stage(width: int, h_in_bytes: int) -> int:
    """One ring stage of the bf16 reverse recurrences: the two projections'
    six gate blocks [6][8][width + 4] f32, h_in [8][width + 4] f32 or
    [8][width + 8] bf16 and g_ys [8][width + 8] bf16."""
    h_row = width + 4 if h_in_bytes == 4 else width + 8
    return (6 * MMA_ROWS * (width + 4) * 4 + MMA_ROWS * h_row * h_in_bytes
            + MMA_ROWS * (width + 8) * 2)


def _backward_smem(hp: int, h_in_bytes: int) -> int:
    """BwdSmem in csrc/gru.cu: the d_hproj^T double buffer [2][hi, lo][3 Hp][8]
    bf16, then RING_STAGES stages (`_ring_stage`, Hp wide)."""
    return 2 * 2 * 3 * hp * MMA_ROWS * 2 + RING_STAGES * _ring_stage(hp, h_in_bytes)


def _wide_backward_smem(h_in_bytes: int) -> int:
    """WideBwdSmem in csrc/gru.cu, U = WIDE / WIDE_CLUSTER: d_hproj^T of the
    CTA's gate columns [hi, lo][3 U][8] bf16, the partial sums
    [2][WIDE_CLUSTER][U][8] f32, RING_STAGES stages (`_ring_stage`, U wide)
    and two mbarriers."""
    U = WIDE // WIDE_CLUSTER
    return (2 * 3 * U * MMA_ROWS * 2 + 2 * WIDE * MMA_ROWS * 4
            + RING_STAGES * _ring_stage(U, h_in_bytes) + 16)


def backward_launch_config(B: int, T: int, H: int, dtype: torch.dtype,
                           rows_per_cluster: Optional[int] = None,
                           cluster_size: Optional[int] = None,
                           h_in_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Layout of one reverse-recurrence launch; `dtype` is W_h's.

    bf16 ("mma.sync"): the forward's blocks of 8 rows and padding (Hp = 16
    ceil(H / 16), Hp / 16 warps, each its own m16 tile of units over all of
    K = 3 Hp, the gate columns), up to Hp = WH_REG_LIMIT: W_h's fragments
    in registers; in shared memory the d_hproj^T double buffer
    [2][hi, lo][3 Hp][8] bf16 and a ring of RING_STAGES stages of the
    step's two projections (the gates are recomputed from them a step
    ahead), h_in (in `h_in_dtype`: bf16, or f32 on the keep path) and g_ys,
    which cp.async fills two steps ahead of their use. d_hproj goes to the
    tensor cores as two bf16 terms (`d_terms`). `rows_per_cluster` and
    `cluster_size` are the f32 design's alone. Above Hp = WH_REG_LIMIT
    (`layout` "cluster"): a cluster of WIDE_CLUSTER CTAs of WIDE_THREADS
    threads, K split between them: each CTA computes the cotangents of its
    U = WIDE / WIDE_CLUSTER units and multiplies W_h's rows of all WIDE
    units over its own 3 U gate columns (8 warps, two 16-unit tiles each,
    every fragment in registers), the partial sums of dh_prev going to the
    units' owners; its ring holds only its units' operands.

    f32 ("cluster"): thread block clusters (`cluster_config` with K = 3H,
    the step's d_hproj, in GRU_BWD_CLUSTERS' order; at H=256 W_h's rows of
    a quarter of the units do not fit beside the ring, so C = 8): a cluster
    of `cluster_size` CTAs owns `rows_per_cluster` batch rows, each CTA
    ceil(H / C) units with their W_h rows in its shared memory, the d_hproj
    double buffer and a ring of each (unit, row) pair's step operands (the
    two projections' three gates, h_in, g_y and keep: BWD_OPERANDS floats).
    A warp sums for BWD_UNITS units, its 32 lanes each over a slice of the
    3H columns.

    Above MAX_HIDDEN, either dtype (`layout` "grid", `grid_config`): the
    grid-persistent reverse recurrence, K split by phases: each CTA
    publishes its units' d_hproj columns, then (after the grid barrier)
    reads the whole d_hproj of its rows and forms dh_prev for its units;
    past `grid_max_hidden(dtype)` the stepped layout (`stepped_config`)."""
    _check_dims(B, T, H, dtype)
    if dtype == torch.bfloat16 and h_in_dtype not in _DTYPE_CODE:
        raise ValueError(f"gru backward: h_in dtype {h_in_dtype} not in float32/bfloat16")
    if H > MAX_HIDDEN:
        not_cluster(rows_per_cluster, cluster_size, H)
        if H > grid_max_hidden(dtype):
            return stepped_config(B, T, H, dtype, 3, reverse=True)
        cfg = grid_config(B, H, dtype, reverse=True)
        return {**cfg, "d_terms": 2} if dtype == torch.bfloat16 else cfg
    if dtype == torch.bfloat16:
        if rows_per_cluster is not None or cluster_size is not None:
            raise ValueError(f"gru: rows_per_cluster and cluster_size are the f32 design's; "
                             f"bf16 takes {MMA_ROWS} rows a block")
        hp = 16 * -(-H // 16)
        h_bytes = torch.empty((), dtype=h_in_dtype).element_size()
        if hp > WH_REG_LIMIT:
            return {**_wide_layout(B, hp), "w_in_regs": 1, "d_terms": 2,
                    "smem_bytes": _wide_backward_smem(h_bytes)}
        return {
            "design": "mma.sync",
            "grid": -(-B // MMA_ROWS),
            "threads": 2 * hp,
            "rows_per_block": MMA_ROWS,
            "hidden_padded": hp,
            "w_in_regs": int(hp <= WH_REG_LIMIT),
            "d_terms": 2,
            "smem_bytes": _backward_smem(hp, h_bytes),
        }
    return cluster_config(B, H, 3 * H, BWD_UNITS, BWD_OPERANDS, cluster_size, rows_per_cluster,
                          GRU_BWD_CLUSTERS, "gru backward", unit_block=BWD_UNITS)


# mma.sync.m16n8k16's A fragment (PTX ISA, "Matrix Fragments for
# mma.m16n8k16"), for a row index 16 tile + 8 mh + g and a column index
# 16 st + 8 kh + 2 q + pair: lane 4 g + q holds registers a0 = (mh 0, kh 0),
# a1 = (1, 0), a2 = (0, 1), a3 = (1, 1), two bf16 each, the lower column
# first; so its fragment is 16 contiguous bytes, [kh][mh][pair], one read.


def backward_fragments(w_h: torch.Tensor) -> torch.Tensor:
    """W_h [H, 3H] -> [Hp/16, 3 Hp/16, 32, 8] bf16 (Hp = 16 ceil(H / 16)):
    the bf16 reverse recurrence's A operand, W_h with each gate's columns
    padded to Hp (A[unit][q Hp + j] = W_h[unit, q H + j], zero past H), as
    fragments [tile (warp)][k-step][lane]. One copy."""
    H = w_h.shape[0]
    hp = 16 * -(-H // 16)
    mt = hp // 16
    w = w_h.to(torch.bfloat16).reshape(H, 3, H)  # unit, gate, column
    if hp != H:
        w = torch.nn.functional.pad(w, (0, hp - H, 0, 0, 0, hp - H))
    w = w.reshape(mt, 2, 8, 3 * mt, 2, 4, 2)  # tile, mh, g, st, kh, q, pair
    return w.permute(0, 3, 2, 5, 4, 1, 6).reshape(mt, 3 * mt, 32, 8)


def forward_fragments(w_h: torch.Tensor) -> torch.Tensor:
    """W_h [H, 3H] -> [16, 16, 3, 32, 8] bf16: the bf16 cluster forward's A
    operand, W_h^T of each gate (A_q[unit][k] = W_h[k, q H + unit]) with
    units and k padded to WIDE (zero past H), as fragments [16-unit tile]
    [k-step][gate][lane]: a lane reads a fragment in one 16-byte load. One
    copy."""
    H = w_h.shape[0]
    w = w_h.to(torch.bfloat16).reshape(H, 3, H)  # k, gate, unit
    w = torch.nn.functional.pad(w, (0, WIDE - H, 0, 0, 0, WIDE - H))
    a = w.permute(1, 2, 0)  # gate, unit, k
    a = a.reshape(3, WIDE // 16, 2, 8, WIDE // 16, 2, 4, 2)  # gate, tile, mh, g, st, kh, q, pair
    return a.permute(1, 4, 0, 3, 6, 5, 2, 7).reshape(WIDE // 16, WIDE // 16, 3, 32, 8)


def wide_backward_fragments(w_h: torch.Tensor) -> torch.Tensor:
    """W_h [H, 3H] -> [C, 16, 3 U / 16, 32, 8] bf16 (C = WIDE_CLUSTER,
    U = WIDE / C): the bf16 cluster reverse recurrence's A operand. CTA c
    multiplies W_h's rows of all WIDE units over its own gate columns, local
    column q U + j being W_h's q H + c U + j (zero past H, and rows past H),
    as fragments [CTA][16-unit tile][k-step][lane]. One copy."""
    H = w_h.shape[0]
    C, U = WIDE_CLUSTER, WIDE // WIDE_CLUSTER
    w = w_h.to(torch.bfloat16).reshape(H, 3, H)  # unit, gate, column
    w = torch.nn.functional.pad(w, (0, WIDE - H, 0, 0, 0, WIDE - H))
    w = w.reshape(WIDE, 3, C, U).permute(2, 0, 1, 3)  # CTA, unit, gate, column
    ks = 3 * U // 16
    w = w.reshape(C, WIDE // 16, 2, 8, ks, 2, 4, 2)  # CTA, tile, mh, g, st, kh, q, pair
    return w.permute(0, 1, 4, 3, 6, 5, 2, 7).reshape(C, WIDE // 16, ks, 32, 8)


def grid_pack(w_h: torch.Tensor, dtype: torch.dtype, reverse: bool) -> torch.Tensor:
    """W_h [H, G H] (G = 3 gates: the GRU's; 4: the LSTM's) -> the grid
    layout's packed weights (csrc/gru.cu, csrc/lstm.cu), one slice of
    GRID_UNITS units a CTA, zero past H. One copy.

    bf16, A fragments of mma.sync.m16n8k16 with K permuted so that lane
    (g, q) of k-steps 2c, 2c + 1 covers k = 32 c + 8 q .. + 7 (its one
    16-byte read of a B row): register 2 kh + mh of k-step 2 c + kk holds
    units 16 tile + 8 mh + g at k = 32 c + 8 q + 4 kk + 2 kh (+ 1).
    Forward: A = W_h^T of each gate, [tiles][Kp/16][G][32][8]; reverse:
    A[unit][q Kp + j] = W_h[unit, q H + j], [tiles][G Kp/16][32][8].
    f32 forward, float4s of 4 consecutive k (the step product's, csrc/rnn.cuh
    grid_f32_product): [tiles][Kp/4][G gates][8 units][4] of W_h[4 kk + e,
    q H + unit]; reverse, the values a lane's float4 k = 128 j + 4 lane
    reads: [tiles][G Kp/128][8 units][32][4] of W_h[unit, column]."""
    H = w_h.shape[0]
    G = w_h.shape[1] // H
    units, kp = GRID_UNITS[dtype], _grid_kpad(H, dtype)
    tiles = -(-H // units)
    w = w_h.to(dtype).reshape(H, G, H)
    pad = torch.nn.functional.pad
    if dtype == torch.bfloat16:
        if reverse:  # unit, gate, column
            a = pad(w, (0, kp - H, 0, 0, 0, units * tiles - H))
            a = a.reshape(tiles, 2, 8, G * kp // 32, 4, 2, 2, 2)  # tile mh g c q kk kh pair
            return a.permute(0, 3, 5, 2, 4, 6, 1, 7).reshape(tiles, G * kp // 16, 32, 8).contiguous()
        a = pad(w.permute(1, 2, 0), (0, kp - H, 0, units * tiles - H))  # gate, unit, k
        a = a.reshape(G, tiles, 2, 8, kp // 32, 4, 2, 2, 2)  # gate tile mh g c q kk kh pair
        return a.permute(1, 4, 6, 0, 3, 5, 7, 2, 8).reshape(tiles, kp // 16, G, 32, 8).contiguous()
    if reverse:  # unit, gate, column
        a = pad(w, (0, kp - H, 0, 0, 0, units * tiles - H)).reshape(tiles, 8, G * kp // 128, 32, 4)
        return a.permute(0, 2, 1, 3, 4).contiguous()
    a = pad(w, (0, units * tiles - H, 0, 0, 0, kp - H))  # k, gate, unit
    a = a.reshape(kp // 4, 4, G, tiles, 8)  # kk e gate tile unit
    return a.permute(3, 0, 2, 4, 1).contiguous()


def _check_operands(args, dev) -> None:
    for a in args:
        if a.device != dev:
            raise ValueError(f"gru: operand on {a.device}, expected {dev}")
        if a.data_ptr() % 16 != 0:
            raise ValueError("gru: operands must be 16-byte aligned")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.seqrec_gru_error_string(rc).decode()
        raise RuntimeError(f"gru {what} kernel launch failed: CUDA error {rc} ({msg})")


def _keep_plane(keep: Optional[torch.Tensor], B: int, T: int) -> Optional[torch.Tensor]:
    """The [B, T] f32 keep plane (1 - reset) the kernels read, from a [B, T]
    or [B, T, 1] one; None stays None (the no-reset variant)."""
    if keep is None:
        return None
    if keep.numel() != B * T or keep.shape[:2] != (B, T):
        raise ValueError(f"gru: keep plane {tuple(keep.shape)}, expected {(B, T)}")
    return keep.reshape(B, T).float().contiguous()


def plain_input_projection(x: torch.Tensor, w_x: torch.Tensor,
                           b_x: torch.Tensor) -> torch.Tensor:
    """x @ W_x + b_x in f32: products of the working dtype summed in f32."""
    return torch.matmul(x.float(), w_x.float()) + b_x.float()


def gru_input_projection(x: torch.Tensor, w_x: torch.Tensor,
                         b_x: torch.Tensor) -> torch.Tensor:
    """The forward's input projection x [..., D] @ w_x [D, N] + b_x [N] ->
    f32 [..., N] (N = 3H): the part of `_gru_step_body`'s step that does not
    depend on h (`xp`, gru.py:110-113), for every step at once. x and w_x
    bf16: the wgmma GEMM planned by `xproj_config` (`seqrec_gru_xproj`,
    counted by `.launches`); f32: the FMA GEMM planned by `xproj_f32_config`,
    f32 products, no TF32 (`seqrec_gru_xproj_f32`, counted by
    `.f32_launches`). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return plain_input_projection(x, w_x, b_x)
    if x.device.type != "cuda":
        raise ValueError(f"gru: no kernel for device {x.device}")
    D = x.shape[-1]
    N = w_x.shape[-1]
    if x.dtype != w_x.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"gru: the input projection kernels take bf16 or f32 x and w_x of "
                         f"one dtype, got {x.dtype}, {w_x.dtype}")
    if tuple(w_x.shape) != (D, N) or tuple(b_x.shape) != (N,):
        raise ValueError(f"gru: input projection needs x [..., D], w_x [D, N], b_x [N]; got "
                         f"{tuple(x.shape)}, {tuple(w_x.shape)}, {tuple(b_x.shape)}")
    if D % 4 or N % 4:  # zero rows and columns to multiples of 4: exact zeros in every sum
        Dp, Np = padded_width(D), padded_width(N)
        pad = torch.nn.functional.pad
        xp = gru_input_projection(pad(x, (0, Dp - D)), pad(w_x, (0, Np - N, 0, Dp - D)),
                                  pad(b_x, (0, Np - N)))
        return xp[..., :N]
    args = [x.contiguous(), w_x.contiguous(), b_x.float().contiguous()]
    _check_operands(args, x.device)
    xp = torch.empty((*x.shape[:-1], N), dtype=torch.float32, device=x.device)
    M = xp.numel() // N
    if M == 0:
        return xp
    lib = _lib()
    f32 = x.dtype == torch.float32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in args] + [xp.data_ptr()]
        rc = (lib.seqrec_gru_xproj_f32(*ptrs, M, D, N, *xproj_f32_plan_args(M, D, N), stream)
              if f32 else
              lib.seqrec_gru_xproj(*ptrs, M, D, N, *xproj_plan_args(M, D, N), stream))
    _raise_on(rc, lib, "input projection")
    if f32:
        gru_input_projection.f32_launches += 1
    else:
        gru_input_projection.launches += 1
    return xp


gru_input_projection.launches = 0
gru_input_projection.f32_launches = 0


def _step_gemm_dims(a: torch.Tensor, w: torch.Tensor, terms: int) -> Tuple[int, int, int]:
    """(M, K, N) of a step GEMM's operands: terms 1 a [M, K], w [K, N];
    terms 2 a [M, 2K], w [N, K]; ValueError where they do not fit."""
    if a.dim() != 2 or w.dim() != 2 or terms not in (1, 2):
        raise ValueError(f"step gemm: a and w must be matrices and terms 1 or 2, got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}, terms={terms}")
    M = a.shape[0]
    N, K = w.shape if terms == 2 else w.shape[::-1]
    if a.shape[1] != terms * K:
        raise ValueError(f"step gemm: a {tuple(a.shape)} does not fit w {tuple(w.shape)} with "
                         f"{terms} terms")
    return M, K, N


def plain_step_gemm(a: torch.Tensor, w: torch.Tensor, terms: int) -> torch.Tensor:
    """The step GEMM's partial planes [splits, M, N] f32 in plain PyTorch
    (`step_gemm_config`'s split): plane s holds the products of K's chunks
    [s per, (s + 1) per), the values multiplied in f32; terms 2: a = [hi |
    lo], w [N, K], hi @ w^T + lo @ w^T."""
    M, K, N = _step_gemm_dims(a, w, terms)
    cfg = step_gemm_config(M, K, N, terms)
    per = cfg["chunks_per_split"] * cfg["block"][2]
    af, wk = a.float(), (w.float().t() if terms == 2 else w.float())
    parts = []
    for k0 in range(0, per * cfg["splits"], per):
        k1 = min(K, k0 + per)
        p = af[:, k0:k1] @ wk[k0:k1]
        if terms == 2:
            p = p + af[:, K + k0:K + k1] @ wk[k0:k1]
        parts.append(p)
    return torch.stack(parts)


def step_product(parts: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What a stepped gate kernel reads of the step GEMM's partial planes
    [splits, M, N] (rnn::step_product): their sum in split order, then the
    bias (the GRU forward's b_h) where there is one."""
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    return v if bias is None else v + bias


def step_gemm(a: torch.Tensor, w: torch.Tensor, terms: int) -> torch.Tensor:
    """The stepped layouts' bf16 step GEMM alone (csrc/step_gemm.cuh): its
    partial planes [splits, M, N] f32 (`step_gemm_config`) of a @ w (terms 1:
    a [M, K] @ w [K, N]) or of the reverse's hi @ w^T + lo @ w^T (terms 2:
    a [M, 2K] = [hi | lo], w [N, K]), both bf16; `step_product` sums them
    as the gate kernels do. Counted by `.launches` (terms 1) and
    `.reverse_launches` (terms 2); the scans past the grid limit launch it
    inside their C loops, once a step, and add T to the count of its
    direction a bf16 stepped scan. A CPU tensor takes the plain version
    (`plain_step_gemm`); a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return plain_step_gemm(a, w, terms)
    if a.device.type != "cuda":
        raise ValueError(f"step gemm: no kernel for device {a.device}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"step gemm: the kernel takes bf16 a and w, got {a.dtype}, {w.dtype}")
    M, K, N = _step_gemm_dims(a, w, terms)
    cfg = step_gemm_config(M, K, N, terms)
    out = torch.empty((cfg["splits"], M, N), dtype=torch.float32, device=a.device)
    args = [a.contiguous(), w.contiguous()]
    _check_operands(args + [out], a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.seqrec_step_gemm(args[0].data_ptr(), args[1].data_ptr(), out.data_ptr(), M, K, N,
                                  terms, cfg["splits"], cfg["block"][0], cfg["workspace_bytes"],
                                  torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, "step gemm")
    if terms == 1:
        step_gemm.launches += 1
    else:
        step_gemm.reverse_launches += 1
    return out


step_gemm.launches = 0  # the forward's (terms 1): alone, and T a bf16 stepped forward scan
step_gemm.reverse_launches = 0  # the reverse's (terms 2): alone, and T a bf16 stepped reverse


def plain_step_gemm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 step GEMM's partial planes [splits, M, N] in plain PyTorch
    (`step_gemm_f32_config`'s split): plane s holds a @ w over K's chunks
    [s per, (s + 1) per), in f32."""
    M, K, N = _step_gemm_dims(a, w, 1)
    cfg = step_gemm_f32_config(M, K, N)
    per = cfg["chunks_per_split"] * cfg["block"][2]
    af, wf = a.float(), w.float()
    return torch.stack([af[:, k0:k0 + per] @ wf[k0:k0 + per]
                        for k0 in range(0, per * cfg["splits"], per)])


def step_gemm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 stepped layouts' step GEMM alone (csrc/fma_gemm.cuh): its
    partial planes [splits, M, N] f32 (`step_gemm_f32_config`) of a [M, K] @
    w [K, N], both f32; `step_product` sums them as the gate kernels do.
    Counted by `.launches`; the f32 scans past the grid limit launch it
    inside their C loops, once a step, and add T to `.launches` (forward,
    h @ W_h) or `.reverse_launches` (d @ W_h^T) a scan. A CPU tensor takes
    the plain version (`plain_step_gemm_f32`); a CUDA tensor launches the
    kernel or raises."""
    if a.device.type == "cpu":
        return plain_step_gemm_f32(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"f32 step gemm: no kernel for device {a.device}")
    if a.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"f32 step gemm: the kernel takes f32 a and w, got {a.dtype}, {w.dtype}")
    M, K, N = _step_gemm_dims(a, w, 1)
    cfg = step_gemm_f32_config(M, K, N)
    out = torch.empty((cfg["splits"], M, N), dtype=torch.float32, device=a.device)
    args = [a.contiguous(), w.contiguous()]
    _check_operands(args + [out], a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.seqrec_step_gemm_f32(args[0].data_ptr(), args[1].data_ptr(), out.data_ptr(), M,
                                      K, N, cfg["splits"], cfg["block"][0],
                                      cfg["workspace_bytes"],
                                      torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, "f32 step gemm")
    step_gemm_f32.launches += 1
    return out


step_gemm_f32.launches = 0  # h @ W_h: alone, and T an f32 stepped forward scan
step_gemm_f32.reverse_launches = 0  # d @ W_h^T: T an f32 stepped reverse scan


def stepped_workspace(cfg: Dict, dev) -> tuple:
    """A stepped scan's GEMM workspace (`gemm.workspace_bytes` of f32) and
    the C entry point's splits, rows a block and bytes."""
    gemm = cfg["gemm"]
    ws = torch.empty(gemm["workspace_bytes"] // 4, dtype=torch.float32, device=dev)
    return ws, (gemm["splits"], gemm["block"][0], gemm["workspace_bytes"])


def _forward_kernel(x, h0, w_x, w_h, b_x, b_h, keep=None, padded: bool = False) -> torch.Tensor:
    """ys [B, T, H]; every operand already in its kernel dtype; `keep` the
    [B, T] plane 1 - reset (the reset variant) or None; `padded`: the
    operands are the padded route's (counted in `.padded_launches`)."""
    B, T, D = x.shape
    H = h0.shape[-1]
    cfg = launch_config(B, T, D, H, x.dtype)
    dtype, dev = x.dtype, x.device
    keep = _keep_plane(keep, B, T)
    ys = torch.empty((B, T, H), dtype=dtype, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep_ptr = None if keep is None else keep.data_ptr()
    if cfg.get("layout") == "stepped":
        xp = gru_input_projection(x, w_x, b_x)
        h_in = h0 if keep is None else h0.float() * keep[:, :1]  # step 0's h_in
        hbuf = h_in.to(dtype).clone(memory_format=torch.contiguous_format)  # the kernels write it
        hp, gemm = stepped_workspace(cfg, dev)
        args = [xp, hbuf, w_h.contiguous(), b_h.contiguous()]
        _check_operands(args + ([] if keep is None else [keep]) + [hp], dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_forward_stepped(
                *(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), hp.data_ptr(), B, T, H,
                _DTYPE_CODE[dtype], *gemm, stream)
    elif cfg.get("layout") == "grid":
        xp = gru_input_projection(x, w_x, b_x)
        ws = torch.zeros(cfg["workspace_bytes"], dtype=torch.uint8, device=dev)
        args = [xp, h0.contiguous(), grid_pack(w_h, dtype, reverse=False), b_h.contiguous()]
        _check_operands(args + ([] if keep is None else [keep]) + [ws], dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_forward_grid(
                *(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), ws.data_ptr(), B, T, H,
                _DTYPE_CODE[dtype], cfg["row_groups"], cfg["smem_bytes"],
                cfg["workspace_bytes"], stream)
    elif cfg.get("layout") == "cluster":
        xp = gru_input_projection(x, w_x, b_x)
        args = [xp, h0.contiguous(), forward_fragments(w_h), b_h.contiguous()]
        _check_operands(args + ([] if keep is None else [keep]), dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_forward_wide(
                *(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), B, T, H,
                cfg["smem_bytes"], stream)
    elif cfg["design"] == "mma.sync":
        xp = gru_input_projection(x, w_x, b_x)
        args = [xp] + [t.contiguous() for t in (h0, w_h, b_h)]
        _check_operands(args + ([] if keep is None else [keep]), dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_forward_mma(
                *(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), B, T, H,
                cfg["smem_bytes"], stream)
    else:
        xp = gru_input_projection(x, w_x, b_x)
        args = [xp] + [t.contiguous() for t in (h0, w_h, b_h)]
        _check_operands(args + ([] if keep is None else [keep]), dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_forward(
                *(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), B, T, H,
                cfg["rows_per_cluster"], cfg["k_slices"], cfg["cluster_size"],
                cfg["units_per_cta"], cfg["threads"], cfg["w_in_regs"], cfg["smem_bytes"],
                stream)
    _raise_on(rc, lib, "forward")
    if keep is None:
        gru_scan.launches += 1
    else:
        gru_scan.reset_launches += 1
    if cfg.get("layout") == "cluster":
        gru_scan.wide_launches += 1
    elif cfg.get("layout") == "grid":
        gru_scan.grid_launches += 1
    elif cfg.get("layout") == "stepped":
        gru_scan.stepped_launches += 1
        if dtype == torch.bfloat16:
            step_gemm.launches += T
        else:
            step_gemm_f32.launches += T
    if padded:
        gru_scan.padded_launches += 1
    return ys


def gru_backward(x_proj: torch.Tensor, h_proj: torch.Tensor, h_in: torch.Tensor,
                 g_ys: torch.Tensor, w_h: torch.Tensor,
                 keep: Optional[torch.Tensor] = None, *, padded: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse recurrence of the GRU backward with the gate recompute
    folded in -> (d_xp [B,T,3H] f32, dh0 [B,H] f32, dn_r [B,T,H] f32),
    `reference.gru_bwd_fused`'s contract: x_proj, h_proj [B,T,3H] f32 the
    two projections with their biases; with `keep` ([B,T,1] or [B,T],
    1 - reset) the reset variant, dh_prev *= keep[t]. The design follows
    W_h's dtype: bf16 weights (the bf16 model, both variants) run on the
    tensor cores, reading h_in in its own dtype (bf16, or f32 where
    `reference.gru_bwd_project` scaled it by keep) and g_ys in bf16; f32
    weights run on thread block clusters, every operand in f32.
    Any H: H % 4 != 0 is zero-padded (`pad_gates`) and the outputs sliced
    back, counted again in `.padded_launches`; `padded`: the operands
    already are the padded route's (`gru_scan`'s autograd), counted so too.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x_proj.device.type == "cpu":
        return plain_backward(x_proj, h_proj, h_in, g_ys, w_h, keep)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru: no kernel for device {x_proj.device}")
    B, T, H = h_in.shape
    Hp = padded_width(H)
    if Hp != H and tuple(w_h.shape) == (H, 3 * H):
        d_xp, dh0, dn_r = gru_backward(
            pad_gates(x_proj, H, Hp), pad_gates(h_proj, H, Hp), pad_gates(h_in, H, Hp),
            pad_gates(g_ys, H, Hp), pad_gates(pad_gates(w_h, H, Hp), H, Hp, dim=0), keep,
            padded=True)
        return unpad_gates(d_xp, H, Hp), dh0[:, :H], dn_r[..., :H]
    dev = x_proj.device
    cfg = backward_launch_config(B, T, H, w_h.dtype, h_in_dtype=h_in.dtype)
    for name, t, shape in (("x_proj", x_proj, (B, T, 3 * H)), ("h_proj", h_proj, (B, T, 3 * H)),
                           ("g_ys", g_ys, (B, T, H)), ("w_h", w_h, (H, 3 * H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gru backward: {name} {tuple(t.shape)}, expected {shape}")
    keep = _keep_plane(keep, B, T)
    keep_ptr = None if keep is None else keep.data_ptr()
    d_xp = torch.empty((B, T, 3 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dn_r = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if cfg.get("layout") == "stepped":
        bf16 = w_h.dtype == torch.bfloat16
        w = w_h.contiguous() if bf16 else w_h.t().float().contiguous()  # bf16: as stored
        # Scratch: the step's d_hproj (bf16: its hi and lo terms), its product
        # (the step GEMM's partial planes), dh z.
        terms = torch.empty((B, (6 if bf16 else 3) * H), dtype=w_h.dtype, device=dev)
        p, gemm = stepped_workspace(cfg, dev)
        z = torch.empty((B, H), dtype=torch.float32, device=dev)
        args = [x_proj.float().contiguous(), h_proj.float().contiguous(),
                (h_in if bf16 else h_in.float()).contiguous(),
                g_ys.to(w_h.dtype).contiguous(), w]
        _check_operands(args + ([] if keep is None else [keep]), dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_backward_stepped(
                *(a.data_ptr() for a in args), keep_ptr, d_xp.data_ptr(), dn_r.data_ptr(),
                dh0.data_ptr(), terms.data_ptr(), p.data_ptr(), z.data_ptr(), B, T, H,
                _DTYPE_CODE[w_h.dtype], _DTYPE_CODE[args[2].dtype], *gemm, stream)
    elif cfg.get("layout") == "grid":
        bf16 = w_h.dtype == torch.bfloat16
        ws = torch.zeros(cfg["workspace_bytes"], dtype=torch.uint8, device=dev)
        args = [x_proj.float().contiguous(), h_proj.float().contiguous(),
                (h_in if bf16 else h_in.float()).contiguous(),
                g_ys.to(w_h.dtype).contiguous(), grid_pack(w_h, w_h.dtype, reverse=True)]
        _check_operands(args + ([] if keep is None else [keep]) + [ws], dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_backward_grid(
                *(a.data_ptr() for a in args), keep_ptr, d_xp.data_ptr(), dn_r.data_ptr(),
                dh0.data_ptr(), ws.data_ptr(), B, T, H, _DTYPE_CODE[w_h.dtype],
                _DTYPE_CODE[args[2].dtype], cfg["row_groups"], cfg["smem_bytes"],
                cfg["workspace_bytes"], stream)
    elif cfg["design"] == "mma.sync":
        wide = cfg.get("layout") == "cluster"
        frags = wide_backward_fragments(w_h) if wide else backward_fragments(w_h)
        args = [x_proj.float().contiguous(), h_proj.float().contiguous(), h_in.contiguous(),
                g_ys.to(torch.bfloat16).contiguous(), frags]
        _check_operands(args + ([] if keep is None else [keep]), dev)
        ptrs = [a.data_ptr() for a in args] + [keep_ptr, d_xp.data_ptr(), dn_r.data_ptr(),
                                               dh0.data_ptr(), B, T, H, _DTYPE_CODE[h_in.dtype]]
        with torch.cuda.device(dev):
            if wide:
                rc = lib.seqrec_gru_backward_wide(*ptrs, cfg["smem_bytes"], stream)
            else:
                rc = lib.seqrec_gru_backward_mma(*ptrs, cfg["smem_bytes"], stream)
    else:
        args = [t.float().contiguous() for t in (x_proj, h_proj, h_in, g_ys, w_h)]
        _check_operands(args + ([] if keep is None else [keep]), dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_gru_backward(
                *(a.data_ptr() for a in args), keep_ptr, d_xp.data_ptr(), dn_r.data_ptr(),
                dh0.data_ptr(), B, T, H, cfg["rows_per_cluster"], cfg["k_slices"],
                cfg["cluster_size"], cfg["units_per_cta"], cfg["threads"], cfg["smem_bytes"],
                stream)
    _raise_on(rc, lib, "backward")
    if keep is None:
        gru_backward.launches += 1
    else:
        gru_backward.reset_launches += 1
    if cfg.get("layout") == "cluster":
        gru_backward.wide_launches += 1
    elif cfg.get("layout") == "grid":
        gru_backward.grid_launches += 1
    elif cfg.get("layout") == "stepped":
        gru_backward.stepped_launches += 1
        if w_h.dtype == torch.bfloat16:
            step_gemm.reverse_launches += T
        else:
            step_gemm_f32.reverse_launches += T
    if padded:
        gru_backward.padded_launches += 1
    return d_xp, dh0, dn_r


gru_backward.launches = 0
gru_backward.reset_launches = 0
gru_backward.wide_launches = 0
gru_backward.grid_launches = 0
gru_backward.stepped_launches = 0  # the stepped layout past grid_max_hidden (a scan a count)
gru_backward.padded_launches = 0  # launches at H % 4 != 0, zero-padded


class _GRUScan(torch.autograd.Function):
    """ys of (x, h0, w_x, w_h, b_x, b_h), all but the f32 biases already in
    the working dtype; the counterpart of the JAX package's `_gru_core`."""

    @staticmethod
    def forward(ctx, x, h0, w_x, w_h, b_x, b_h, reset, padded=False, h_padded=False):
        if x.device.type == "cpu":
            ys, _ = plain(x, h0, w_x, w_h, b_x, b_h, reset_mask=reset)
        else:
            ys = _forward_kernel(x, h0, w_x, w_h, b_x, b_h,
                                 None if reset is None else 1.0 - reset.float(), padded)
        ctx.save_for_backward(x, ys, h0, w_x, w_h, b_x, b_h, reset)
        ctx.h_padded = h_padded
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        x, ys, h0, w_x, w_h, b_x, b_h, reset = ctx.saved_tensors
        x_proj = plain_input_projection(x, w_x, b_x)
        d_xp, dh0, dW_h, db_h = reference.gru_bwd_math(
            x_proj, ys, h0, w_h, b_h, g_ys, reset,
            scan=functools.partial(gru_backward, padded=ctx.h_padded))
        d_x = torch.matmul(d_xp, w_x.float().T).to(x.dtype)
        dW_x = torch.einsum("btd,btk->dk", x.float(), d_xp)
        db_x = d_xp.sum(dim=(0, 1))
        return (d_x, dh0.to(h0.dtype), dW_x.to(w_x.dtype), dW_h.to(w_h.dtype),
                db_x, db_h, None, None, None)


def gru_scan(
    x: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    w_x: torch.Tensor,  # [D, 3H]
    w_h: torch.Tensor,  # [H, 3H]
    b_x: Optional[torch.Tensor] = None,  # [3H]
    b_h: Optional[torch.Tensor] = None,  # [3H]
    *,
    reset_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over time -> (ys [B, T, H], ys[:, -1]), in x.dtype, differentiable
    in x, h0 and the weights. `reset_mask` [B, T] (1 = zero the state before
    step t) selects the reset variants of both kernels.

    A CPU tensor takes the plain versions (forward and reverse loop); a CUDA
    tensor launches the kernels or raises. On a CUDA tensor, a D or H that
    is not a multiple of 4 takes the padded route (`pad_gates`, exact: see
    the module note), counted again in `.padded_launches`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru: no kernel for device {x.device}")
    B, T, D = x.shape
    H = h0.shape[-1]
    if tuple(w_x.shape) != (D, 3 * H) or tuple(w_h.shape) != (H, 3 * H):
        raise ValueError(
            f"gru: w_x {tuple(w_x.shape)} / w_h {tuple(w_h.shape)} do not "
            f"match D={D}, H={H}"
        )
    dtype = x.dtype
    zeros = torch.zeros(3 * H, dtype=torch.float32, device=x.device)
    args = [x, h0.to(dtype), w_x.to(dtype), w_h.to(dtype),
            zeros if b_x is None else b_x.to(torch.float32),
            zeros if b_h is None else b_h.to(torch.float32)]
    Dp, Hp = padded_width(D), padded_width(H)
    padded = x.device.type == "cuda" and (Dp, Hp) != (D, H)
    if padded:
        x_, (h0_,), w_x_, w_h_, biases = pad_scan_operands(args[0], [args[1]], args[2], args[3],
                                                           args[4:])
        args = [x_, h0_, w_x_, w_h_, *biases]
    ys = _GRUScan.apply(*args, reset_mask, padded, padded and Hp != H)
    if padded:
        ys = ys[..., :H]
    return ys, ys[:, -1]


gru_scan.launches = 0
gru_scan.reset_launches = 0
gru_scan.wide_launches = 0
gru_scan.grid_launches = 0
gru_scan.stepped_launches = 0  # the stepped layout past grid_max_hidden (a scan a count)
gru_scan.padded_launches = 0  # launches at D or H % 4 != 0, zero-padded
