"""LSTM scan kernels (`csrc/lstm.cu`): the forward scan and the reverse
recurrence of its backward, joined by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/lstm.py::lstm_scan` (the TPU kernel
`_lstm_step_body`, `_lstm_step_kernel` :106 and `_lstm_step_kernel_reset`
:112, launched at :153) and its custom VJP `_lstm_core_bwd`, both variants:
without a reset mask, and with one (session-parallel training), where a
keep plane `1 - reset` [B, T] f32 goes to both kernels. The two variants
count their launches apart: `lstm_scan.launches` / `lstm_scan.reset_launches`,
and the same two on `lstm_backward`; each also counts its launches of the
grid layout above H = 256 (either variant, either dtype) in `.grid_launches`.

Above H = 256 (the JAX package's wide LSTM at D = H = 512, benchmarks/
scan_ab.py's wide_lstm_D512) no cluster holds W_h, and both directions in
both dtypes run csrc/lstm.cu's grid-persistent layout (`grid_config`, the
GRU's with four gates): one cooperative launch, each CTA a slice of the
units with their W_h values, all four gates, resident in its shared memory
(`gru.grid_pack`) for a group of batch rows, the step's vector through L2
in a zeroed workspace, one grid barrier a step; a (unit, row) pair's four
gate sums land in one lane, which alone reads and writes its f32 cell in the
workspace (the f32 forward's step is a CTA GEMM that reads h's rows from L2
once a CTA, `gru.grid_f32_plan`). The reverse publishes each step's dz columns, then forms dh_prev
from the whole of it (the K split) with no atomics. Up to
`grid_max_hidden`: 1,792 in bf16, 1,056 in f32. Past it the stepped layout
(`gru.stepped_config` with four gates, `layout` "stepped", counted again in
`.stepped_launches`): each step a GEMM of the step's vector (bf16:
csrc/step_gemm.cuh's, `gru.step_gemm`, its partial planes summed by the gate
kernel, the reverse's dz as two bf16 terms on W_h as stored; f32: csrc/fma_gemm.cuh's,
`gru.step_gemm_f32`, its planes summed the same way) and an elementwise gate kernel (csrc/lstm.cu) that carries c in
f32.

Any H and D: as the GRU's (`gru.pad_gates`), the public entry points
(`lstm_scan`, `lstm_backward`, `lstm_input_projection`) zero-pad H and D to
multiples of 4, each gate block on its own, and slice the outputs back
(counted again in `.padded_launches`). Exact: a padded unit has zero
weights and bias and starts from h = c = 0, so c' = f 0 + i tanh(0) = 0 and
h' = o tanh(0) = 0 at every step, and its cotangents stay 0.

Two hand-written designs chosen by dtype (each computes the whole function
in its own numerics; neither gives way to the other):

- bf16 (`design` "mma.sync", every shipped config), as the GRU's: the input
  projection `x @ W_x + b` does not depend on h, so `lstm_input_projection`
  computes it for all B*T rows first (a hand-written mma.sync GEMM into an
  f32 [B, T, 4H] plane; its own launch counter); the scan then runs only
  `h @ W_h`, transposed (W_h^T h^T) on mma.sync.m16n8k16 with the hidden
  units as M and a block's 8 batch rows as N. H pads to Hp = 16 ceil(H / 16)
  with zero weights; Hp / 16 warps each own 16 units of all four gates, so a
  lane holds the i, f, g and o sums of its own (unit, row) pairs and keeps
  their f32 cells in registers. The reverse recurrence mirrors it
  (dh^T = W_h dz^T, K = 4 Hp), with dz split into two bf16 parts so that
  the product keeps dz's f32 precision. W_h's fragments are packed here
  (`forward_fragments`, `backward_fragments`) and stay in registers up to
  Hp = 128.
- f32 (`design` "cluster", both directions): f32 FMAs on the CUDA cores
  (TF32 tensor cores would keep ~3 digits, not the f32 products of the
  contract), on thread block clusters, as the f32 GRU forward. The forward
  takes the projection off the serial chain as an f32 SIMT GEMM
  (`lstm_input_projection`, its own launch counter `.f32_launches`), then
  the recurrence: a cluster of C CTAs owns R batch rows, each CTA a slice
  of the hidden units with W_h's columns of their four gates resident in
  its shared memory, the owner lane of a (unit, row) pair keeps its f32
  cell in a register, and the new h slices go to every CTA of the cluster
  through distributed shared memory (`st.async`, counted by an mbarrier a
  buffer). The reverse recurrence holds W_h's rows of its units (a warp
  for BWD_UNITS units) and exchanges the step's dz values the same way.

Forward: the kernels also write c_T, and, when autograd will need it, the
f32 cell plane c_1..c_T, so the backward runs no serial `_recompute_cells`
loop on the card. Backward, as `_lstm_core_bwd`: the input projection and
the gates are recomputed with `torch.matmul` in parallel over T
(`reference.lstm_bwd_math`), the reverse recurrence runs in the kernel, and
the input and weight gradients are `torch.matmul`s and sums. The cotangent
of c_T starts the reverse recurrence's dc carry, so c_last is
differentiable. All kernels but the projection are bound by their serial
chain over T; see the source note.

Numerics: forward products and gate math in f32, the bias in f32 (as the
JAX Pallas wrapper adds it), c in f32, h rounded to the working dtype
(x.dtype: float32 or bfloat16) every step, as the TPU kernel does. The JAX
wrapper also upcasts bf16 inputs to f32 at shapes narrower than the TPU's
(8, 128) tiles; that is a TPU tiling choice, and the port runs the kernel in
x.dtype at every shape, as its GRU does. The plain version
(ops/reference.py, the JAX oracle's formula) works in x.dtype throughout,
its cell state included, so in bf16 the two differ by bf16 rounding of the
gates and of c. The backward carries f32 cotangents on both paths, and
weight gradients are rounded to the weights' working dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda.gru import (MMA_ROWS, RING_STAGES, SMEM_LIMIT,
                                           XPROJ_ARGTYPES, XPROJ_F32_ARGTYPES, cluster_config,
                                           grid_forward_layout, grid_layout, grid_pack,
                                           grid_max_hidden as _grid_max_hidden,
                                           not_cluster, pad_gates, pad_scan_operands,
                                           padded_backward_route, padded_route, padded_width,
                                           plain_input_projection, step_gemm, step_gemm_f32,
                                           stepped_config, stepped_workspace, unpad_gates,
                                           xproj_f32_plan_args, xproj_plan_args)
from seqrec_tpu_torch.ops.cuda.gru import _check_dims as _gru_check_dims

plain = reference.lstm_scan
plain_backward = reference.lstm_bwd_scan

MAX_HIDDEN = 256  # kMaxHidden in csrc/lstm.cu: the widest H of the block and cluster layouts
GRID_GATES = 4  # i, f, g, o: the grid layout's W_h values a unit (csrc/lstm.cu, above MAX_HIDDEN)
WH_REG_LIMIT = 128  # Hp up to which the bf16 kernels hold W_h in registers
BWD_UNITS = 4  # kBwdUnits in csrc/lstm.cu: units a warp of the f32 reverse recurrence sums for
# The f32 reverse recurrence's (cluster size, rows a cluster), in the order
# preferred (kernel_probes.py clusters on an H100: 8 rows and 4 CTAs first).
LSTM_CLUSTERS = ((4, 8), (4, 4), (2, 4), (4, 16), (8, 8), (8, 4), (8, 16), (2, 8), (2, 16))
# The f32 forward's, the GRU forward's order: 4 rows a cluster on as many
# CTAs as fit the card (kernel_probes.py clusters on an H100: best at B=64,
# H=128 and B=256, H=100; at B=128, H=128 within 5% of 8 rows on 64 CTAs).
LSTM_FWD_CLUSTERS = ((4, 4), (2, 4), (4, 8), (2, 8), (4, 16), (2, 16), (8, 4), (8, 8), (8, 16))
LSTM_REG_SLICE = 16  # kLstmRegSlice in csrc/lstm.cu: a W_h slice of this length stays in registers
LSTM_REG_THREADS = 256  # kLstmRegThreads: ... in CTAs of up to this many threads
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm")
    fwd = lib.seqrec_lstm_forward
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    proj = lib.seqrec_lstm_xproj_f32
    proj.argtypes = XPROJ_F32_ARGTYPES
    proj.restype = ctypes.c_int
    proj = lib.seqrec_lstm_xproj
    proj.argtypes = XPROJ_ARGTYPES
    proj.restype = ctypes.c_int
    fwd_mma = lib.seqrec_lstm_forward_mma
    fwd_mma.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fwd_mma.restype = ctypes.c_int
    bwd = lib.seqrec_lstm_backward
    bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd.restype = ctypes.c_int
    bwd_mma = lib.seqrec_lstm_backward_mma
    bwd_mma.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd_mma.restype = ctypes.c_int
    fwd_grid = lib.seqrec_lstm_forward_grid
    fwd_grid.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    fwd_grid.restype = ctypes.c_int
    bwd_grid = lib.seqrec_lstm_backward_grid
    bwd_grid.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    bwd_grid.restype = ctypes.c_int
    fwd_step = lib.seqrec_lstm_forward_stepped
    fwd_step.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                                                      ctypes.c_void_p]
    fwd_step.restype = ctypes.c_int
    bwd_step = lib.seqrec_lstm_backward_stepped
    bwd_step.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_longlong,
                                                                       ctypes.c_void_p]
    bwd_step.restype = ctypes.c_int
    lib.seqrec_lstm_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_lstm_error_string.restype = ctypes.c_char_p
    return lib


def _check_dims(B: int, T: int, H: int, dtype: torch.dtype) -> int:
    return _gru_check_dims(B, T, H, dtype, "lstm")


def grid_max_hidden(dtype: torch.dtype) -> int:
    """The widest H (a multiple of 4) of the LSTM's grid layout
    (`gru.grid_max_hidden` with four gates): 1,792 in bf16, where a CTA's
    128 Kp bytes of W_h values reach SMEM_LIMIT; 1,056 in f32, where the
    132 slices of 8 units fill the card's NUM_SMS."""
    return _grid_max_hidden(dtype, GRID_GATES)


def grid_config(B: int, H: int, dtype: torch.dtype, reverse: bool) -> Dict:
    """The grid-persistent layout of csrc/lstm.cu above MAX_HIDDEN
    (`gru.grid_layout` with four gates: a CTA's W_h values are 128 Kp
    bytes; the f32 forward's `gru.grid_forward_layout`, W_h and the step
    product's ring). Its workspace (lstm.cu's grid_workspace): the forward's h
    buffers [2][rows][Kp] of the dtype and the f32 cell plane [rows][Kp];
    the reverse's dz buffers (32 bytes a (row, k): [2][hi, lo][rows][4 Kp]
    bf16 or [2][rows][4 Kp] f32) and the f32 dh and dc carries."""
    if reverse:
        return grid_layout(B, H, dtype, GRID_GATES, 40)
    return grid_forward_layout(B, H, dtype, GRID_GATES, 2 * dtype.itemsize + 4)


def _padded(H: int) -> int:
    """Hp: H padded to whole m16 tiles (mma's M) and k16 steps."""
    return 16 * -(-H // 16)


def _padded_pairs(H: int) -> int:
    """The reverse recurrence's Hp: whole pairs of m16 tiles (its warps
    split K in pairs)."""
    return 32 * -(-H // 32)


def _forward_smem(hp: int) -> int:
    """FwdSmem in csrc/lstm.cu: the h^T double buffer [2][Hp][8] bf16, then
    RING_STAGES stages of xp [8][4 Hp + 4] f32."""
    return 2 * hp * MMA_ROWS * 2 + RING_STAGES * MMA_ROWS * (4 * hp + 4) * 4


def _backward_smem(hp: int) -> int:
    """BwdSmem in csrc/lstm.cu: the dz^T buffer [hi, lo][4 Hp][8] bf16,
    RING_STAGES stages of the six gate planes [6][8][Hp + 4] f32 and g_ys
    [8][Hp + 8] bf16, then the warps' exchanged partial sums [Hp/16][32][4]
    f32."""
    stage = 6 * MMA_ROWS * (hp + 4) * 4 + MMA_ROWS * (hp + 8) * 2
    return 2 * 4 * hp * MMA_ROWS * 2 + RING_STAGES * stage + hp // 16 * 32 * 16


def _mma_rows(rows_per_cluster: Optional[int], cluster_size: Optional[int]) -> int:
    if rows_per_cluster is not None or cluster_size is not None:
        raise ValueError(f"lstm: rows_per_cluster and cluster_size are the f32 design's; "
                         f"bf16 takes {MMA_ROWS} rows a block")
    return MMA_ROWS


def launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype,
                  rows_per_cluster: Optional[int] = None,
                  cluster_size: Optional[int] = None) -> Dict:
    """Design, grid, block and shared-memory layout of one forward launch;
    ValueError for a shape the kernels cannot take.

    bf16 ("mma.sync"): the projection (`gru.xproj_config`, a plan of its
    own), then the scan: 8 batch rows a block (the N of each mma, one n8 tile, as the GRU's
    scan, where 8 rows beat 16 by 1.5-1.8x on an H100), Hp = 16 ceil(H / 16)
    and Hp / 16 warps, W_h^T's fragments in registers up to Hp = 128 (read
    from global memory above); in shared memory the h double buffer
    [2][Hp][8] bf16 and a ring of RING_STAGES xp stages, which cp.async
    fills two steps ahead of their use. `rows_per_cluster` and
    `cluster_size` are the f32 design's alone.

    f32 ("cluster"): the projection (`gru.xproj_f32_config`, a plan of its
    own: f32 FMAs fed by TMA), then the recurrence on thread block clusters
    (`gru.cluster_config` with K = H, four gates' weights a thread and a
    ring of xp's four gates and keep, in LSTM_FWD_CLUSTERS' order: 4 CTAs
    of 4 rows at B=64 and 128, 2 CTAs at B=256, H=100; at H=256 a quarter
    of the units' W_h columns do not fit beside the ring, so C = 8): a
    cluster of `cluster_size` CTAs owns `rows_per_cluster`
    batch rows, each CTA ceil(H / C) units with their W_h columns in its
    shared memory, and in registers (`w_in_regs`) where a thread's slice is
    LSTM_REG_SLICE values with 8 slices a unit, up to 8 rows and
    LSTM_REG_THREADS threads (H = 128 on 4 CTAs).

    Above MAX_HIDDEN, either dtype (`layout` "grid", `grid_config`): the
    projection as above, then the grid-persistent recurrence, up to
    `grid_max_hidden(dtype)`; past it the projection, then the stepped
    layout (`gru.stepped_config` with four gates). ValueError only for an
    empty shape, another dtype, or H or D not a multiple of 4
    (`padded_launch_config`)."""
    es = _check_dims(B, T, H, dtype)
    if D <= 0 or D % 4 != 0:  # x rows in 16-byte (f32) or 8-byte (bf16) pieces
        raise ValueError(f"lstm: needs D*{es} % {4 * es} == 0 (D={D}, H={H}; the public entry "
                         f"points pad it)")
    if H > MAX_HIDDEN:
        not_cluster(rows_per_cluster, cluster_size, H, "lstm")
        if H > grid_max_hidden(dtype):
            return stepped_config(B, T, H, dtype, GRID_GATES, reverse=False)
        return grid_config(B, H, dtype, reverse=False)
    if dtype == torch.bfloat16:
        R = _mma_rows(rows_per_cluster, cluster_size)
        hp = _padded(H)
        return {
            "design": "mma.sync",
            "grid": -(-B // R),
            "threads": 2 * hp,
            "rows_per_block": R,
            "hidden_padded": hp,
            "wh_in_regs": int(hp <= WH_REG_LIMIT),
            "smem_bytes": _forward_smem(hp),
        }
    cfg = cluster_config(B, H, H, 4, 5, cluster_size, rows_per_cluster, LSTM_FWD_CLUSTERS,
                         "lstm")
    w_in_regs = (cfg["k_slice"] == LSTM_REG_SLICE and cfg["k_slices"] == 8
                 and cfg["rows_per_cluster"] <= 8 and cfg["threads"] <= LSTM_REG_THREADS)
    return {**cfg, "w_in_regs": int(w_in_regs)}


def backward_launch_config(B: int, T: int, H: int, dtype: torch.dtype,
                           rows_per_cluster: Optional[int] = None,
                           cluster_size: Optional[int] = None) -> Dict:
    """Layout of one reverse-recurrence launch.

    bf16 ("mma.sync"): the forward's blocks of 8 rows, with H padded to
    whole pairs of m16 tiles (Hp = 32 ceil(H / 32)): K = 4 Hp (the gate
    columns), and the Hp / 16 warps pair up, each warp of a pair computing
    both its tiles over half of K (each reads half of dz^T from shared
    memory a step) and the pair exchanging partial sums. W_h's fragments in
    registers up to Hp = 128; in shared memory the dz^T buffer
    [hi, lo][4 Hp][8] bf16, a ring of RING_STAGES stages of the step's
    gate planes, which cp.async fills two steps ahead of their use, and the
    exchanged sums. dz goes to the tensor cores as two bf16 terms
    (`dz_terms`), hi = bf16(dz) and lo = bf16(dz - hi), so that the product
    keeps the contract's f32 dz. `rows_per_cluster` and `cluster_size` are
    the f32 design's alone.

    f32 ("cluster"): thread block clusters (`gru.cluster_config` with
    K = 4H, the step's dz, in LSTM_CLUSTERS' order; at H=256 W_h's rows of
    a quarter of the units are 256 KB, so C = 8): a cluster of
    `cluster_size` CTAs owns `rows_per_cluster` batch rows, each CTA
    ceil(H / C) units with their W_h rows in its shared memory and the dz
    double buffer. A warp sums for BWD_UNITS units, its 32 lanes each over
    a slice of the 4H columns, so that each dz value read from shared
    memory serves BWD_UNITS units (the step's product reads shared memory,
    not the FMAs, at one unit a thread group).

    Above MAX_HIDDEN, either dtype (`layout` "grid", `grid_config`): the
    grid-persistent reverse recurrence, K split by phases: each CTA
    publishes its units' dz columns (bf16: as `dz_terms` bf16 terms), then
    (after the grid barrier) reads the whole dz of its rows and forms
    dh_prev for its units; past `grid_max_hidden(dtype)` the stepped layout."""
    _check_dims(B, T, H, dtype)
    if H > MAX_HIDDEN:
        not_cluster(rows_per_cluster, cluster_size, H, "lstm")
        if H > grid_max_hidden(dtype):
            return stepped_config(B, T, H, dtype, GRID_GATES, reverse=True)
        cfg = grid_config(B, H, dtype, reverse=True)
        return {**cfg, "dz_terms": 2} if dtype == torch.bfloat16 else cfg
    if dtype == torch.bfloat16:
        R = _mma_rows(rows_per_cluster, cluster_size)
        hp = _padded_pairs(H)
        return {
            "design": "mma.sync",
            "grid": -(-B // R),
            "threads": 2 * hp,
            "rows_per_block": R,
            "hidden_padded": hp,
            "w_in_regs": int(hp <= WH_REG_LIMIT),
            "dz_terms": 2,
            "smem_bytes": _backward_smem(hp),
        }
    return cluster_config(B, H, 4 * H, BWD_UNITS, 8, cluster_size, rows_per_cluster,
                          LSTM_CLUSTERS, "lstm backward", unit_block=BWD_UNITS)


def padded_launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype) -> Dict:
    """The LSTM forward's launch at any D and H (`gru.padded_route`)."""
    return padded_route(launch_config, B, T, D, H, dtype)


def padded_backward_launch_config(B: int, T: int, H: int, dtype: torch.dtype, **kw) -> Dict:
    """The LSTM reverse recurrence's launch at any H (`gru.padded_backward_route`)."""
    return padded_backward_route(backward_launch_config, B, T, H, dtype, **kw)


def _check_operands(args, dev) -> None:
    for a in args:
        if a.device != dev:
            raise ValueError(f"lstm: operand on {a.device}, expected {dev}")
        if a.data_ptr() % 16 != 0:
            raise ValueError("lstm: operands must be 16-byte aligned")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.seqrec_lstm_error_string(rc).decode()
        raise RuntimeError(f"lstm {what} kernel launch failed: CUDA error {rc} ({msg})")


# mma.sync.m16n8k16's A fragment (PTX ISA, "Matrix Fragments for
# mma.m16n8k16"), for a row index 16 tile + 8 mh + g and a column index
# 16 st + 8 kh + 2 q + pair: lane 4 g + q holds registers a0 = (mh 0, kh 0),
# a1 = (1, 0), a2 = (0, 1), a3 = (1, 1), two bf16 each, the lower column
# first; so its fragment is 16 contiguous bytes, [kh][mh][pair], one read.


def forward_fragments(w_h: torch.Tensor) -> torch.Tensor:
    """W_h [H, 4H] -> [Hp/16, Hp/16, 4, 32, 8] bf16: the bf16 forward's A
    operand, W_h^T gate by gate (A_q[unit][k] = W_h[k, q H + unit], zero past
    H), as fragments [warp (tile)][k-step][gate][lane], in one copy."""
    H = w_h.shape[0]
    hp = _padded(H)
    mt = hp // 16
    w = w_h.to(torch.bfloat16).reshape(H, 4, H)  # k, gate, unit
    if hp != H:
        w = torch.nn.functional.pad(w, (0, hp - H, 0, 0, 0, hp - H))
    w = w.reshape(mt, 2, 4, 2, 4, mt, 2, 8)  # st, kh, q, pair, gate, tile, mh, g
    return w.permute(5, 0, 4, 7, 2, 1, 6, 3).reshape(mt, mt, 4, 32, 8)


def backward_fragments(w_h: torch.Tensor) -> torch.Tensor:
    """W_h [H, 4H] -> [Hp/16, 2 Hp/16, 2, 32, 8] bf16 (Hp = 32 ceil(H / 32)):
    the bf16 reverse recurrence's A operand, W_h with each gate's columns
    padded to Hp (A[unit][q Hp + j] = W_h[unit, q H + j], zero past H), as
    fragments [warp][k-step of its half][tile of its pair][lane]: warp
    2 j + h holds m16 tiles 2 j and 2 j + 1 over the k-steps of half h of
    the 4 Hp columns. One copy."""
    H = w_h.shape[0]
    hp = _padded_pairs(H)
    mt = hp // 16
    w = w_h.to(torch.bfloat16).reshape(H, 4, H)  # unit, gate, column
    if hp != H:
        w = torch.nn.functional.pad(w, (0, hp - H, 0, 0, 0, hp - H))
    w = w.reshape(mt // 2, 2, 2, 8, 2, 2 * mt, 2, 4, 2)  # j, i, mh, g, half, st, kh, q, pair
    return w.permute(0, 4, 5, 1, 3, 7, 6, 2, 8).reshape(mt, 2 * mt, 2, 32, 8)


def lstm_input_projection(x: torch.Tensor, w_x: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """The forward's input projection x [..., D] @ w_x [D, 4H] + b [4H] ->
    f32 [..., 4H]: the part of `_lstm_step_body`'s step that does not depend
    on h (lstm.py:89-93), for every step at once. x and w_x bf16: the wgmma
    GEMM planned by `gru.xproj_config` (`seqrec_lstm_xproj`, counted by
    `.launches`); f32: the FMA GEMM planned by `gru.xproj_f32_config`, f32
    products, no TF32 (`seqrec_lstm_xproj_f32`, counted by `.f32_launches`).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return plain_input_projection(x, w_x, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm: no kernel for device {x.device}")
    D, N4 = w_x.shape
    if x.dtype != w_x.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"lstm: the input projection kernels take bf16 or f32 x and w_x of "
                         f"one dtype, got {x.dtype}, {w_x.dtype}")
    if x.shape[-1] != D or tuple(b.shape) != (N4,):
        raise ValueError(f"lstm: input projection needs x [..., D], w_x [D, 4H], b [4H]; got "
                         f"{tuple(x.shape)}, {tuple(w_x.shape)}, {tuple(b.shape)}")
    if D % 4:  # zero rows of W_x and columns of x to a multiple of 4: exact zeros in every sum
        Dp = padded_width(D)
        pad = torch.nn.functional.pad
        return lstm_input_projection(pad(x, (0, Dp - D)), pad(w_x, (0, 0, 0, Dp - D)), b)
    args = [x.contiguous(), w_x.contiguous(), b.float().contiguous()]
    _check_operands(args, x.device)
    xp = torch.empty((*x.shape[:-1], N4), dtype=torch.float32, device=x.device)
    M = xp.numel() // N4
    if M == 0:
        return xp
    lib = _lib()
    f32 = x.dtype == torch.float32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in args] + [xp.data_ptr()]
        rc = (lib.seqrec_lstm_xproj_f32(*ptrs, M, D, N4, *xproj_f32_plan_args(M, D, N4), stream)
              if f32 else
              lib.seqrec_lstm_xproj(*ptrs, M, D, N4, *xproj_plan_args(M, D, N4), stream))
    _raise_on(rc, lib, "input projection")
    if f32:
        lstm_input_projection.f32_launches += 1
    else:
        lstm_input_projection.launches += 1
    return xp


lstm_input_projection.launches = 0
lstm_input_projection.f32_launches = 0


def _keep_plane(keep: Optional[torch.Tensor], B: int, T: int) -> Optional[torch.Tensor]:
    """The [B, T] f32 keep plane (1 - reset) the kernels read, from a [B, T]
    or [B, T, 1] one; None stays None (the no-reset variant)."""
    if keep is None:
        return None
    if keep.numel() != B * T or keep.shape[:2] != (B, T):
        raise ValueError(f"lstm: keep plane {tuple(keep.shape)}, expected {(B, T)}")
    return keep.reshape(B, T).float().contiguous()


def _forward_kernel(x, h0, c0, w_x, w_h, b, with_cells: bool, keep=None,
                    padded: bool = False):
    """(ys [B, T, H] in x.dtype, c_last [B, H] f32, cs [B, T, H] f32 or
    None); every operand already in its kernel dtype; `keep` the [B, T]
    plane 1 - reset (the reset variant) or None; `padded`: the operands are
    the padded route's (counted in `.padded_launches`)."""
    B, T, D = x.shape
    H = h0.shape[-1]
    cfg = launch_config(B, T, D, H, x.dtype)
    dtype, dev = x.dtype, x.device
    keep = _keep_plane(keep, B, T)
    keep_ptr = None if keep is None else keep.data_ptr()
    ys = torch.empty((B, T, H), dtype=dtype, device=dev)
    c_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    cs = torch.empty((B, T, H), dtype=torch.float32, device=dev) if with_cells else None
    cs_ptr = None if cs is None else cs.data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    xp = lstm_input_projection(x, w_x, b)
    if cfg.get("layout") == "stepped":
        h_in = h0 if keep is None else h0.float() * keep[:, :1]  # step 0's h_in
        hbuf = h_in.to(dtype).clone(memory_format=torch.contiguous_format)  # the kernels write it
        c_buf = c0.float().clone(memory_format=torch.contiguous_format)  # c_T after the scan
        hp, gemm = stepped_workspace(cfg, dev)
        args = [xp, hbuf, c_buf, w_h.contiguous()]
        _check_operands(args + ([] if keep is None else [keep]) + [hp], dev)
        with torch.cuda.device(dev):
            rc = lib.seqrec_lstm_forward_stepped(
                *(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), cs_ptr, hp.data_ptr(),
                B, T, H, _DTYPE_CODE[dtype], *gemm, stream)
        _raise_on(rc, lib, "forward")
        if keep is None:
            lstm_scan.launches += 1
        else:
            lstm_scan.reset_launches += 1
        lstm_scan.stepped_launches += 1
        if dtype == torch.bfloat16:
            step_gemm.launches += T
        else:
            step_gemm_f32.launches += T
        if padded:
            lstm_scan.padded_launches += 1
        return ys, c_buf, cs
    grid = cfg.get("layout") == "grid"
    mma = cfg["design"] == "mma.sync"
    if grid:
        w = grid_pack(w_h, dtype, reverse=False)
    else:
        w = forward_fragments(w_h) if mma else w_h
    args = [xp] + [t.contiguous() for t in (h0, c0, w)]
    ws = torch.zeros(cfg["workspace_bytes"], dtype=torch.uint8, device=dev) if grid else None
    _check_operands(args + ([] if keep is None else [keep]) + ([] if ws is None else [ws]), dev)
    ptrs = [*(a.data_ptr() for a in args), keep_ptr, ys.data_ptr(), c_last.data_ptr(), cs_ptr]
    with torch.cuda.device(dev):
        if grid:
            rc = lib.seqrec_lstm_forward_grid(
                *ptrs, ws.data_ptr(), B, T, H, _DTYPE_CODE[dtype], cfg["row_groups"],
                cfg["smem_bytes"], cfg["workspace_bytes"], stream)
        elif mma:
            rc = lib.seqrec_lstm_forward_mma(*ptrs, B, T, H, cfg["smem_bytes"], stream)
        else:
            rc = lib.seqrec_lstm_forward(
                *ptrs, B, T, H, cfg["rows_per_cluster"], cfg["k_slices"], cfg["cluster_size"],
                cfg["units_per_cta"], cfg["threads"], cfg["w_in_regs"], cfg["smem_bytes"],
                stream)
    _raise_on(rc, lib, "forward")
    if keep is None:
        lstm_scan.launches += 1
    else:
        lstm_scan.reset_launches += 1
    if grid:
        lstm_scan.grid_launches += 1
    if padded:
        lstm_scan.padded_launches += 1
    return ys, c_last, cs


def lstm_backward(i: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                  o: torch.Tensor, tanh_c: torch.Tensor, c_in: torch.Tensor,
                  g_ys: torch.Tensor, w_h: torch.Tensor,
                  keep: Optional[torch.Tensor] = None,
                  dc_last: Optional[torch.Tensor] = None, *, padded: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse recurrence of the LSTM backward -> (dz [B,T,4H] f32,
    dh0 [B,H] f32, dc0 [B,H] f32), `reference.lstm_bwd_scan`'s contract;
    with `keep` ([B,T,1] or [B,T], 1 - reset) the reset variant, dh_prev and
    dc_prev *= keep[t] (`c_in` arrives scaled by `reference.lstm_bwd_hoist`).
    The kernel works in g_ys's dtype (that of the forward's h): bf16 on the
    tensor cores, f32 on the CUDA cores. Any H: H % 4 != 0 is zero-padded
    and the outputs sliced back, counted again in `.padded_launches`;
    `padded`: the operands already are the padded route's (`lstm_scan`'s
    autograd), counted so too. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if i.device.type == "cpu":
        return plain_backward(i, f, g, o, tanh_c, c_in, g_ys, w_h, keep, dc_last)
    if i.device.type != "cuda":
        raise ValueError(f"lstm: no kernel for device {i.device}")
    B, T, H = i.shape
    Hp = padded_width(H)
    if Hp != H and tuple(w_h.shape) == (H, 4 * H):  # zero-padded (exact; module note)
        planes = [pad_gates(t, H, Hp) for t in (i, f, g, o, tanh_c, c_in, g_ys)]
        dz, dh0, dc0 = lstm_backward(
            *planes, pad_gates(pad_gates(w_h, H, Hp), H, Hp, dim=0), keep,
            None if dc_last is None else pad_gates(dc_last, H, Hp), padded=True)
        return unpad_gates(dz, H, Hp), dh0[:, :H], dc0[:, :H]
    dtype, dev = g_ys.dtype, i.device
    cfg = backward_launch_config(B, T, H, dtype)
    for name, t in (("f", f), ("g", g), ("o", o), ("tanh_c", tanh_c), ("c_in", c_in),
                    ("g_ys", g_ys)):
        if tuple(t.shape) != (B, T, H):
            raise ValueError(f"lstm backward: {name} {tuple(t.shape)}, expected {(B, T, H)}")
    if tuple(w_h.shape) != (H, 4 * H):
        raise ValueError(f"lstm backward: w_h {tuple(w_h.shape)}, expected {(H, 4 * H)}")
    if dc_last is None:
        dc_last = torch.zeros((B, H), dtype=torch.float32, device=dev)
    keep = _keep_plane(keep, B, T)
    planes = [t.float().contiguous() for t in (i, f, g, o, tanh_c, c_in)]
    grid = cfg.get("layout") == "grid"
    stepped = cfg.get("layout") == "stepped"
    mma = cfg["design"] == "mma.sync"
    if grid:
        w = grid_pack(w_h, dtype, reverse=True)
    elif stepped:  # bf16 W_h as stored (dz's hi and lo terms share its tiles); f32 W_h^T
        w = (w_h.to(dtype).contiguous() if dtype == torch.bfloat16
             else w_h.t().float().contiguous())
    else:
        w = backward_fragments(w_h) if mma else w_h.float().contiguous()
    args = planes + [g_ys.contiguous(), w]
    dc_last = dc_last.float().contiguous()
    ws = torch.zeros(cfg["workspace_bytes"], dtype=torch.uint8, device=dev) if grid else None
    _check_operands(args + [dc_last] + ([] if keep is None else [keep])
                    + ([] if ws is None else [ws]), dev)
    dz = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    ptrs = [*(a.data_ptr() for a in args), None if keep is None else keep.data_ptr(),
            dc_last.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr()]
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if stepped:  # scratch: the step's dz (bf16: hi and lo terms), its product (the
            # step GEMM's partial planes), the dc carry
            terms = torch.empty((B, (8 if dtype == torch.bfloat16 else 4) * H), dtype=dtype,
                                device=dev)
            p, gemm = stepped_workspace(cfg, dev)
            dc = torch.empty((B, H), dtype=torch.float32, device=dev)
            rc = lib.seqrec_lstm_backward_stepped(
                *ptrs, terms.data_ptr(), p.data_ptr(), dc.data_ptr(), B, T, H,
                _DTYPE_CODE[dtype], *gemm, stream)
        elif grid:
            rc = lib.seqrec_lstm_backward_grid(
                *ptrs, ws.data_ptr(), B, T, H, _DTYPE_CODE[dtype], cfg["row_groups"],
                cfg["smem_bytes"], cfg["workspace_bytes"], stream)
        elif mma:
            rc = lib.seqrec_lstm_backward_mma(*ptrs, B, T, H, cfg["smem_bytes"], stream)
        else:
            rc = lib.seqrec_lstm_backward(
                *ptrs, B, T, H, cfg["rows_per_cluster"], cfg["k_slices"], cfg["cluster_size"],
                cfg["units_per_cta"], cfg["threads"], cfg["smem_bytes"], stream)
    _raise_on(rc, lib, "backward")
    if keep is None:
        lstm_backward.launches += 1
    else:
        lstm_backward.reset_launches += 1
    if grid:
        lstm_backward.grid_launches += 1
    elif stepped:
        lstm_backward.stepped_launches += 1
        if dtype == torch.bfloat16:
            step_gemm.reverse_launches += T
        else:
            step_gemm_f32.reverse_launches += T
    if padded:
        lstm_backward.padded_launches += 1
    return dz, dh0, dc0


lstm_backward.launches = 0
lstm_backward.reset_launches = 0
lstm_backward.grid_launches = 0
lstm_backward.stepped_launches = 0  # the stepped layout past grid_max_hidden (a scan a count)
lstm_backward.padded_launches = 0  # launches at H % 4 != 0, zero-padded


class _LSTMScan(torch.autograd.Function):
    """(ys, c_last) of (x, h0, c0, w_x, w_h, b), all but the f32 bias
    already in the working dtype; the counterpart of the JAX package's
    `_lstm_core` with its cell recompute. `with_cells`: keep the f32 cell
    plane for the backward (the kernel writes it as it goes)."""

    @staticmethod
    def forward(ctx, x, h0, c0, w_x, w_h, b, reset, with_cells, padded=False,
                h_padded=False):
        if x.device.type == "cpu":
            ys, (_, c_last) = plain(x, h0, c0, w_x, w_h, b, reset_mask=reset)
            cs = None
        else:
            ys, c_last, cs = _forward_kernel(
                x, h0, c0, w_x, w_h, b, with_cells,
                None if reset is None else 1.0 - reset.float(), padded)
            c_last = c_last.to(x.dtype)
        ctx.save_for_backward(x, ys, cs, h0, c0, w_x, w_h, b, reset)
        ctx.h_padded = h_padded
        return ys, c_last

    @staticmethod
    def backward(ctx, g_ys, g_c):
        x, ys, cs, h0, c0, w_x, w_h, b, reset = ctx.saved_tensors
        x_proj = torch.matmul(x.float(), w_x.float()) + b
        if cs is None:  # the CPU path: the plain serial recompute
            cs = reference.lstm_recompute_cells(x_proj, ys, h0, c0, w_h, reset)
        d_xp, dh0, dc0, dW_h, db = reference.lstm_bwd_math(
            x_proj, ys, cs, h0, c0, w_h, g_ys, reset, dc_last=g_c,
            scan=functools.partial(lstm_backward, padded=ctx.h_padded))
        d_x = torch.matmul(d_xp, w_x.float().T).to(x.dtype)
        dW_x = torch.einsum("btd,btk->dk", x.float(), d_xp)
        return (d_x, dh0.to(h0.dtype), dc0.to(c0.dtype), dW_x.to(w_x.dtype),
                dW_h.to(w_h.dtype), db, None, None, None, None)


def lstm_scan(
    x: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    c0: torch.Tensor,  # [B, H]
    w_x: torch.Tensor,  # [D, 4H]
    w_h: torch.Tensor,  # [H, 4H]
    b: Optional[torch.Tensor] = None,  # [4H]
    *,
    reset_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """LSTM over time -> (ys [B, T, H], (h_last, c_last)), in x.dtype,
    differentiable in x, h0, c0 and the weights, through ys and c_last.
    `reset_mask` [B, T] (1 = zero h and c before step t) selects the reset
    variants of both kernels.

    A CPU tensor takes the plain versions (forward and reverse loop); a
    CUDA tensor launches the kernels or raises. On a CUDA tensor, a D or H
    that is not a multiple of 4 takes the padded route (`gru.pad_gates`,
    exact: see the module note), counted again in `.padded_launches`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm: no kernel for device {x.device}")
    B, T, D = x.shape
    H = h0.shape[-1]
    if tuple(w_x.shape) != (D, 4 * H) or tuple(w_h.shape) != (H, 4 * H):
        raise ValueError(
            f"lstm: w_x {tuple(w_x.shape)} / w_h {tuple(w_h.shape)} do not "
            f"match D={D}, H={H}"
        )
    dtype = x.dtype
    b32 = (torch.zeros(4 * H, dtype=torch.float32, device=x.device) if b is None
           else b.to(torch.float32))
    operands = (x, h0.to(dtype), c0.to(dtype), w_x.to(dtype), w_h.to(dtype), b32)
    with_cells = torch.is_grad_enabled() and any(t.requires_grad for t in operands)
    Dp, Hp = padded_width(D), padded_width(H)
    padded = x.device.type == "cuda" and (Dp, Hp) != (D, H)
    if padded:
        x_, states, w_x_, w_h_, (b_,) = pad_scan_operands(
            operands[0], operands[1:3], operands[3], operands[4], operands[5:])
        operands = (x_, *states, w_x_, w_h_, b_)
    ys, c_last = _LSTMScan.apply(*operands, reset_mask, with_cells, padded, padded and Hp != H)
    if padded:
        ys, c_last = ys[..., :H], c_last[..., :H]
    return ys, (ys[:, -1], c_last)


lstm_scan.launches = 0
lstm_scan.reset_launches = 0
lstm_scan.grid_launches = 0
lstm_scan.stepped_launches = 0  # the stepped layout past grid_max_hidden (a scan a count)
lstm_scan.padded_launches = 0  # launches at D or H % 4 != 0, zero-padded
