"""Sampled-softmax head forward kernel (`csrc/softmax_head.cu`).

Replaces `seqrec_tpu/ops/pallas/softmax_head.py::sampled_softmax_loss`: the
per-row NLL against S shared negatives with the logQ correction and the
accidental-hit mask, never writing the [N, S] logits. Bound by bytes at the
training shape. Two hand-written designs chosen by dtype (see the source
note):

- bf16 (`design` "mma.sync", every shipped config): FlashAttention-2's
  pattern with the negatives as keys: a warp's 16 h rows as A fragments in
  registers, the negatives streamed through shared memory in S-tiles of 64
  (any S), an online logsumexp per row on the accumulators.
- f32 (`design` "simt-stream"): a SIMT GEMM on the CUDA cores (f32 FMAs,
  no TF32; the main loop of the f32 input projection, `csrc/simt_gemm.cuh`)
  with an online logsumexp as its epilogue: a block's 64 or 128 h rows
  resident in shared memory, the negatives streamed in S-tiles of 128
  through a cp.async ring (any S, any H <= 256).

Above H = 256 (up to `max_hidden`: 1,280 in bf16, 1,376 in f32) the K
split (`layout` "k-split", counted again in `.ksplit_launches`): bf16 on
64-row blocks whose h rows stay resident in shared memory while H is walked
in chunks of 128 through the negatives' ring, each S-tile's logits summed in
f32 across the chunks; f32 the design above on 32-row blocks.

Every H from 1 to 256 in both dtypes: bf16 copies a negative's row in the
widest unit of 16, 8, 4 or 2 bytes that divides its bytes and the bases
(zero-filled to Hp in shared memory) and reads h as bf16 pairs, or one bf16
at a time where that unit is 2 bytes (H odd, or a base off a 4-byte
boundary); f32 reads h and pos a float at a time for the
positive logit where they are not 16-byte rows on 16-byte bases. No operand
is copied for the kernel's sake.

The backward is the JAX package's `_head_core_bwd`: a recompute of the
softmax in plain tensor code (`reference.sampled_softmax_nll_bwd`), whose two
[N, S] products go to `torch.matmul` as XLA's did; the JAX package has no
Pallas kernel for it either. The `where(w > 0) * w` reduction stays outside
the kernel, as in the JAX package.

Numerics: every product in f32 (bf16 inputs multiply exactly in f32, so the
bf16 tensor-core products with f32 sums are the same contract), as the TPU
kernel; the plain version (`plain`) is the same math in torch ops, so the
two differ by summation order (and the exponential's last bits) only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import unit_bytes

plain = reference.sampled_softmax_nll

SMEM_LIMIT = 232_448  # shared memory one block may opt in to on sm_90 (227 KB)
MMA_ROWS = 128  # kMmaRows in csrc/softmax_head.cu: the bf16 design's rows a block, 16 a warp
S_TILE = 64  # kSTile: negatives a stage of the bf16 design's ring
STAGES = 3  # kHeadStages
MMA_MAX_H = 256
# The f32 design (simt::kTileN, kF32KChunk, kF32Stages, kF32MaxH): 64 or
# 128 h rows a block, resident, on 2 threads a row of 8 x 8 logits each.
ROWS_PER_BLOCK = 64
WIDE_ROWS = 128  # at H <= WIDE_MAX_H and N >= WIDE_MIN_N
WIDE_MAX_H = 128
WIDE_MIN_N = 96 * WIDE_ROWS  # 96 blocks: most of the card's 132 SMs
F32_S_TILE = 128  # negatives an S-tile
F32_K_CHUNK = 32  # k a ring stage
F32_STAGES = 2
F32_MAX_H = 256
# Above MMA_MAX_H / F32_MAX_H, the K split (csrc/softmax_head.cu):
KSPLIT_ROWS = 64  # kKsRows: bf16 rows a block (4 warps), their h resident in shared memory
KSPLIT_CHUNK = 128  # kKsChunk: k a stage of the negatives' ring
KSPLIT_STAGE = S_TILE * (KSPLIT_CHUNK + 8) * 2 + S_TILE * 8  # ksplit_stage_bytes
F32_KSPLIT_ROWS = 32  # f32 rows a block past F32_MAX_H (hT resident)
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("softmax_head")
    fn = lib.seqrec_head_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    mma = lib.seqrec_head_forward_mma
    mma.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    mma.restype = ctypes.c_int
    lib.seqrec_head_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_head_error_string.restype = ctypes.c_char_p
    return lib


def _ksplit_smem(H: int) -> int:
    """ksplit_smem in csrc/softmax_head.cu: the block's h rows [64][Hp + 8]
    bf16 (Hp = H padded to KSPLIT_CHUNK), then STAGES ring stages."""
    return KSPLIT_ROWS * (-(-H // KSPLIT_CHUNK) * KSPLIT_CHUNK + 8) * 2 + STAGES * KSPLIT_STAGE


def _f32_smem(H: int, rows: int) -> int:
    """head_f32_smem: hT [Hp][rows + 4] (Hp = H padded to F32_K_CHUNK), the
    ring of F32_STAGES [32][132] chunks, the positive logits, the odd warps'
    (m, l) and the targets."""
    hp = -(-H // F32_K_CHUNK) * F32_K_CHUNK
    return (hp * (rows + 4) + F32_STAGES * F32_K_CHUNK * (F32_S_TILE + 4) + 4 * rows) * 4


@functools.lru_cache(maxsize=None)
def max_hidden(dtype: torch.dtype) -> int:
    """The widest H the head takes in `dtype`: the widest padded width whose
    K split's resident rows still fit SMEM_LIMIT (1,280 in bf16, 1,376 in
    f32)."""
    if dtype == torch.bfloat16:
        unit, fits = KSPLIT_CHUNK, _ksplit_smem
    else:
        unit, fits = F32_K_CHUNK, lambda h: _f32_smem(h, F32_KSPLIT_ROWS)
    H = 4096
    while fits(H) > SMEM_LIMIT:
        H -= unit
    return H


def launch_config(N: int, S: int, H: int, dtype: torch.dtype, align: int = 16) -> Dict:
    """Design, grid and shared-memory layout for one launch; ValueError for
    a shape the kernel cannot take: any H from 1 to 256, any S. `align`:
    what the bases of h, pos_emb and neg_emb are all multiples of (16 for
    tensors of their own).

    bf16 ("mma.sync"): 128 rows a block (8 warps of 16), H padded with
    zeros to Hp in {16, 32, 64, 128, 256} (H <= 256: a warp's h rows stay
    in registers), a negative's row copied in pieces of `unit_bytes`, the
    widest of 16, 8, 4 and 2 that divides H * 2 and `align` (h and pos read
    as bf16 pairs at 4 and up, else one bf16 at a time), a ring of STAGES
    S-tiles of 64 negatives [64][Hp + 8] bf16 with their ids and logQ.

    f32 ("simt-stream"): 64 rows a block of 128 threads (8 x 8 logits a
    thread), or 128 rows of 256 threads where H <= 128 and N >= 12,288 (at
    least 96 such blocks; one wave of 200 at N = 25,600 where 400 blocks of
    64 rows leave a second wave of 4): their h transposed into shared
    memory once ([Hp][rows + 4] f32, H padded with zeros to Hp, a multiple
    of the 32-deep k chunk), the negatives streamed in S-tiles of 128
    through a ring of two k chunks ([32][132] f32 each): any S, and H <= 256;
    `pos_unit_bytes` 16 where h and pos are 16-byte rows (H % 4 == 0) and
    `align` is 16 (the positive logit's float4 reads), else 4.

    Above 256 (`layout` "k-split"), up to `max_hidden(dtype)`: bf16 on
    blocks of KSPLIT_ROWS rows (4 warps), their h rows resident in shared
    memory ([64][Hp + 8] bf16, Hp = H padded to KSPLIT_CHUNK) and H walked
    in chunks of 128 through the ring (stages of 64 negatives x 128 k), each
    S-tile's logits summed in f32 across the chunks; f32 the design above on
    blocks of F32_KSPLIT_ROWS rows, whose transposed h fits."""
    if dtype not in _DTYPES:
        raise ValueError(f"softmax_head: dtype {dtype} not in float32/bfloat16")
    if min(N, S, H) <= 0:
        raise ValueError(f"softmax_head: empty shape N={N} S={S} H={H}")
    es = dtype.itemsize
    if align < es or align % es:
        raise ValueError(f"softmax_head: {dtype} operands must be {es}-byte aligned "
                         f"(align={align})")
    limit = max_hidden(dtype)
    if H > limit:
        raise ValueError(f"softmax_head: {dtype} needs H <= {limit} (H={H}; the K split's "
                         f"resident h rows must fit {SMEM_LIMIT} bytes of shared memory)")
    if dtype == torch.bfloat16 and H > MMA_MAX_H:
        return {"design": "mma.sync", "layout": "k-split", "grid": -(-N // KSPLIT_ROWS),
                "threads": 2 * KSPLIT_ROWS, "rows_per_block": KSPLIT_ROWS,
                "hidden_padded": -(-H // KSPLIT_CHUNK) * KSPLIT_CHUNK, "s_tile": S_TILE,
                "k_chunk": KSPLIT_CHUNK, "unit_bytes": unit_bytes(H * 2, align),
                "smem_bytes": _ksplit_smem(H), "max_hidden": limit}
    if dtype == torch.bfloat16:
        hp = max(16, 1 << (H - 1).bit_length())
        return {"design": "mma.sync", "grid": -(-N // MMA_ROWS), "threads": 256,
                "rows_per_block": MMA_ROWS, "hidden_padded": hp, "s_tile": S_TILE,
                "unit_bytes": unit_bytes(H * 2, align),
                "smem_bytes": STAGES * (S_TILE * (hp + 8) * 2 + S_TILE * 8)}
    rows = (F32_KSPLIT_ROWS if H > F32_MAX_H else
            WIDE_ROWS if H <= WIDE_MAX_H and N >= WIDE_MIN_N else ROWS_PER_BLOCK)
    cfg = {"design": "simt-stream", "grid": -(-N // rows), "threads": 2 * rows,
           "rows_per_block": rows, "hidden_padded": -(-H // F32_K_CHUNK) * F32_K_CHUNK,
           "s_tile": F32_S_TILE, "k_chunk": F32_K_CHUNK, "stages": F32_STAGES,
           "pos_unit_bytes": 16 if unit_bytes(H * 4, align) == 16 else 4,
           "smem_bytes": _f32_smem(H, rows)}
    return {**cfg, "layout": "k-split", "max_hidden": limit} if H > F32_MAX_H else cfg


def check_launchable(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                     neg_log_q) -> Dict[str, int]:
    """Raise ValueError for inputs the kernel cannot take; else its launch
    configuration (at the bases of h, pos_emb and neg_emb as they are
    passed; the kernel reads contiguous copies of any that are not)."""
    if h.dim() != 2 or neg_emb.dim() != 2:
        raise ValueError(f"softmax_head: h {tuple(h.shape)} and neg_emb "
                         f"{tuple(neg_emb.shape)} must be 2-D")
    N, H = h.shape
    S = neg_emb.shape[0]
    shapes = {"pos_emb": (pos_emb, (N, H)), "neg_emb": (neg_emb, (S, H)),
              "targets": (targets, (N,)), "neg_ids": (neg_ids, (S,)),
              "pos_log_q": (pos_log_q, (N,)), "neg_log_q": (neg_log_q, (S,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"softmax_head: {name} {tuple(t.shape)}, expected {shape}")
        if t.device != h.device:
            raise ValueError(f"softmax_head: {name} on {t.device}, h on {h.device}")
    if pos_emb.dtype != h.dtype or neg_emb.dtype != h.dtype:
        raise ValueError("softmax_head: h, pos_emb and neg_emb need one dtype")
    return launch_config(N, S, H, h.dtype, unit_bytes(16, *(t.data_ptr() for t in
                                                             (h, pos_emb, neg_emb))))


def _forward_kernel(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                    neg_log_q) -> torch.Tensor:
    cfg = check_launchable(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q, neg_log_q)
    N, H = h.shape
    S = neg_emb.shape[0]
    args = [h.contiguous(), pos_emb.contiguous(), neg_emb.contiguous(),
            targets.to(torch.int32).contiguous(), neg_ids.to(torch.int32).contiguous(),
            pos_log_q.to(torch.float32).contiguous(),
            neg_log_q.to(torch.float32).contiguous()]
    if any(a.data_ptr() != t.data_ptr() for a, t in zip(args, (h, pos_emb, neg_emb))):
        # The units at the bases the kernel reads (a view off a 16-byte
        # boundary takes a narrower one; nothing is copied for its sake).
        cfg = launch_config(N, S, H, h.dtype,
                            unit_bytes(16, *(a.data_ptr() for a in args[:3])))
    nll = torch.empty((N,), dtype=torch.float32, device=h.device)
    lib = _lib()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        if cfg["design"] == "mma.sync":
            rc = lib.seqrec_head_forward_mma(*(a.data_ptr() for a in args), nll.data_ptr(),
                                             N, S, H, cfg["smem_bytes"], cfg["unit_bytes"],
                                             stream)
        else:
            rc = lib.seqrec_head_forward(*(a.data_ptr() for a in args), nll.data_ptr(), N, S,
                                         H, cfg["rows_per_block"], cfg["smem_bytes"],
                                         cfg["pos_unit_bytes"], stream)
    if rc != 0:
        msg = lib.seqrec_head_error_string(rc).decode()
        raise RuntimeError(f"softmax_head kernel launch failed: CUDA error {rc} ({msg})")
    sampled_softmax_nll.launches += 1
    if cfg.get("layout") == "k-split":
        sampled_softmax_nll.ksplit_launches += 1
    return nll


class _HeadNLL(torch.autograd.Function):
    """nll [N] f32 of (h, pos_emb, neg_emb); the ids and logQ get no
    gradient, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, h, pos_emb, neg_emb, targets, neg_ids, pos_log_q, neg_log_q):
        ctx.save_for_backward(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                              neg_log_q)
        if h.device.type == "cpu":
            return plain(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q, neg_log_q)
        return _forward_kernel(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                               neg_log_q)

    @staticmethod
    def backward(ctx, g):
        dh, dpos, dneg = reference.sampled_softmax_nll_bwd(g, *ctx.saved_tensors)
        return dh, dpos, dneg, None, None, None, None


def sampled_softmax_nll(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                        neg_log_q) -> torch.Tensor:
    """Per-row NLL [N] f32, differentiable in h, pos_emb and neg_emb.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"softmax_head: no kernel for device {h.device}")
    return _HeadNLL.apply(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q, neg_log_q)


sampled_softmax_nll.launches = 0
sampled_softmax_nll.ksplit_launches = 0  # the K split's launches above 256 (in .launches too)


def sampled_softmax_loss(
    h: torch.Tensor,  # [N, H]
    pos_emb: torch.Tensor,  # [N, H]
    neg_emb: torch.Tensor,  # [S, H]
    targets: torch.Tensor,  # [N]
    neg_ids: torch.Tensor,  # [S]
    weights: torch.Tensor,  # [N]
    *,
    pos_log_q: Optional[torch.Tensor] = None,
    neg_log_q: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused head with the same contract as
    `reference.sampled_softmax_loss`: (sum of w * nll, sum of w)."""
    N, S = h.shape[0], neg_emb.shape[0]
    dev = h.device
    plq = (torch.zeros(N, device=dev) if pos_log_q is None else pos_log_q).float()
    nlq = (torch.zeros(S, device=dev) if neg_log_q is None else neg_log_q).float()
    nll = sampled_softmax_nll(h, pos_emb, neg_emb, targets.to(torch.int32),
                              neg_ids.to(torch.int32), plq, nlq)
    return reference.masked_sum(nll, weights)
