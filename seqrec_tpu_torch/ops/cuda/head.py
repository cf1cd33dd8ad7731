"""Sampled-softmax head forward kernel (`csrc/softmax_head.cu`).

Replaces `seqrec_tpu/ops/pallas/softmax_head.py::sampled_softmax_loss`: the
per-row NLL against S shared negatives with the logQ correction and the
accidental-hit mask, never writing the [N, S] logits. Bound by bytes at the
training shape; see the source note for the design.

The backward is the JAX package's `_head_core_bwd`: a recompute of the
softmax in plain tensor code (`reference.sampled_softmax_nll_bwd`), whose two
[N, S] products go to `torch.matmul` as XLA's did; the JAX package has no
Pallas kernel for it either. The `where(w > 0) * w` reduction stays outside
the kernel, as in the JAX package.

Numerics: every product in f32 (bf16 inputs multiply exactly in f32), as the
TPU kernel; the plain version (`plain`) is the same math in torch ops, so
the two differ by summation order only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.sampled_softmax_nll

SMEM_LIMIT = 232_448  # shared memory one block may opt in to on sm_90 (227 KB)
ROWS_PER_BLOCK = 64  # kRows in csrc/softmax_head.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("softmax_head")
    fn = lib.seqrec_head_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.seqrec_head_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_head_error_string.restype = ctypes.c_char_p
    return lib


def launch_config(N: int, S: int, H: int, dtype: torch.dtype) -> Dict[str, int]:
    """Grid and shared-memory layout for one launch; ValueError for a shape
    the kernel cannot take. The negatives live in shared memory transposed,
    so S * H in the working dtype (plus 64 f32 rows of h) must fit in the
    227 KB a block can have: at H=128, S up to 736 in bf16, 352 in f32."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"softmax_head: dtype {dtype} not in float32/bfloat16")
    if min(N, S, H) <= 0:
        raise ValueError(f"softmax_head: empty shape N={N} S={S} H={H}")
    es = torch.empty((), dtype=dtype).element_size()
    sp = -(-S // 32) * 32
    ld = sp + 4 // es  # one extra 32-bit word per row: no bank conflicts
    smem = ROWS_PER_BLOCK * H * 4 + sp * 8 + H * ld * es
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"softmax_head: {S} negatives of width {H} in {dtype} need {smem} "
            f"bytes of shared memory, over the {SMEM_LIMIT} a block can have"
        )
    return {"grid": -(-N // ROWS_PER_BLOCK), "threads": 256, "s_padded": sp,
            "ld": ld, "smem_bytes": smem}


def check_launchable(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                     neg_log_q) -> Dict[str, int]:
    """Raise ValueError for inputs the kernel cannot take; else its launch
    configuration."""
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
    return launch_config(N, S, H, h.dtype)


def _forward_kernel(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                    neg_log_q) -> torch.Tensor:
    cfg = check_launchable(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                           neg_log_q)
    N, H = h.shape
    S = neg_emb.shape[0]
    args = [h.contiguous(), pos_emb.contiguous(), neg_emb.contiguous(),
            targets.to(torch.int32).contiguous(), neg_ids.to(torch.int32).contiguous(),
            pos_log_q.to(torch.float32).contiguous(),
            neg_log_q.to(torch.float32).contiguous()]
    nll = torch.empty((N,), dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        rc = lib.seqrec_head_forward(
            *(a.data_ptr() for a in args), nll.data_ptr(),
            N, S, cfg["s_padded"], cfg["ld"], H, _DTYPE_CODE[h.dtype],
            cfg["smem_bytes"], torch.cuda.current_stream(h.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_head_error_string(rc).decode()
        raise RuntimeError(f"softmax_head kernel launch failed: CUDA error {rc} ({msg})")
    sampled_softmax_nll.launches += 1
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
