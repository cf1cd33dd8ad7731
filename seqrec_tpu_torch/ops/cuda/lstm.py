"""LSTM scan kernels (`csrc/lstm.cu`): the forward scan and the reverse
recurrence of its backward, joined by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/lstm.py::lstm_scan` and its custom VJP
`_lstm_core_bwd`, both variants: without a reset mask, and with one
(`_lstm_step_kernel_reset`, session-parallel training), where a keep plane
`1 - reset` [B, T] f32 goes to both kernels. The two variants count their
launches apart: `lstm_scan.launches` / `lstm_scan.reset_launches`, and the
same two on `lstm_backward`. Forward: the x-projection is computed inside
the kernel, step by step; the kernel also writes c_T, and, when autograd
will need it, the f32 cell plane c_1..c_T, so the backward runs no serial
`_recompute_cells` loop on the card. Backward, as `_lstm_core_bwd`: the
input projection and the gates are recomputed with `torch.matmul` in
parallel over T (`reference.lstm_bwd_math`), the reverse recurrence runs in
the kernel, and the input and weight gradients are `torch.matmul`s and
sums. The cotangent of c_T starts the reverse recurrence's dc carry, so
c_last is differentiable. Both kernels are bound by their serial chain; see
the source note.

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
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.lstm_scan
plain_backward = reference.lstm_bwd_scan

SMEM_LIMIT = 232_448  # shared memory one block may opt in to on sm_90 (227 KB)
MAX_HIDDEN = 256  # kMaxHidden in csrc/lstm.cu: one thread per hidden unit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm")
    fwd = lib.seqrec_lstm_forward
    fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    bwd = lib.seqrec_lstm_backward
    bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd.restype = ctypes.c_int
    lib.seqrec_lstm_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_lstm_error_string.restype = ctypes.c_char_p
    return lib


def _check_dims(B: int, T: int, H: int, dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"lstm: dtype {dtype} not in float32/bfloat16")
    if min(B, T, H) <= 0:
        raise ValueError(f"lstm: empty shape B={B} T={T} H={H}")
    if H % 4 != 0 or H > MAX_HIDDEN:
        raise ValueError(f"lstm: needs H % 4 == 0 and H <= {MAX_HIDDEN} (H={H})")
    return torch.empty((), dtype=dtype).element_size()


def _rows(rows_per_block: Optional[int], fits_one_row: bool) -> int:
    R = rows_per_block if rows_per_block is not None else (1 if fits_one_row else 2)
    if R not in (1, 2):
        raise ValueError(f"lstm: rows_per_block {R} not in 1, 2")
    return R


def launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype,
                  rows_per_block: Optional[int] = None) -> Dict[str, int]:
    """Grid, block and shared-memory layout of one forward launch;
    ValueError for a shape the kernel cannot take. W_h goes to shared memory
    when it fits beside the step buffers, and W_x too when both fit;
    whatever does not fit is read from global memory (L2), with two rows a
    block so that half as many blocks read it. Both come k-packed (`pack_k`).
    At D=H=128: in bf16 W_h (128 KB) is in shared memory and W_x is read
    through L2; in f32 W_h alone is 256 KB, and both are read through L2."""
    es = _check_dims(B, T, H, dtype)
    if D <= 0 or (D * es) % 16 != 0:
        raise ValueError(f"lstm: needs D*{es} % 16 == 0 (D={D}, H={H})")
    w_h, w_x = H * 4 * H * es, D * 4 * H * es

    def base(r):  # h and x double buffers
        return 2 * r * H * 4 + 2 * r * D * es

    R = _rows(rows_per_block, base(1) + w_h + w_x <= SMEM_LIMIT)
    wh_in_smem = int(base(R) + w_h <= SMEM_LIMIT)
    wx_in_smem = int(wh_in_smem and base(R) + w_h + w_x <= SMEM_LIMIT)
    return {
        "grid": -(-B // R),
        "threads": H,
        "rows_per_block": R,
        "wh_in_smem": wh_in_smem,
        "wx_in_smem": wx_in_smem,
        "smem_bytes": base(R) + wh_in_smem * w_h + wx_in_smem * w_x,
    }


def backward_launch_config(B: int, T: int, H: int, dtype: torch.dtype,
                           rows_per_block: Optional[int] = None) -> Dict[str, int]:
    """Layout of one reverse-recurrence launch: the dz double buffer, and
    W_h^T in shared memory when it fits (128 KB in bf16 at H=128; read
    through L2 otherwise, with two rows a block)."""
    es = _check_dims(B, T, H, dtype)
    w = 4 * H * H * es

    def base(r):
        return 2 * r * 4 * H * 4

    R = _rows(rows_per_block, base(1) + w <= SMEM_LIMIT)
    w_in_smem = int(base(R) + w <= SMEM_LIMIT)
    return {
        "grid": -(-B // R),
        "threads": H,
        "rows_per_block": R,
        "w_in_smem": w_in_smem,
        "smem_bytes": base(R) + w_in_smem * w,
    }


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


def pack_k(w: torch.Tensor) -> torch.Tensor:
    """[K, N] -> [K/P, N, P], P = 16 bytes / element size: the layout in which
    the forward kernel reads its weights, from shared or global memory."""
    K, N = w.shape
    P = 16 // w.element_size()
    return w.reshape(K // P, P, N).transpose(1, 2).contiguous()


def _keep_plane(keep: Optional[torch.Tensor], B: int, T: int) -> Optional[torch.Tensor]:
    """The [B, T] f32 keep plane (1 - reset) the kernels read, from a [B, T]
    or [B, T, 1] one; None stays None (the no-reset variant)."""
    if keep is None:
        return None
    if keep.numel() != B * T or keep.shape[:2] != (B, T):
        raise ValueError(f"lstm: keep plane {tuple(keep.shape)}, expected {(B, T)}")
    return keep.reshape(B, T).float().contiguous()


def _forward_kernel(x, h0, c0, w_x, w_h, b, with_cells: bool, keep=None):
    """(ys [B, T, H] in x.dtype, c_last [B, H] f32, cs [B, T, H] f32 or
    None); every operand already in its kernel dtype; `keep` the [B, T]
    plane 1 - reset (the reset variant) or None."""
    B, T, D = x.shape
    H = h0.shape[-1]
    cfg = launch_config(B, T, D, H, x.dtype)
    dtype, dev = x.dtype, x.device
    keep = _keep_plane(keep, B, T)
    args = [t.contiguous() for t in (x, h0, c0, pack_k(w_x), pack_k(w_h), b)]
    _check_operands(args + ([] if keep is None else [keep]), dev)
    ys = torch.empty((B, T, H), dtype=dtype, device=dev)
    c_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    cs = torch.empty((B, T, H), dtype=torch.float32, device=dev) if with_cells else None
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.seqrec_lstm_forward(
            *(a.data_ptr() for a in args), None if keep is None else keep.data_ptr(),
            ys.data_ptr(), c_last.data_ptr(),
            None if cs is None else cs.data_ptr(),
            B, T, D, H, _DTYPE_CODE[dtype], cfg["rows_per_block"],
            cfg["wx_in_smem"], cfg["wh_in_smem"], cfg["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "forward")
    if keep is None:
        lstm_scan.launches += 1
    else:
        lstm_scan.reset_launches += 1
    return ys, c_last, cs


def lstm_backward(i: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                  o: torch.Tensor, tanh_c: torch.Tensor, c_in: torch.Tensor,
                  g_ys: torch.Tensor, w_h: torch.Tensor,
                  keep: Optional[torch.Tensor] = None,
                  dc_last: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse recurrence of the LSTM backward -> (dz [B,T,4H] f32,
    dh0 [B,H] f32, dc0 [B,H] f32), `reference.lstm_bwd_scan`'s contract;
    with `keep` ([B,T,1] or [B,T], 1 - reset) the reset variant, dh_prev and
    dc_prev *= keep[t] (`c_in` arrives scaled by `reference.lstm_bwd_hoist`).
    The kernel works in g_ys's dtype (that of the forward's h). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if i.device.type == "cpu":
        return plain_backward(i, f, g, o, tanh_c, c_in, g_ys, w_h, keep, dc_last)
    if i.device.type != "cuda":
        raise ValueError(f"lstm: no kernel for device {i.device}")
    B, T, H = i.shape
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
    args = planes + [g_ys.contiguous(), w_h.to(dtype).T.contiguous()]
    dc_last = dc_last.float().contiguous()
    _check_operands(args + [dc_last] + ([] if keep is None else [keep]), dev)
    dz = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.seqrec_lstm_backward(
            *(a.data_ptr() for a in args), None if keep is None else keep.data_ptr(),
            dc_last.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            B, T, H, _DTYPE_CODE[dtype], cfg["rows_per_block"], cfg["w_in_smem"],
            cfg["smem_bytes"], torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "backward")
    if keep is None:
        lstm_backward.launches += 1
    else:
        lstm_backward.reset_launches += 1
    return dz, dh0, dc0


lstm_backward.launches = 0
lstm_backward.reset_launches = 0


class _LSTMScan(torch.autograd.Function):
    """(ys, c_last) of (x, h0, c0, w_x, w_h, b), all but the f32 bias
    already in the working dtype; the counterpart of the JAX package's
    `_lstm_core` with its cell recompute. `with_cells`: keep the f32 cell
    plane for the backward (the kernel writes it as it goes)."""

    @staticmethod
    def forward(ctx, x, h0, c0, w_x, w_h, b, reset, with_cells):
        if x.device.type == "cpu":
            ys, (_, c_last) = plain(x, h0, c0, w_x, w_h, b, reset_mask=reset)
            cs = None
        else:
            ys, c_last, cs = _forward_kernel(
                x, h0, c0, w_x, w_h, b, with_cells,
                None if reset is None else 1.0 - reset.float())
            c_last = c_last.to(x.dtype)
        ctx.save_for_backward(x, ys, cs, h0, c0, w_x, w_h, b, reset)
        return ys, c_last

    @staticmethod
    def backward(ctx, g_ys, g_c):
        x, ys, cs, h0, c0, w_x, w_h, b, reset = ctx.saved_tensors
        x_proj = torch.matmul(x.float(), w_x.float()) + b
        if cs is None:  # the CPU path: the plain serial recompute
            cs = reference.lstm_recompute_cells(x_proj, ys, h0, c0, w_h, reset)
        d_xp, dh0, dc0, dW_h, db = reference.lstm_bwd_math(
            x_proj, ys, cs, h0, c0, w_h, g_ys, reset, dc_last=g_c,
            scan=lstm_backward)
        d_x = torch.matmul(d_xp, w_x.float().T).to(x.dtype)
        dW_x = torch.einsum("btd,btk->dk", x.float(), d_xp)
        return (d_x, dh0.to(h0.dtype), dc0.to(c0.dtype), dW_x.to(w_x.dtype),
                dW_h.to(w_h.dtype), db, None, None)


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
    CUDA tensor launches the kernels or raises."""
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
    ys, c_last = _LSTMScan.apply(*operands, reset_mask, with_cells)
    return ys, (ys[:, -1], c_last)


lstm_scan.launches = 0
lstm_scan.reset_launches = 0
