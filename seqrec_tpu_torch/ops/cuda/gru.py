"""GRU scan kernels (`csrc/gru.cu`): the forward scan and the reverse
recurrence of its backward, joined by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/gru.py::gru_scan` (no reset mask: the reset
variant comes with session-parallel training) and its custom VJP
`_gru_core_bwd`. Forward: the x-projection is computed inside the kernel,
step by step. Backward, as `_gru_core_bwd`: the input projection and the
gates are recomputed with `torch.matmul` in parallel over T
(`reference.gru_bwd_hoist`), the reverse recurrence runs in the kernel, and
the weight and input gradients are batched `torch.matmul`s and sums, where
the JAX package has XLA einsums. Both kernels are bound by their 200-step
serial chain, not by bytes or operations; see the source note.

Numerics: forward products and gate math in f32, biases in f32, h rounded
to the working dtype (x.dtype: float32 or bfloat16) every step, as the TPU
kernel does; the plain version (ops/reference.py) works in x.dtype
throughout, so in bf16 the two differ by bf16 rounding of the gates. The
backward carries an f32 cotangent on both paths, and weight gradients are
rounded to the weights' working dtype, as the JAX package's VJP does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.gru_scan
plain_backward = reference.gru_bwd_scan

# Shared memory one block may opt in to on sm_90 (227 KB).
SMEM_LIMIT = 232_448
MAX_HIDDEN = 256  # kMaxHidden in csrc/gru.cu: one thread per hidden unit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_RESET_ITEM = ("gru kernel: reset_mask (session-parallel streaming) is ported "
               "with session-parallel training (ROADMAP.md Queue 1 item 7)")


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru")
    fwd = lib.seqrec_gru_forward
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fwd.restype = ctypes.c_int
    bwd = lib.seqrec_gru_backward
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    bwd.restype = ctypes.c_int
    lib.seqrec_gru_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_gru_error_string.restype = ctypes.c_char_p
    return lib


def _check_dims(B: int, T: int, H: int, dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"gru: dtype {dtype} not in float32/bfloat16")
    if min(B, T, H) <= 0:
        raise ValueError(f"gru: empty shape B={B} T={T} H={H}")
    if H % 4 != 0 or H > MAX_HIDDEN:
        raise ValueError(f"gru: needs H % 4 == 0 and H <= {MAX_HIDDEN} (H={H})")
    return torch.empty((), dtype=dtype).element_size()


def launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype,
                  rows_per_block: Optional[int] = None) -> Dict[str, int]:
    """Grid, block and shared-memory layout for one forward launch;
    ValueError for a shape the kernel cannot take. W_x goes to shared memory
    when it fits beside W_h, and is read from global memory (L2) otherwise.

    Rows per block (R): every block reads all of its weights every step,
    whatever R is, so a smaller R spreads the scan over more SMs. With W_x in
    shared memory R=1 is fastest; with W_x read from L2 each block's L2
    traffic is the limit, and R=2 halves the number of readers (an H100 sweep
    at B=64, T=200, D=H=128, which also found R=4 slower in both cases)."""
    es = _check_dims(B, T, H, dtype)
    if D <= 0 or (D * es) % 16 != 0:
        raise ValueError(f"gru: needs D*{es} % 16 == 0 (D={D}, H={H})")
    w_x = D * 3 * H * es

    def base(r):  # h and x double buffers, then W_h
        return 2 * r * H * 4 + 2 * r * D * es + H * 3 * H * es

    if rows_per_block is None:
        rows_per_block = 1 if base(1) + w_x <= SMEM_LIMIT else 2
    if rows_per_block not in (1, 2):
        raise ValueError(f"gru: rows_per_block {rows_per_block} not in 1, 2")
    R = rows_per_block
    if base(R) > SMEM_LIMIT:
        raise ValueError(
            f"gru: W_h and the step buffers need {base(R)} bytes of shared "
            f"memory, over the {SMEM_LIMIT} a block can have (H={H}, {dtype})"
        )
    wx_in_smem = int(base(R) + w_x <= SMEM_LIMIT)
    return {
        "grid": -(-B // R),
        "threads": H,
        "rows_per_block": R,
        "wx_in_smem": wx_in_smem,
        "smem_bytes": base(R) + (w_x if wx_in_smem else 0),
    }


def backward_launch_config(B: int, T: int, H: int, dtype: torch.dtype,
                           rows_per_block: Optional[int] = None) -> Dict[str, int]:
    """Layout of one reverse-recurrence launch: the d_hproj double buffer,
    and W_h^T in shared memory when it fits (read through L2 otherwise, with
    two rows per block, as the forward does with W_x)."""
    es = _check_dims(B, T, H, dtype)
    w = 3 * H * H * es

    def base(r):
        return 2 * r * 3 * H * 4

    if rows_per_block is None:
        rows_per_block = 1 if base(1) + w <= SMEM_LIMIT else 2
    if rows_per_block not in (1, 2):
        raise ValueError(f"gru: rows_per_block {rows_per_block} not in 1, 2")
    R = rows_per_block
    w_in_smem = int(base(R) + w <= SMEM_LIMIT)
    return {
        "grid": -(-B // R),
        "threads": H,
        "rows_per_block": R,
        "w_in_smem": w_in_smem,
        "smem_bytes": base(R) + (w if w_in_smem else 0),
    }


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


def _forward_kernel(x, h0, w_x, w_h, b_x, b_h) -> torch.Tensor:
    """ys [B, T, H]; every operand already in its kernel dtype."""
    B, T, D = x.shape
    H = h0.shape[-1]
    cfg = launch_config(B, T, D, H, x.dtype)
    dtype, dev = x.dtype, x.device
    args = [t.contiguous() for t in (x, h0, w_x, w_h, b_x, b_h)]
    _check_operands(args, dev)
    ys = torch.empty((B, T, H), dtype=dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.seqrec_gru_forward(
            *(a.data_ptr() for a in args), ys.data_ptr(),
            B, T, D, H, _DTYPE_CODE[dtype], cfg["rows_per_block"],
            cfg["wx_in_smem"], cfg["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "forward")
    gru_scan.launches += 1
    return ys


def gru_backward(r: torch.Tensor, z: torch.Tensor, n: torch.Tensor,
                 hn: torch.Tensor, h_in: torch.Tensor, g_ys: torch.Tensor,
                 w_h: torch.Tensor, keep: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse recurrence of the GRU backward -> (d_xp [B,T,3H] f32,
    dh0 [B,H] f32), `reference.gru_bwd_scan`'s contract. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if r.device.type == "cpu":
        return plain_backward(r, z, n, hn, h_in, g_ys, w_h, keep)
    if r.device.type != "cuda":
        raise ValueError(f"gru: no kernel for device {r.device}")
    if keep is not None:
        raise NotImplementedError(_RESET_ITEM)
    B, T, H = r.shape
    dtype, dev = h_in.dtype, r.device
    cfg = backward_launch_config(B, T, H, dtype)
    for name, t in (("z", z), ("n", n), ("hn", hn), ("h_in", h_in), ("g_ys", g_ys)):
        if tuple(t.shape) != (B, T, H):
            raise ValueError(f"gru backward: {name} {tuple(t.shape)}, expected {(B, T, H)}")
    if tuple(w_h.shape) != (H, 3 * H):
        raise ValueError(f"gru backward: w_h {tuple(w_h.shape)}, expected {(H, 3 * H)}")
    planes = [t.float().contiguous() for t in (r, z, n, hn)]
    args = planes + [h_in.contiguous(), g_ys.to(dtype).contiguous(),
                     w_h.to(dtype).T.contiguous()]
    _check_operands(args, dev)
    d_xp = torch.empty((B, T, 3 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.seqrec_gru_backward(
            *(a.data_ptr() for a in args), d_xp.data_ptr(), dh0.data_ptr(),
            B, T, H, _DTYPE_CODE[dtype], cfg["rows_per_block"], cfg["w_in_smem"],
            cfg["smem_bytes"], torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "backward")
    gru_backward.launches += 1
    return d_xp, dh0


gru_backward.launches = 0


class _GRUScan(torch.autograd.Function):
    """ys of (x, h0, w_x, w_h, b_x, b_h), all but the f32 biases already in
    the working dtype; the counterpart of the JAX package's `_gru_core`."""

    @staticmethod
    def forward(ctx, x, h0, w_x, w_h, b_x, b_h, reset):
        if x.device.type == "cpu":
            ys, _ = plain(x, h0, w_x, w_h, b_x, b_h, reset_mask=reset)
        else:
            ys = _forward_kernel(x, h0, w_x, w_h, b_x, b_h)
        ctx.save_for_backward(x, ys, h0, w_x, w_h, b_x, b_h, reset)
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        x, ys, h0, w_x, w_h, b_x, b_h, reset = ctx.saved_tensors
        x_proj = torch.matmul(x.float(), w_x.float()) + b_x
        d_xp, dh0, dW_h, db_h = reference.gru_bwd_math(
            x_proj, ys, h0, w_h, b_h, g_ys, reset, scan=gru_backward)
        d_x = torch.matmul(d_xp, w_x.float().T).to(x.dtype)
        dW_x = torch.einsum("btd,btk->dk", x.float(), d_xp)
        db_x = d_xp.sum(dim=(0, 1))
        return (d_x, dh0.to(h0.dtype), dW_x.to(w_x.dtype), dW_h.to(w_h.dtype),
                db_x, db_h, None)


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
    in x, h0 and the weights.

    A CPU tensor takes the plain versions (forward and reverse loop); a CUDA
    tensor launches the kernels or raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru: no kernel for device {x.device}")
    if x.device.type == "cuda" and reset_mask is not None:
        raise NotImplementedError(_RESET_ITEM)
    B, T, D = x.shape
    H = h0.shape[-1]
    if tuple(w_x.shape) != (D, 3 * H) or tuple(w_h.shape) != (H, 3 * H):
        raise ValueError(
            f"gru: w_x {tuple(w_x.shape)} / w_h {tuple(w_h.shape)} do not "
            f"match D={D}, H={H}"
        )
    dtype = x.dtype
    zeros = torch.zeros(3 * H, dtype=torch.float32, device=x.device)
    ys = _GRUScan.apply(
        x, h0.to(dtype), w_x.to(dtype), w_h.to(dtype),
        zeros if b_x is None else b_x.to(torch.float32),
        zeros if b_h is None else b_h.to(torch.float32), reset_mask)
    return ys, ys[:, -1]


gru_scan.launches = 0
