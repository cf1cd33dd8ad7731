"""GRU scan forward kernel (`csrc/gru.cu`).

Replaces `seqrec_tpu/ops/pallas/gru.py::gru_scan` (forward, no reset mask:
the reset variant and the BPTT backward come with the training slice). The
x-projection is computed inside the kernel, step by step. Bound by its
200-step serial chain, not by bytes or operations; see the source note.

Numerics: products and gate math in f32, biases in f32, h rounded to the
working dtype (x.dtype: float32 or bfloat16) every step, as the TPU kernel
does. The plain version (ops/reference.py) works in x.dtype throughout, so
in bf16 the two differ by bf16 rounding of the gates.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.gru_scan

# Shared memory one block may opt in to on sm_90 (227 KB).
SMEM_LIMIT = 232_448
MAX_HIDDEN = 256  # kMaxHidden in csrc/gru.cu: one thread per hidden unit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru")
    fn = lib.seqrec_gru_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.seqrec_gru_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_gru_error_string.restype = ctypes.c_char_p
    return lib


def launch_config(B: int, T: int, D: int, H: int, dtype: torch.dtype,
                  rows_per_block: Optional[int] = None) -> Dict[str, int]:
    """Grid, block and shared-memory layout for one launch; ValueError for a
    shape the kernel cannot take. W_x goes to shared memory when it fits
    beside W_h, and is read from global memory (L2) otherwise.

    Rows per block (R): every block reads all of its weights every step,
    whatever R is, so a smaller R spreads the scan over more SMs. With W_x in
    shared memory R=1 is fastest; with W_x read from L2 each block's L2
    traffic is the limit, and R=2 halves the number of readers (an H100 sweep
    at B=64, T=200, D=H=128, which also found R=4 slower in both cases)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"gru: dtype {dtype} not in float32/bfloat16")
    if min(B, T, D, H) <= 0:
        raise ValueError(f"gru: empty shape B={B} T={T} D={D} H={H}")
    es = torch.empty((), dtype=dtype).element_size()
    if (D * es) % 16 != 0 or H % 4 != 0 or H > MAX_HIDDEN:
        raise ValueError(
            f"gru: needs D*{es} % 16 == 0, H % 4 == 0 and H <= {MAX_HIDDEN} "
            f"(D={D}, H={H})"
        )
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
    """GRU over time -> (ys [B, T, H], ys[:, -1]), in x.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return plain(x, h0, w_x, w_h, b_x, b_h, reset_mask=reset_mask)
    if x.device.type != "cuda":
        raise ValueError(f"gru: no kernel for device {x.device}")
    if reset_mask is not None:
        raise NotImplementedError(
            "gru kernel: reset_mask (session-parallel streaming) is ported with "
            "the training slice (ROADMAP.md Queue 2 item 1)"
        )
    B, T, D = x.shape
    H = h0.shape[-1]
    if tuple(w_x.shape) != (D, 3 * H) or tuple(w_h.shape) != (H, 3 * H):
        raise ValueError(
            f"gru: w_x {tuple(w_x.shape)} / w_h {tuple(w_h.shape)} do not "
            f"match D={D}, H={H}"
        )
    cfg = launch_config(B, T, D, H, x.dtype)
    dtype, dev = x.dtype, x.device
    zeros = torch.zeros(3 * H, dtype=torch.float32, device=dev)
    args = [
        x.contiguous(), h0.to(dtype).contiguous(), w_x.to(dtype).contiguous(),
        w_h.to(dtype).contiguous(),
        (zeros if b_x is None else b_x.to(torch.float32)).contiguous(),
        (zeros if b_h is None else b_h.to(torch.float32)).contiguous(),
    ]
    for a in args:
        if a.device != dev:
            raise ValueError(f"gru: operand on {a.device}, x on {dev}")
        if a.data_ptr() % 16 != 0:
            raise ValueError("gru: operands must be 16-byte aligned")
    ys = torch.empty((B, T, H), dtype=dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.seqrec_gru_forward(
            *(a.data_ptr() for a in args), ys.data_ptr(),
            B, T, D, H, _DTYPE_CODE[dtype], cfg["rows_per_block"],
            cfg["wx_in_smem"], cfg["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gru_error_string(rc).decode()
        raise RuntimeError(f"gru kernel launch failed: CUDA error {rc} ({msg})")
    gru_scan.launches += 1
    return ys, ys[:, -1]


gru_scan.launches = 0
