"""Embedding gather kernel (`csrc/gather.cu`).

Replaces `seqrec_tpu/ops/pallas/gather.py::embedding_gather` (forward only:
the backward, a scatter-add, comes with the training slice). Bound by bytes;
see the source note for the design. Same contract as the plain version:
`jnp.take` semantics, ids in [-V, V) wrap, other ids give NaN rows.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.embedding_gather

# The dtype's quiet-NaN bit pattern, repeated to fill 32 bits.
_NAN_WORD = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    fn = lib.seqrec_gather_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # table, V, row bytes
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,  # ids, int64?, n
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,  # out, nan word, stream
    ]
    fn.restype = ctypes.c_int
    lib.seqrec_gather_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_gather_error_string.restype = ctypes.c_char_p
    return lib


def check_launchable(table: torch.Tensor, ids: torch.Tensor) -> None:
    """Raise ValueError for inputs the kernel cannot take."""
    if table.dim() != 2:
        raise ValueError(f"gather: table must be [V, D], got {tuple(table.shape)}")
    if table.dtype not in _NAN_WORD:
        raise ValueError(f"gather: table dtype {table.dtype} not in float32/bfloat16")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather: ids dtype {ids.dtype} not in int32/int64")
    if ids.device != table.device:
        raise ValueError(f"gather: ids on {ids.device}, table on {table.device}")
    if not table.is_contiguous():
        raise ValueError("gather: table must be contiguous")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 != 0 or table.data_ptr() % 16 != 0:
        raise ValueError(
            f"gather: rows must be 16-byte multiples on a 16-byte aligned base "
            f"(D={table.shape[1]}, {table.dtype})"
        )


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` with jnp.take's out-of-range contract -> [*ids.shape, D].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if table.device.type == "cpu":
        return plain(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {table.device}")
    check_launchable(table, ids)
    ids_c = ids.contiguous()
    out = torch.empty((*ids.shape, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if ids_c.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        rc = lib.seqrec_gather_rows(
            table.data_ptr(), table.shape[0],
            table.shape[1] * table.element_size(),
            ids_c.data_ptr(), int(ids_c.dtype == torch.int64), ids_c.numel(),
            out.data_ptr(), _NAN_WORD[table.dtype],
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gather_error_string(rc).decode()
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc} ({msg})")
    embedding_gather.launches += 1
    return out


embedding_gather.launches = 0
