"""Embedding gather kernels (`csrc/gather.cu`): the row gather and its
transpose, a scatter-add, joined by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/gather.py::embedding_gather` and its custom
VJP `_gather_core_bwd`. Both are bound by bytes; see the source note for the
design. Same contract as the plain versions: `jnp.take` semantics, ids in
[-V, V) wrap, other ids give NaN rows forward and drop their cotangent rows
backward. The table's gradient is accumulated in f32 and cast to the
table's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference

plain = reference.embedding_gather
plain_backward = reference.embedding_scatter_add

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
    bwd = lib.seqrec_scatter_add_rows
    bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # g, ids, int64?
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # n, V, D
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    bwd.restype = ctypes.c_int
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


def _gather_kernel(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
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


def check_scatter_add_launchable(g: torch.Tensor, ids: torch.Tensor,
                                 num_rows: int) -> None:
    """Raise ValueError for inputs the scatter-add kernel cannot take."""
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"scatter_add: ids dtype {ids.dtype} not in int32/int64")
    if not g.is_floating_point():
        raise ValueError(f"scatter_add: g dtype {g.dtype} is not floating")
    if ids.device != g.device:
        raise ValueError(f"scatter_add: ids on {ids.device}, g on {g.device}")
    if g.dim() != ids.dim() + 1 or tuple(g.shape[:-1]) != tuple(ids.shape) \
            or num_rows <= 0 or g.shape[-1] <= 0:
        raise ValueError(f"scatter_add: g {tuple(g.shape)} does not match ids "
                         f"{tuple(ids.shape)} and num_rows={num_rows}")


def embedding_scatter_add(g: torch.Tensor, ids: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """The gather's transpose -> a [num_rows, D] f32 table holding each row
    of `g` ([*ids.shape, D]) summed at its id (wrapped; out-of-range ids
    dropped). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if g.device.type == "cpu":
        return plain_backward(g, ids, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {g.device}")
    check_scatter_add_launchable(g, ids, num_rows)
    D = g.shape[-1]
    n = ids.numel()
    ids_c = ids.contiguous()
    g_c = g.to(torch.float32).contiguous()
    out = torch.zeros((num_rows, D), dtype=torch.float32, device=g.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(g.device):
        rc = lib.seqrec_scatter_add_rows(
            g_c.data_ptr(), ids_c.data_ptr(), int(ids_c.dtype == torch.int64), n,
            num_rows, D, out.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gather_error_string(rc).decode()
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {rc} ({msg})")
    embedding_scatter_add.launches += 1
    return out


embedding_scatter_add.launches = 0


class _Gather(torch.autograd.Function):
    """rows of `table` for `ids`; the gradient reaches the table only."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.table_dtype = table.shape[0], table.dtype
        if table.device.type == "cpu":
            return plain(table, ids)
        return _gather_kernel(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d_table = embedding_scatter_add(g, ids, ctx.num_rows)
        return d_table.to(ctx.table_dtype), None


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` with jnp.take's out-of-range contract -> [*ids.shape, D],
    differentiable in `table`.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels or raises."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather: no kernel for device {table.device}")
    return _Gather.apply(table, ids)


embedding_gather.launches = 0
