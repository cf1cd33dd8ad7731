"""Embedding gather kernels (`csrc/gather.cu`): the row gather and its
transpose, a scatter-add, joined by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/gather.py::embedding_gather` and its custom
VJP `_gather_core_bwd`, with the `astype` to the compute dtype that the
JAX model puts after every lookup folded into the gather's store. Both are
bound by bytes; see the source note for the design. Same contract as the
plain versions: `jnp.take` semantics, ids in [-V, V) wrap, other ids give
NaN rows forward and drop their cotangent rows backward. The output is in
`dtype` (f32 or bf16, round to nearest even), the cotangent comes back in
it and is widened to f32 by the scatter-add's loads; the table's gradient
is accumulated in f32 and cast to the table's dtype.

The scatter-add is deterministic: every row sums its terms in an order the
ids' positions fix (chunks of positions, runs of one id in a chunk cut into
sub-runs of 32; `scatter_add_plan`), so the same inputs give the same bits
on every run. `plain_ordered` adds in that order in plain tensor code, for
the tests.

The shard-window variants (`embedding_gather_window`,
`embedding_scatter_add_window`) are the same kernels instantiated for a row
shard of a row-sharded table (a template flag, not a runtime branch): the
tensor holds rows [row0, row0 + rows) of the whole table; an id in that
window reads (adds into) row id - row0, any other id gives a zero row (adds
nothing): its row lives on another shard. They are what
`parallel/embedding.py` and the sharded sparse pair launch; their plain
versions are `ops.reference.embedding_gather_window` and
`embedding_scatter_add_window`, and `plain_ordered_window` the
scatter-add's order.
"""

from __future__ import annotations

import ctypes

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import unit_bytes

plain = reference.embedding_gather
plain_backward = reference.embedding_scatter_add

# The scatter-add's order (csrc/gather.cu, which also owns its scratch
# layout): positions a sub-run, the chunk sizes, and the largest table it
# takes (ids kept as int32).
SUB_RUN = 32
CHUNKS = (256, 512)
MAX_ROWS = 2 ** 31 - 1
MAX_IDS = 2 ** 31 - 1  # positions are kept as int32 too
MAX_ROW0 = 2 ** 31 - 1  # a shard window starts below 2^31 (ids are int32 or int64)

# The dtypes the kernels read and write.
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256  # kThreads in csrc/gather.cu
ROWS_IN_FLIGHT = 4  # kRows: rows a lane group loads before it stores any


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    fn = lib.seqrec_gather_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # table, V, D, bf16?
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,  # ids, int64?, n
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # out, bf16?, stream
    ]
    fn.restype = ctypes.c_int
    bwd = lib.seqrec_scatter_add_rows
    bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # g, bf16?, ids, int64?
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, V, D, chunk
        ctypes.c_void_p, ctypes.c_longlong,  # scratch, its bytes
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    bwd.restype = ctypes.c_int
    size = lib.seqrec_scatter_add_scratch_bytes
    size.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # n, D, chunk
    size.restype = ctypes.c_longlong
    win = lib.seqrec_gather_rows_window
    win.argtypes = fn.argtypes[:-1] + [ctypes.c_longlong, ctypes.c_void_p]  # ..., row0, stream
    win.restype = ctypes.c_int
    bwin = lib.seqrec_scatter_add_rows_window
    bwin.argtypes = bwd.argtypes[:-1] + [ctypes.c_longlong, ctypes.c_void_p]  # ..., row0, stream
    bwin.restype = ctypes.c_int
    lib.seqrec_gather_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_gather_error_string.restype = ctypes.c_char_p
    return lib


def launch_config(D: int, table_dtype: torch.dtype, dtype: torch.dtype | None = None,
                  base: int = 0) -> dict:
    """The gather's unit and lanes for [V, D] rows of `table_dtype` at a
    table address `base` (0: a 16-byte aligned one) into `dtype` (the
    table's when None); ValueError for what it cannot take. Any D >= 1: the
    unit is the widest of 16, 8, 4 and 2 bytes that divides the row's bytes
    and the base (an f32 table's rows always take 4), its output piece the
    same values in `dtype`; a row is `units` of them on `lanes` lanes (a
    power of two up to 32), 256 / lanes rows a block, 4 in flight a lane
    group."""
    dtype = table_dtype if dtype is None else dtype
    if table_dtype not in DTYPES or dtype not in DTYPES:
        raise ValueError(f"gather: table dtype {table_dtype} and output dtype {dtype} must "
                         "be float32/bfloat16")
    if D <= 0:
        raise ValueError(f"gather: D={D}; the kernel takes D >= 1")
    es = table_dtype.itemsize
    unit = unit_bytes(D * es, base)
    if unit == 0:
        raise ValueError(f"gather: a {table_dtype} table at address {base:#x} is not "
                         f"{es}-byte aligned")
    units = D * es // unit
    lanes = min(32, 1 << (units - 1).bit_length())
    out_es = dtype.itemsize
    return {"unit_bytes": unit, "out_unit_bytes": unit * out_es // es, "units": units,
            "lanes": lanes, "rows_per_block": THREADS // lanes * ROWS_IN_FLIGHT,
            "threads": THREADS}


def check_launchable(table: torch.Tensor, ids: torch.Tensor,
                     dtype: torch.dtype | None = None) -> dict:
    """Raise ValueError for inputs the kernel cannot take (`dtype`: the
    output's, the table's when None); else its launch configuration."""
    if table.dim() != 2:
        raise ValueError(f"gather: table must be [V, D], got {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise ValueError(f"gather: table dtype {table.dtype} not in float32/bfloat16")
    if dtype is not None and dtype not in DTYPES:
        raise ValueError(f"gather: output dtype {dtype} not in float32/bfloat16")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather: ids dtype {ids.dtype} not in int32/int64")
    if ids.device != table.device:
        raise ValueError(f"gather: ids on {ids.device}, table on {table.device}")
    if not table.is_contiguous():
        raise ValueError("gather: table must be contiguous")
    return launch_config(table.shape[1], table.dtype, dtype, table.data_ptr())


def _gather_kernel(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    check_launchable(table, ids, dtype)
    ids_c = ids.contiguous()
    out = torch.empty((*ids.shape, table.shape[1]), dtype=dtype, device=table.device)
    if ids_c.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        rc = lib.seqrec_gather_rows(
            table.data_ptr(), table.shape[0], table.shape[1],
            int(table.dtype == torch.bfloat16),
            ids_c.data_ptr(), int(ids_c.dtype == torch.int64), ids_c.numel(),
            out.data_ptr(), int(dtype == torch.bfloat16),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gather_error_string(rc).decode()
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc} ({msg})")
    embedding_gather.launches += 1
    return out


def scatter_add_plan(n: int, num_rows: int, D: int) -> dict:
    """The deterministic scatter-add's two launches for n ids into a
    [num_rows, D] table: chunks of `chunk` positions (256 up to n = 16,384,
    else 512: 25 to 50 chunks, one block each, at the training shapes),
    then a warp a table row. `unit`: the f32 values a lane adds at once,
    "float4" where D % 4 == 0 (on aligned bases), else "float" (any D).
    ValueError for what it cannot take."""
    if not 0 <= n <= MAX_IDS or D <= 0 or not 0 < num_rows <= MAX_ROWS:
        raise ValueError(f"scatter_add: n={n}, num_rows={num_rows}, D={D}; the kernel "
                         f"takes 0 <= n <= {MAX_IDS}, 0 < num_rows <= {MAX_ROWS} and D > 0")
    chunk = CHUNKS[0] if n <= 64 * CHUNKS[0] else CHUNKS[1]
    return {"chunk": chunk, "chunks": -(-n // chunk), "threads": chunk, "sub_run": SUB_RUN,
            "launches": 2 if n else 0, "deterministic": True,
            "unit": "float4" if D % 4 == 0 else "float"}


def check_scatter_add_launchable(g: torch.Tensor, ids: torch.Tensor,
                                 num_rows: int) -> dict:
    """Raise ValueError for inputs the scatter-add kernel cannot take; else
    its plan, its unit at g's base (float4 needs 16 bytes of f32 g, or 8 of
    bf16, aligned)."""
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"scatter_add: ids dtype {ids.dtype} not in int32/int64")
    if g.dtype not in DTYPES:
        raise ValueError(f"scatter_add: g dtype {g.dtype} not in float32/bfloat16")
    if ids.device != g.device:
        raise ValueError(f"scatter_add: ids on {ids.device}, g on {g.device}")
    if g.dim() != ids.dim() + 1 or tuple(g.shape[:-1]) != tuple(ids.shape) \
            or num_rows <= 0 or g.shape[-1] <= 0:
        raise ValueError(f"scatter_add: g {tuple(g.shape)} does not match ids "
                         f"{tuple(ids.shape)} and num_rows={num_rows}")
    plan = scatter_add_plan(ids.numel(), num_rows, g.shape[-1])
    if g.data_ptr() % (4 * g.element_size()) != 0:  # four values of g
        plan["unit"] = "float"
    return plan


def _sequential_sums(values: torch.Tensor, seg: torch.Tensor, groups: int) -> torch.Tensor:
    """[groups, D]: each group's rows of `values` summed from 0 in their
    order (`seg` [m] sorted, the group of each row), one f32 add at a
    time."""
    out = torch.zeros((groups, values.shape[1]), dtype=torch.float32, device=values.device)
    if seg.numel() == 0:
        return out
    idx = torch.arange(seg.numel(), device=seg.device)
    rank = idx - torch.searchsorted(seg, seg)
    for k in range(int(rank.max()) + 1):
        at = rank == k
        out[seg[at]] = out[seg[at]] + values[at]
    return out


def plain_ordered(g: torch.Tensor, ids: torch.Tensor, num_rows: int,
                  chunk: int) -> torch.Tensor:
    """The scatter-add in the kernel's order, in plain tensor code (for the
    tests: the kernel equals it bit for bit): a row's terms summed from 0
    in position order within each sub-run (at most SUB_RUN of one id's
    positions in one chunk of `chunk`), the sub-runs of a run summed from 0
    in order, then the chunks' partials from 0 in chunk order."""
    ids = ids.reshape(-1).long()
    g = g.reshape(ids.shape[0], g.shape[-1]).float()
    valid = (ids >= -num_rows) & (ids < num_rows)
    pos = torch.arange(ids.numel(), device=ids.device)[valid]
    rows = torch.where(ids < 0, ids + num_rows, ids)[valid]
    chunk_of = pos // chunk
    # Sort by (chunk, row), positions ascending within.
    order = torch.argsort(chunk_of * num_rows + rows, stable=True)
    pos, rows, chunk_of = pos[order], rows[order], chunk_of[order]
    run_key = chunk_of * num_rows + rows
    _, run = torch.unique_consecutive(run_key, return_inverse=True)
    rank = torch.arange(run.numel(), device=run.device) - torch.searchsorted(run, run)
    _, sub = torch.unique_consecutive(run * (chunk // SUB_RUN + 1) + rank // SUB_RUN,
                                      return_inverse=True)
    n_sub = int(sub.max()) + 1 if sub.numel() else 0
    sub_sums = _sequential_sums(g[pos], sub, n_sub)
    first = torch.ones_like(sub, dtype=torch.bool)
    first[1:] = sub[1:] != sub[:-1]
    n_run = int(run.max()) + 1 if run.numel() else 0
    run_sums = _sequential_sums(sub_sums, run[first], n_run)
    head = torch.ones_like(run, dtype=torch.bool)
    head[1:] = run[1:] != run[:-1]
    run_rows, run_chunks = rows[head], chunk_of[head]
    # Per table row, its chunks' partials in chunk order.
    order = torch.argsort(run_rows * (int(chunk_of.max()) + 1 if chunk_of.numel() else 1)
                          + run_chunks, stable=True)
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    seg_rows = run_rows[order]
    if seg_rows.numel():
        uniq, seg = torch.unique_consecutive(seg_rows, return_inverse=True)
        out[uniq] = _sequential_sums(run_sums[order], seg, uniq.numel())
    return out


def embedding_scatter_add(g: torch.Tensor, ids: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """The gather's transpose -> a [num_rows, D] f32 table holding each row
    of `g` ([*ids.shape, D], f32 or bf16, summed as its f32 widening) at
    its id (wrapped; out-of-range ids dropped). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (two, deterministic) or
    raises."""
    if g.device.type == "cpu":
        return plain_backward(g, ids, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {g.device}")
    plan = check_scatter_add_launchable(g, ids, num_rows)
    D = g.shape[-1]
    n = ids.numel()
    if n == 0:
        return torch.zeros((num_rows, D), dtype=torch.float32, device=g.device)
    ids_c = ids.contiguous()
    g_c = g.contiguous()
    dev = g.device
    lib = _lib()
    nbytes = lib.seqrec_scatter_add_scratch_bytes(n, D, plan["chunk"])
    out = torch.empty((num_rows, D), dtype=torch.float32, device=dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.seqrec_scatter_add_rows(
            g_c.data_ptr(), int(g_c.dtype == torch.bfloat16), ids_c.data_ptr(),
            int(ids_c.dtype == torch.int64), n,
            num_rows, D, plan["chunk"], scratch.data_ptr(), nbytes, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gather_error_string(rc).decode()
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {rc} ({msg})")
    embedding_scatter_add.launches += 1
    return out


embedding_scatter_add.launches = 0


def check_window(row0: int, rows: int) -> None:
    """Raise ValueError for a shard window the kernels cannot take: they
    take 0 <= row0 <= MAX_ROW0 and 0 < rows <= MAX_ROWS (ids are compared
    with the window as int64)."""
    if not (0 <= row0 <= MAX_ROW0 and 0 < rows <= MAX_ROWS):
        raise ValueError(f"shard window [{row0}, {row0} + {rows}): the kernels take "
                         f"0 <= row0 <= {MAX_ROW0} and 0 < rows <= {MAX_ROWS}")


def embedding_gather_window(table: torch.Tensor, ids: torch.Tensor, row0: int, *,
                            dtype: torch.dtype | None = None) -> torch.Tensor:
    """Rows of a row shard (`table` [rows, D] holds rows [row0, row0 +
    rows) of the whole table) for `ids` -> [*ids.shape, D] in `dtype` (the
    table's when None): an id in the window its row, any other id a zero
    row. Not differentiable itself (`parallel.embedding` joins it to its
    transpose). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    dtype = table.dtype if dtype is None else dtype
    if table.device.type == "cpu":
        return reference.embedding_gather_window(table, ids, row0, dtype=dtype)
    if table.device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {table.device}")
    check_launchable(table, ids, dtype)
    check_window(int(row0), table.shape[0])
    ids_c = ids.contiguous()
    out = torch.empty((*ids.shape, table.shape[1]), dtype=dtype, device=table.device)
    if ids_c.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        rc = lib.seqrec_gather_rows_window(
            table.data_ptr(), table.shape[0], table.shape[1],
            int(table.dtype == torch.bfloat16),
            ids_c.data_ptr(), int(ids_c.dtype == torch.int64), ids_c.numel(),
            out.data_ptr(), int(dtype == torch.bfloat16), int(row0),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gather_error_string(rc).decode()
        raise RuntimeError(f"gather window kernel launch failed: CUDA error {rc} ({msg})")
    embedding_gather_window.launches += 1
    return out


embedding_gather_window.launches = 0


def embedding_scatter_add_window(g: torch.Tensor, ids: torch.Tensor, row0: int,
                                 num_rows: int) -> torch.Tensor:
    """The window gather's transpose -> a [num_rows, D] f32 shard holding
    each row of `g` ([*ids.shape, D], f32 or bf16) added at id - row0 where
    the id lies in [row0, row0 + num_rows); other ids add nothing.
    Deterministic, in `embedding_scatter_add`'s order over the ids in the
    window (`plain_ordered_window`). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernels (two) or raises."""
    if g.device.type == "cpu":
        return reference.embedding_scatter_add_window(g, ids, row0, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {g.device}")
    plan = check_scatter_add_launchable(g, ids, num_rows)
    check_window(int(row0), num_rows)
    D = g.shape[-1]
    n = ids.numel()
    if n == 0:
        return torch.zeros((num_rows, D), dtype=torch.float32, device=g.device)
    ids_c = ids.contiguous()
    g_c = g.contiguous()
    dev = g.device
    lib = _lib()
    nbytes = lib.seqrec_scatter_add_scratch_bytes(n, D, plan["chunk"])
    out = torch.empty((num_rows, D), dtype=torch.float32, device=dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.seqrec_scatter_add_rows_window(
            g_c.data_ptr(), int(g_c.dtype == torch.bfloat16), ids_c.data_ptr(),
            int(ids_c.dtype == torch.int64), n,
            num_rows, D, plan["chunk"], scratch.data_ptr(), nbytes, out.data_ptr(), int(row0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_gather_error_string(rc).decode()
        raise RuntimeError(f"scatter_add window kernel launch failed: CUDA error {rc} ({msg})")
    embedding_scatter_add_window.launches += 1
    return out


embedding_scatter_add_window.launches = 0


def plain_ordered_window(g: torch.Tensor, ids: torch.Tensor, row0: int, num_rows: int,
                         chunk: int) -> torch.Tensor:
    """`plain_ordered` for the shard window: the window scatter-add's order
    in plain tensor code (ids off the window dropped, as out-of-range ids
    are)."""
    local, owned = reference.window_ids(ids, row0, num_rows)
    return plain_ordered(g, torch.where(owned, local, num_rows), num_rows, chunk)


class _Gather(torch.autograd.Function):
    """rows of `table` for `ids` in `dtype`; the gradient (in `dtype`)
    reaches the table only."""

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.table_dtype = table.shape[0], table.dtype
        if table.device.type == "cpu":
            return plain(table, ids, dtype=dtype)
        return _gather_kernel(table, ids, dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d_table = embedding_scatter_add(g, ids, ctx.num_rows)
        return d_table.to(ctx.table_dtype), None, None


def embedding_gather(table: torch.Tensor, ids: torch.Tensor, *,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """`table[ids].to(dtype)` with jnp.take's out-of-range contract ->
    [*ids.shape, D] in `dtype` (the table's when None), differentiable in
    `table`. The cast is the kernel's store, not a second pass.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels or raises."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather: no kernel for device {table.device}")
    return _Gather.apply(table, ids, table.dtype if dtype is None else dtype)


embedding_gather.launches = 0
