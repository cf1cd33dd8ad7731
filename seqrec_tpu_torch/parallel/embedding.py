"""The row-sharded embedding lookup: the port of
`seqrec_tpu/parallel/embedding.py` on `torch.distributed`.

Each rank holds the rows [m V / M, (m + 1) V / M) of a [V, D] table, m its
index on the mesh's 'model' axis (`runtime.mesh`). A lookup of the rank's
own ids is an all-gather / reduce-scatter pair over its model group, as in
the JAX package:

    ids  [N]  --all_gather('model')-->  ids_all [M N]
    contrib = the shard-window gather of ids_all (zero rows off the window)
    acts [N, D]  <--psum_scatter('model')--  contrib [M N, D]

Every id is owned by exactly one shard, so the reduce-scatter's sum is
exact (x + 0 + ... + 0 = x), and the volumes are static (no per-shard
capacity to overflow). The backward pass is the transpose: the cotangent
is all-gathered over the model group and added into the shard by the
shard-window scatter-add, so each gradient row lands on the one shard that
owns it (summed over the data group by the trainer).

With `dedup` (the JAX package's per-device dedup) the ids are first made
unique (`unique_inverse`: JAX's `jnp.unique(size=N, fill_value=0,
return_inverse=True)`, with no host sync and a static shape), the exchange
moves the unique ids, and the inverse gathers the rows back (the gather
kernel, with the cast to the compute dtype in its store); backward, the
deterministic scatter-add sums a row's duplicates first.

`replicated_gather` is the lookup of ids that every rank of a model group
holds alike (the step's shared negatives): the window gather and a psum
over the model group; backward, a psum of the cotangent and the window
scatter-add.

The exchange runs in the table's dtype (f32), then the rows are cast, as
JAX casts after its collective. The table's rows must divide the model
axis: `padded_vocab` (pad rows are never referenced: real ids are below
the true vocab).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from seqrec_tpu_torch.ops import dispatch
from seqrec_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh


def padded_vocab(vocab_size: int, model_shards: int, multiple: int = 8) -> int:
    """Round vocab up so tables row-shard evenly (and tile nicely)."""
    m = max(model_shards * multiple, multiple)
    return ((vocab_size + m - 1) // m) * m


def shard_window(table: torch.Tensor, mesh: Mesh) -> Tuple[int, int]:
    """(row0, rows) of this rank's shard of a row-sharded table whose local
    part is `table`."""
    rows = table.shape[0]
    return mesh.axis_index(MODEL_AXIS) * rows, rows


def unique_inverse(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uniq [N], inv [N]) of a 1-D id tensor: the sorted unique ids padded
    with zeros at the end, and each id's position in them, so that
    uniq[inv] == flat. JAX's `jnp.unique(flat, size=N, fill_value=0,
    return_inverse=True)`, with no host sync: sort, flag first occurrences,
    and number them by a cumulative sum."""
    s, perm = torch.sort(flat)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    uniq = torch.zeros_like(flat).scatter_(0, rank, s)  # a slot's writers agree
    inv = torch.empty_like(rank).scatter_(0, perm, rank)
    return uniq, inv


class _ShardedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh, dedup, dtype, use_pallas):
        row0, rows = shard_window(table, mesh)
        D = table.shape[1]
        flat = ids.reshape(-1)
        n = flat.shape[0]
        inv = None
        lookup = flat
        if dedup:
            lookup, inv = unique_inverse(flat)
        ids_all = mesh.all_gather(lookup, MODEL_AXIS)  # [M N]
        contrib = dispatch.embedding_gather_window(table, ids_all, row0, use_pallas=use_pallas)
        acts = mesh.psum_scatter(contrib, MODEL_AXIS)  # [N, D] in the table's dtype
        if dedup:
            acts = dispatch.embedding_gather(acts, inv, dtype=dtype, use_pallas=use_pallas)
        else:
            acts = acts.to(dtype)
        ctx.save_for_backward(ids_all, inv if dedup else ids_all)
        ctx.mesh, ctx.dedup, ctx.use_pallas = mesh, dedup, use_pallas
        ctx.window, ctx.n, ctx.table_dtype = (row0, rows), n, table.dtype
        return acts.reshape(*ids.shape, D)

    @staticmethod
    def backward(ctx, g):
        ids_all, inv = ctx.saved_tensors
        row0, rows = ctx.window
        g = g.reshape(ctx.n, g.shape[-1])
        if ctx.dedup:  # a unique id's duplicates summed, deterministically
            g = dispatch.embedding_scatter_add(g, inv, ctx.n, use_pallas=ctx.use_pallas)
        g_all = ctx.mesh.all_gather(g.float(), MODEL_AXIS)  # [M N, D]
        d_table = dispatch.embedding_scatter_add_window(g_all, ids_all, row0, rows,
                                                        use_pallas=ctx.use_pallas)
        return d_table.to(ctx.table_dtype), None, None, None, None, None


def sharded_gather(table_local: torch.Tensor, ids_local: torch.Tensor, mesh: Mesh, *,
                   dedup: bool = True, dtype: Optional[torch.dtype] = None,
                   use_pallas: bool = True) -> torch.Tensor:
    """Row-sharded lookup of this rank's ids -> ids' shape + [D] in `dtype`
    (the table's when None), differentiable in `table_local` (this rank's
    shard). A collective over the model group: every rank of it calls this
    together, with ids of one shape. With one shard, the plain gather."""
    dtype = table_local.dtype if dtype is None else dtype
    if mesh.shape[MODEL_AXIS] == 1:
        return dispatch.embedding_gather(table_local, ids_local, dtype=dtype,
                                         use_pallas=use_pallas)
    return _ShardedGather.apply(table_local, ids_local, mesh, dedup, dtype, use_pallas)


class _ReplicatedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh, dtype, use_pallas):
        row0, rows = shard_window(table, mesh)
        contrib = dispatch.embedding_gather_window(table, ids, row0, use_pallas=use_pallas)
        out = mesh.psum(contrib, MODEL_AXIS)
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.window, ctx.use_pallas, ctx.table_dtype = (
            mesh, (row0, rows), use_pallas, table.dtype)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        row0, rows = ctx.window
        g = ctx.mesh.psum(g.float(), MODEL_AXIS)
        d_table = dispatch.embedding_scatter_add_window(g, ids, row0, rows,
                                                        use_pallas=ctx.use_pallas)
        return d_table.to(ctx.table_dtype), None, None, None, None


def replicated_gather(table_local: torch.Tensor, ids: torch.Tensor, mesh: Mesh, *,
                      dtype: Optional[torch.dtype] = None,
                      use_pallas: bool = True) -> torch.Tensor:
    """Lookup of ids that every rank of the model group holds alike (the
    step's shared negatives) -> ids' shape + [D] in `dtype`, differentiable
    in `table_local`: each shard gives the rows it owns, zeros elsewhere,
    summed over the model group. With one shard, the plain gather."""
    dtype = table_local.dtype if dtype is None else dtype
    if mesh.shape[MODEL_AXIS] == 1:
        return dispatch.embedding_gather(table_local, ids, dtype=dtype, use_pallas=use_pallas)
    return _ReplicatedGather.apply(table_local, ids, mesh, dtype, use_pallas)
