"""Full-catalog ranking over a row-sharded catalog: the port of
`seqrec_tpu/eval/sharded.py` on `torch.distributed`.

At a 10M-item catalog the dense eval path ([B, V] logits on one device) does
not fit: B=256 x 10M x 4 B = 10 GB. Each rank holds a shard of the output
table (`parallel.embedding`), and the metrics need only each target's rank
among all items:

    per shard:  local logits = h @ shard.T (+ bias shard)             [B, V/M]
                target score: the owner shard's value, psum('model')
                rank: #{local scores > target score}, psum('model')

No [B, V] array exists; the collectives move [B]-sized vectors (and the
query rows). The strictly-greater convention is `eval.metrics`'; the pad
column and the padded-vocab tail are masked on the shard that owns them.

The JAX functions take query rows replicated over the model axis. Here each
rank brings its own rows (its users), so both functions first all-gather
`h` (and the targets) over the model group, rank every gathered row, and
keep this rank's rows. Every rank of the model group calls them together,
with rows of one shape. The local [M B, V/M] scores are one `torch.matmul`,
as JAX computes them outside any kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from seqrec_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh

NEG_INF = -1e30


def _local_logits(table: torch.Tensor, h: torch.Tensor, offset: int,
                  bias: Optional[torch.Tensor], num_valid: int, pad_id: int) -> torch.Tensor:
    """[B, V/M] f32 scores of rows `h` against this shard (rows [offset,
    offset + V/M)), the pad column and the padded tail at NEG_INF."""
    logits = torch.matmul(h, table.to(h.dtype).t()).float()
    if bias is not None:
        logits = logits + bias.float()[None, :]
    cols = offset + torch.arange(table.shape[0], device=table.device)
    invalid = (cols == pad_id) | (cols >= num_valid)
    return torch.where(invalid[None, :], torch.full_like(logits, NEG_INF), logits)


def _own_rows(x: torch.Tensor, mesh: Mesh, rows: int) -> torch.Tensor:
    i = mesh.axis_index(MODEL_AXIS)
    return x[i * rows:(i + 1) * rows]


@torch.no_grad()
def sharded_ranks(
    table: torch.Tensor,  # [V/M, H]: this rank's shard of the output table
    h: torch.Tensor,  # [B, H]: this rank's query rows
    targets: torch.Tensor,  # [B]
    mesh: Mesh,
    *,
    bias: Optional[torch.Tensor] = None,  # [V/M]: this rank's shard of the bias
    num_valid: Optional[int] = None,  # the true vocab (masks the padded rows)
    pad_id: int = 0,
    exclude: Optional[torch.Tensor] = None,  # [B, T] per-row ids not to count
) -> torch.Tensor:
    """[B] 0-based strictly-greater rank of each target over the whole
    catalog, for this rank's rows.

    `exclude` (eval.exclude_history): ids whose columns do not count; the
    shard that owns an id subtracts it, scored by its own logits (pad and
    padded columns are NEG_INF there, so they never subtract), each id once
    a row and never the target itself."""
    rows_per_shard = table.shape[0]
    V = rows_per_shard * mesh.shape[MODEL_AXIS]
    nv = num_valid if num_valid is not None else V
    offset = mesh.axis_index(MODEL_AXIS) * rows_per_shard
    B = h.shape[0]
    h_all = mesh.all_gather(h, MODEL_AXIS)
    t_all = mesh.all_gather(targets.long(), MODEL_AXIS)
    logits = _local_logits(table, h_all, offset, bias, nv, pad_id)

    # The target's score: its owner's value, the others' zeros, summed.
    local_t = t_all - offset
    owns = (local_t >= 0) & (local_t < rows_per_shard)
    t_score = torch.gather(logits, 1, local_t.clamp(0, rows_per_shard - 1)[:, None])[:, 0]
    t_score = mesh.psum(torch.where(owns, t_score, torch.zeros_like(t_score)), MODEL_AXIS)

    count = (logits > t_score[:, None]).sum(dim=1)
    if exclude is not None:
        from seqrec_tpu_torch.eval.metrics import first_occurrence_2d

        ex_all = mesh.all_gather(exclude.long(), MODEL_AXIS)
        local_e = ex_all - offset
        owned_e = (local_e >= 0) & (local_e < rows_per_shard)
        s_e = torch.gather(logits, 1, local_e.clamp(0, rows_per_shard - 1))
        corr = ((s_e > t_score[:, None]) & owned_e & first_occurrence_2d(ex_all)
                & (ex_all != t_all[:, None])).sum(dim=1)
        count = count - corr
    return _own_rows(mesh.psum(count, MODEL_AXIS), mesh, B)


@torch.no_grad()
def sharded_topk(
    table: torch.Tensor,  # [V/M, H]: this rank's shard
    h: torch.Tensor,  # [B, H]: this rank's query rows
    k: int,
    mesh: Mesh,
    *,
    bias: Optional[torch.Tensor] = None,
    num_valid: Optional[int] = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k (scores [B, k] f32, item ids [B, k]) over the
    sharded catalog, for this rank's rows: each shard's local top k, the M k
    candidates gathered over the model group, and their top k. Equal scores
    keep the lower item id first (a stable descending sort), as
    `jax.lax.top_k` orders them."""
    rows_per_shard = table.shape[0]
    V = rows_per_shard * mesh.shape[MODEL_AXIS]
    nv = num_valid if num_valid is not None else V
    offset = mesh.axis_index(MODEL_AXIS) * rows_per_shard
    B = h.shape[0]
    h_all = mesh.all_gather(h, MODEL_AXIS)
    logits = _local_logits(table, h_all, offset, bias, nv, pad_id)
    vals, idx = torch.sort(logits, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :k].contiguous(), idx[:, :k] + offset
    # Every shard's [M B, k] side by side: [M B, M k], shards in order.
    vals_all = mesh.all_gather(vals.t().contiguous(), MODEL_AXIS).t()
    ids_all = mesh.all_gather(ids.t().contiguous(), MODEL_AXIS).t()
    mvals, midx = torch.sort(vals_all, dim=1, descending=True, stable=True)
    mids = torch.gather(ids_all, 1, midx[:, :k])
    return _own_rows(mvals[:, :k], mesh, B), _own_rows(mids, mesh, B)
