"""The full softmax over a row-sharded output table (vocab-parallel
cross-entropy): the port of what GSPMD makes of
`seqrec_tpu/ops/xla.py::full_softmax_loss` when the table and its output
bias are row-sharded over the mesh's 'model' axis.

Each rank holds rows [m V / M, (m + 1) V / M) of the [V, H] output table
and of the [V] bias, and brings its own N query rows. Over its model group:

    h, targets, weights  --all_gather('model')-->  [M N, ...]
    local logits  = h_all @ shard.T + bias shard      [M N, V / M], f32
    logsumexp     = logsumexp over M of each shard's row logsumexp
                    (one all-gather of [M N] values)
    target logit  = the owner shard's value, psum('model')

and keeps its own N rows' loss. No [N, V] array exists on any rank; the
[M N, V / M] logits are the size of one device's unsharded [N, V].

Backward, with d = (softmax_local - onehot_local) * w * g for all M N rows
(each row's w * g all-gathered from the rank that owns the row):
d_h = d @ shard, psum-scattered back to the rows' owners; d_shard =
d.T @ h_all; d_bias = d.sum(0). The shard's gradient covers the model
group's rows; the trainer sums it over the data group.

The products run in h's dtype (the compute dtype) and the logits in f32,
as the unsharded `reference.full_softmax_loss` computes them; the JAX
package computes them outside any Pallas kernel (XLA einsums), so they stay
`torch.matmul` here. Every rank of the model group calls this together,
with rows of one shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from seqrec_tpu_torch.ops.reference import NEG_INF
from seqrec_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh


def _local_logits(h_all, table, bias, row0: int, num_valid: int) -> torch.Tensor:
    """[M N, V / M] f32 logits against this shard, the columns past the
    true vocab at NEG_INF (-1e30, as ops/xla.py masks them)."""
    logits = h_all @ table.to(h_all.dtype).T
    if bias is not None:
        logits = logits + bias.to(h_all.dtype)
    logits = logits.float()
    cols = row0 + torch.arange(table.shape[0], device=logits.device)
    return torch.where(cols[None, :] < num_valid, logits, NEG_INF)


class _ShardedFullSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, bias, targets, weights, mesh, num_valid):
        M, m = mesh.shape[MODEL_AXIS], mesh.axis_index(MODEL_AXIS)
        rows = table.shape[0]
        row0 = m * rows
        n = h.shape[0]
        h_all = mesh.all_gather(h, MODEL_AXIS)  # [M N, H]
        t_all = mesh.all_gather(targets.long(), MODEL_AXIS)
        logits = _local_logits(h_all, table, bias, row0, num_valid)
        lse = torch.logsumexp(logits, dim=1)  # this shard's part of each row
        logz = torch.logsumexp(mesh.all_gather(lse, MODEL_AXIS).view(M, -1), dim=0)
        local_t = t_all - row0
        owns = (local_t >= 0) & (local_t < rows)
        idx = local_t.clamp(0, rows - 1)
        tgt = torch.gather(logits, 1, idx[:, None])[:, 0]
        tgt = mesh.psum(torch.where(owns, tgt, torch.zeros_like(tgt)), MODEL_AXIS)
        mine = slice(m * n, (m + 1) * n)
        w = weights.float()
        sum_loss = torch.sum((logz[mine] - tgt[mine]) * w)
        sum_w = torch.sum(w)
        ctx.save_for_backward(h_all, table, logits, logz, idx, owns, w)
        ctx.mesh, ctx.has_bias, ctx.h_dtype = mesh, bias is not None, h.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.mark_non_differentiable(sum_w)
        return sum_loss, sum_w

    @staticmethod
    def backward(ctx, g, _g_w):
        h_all, table, logits, logz, idx, owns, w = ctx.saved_tensors
        mesh = ctx.mesh
        # Each row's w * g, from the rank whose loss holds the row.
        cw = mesh.all_gather((w * g).float(), MODEL_AXIS)  # [M N]
        d = torch.exp(logits - logz[:, None])
        rows_idx = torch.arange(d.shape[0], device=d.device)
        d[rows_idx, idx] -= owns.to(d.dtype)
        d = (d * cw[:, None]).to(h_all.dtype)
        d_h = mesh.psum_scatter((d @ table.to(h_all.dtype)).float(), MODEL_AXIS)
        d_table = (d.T @ h_all).to(table.dtype)
        d_bias = d.sum(0).to(ctx.bias_dtype) if ctx.has_bias else None
        return d_h.to(ctx.h_dtype), d_table, d_bias, None, None, None, None


def sharded_full_softmax_loss(h: torch.Tensor, table_local: torch.Tensor,
                              bias_local: Optional[torch.Tensor], targets: torch.Tensor,
                              weights: torch.Tensor, mesh: Mesh, num_valid: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross-entropy over the whole catalog of a row-sharded output
    table: h [N, H] (this rank's rows, in the compute dtype), table_local
    [V / M, H] and bias_local [V / M] (this rank's shards), targets [N],
    weights [N]; columns >= num_valid (the true vocab) score -1e30. Returns
    this rank's (sum of loss, sum of weights), as
    `reference.full_softmax_loss` does for one device; differentiable in h,
    the table shard and the bias shard. A collective over the model group."""
    V = table_local.shape[0] * mesh.shape[MODEL_AXIS]
    nv = V if num_valid is None else int(num_valid)
    return _ShardedFullSoftmax.apply(h, table_local, bias_local, targets, weights, mesh, nv)
