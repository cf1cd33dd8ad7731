"""Full-catalog ranking and top-k in blocks of the catalog, on one device:
the port of `seqrec_tpu/eval/chunked.py`.

The full-protocol metrics need only the target's 0-based rank (the count
of catalog items scored strictly higher), never the [B, V] score matrix;
serving needs only the top k. At V=10M and B=256 that matrix is 10 GB;
these functions stream the catalog in blocks of `chunk` rows, keeping
[B, chunk] at a time, with the semantics of `ranks_from_scores(
mask_scores(full_logits(...)))` and of a stable top-k over the masked
scores:

- strictly-greater counting (ties rank the target first);
- the pad column and the vocab-padding columns (>= num_valid) are left out;
- a NaN target score ranks last;
- top-k ties resolve to the lowest item id.

The eval harness and `recommend` switch to them when [B, V] f32 scores
would exceed `CHUNK_THRESHOLD_BYTES`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from seqrec_tpu_torch.eval.metrics import first_occurrence_2d

DEFAULT_CHUNK = 1 << 18  # a [256, 262144] f32 block = 268 MB

# Above this many bytes of [B, V] f32 scores the harness and `recommend`
# take the blockwise paths. Module-level so that tests can shrink it.
CHUNK_THRESHOLD_BYTES = 512 << 20


def _block_logits(hc, table, start, chunk, compute_dtype, bias):
    """f32 [B, chunk] scores of rows [start, start + chunk)."""
    blk = table[start:start + chunk].to(compute_dtype)
    logits = (hc @ blk.T).float()
    if bias is not None:
        logits = logits + bias[start:start + chunk]
    return logits


def chunked_ranks(
    table: torch.Tensor,  # [V, D] output embedding table
    h: torch.Tensor,  # [B, D] query vectors (last hidden states)
    targets: torch.Tensor,  # [B] target item ids
    *,
    bias: Optional[torch.Tensor] = None,  # [V]
    num_valid: Optional[int] = None,  # leave out columns >= num_valid
    pad_id: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    chunk: int = DEFAULT_CHUNK,
    exclude: Optional[torch.Tensor] = None,  # [B, T] per-row ids to leave out
) -> torch.Tensor:  # [B] int32 0-based ranks
    """`exclude` (eval.exclude_history): per-row item ids whose columns do
    not count against the target, as `ranks_from_scores(mask_scores(scores,
    exclude=...))`. They are subtracted inside each block using the block's
    own logits (the values the count saw), so no recomputed score can flip
    a strict comparison."""
    V, _ = table.shape
    B = h.shape[0]
    limit = V if num_valid is None else min(num_valid, V)
    chunk = min(chunk, V)
    n_blocks = -(-V // chunk)
    ex_first = first_occurrence_2d(exclude) if exclude is not None else None
    # The ragged last block starts at a clamped offset (overlapping the one
    # before, so that no padded copy of the table is made) and a block
    # ownership mask drops the overlap from the count.
    b = None if bias is None else bias.float()
    t = targets.long()
    hc = h.to(compute_dtype)
    # The target's score through the same dtype path as the blocks.
    tgt = (hc[:, None, :] @ table[t].to(compute_dtype)[:, :, None])[:, 0, 0].float()
    if b is not None:
        tgt = tgt + b[t]
    counts = torch.zeros(B, dtype=torch.int32, device=h.device)
    for i in range(n_blocks):
        start = min(i * chunk, V - chunk)
        logits = _block_logits(hc, table, start, chunk, compute_dtype, b)
        cols = start + torch.arange(chunk, device=h.device)
        col_ok = (cols >= i * chunk) & (cols != pad_id) & (cols < limit)
        # The target's own column is left out explicitly: its score here
        # comes from the block product while `tgt` came from a row product,
        # and a last-ulp difference must not make it beat itself.
        not_self = cols[None, :] != t[:, None]
        gt = logits > tgt[:, None]
        counts += (gt & col_ok[None, :] & not_self).sum(dim=-1, dtype=torch.int32)
        if exclude is not None:
            # Subtract the excluded columns this block owns (the same
            # overlap rule as col_ok), reading their scores from its logits.
            ex = exclude.long()
            ex_local = ex - start
            owned = ((ex >= i * chunk) & (ex_local >= 0) & (ex_local < chunk)
                     & (ex != pad_id) & (ex < limit) & (ex != t[:, None]) & ex_first)
            s_ex = torch.gather(logits, 1, ex_local.clamp(0, chunk - 1))
            counts -= ((s_ex > tgt[:, None]) & owned).sum(dim=-1, dtype=torch.int32)
    return torch.where(torch.isnan(tgt), torch.full_like(counts, limit), counts)


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of each row, equal values in index order (lax.top_k's)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def chunked_topk(
    table: torch.Tensor,  # [V, D]
    h: torch.Tensor,  # [B, D]
    k: int,
    *,
    bias: Optional[torch.Tensor] = None,  # [V]
    num_valid: Optional[int] = None,
    pad_id: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    chunk: int = DEFAULT_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (f32 values [B, k], int32 item ids [B, k]) over the catalog
    without [B, V]: each block's top k merged into a running top k. Blocks
    go in ascending id order and the merge puts the running set first, so
    ties resolve to the lowest item id, as a dense stable top-k."""
    V, _ = table.shape
    B = h.shape[0]
    limit = V if num_valid is None else min(num_valid, V)
    chunk = max(min(chunk, V), k)
    n_blocks = -(-V // chunk)
    b = None if bias is None else bias.float()
    hc = h.to(compute_dtype)
    vals = torch.full((B, k), float("-inf"), device=h.device)
    ids = torch.zeros((B, k), dtype=torch.int32, device=h.device)
    for i in range(n_blocks):
        start = min(i * chunk, V - chunk)
        logits = _block_logits(hc, table, start, chunk, compute_dtype, b)
        cols = start + torch.arange(chunk, device=h.device)
        col_ok = (cols >= i * chunk) & (cols != pad_id) & (cols < limit)
        logits = torch.where(col_ok[None, :], logits, torch.full_like(logits, float("-inf")))
        bvals, bidx = _stable_topk(logits, k)
        bids = (start + bidx).to(torch.int32)
        vals, midx = _stable_topk(torch.cat([vals, bvals], dim=-1), k)
        ids = torch.gather(torch.cat([ids, bids], dim=-1), 1, midx)
    return vals, ids
