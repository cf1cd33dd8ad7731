"""Ranking metrics and score masking: the port of `seqrec_tpu/eval/metrics.py`.

Rank convention: rank r = number of candidates scored strictly higher than
the target (0 = best). recall@k counts r < k; MRR@k adds 1/(r+1) when
r < k; NDCG@k adds 1/log2(r+2) when r < k. With a single relevant item per
user (leave-one-out) NDCG's ideal DCG is 1, so there is no normalization.

The reducers return sums and a count, so that sums from several batches
(or processes) add before the division.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

NEG_INF = -1e30


def ranks_from_scores(
    scores: torch.Tensor,  # [B, C] float
    target_idx: torch.Tensor,  # [B] int: the target's column in `scores`
) -> torch.Tensor:
    """[B] int32 0-based rank of the target among the candidates (strictly
    greater). A NaN target score ranks last: every comparison with NaN is
    false, which would otherwise rank it first, and a diverged model must
    not look perfect."""
    tgt = torch.gather(scores, 1, target_idx[:, None].long())  # [B, 1]
    ranks = (scores > tgt).sum(dim=-1, dtype=torch.int32)
    last = torch.full_like(ranks, scores.shape[-1])
    return torch.where(torch.isnan(tgt[:, 0]), last, ranks)


def rank_metrics(
    ranks: torch.Tensor,  # [B] int
    valid: torch.Tensor,  # [B] {0, 1}
    ks: Sequence[int] = (5, 10, 20),
) -> Dict[str, torch.Tensor]:
    """f32 metric sums over the valid rows, and their count ('count')."""
    v = valid.float()
    out: Dict[str, torch.Tensor] = {"count": v.sum()}
    r = ranks.float()
    for k in ks:
        hit = (ranks < k).float() * v
        out[f"recall@{k}"] = hit.sum()
        out[f"mrr@{k}"] = (hit / (r + 1.0)).sum()
        out[f"ndcg@{k}"] = (hit / torch.log2(r + 2.0)).sum()
    return out


def finalize_metrics(sums: Dict[str, float]) -> Dict[str, float]:
    """Each metric sum over the count (0 when there is no row), and the
    count."""
    count = float(sums["count"])
    return {
        k: (float(val) / count if count > 0 else 0.0)
        for k, val in sums.items()
        if k != "count"
    } | {"count": count}


def first_occurrence_2d(x: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: True where x[b, t] is the first occurrence of its value in
    row b, so that a history's repeated items are discounted once. An O(T^2)
    compare, fine at session lengths of a few hundred."""
    eq = x[:, :, None] == x[:, None, :]  # [B, T, T]
    t = x.shape[1]
    earlier = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), diagonal=-1)
    return ~(eq & earlier[None]).any(dim=2)


def mask_scores(
    scores: torch.Tensor,  # [B, V]
    *,
    pad_id: int = 0,
    exclude: Optional[torch.Tensor] = None,  # [B, T] ids to exclude (e.g. history)
) -> torch.Tensor:
    """A copy of `scores` with the pad column and (optionally) each row's
    excluded ids set to NEG_INF. Excluded pad entries land on the pad column,
    which is NEG_INF already."""
    scores = scores.clone()
    scores[:, pad_id] = NEG_INF
    if exclude is not None:
        rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
        scores[rows, exclude.long()] = NEG_INF
    return scores
