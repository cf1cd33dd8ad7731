"""Score masking: the part of `seqrec_tpu/eval/metrics.py` that serving uses.
The ranking metrics come with the eval slice."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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
