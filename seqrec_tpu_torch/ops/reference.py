"""Plain PyTorch versions of the hot ops: the port's counterpart of
`seqrec_tpu/ops/xla.py`.

Each function keeps the JAX oracle's semantics and layout (weights stored
[in, out], gate blocks r|z|n), so the same numpy inputs give the same answer
on both sides. They are the CPU path, the path taken when `use_pallas` is
false, and the yardstick each hand-written kernel in `ops/cuda/` is held
against. This slice ports the three functions the serving path needs; the
losses, the LSTM and attention come with the slices that run them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Embedding gather
# ---------------------------------------------------------------------------


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of `table` ([V, D], floating) for integer `ids` (any shape).

    `jnp.take` semantics: ids in [-V, V) wrap as Python indexing does, and any
    other id gives a NaN row instead of reading out of bounds."""
    V = table.shape[0]
    ids = ids.long()
    valid = (ids >= -V) & (ids < V)
    rows = torch.where(ids < 0, ids + V, ids)
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    out = table[rows]
    nan = torch.full((), float("nan"), dtype=table.dtype, device=table.device)
    return torch.where(valid[..., None], out, nan)


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------
#
# Gate convention as in the JAX oracle: the candidate uses r * (h @ U_n + b_hn)
# (cuDNN's "linear before reset"), which is also torch.nn.GRU's, with the
# weights transposed. The working dtype is x.dtype throughout.


def gru_gates(x_proj: torch.Tensor, h_proj: torch.Tensor,
              h_prev: torch.Tensor) -> torch.Tensor:
    """GRU gate math given the projections ([..., 3H], r|z|n). Returns h_next."""
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h_prev


def gru_scan(
    x: torch.Tensor,  # [B, T, D_in]
    h0: torch.Tensor,  # [B, H]
    w_x: torch.Tensor,  # [D_in, 3H]
    w_h: torch.Tensor,  # [H, 3H]
    b_x: Optional[torch.Tensor] = None,  # [3H]
    b_h: Optional[torch.Tensor] = None,  # [3H]
    *,
    reset_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = reset BEFORE step t
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU over time. Returns (outputs [B, T, H], final state [B, H]).

    Where `reset_mask` is 1 the state is zeroed before step t is consumed
    (session-parallel batching)."""
    dtype = x.dtype
    x_proj = torch.einsum("btd,dh->bth", x, w_x.to(dtype))
    if b_x is not None:
        x_proj = x_proj + b_x.to(dtype)
    w_h_c = w_h.to(dtype)
    b_h_c = b_h.to(dtype) if b_h is not None else None
    keep = None if reset_mask is None else 1.0 - reset_mask.to(dtype)

    h = h0.to(dtype)
    ys = []
    for t in range(x.shape[1]):
        if keep is not None:
            h = h * keep[:, t, None]
        h_proj = h @ w_h_c
        if b_h_c is not None:
            h_proj = h_proj + b_h_c
        h = gru_gates(x_proj[:, t], h_proj, h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


def full_logits(h: torch.Tensor, table: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores against the whole catalog: [.., H] x [V, H] -> [.., V]."""
    logits = h @ table.to(h.dtype).T
    if bias is not None:
        logits = logits + bias.to(h.dtype)
    return logits
