"""Sequence towers: the port of `seqrec_tpu/models/towers.py`.

`RNNTower` with `cell="gru"` maps embedded sequences [B, T, D] to per-step
hidden states [B, T, H] through the fused `ops.gru_scan`. Parameters keep the
flax names and layouts (`gru{l}_wx` [D_in, 3H], `gru{l}_wh` [H, 3H],
`gru{l}_bx`, `gru{l}_bh` [3H]), so a JAX parameter tree loads by name.

Dropout between stacked layers (training only) uses flax's formula with an
explicit `torch.Generator` (`dropout`). The LSTM cell and the SASRec tower
are ported with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from seqrec_tpu_torch import ops


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """`flax.linen.Dropout` in training mode: keep each element where a
    uniform draw falls below 1 - rate, and scale it by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def zero_carry(cell: str, num_layers: int, batch: int, hidden: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu"):
    """Fresh recurrent state for a session-parallel stream: per-layer h for
    GRU, (h, c) for LSTM. Shape [batch, hidden] per leaf."""
    def z():
        return torch.zeros((batch, hidden), dtype=dtype, device=device)
    if cell == "gru":
        return tuple(z() for _ in range(num_layers))
    return tuple((z(), z()) for _ in range(num_layers))


class RNNTower(nn.Module):
    """Stacked GRU encoder (GRU4Rec). `residual` adds a layer's input to its
    output when the widths match; the initial state is zeros unless a
    `carry` (see `zero_carry`) is given."""

    def __init__(self, embed_dim: int, hidden: int, num_layers: int = 1,
                 cell: str = "gru", residual: bool = False,
                 use_pallas: bool = True, param_dtype=torch.float32,
                 device: Optional[torch.device] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        if cell == "lstm":
            raise NotImplementedError(
                "RNNTower(cell='lstm') is not ported yet: ROADMAP.md Queue 1 "
                "item 6 (LSTM and SASRec towers)"
            )
        if cell != "gru":
            raise ValueError(f"unknown rnn cell {cell!r}")
        self.cell = cell
        self.hidden = hidden
        self.num_layers = num_layers
        self.residual = residual
        self.use_pallas = use_pallas
        self.dropout_rate = dropout_rate
        d_in = embed_dim
        for layer in range(num_layers):
            for name, shape in ((f"gru{layer}_wx", (d_in, 3 * hidden)),
                                (f"gru{layer}_wh", (hidden, 3 * hidden)),
                                (f"gru{layer}_bx", (3 * hidden,)),
                                (f"gru{layer}_bh", (3 * hidden,))):
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(shape, dtype=param_dtype, device=device)))
            d_in = hidden

    def forward(self, x: torch.Tensor, mask: torch.Tensor, *, carry=None,
                reset: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Encode [B, T, D] -> [B, T, H]; with `carry`, (outputs, new_carry).
        `mask` is unused by the recurrence (pads sit at the tail), as in the
        reference. Unless `deterministic`, dropout between layers draws from
        `generator`."""
        del mask
        B = x.shape[0]
        h = x
        new_carry = []
        for layer in range(self.num_layers):
            d_in = h.shape[-1]
            h0 = (carry[layer] if carry is not None
                  else torch.zeros((B, self.hidden), device=x.device)).to(h.dtype)
            y, h_last = ops.gru_scan(
                h, h0,
                getattr(self, f"gru{layer}_wx"), getattr(self, f"gru{layer}_wh"),
                getattr(self, f"gru{layer}_bx"), getattr(self, f"gru{layer}_bh"),
                reset_mask=reset, use_pallas=self.use_pallas,
            )
            new_carry.append(h_last)
            h = y + h if (self.residual and d_in == self.hidden) else y
            if not deterministic and layer < self.num_layers - 1:
                h = dropout(h, self.dropout_rate, generator)
        if carry is not None:
            return h, tuple(new_carry)
        return h


class SASRecTower(nn.Module):
    """Placeholder naming where the SASRec tower will come from."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SASRecTower is not ported yet: ROADMAP.md Queue 1 item 6 "
            "(LSTM and SASRec towers)"
        )
