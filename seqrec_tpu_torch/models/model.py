"""SeqRecModel: the port of `seqrec_tpu/models/model.py`.

Item table + sequence tower + scoring, as one `nn.Module`. Parameter names
and layouts are the flax ones (`item_embedding` [rows, D], `output_embedding`,
`output_bias`, `user_embedding`, `tower.gru{l}_*`), so `models.convert` maps a
JAX parameter tree onto `state_dict` by name.

Batch layout as in the reference: `inputs` [B, T] item ids (0 = pad), `mask`
[B, T] {0, 1}, pads at the tail. This slice serves (`encode`, `last_hidden`,
`scores`); `loss` and `loss_stream` come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from seqrec_tpu_torch import ops
from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.models.towers import RNNTower, SASRecTower
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE, resolve_device

NEG_FILL = -1e30  # logit of a padded-vocab column

_TRAINING_SLICE = "ROADMAP.md Queue 1 item 2 (training step)"


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class SeqRecModel(nn.Module):
    def __init__(
        self,
        vocab_size: int,  # includes pad id 0
        *,
        # Table rows >= vocab_size (padded for row-sharding in the reference);
        # rows >= vocab_size are never valid ids and score -1e30.
        table_size: Optional[int] = None,
        num_users: int = 0,
        use_user_embedding: bool = False,
        user_table_size: Optional[int] = None,
        arch: str = "gru4rec",
        embed_dim: int = 64,
        hidden: int = 64,
        num_layers: int = 1,
        cell_type: str = "gru",
        residual: bool = False,
        tie_embeddings: bool = True,
        output_bias: bool = True,
        use_pallas: bool = True,
        param_dtype: torch.dtype = torch.float32,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        rows = table_size if table_size is not None else vocab_size
        if rows < vocab_size:
            raise ValueError("table_size must be >= vocab_size")
        self.vocab_size = vocab_size
        self.table_size = rows
        self.use_user_embedding = use_user_embedding
        self.tie_embeddings = tie_embeddings
        self.has_output_bias = output_bias
        self.use_pallas = use_pallas
        self.compute_dtype = compute_dtype
        self.item_embedding = _param((rows, embed_dim), param_dtype, device)
        if tie_embeddings:
            if hidden != embed_dim:
                raise ValueError("tie_embeddings requires hidden == embed_dim")
        else:
            self.output_embedding = _param((rows, hidden), param_dtype, device)
        if output_bias:
            self.output_bias = _param((rows,), param_dtype, device)
        if use_user_embedding:
            u_rows = user_table_size if user_table_size is not None else num_users + 1
            self.user_embedding = _param((u_rows, embed_dim), param_dtype, device)
        if arch == "gru4rec":
            self.tower = RNNTower(embed_dim, hidden, num_layers, cell=cell_type,
                                  residual=residual, use_pallas=use_pallas,
                                  param_dtype=param_dtype, device=device)
        elif arch == "sasrec":
            self.tower = SASRecTower()
        else:
            raise ValueError(f"unknown arch {arch!r}")

    # ---- helpers -------------------------------------------------------

    def _lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        out = ops.embedding_gather(table, ids, use_pallas=self.use_pallas)
        return out.to(self.compute_dtype)

    def output_table(self) -> torch.Tensor:
        return self.item_embedding if self.tie_embeddings else self.output_embedding

    def output_bias_value(self) -> Optional[torch.Tensor]:
        return self.output_bias if self.has_output_bias else None

    # ---- public methods -------------------------------------------------

    def forward(self, inputs, mask, *, users=None):
        return self.encode(inputs, mask, users=users)

    def encode(self, inputs: torch.Tensor, mask: torch.Tensor, *,
               users: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids [B, T] -> per-step hidden states [B, T, H] (inference: no
        dropout)."""
        x = self._lookup(self.item_embedding, inputs)
        if self.use_user_embedding and users is not None:
            x = x + self._lookup(self.user_embedding, users)[:, None, :]
        return self.tower(x, mask)

    def loss(self, *args, **kwargs):
        raise NotImplementedError(f"SeqRecModel.loss: {_TRAINING_SLICE}")

    def loss_stream(self, *args, **kwargs):
        raise NotImplementedError(f"SeqRecModel.loss_stream: {_TRAINING_SLICE}")

    def last_hidden(self, inputs: torch.Tensor, mask: torch.Tensor,
                    users: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, H] hidden state at the LAST real position of each row; an
        empty row reads position 0."""
        h = self.encode(inputs, mask, users=users)
        last = (mask.to(torch.int64).sum(dim=1) - 1).clamp(min=0)
        return h[torch.arange(h.shape[0], device=h.device), last]

    def scores(self, inputs: torch.Tensor, mask: torch.Tensor, *,
               users: Optional[torch.Tensor] = None,
               candidates: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f32 scores from the last real position of each row: [B, rows]
        against the whole catalog, or [B, C] against per-row `candidates`.
        Empty rows give scores that callers mask out."""
        h_last = self.last_hidden(inputs, mask, users=users)  # [B, H]
        out_table = self.output_table()
        bias = self.output_bias_value()
        if candidates is None:
            logits = reference.full_logits(
                h_last, out_table.to(self.compute_dtype), bias
            ).float()
            if self.table_size > self.vocab_size:
                cols = torch.arange(self.table_size, device=logits.device)
                logits = torch.where(cols[None, :] < self.vocab_size, logits,
                                     torch.full_like(logits, NEG_FILL))
            return logits
        cand = ops.embedding_gather(out_table, candidates,
                                    use_pallas=self.use_pallas)
        cand = cand.to(self.compute_dtype)  # [B, C, H]
        logits = torch.einsum("bh,bch->bc", h_last, cand).float()
        if bias is not None:
            logits = logits + reference.embedding_gather(
                bias[:, None], candidates)[..., 0].float()
        return logits


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def build_model(cfg: ModelConfig, vocab_size: int, *, num_users: int = 0,
                device: str | torch.device = DEFAULT_DEVICE) -> SeqRecModel:
    """The model a `ModelConfig` describes, on `device` (CUDA unless the
    caller asks for another; raises without CUDA). Parameters are zeros until
    a state_dict is loaded (see models.convert)."""
    dev = resolve_device(device)
    return SeqRecModel(
        vocab_size,
        num_users=num_users,
        use_user_embedding=cfg.use_user_embedding,
        arch=cfg.arch,
        embed_dim=cfg.embed_dim,
        hidden=cfg.hidden,
        num_layers=cfg.num_layers,
        cell_type=cfg.cell_type,
        residual=cfg.residual,
        tie_embeddings=cfg.tie_embeddings,
        output_bias=cfg.loss == "full_softmax",
        use_pallas=cfg.use_pallas,
        param_dtype=_dtype(cfg.param_dtype),
        compute_dtype=_dtype(cfg.compute_dtype),
        device=dev,
    )
