"""SeqRecModel: the port of `seqrec_tpu/models/model.py`.

Item table + sequence tower + scoring, as one `nn.Module`. Parameter names
and layouts are the flax ones (`item_embedding` [rows, D], `output_embedding`,
`output_bias`, `user_embedding`, `tower.gru{l}_*`), so `models.convert` maps a
JAX parameter tree onto `state_dict` by name.

Batch layout as in the reference: `inputs` [B, T] item ids (0 = pad),
`targets` [B, T] next-item ids, `mask` [B, T] {0, 1}, pads at the tail.
Methods: `encode`, `last_hidden`, `scores` (serving) and `loss` (training,
every loss type). `loss_stream` comes with session-parallel training.
Dropout draws from an explicit `torch.Generator` passed in.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from seqrec_tpu_torch import ops
from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.data.negative import pos_log_prob
from seqrec_tpu_torch.models.towers import RNNTower, SASRecTower, dropout
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE, resolve_device

NEG_FILL = -1e30  # logit of a padded-vocab column

# Losses that train against a shared sampled-negative set (vs. full_softmax's
# whole-catalog product). top1 and bpr_max are the GRU4Rec-lineage ranking
# losses (Hidasi et al. ICLR'16; Hidasi & Karatzoglou CIKM'18).
SAMPLED_LOSSES = ("sampled_softmax", "bpr", "top1", "bpr_max")
_RANKING_LOSSES = {"bpr": reference.bpr_loss, "top1": reference.top1_loss,
                   "bpr_max": reference.bpr_max_loss}


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
        dropout_rate: float = 0.1,
        loss_type: str = "full_softmax",
        # The negative sampler of training: the sampled-softmax logQ
        # correction for POSITIVES uses the law the negatives came from.
        neg_sampler: str = "log_uniform",
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
        self.arch = arch
        self.dropout_rate = dropout_rate
        self.loss_type = loss_type
        self.neg_sampler = neg_sampler
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
                                  param_dtype=param_dtype, device=device,
                                  dropout_rate=dropout_rate)
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

    def forward(self, *args, method: str = "encode", **kwargs):
        """`method` names the method to run (as flax's `apply(...,
        method=)`), so `torch.func.functional_call` can reach `loss`."""
        return getattr(self, method)(*args, **kwargs)

    def encode(self, inputs: torch.Tensor, mask: torch.Tensor, *,
               users: Optional[torch.Tensor] = None, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """ids [B, T] -> per-step hidden states [B, T, H]. Unless
        `deterministic`, input and inter-layer dropout draw from `generator`."""
        x = self._lookup(self.item_embedding, inputs)
        if self.use_user_embedding and users is not None:
            x = x + self._lookup(self.user_embedding, users)[:, None, :]
        if not deterministic and self.arch == "gru4rec":
            x = dropout(x, self.dropout_rate, generator)
        return self.tower(x, mask, deterministic=deterministic, generator=generator)

    def loss(self, batch: Dict[str, torch.Tensor], *,
             neg_ids: Optional[torch.Tensor] = None,  # [S] shared negatives
             neg_log_q: Optional[torch.Tensor] = None,  # [S]
             deterministic: bool = False,
             generator: Optional[torch.Generator] = None):
        """Masked training loss of a batch {inputs, targets, mask[, users]}.
        Returns (sum of loss, sum of weights)."""
        h = self.encode(batch["inputs"], batch["mask"], users=batch.get("users"),
                        deterministic=deterministic, generator=generator)
        return self._head_loss(h, batch["targets"], batch["mask"], neg_ids, neg_log_q)

    def loss_stream(self, *args, **kwargs):
        raise NotImplementedError(
            "SeqRecModel.loss_stream: ROADMAP.md Queue 1 item 7 "
            "(session-parallel training)")

    def _head_loss(self, h, targets, mask, neg_ids, neg_log_q):
        B, T, H = h.shape
        h2 = h.reshape(B * T, H)
        t2 = targets.reshape(B * T)
        w2 = mask.reshape(B * T).float()
        out_table = self.output_table()
        if self.loss_type == "full_softmax":
            return reference.full_softmax_loss(
                h2, out_table.to(self.compute_dtype), t2, w2,
                bias=self.output_bias_value(),
                num_valid=self.vocab_size if self.table_size > self.vocab_size else None,
            )
        if self.loss_type not in SAMPLED_LOSSES:
            raise ValueError(f"unknown loss {self.loss_type!r}")
        if neg_ids is None:
            raise ValueError(f"{self.loss_type} needs neg_ids")
        pos_emb = self._lookup(out_table, t2)
        neg_emb = self._lookup(out_table, neg_ids)
        if self.loss_type == "sampled_softmax":
            pos_log_q = None
            if neg_log_q is not None:
                pos_log_q = pos_log_prob(t2, self.vocab_size, self.neg_sampler)
            return ops.sampled_softmax_loss(
                h2, pos_emb, neg_emb, t2, neg_ids, w2,
                pos_log_q=pos_log_q, neg_log_q=neg_log_q,
                use_pallas=self.use_pallas,
            )
        return _RANKING_LOSSES[self.loss_type](h2, pos_emb, neg_emb, t2, neg_ids, w2)

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
                neg_sampler: str = "log_uniform",
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
        dropout_rate=cfg.dropout_rate,
        loss_type=cfg.loss,
        neg_sampler=neg_sampler,
        tie_embeddings=cfg.tie_embeddings,
        output_bias=cfg.loss == "full_softmax",
        use_pallas=cfg.use_pallas,
        param_dtype=_dtype(cfg.param_dtype),
        compute_dtype=_dtype(cfg.compute_dtype),
        device=dev,
    )
