"""SeqRecModel: the port of `seqrec_tpu/models/model.py`.

Item table + sequence tower (GRU4Rec with a GRU or LSTM cell, or SASRec) +
scoring, as one `nn.Module`. Parameter names and layouts are the flax ones
(`item_embedding` [rows, D], `output_embedding`, `output_bias`,
`user_embedding`, `tower.*`), so `models.convert` maps a JAX parameter tree
onto `state_dict` by name.

Batch layout as in the reference: `inputs` [B, T] item ids (0 = pad),
`targets` [B, T] next-item ids, `mask` [B, T] {0, 1}, pads at the tail.
Methods: `encode`, `last_hidden`, `scores` (serving), `loss` (training,
every loss type) and `loss_stream` (session-parallel training with a
carried recurrent state). Dropout draws from an explicit `torch.Generator`
passed in.

Row-sharded tables (a `mesh` with model axis M > 1 and `shard_embeddings`,
as the JAX model's): each rank's module holds its shard of every table,
rows [m rows / M, (m + 1) rows / M) of the padded table (`table_size` is
the whole table's rows), and looks its own ids up through
`parallel.embedding.sharded_gather` (the shared negatives through
`replicated_gather`), a collective over the model group. The output
bias of the full softmax is held as the same rows' shard, and the full
softmax runs vocab-parallel (`parallel.softmax.sharded_full_softmax_loss`:
each rank's [M N, V / M] logits, never [N, V]). The sparse step's
sub-tables are replicated and take the plain gather.
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
from seqrec_tpu_torch.parallel.embedding import padded_vocab, replicated_gather, sharded_gather
from seqrec_tpu_torch.parallel.softmax import sharded_full_softmax_loss
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE, resolve_device
from seqrec_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh

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
        num_heads: int = 1,
        mlp_dim: int = 256,
        max_len: int = 200,
        remat: bool = False,
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
        # Row-sharded tables over the mesh's model axis (see the module
        # docstring); dedup_lookup: dedup ids before the exchange.
        mesh: Optional[Mesh] = None,
        shard_embeddings: bool = False,
        dedup_lookup: bool = True,
    ):
        super().__init__()
        rows = table_size if table_size is not None else vocab_size
        if rows < vocab_size:
            raise ValueError("table_size must be >= vocab_size")
        self.mesh = mesh
        self.sharded = bool(shard_embeddings and mesh is not None
                            and mesh.shape[MODEL_AXIS] > 1)
        self.dedup_lookup = dedup_lookup
        shards = mesh.shape[MODEL_AXIS] if self.sharded else 1
        if rows % shards:
            raise ValueError(f"vocab {rows} must divide model shards {shards}; "
                             "use padded_vocab()")
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
        # name -> rows of the whole table, for the tables held as shards
        self.sharded_rows: Dict[str, int] = {}
        local = rows // shards
        self.item_embedding = _param((local, embed_dim), param_dtype, device)
        if tie_embeddings:
            if hidden != embed_dim:
                raise ValueError("tie_embeddings requires hidden == embed_dim")
        else:
            self.output_embedding = _param((local, hidden), param_dtype, device)
        if output_bias:
            self.output_bias = _param((local,), param_dtype, device)
        if use_user_embedding:
            u_rows = user_table_size if user_table_size is not None else num_users + 1
            if u_rows % shards:
                raise ValueError(f"user table {u_rows} must divide model shards {shards}")
            self.user_embedding = _param((u_rows // shards, embed_dim), param_dtype, device)
        if self.sharded:
            self.sharded_rows = {n: rows for n in ("item_embedding", "output_embedding",
                                                   "output_bias") if hasattr(self, n)}
            if use_user_embedding:
                self.sharded_rows["user_embedding"] = u_rows
        if arch == "gru4rec":
            self.tower = RNNTower(embed_dim, hidden, num_layers, cell=cell_type,
                                  residual=residual, use_pallas=use_pallas,
                                  param_dtype=param_dtype, device=device,
                                  dropout_rate=dropout_rate)
        elif arch == "sasrec":
            self.tower = SASRecTower(hidden, num_layers, num_heads, mlp_dim, max_len,
                                     dropout_rate=dropout_rate, use_pallas=use_pallas,
                                     remat=remat, param_dtype=param_dtype, device=device)
        else:
            raise ValueError(f"unknown arch {arch!r}")

    # ---- helpers -------------------------------------------------------

    def table_window(self, name: str) -> Optional[tuple]:
        """(row0, rows of the whole table) of a table this module holds as
        a shard; None for a whole one."""
        if name not in self.sharded_rows:
            return None
        rows = getattr(self, name).shape[0]
        return (self.mesh.axis_index(MODEL_AXIS) * rows, self.sharded_rows[name])

    def _lookup(self, table: torch.Tensor, ids: torch.Tensor,
                sharded: bool = False) -> torch.Tensor:
        """Rows of `table` in the compute dtype (the gather writes it).
        `sharded`: `table` is one of this module's row-sharded tables and
        `ids` this rank's (the collective lookup) when the model is sharded."""
        if sharded and self.sharded:
            return sharded_gather(table, ids, self.mesh, dedup=self.dedup_lookup,
                                  dtype=self.compute_dtype, use_pallas=self.use_pallas)
        return ops.embedding_gather(table, ids, dtype=self.compute_dtype,
                                    use_pallas=self.use_pallas)

    def output_table(self) -> torch.Tensor:
        return self.item_embedding if self.tie_embeddings else self.output_embedding

    def output_bias_value(self) -> Optional[torch.Tensor]:
        return self.output_bias if self.has_output_bias else None

    # ---- public methods -------------------------------------------------

    def forward(self, *args, method: str = "encode", **kwargs):
        """`method` names the method to run (as flax's `apply(...,
        method=)`), so `torch.func.functional_call` can reach `loss`."""
        return getattr(self, method)(*args, **kwargs)

    def _input_table(self, table_override: Optional[torch.Tensor]) -> torch.Tensor:
        """The table the inputs are looked up in: the item table, or the
        sparse step's [K, D] sub-table (`inputs` then hold positions in it,
        and the cotangent is [K, D], never [V, D])."""
        return self.item_embedding if table_override is None else table_override

    def encode(self, inputs: torch.Tensor, mask: torch.Tensor, *,
               users: Optional[torch.Tensor] = None, deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               table_override: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids [B, T] -> per-step hidden states [B, T, H]. Unless
        `deterministic`, input and inter-layer dropout draw from `generator`.
        `table_override`: see `_input_table`."""
        x = self._lookup(self._input_table(table_override), inputs,
                         sharded=table_override is None)
        if self.use_user_embedding and users is not None:
            x = x + self._lookup(self.user_embedding, users, sharded=True)[:, None, :]
        if not deterministic and self.arch == "gru4rec":
            x = dropout(x, self.dropout_rate, generator)
        return self.tower(x, mask, deterministic=deterministic, generator=generator)

    def loss(self, batch: Dict[str, torch.Tensor], *,
             neg_ids: Optional[torch.Tensor] = None,  # [S] shared negatives
             neg_log_q: Optional[torch.Tensor] = None,  # [S]
             pos_log_q: Optional[torch.Tensor] = None,  # [B*T]; see _head_loss
             deterministic: bool = False,
             generator: Optional[torch.Generator] = None,
             table_override: Optional[torch.Tensor] = None,  # [K, D]; see encode
             out_table_override: Optional[torch.Tensor] = None):  # [K2, H], untied
        """Masked training loss of a batch {inputs, targets, mask[, users]}.
        Returns (sum of loss, sum of weights)."""
        h = self.encode(batch["inputs"], batch["mask"], users=batch.get("users"),
                        deterministic=deterministic, generator=generator,
                        table_override=table_override)
        return self._head_loss(h, batch["targets"], batch["mask"], neg_ids, neg_log_q,
                               pos_log_q=pos_log_q, table_override=table_override,
                               out_table_override=out_table_override)

    def loss_stream(self, batch: Dict[str, torch.Tensor], carry, *,
                    neg_ids: Optional[torch.Tensor] = None,
                    neg_log_q: Optional[torch.Tensor] = None,
                    pos_log_q: Optional[torch.Tensor] = None,
                    deterministic: bool = False,
                    generator: Optional[torch.Generator] = None,
                    table_override: Optional[torch.Tensor] = None,
                    out_table_override: Optional[torch.Tensor] = None):
        """One session-parallel window (the original GRU4Rec training
        regime, truncated BPTT): `batch` is a dense packed window {inputs,
        targets, mask, reset} (`data.batching.make_session_stream`), `carry`
        the recurrent state from the previous window (`towers.zero_carry` to
        start). Returns (sum of loss, sum of weights, new carry); the trainer
        detaches the new carry at the window boundary. The sub-table
        overrides and `pos_log_q` are the sparse step's, as in `loss`."""
        if self.arch != "gru4rec":
            raise ValueError("session-parallel streaming needs an RNN tower")
        if self.use_user_embedding:
            raise ValueError("session streams are anonymous; disable use_user_embedding")
        x = self._lookup(self._input_table(table_override), batch["inputs"],
                         sharded=table_override is None)
        if not deterministic:
            x = dropout(x, self.dropout_rate, generator)
        h, new_carry = self.tower(x, batch["mask"], carry=carry, reset=batch["reset"],
                                  deterministic=deterministic, generator=generator)
        loss_sum, w_sum = self._head_loss(h, batch["targets"], batch["mask"],
                                          neg_ids, neg_log_q, pos_log_q=pos_log_q,
                                          table_override=table_override,
                                          out_table_override=out_table_override)
        return loss_sum, w_sum, new_carry

    def _head_loss(self, h, targets, mask, neg_ids, neg_log_q, pos_log_q=None,
                   table_override=None, out_table_override=None):
        """The sparse step passes its sub-tables: `targets` and `neg_ids`
        are then positions in the output sub-table (`out_table_override`
        when the tables are untied, else `table_override`), and `pos_log_q`
        comes precomputed from the original ids (the logQ correction needs
        ids, not positions). Accidental hits are found by position: with
        the exact budget remapping is a bijection on the ids present, so the
        answer is the same; a capped budget sends every overflowed id to the
        one sentinel position, as the JAX package does."""
        B, T, H = h.shape
        h2 = h.reshape(B * T, H)
        t2 = targets.reshape(B * T)
        w2 = mask.reshape(B * T).float()
        if out_table_override is not None:
            out_table = out_table_override
        elif table_override is not None:
            if not self.tie_embeddings:
                raise ValueError("untied output table needs out_table_override")
            out_table = table_override
        else:
            out_table = self.output_table()
        if self.loss_type == "full_softmax":
            if self.sharded and out_table_override is None and table_override is None:
                return sharded_full_softmax_loss(h2, out_table, self.output_bias_value(), t2,
                                                 w2, self.mesh, num_valid=self.vocab_size)
            return reference.full_softmax_loss(
                h2, out_table.to(self.compute_dtype), t2, w2,
                bias=self.output_bias_value(),
                num_valid=self.vocab_size if self.table_size > self.vocab_size else None,
            )
        if self.loss_type not in SAMPLED_LOSSES:
            raise ValueError(f"unknown loss {self.loss_type!r}")
        if neg_ids is None:
            raise ValueError(f"{self.loss_type} needs neg_ids")
        whole = out_table_override is None and table_override is None
        pos_emb = self._lookup(out_table, t2, sharded=whole)
        if whole and self.sharded:  # the negatives are alike on every rank
            neg_emb = replicated_gather(out_table, neg_ids, self.mesh,
                                        dtype=self.compute_dtype, use_pallas=self.use_pallas)
        else:
            neg_emb = self._lookup(out_table, neg_ids)
        if self.loss_type == "sampled_softmax":
            if pos_log_q is None and neg_log_q is not None:
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
        if candidates is None and self.sharded:
            raise ValueError("scores over the whole catalog of a row-sharded model: rank "
                             "with eval.sharded.sharded_ranks / sharded_topk")
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
        cand = self._lookup(out_table, candidates, sharded=True)  # [B, C, H]
        logits = torch.einsum("bh,bch->bc", h_last, cand).float()
        if bias is not None:  # plain lookups of the bias, sharded or whole
            if self.sharded:
                b = sharded_gather(bias[:, None], candidates, self.mesh,
                                   dedup=self.dedup_lookup, use_pallas=False)
            else:
                b = reference.embedding_gather(bias[:, None], candidates)
            logits = logits + b[..., 0].float()
        return logits


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def build_model(cfg: ModelConfig, vocab_size: int, *, num_users: int = 0,
                neg_sampler: str = "log_uniform",
                device: str | torch.device = DEFAULT_DEVICE,
                mesh: Optional[Mesh] = None, mesh_cfg=None) -> SeqRecModel:
    """The model a `ModelConfig` describes, on `device` (CUDA unless the
    caller asks for another; raises without CUDA). Parameters are zeros until
    a state_dict is loaded (see models.convert). With a `mesh` and
    `mesh_cfg.shard_embeddings`, the tables are padded to divide the model
    axis (`padded_vocab`, as the JAX package pads them) and, past one
    shard, held as this rank's shard."""
    dev = resolve_device(device)
    shard = bool(mesh_cfg is not None and mesh_cfg.shard_embeddings and mesh is not None)
    table_size, user_table_size = vocab_size, num_users + 1
    if shard:
        table_size = padded_vocab(vocab_size, mesh.shape[MODEL_AXIS])
        user_table_size = padded_vocab(num_users + 1, mesh.shape[MODEL_AXIS])
    return SeqRecModel(
        vocab_size,
        table_size=table_size,
        user_table_size=user_table_size,
        num_users=num_users,
        use_user_embedding=cfg.use_user_embedding,
        arch=cfg.arch,
        embed_dim=cfg.embed_dim,
        hidden=cfg.hidden,
        num_layers=cfg.num_layers,
        cell_type=cfg.cell_type,
        residual=cfg.residual,
        num_heads=cfg.num_heads,
        mlp_dim=cfg.mlp_dim if cfg.mlp_dim is not None else 4 * cfg.embed_dim,
        max_len=cfg.max_len,
        remat=cfg.remat,
        dropout_rate=cfg.dropout_rate,
        loss_type=cfg.loss,
        neg_sampler=neg_sampler,
        tie_embeddings=cfg.tie_embeddings,
        output_bias=cfg.loss == "full_softmax",
        use_pallas=cfg.use_pallas,
        param_dtype=_dtype(cfg.param_dtype),
        compute_dtype=_dtype(cfg.compute_dtype),
        device=dev,
        mesh=mesh,
        shard_embeddings=shard,
        dedup_lookup=True if mesh_cfg is None else mesh_cfg.dedup_lookup,
    )
