"""Sparse (row-wise) embedding updates for large catalogs: the port of
`seqrec_tpu/train/sparse_embed.py`.

Dense training builds a [V, D] gradient for the item table every step; at
V = 10M, D = 128 that is 5.1 GB of gradient and as much optimizer-state
traffic. The sparse step instead:

1. collects every item id the step touches (inputs, targets, sampled
   negatives) into a sorted [K] set of unique ids, K a static budget
   (`collect_unique`: sorts and cumulative sums, no host sync and no
   data-dependent shape, so a CUDA graph can capture it);
2. remaps each id tensor to positions in that set (`remap`: a left-side
   `searchsorted`) and differentiates through the gathered [K, D]
   sub-table: the cotangent is [K, D], never [V, D];
3. applies the optimizer to the touched rows only (`row_update`), in place
   on the table and its row state, with `index_add_` of deltas masked to
   each id's first occurrence, so the duplicate fill slots of the unique
   set add exact zeros and the result does not depend on the order of the
   adds.

Optimizer semantics against the dense path: sgd and adagrad are exact
(their state for an untouched row is unchanged by a zero gradient); adam
becomes lazy adam: untouched rows skip the decay of their moments, and the
bias correction uses the global step.

Formulas and constants mirror optax, as the JAX package's do. Against the
JAX package on the CPU, everything is bit for bit but adagrad's inverse
square root: XLA:CPU's `rsqrt` is an approximation that differs from the
correctly rounded value by 1 ulp in about one case in seven, where
`torch.rsqrt` is `1 / sqrt`; that row update agrees to 1 ulp.

Row-sharded tables (`mesh.shard_embeddings`, the mesh's 'model' axis
M > 1) compose with this as in the JAX package: the trainer takes the
unique set of the GLOBAL batch (its ids all-gathered over the world), the
same [K] set on every rank; `sharded_sub_table` fetches the [K, D]
sub-table, each shard the rows it owns (the gather kernel's shard-window
variant, zeros elsewhere) summed over the model group, replicated;
the step differentiates the replicated sub-table as on one device (its
cotangent summed over the world); and `sharded_row_update` applies the
optimizer on each shard to the rows it owns only (`row_update` at local
row offsets, other shards' ids masked). No dense [V, D] or [V/M, D]
gradient exists.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from seqrec_tpu_torch.models.model import SAMPLED_LOSSES
from seqrec_tpu_torch.ops import dispatch, reference
from seqrec_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh

# optax defaults, mirrored (see the module docstring).
ADAGRAD_INIT_ACC = 0.1
ADAGRAD_EPS = 1e-7
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

SPARSE_OPTIMIZERS = ("sgd", "adagrad", "adam")


def unique_budget(num_ids: int, table_rows: int) -> int:
    """The static unique-row budget: every id distinct, capped by the table."""
    return min(int(num_ids), int(table_rows))


def collect_unique(ids: torch.Tensor, budget: int) -> torch.Tensor:
    """[budget] sorted unique ids of `ids`, the smallest `budget` of them,
    padded with zeros that sort to the front: `jnp.sort(jnp.unique(ids,
    size=budget, fill_value=0))`, bit for bit.

    No host sync and a static shape: sort the ids, flag each first
    occurrence, write it at its rank (the cumulative count of first
    occurrences) into a zeroed [budget] buffer, ranks past the budget into
    one spare slot that is dropped, and sort the buffer again. The fill
    zeros lead, where the leftmost match of `remap` and the first-occurrence
    mask of `row_update` make them harmless."""
    s = torch.sort(ids.reshape(-1)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    slot = torch.where(first & (rank < budget), rank, torch.full_like(rank, budget))
    buf = torch.zeros(budget + 1, dtype=s.dtype, device=s.device)
    buf.scatter_(0, slot, s)  # each kept slot is written once; the spare slot is dropped
    return torch.sort(buf[:budget]).values


def remap(uids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Positions of `ids` in the sorted unique set `uids` (int32). With
    duplicates (the fill zeros) the leftmost match wins, so a fill slot is
    never referenced."""
    return torch.searchsorted(uids, ids.to(uids.dtype).contiguous(), out_int32=True)


def remap_capped(uids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`remap` for a capped budget (train.sparse_unique_budget): an id
    absent from `uids` (the step touched more distinct rows than the budget)
    maps to position K = len(uids), the zeros sentinel row the caller
    appends, never to a neighbouring id's row as a plain searchsorted
    would."""
    K = uids.shape[0]
    ids = ids.to(uids.dtype).contiguous()
    pos = torch.searchsorted(uids, ids, out_int32=True)
    safe = torch.clamp(pos, 0, K - 1)
    found = uids[safe.long()] == ids
    return torch.where(found, safe, torch.full_like(safe, K))


def _first_occurrence_mask(uids: torch.Tensor) -> torch.Tensor:
    """[K] True where a slot holds the first occurrence of its id (`uids`
    sorted): the duplicate fill slots get False."""
    first = torch.ones_like(uids, dtype=torch.bool)
    first[1:] = uids[1:] != uids[:-1]
    return first


def init_row_opt(optimizer: str, table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The optimizer state of a sparse table: full size, updated row-wise."""
    if optimizer == "sgd":
        return {}
    if optimizer == "adagrad":
        return {"acc": torch.full(table.shape, ADAGRAD_INIT_ACC, dtype=torch.float32,
                                  device=table.device)}
    if optimizer == "adam":
        return {"m": torch.zeros(table.shape, dtype=torch.float32, device=table.device),
                "v": torch.zeros(table.shape, dtype=torch.float32, device=table.device)}
    raise ValueError(f"sparse_embedding_update: unsupported optimizer {optimizer!r} "
                     f"(supported: {SPARSE_OPTIMIZERS})")


def _bias_correction(b: float, step: int) -> float:
    """1 - b ** (step + 1) in f32, as the JAX step computes it from its f32
    step counter; on the host, so no scalar is copied to the device."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(step + 1))


def row_update(optimizer: str, lr: float, table: torch.Tensor,
               row_opt: Dict[str, torch.Tensor], uids: torch.Tensor,
               g_rows: torch.Tensor, step: int, *,
               indices: Optional[torch.Tensor] = None,
               extra_valid: Optional[torch.Tensor] = None) -> None:
    """One optimizer step on the rows `uids` (sorted, with fill duplicates)
    of `table` [V, D] and of its row state `row_opt`, IN PLACE: `g_rows`
    [K, D] is the gradient of the gathered sub-table, `step` the 0-based
    global step (adam's bias correction).

    Every write is an `index_add_` of a delta masked to the first occurrence
    of its id: a duplicate fill slot adds exactly zero, for every optimizer
    below (adam's moment deltas included), so the order of the adds does not
    change the result. `indices` ([K], default `uids`) and `extra_valid`
    ([K] bool) are for a row shard (`sharded_row_update`): the rows are
    written at local offsets, and the slots of ids that other shards own are
    masked: their delta is exactly zero at whatever row they were clipped
    to."""
    first = _first_occurrence_mask(uids)
    if extra_valid is not None:
        first = first & extra_valid
    valid = first[:, None].to(torch.float32)
    g = g_rows.to(torch.float32) * valid
    idx = (uids if indices is None else indices).long()

    if optimizer == "sgd":
        table.index_add_(0, idx, (-lr * g).to(table.dtype))
        return

    if optimizer == "adagrad":
        acc = row_opt["acc"]
        acc_rows = acc[idx]
        acc_new = acc_rows + g * g
        inv = torch.where(acc_new > 0, torch.rsqrt(acc_new + ADAGRAD_EPS),
                          torch.zeros_like(acc_new))
        upd = (-lr * g * inv) * valid
        table.index_add_(0, idx, upd.to(table.dtype))
        acc.index_add_(0, idx, (acc_new - acc_rows) * valid)
        return

    if optimizer == "adam":
        # Lazy adam: the moments of untouched rows keep their values.
        m, v = row_opt["m"], row_opt["v"]
        m_rows, v_rows = m[idx], v[idx]
        m_new = ADAM_B1 * m_rows + (1.0 - ADAM_B1) * g
        v_new = ADAM_B2 * v_rows + (1.0 - ADAM_B2) * g * g
        m_hat = m_new / _bias_correction(ADAM_B1, step)
        v_hat = v_new / _bias_correction(ADAM_B2, step)
        upd = (-lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)) * valid
        # A fill slot's moment delta is (B - 1) * moment, not zero at g = 0:
        # the `valid` factor is what keeps it out.
        table.index_add_(0, idx, upd.to(table.dtype))
        m.index_add_(0, idx, (m_new - m_rows) * valid)
        v.index_add_(0, idx, (v_new - v_rows) * valid)
        return

    raise ValueError(f"unsupported optimizer {optimizer!r}")


def sharded_sub_table(table: torch.Tensor, uids: torch.Tensor, mesh: Mesh, *,
                      use_pallas: bool = True) -> torch.Tensor:
    """The [K, D] rows `uids` of a row-sharded table whose shard on this
    rank is `table`, replicated on every rank of the model group: each
    shard's owned rows (the shard-window gather, zeros elsewhere), summed
    over the model group. A fetch: the caller differentiates the returned
    sub-table, never through this. With one shard, the gather."""
    M = mesh.shape[MODEL_AXIS]
    if M == 1:
        return dispatch.embedding_gather(table, uids, use_pallas=use_pallas)
    row0 = mesh.axis_index(MODEL_AXIS) * table.shape[0]
    contrib = dispatch.embedding_gather_window(table, uids, row0, use_pallas=use_pallas)
    return mesh.psum(contrib, MODEL_AXIS)


def sharded_row_update(optimizer: str, lr: float, table: torch.Tensor,
                       row_opt: Dict[str, torch.Tensor], uids: torch.Tensor,
                       g_rows: torch.Tensor, step: int, mesh: Mesh) -> None:
    """`row_update` on a row shard (`table` and `row_opt` this rank's
    shard; `uids` and `g_rows` replicated): each shard updates the rows it
    owns, in place; other shards' ids are clipped into the window and
    masked (their delta is exactly zero)."""
    if mesh.shape[MODEL_AXIS] == 1:
        return row_update(optimizer, lr, table, row_opt, uids, g_rows, step)
    rows = table.shape[0]
    local, owned = reference.window_ids(uids, mesh.axis_index(MODEL_AXIS) * rows, rows)
    return row_update(optimizer, lr, table, row_opt, uids, g_rows, step,
                      indices=local.clamp(0, rows - 1), extra_valid=owned)


def validate_config(cfg) -> None:
    """Fail fast on option combinations the sparse path does not define
    (`cfg` is the whole RunConfig)."""
    t = cfg.train
    problems = []
    if t.optimizer not in SPARSE_OPTIMIZERS:
        problems.append(f"optimizer {t.optimizer!r} not in {SPARSE_OPTIMIZERS}")
    if cfg.model.loss not in SAMPLED_LOSSES:
        problems.append(f"loss {cfg.model.loss!r} needs the full table every step; "
                        f"sparse updates require one of {SAMPLED_LOSSES}")
    if t.weight_decay and t.weight_decay > 0:
        problems.append("weight_decay would need dense row touches")
    if problems:
        raise ValueError("train.sparse_embedding_update=True is incompatible with: "
                         + "; ".join(problems))
