"""Eval harness: full-catalog and sampled-negative ranking protocols, the
port of `seqrec_tpu/eval/harness.py`.

- "full": rank the held-out item against the whole catalog (pad masked
  out): exact metrics, the GRU4Rec paper's protocol.
- "sampled": rank against 1 positive and N sampled negatives not in the
  user's history, the SASRec paper's 100-negative protocol. The candidates
  come from numpy (`sample_eval_candidates_batch`), so the same seed gives
  the same candidates as the JAX package.

Metric sums are accumulated over batches on the host in f64 and finalized
to means at the end. The JAX package's compiled-step cache has no
counterpart here (eager torch compiles nothing).

Over a mesh (`runtime.mesh`), each rank evaluates its own shard of the
users (`host_shard=(rank, world)`; the sampled protocol's candidates from
`seed + 7919 rank`, as a JAX host draws them), and the sums are summed over
the world at the end, so the metrics are global. A model with row-sharded
tables ranks the full protocol with `eval.sharded.sharded_ranks` (its
lookups are collectives too), so the ranks first agree on the largest
number of batches any of them holds and the others pad with empty batches:
a collective that one rank skips would hang the rest.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from seqrec_tpu_torch.config import EvalConfig
from seqrec_tpu_torch.data.batching import make_eval_batches, pad_batch_rows
from seqrec_tpu_torch.data.dataset import SequenceDataset
from seqrec_tpu_torch.data.batching import _pack_eval
from seqrec_tpu_torch.eval import chunked
from seqrec_tpu_torch.eval.sharded import sharded_ranks
from seqrec_tpu_torch.eval.metrics import (
    finalize_metrics,
    mask_scores,
    rank_metrics,
    ranks_from_scores,
)


def sample_eval_candidates(
    history: np.ndarray,
    target: int,
    num_negatives: int,
    vocab_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """[1 + N] candidate ids: the target first, then negatives not in
    history or {target, 0}. The one-row version, the batch sampler's
    semantics for the tests; the harness uses
    `sample_eval_candidates_batch`."""
    forbidden = set(history.tolist()) | {int(target), 0}
    out = np.empty(1 + num_negatives, dtype=np.int32)
    out[0] = target
    n = 0
    while n < num_negatives:
        cand = rng.integers(1, vocab_size, size=2 * (num_negatives - n))
        for c in cand:
            if c not in forbidden:
                out[1 + n] = c
                forbidden.add(int(c))
                n += 1
                if n == num_negatives:
                    break
    return out


def sample_eval_candidates_batch(
    inputs: np.ndarray,  # [B, T] padded histories (0 = pad)
    targets: np.ndarray,  # [B]
    num_negatives: int,
    vocab_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """[B, 1 + N] candidates: the target first, then distinct negatives a
    row, not in its history or {target, 0}. Vectorized over the batch:
    rejection rounds over all rows at once, membership by the row-offset
    key (row * V + id makes all rows one sorted array). With N much below
    the vocabulary the first round almost always fills every row."""
    B = inputs.shape[0]
    N = num_negatives
    out = np.zeros((B, 1 + N), np.int32)
    out[:, 0] = targets
    count = np.zeros(B, np.int64)  # negatives accepted a row
    V = np.int64(vocab_size)

    # Forbidden: history and target; grows by each round's acceptances.
    forb = np.concatenate([inputs, targets[:, None]], axis=1).astype(np.int64)
    active = np.flatnonzero(count < N)
    while active.size:
        a = active
        # Sorted global keys of the forbidden sets (rows ascending, values
        # sorted within a row: one sorted array).
        fkeys = np.sort(forb[a], axis=1) + np.arange(a.size)[:, None] * V
        fkeys = fkeys.reshape(-1)
        draw = rng.integers(1, vocab_size, size=(a.size, 2 * N))
        dkeys = draw + np.arange(a.size)[:, None] * V
        pos = np.searchsorted(fkeys, dkeys.reshape(-1))
        pos = np.minimum(pos, fkeys.size - 1)
        member = (fkeys[pos] == dkeys.reshape(-1)).reshape(a.size, 2 * N)
        # Duplicates within a draw: keep the first occurrence a row.
        order = np.argsort(draw, axis=1, kind="stable")
        sorted_d = np.take_along_axis(draw, order, axis=1)
        dup_sorted = np.concatenate(
            [np.zeros((a.size, 1), bool), sorted_d[:, 1:] == sorted_d[:, :-1]],
            axis=1,
        )
        dup = np.zeros_like(dup_sorted)
        np.put_along_axis(dup, order, dup_sorted, axis=1)
        ok = ~member & ~dup
        # The first `need` acceptances of each row go into `out`.
        cum = np.cumsum(ok, axis=1)
        need = N - count[a]
        take = ok & (cum <= need[:, None])
        r_idx, c_idx = np.nonzero(take)
        dest = 1 + count[a][r_idx] + cum[r_idx, c_idx] - 1
        out[a[r_idx], dest] = draw[r_idx, c_idx]
        taken = take.sum(axis=1)
        count[a] += taken
        # Later rounds reject this round's acceptances too.
        still = count < N
        if still.any():
            forb = np.concatenate([forb, out[:, 1:].astype(np.int64)], axis=1)
        active = np.flatnonzero(still)
    return out


def _call(model, params, method: str, *args, **kwargs):
    return torch.func.functional_call(model, params, args, {"method": method, **kwargs})


def _output_table(model, params):
    """(output table, output bias or None) from the parameters."""
    table = params["item_embedding" if model.tie_embeddings else "output_embedding"]
    return table, params.get("output_bias") if model.has_output_bias else None


@torch.inference_mode()
def _full_sums(model, params, batch, ks, use_chunked: bool, chunk: int,
               exclude_history: bool, mesh=None) -> Dict[str, torch.Tensor]:
    users = batch.get("users")
    # eval.exclude_history: a user's own history must not outrank the
    # held-out target. The model saw only the last max_len items, so that
    # window is what is excluded.
    excl = batch["inputs"] if exclude_history else None
    if model.sharded:
        h_last = _call(model, params, "last_hidden", batch["inputs"], batch["mask"], users=users)
        table, bias = _output_table(model, params)
        ranks = sharded_ranks(table, h_last.float(), batch["target"], mesh, bias=bias,
                              num_valid=model.vocab_size, exclude=excl)
        return rank_metrics(ranks, batch["valid"], ks)
    if use_chunked:
        h_last = _call(model, params, "last_hidden", batch["inputs"], batch["mask"], users=users)
        table, bias = _output_table(model, params)
        ranks = chunked.chunked_ranks(table, h_last, batch["target"], bias=bias,
                                      num_valid=model.vocab_size,
                                      compute_dtype=model.compute_dtype, chunk=chunk,
                                      exclude=excl)
        return rank_metrics(ranks, batch["valid"], ks)
    scores = _call(model, params, "scores", batch["inputs"], batch["mask"], users=users)
    if excl is not None:
        # Never exclude the held-out target itself (a repeated item stays
        # rankable): such entries go to the pad column, masked anyway.
        excl = torch.where(excl == batch["target"][:, None], torch.zeros_like(excl), excl)
    ranks = ranks_from_scores(mask_scores(scores, exclude=excl), batch["target"])
    return rank_metrics(ranks, batch["valid"], ks)


@torch.inference_mode()
def _sampled_sums(model, params, batch, ks) -> Dict[str, torch.Tensor]:
    scores = _call(model, params, "scores", batch["inputs"], batch["mask"],
                   users=batch.get("users"), candidates=batch["candidates"])
    target_idx = torch.zeros(scores.shape[0], dtype=torch.int64, device=scores.device)
    return rank_metrics(ranks_from_scores(scores, target_idx), batch["valid"], ks)


def evaluate(
    model,
    params: Dict[str, torch.Tensor],
    ds: SequenceDataset,
    eval_cfg: EvalConfig,
    *,
    split: str = "val",
    max_len: int = 200,
    mesh=None,
) -> Dict[str, float]:
    """Metrics of `model` with `params` (a state_dict-shaped dict, as
    `TrainState.params`) on `ds`'s `split`, on the parameters' device. Over
    a `mesh` (every rank calls this together), this rank's users, and the
    global metrics."""
    device = params["item_embedding"].device
    B = eval_cfg.batch_size
    # Large catalogs: stream the catalog in blocks instead of building
    # [B, V] scores (eval/chunked.py); on past CHUNK_THRESHOLD_BYTES, or
    # forced by eval.full_chunk_items.
    table_rows = getattr(model, "table_size", None) or model.vocab_size
    use_chunked = (eval_cfg.full_chunk_items is not None
                   or 4 * B * table_rows > chunked.CHUNK_THRESHOLD_BYTES)
    chunk = eval_cfg.full_chunk_items or chunked.DEFAULT_CHUNK
    if eval_cfg.protocol not in ("full", "sampled"):
        raise ValueError(f"unknown eval protocol {eval_cfg.protocol!r}")
    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    rng = np.random.default_rng(eval_cfg.seed + 7919 * rank)
    batches = list(make_eval_batches(ds, split=split, batch_size=B, max_len=max_len,
                                     max_batches=eval_cfg.max_batches,
                                     host_shard=(rank, world)))
    if model.sharded:  # every rank runs the same number of collective lookups
        empty = pad_batch_rows(_pack_eval([], max_len), B)
        batches += [empty] * (mesh.pmax_int(len(batches)) - len(batches))
    sums: Optional[Dict[str, np.ndarray]] = None
    for batch in batches:
        batch = pad_batch_rows(batch, B)
        if eval_cfg.protocol == "sampled":
            batch["candidates"] = sample_eval_candidates_batch(
                batch["inputs"], batch["target"], eval_cfg.num_negatives, ds.vocab_size, rng)
        dev_batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if eval_cfg.protocol == "sampled":
            out = _sampled_sums(model, params, dev_batch, eval_cfg.ks)
        else:
            out = _full_sums(model, params, dev_batch, eval_cfg.ks, use_chunked, chunk,
                             bool(eval_cfg.exclude_history), mesh)
        # One copy to the host a batch; f32 sums widened to f64.
        vals = torch.stack(list(out.values())).cpu().numpy().astype(np.float64)
        out = dict(zip(out, vals))
        if sums is None:
            sums = out
        else:
            for k, v in out.items():
                sums[k] += v
    if world > 1:
        sums = _allreduce_sums(sums, eval_cfg.ks, mesh)
    if not sums:
        return {"count": 0.0}
    return finalize_metrics(sums)


def _allreduce_sums(sums: Optional[Dict[str, np.ndarray]], ks, mesh) -> Dict[str, np.ndarray]:
    """The ranks' metric sums summed over the world, in one order of keys
    (a rank without a batch sends zeros)."""
    keys = ["count"] + [f"{m}@{k}" for k in ks for m in ("recall", "mrr", "ndcg")]
    local = np.asarray([float((sums or {}).get(k, 0.0)) for k in keys], np.float64)
    total = mesh.psum_host(local)
    return {k: total[i] for i, k in enumerate(keys)}
