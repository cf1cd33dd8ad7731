"""Batch inference: the port of `seqrec_tpu/eval/infer.py`.

Histories come in as dicts (`{"user": optional id, "history": [item ids]}`,
one JSON line each in the CLI) and recommendations go out in the same order
as `{"user", "items", "scores"}`. Each batch is padded to [batch_size,
max_len], scored against the whole catalog on the model's device, and its
top `k + max_len` items are fetched so that the host-side exclusion of seen
items cannot empty the list. Where [batch_size, V] f32 scores would exceed
`chunked.CHUNK_THRESHOLD_BYTES` the catalog is scored in blocks
(`chunked.chunked_topk`), with the same result.

Top-k is a stable descending sort, so equal scores keep the lower item id
first, as `jax.lax.top_k` orders them.

A model with row-sharded tables (`SeqRecModel.sharded`) takes the sharded
top-k (`eval.sharded.sharded_topk`): every rank of its model group calls
`recommend` with the same histories, and each gets the whole answer.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seqrec_tpu_torch.eval import chunked
from seqrec_tpu_torch.eval.metrics import mask_scores
from seqrec_tpu_torch.eval.sharded import sharded_topk


def _pack(
    histories: Sequence[Sequence[int]],
    users: Sequence[int],
    batch_size: int,
    max_len: int,
):
    B = batch_size
    inputs = np.zeros((B, max_len), np.int32)
    mask = np.zeros((B, max_len), np.float32)
    u = np.zeros((B,), np.int32)
    for r, h in enumerate(histories):
        h = list(h)[-max_len:]
        inputs[r, : len(h)] = h
        mask[r, : len(h)] = 1.0
        u[r] = users[r]
    return inputs, mask, u


@torch.inference_mode()
def topk_step(model, inputs: torch.Tensor, mask: torch.Tensor,
              users: torch.Tensor, fetch_k: int,
              chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores of one packed batch, pad column masked, top `fetch_k` as
    (values [B, fetch_k] f32, item ids [B, fetch_k]). `chunk`: score the
    catalog in blocks of that many rows (None: all at once). A row-sharded
    model takes the sharded top-k (a collective over its model group)."""
    if model.sharded:
        return sharded_topk(model.output_table(),
                            model.last_hidden(inputs, mask, users=users).float(), fetch_k,
                            model.mesh, bias=model.output_bias_value(),
                            num_valid=model.vocab_size)
    if chunk is not None:
        return chunked.chunked_topk(
            model.output_table(), model.last_hidden(inputs, mask, users=users), fetch_k,
            bias=model.output_bias_value(), num_valid=model.vocab_size,
            compute_dtype=model.compute_dtype, chunk=chunk)
    scores = mask_scores(model.scores(inputs, mask, users=users))
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :fetch_k], ids[:, :fetch_k]


def recommend(
    model,
    histories: Iterable[Dict],
    *,
    k: int = 10,
    batch_size: int = 64,
    max_len: int = 200,
    exclude_history: bool = True,
    chunk: Optional[int] = None,
) -> Iterator[Dict]:
    """Yield {"user", "items", "scores"} per input history dict (in order),
    computed on the device that holds `model`. `chunk`: the catalog block
    of the chunked top-k (None: `chunked.DEFAULT_CHUNK`, read at call
    time)."""
    use_chunked = (not model.sharded
                   and 4 * batch_size * model.table_size > chunked.CHUNK_THRESHOLD_BYTES)
    block = (chunk or chunked.DEFAULT_CHUNK) if use_chunked else None
    device = model.item_embedding.device
    # Over-fetch so host-side history exclusion cannot empty the list.
    fetch_k = min(k + (max_len if exclude_history else 0), model.vocab_size - 1)

    pending: List[Dict] = []

    def flush() -> Iterator[Dict]:
        hs = [p.get("history", []) for p in pending]
        us = [int(p.get("user", 0)) for p in pending]
        while len(hs) < batch_size:
            hs.append([])
            us.append(0)
        inputs, mask, u = _pack(hs, us, batch_size, max_len)
        vals, ids = topk_step(
            model, torch.from_numpy(inputs).to(device),
            torch.from_numpy(mask).to(device), torch.from_numpy(u).to(device),
            fetch_k, block,
        )
        vals = vals.cpu().numpy()
        ids = ids.cpu().numpy()
        for r, p in enumerate(pending):
            seen = (
                {int(x) for x in p.get("history", [])}
                if exclude_history else set()
            )
            items: List[int] = []
            scores: List[float] = []
            for i, v in zip(ids[r], vals[r]):
                if int(i) in seen:
                    continue
                items.append(int(i))
                scores.append(float(v))
                if len(items) == k:
                    break
            yield {"user": p.get("user"), "items": items, "scores": scores}
        pending.clear()

    for rec in histories:
        pending.append(rec)
        if len(pending) == batch_size:
            yield from flush()
    if pending:
        yield from flush()
