"""Per-op dispatch between the hand-written kernels and the plain versions.

`use_pallas` is the model's flag of the same name (`ModelConfig.use_pallas`).
When it is true the op goes to its kernel module in `ops/cuda/`, which
launches the kernel for a CUDA tensor (or raises for one it cannot take) and
uses the plain version for a CPU tensor. When it is false the op goes to the
plain version in `ops/reference.py` on any device. There is no other switch
and no fallback from a kernel to the plain version.
"""

from __future__ import annotations

from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import gather as cuda_gather
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import head as cuda_head


def embedding_gather(table, ids, *, use_pallas: bool = True):
    if use_pallas:
        return cuda_gather.embedding_gather(table, ids)
    return reference.embedding_gather(table, ids)


def gru_scan(x, h0, w_x, w_h, b_x=None, b_h=None, *, reset_mask=None,
             use_pallas: bool = True):
    if use_pallas:
        return cuda_gru.gru_scan(x, h0, w_x, w_h, b_x, b_h,
                                 reset_mask=reset_mask)
    return reference.gru_scan(x, h0, w_x, w_h, b_x, b_h, reset_mask=reset_mask)


def sampled_softmax_loss(h, pos_emb, neg_emb, targets, neg_ids, weights, *,
                         pos_log_q=None, neg_log_q=None,
                         use_pallas: bool = True):
    if use_pallas:
        return cuda_head.sampled_softmax_loss(
            h, pos_emb, neg_emb, targets, neg_ids, weights,
            pos_log_q=pos_log_q, neg_log_q=neg_log_q)
    return reference.sampled_softmax_loss(
        h, pos_emb, neg_emb, targets, neg_ids, weights,
        pos_log_q=pos_log_q, neg_log_q=neg_log_q)
