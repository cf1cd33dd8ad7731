"""Plain PyTorch versions of the hot ops: the port's counterpart of
`seqrec_tpu/ops/xla.py`.

Each function keeps the JAX oracle's semantics and layout (weights stored
[in, out], gate blocks r|z|n), so the same numpy inputs give the same answer
on both sides. They are the CPU path, the path taken when `use_pallas` is
false, and the yardstick each hand-written kernel in `ops/cuda/` is held
against. Ported so far: the gather and its scatter-add transpose, the GRU
scan and its analytic BPTT backward, the scoring heads and the five training
losses. The LSTM and attention come with the slices that run them.
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


def embedding_scatter_add(g: torch.Tensor, ids: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """The gather's transpose: a zeroed [num_rows, D] f32 table with each
    row of `g` ([*ids.shape, D]) added at its id. Ids in [-V, V) wrap; any
    other id's row is dropped, as XLA's scatter drops out-of-bounds updates."""
    ids = ids.reshape(-1).long()
    g = g.reshape(ids.shape[0], -1).float()
    valid = (ids >= -num_rows) & (ids < num_rows)
    rows = torch.where(ids < 0, ids + num_rows, ids)[valid]
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_put_((rows,), g[valid], accumulate=True)


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


# GRU backward: `seqrec_tpu/ops/pallas/gru.py::_gru_bwd_math`, line for line.
# Every product that does not depend on the running cotangent is hoisted out
# of the reverse loop (the gate recompute before it, the weight-grad
# reductions after it); the loop itself (`gru_bwd_scan`) is what the reverse
# recurrence kernel in csrc/gru.cu computes.


def gru_bwd_hoist(x_proj: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                  w_h: torch.Tensor, b_h: torch.Tensor,
                  reset: Optional[torch.Tensor] = None):
    """Recompute what the forward consumed, in parallel over T. Returns
    (h_in [B,T,H] in hs.dtype, keep [B,T,1] f32 or None, r, z, n, hn, each
    [B,T,H] f32). `x_proj` is the f32 input projection with b_x added."""
    H = h0.shape[-1]
    h_in = torch.cat([h0.to(hs.dtype)[:, None], hs[:, :-1]], dim=1)
    keep = None if reset is None else (1.0 - reset.float())[:, :, None]
    h_in_f = h_in.float() if keep is None else h_in.float() * keep
    h_proj = torch.matmul(h_in_f, w_h.float()) + b_h.float()
    r = torch.sigmoid(x_proj[..., :H] + h_proj[..., :H])
    z = torch.sigmoid(x_proj[..., H:2 * H] + h_proj[..., H:2 * H])
    hn = h_proj[..., 2 * H:]
    n = torch.tanh(x_proj[..., 2 * H:] + r * hn)
    return h_in if keep is None else h_in_f, keep, r, z, n, hn


def gru_bwd_scan(r: torch.Tensor, z: torch.Tensor, n: torch.Tensor,
                 hn: torch.Tensor, h_in: torch.Tensor, g_ys: torch.Tensor,
                 w_h: torch.Tensor, keep: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse recurrence, t = T-1 .. 0, with an f32 cotangent carry.
    Returns (d_xp [B,T,3H] f32, dh0 [B,H] f32)."""
    B, T, H = r.shape
    w_h_t = w_h.float().T  # [3H, H]
    dh_next = torch.zeros((B, H), dtype=torch.float32, device=r.device)
    d_xp = [None] * T
    for t in range(T - 1, -1, -1):
        r_t, z_t, n_t = r[:, t], z[:, t], n[:, t]
        dh = dh_next + g_ys[:, t].float()
        dn = dh * (1.0 - z_t)
        dz = dh * (h_in[:, t].float() - n_t)
        dpre_n = dn * (1.0 - n_t * n_t)
        dr = dpre_n * hn[:, t]
        dpre_z = dz * z_t * (1.0 - z_t)
        dpre_r = dr * r_t * (1.0 - r_t)
        d_xp[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        d_hproj = torch.cat([dpre_r, dpre_z, dpre_n * r_t], dim=-1)
        dh_next = dh * z_t + d_hproj @ w_h_t
        if keep is not None:
            dh_next = dh_next * keep[:, t]
    return torch.stack(d_xp, dim=1), dh_next


def gru_bwd_math(x_proj: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                 w_h: torch.Tensor, b_h: torch.Tensor, g_ys: torch.Tensor,
                 reset: Optional[torch.Tensor] = None, *, scan=None):
    """Analytic GRU BPTT. Returns (d_x_proj, d_h0, d_w_h, d_b_h), all f32.
    `scan` runs the reverse loop (`gru_bwd_scan`'s signature; the kernel
    wrapper passes its own)."""
    H = h0.shape[-1]
    h_in, keep, r, z, n, hn = gru_bwd_hoist(x_proj, hs, h0, w_h, b_h, reset)
    d_xp, dh0 = (scan or gru_bwd_scan)(r, z, n, hn, h_in, g_ys, w_h, keep)
    d_hproj = torch.cat([d_xp[..., :2 * H], d_xp[..., 2 * H:] * r], dim=-1)
    dW = torch.einsum("bth,btk->hk", h_in.float(), d_hproj)
    db = d_hproj.sum(dim=(0, 1))
    return d_xp, dh0, dW, db


# ---------------------------------------------------------------------------
# Scoring heads and training losses (ops/xla.py's, same formulas)
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # logit of an accidental hit / a masked column


def full_logits(h: torch.Tensor, table: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores against the whole catalog: [.., H] x [V, H] -> [.., V]."""
    logits = h @ table.to(h.dtype).T
    if bias is not None:
        logits = logits + bias.to(h.dtype)
    return logits


def masked_sum(per_pos: torch.Tensor, weights: torch.Tensor):
    """(sum(w * per_pos), sum(w)); where(): a non-finite value at a 0-weight
    (pad) position must not poison the sum (0 * inf = nan)."""
    w = weights.float()
    return torch.sum(torch.where(w > 0, per_pos, 0.0) * w), torch.sum(w)


def full_softmax_loss(h: torch.Tensor, table: torch.Tensor,
                      targets: torch.Tensor, weights: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      num_valid: Optional[int] = None):
    """Masked cross-entropy over the full catalog: h [N, H], table [V, H],
    targets [N], weights [N]. Columns >= num_valid score -1e30. Returns
    (sum of loss, sum of weights)."""
    logits = full_logits(h, table, bias).float()
    if num_valid is not None and num_valid < table.shape[0]:
        cols = torch.arange(table.shape[0], device=logits.device)
        logits = torch.where(cols[None, :] < num_valid, logits, NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, targets.long()[:, None])[:, 0]
    w = weights.float()
    return torch.sum((logz - tgt) * w), torch.sum(w)


def _pair_logits(h, pos_emb, neg_emb):
    """f32 positive logits [N] and negative logits [N, S], products in the
    working dtype as the JAX oracle computes them."""
    pos_logit = torch.sum(h * pos_emb, dim=-1).float()
    neg_logit = (h @ neg_emb.T).float()
    return pos_logit, neg_logit


def _hits(targets, neg_ids):
    return neg_ids[None, :].long() == targets[:, None].long()  # [N, S]


def sampled_softmax_loss(h, pos_emb, neg_emb, targets, neg_ids, weights, *,
                         pos_log_q=None, neg_log_q=None):
    """Sampled softmax with shared negatives, logQ correction and
    accidental-hit removal (TF `sampled_softmax_loss` semantics)."""
    pos_logit, neg_logit = _pair_logits(h, pos_emb, neg_emb)
    if pos_log_q is not None:
        pos_logit = pos_logit - pos_log_q
    if neg_log_q is not None:
        neg_logit = neg_logit - neg_log_q[None, :]
    neg_logit = torch.where(_hits(targets, neg_ids), NEG_INF, neg_logit)
    logits = torch.cat([pos_logit[:, None], neg_logit], dim=-1)
    return masked_sum(torch.logsumexp(logits, dim=-1) - pos_logit, weights)


def sampled_softmax_nll(h, pos_emb, neg_emb, targets, neg_ids, pos_log_q,
                        neg_log_q) -> torch.Tensor:
    """Per-row NLL [N] f32 as the TPU head kernel computes it
    (`ops/pallas/softmax_head.py::_head_kernel`): every product in f32,
    logsumexp over [pos, S negatives - logQ, hits at -1e30] minus the
    positive logit. The plain version of the head kernel."""
    hf = h.float()
    pos_logit = torch.sum(hf * pos_emb.float(), dim=-1) - pos_log_q
    s = hf @ neg_emb.float().T - neg_log_q[None, :]
    s = torch.where(_hits(targets, neg_ids), NEG_INF, s)
    m = torch.maximum(s.max(dim=-1).values, pos_logit)
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=-1)
                        + torch.exp(pos_logit - m))
    return lse - pos_logit


def sampled_softmax_nll_bwd(g, h, pos_emb, neg_emb, targets, neg_ids,
                            pos_log_q, neg_log_q):
    """Gradients (dh, dpos, dneg) of sum(g * nll) by recompute, as the JAX
    package's `_head_core_bwd` takes the VJP of its XLA formula: products in
    the working dtype, softmax in f32, the [N, S] probabilities cast back to
    the working dtype for the two products."""
    dt = h.dtype
    pos_logit, neg_logit = _pair_logits(h, pos_emb, neg_emb)
    pos_logit = pos_logit - pos_log_q
    neg_logit = torch.where(_hits(targets, neg_ids), NEG_INF,
                            neg_logit - neg_log_q[None, :])
    lse = torch.logsumexp(torch.cat([pos_logit[:, None], neg_logit], dim=-1), dim=-1)
    d_pos = (g * (torch.exp(pos_logit - lse) - 1.0)).to(dt)[:, None]  # [N, 1]
    d_neg = (g[:, None] * torch.exp(neg_logit - lse[:, None])).to(dt)  # [N, S]
    dh = d_pos * pos_emb + d_neg @ neg_emb
    return dh, d_pos * h, d_neg.T @ h


def top1_loss(h, pos_emb, neg_emb, targets, neg_ids, weights):
    """TOP1 (Hidasi et al., ICLR'16): mean_j sigmoid(neg_j - pos) +
    sigmoid(neg_j^2), accidental hits excluded from the mean."""
    pos_logit, neg_logit = _pair_logits(h, pos_emb, neg_emb)
    hits = _hits(targets, neg_ids)
    per_pair = (torch.sigmoid(neg_logit - pos_logit[:, None])
                + torch.sigmoid(neg_logit * neg_logit))
    per_pair = torch.where(hits, 0.0, per_pair)
    denom = torch.clamp((~hits).sum(dim=-1).float(), min=1.0)
    return masked_sum(per_pair.sum(dim=-1) / denom, weights)


def bpr_max_loss(h, pos_emb, neg_emb, targets, neg_ids, weights, *,
                 reg: float = 1.0):
    """BPR-max (Hidasi & Karatzoglou, CIKM'18):
    -log(sum_j s_j sigmoid(pos - neg_j)) + reg * sum_j s_j neg_j^2, with s the
    softmax of the negative logits (hits masked out)."""
    pos_logit, neg_logit = _pair_logits(h, pos_emb, neg_emb)
    masked = torch.where(_hits(targets, neg_ids), NEG_INF, neg_logit)
    s = torch.softmax(masked, dim=-1)
    p = torch.sum(s * torch.sigmoid(pos_logit[:, None] - neg_logit), dim=-1)
    nll = -torch.log(torch.clamp(p, min=1e-12))
    reg_term = reg * torch.sum(s * neg_logit * neg_logit, dim=-1)
    return masked_sum(nll + reg_term, weights)


def bpr_loss(h, pos_emb, neg_emb, targets, neg_ids, weights):
    """BPR (Rendle et al. 2009): -log sigmoid(pos - neg), averaged over the
    shared negatives that are not accidental hits."""
    pos_logit, neg_logit = _pair_logits(h, pos_emb, neg_emb)
    hits = _hits(targets, neg_ids)
    per_pair = torch.where(hits, 0.0,
                           -torch.nn.functional.logsigmoid(pos_logit[:, None] - neg_logit))
    denom = torch.clamp((~hits).sum(dim=-1).float(), min=1.0)
    return masked_sum(per_pair.sum(dim=-1) / denom, weights)
