"""Negative samplers: the port's copy of `seqrec_tpu/data/negative.py`.

Distributions over REAL item ids 1..V-1 (0 is pad):

- uniform: each real item equally likely;
- log_uniform: P(rank k) ∝ log((k+2)/(k+1)) over frequency-ordered ids (the
  TF `log_uniform_candidate_sampler` lineage). Item ids are assigned by
  decreasing frequency at prep time, so rank == id-1 and this approximates
  the unigram distribution. Sampling is with replacement; accidental hits
  vs. the positives are removed inside the loss.

Draws happen on the generator's device from an explicit `torch.Generator`.
They are not the JAX package's draws (threefry and Philox differ); the
log-probabilities are the same formulas in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _log_f32(v: float) -> float:
    """log(v) in f32, on the host: a constant built as a device tensor from
    a Python scalar would be a pageable copy that waits for the stream."""
    return float(torch.log(torch.tensor(v, dtype=torch.float32)))


def _uniform_log_q(vocab_size: int) -> float:
    """-log(V - 1) in f32, as `-jnp.log(vocab_size - 1.0)` computes it."""
    return -_log_f32(vocab_size - 1.0)


def sample_uniform(gen: torch.Generator, num: int, vocab_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ids [num] int32, log_q [num] f32) under the uniform law."""
    ids = torch.randint(1, vocab_size, (num,), generator=gen, device=gen.device,
                        dtype=torch.int32)
    log_q = torch.full((num,), _uniform_log_q(vocab_size), dtype=torch.float32,
                       device=gen.device)
    return ids, log_q


def sample_log_uniform(gen: torch.Generator, num: int, vocab_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zipf-ish sampler: rank k = floor(exp(u*log(R+1)))-1, R = vocab_size-1.

    Returns (ids [num] int32 in [1, vocab_size-1], log_q [num] f32)."""
    R = vocab_size - 1
    u = torch.rand((num,), generator=gen, device=gen.device, dtype=torch.float32)
    k = torch.floor(torch.exp(u * _log_f32(R + 1.0)) - 1.0).to(torch.int32)
    ids = torch.clamp(k, 0, R - 1) + 1
    return ids, log_uniform_log_prob(ids, vocab_size)


def log_uniform_log_prob(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """log P(id) under the log-uniform sampler (for the logQ correction).

    Defined over real ids >= 1; id 0 (pad) is clamped to id 1 so the result
    stays finite: pad positions are masked out of the loss, but an inf here
    would turn 0-weighted terms into NaNs."""
    R = vocab_size - 1
    k = (torch.clamp(ids, min=1) - 1).to(torch.float32)
    p = torch.log((k + 2.0) / (k + 1.0)) / _log_f32(R + 1.0)
    return torch.log(torch.clamp(p, min=1e-30))


def pos_log_prob(ids: torch.Tensor, vocab_size: int, kind: str) -> torch.Tensor:
    """log Q(id) of POSITIVE targets under the configured negative sampler
    (the logQ correction must use the law the negatives were drawn from)."""
    if kind == "uniform":
        return torch.full(ids.shape, _uniform_log_q(vocab_size),
                          dtype=torch.float32, device=ids.device)
    if kind == "log_uniform":
        return log_uniform_log_prob(ids, vocab_size)
    raise ValueError(f"unknown negative sampler {kind!r}")


def sample_negatives(gen: torch.Generator, num: int, vocab_size: int, kind: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if kind == "uniform":
        return sample_uniform(gen, num, vocab_size)
    if kind == "log_uniform":
        return sample_log_uniform(gen, num, vocab_size)
    raise ValueError(f"unknown negative sampler {kind!r}")

