"""Train state, learning-rate schedules and the optimizer: the port of
`seqrec_tpu/train/state.py`.

The optimizer mirrors the JAX package's optax chain, in its order and with
its formulas, written out in plain tensor code over a dict of parameters:

    clip_by_global_norm(grad_clip_norm)        (when grad_clip_norm > 0)
    scale_by_adam | scale_by_rss(0.1, 1e-7) | identity
    add_decayed_weights(weight_decay, decay_mask)   (when weight_decay > 0)
    scale_by_learning_rate(schedule)

It is functional, as optax is: `update` returns new tensors and new state
and changes nothing it was given, so a step can be replayed from a state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from seqrec_tpu_torch.config import TrainConfig

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


def decay_mask(params: Tensors) -> Dict[str, bool]:
    """Weight-decay mask: decay only matrices that are not embedding tables
    (biases, norms and the tables are left alone, as in AdamW practice)."""
    return {name: p.dim() >= 2 and "embedding" not in name
            for name, p in params.items()}


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tensors  # state_dict names -> tensors (flax layouts)
    opt_state: Dict
    # The per-step generators are seeded from (rng_seed, step): the JAX
    # package's `jax.random.key(seed + 1)` folded with the step.
    rng_seed: int


def make_schedule(cfg: TrainConfig) -> Schedule:
    """optax's constant / cosine_decay / warmup_cosine_decay schedules as
    functions of the update count."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if cfg.lr_schedule == "cosine":
        return _cosine(lr, cfg.num_steps)
    if cfg.lr_schedule == "warmup_cosine":
        warmup = cfg.warmup_steps
        decay = _cosine(lr, max(cfg.num_steps, warmup + 1) - warmup)

        def schedule(count: int) -> float:
            if count >= warmup:
                return decay(count - warmup)
            # optax.linear_schedule(0, lr, warmup), as polynomial_schedule.
            frac = 1 - min(max(count, 0), warmup) / warmup
            return (0.0 - lr) * frac + lr

        return schedule
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def _cosine(init_value: float, decay_steps: int) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Optimizer:
    """`init(params) -> state`; `update(grads, state, params) -> (updates,
    new_state)`; `apply(params, updates) -> new params`."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adam", "adagrad", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.clip = cfg.grad_clip_norm if cfg.grad_clip_norm and cfg.grad_clip_norm > 0 else None
        self.weight_decay = cfg.weight_decay if cfg.weight_decay and cfg.weight_decay > 0 else 0.0
        self.schedule = make_schedule(cfg)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8  # optax.scale_by_adam
        self.rss_init, self.rss_eps = 0.1, 1e-7  # scale_by_rss as the JAX package sets it

    def init(self, params: Tensors) -> Dict:
        state: Dict = {"count": 0}
        if self.kind == "adam":
            state["mu"] = {k: torch.zeros_like(p) for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        elif self.kind == "adagrad":
            state["sum_of_squares"] = {k: torch.full_like(p, self.rss_init)
                                       for k, p in params.items()}
        return state

    def update(self, grads: Tensors, state: Dict, params: Tensors
               ) -> Tuple[Tensors, Dict]:
        u = dict(grads)
        if self.clip is not None:
            # optax: select(norm < max, t, (t / norm) * max); not
            # torch's clip_grad_norm_, which scales by max / (norm + 1e-6).
            g_norm = global_norm(u.values())
            u = {k: torch.where(g_norm < self.clip, g, (g / g_norm) * self.clip)
                 for k, g in u.items()}
        count = state["count"]
        new_state: Dict = {"count": count + 1}
        if self.kind == "adam":
            b1, b2 = self.b1, self.b2
            mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in u.items()}
            nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in u.items()}
            c1 = 1 - b1 ** (count + 1)
            c2 = 1 - b2 ** (count + 1)
            u = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps) for k in u}
            new_state.update(mu=mu, nu=nu)
        elif self.kind == "adagrad":
            sos = {k: g * g + state["sum_of_squares"][k] for k, g in u.items()}
            u = {k: torch.where(sos[k] > 0, torch.rsqrt(sos[k] + self.rss_eps), 0.0) * g
                 for k, g in u.items()}
            new_state["sum_of_squares"] = sos
        if self.weight_decay:
            mask = decay_mask(params)
            u = {k: g + self.weight_decay * params[k] if mask[k] else g
                 for k, g in u.items()}
        step_size = -self.schedule(count)
        return {k: step_size * g for k, g in u.items()}, new_state

    @staticmethod
    def apply(params: Tensors, updates: Tensors) -> Tensors:
        return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)
