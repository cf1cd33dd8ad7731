"""The training step: the port of `seqrec_tpu/train/trainer.py`'s dense
`_train_step_impl`, `_train_step_multi_impl` and its compact wire format.

    trainer = Trainer(cfg, ds)               # ds: anything with vocab_size, num_users
    state = trainer.init_state(seed)
    state, metrics = trainer.train_step(state, wire_or_dict)
    state, metrics = trainer.train_step_multi(state, wires)   # [K, B, T+2]

A step runs eagerly on the device: negatives drawn on the device, the loss
through the kernels (gather, the tower's GRU or LSTM scan or causal
attention, sampled-softmax head) and their backward kernels, the global
gradient norm, and the optimizer. It is functional, as the JAX step is:
the state it was given is left as it was.
Metrics stay on the device (no host sync inside a step). The fit loop, the
data pipeline and a CUDA-graph capture of a K-step group come with later
slices (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data.negative import sample_negatives
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.models.model import SAMPLED_LOSSES
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE, resolve_device
from seqrec_tpu_torch.train.state import (
    TrainState,
    global_norm,
    make_optimizer,
)

Batch = Union[np.ndarray, torch.Tensor, Dict[str, np.ndarray]]


class Trainer:
    def __init__(self, cfg: RunConfig, ds, *,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.cfg = cfg
        self.ds = ds
        self.device = resolve_device(device)
        if cfg.train.sparse_embedding_update:
            raise NotImplementedError(
                "train.sparse_embedding_update: ROADMAP.md Queue 1 item 8 "
                "(sparse embedding updates)")
        if cfg.data.session_parallel:
            raise NotImplementedError(
                "data.session_parallel: ROADMAP.md Queue 1 item 7 "
                "(session-parallel training)")
        if cfg.mesh.shard_embeddings and cfg.mesh.model_axis > 1:
            raise NotImplementedError(
                "mesh.shard_embeddings: ROADMAP.md Queue 1 item 9 (multi-GPU)")
        self.model = build_model(cfg.model, ds.vocab_size, num_users=ds.num_users,
                                 neg_sampler=cfg.data.neg_sampler,
                                 device=self.device)
        self.optimizer = make_optimizer(cfg.train)

    # ---- state ----------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Parameters drawn with numpy from `seed` (`models.convert`'s flax
        initializer distributions), zero optimizer state, step 0."""
        seed = self.cfg.train.seed if seed is None else seed
        params = {k: v.to(self.device)
                  for k, v in flax_to_state_dict(random_params(self.model, seed)).items()}
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params), rng_seed=seed + 1)

    def _generators(self, state: TrainState) -> Tuple[torch.Generator, torch.Generator]:
        """(negatives, dropout) generators of this step: a function of the
        state's seed and step only, so K grouped steps draw what K single
        steps draw."""
        base = (state.rng_seed % 2 ** 31) * 2 ** 32 + 2 * state.step
        gens = []
        for offset in (0, 1):
            g = torch.Generator(device=self.device)
            g.manual_seed(base + offset)
            gens.append(g)
        return gens[0], gens[1]

    def sample_negatives(self, gen: torch.Generator):
        """(neg_ids [S], neg_log_q [S] or None) for one step."""
        m = self.cfg.model
        neg_ids, neg_log_q = sample_negatives(gen, m.num_negatives,
                                              self.ds.vocab_size,
                                              self.cfg.data.neg_sampler)
        return neg_ids, (neg_log_q if m.loss == "sampled_softmax" else None)

    # ---- the step ---------------------------------------------------------

    def train_step(self, state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a [B, T+2] wire (numpy or a tensor) or a batch dict
        {inputs, targets, mask[, users]} of numpy arrays."""
        batch = self._device_batch(batch)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, w_sum = self.forward(state, params, batch)
        grads = self.backward(loss, params)
        return self.update(state, params, grads, loss, w_sum)

    def forward(self, state: TrainState, params, batch):
        """The step's loss (sum / max(weights, 1)) and weight sum, with this
        step's negatives and dropout."""
        neg_gen, dropout_gen = self._generators(state)
        neg_ids = neg_log_q = None
        if self.cfg.model.loss in SAMPLED_LOSSES:
            neg_ids, neg_log_q = self.sample_negatives(neg_gen)
        loss_sum, w_sum = torch.func.functional_call(
            self.model, params, (batch,),
            {"method": "loss", "neg_ids": neg_ids, "neg_log_q": neg_log_q,
             "deterministic": False, "generator": dropout_gen},
        )
        return loss_sum / torch.clamp(w_sum, min=1.0), w_sum

    @staticmethod
    def backward(loss: torch.Tensor, params) -> Dict[str, torch.Tensor]:
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def update(self, state: TrainState, params, grads, loss, w_sum
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Gradient norm, non-finite flag, optional sanitizing, and the
        optimizer: the new state and the step's metrics."""
        gnorm = global_norm(grads.values())
        # One NaN/inf anywhere poisons the global norm: one scalar check.
        nonfinite = ~torch.isfinite(gnorm) | ~torch.isfinite(loss)
        if self.cfg.train.sanitize_nans:
            grads = {k: torch.where(torch.isfinite(g).all(), g, torch.nan_to_num(g))
                     for k, g in grads.items()}
        params = {k: v.detach() for k, v in params.items()}
        updates, opt_state = self.optimizer.update(grads, state.opt_state, params)
        new_state = TrainState(step=state.step + 1,
                               params=self.optimizer.apply(params, updates),
                               opt_state=opt_state, rng_seed=state.rng_seed)
        metrics = {"loss": loss.detach(), "tokens": w_sum.detach(),
                   "grad_norm": gnorm, "nonfinite": nonfinite}
        return new_state, metrics

    def train_step_multi(self, state: TrainState, wires: Union[np.ndarray, torch.Tensor]
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K steps over a [K, B, T+2] group of wires: the same math as K
        `train_step` calls (each step's draws depend on its step number
        only). Metrics over the group: mean loss, summed tokens, max
        gradient norm, any non-finite."""
        wires = self._to_device(wires)
        ms = []
        for k in range(wires.shape[0]):
            state, m = self.train_step(state, wires[k])
            ms.append(m)
        metrics = {
            "loss": torch.stack([m["loss"] for m in ms]).mean(),
            "tokens": torch.stack([m["tokens"] for m in ms]).sum(),
            # Max over the group: a spike anywhere in it must show.
            "grad_norm": torch.stack([m["grad_norm"] for m in ms]).max(),
            "nonfinite": torch.stack([m["nonfinite"] for m in ms]).any(),
        }
        return state, metrics

    # ---- the compact wire format --------------------------------------------
    #
    # A bucketed train batch's {inputs, targets, mask, users} is fully
    # determined by the item sequence (targets = inputs shifted by one, mask =
    # non-pad targets), so one [B, T+2] token array, int16 when the vocab
    # fits, carries it and the step rebuilds the planes on the device.

    @property
    def _wire_dtype(self):
        if self.ds.vocab_size < 2 ** 15 and (self.ds.num_users + 1) < 2 ** 15:
            return np.int16
        return np.int32

    def pack_train_batch(self, batch: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Pack a CANONICAL bucketed train batch: tokens[:, :T] = inputs,
        tokens[r, L_r] = last target (the one token inputs lacks),
        tokens[:, T+1] = users. None when the batch is not canonical (a
        `reset` plane, a mask that is not `targets != 0`, targets that are
        not the inputs shifted by one)."""
        if "targets" not in batch or "reset" in batch:
            return None
        inputs, targets, mask = batch["inputs"], batch["targets"], batch["mask"]
        B, T = inputs.shape
        tgt_nz = targets != 0
        if mask.shape != targets.shape or not (mask == tgt_nz).all():
            return None
        m = mask[:, 1:] > 0
        if not (inputs[:, 1:][m] == targets[:, :-1][m]).all():
            return None
        lens = tgt_nz.sum(1)
        tokens = np.zeros((B, T + 2), self._wire_dtype)
        tokens[:, :T] = inputs
        rows = np.flatnonzero(lens > 0)
        tokens[rows, lens[rows]] = targets[rows, lens[rows] - 1]
        tokens[:, T + 1] = batch.get("users", np.zeros((B,), np.int32))
        return tokens

    @staticmethod
    def _unpack_wire(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inverse of pack_train_batch, on the wire's device. `inputs` carries
        the sequence's continuation at the first pad position instead of 0;
        that position is loss-masked and cannot reach any unmasked output
        (the RNN state flows forward), so loss and gradients are unchanged."""
        T = packed.shape[1] - 2
        tokens = packed[:, :T + 1].to(torch.int32)
        targets = tokens[:, 1:]
        return {
            "inputs": tokens[:, :-1],
            "targets": targets,
            "mask": (targets != 0).to(torch.float32),
            "users": packed[:, T + 1].to(torch.int32),
        }

    def _to_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return t.to(self.device, non_blocking=True)

    def _device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return self._unpack_wire(self._to_device(batch))
