"""The training engine: the port of `seqrec_tpu/train/trainer.py`, its dense
and session-parallel steps, their compact wire formats, the fit loop and
eval.

    trainer = Trainer(cfg)                   # the dataset from cfg.data
    state, last_eval = trainer.fit()         # loader -> prefetcher -> steps
    metrics = trainer.evaluate(state, split="test")

    trainer = Trainer(cfg, ds)               # ds: anything with vocab_size, num_users
    state = trainer.init_state(seed)
    state, metrics = trainer.train_step(state, wire_or_dict)
    state, metrics = trainer.train_step_multi(state, wires)   # [K, B, W]

A step runs eagerly on the device: negatives drawn on the device, the loss
through the kernels (gather, the tower's GRU or LSTM scan or causal
attention, sampled-softmax head) and their backward kernels, the global
gradient norm, and the optimizer. It is functional, as the JAX step is:
the state it was given is left as it was, with one exception. With
`train.sparse_embedding_update` the step touches only the rows of the
batch's ids (`_sparse_step`, `train/sparse_embed.py`): no [V, D] gradient
exists, and the [V, D] tables and their row state (`embed_opt`) are updated
IN PLACE, the counterpart of the JAX step's donated state; the new state
shares them with the old one. A caller that replays a step from one state
clones it first (`state.clone_state`).

With `data.session_parallel` a batch is one window of a session-parallel
stream (`data.batching.make_session_stream`): the step runs
`SeqRecModel.loss_stream` from `state.carry`, the recurrent state the
previous window left, and the new state carries the window's final state,
detached (truncated BPTT: gradients stop at the window boundary, as
`jax.lax.stop_gradient` stops them in the JAX step).
Metrics stay on the device (no host sync inside a step).

`fit` runs the JAX package's loop: the native C++ loader (or the Python
batcher when the engine cannot be built), `train.steps_per_call` batches
of one bucket packed into one [K, B, T+2] wire group on the feeder side,
a `DevicePrefetcher` that stages wires through pinned memory on a side
stream, the log, eval, heartbeat and checkpoint cadences at group
boundaries, the `debug_nans` halt and the `fail_after_step` return (with a
checkpoint). With `train.resume` it restores the newest checkpoint under
`out_dir/ckpt`, written on this mesh or another (`train/checkpoint.py`
reshards it where every leaf's global shape agrees, as orbax does), and
resumes the data where the run left it: the bucketed loaders fast-forward
past the batches consumed, on this run's mesh (its `host_shard` and global
batch, as a JAX process with another device count does), a
session-parallel stream restores its snapshot with the engine that took
it. A killed and resumed
run equals a straight one bit for bit. With `train.profile_dir`, process 0
traces the groups from the one holding `profile_steps[0]` to the one
holding `profile_steps[1]` (or the loop's end) with `torch.profiler`, the
CUDA activity included on a CUDA device (it raises if the profiler cannot
trace it), each group under a `seqrec_group[lo,hi)` label, and writes a
Chrome trace into `profile_dir` (`profile_trace` names it). A CUDA-graph
capture of the K-step group is ROADMAP.md Queue 1 item 3b.
`train.compilation_cache_dir` is read and does nothing: it keys XLA's
persistent compilation cache, and nothing in eager torch compiles. The
port's persistent build cache is `ops/_build.py`'s content-hashed
`seqrec_tpu_torch/build/` (listed in `.gitignore`); moving the builds to
that key's `~/.cache/seqrec_xla` would take them out of the checkout.

Multi-device (one process per device, `runtime.mesh`): with a process group
up, the trainer makes the ('data', 'model') mesh from `mesh.model_axis` (or
takes the caller's) and trains as the JAX package does on the same global
batch. `data.batch_size` is per device: the global batch is batch_size x
world (`local_batch`, `global_batch`), and each rank reads its own shard of
the users (`host_shard`), as a JAX host does. The loss is global,
sum / max(global weights, 1): each rank all-reduces the weight sum before
its backward pass and differentiates its own loss sum over it, and the
gradients are summed: over the world for replicated leaves (the tower, an
unsharded table), over the data group for row-sharded ones (the tables
with `mesh.shard_embeddings`, their optimizer moments). The clip's global
norm counts each row once (the sharded leaves' squares summed over the
model group, the replicated ones once). The sparse step takes the unique
set of the global batch (the ids all-gathered over the world), fetches the
sub-table with `sharded_sub_table`, sums its cotangent over the world and
updates each shard's own rows (`sharded_row_update`). Negatives are drawn
alike on every rank (from the seed and the step); dropout draws from a
stream of the rank's own past rank 0. The session carry stays rank-local.
Only rank 0 logs; each rank beats its own heartbeat and checkpoints its
own shard (`train/checkpoint.py`). Without a process group the mesh is
1 x 1 and nothing of this runs.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import native
from seqrec_tpu_torch.data.batching import make_session_stream, make_train_batches
from seqrec_tpu_torch.data.dataset import load_dataset
from seqrec_tpu_torch.data.negative import pos_log_prob, sample_negatives
from seqrec_tpu_torch.data.prefetch import DevicePrefetcher, HostStager, StagedBatch
from seqrec_tpu_torch.eval.harness import evaluate
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import init_state_dict
from seqrec_tpu_torch.models.model import SAMPLED_LOSSES
from seqrec_tpu_torch.models.towers import zero_carry
from seqrec_tpu_torch.ops import _build, embedding_gather
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE
from seqrec_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, WORLD, Mesh, make_mesh, rank_device
from seqrec_tpu_torch.train import sparse_embed
from seqrec_tpu_torch.train.checkpoint import CheckpointManager
from seqrec_tpu_torch.train.state import (
    TrainState,
    global_norm,
    make_optimizer,
)
from seqrec_tpu_torch.utils.logging import Heartbeat, MetricsLogger

Batch = Union[np.ndarray, torch.Tensor, Dict[str, np.ndarray]]


def _crossed(every: int, lo: int, hi: int) -> bool:
    """True when a step s in [lo, hi) has (s + 1) % every == 0: fit's
    cadence checks over a group of steps (at hi == lo + 1, exactly
    (lo + 1) % every == 0)."""
    return every > 0 and (hi // every) > (lo // every)


class DeclinedDict(dict):
    """A batch dict that `pack` already declined (not canonical): put_batch
    does not try to pack it a second time."""


def _group_wires(it, pack, k: int, limit: int):
    """Group up to `k` consecutive same-bucket canonical batches from `it`
    into one stacked [k, B, W] wire array (train.steps_per_call). Yields
    (bucket, payload), payload one of: a stacked group, a single [B, W]
    wire, or the batch dict (a DeclinedDict) when `pack` declines it. Order
    is kept exactly; at most `limit` batches go out inside full groups, so
    that fit never runs past num_steps."""
    buf = []  # staged (bucket, wire) of one bucket and shape
    emitted = 0
    for bucket, batch in it:
        wire = pack(batch)
        if buf and (wire is None or bucket != buf[0][0] or wire.shape != buf[0][1].shape):
            for b, w in buf:
                yield b, w
            emitted += len(buf)
            buf = []
        if wire is None:
            yield bucket, DeclinedDict(batch)
            emitted += 1
            continue
        buf.append((bucket, wire))
        if len(buf) == k:
            if emitted + k <= limit:
                yield bucket, np.stack([w for _, w in buf])
            else:  # the tail: not enough steps left for a full group
                for b, w in buf:
                    yield b, w
            emitted += k
            buf = []
    for b, w in buf:
        yield b, w


class _RankRows:
    """The rows [r B, (r + 1) B) of every batch of a global bucketed stream
    (`Trainer.train_iterator`); closes the stream it reads."""

    def __init__(self, it, rank: int, rows: int):
        self._it, self._lo, self._hi = it, rank * rows, (rank + 1) * rows

    def __iter__(self):
        return self

    def __next__(self):
        bucket, batch = next(self._it)
        return bucket, {k: v[self._lo:self._hi] for k, v in batch.items()}

    def close(self) -> None:
        if hasattr(self._it, "close"):
            self._it.close()


def _ready(staged):
    return staged.ready() if isinstance(staged, StagedBatch) else staged


def _detach(carry):
    """The carry with every tensor detached from the step's graph."""
    if isinstance(carry, torch.Tensor):
        return carry.detach()
    return tuple(_detach(c) for c in carry)


class Trainer:
    def __init__(self, cfg: RunConfig, ds=None, *,
                 device: Union[str, torch.device] = DEFAULT_DEVICE,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = rank_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh.model_axis)
        self.ds = ds if ds is not None else load_dataset(cfg.data)
        self._sparse = bool(cfg.train.sparse_embedding_update)
        if self._sparse:
            sparse_embed.validate_config(cfg)
        self.model = build_model(cfg.model, self.ds.vocab_size, num_users=self.ds.num_users,
                                 neg_sampler=cfg.data.neg_sampler,
                                 device=self.device, mesh=self.mesh, mesh_cfg=cfg.mesh)
        # The leaves held as row shards (their gradients sum over the data
        # group only, their squares over the model group in the norm).
        self._sharded = frozenset(self.model.sharded_rows)
        if self._sparse:
            # The state holds the [V, D] tables and every call passes them
            # in; the module's own copies would be a second table on the
            # device, so they keep only their shapes.
            for name in self._sparse_table_names():
                p = getattr(self.model, name)
                setattr(self.model, name, nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"), requires_grad=False))
        # The sparse step clips the global norm of the tower's and the
        # sub-tables' gradients together; the optimizer must not clip again.
        self.optimizer = make_optimizer(cfg.train, with_clip=not self._sparse)
        # data.batch_size is per device, as in the JAX package.
        self.num_devices = self.mesh.size
        self.local_batch = cfg.data.batch_size
        self.global_batch = cfg.data.batch_size * self.num_devices
        self.host_shard = (self.mesh.rank, self.mesh.size)
        self.data_engine: Optional[str] = None  # "native" or "python", once chosen
        self._stager: Optional[HostStager] = None
        self.ckpt: Optional[CheckpointManager] = None  # fit's, when it checkpoints
        self.profile_trace: Optional[str] = None  # the trace fit wrote (profile_dir)

    # ---- state ----------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Parameters drawn with numpy from `seed` (`models.convert`'s flax
        initializer distributions; the tables in row blocks straight into
        the device), zero optimizer state, step 0, and for session-parallel
        training a zero carry in the compute dtype. In sparse mode the
        tables' optimizer state is row-wise (`embed_opt`) and `opt_state`
        covers the other parameters only."""
        seed = self.cfg.train.seed if seed is None else seed
        return self._state(init_state_dict(self.model, seed, self.device), seed, self.device)

    def abstract_state(self) -> TrainState:
        """The state's structure, shapes and dtypes on the meta device (no
        memory, nothing drawn): what a checkpoint restores into."""
        params = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                  for k, p in self.model.named_parameters()}
        return self._state(params, self.cfg.train.seed, torch.device("meta"))

    def _state(self, params, seed: int, device) -> TrainState:
        carry = None
        if self.cfg.data.session_parallel:
            m = self.cfg.model
            carry = zero_carry(m.cell_type, m.num_layers, self.cfg.data.batch_size, m.hidden,
                               self.model.compute_dtype, device)
        embed_opt = None
        if self._sparse:
            names = self._sparse_table_names()
            opt_state = self.optimizer.init({k: v for k, v in params.items() if k not in names})
            embed_opt = {n: sparse_embed.init_row_opt(self.cfg.train.optimizer, params[n])
                         for n in names}
        else:
            opt_state = self.optimizer.init(params)
        return TrainState(step=0, params=params, opt_state=opt_state, rng_seed=seed + 1,
                          carry=carry, embed_opt=embed_opt)

    def _generators(self, state: TrainState) -> Tuple[torch.Generator, torch.Generator]:
        """(negatives, dropout) generators of this step: a function of the
        state's seed and step only, so K grouped steps draw what K single
        steps draw. The negatives are alike on every rank (JAX draws them
        once a step, replicated); dropout's stream past rank 0 folds the
        rank in (JAX draws one mask over the global batch), so rank 0, and a
        run of one device, keep theirs."""
        base = (state.rng_seed % 2 ** 31) * 2 ** 32 + 2 * state.step
        seeds = [base, base + 1]
        if self.mesh.rank > 0:
            seeds[1] = int(np.random.SeedSequence([base + 1, self.mesh.rank])
                           .generate_state(1, np.uint64)[0])
        gens = []
        for seed in seeds:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
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
        """One step on a wire (numpy or a tensor: [B, T+2], or [B, T+E+W]
        for a session window) or a batch dict {inputs, targets, mask[, users]
        [, reset]} of numpy arrays or tensors."""
        batch = self._device_batch(batch)
        if self._sparse:
            neg_gen, dropout_gen = self._generators(state)
            neg_ids, neg_log_q = self.sample_negatives(neg_gen)
            return self._sparse_step(state, batch, neg_ids, neg_log_q, dropout_gen)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, w_sum, carry = self.forward(state, params, batch)
        grads = self.backward(loss, params)
        return self.update(state, params, grads, loss, w_sum, carry)

    def forward(self, state: TrainState, params, batch):
        """The step's loss (sum / max(weights, 1)), weight sum and new carry
        (detached; None unless session-parallel), with this step's negatives
        and dropout."""
        neg_gen, dropout_gen = self._generators(state)
        neg_ids = neg_log_q = None
        if self.cfg.model.loss in SAMPLED_LOSSES:
            neg_ids, neg_log_q = self.sample_negatives(neg_gen)
        kwargs = {"neg_ids": neg_ids, "neg_log_q": neg_log_q, "deterministic": False,
                  "generator": dropout_gen}
        carry = None
        if self.cfg.data.session_parallel:
            loss_sum, w_sum, carry = torch.func.functional_call(
                self.model, params, (batch, state.carry), {"method": "loss_stream", **kwargs})
            # TBPTT: the next window starts from this state, not from its graph.
            carry = _detach(carry)
        else:
            loss_sum, w_sum = torch.func.functional_call(
                self.model, params, (batch,), {"method": "loss", **kwargs})
        w_sum = self._global_weights(w_sum)
        return loss_sum / torch.clamp(w_sum, min=1.0), w_sum, carry

    def _global_weights(self, w_sum: torch.Tensor) -> torch.Tensor:
        """The weight sum of the global batch (before the backward pass: the
        loss each rank differentiates is its sum over the global weights)."""
        return self.mesh.psum(w_sum.detach(), WORLD) if self.mesh.distributed else w_sum

    @staticmethod
    def backward(loss: torch.Tensor, params) -> Dict[str, torch.Tensor]:
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def _reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each gradient summed over the ranks that share its leaf: the world
        for replicated leaves, the data group for row-sharded ones (one
        flat buffer each)."""
        if not self.mesh.distributed:
            return grads
        out = dict(grads)
        for axis, names in ((WORLD, [k for k in grads if k not in self._sharded]),
                            (DATA_AXIS, [k for k in grads if k in self._sharded])):
            if not names:
                continue
            flat = self.mesh.psum(torch.cat([grads[k].reshape(-1) for k in names]), axis)
            for k, g in zip(names, flat.split([grads[k].numel() for k in names])):
                out[k] = g.view_as(grads[k])
        return out

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the (reduced) gradients, each row counted
        once: the sharded leaves' squares summed over the model group, the
        replicated ones once."""
        sharded = [k for k in grads if k in self._sharded]
        if not sharded:
            return global_norm(grads.values())
        sq = lambda ks: sum(torch.sum(grads[k].float() * grads[k].float()) for k in ks)  # noqa: E731
        shard = self.mesh.psum(sq(sharded), MODEL_AXIS)
        return torch.sqrt(sq([k for k in grads if k not in self._sharded]) + shard)

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's loss from each rank's sum over the global
        weights."""
        return self.mesh.psum(loss.detach(), WORLD) if self.mesh.distributed else loss.detach()

    def update(self, state: TrainState, params, grads, loss, w_sum, carry=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Gradient reduction over the mesh, norm, non-finite flag, optional
        sanitizing, and the optimizer: the new state (carrying `carry`) and
        the step's metrics (global loss and tokens)."""
        grads = self._reduce_grads(grads)
        loss = self._global_loss(loss)
        gnorm = self._grad_norm(grads)
        # One NaN/inf anywhere poisons the global norm: one scalar check.
        nonfinite = ~torch.isfinite(gnorm) | ~torch.isfinite(loss)
        if self.cfg.train.sanitize_nans:
            grads = {k: torch.where(torch.isfinite(g).all(), g, torch.nan_to_num(g))
                     for k, g in grads.items()}
        params = {k: v.detach() for k, v in params.items()}
        # The clip's norm over row shards is the mesh's (on sanitized grads).
        clip_norm = None
        if self._sharded:
            clip_norm = self._grad_norm(grads) if self.cfg.train.sanitize_nans else gnorm
        updates, opt_state = self.optimizer.update(grads, state.opt_state, params,
                                                   g_norm=clip_norm)
        new_state = TrainState(step=state.step + 1,
                               params=self.optimizer.apply(params, updates),
                               opt_state=opt_state, rng_seed=state.rng_seed, carry=carry)
        metrics = {"loss": loss.detach(), "tokens": w_sum.detach(),
                   "grad_norm": gnorm, "nonfinite": nonfinite}
        return new_state, metrics

    # ---- the sparse step ---------------------------------------------------

    def _sparse_table_names(self) -> List[str]:
        names = ["item_embedding"]
        if not self.cfg.model.tie_embeddings:
            names.append("output_embedding")
        return names

    def _sparse_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                     neg_ids: torch.Tensor, neg_log_q: Optional[torch.Tensor],
                     dropout_gen: torch.Generator
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The large-catalog step (`train/sparse_embed.py`), the JAX
        package's `_sparse_step` with the same arguments: the batch's
        unique ids (inputs, targets and negatives in one set for tied
        tables; untied, the output table its own set of targets and
        negatives), the [K, D] sub-tables fetched by the gather kernel and
        differentiated in place of the tables, the tower and sub-table
        gradients clipped by their global norm together, the optimizer on
        the tower and a row update of each table and its row state, in
        place. With train.sparse_unique_budget the budget is capped: ids
        past it embed as a zeros sentinel row at position K, whose gradient
        row is dropped. No host sync and no data-dependent shape.

        Over a mesh the unique set is the global batch's (this rank's ids
        all-gathered over the world, as JAX's step sees the global batch):
        one set on every rank. Row-sharded tables fetch it with
        `sharded_sub_table` and update their own rows with
        `sharded_row_update`; the sub-tables' and the tower's gradients
        are summed over the world."""
        cfg = self.cfg
        tied = cfg.model.tie_embeddings
        use_pallas = cfg.model.use_pallas
        mesh = self.mesh
        names = self._sparse_table_names()
        tables = {n: state.params[n] for n in names}
        rest = {k: v.detach().requires_grad_(True) for k, v in state.params.items()
                if k not in tables}

        inputs, targets = batch["inputs"], batch["targets"]
        neg_ids = neg_ids.to(targets.dtype)
        all_inputs, all_targets = inputs, targets
        if mesh.distributed:
            all_inputs = mesh.all_gather(inputs, WORLD)
            all_targets = mesh.all_gather(targets, WORLD)
        out_ids = torch.cat([all_targets.reshape(-1), neg_ids])
        in_ids = torch.cat([all_inputs.reshape(-1), out_ids]) if tied else all_inputs.reshape(-1)
        rows = self.model.table_size  # the whole table's rows, sharded or not
        cap = int(cfg.train.sparse_unique_budget or 0)
        remap = sparse_embed.remap_capped if cap else sparse_embed.remap

        def unique(ids: torch.Tensor) -> torch.Tensor:
            budget = sparse_embed.unique_budget(ids.numel(), rows)
            return sparse_embed.collect_unique(ids, min(budget, cap) if cap else budget)

        def sub_table(table: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
            if self.model.sharded:
                sub = sparse_embed.sharded_sub_table(table, uids, mesh, use_pallas=use_pallas)
            else:
                sub = embedding_gather(table, uids, use_pallas=use_pallas)
            if cap:
                sub = torch.cat([sub, sub.new_zeros((1, sub.shape[1]))])
            return sub.detach().requires_grad_(True)

        uids_in = unique(in_ids)
        subs = {"in": sub_table(tables["item_embedding"], uids_in)}
        uids_out = uids_in
        if not tied:
            uids_out = unique(out_ids)
            subs["out"] = sub_table(tables["output_embedding"], uids_out)

        batch_r = dict(batch, inputs=remap(uids_in, inputs), targets=remap(uids_out, targets))
        pos_log_q = None
        if cfg.model.loss == "sampled_softmax" and neg_log_q is not None:
            # From the ORIGINAL ids (batch_r holds positions), under the law
            # the negatives were drawn from.
            pos_log_q = pos_log_prob(targets.reshape(-1), self.ds.vocab_size,
                                     cfg.data.neg_sampler)
        kwargs = {"neg_ids": remap(uids_out, neg_ids), "neg_log_q": neg_log_q,
                  "pos_log_q": pos_log_q, "deterministic": False, "generator": dropout_gen,
                  "table_override": subs["in"], "out_table_override": subs.get("out")}
        params = {**rest, **tables}
        carry = None
        if cfg.data.session_parallel:
            loss_sum, w_sum, carry = torch.func.functional_call(
                self.model, params, (batch_r, state.carry), {"method": "loss_stream", **kwargs})
            carry = _detach(carry)  # TBPTT, and no sub-table in the next step's graph
        else:
            loss_sum, w_sum = torch.func.functional_call(
                self.model, params, (batch_r,), {"method": "loss", **kwargs})
        w_sum = self._global_weights(w_sum)
        loss = loss_sum / torch.clamp(w_sum, min=1.0)

        leaves = {**{f"sub/{k}": v for k, v in subs.items()}, **rest}
        grads = self._reduce_grads(self.backward(loss, leaves))
        loss = self._global_loss(loss)
        gnorm = self._grad_norm(grads)
        nonfinite = ~torch.isfinite(gnorm) | ~torch.isfinite(loss)
        clip = cfg.train.grad_clip_norm
        if clip and clip > 0:
            # min(1, clip / max(norm, 1e-12)); a tensor numerator, so that
            # the division is one rounding (a Python float over a tensor is
            # a reciprocal and a product in torch).
            scale = torch.clamp(torch.full_like(gnorm, clip) / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        if cfg.train.sanitize_nans:
            grads = {k: torch.where(torch.isfinite(g).all(), g, torch.nan_to_num(g))
                     for k, g in grads.items()}

        rest = {k: v.detach() for k, v in rest.items()}
        updates, opt_state = self.optimizer.update({k: grads[k] for k in rest},
                                                   state.opt_state, rest)
        rest = self.optimizer.apply(rest, updates)
        lr = self.optimizer.schedule(state.step)
        with torch.no_grad():
            for name, uids, key in (("item_embedding", uids_in, "in"),
                                    ("output_embedding", uids_out, "out"))[:len(names)]:
                g = grads[f"sub/{key}"]
                if cap:
                    g = g[:-1]  # the sentinel row: overflowed ids update nothing
                if self.model.sharded:
                    sparse_embed.sharded_row_update(cfg.train.optimizer, lr, tables[name],
                                                    state.embed_opt[name], uids, g,
                                                    state.step, mesh)
                else:
                    sparse_embed.row_update(cfg.train.optimizer, lr, tables[name],
                                            state.embed_opt[name], uids, g, state.step)
        new_state = TrainState(
            step=state.step + 1,
            params={k: tables[k] if k in tables else rest[k] for k in state.params},
            opt_state=opt_state, rng_seed=state.rng_seed, carry=carry,
            embed_opt=state.embed_opt)
        metrics = {"loss": loss.detach(), "tokens": w_sum.detach(),
                   "grad_norm": gnorm, "nonfinite": nonfinite}
        return new_state, metrics

    def train_step_multi(self, state: TrainState,
                         wires: Union[np.ndarray, torch.Tensor, Sequence[Batch]]
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K steps over a [K, B, W] group of wires, or over a sequence of K
        batches (wires or dicts: a session window that does not pack ships
        as a dict): the same math as K `train_step` calls (each step's draws
        depend on its step number only; the carry threads through the K
        steps). Metrics over the group: mean loss, summed tokens, max
        gradient norm, any non-finite."""
        if not isinstance(wires, (list, tuple)):
            wires = self._to_device(wires)
        ms = []
        for k in range(len(wires)):
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

    # ---- the compact wire formats --------------------------------------------
    #
    # A bucketed train batch's {inputs, targets, mask, users} is fully
    # determined by the item sequence (targets = inputs shifted by one, mask =
    # non-pad targets), so one [B, T+2] token array, int16 when the vocab
    # fits, carries it and the step rebuilds the planes on the device. A
    # session window is determined by its inputs, the targets at session
    # ends and its reset plane: one [B, T+E+W] array (`pack_session_batch`).

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

    @property
    def _session_wire_cols(self) -> Tuple[int, int, int]:
        """(T, E, W) column layout of the session wire: T input tokens, E =
        T//2 + 1 slots for the targets at session ends (every window whose
        sessions average >= 2 transitions), W = ceil(T/8) words of reset
        bits, 8 a word. A denser window ships as a dict."""
        T = self.cfg.data.max_len
        return T, T // 2 + 1, (T + 7) // 8

    def pack_session_batch(self, batch: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Pack a session-parallel window: [B, T+E+W] = inputs, each lane's
        session-end targets in order (the one token of a session that
        `inputs` never carries: mask is all ones, and targets[t] ==
        inputs[t+1] except where a session ends, at t == T-1 or before a
        reset), and the reset plane as 8-bit words. None (ship the dict) for
        a window that is not such a stream or has more than E session ends."""
        if "reset" not in batch or "targets" not in batch:
            return None
        inputs, targets = batch["inputs"], batch["targets"]
        mask, reset = batch["mask"], batch["reset"]
        B, T = inputs.shape
        Tc, E, W = self._session_wire_cols
        if T != Tc or mask.shape != targets.shape or not (mask == 1.0).all():
            return None
        rs = reset > 0
        end = np.concatenate([rs[:, 1:], np.ones((B, 1), bool)], axis=1)
        cont = ~end[:, :-1]
        if not (targets[:, :-1][cont] == inputs[:, 1:][cont]).all():
            return None  # not a packed next-item stream
        counts = end.sum(1)
        if counts.max() > E:
            return None  # more session ends than the wire has slots
        wire = np.zeros((B, T + E + W), self._wire_dtype)
        wire[:, :T] = inputs
        r_idx, t_idx = np.nonzero(end)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        j = np.arange(len(r_idx)) - np.repeat(starts, counts)
        wire[r_idx, T + j] = targets[r_idx, t_idx]
        pad = np.zeros((B, W * 8), np.int64)
        pad[:, :T] = rs
        wire[:, T + E:] = (pad.reshape(B, W, 8) << np.arange(8)).sum(-1).astype(self._wire_dtype)
        return wire

    def _unpack_session_wire(self, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inverse of pack_session_batch, on the wire's device."""
        T, E, W = self._session_wire_cols
        B = packed.shape[0]
        dev = packed.device
        inputs = packed[:, :T].to(torch.int32)
        bt = packed[:, T:T + E].to(torch.int64)
        words = packed[:, T + E:].to(torch.int32)
        t = torch.arange(T, device=dev)
        reset = (words[:, t // 8] >> (t % 8)) & 1  # [B, T]
        end = torch.cat([reset[:, 1:], torch.ones((B, 1), dtype=reset.dtype, device=dev)], dim=1)
        idx = torch.clamp(torch.cumsum(end, dim=1) - 1, min=0)
        boundary = torch.gather(bt, 1, idx.to(torch.int64)).to(torch.int32)
        shifted = torch.cat([inputs[:, 1:], torch.zeros((B, 1), dtype=torch.int32, device=dev)],
                            dim=1)
        return {
            "inputs": inputs,
            "targets": torch.where(end == 1, boundary, shifted),
            "mask": torch.ones((B, T), dtype=torch.float32, device=dev),
            "reset": reset.to(torch.float32),
        }

    def pack_batch(self, batch) -> Optional[np.ndarray]:
        """The config's wire packer: session windows for session-parallel
        training, bucketed batches otherwise. Arrays pass through."""
        if isinstance(batch, np.ndarray):
            return batch
        if self.cfg.data.session_parallel:
            return self.pack_session_batch(batch)
        return self.pack_train_batch(batch)

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
        wire = self._to_device(batch)
        if self.cfg.data.session_parallel:
            return self._unpack_session_wire(wire)
        return self._unpack_wire(wire)

    def put_batch(self, batch):
        """Stage a host batch on the device: a wire ([B, W] or a [K, B, W]
        group), or a dict, packed into its wire when it is canonical. For
        a CUDA device a `StagedBatch` (copied through pinned memory on a
        side stream; `ready()` on the consuming thread), else tensors."""
        if isinstance(batch, dict) and not isinstance(batch, DeclinedDict):
            packed = self.pack_batch(batch)
            if packed is not None:
                batch = packed
        if self.device.type == "cuda":
            if self._stager is None:
                self._stager = HostStager(self.device,
                                          slots=self.cfg.data.prefetch_to_device + 2)
            return self._stager(batch)
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return self._to_device(batch)

    # ---- data ------------------------------------------------------------

    def train_iterator(self, skip_batches: int = 0) -> Iterator:
        """The training stream: the native engine when it is built and
        `data.use_native_loader` is set, else the Python batcher (the same
        batch semantics). `data_engine` records which. `skip_batches`
        fast-forwards a bucketed stream past that many batches without
        building them (resume); a session-parallel stream resumes from its
        snapshot instead (`fit`).

        Over several ranks a stream is built in one of two ways:
        - each rank its own shard of the users (`host_shard=(rank, world)`,
          `local_batch` rows), as a JAX host reads its own: the default;
        - with more than one bucket and the sparse step or row-sharded
          tables, every rank builds the stream of one process
          (`host_shard=(0, 1)`, `global_batch` rows) and keeps its rows
          [r B, (r + 1) B): the JAX package's one-process batch over
          several devices, bit for bit. Every rank then holds the same
          bucket, so the ids' collectives see one shape on every rank (a
          rank's own loader would pick its own bucket). Each rank does the
          host work of the whole global batch."""
        if self.cfg.data.session_parallel:
            return self._make_session_iterator()
        d = self.cfg.data
        whole = self._global_stream()
        batch, shard = (self.global_batch, (0, 1)) if whole else (self.local_batch,
                                                                   self.host_shard)
        if d.use_native_loader and native.available():
            self.data_engine = "native"
            it = native.NativeTrainLoader(
                self.ds, batch_size=batch, max_len=d.max_len, buckets=d.buckets,
                seed=d.seed, host_shard=shard, skip_batches=skip_batches)
        else:
            self.data_engine = "python"
            it = make_train_batches(
                self.ds, batch_size=batch, max_len=d.max_len, buckets=d.buckets,
                seed=d.seed, host_shard=shard, skip_batches=skip_batches)
        return _RankRows(it, self.mesh.rank, self.local_batch) if whole else it

    def _global_stream(self) -> bool:
        """Whether each rank reads its rows of one global stream (see
        `train_iterator`): several ranks, several buckets, and the ids'
        collectives of the sparse step or of row-sharded tables."""
        d = self.cfg.data
        buckets = {min(b, d.max_len) for b in d.buckets}
        return self.mesh.size > 1 and len(buckets) > 1 and bool(self._sparse or self._sharded)

    def _make_session_iterator(self, engine: str = "auto"):
        """The session-parallel stream: the native engine when it is built
        and `data.use_native_loader` is set (it fills windows and packs the
        session wire off the GIL), else the Python stream. `engine`
        ("native" or "python") pins the kind when a checkpoint written by
        that loader is resumed: their shuffles differ, so a snapshot means
        something only to the engine that took it."""
        # The snapshot ring covers the feeder's read-ahead: with
        # steps_per_call grouping it stages whole K-groups, so the gap
        # between the stream's head and the loop grows to about
        # K * (prefetch depth + 2) batches.
        spc = self._steps_per_call()
        depth = max(16, spc * (self.cfg.data.prefetch_to_device + 2) + spc)
        use_native = engine == "native" or (self.cfg.data.use_native_loader
                                            and engine != "python")
        if use_native and native.available():
            T, E, _ = self._session_wire_cols
            self.data_engine = "native"
            return native.NativeSessionLoader(
                self.ds, batch_size=self.local_batch, window=T, ends_budget=E,
                wire_dtype=self._wire_dtype, seed=self.cfg.data.seed,
                host_shard=self.host_shard, snapshot_depth=depth)
        if engine == "native":
            raise RuntimeError(
                "the checkpoint was written by the native session loader, but the native "
                f"engine is not available: {native.build_error()}")
        self.data_engine = "python"
        return make_session_stream(self.ds, batch_size=self.local_batch,
                                   window=self.cfg.data.max_len, seed=self.cfg.data.seed,
                                   host_shard=self.host_shard, snapshot_depth=depth)

    def precompile(self) -> None:
        """Build the CUDA kernels before the loop, so that no nvcc time
        falls inside the first group (the JAX package compiles its steps
        here; eager torch has nothing else to compile)."""
        if self.device.type == "cuda" and self.cfg.model.use_pallas:
            _build.build()
            for name in _build.SOURCES:
                _build.load(name)

    # ---- the loop --------------------------------------------------------

    def _steps_per_call(self) -> int:
        """The effective train.steps_per_call: debug_nans forces 1 (it halts
        at the step that went non-finite)."""
        if self.cfg.train.debug_nans:
            return 1
        return max(1, int(self.cfg.train.steps_per_call))

    def _start_profile(self):
        """A started `torch.profiler.profile`: the host's activity, and the
        device's on a CUDA device (raises when this torch cannot trace it:
        a trace of the host alone would pass for one of the steps)."""
        from torch.profiler import ProfilerActivity, profile, supported_activities

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError("train.profile_dir: this torch's profiler cannot trace CUDA "
                                   f"activity (it supports {supported_activities()})")
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, lo: int, hi: int) -> str:
        """Stop the trace of steps [lo, hi) and write it into profile_dir."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.train.profile_dir, exist_ok=True)
        self.profile_trace = os.path.join(self.cfg.train.profile_dir,
                                          f"trace_steps_{lo}_{hi}.json")
        prof.export_chrome_trace(self.profile_trace)
        return self.profile_trace

    def checkpoint_manager(self, directory: str, keep: int = 3) -> CheckpointManager:
        """A checkpoint manager of this run's mesh and its row-sharded
        leaves, which writes the vocab_size and num_users `recommend --ckpt`
        reads; its `restore` reads a checkpoint of any mesh that holds this
        run's global shapes."""
        return CheckpointManager(directory, keep=keep, mesh=self.mesh,
                                 row_sharded=self._sharded,
                                 info={"vocab_size": int(self.ds.vocab_size),
                                       "num_users": int(self.ds.num_users)})

    def fit(self, state: Optional[TrainState] = None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Train to `train.num_steps` from `state` (when None: the newest
        checkpoint under out_dir/ckpt with train.resume, else a fresh state
        from train.seed). Returns (state, the last eval's metrics).
        Checkpoints go to out_dir/ckpt every train.checkpoint_every steps
        (at the group boundary past each multiple), at fail_after_step and
        at the end."""
        cfg = self.cfg
        out_dir = cfg.train.out_dir
        rank = self.mesh.rank
        logger = MetricsLogger(out_dir, tensorboard=cfg.train.tensorboard, host0=rank == 0)
        heartbeat = Heartbeat(out_dir, rank) if out_dir else None
        ckpt = self.ckpt = (
            self.checkpoint_manager(os.path.join(out_dir, "ckpt"), keep=cfg.train.keep_checkpoints)
            if out_dir and cfg.train.checkpoint_every > 0 else None)
        data_position = 0  # batches consumed: the resume point of the data
        data_state = None
        if state is None:
            if cfg.train.resume and ckpt is not None and ckpt.latest_step() is not None:
                state, _, data_position, data_state = ckpt.restore(self.abstract_state(),
                                                                   device=self.device)
            else:
                state = self.init_state()
        if out_dir and rank == 0:
            os.makedirs(out_dir, exist_ok=True)
            cfg.save(os.path.join(out_dir, "config.json"))

        it = self.train_iterator(skip_batches=data_position)
        if cfg.data.session_parallel and data_position:
            if data_state is not None:
                # The snapshot is restored by the loader kind that took it
                # (the Python stream and the native engine shuffle apart).
                want = data_state.get("engine", "python")
                have = "native" if isinstance(it, native.NativeSessionLoader) else "python"
                if want != have:
                    if hasattr(it, "close"):
                        it.close()
                    it = self._make_session_iterator(engine=want)
                it.restore(data_state)
            else:
                for _ in range(data_position):  # a checkpoint without a snapshot: replay
                    next(it)
        self.precompile()

        def pipeline_state() -> Optional[dict]:
            """The stream's snapshot at the loop's position, for a save. The
            feeder reads ahead of the loop; the session stream keeps a ring
            of recent snapshots for that."""
            if cfg.data.session_parallel:
                return it.state_at(data_position)
            return None

        start_step = state.step
        spc = self._steps_per_call()
        logger.log(start_step, "data", {
            "engine": self.data_engine, "prefetch_to_device": cfg.data.prefetch_to_device,
            "steps_per_call": spc, "native_unavailable": native.build_error() or ""})
        if spc > 1 and 0 < cfg.train.log_every < spc:
            warnings.warn(
                f"train.log_every={cfg.train.log_every} < steps_per_call={spc}: log "
                "boundaries inside a group collapse to one line a group (loss = group "
                "mean, grad_norm = group max)", stacklevel=2)
        # Pack and stack K consecutive same-bucket batches on the feeder's
        # side, so that the loop takes one staged group a K steps.
        src: Iterator = it
        if spc > 1:
            src = _group_wires(it, self.pack_batch, spc, cfg.train.num_steps - start_step)
        # Host-to-device prefetch: the next batches are built, packed and
        # copied from a background thread while the loop's steps run.
        # Built after the iterator, so its queue holds exactly the next
        # batches.
        prefetcher: Optional[DevicePrefetcher] = None
        if cfg.data.prefetch_to_device > 0:
            prefetcher = DevicePrefetcher(src, self.put_batch,
                                          depth=cfg.data.prefetch_to_device)
            feed: Iterator = prefetcher
        else:
            feed = ((b, _ready(self.put_batch(h))) for b, h in src)
        pending: Dict[str, torch.Tensor] = {}
        t_window = time.perf_counter()
        examples_window = 0
        last_eval: Dict[str, float] = {}
        # The trace in progress, its first step and its end so far.
        prof, prof_lo, prof_hi, traced = None, 0, 0, False
        self.profile_trace = None
        try:
            step = start_step
            while step < cfg.train.num_steps:
                bucket, batch = next(feed)
                # A stacked group is [K, B, W]; a dict or a single wire is
                # one step. A cadence fires when its boundary falls in
                # [step, hi).
                k = batch.shape[0] if isinstance(batch, torch.Tensor) and batch.dim() == 3 else 1
                hi = step + k
                if (cfg.train.profile_dir and not traced and rank == 0
                        and step <= cfg.train.profile_steps[0] < hi):
                    prof, prof_lo, traced = self._start_profile(), step, True
                data_position += k
                with (torch.profiler.record_function(f"seqrec_group[{step},{hi})")
                      if prof is not None else contextlib.nullcontext()):
                    if k > 1:
                        state, metrics = self.train_step_multi(state, batch)
                    else:
                        state, metrics = self.train_step(state, batch)
                prof_hi = hi
                examples_window += self.global_batch * k
                pending, pending_step = metrics, hi - 1

                if cfg.train.debug_nans and bool(metrics["nonfinite"]):
                    # _steps_per_call() makes k == 1 here: hi - 1 is the step.
                    if ckpt is not None:
                        ckpt.wait()
                    logger.log(hi - 1, "fatal", {"nonfinite_grads_at": hi - 1})
                    raise FloatingPointError(
                        f"non-finite loss/gradients at step {hi - 1} (train.debug_nans); "
                        "the last finite checkpoint is intact")

                if _crossed(cfg.train.log_every, step, hi):
                    m = {key: float(v) for key, v in pending.items()}
                    dt = time.perf_counter() - t_window
                    eps = examples_window / dt if dt > 0 else 0.0
                    logger.log(pending_step, "train", {
                        "loss": m["loss"], "grad_norm": m["grad_norm"],
                        "lr": float(self.optimizer.schedule(pending_step)), "bucket": bucket,
                        "examples_per_s": eps,
                        "examples_per_s_per_chip": eps / self.num_devices})
                    t_window = time.perf_counter()
                    examples_window = 0
                    if heartbeat:
                        heartbeat.beat(pending_step)

                if prof is not None and step <= cfg.train.profile_steps[1] < hi:
                    self._stop_profile(prof, prof_lo, hi)
                    prof = None

                if _crossed(cfg.train.eval_every, step, hi):
                    last_eval = self.evaluate(state, split="val")
                    logger.log(pending_step, "eval/val", last_eval)
                    t_window = time.perf_counter()
                    examples_window = 0

                if ckpt is not None and _crossed(cfg.train.checkpoint_every, step, hi):
                    ckpt.save(hi, state, data_position, data_state=pipeline_state())

                if cfg.train.fail_after_step is not None and hi >= cfg.train.fail_after_step:
                    if ckpt is not None:
                        if ckpt.latest_step() != hi:
                            ckpt.save(hi, state, data_position, data_state=pipeline_state())
                        ckpt.wait()
                    logger.log(hi - 1, "fault_injection", {"exit_at": hi})
                    return state, last_eval
                step = hi
            if ckpt is not None:  # before the stream closes: its snapshot
                ckpt.save(cfg.train.num_steps, state, data_position,
                          data_state=pipeline_state())
        finally:
            if prof is not None:  # the window ran past the loop's end
                self._stop_profile(prof, prof_lo, prof_hi)
            if prefetcher is not None:
                prefetcher.close()
            if hasattr(it, "close"):
                it.close()
            if ckpt is not None:
                ckpt.close()
            logger.close()
        return state, last_eval

    # ---- eval -----------------------------------------------------------

    def evaluate(self, state: TrainState, split: str = "val") -> Dict[str, float]:
        """The global metrics: each rank evaluates its own users, the sums
        are summed over the world (a collective: every rank calls this)."""
        return evaluate(self.model, state.params, self.ds, self.cfg.eval, split=split,
                        max_len=self.cfg.data.max_len, mesh=self.mesh)
