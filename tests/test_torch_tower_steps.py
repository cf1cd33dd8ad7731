"""One `Trainer.train_step` of each configuration this slice added
(configs/ml1m_sasrec.json and configs/ml1m_lstm.json, cut to a narrow width,
f32, dropout off) against JAX value_and_grad and the JAX package's optax
chain, from the same parameters with the same injected negatives.

Tolerances: 1e-5 relative on the loss and the gradient norm (same formulas,
another summation order); 1e-4 on the updated parameters (Adam divides by
sqrt(nu), so last-bit differences in the gradients show at ~1e-6 of lr)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.config import TrainConfig as JaxTrainConfig
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.train import state as jax_state
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
VOCAB, T = 30, 12


def _batch(rng, B=4):
    inputs = np.zeros((B, T), np.int32)
    targets = np.zeros((B, T), np.int32)
    for r, n in enumerate([T, 5, 1, 3][:B]):
        seq = rng.integers(1, VOCAB, size=n + 1)
        inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
    return {"inputs": inputs, "targets": targets, "mask": (targets != 0).astype(np.float32)}


class _DS:
    vocab_size, num_users = VOCAB, 0


@pytest.mark.parametrize("config,overrides", [
    ("ml1m_sasrec", ["model.embed_dim=16", "model.num_heads=2", f"model.max_len={T}"]),
    ("ml1m_lstm", ["model.embed_dim=16"]),
])
def test_train_step_matches_jax(config, overrides, monkeypatch):
    """Adam, clip 5.0 and the config's schedule; the updated parameters,
    loss, gradient norm and token count all agree."""
    cfg = RunConfig.load(str(ROOT / f"configs/{config}.json")).apply_overrides(
        overrides + ["model.num_negatives=9", "model.dropout_rate=0.0",
                     "model.compute_dtype=float32", f"data.max_len={T}"])
    tr = Trainer(cfg, _DS(), device="cpu")
    state = tr.init_state(5)
    params = random_params(tr.model, seed=5)
    rng = np.random.default_rng(13)
    ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    nlq = (rng.normal(size=9) - 3).astype(np.float32)
    monkeypatch.setattr(tr, "sample_negatives",
                        lambda gen: (torch.from_numpy(ids), torch.from_numpy(nlq)))
    batch = _batch(np.random.default_rng(14))

    jm = jax_build_model(JaxModelConfig(**cfg.model.__dict__), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)

    def loss_fn(p):
        s, w = jm.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        neg_ids=jnp.asarray(ids), neg_log_q=jnp.asarray(nlq),
                        deterministic=True, method=jm.loss)
        return s / jnp.maximum(w, 1.0), w

    (j_loss, j_w), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
    upd, _ = opt.update(grads["params"], opt.init(j_params["params"]), j_params["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(j_params["params"], upd)}))

    state, m = tr.train_step(state, tr.pack_train_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-5)
    assert float(m["tokens"]) == float(j_w) and not bool(m["nonfinite"])
    assert sorted(state.params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("config,overrides", [
    ("ml1m_lstm", ["model.embed_dim=16"]),
    ("ml1m_gru4rec", ["model.embed_dim=16"]),
    ("ml1m_sasrec", ["model.embed_dim=16", "model.num_heads=2", f"model.max_len={T}"]),
])
def test_f32_path_step1_matches_jax(config, overrides, monkeypatch):
    """The f32 paths of chip_smoke.py (a shipped config with
    model.compute_dtype=float32, the kernels on: on the card the f32 cluster
    recurrences after their f32 input projections, or SASRec's f32 causal
    attention) cut to a narrow
    width: step 1 through `train_step_multi`, a group of one wire, against
    JAX value_and_grad and optax from the same parameters with the same
    injected negatives; the same tolerances as above. SASRec keeps its
    config's warmup here (chip_smoke.py sets it to 0 and compares step 1's
    loss and gradient norm only): the key bias's gradient is zero up to
    rounding (a shift of every key score of a row), and Adam at the full
    rate would turn that noise into a +-lr step on either side."""
    cfg = RunConfig.load(str(ROOT / f"configs/{config}.json")).apply_overrides(
        overrides + ["model.num_negatives=9", "model.dropout_rate=0.0",
                     "model.compute_dtype=float32", f"data.max_len={T}"])
    assert cfg.model.use_pallas
    tr = Trainer(cfg, _DS(), device="cpu")
    params = random_params(tr.model, seed=7)
    tr.model.load_state_dict(flax_to_state_dict(params))
    state = tr.init_state(7)
    rng = np.random.default_rng(21)
    ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    nlq = (rng.normal(size=9) - 3).astype(np.float32)
    monkeypatch.setattr(tr, "sample_negatives",
                        lambda gen: (torch.from_numpy(ids), torch.from_numpy(nlq)))
    batch = _batch(np.random.default_rng(22))

    jm = jax_build_model(JaxModelConfig(**cfg.model.__dict__), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)

    def loss_fn(p):
        s, w = jm.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        neg_ids=jnp.asarray(ids), neg_log_q=jnp.asarray(nlq),
                        deterministic=True, method=jm.loss)
        return s / jnp.maximum(w, 1.0), w

    (j_loss, j_w), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
    upd, _ = opt.update(grads["params"], opt.init(j_params["params"]), j_params["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(j_params["params"], upd)}))

    state, m = tr.train_step_multi(state, tr.pack_train_batch(batch)[None])
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-5)
    assert float(m["tokens"]) == float(j_w) and not bool(m["nonfinite"])
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)
