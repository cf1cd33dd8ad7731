"""The port's training steps over a mesh against the JAX package's Trainer
on the same global batch, on the CPU: gloo ranks (`torch_mesh_worker.py`,
no JAX) against `seqrec_tpu.train.trainer.Trainer` on the conftest's fake
devices with `make_mesh(M, devices=jax.devices()[:W])`.

Meshes (data, model): (2, 1), (1, 2) and (2, 2). Cases, each K=4 steps from
the JAX Trainer's own initial state (`init_state`, converted), with the
same negatives injected on both sides (dropout 0):
- dense: sampled softmax over log-uniform negatives, adagrad, clip 1.0
  (adagrad everywhere, as the JAX package's sharded tests: adam's
  m / sqrt(v) turns the rounding of a near-zero gradient into a whole
  step's difference);
- sparse: the sparse step, the exact budget;
- sparse_session_capped: the sparse step on session-parallel windows with
  the carry, unique budget capped below the step's distinct ids (the
  sentinel row), as configs/rsc15_10m.json;
- session: the dense session-parallel step (BPR-max, uniform negatives);
- dense_full_softmax: the full softmax (the JAX package's default loss)
  with its output bias, vocab-parallel over the row-sharded table and bias
  (the path of tests/sharding/test_mesh.py::test_sharded_embedding_trainer).
All with `mesh.shard_embeddings` (tables padded to the mesh, row-sharded at
model axis 2; the full softmax's output bias too). Each rank reads its rows [r B, (r + 1) B) of the global
batch.

Tolerance: every step's loss and gradient norm, and every parameter, row
state and carry leaf after the group, within 1e-5 of the leaf's largest
magnitude: the JAX package's sharded-vs-unsharded rtol
(tests/sharding/test_sparse_sharded.py), the same formulas summed in
another order (over ranks, then over rows). The weight sums (tokens) are
equal. Replicas hold the same bits: replicated leaves on every rank,
row-sharded ones on the ranks of one model index.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seqrec_tpu.config import RunConfig as JaxRunConfig
from seqrec_tpu.data import negative as jax_negative
from seqrec_tpu.runtime import make_mesh as jax_make_mesh
from seqrec_tpu.train import trainer as jax_trainer
from seqrec_tpu_torch.models.convert import flax_to_state_dict
from torch_mesh_worker import spawn

VOCAB, B, T, S, K = 61, 3, 8, 20, 4
REL = 1e-5
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}


def _settings(case: str, model_axis: int) -> dict:
    session = "session" in case
    sparse = case.startswith("sparse")
    s = {"model.embed_dim": 16, "model.use_pallas": False, "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "model.num_negatives": S, "model.max_len": T,
         "model.loss": {"session": "bpr_max", "dense_full_softmax": "full_softmax"}.get(
             case, "sampled_softmax"),
         "data.batch_size": B, "data.max_len": T, "data.session_parallel": session,
         "data.neg_sampler": "uniform" if case == "session" else "log_uniform",
         "train.optimizer": "adagrad", "train.grad_clip_norm": 1.0,
         "train.learning_rate": 0.05, "train.sparse_embedding_update": sparse,
         "train.sparse_unique_budget": 40 if case == "sparse_session_capped" else 0,
         "train.compilation_cache_dir": "", "mesh.model_axis": model_axis,
         "mesh.shard_embeddings": True}
    return s


CASES = ("dense", "sparse", "sparse_session_capped", "session", "dense_full_softmax")


class _DS:
    vocab_size, num_users = VOCAB, 0


def _apply(cfg, settings):
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


class _Injected(jax_trainer.Trainer):
    """The JAX Trainer with this test's negatives: step s draws negs[s]."""

    negs = None

    def _train_step_impl(self, state, batch):
        ids = jnp.asarray(self.negs[0])[state.step]
        lq = jnp.asarray(self.negs[1])[state.step] if self.negs[1].size else None
        orig = jax_trainer.sample_negatives
        jax_trainer.sample_negatives = lambda *a, **k: (ids, lq)
        try:
            return super()._train_step_impl(state, batch)
        finally:
            jax_trainer.sample_negatives = orig


def _batches(rng, case, W):
    n = W * B
    inputs = rng.integers(1, VOCAB, size=(K, n, T)).astype(np.int32)
    targets = rng.integers(1, VOCAB, size=(K, n, T)).astype(np.int32)
    if "session" in case:
        return {"inputs": inputs, "targets": targets, "mask": np.ones((K, n, T), np.float32),
                "reset": (rng.random((K, n, T)) < 0.25).astype(np.float32)}
    lens = rng.integers(2, T + 1, size=(K, n))
    mask = np.arange(T)[None, None, :] < lens[..., None]
    return {"inputs": inputs * mask, "targets": targets * mask, "mask": mask.astype(np.float32)}


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    """One spawn a mesh: every case's K steps on its ranks, and the JAX
    Trainer's on the same inputs."""
    D, M = MESHES[request.param]
    W = D * M
    d = tmp_path_factory.mktemp(f"mesh_steps_{request.param}")
    rng = np.random.default_rng(W + 10 * M)
    jmesh = jax_make_mesh(M, devices=jax.devices()[:W])
    io, spec, want = {}, {"vocab": VOCAB, "cases": {}}, {}
    for case in CASES:
        settings = _settings(case, M)
        spec["cases"][case] = settings
        jtr = _Injected(_apply(JaxRunConfig(), settings), ds=_DS(), mesh=jmesh)
        jstate = jtr.init_state(3)
        whole = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
        io.update({f"{case}/params/{k}": v.numpy() for k, v in whole.items()})
        batches = _batches(rng, case, W)
        io.update({f"{case}/{k}": v for k, v in batches.items()})
        negs = rng.integers(1, VOCAB, size=(K, S)).astype(np.int32)
        lq = (np.asarray(jax_negative.log_uniform_log_prob(jnp.asarray(negs), VOCAB))
              if case != "session" else np.zeros((K, 0), np.float32))
        io[f"{case}/neg"], io[f"{case}/neg_log_q"] = negs, lq
        jtr.negs = (negs, lq)
        metrics = []
        for s in range(K):
            jstate, m = jtr._train_step(jstate, {k: jnp.asarray(v[s]) for k, v in batches.items()})
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["tokens"])])
        want[case] = {"metrics": np.array(metrics), "params": flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jstate.params)),
            "embed_opt": jax.tree_util.tree_map(np.asarray, jstate.embed_opt),
            "carry": None if jstate.carry is None else [np.asarray(c) for c in jstate.carry]}
    np.savez(d / "inputs.npz", **io)
    (d / "inputs.json").write_text(json.dumps(spec))
    outs = spawn("steps", W, d)
    return (D, M), outs, want


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= REL * scale, f"{what}: max abs err {err} > {REL} x {scale}"


def _assembled(outs, key, M, sharded):
    """The whole leaf: a sharded one from the ranks of data index 0 in
    model order, a replicated one from rank 0; every replica equal."""
    for r, o in enumerate(outs):
        ref = outs[r % M] if sharded else outs[0]
        np.testing.assert_array_equal(o[key], ref[key], err_msg=f"{key} rank {r}")
    return np.concatenate([outs[m][key] for m in range(M)]) if sharded else outs[0][key]


def _sharded(name, M):
    return M > 1 and name in ("item_embedding", "output_embedding", "output_bias")


@pytest.mark.parametrize("case", CASES)
def test_steps_equal_jax(run, case):
    (D, M), outs, want = run
    w = want[case]
    for o in outs:
        np.testing.assert_array_equal(o[f"{case}/world"], [D * M, B])
    got = outs[0][f"{case}/metrics"]
    for o in outs:  # the logged loss, norm and tokens are global: alike on every rank
        np.testing.assert_array_equal(o[f"{case}/metrics"], got)
    _close(got[:, 0], w["metrics"][:, 0], "loss")
    _close(got[:, 1], w["metrics"][:, 1], "grad_norm")
    np.testing.assert_array_equal(got[:, 2], w["metrics"][:, 2])
    for k, v in w["params"].items():
        _close(_assembled(outs, f"{case}/params/{k}", M, _sharded(k, M)), v.numpy(), k)
    for name, tree in (w["embed_opt"] or {}).items():
        for leaf, v in tree.items():
            _close(_assembled(outs, f"{case}/embed_opt/{name}/{leaf}", M, _sharded(name, M)), v,
                   f"embed_opt {name}/{leaf}")
    if w["carry"] is not None:  # rank-local rows of the global carry
        for i, c in enumerate(w["carry"]):
            _close(np.concatenate([o[f"{case}/carry/{i}"] for o in outs]), c, f"carry {i}")
