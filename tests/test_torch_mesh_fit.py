"""The port's eval, checkpoint and resume, and `recommend` over a mesh of two
gloo ranks with row-sharded tables (`mesh.model_axis=2`), on the CPU
(`torch_mesh_worker.py` "fit", no JAX in the ranks).

- The full-protocol eval at world 2 (each rank its own users, the sharded
  ranks, the sums summed over the ranks; the ranks hold different numbers
  of batches, so one pads) against the JAX package's single-process
  `evaluate` of the same parameters on the same dataset: within 1e-5
  relative (f32 metric sums in another order; the ranks are integers and
  equal).
- The sampled protocol at world 2: the same global metrics on both ranks,
  over every eval user (its candidates depend on the rank's seed, as a JAX
  host's do, so it is not held against one process).
- A fit killed at step 8 and resumed from its checkpoints against a
  straight one, the sparse step and the sparse session-parallel step (the
  stream's snapshot and the carry, rank-local): every leaf on every rank
  bit for bit; each rank's part of the checkpoint and rank 0's meta.json
  with the mesh; that checkpoint restored by one process where the global
  shapes agree (the shards put together), refused, naming the leaves and
  both shapes, where they do not.
- `recommend` with the sharded top-k against one rank's whole model: the
  same items, scores within 1e-6 relative (the dot products of another
  matmul's shape).
- A full-softmax model (its output bias row-sharded with the table): the
  full-protocol eval at world 2 against the JAX package's single-process
  eval, within 1e-5 relative as above; its candidate scores (the sharded
  bias lookup) against one rank's whole model, within 1e-6 relative.
- The bucketed stream of a sharded model at world 2 (several buckets): each
  rank's batches are its rows of the JAX package's one-process stream of
  the global batch, bit for bit, for the Python batcher and the native
  engine, and both ranks hold the same bucket; a bucketed full-softmax fit
  killed and resumed equals a straight one (the case `bucketed`).
- A fit with `train.profile_dir` at world 2: process 0 alone writes the
  trace, and it holds the window's groups, each under its label.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import RunConfig as JaxRunConfig
from seqrec_tpu.data import native as jax_native
from seqrec_tpu.data.batching import make_train_batches as jax_make_train_batches
from seqrec_tpu.data.dataset import synthetic_dataset as jax_synthetic_dataset
from seqrec_tpu.eval.harness import evaluate as jax_evaluate
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu_torch.config import RunConfig as PortRunConfig
from seqrec_tpu_torch.parallel.embedding import padded_vocab
from seqrec_tpu_torch.train.checkpoint import CheckpointManager
from seqrec_tpu_torch.train.state import TrainState
from seqrec_tpu_torch.train.trainer import Trainer
from torch_mesh_worker import spawn

DATASET = {"num_users": 61, "num_items": 90, "seed": 4, "min_len": 4, "max_len": 14}
MODEL = {"model.embed_dim": 16, "model.use_pallas": False, "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "model.loss": "sampled_softmax", "model.num_negatives": 24,
         "model.max_len": 12, "data.max_len": 12, "mesh.model_axis": 2,
         "mesh.shard_embeddings": True}
EVAL = {**MODEL, "eval.batch_size": 10, "eval.exclude_history": True, "eval.num_negatives": 20}
FIT = {**MODEL, "data.batch_size": 4, "data.use_native_loader": False,
       "train.sparse_embedding_update": True, "train.optimizer": "adagrad",
       "train.num_steps": 12, "train.steps_per_call": 4, "train.checkpoint_every": 5,
       "train.eval_every": 0, "train.log_every": 4, "train.learning_rate": 0.05}
FULL = {**MODEL, "model.loss": "full_softmax"}
BUCKETED = {**FULL, "data.batch_size": 4, "data.buckets": [6, 12]}
FITS = {"sparse": FIT,
        "sparse_session": {**FIT, "data.session_parallel": True,
                           "train.sparse_unique_budget": 40},
        "bucketed": {**BUCKETED, "model.dropout_rate": 0.1, "data.use_native_loader": True,
                     **{k: v for k, v in FIT.items() if k.startswith("train.")},
                     "train.sparse_embedding_update": False}}
STREAM_BATCHES = 6
PROFILE = {**FULL, "data.batch_size": 4, "data.use_native_loader": False,
           "train.num_steps": 12, "train.steps_per_call": 4, "train.profile_steps": [4, 8],
           "train.checkpoint_every": 0, "train.eval_every": 0, "train.log_every": 4}


def _apply(cfg, settings):
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_fit")
    jds = jax_synthetic_dataset(**{k: v for k, v in DATASET.items()
                                   if k not in ("num_users", "num_items")},
                                num_users=DATASET["num_users"], num_items=DATASET["num_items"])
    jcfg = _apply(JaxRunConfig(), {k: v for k, v in EVAL.items() if not k.startswith("mesh.")})
    jm = jax_build_model(jcfg.model, jds.vocab_size)
    T = jcfg.data.max_len
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(0), jnp.zeros((2, T), jnp.int32), jnp.ones((2, T), jnp.float32)))
    table = params["params"]["item_embedding"]
    pad = padded_vocab(jds.vocab_size, 2) - table.shape[0]
    io = {"params/item_embedding": np.concatenate([table, np.zeros((pad, table.shape[1]),
                                                                    np.float32)])}
    for k, v in params["params"]["tower"].items():
        io[f"params/tower.{k}"] = v
    # The full-softmax model: JAX's own init, its bias drawn (it starts at
    # zeros) so that its shards matter; the tables padded to the mesh.
    fcfg = _apply(JaxRunConfig(), {k: v for k, v in {**EVAL, **FULL}.items()
                                   if not k.startswith("mesh.")})
    fm = jax_build_model(fcfg.model, jds.vocab_size)
    fparams = jax.tree_util.tree_map(np.asarray, fm.init(
        jax.random.key(1), jnp.zeros((2, T), jnp.int32), jnp.ones((2, T), jnp.float32)))
    rng = np.random.default_rng(7)
    fparams["params"]["output_bias"] = rng.normal(
        scale=0.5, size=fparams["params"]["output_bias"].shape).astype(np.float32)
    for k in ("item_embedding", "output_bias"):
        v = fparams["params"][k]
        io[f"fs_params/{k}"] = np.concatenate([v, np.zeros((pad, *v.shape[1:]), np.float32)])
    for k, v in fparams["params"]["tower"].items():
        io[f"fs_params/tower.{k}"] = v
    io["fs_cand/inputs"] = rng.integers(1, jds.vocab_size, size=(6, T)).astype(np.int32)
    io["fs_cand/mask"] = (np.arange(T)[None, :] < rng.integers(1, T + 1, size=(6, 1))
                          ).astype(np.float32)
    io["fs_cand/inputs"] *= io["fs_cand/mask"].astype(np.int32)
    io["fs_cand/candidates"] = rng.integers(1, jds.vocab_size, size=(6, 9)).astype(np.int32)
    np.savez(d / "inputs.npz", **io)
    (d / "inputs.json").write_text(json.dumps({
        "dataset": DATASET, "eval": EVAL, "fit": FITS, "eval_fs": {**EVAL, **FULL},
        "stream": BUCKETED, "stream_batches": STREAM_BATCHES, "profile": PROFILE}))
    outs = spawn("fit", 2, d, timeout=90)
    want = {split: jax_evaluate(jm, params, jds, jcfg.eval, split=split, max_len=T)
            for split in ("val", "test")}
    want.update({f"fs/{split}": jax_evaluate(fm, fparams, jds, fcfg.eval, split=split,
                                             max_len=T) for split in ("val", "test")})
    return d, outs, want, jds


def _metrics(o, protocol, split):
    return dict(zip(o[f"eval/{protocol}/{split}/keys"], o[f"eval/{protocol}/{split}/values"]))


@pytest.mark.parametrize("split", ["val", "test"])
def test_full_eval_at_world_2_equals_jax_single_process(run, split):
    _, outs, want, _ = run
    got = [_metrics(o, "full", split) for o in outs]
    assert got[0] == got[1]  # the global metrics, on each rank
    assert sorted(got[0]) == sorted(want[split])
    for k, v in want[split].items():
        np.testing.assert_allclose(got[0][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert got[0]["count"] > 0


@pytest.mark.parametrize("split", ["val", "test"])
def test_full_softmax_eval_at_world_2_equals_jax_single_process(run, split):
    """The sharded ranks with the output bias's shards (`output_bias_value`)."""
    _, outs, want, _ = run
    got = [dict(zip(o[f"eval_fs/full/{split}/keys"], o[f"eval_fs/full/{split}/values"]))
           for o in outs]
    assert got[0] == got[1]
    assert sorted(got[0]) == sorted(want[f"fs/{split}"])
    for k, v in want[f"fs/{split}"].items():
        np.testing.assert_allclose(got[0][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert got[0]["count"] > 0


def test_full_softmax_candidate_scores_equal_the_whole_model(run):
    _, outs, _, _ = run
    for o in outs:
        np.testing.assert_allclose(o["fs_scores/sharded"], o["fs_scores/whole"],
                                   rtol=1e-6, atol=1e-6)
    assert not np.array_equal(outs[0]["fs_scores/whole"], outs[1]["fs_scores/whole"])


@pytest.mark.parametrize("engine", ["python", "native"])
def test_bucketed_sharded_stream_is_jaxs_one_process_stream(run, engine):
    _, outs, _, jds = run
    for o in outs:
        assert str(o[f"stream/{engine}/engine"][0]) == engine
    B, W = BUCKETED["data.batch_size"], len(outs)
    kw = dict(batch_size=B * W, max_len=BUCKETED["data.max_len"],
              buckets=BUCKETED["data.buckets"], seed=JaxRunConfig().data.seed, host_shard=(0, 1))
    stream = (jax_native.NativeTrainLoader(jds, **kw) if engine == "native"
              else jax_make_train_batches(jds, **kw))
    buckets = set()
    for i in range(STREAM_BATCHES):
        bucket, want = next(stream)
        buckets.add(bucket)
        for r, o in enumerate(outs):
            assert int(o[f"stream/{engine}/{i}/bucket"][0]) == bucket
            for k, v in want.items():
                np.testing.assert_array_equal(o[f"stream/{engine}/{i}/{k}"],
                                              v[r * B:(r + 1) * B], err_msg=f"{i} {k} rank {r}")
    assert len(buckets) > 1  # the ranks agreed on more than one bucket
    if hasattr(stream, "close"):
        stream.close()


def test_profiled_fit_traces_the_window_on_process_0_only(run):
    d, outs, _, _ = run
    trace = str(outs[0]["profile/trace"][0])
    assert trace.endswith("trace_steps_4_12.json") and str(outs[1]["profile/trace"][0]) == ""
    assert os.listdir(d / "prof") == [os.path.basename(trace)]
    assert list(outs[0]["profile/labels"]) == ["seqrec_group[4,8)", "seqrec_group[8,12)"]


@pytest.mark.parametrize("split", ["val", "test"])
def test_sampled_eval_at_world_2_counts_every_user_once(run, split):
    _, outs, want, _ = run
    got = [_metrics(o, "sampled", split) for o in outs]
    assert got[0] == got[1]
    assert got[0]["count"] == float(want[split]["count"])
    assert all(np.isfinite(v) and 0.0 <= v <= max(1.0, got[0]["count"]) for v in got[0].values())


@pytest.mark.parametrize("case", list(FITS))
def test_resume_at_world_2_is_bit_for_bit(run, case):
    d, outs, _, _ = run
    for o in outs:
        assert int(o[f"fit/{case}/killed/step"][0]) == 8
        assert int(o[f"fit/{case}/straight/step"][0]) == int(o[f"fit/{case}/resumed/step"][0]) == 12
        keys = [k for k in o if k.startswith(f"fit/{case}/straight/")]
        assert any("embed_opt" in k for k in keys) == case.startswith("sparse")
        for k in keys:
            np.testing.assert_array_equal(o[k.replace("/straight/", "/resumed/")], o[k], err_msg=k)
    # The sharded table really differs between the ranks (two shards).
    key = f"fit/{case}/straight/params/item_embedding"
    assert not np.array_equal(outs[0][key], outs[1][key])
    ckpt = d / case / "resumed" / "ckpt"
    steps = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
    assert steps[0] == 8 and steps[-1] == 12
    parts = [f"{n}.rank{r}{e}" for r in range(2)
             for n, e in (("params", ".pt"), ("state", ".pt"), ("data", ".json"), ("done", ""))]
    assert sorted(os.listdir(ckpt / "12")) == sorted(["meta.json"] + parts)
    meta = json.loads((ckpt / "12" / "meta.json").read_text())
    assert meta["mesh"] == {"data": 1, "model": 2} and meta["step"] == 12
    assert meta["vocab_size"] == run[3].vocab_size
    data = json.loads((ckpt / "12" / "data.rank1.json").read_text())
    assert data["data_position"] == 12
    assert ("data_state" in data) == (case == "sparse_session")


class _DS:
    def __init__(self, vocab: int, users: int = 0):
        self.vocab_size, self.num_users = vocab, users


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{path}/{i}").items()}
    return {}


def test_restore_on_another_mesh_is_refused(run):
    """The 1 x 2 sparse checkpoint (vocab 91, padded to 96 at model axis 1
    and 2 alike) restores at 1 x 1 with the tables padded
    (`mesh.shard_embeddings`), as orbax restores it: every table, row-state
    and moment leaf the two ranks' shards put together, every other leaf
    rank 0's, bit for bit. Without the padding (91 rows) the global shapes
    differ: refused, the leaves named with both shapes."""
    d, _, _, jds = run
    ckpt = d / "sparse" / "resumed" / "ckpt"
    parts = [{**_leaves(torch.load(ckpt / "12" / f"params.rank{r}.pt"), "/params"),
              **_leaves(torch.load(ckpt / "12" / f"state.rank{r}.pt"))} for r in range(2)]
    one = _apply(PortRunConfig(), {**FIT, "mesh.model_axis": 1})
    tr = Trainer(one, _DS(jds.vocab_size), device="cpu")
    mgr = tr.checkpoint_manager(str(ckpt))  # one process: 1 x 1
    state, step, pos, data_state = mgr.restore(tr.abstract_state(), device="cpu")
    assert (step, pos, data_state) == (12, 12, None) and mgr.read_meta()["data_position"] == 12
    got = _leaves({"params": state.params, "opt_state": state.opt_state,
                   "embed_opt": state.embed_opt, "carry": state.carry})
    assert sorted(got) == sorted(parts[0])
    sharded = {"/params/item_embedding", "/embed_opt/item_embedding/acc"}
    assert sharded <= set(got) and got["/params/item_embedding"].shape[0] == 96
    for k, v in got.items():
        want = torch.cat([parts[0][k], parts[1][k]]) if k in sharded else parts[0][k]
        assert torch.equal(v, want), k
    params = mgr.restore_params("cpu", like=state.params)
    assert all(torch.equal(params[k], v) for k, v in state.params.items())
    whole = _apply(PortRunConfig(), {**FIT, "mesh.model_axis": 1,
                                     "mesh.shard_embeddings": False})
    tr = Trainer(whole, _DS(jds.vocab_size), device="cpu")
    mgr = tr.checkpoint_manager(str(ckpt))
    shapes = r"mesh of 1 x 2 .*this run's, 1 x 1.*/params/item_embedding \(96, 16\) float32 vs " \
             r"\(91, 16\) float32"
    with pytest.raises(ValueError, match=r"/embed_opt/item_embedding/acc \(96, 16\) float32 vs "
                                         r"\(91, 16\) float32; " + shapes[shapes.index("/params"):]):
        mgr.restore(tr.abstract_state(), device="cpu")
    with pytest.raises(ValueError, match=shapes):
        mgr.restore_params("cpu", like=dict(tr.model.named_parameters()))


def test_a_one_process_checkpoint_is_refused_at_world_2(tmp_path):
    """A checkpoint of one process (no rank parts) read on either rank of a
    1 x 2 mesh: its replicated `w` restores on both ranks, as orbax restores
    a replicated leaf on any mesh; a state whose `w` has another shape is
    refused, naming it and both shapes, before anything is read. The mesh
    is a stand-in: the manager reads its shape, rank and size, and sums
    rank 0's save token with `psum_host`."""
    from types import SimpleNamespace

    state = TrainState(step=3, params={"w": torch.arange(2.0)}, opt_state={"count": 3},
                       rng_seed=5)
    assert CheckpointManager(str(tmp_path), async_save=False).save(3, state, data_position=4)
    wrong = TrainState(step=3, params={"w": torch.ones(3)}, opt_state={}, rng_seed=0)
    for rank in (0, 1):
        mesh = SimpleNamespace(shape={"data": 1, "model": 2}, rank=rank, size=2,
                               psum_host=lambda x: x)
        mgr = CheckpointManager(str(tmp_path), mesh=mesh)
        got, step, pos, _ = mgr.restore(state, device="cpu")
        assert (step, pos, got.step, got.rng_seed, got.opt_state) == (3, 4, 3, 5, {"count": 3})
        assert torch.equal(got.params["w"], state.params["w"])
        assert torch.equal(mgr.restore_params("cpu")["w"], state.params["w"])
        assert mgr.read_meta()["data_position"] == 4
        for read in (lambda: mgr.restore(wrong, device="cpu"),
                     lambda: mgr.restore_params("cpu", like=wrong.params)):
            with pytest.raises(ValueError, match=r"mesh of 1 x 1 .*this run's, 1 x 2.*"
                                                 r"/params/w \(2,\) float32 vs \(3,\) float32"):
                read()


def test_recommend_sharded_equals_the_whole_model(run):
    _, outs, _, _ = run
    for o in outs:
        np.testing.assert_array_equal(o["recommend/sharded/items"], o["recommend/whole/items"])
        np.testing.assert_allclose(o["recommend/sharded/scores"], o["recommend/whole/scores"],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outs[0]["recommend/sharded/items"],
                                  outs[1]["recommend/sharded/items"])


def test_train_cli_runs_on_two_processes_with_the_coordinator_flags(tmp_path):
    """`python -m seqrec_tpu_torch train --coordinator ... --num_processes 2
    --process_id r` on the CPU: both ranks train the sharded sparse config
    and evaluate; rank 0 alone prints and writes metrics.jsonl; each rank
    beats its own heartbeat."""
    import subprocess
    import sys

    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.data.dataset import load_dataset

    sets = [f"{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in FIT.items()
            if k not in ("train.num_steps",)]
    sets += ["data.dataset=synthetic", f"data.data_dir={tmp_path / 'data'}",
             "data.synthetic_num_users=80", "data.synthetic_num_items=120",
             "train.num_steps=8", "train.checkpoint_every=4", f"train.out_dir={tmp_path / 'run'}",
             "eval.batch_size=16"]
    load_dataset(RunConfig().apply_overrides(sets).data)  # once, before the ranks read it
    argv = [sys.executable, "-m", "seqrec_tpu_torch", "train", "--device", "cpu",
            "--coordinator", f"file://{tmp_path / 'store'}", "--num_processes", "2"]
    for s in sets:
        argv += ["--set", s]
    procs = [subprocess.Popen(argv + ["--process_id", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "1"}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-3000:] for o in outs]
    lines0 = [json.loads(x) for x in outs[0][0].splitlines() if x.startswith("{")]
    assert "final_test" in lines0[-1] and lines0[-1]["final_test"]["count"] > 0
    assert not [x for x in outs[1][0].splitlines() if x.startswith("{")]
    logged = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in logged if '"train"' in x] == [3, 7]
    assert {"heartbeat_0", "heartbeat_1"} <= set(os.listdir(tmp_path / "run"))
    assert json.loads((tmp_path / "run" / "ckpt" / "8" / "meta.json").read_text())["mesh"] == {
        "data": 1, "model": 2}
