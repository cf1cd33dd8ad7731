"""Checkpoint and resume in the port (`train/checkpoint.py`, `Trainer.fit`,
the `eval` and `recommend --ckpt` subcommands), mirroring
tests/integration/test_steps_per_call.py (a killed run resumed from a
checkpoint inside a K=4 group lands bit for bit on the straight run),
tests/unit/test_resume_fast_forward.py (the fast-forwarded stream is the
JAX package's) and tests/integration/test_failure_semantics.py (debug_nans
leaves the last finite checkpoint intact). Equality is bit for bit
throughout: a resumed run must be the straight run, not close to it."""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from seqrec_tpu.config import RunConfig as JaxRunConfig
from seqrec_tpu.train import trainer as jax_trainer
from seqrec_tpu_torch import cli
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import native
from seqrec_tpu_torch.data.dataset import SequenceDataset, load_dataset
from seqrec_tpu_torch.eval.infer import recommend
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.train import checkpoint
from seqrec_tpu_torch.train.checkpoint import CheckpointManager
from seqrec_tpu_torch.train.state import TrainState, clone_state
from seqrec_tpu_torch.train.trainer import Trainer


def _apply(cfg, settings):
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


def _port_ds(ds) -> SequenceDataset:
    return SequenceDataset(items=ds.items.copy(), offsets=ds.offsets.copy(),
                           vocab_size=ds.vocab_size, name=ds.name)


def _settings(out_dir, **kw):
    s = {"model.embed_dim": 16, "model.use_pallas": False, "model.compute_dtype": "float32",
         "model.dropout_rate": 0.1, "model.loss": "sampled_softmax",
         "model.num_negatives": 16, "data.batch_size": 8, "data.max_len": 12,
         "data.buckets": (6, 12), "train.num_steps": 12, "train.log_every": 1000,
         "train.eval_every": 0, "train.checkpoint_every": 0, "train.steps_per_call": 4,
         "train.out_dir": str(out_dir), "train.compilation_cache_dir": ""}
    s.update(kw)
    return s


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{path}/{i}").items()}
    return {}


def _state_leaves(state: TrainState):
    return _leaves({"params": state.params, "opt_state": state.opt_state,
                    "embed_opt": state.embed_opt, "carry": state.carry})


def _assert_same_state(a: TrainState, b: TrainState):
    assert a.step == b.step and a.rng_seed == b.rng_seed
    assert a.opt_state["count"] == b.opt_state["count"]
    la, lb = _state_leaves(a), _state_leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def _random_state(cell="lstm", sparse=True) -> TrainState:
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    params = {"item_embedding": r(20, 4), "tower.lstm0_wx": r(4, 16), "tower.lstm0_b": r(16)}
    rest = {k: v for k, v in params.items() if k != "item_embedding"}
    carry = ((r(3, 4), r(3, 4)), (r(3, 4), r(3, 4))) if cell == "lstm" else (r(3, 4),)
    return TrainState(step=7, params=params,
                      opt_state={"count": 7, "mu": {k: r(*v.shape) for k, v in rest.items()},
                                 "nu": {k: r(*v.shape) for k, v in rest.items()}},
                      rng_seed=43, carry=carry,
                      embed_opt={"item_embedding": {"m": r(20, 4), "v": r(20, 4)}}
                      if sparse else None)


def _abstract(state: TrainState) -> TrainState:
    """A restore target: `state`'s leaves as meta tensors (what
    `Trainer.abstract_state` gives for a trainer's own state)."""
    def meta(tree):
        if isinstance(tree, torch.Tensor):
            return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(meta(v) for v in tree)
        return tree

    return TrainState(step=state.step, params=meta(state.params),
                      opt_state=meta(state.opt_state), rng_seed=state.rng_seed,
                      carry=meta(state.carry), embed_opt=meta(state.embed_opt))


@pytest.mark.parametrize("async_save", [True, False])
@pytest.mark.parametrize("cell,sparse", [("lstm", True), ("gru", False)])
def test_save_restore_round_trips_every_leaf_and_the_meta(tmp_path, async_save, cell, sparse):
    state = _random_state(cell, sparse)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=async_save)
    snap = {"engine": "native", "count": 5, "epoch": 1, "pos": 3, "lanes": [[4, 2, True], None]}
    assert mgr.save(7, state, data_position=5, data_state=snap)
    mgr.wait()
    assert mgr.latest_step() == 7 and mgr.all_steps() == [7]
    assert sorted(os.listdir(tmp_path / "ckpt" / "7")) == ["meta.json", "params.pt", "state.pt"]
    got, step, pos, data_state = CheckpointManager(str(tmp_path / "ckpt")).restore(
        _abstract(state), device="cpu")
    assert (step, pos, data_state) == (7, 5, snap)
    _assert_same_state(got, state)
    assert mgr.saves[0]["step"] == 7 and mgr.saves[0]["bytes"] == sum(
        t.numel() * 4 for t in _state_leaves(state).values())
    assert mgr.restore_params("cpu").keys() == state.params.keys()
    assert mgr.read_meta() == {"step": 7, "rng_seed": 43, "data_position": 5,
                               "data_state": snap}


@pytest.mark.parametrize("case", ["bucketed", "sparse_session_capped"])
def test_abstract_state_holds_no_memory_and_restore_checks_it(tiny_ds, tmp_path, case):
    """`Trainer.abstract_state` is the trainer's state as meta tensors, leaf
    for leaf; `restore` refuses a checkpoint whose leaves differ from its
    target's in shape or in presence."""
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path / "run", **CASES[case])),
                 _port_ds(tiny_ds), device="cpu")
    abstract, state = _state_leaves(tr.abstract_state()), _state_leaves(tr.init_state())
    assert all(t.device.type == "meta" for t in abstract.values())
    assert {k: (t.shape, t.dtype) for k, t in abstract.items()} == {
        k: (t.shape, t.dtype) for k, t in state.items()}
    state = _random_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, 0)
    wrong = _random_state()
    wrong.params["tower.lstm0_b"] = torch.zeros(17)
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(_abstract(wrong))
    no_carry = _random_state()
    no_carry.carry = None
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(_abstract(no_carry))


def test_keep_the_last_steps_and_skip_a_step_already_saved(tmp_path):
    state = _random_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(_abstract(state))
    for step in (2, 4, 6, 8):
        assert mgr.save(step, state, step)
    assert not mgr.save(8, state, 8) and not mgr.save(5, state, 5)  # as orbax: skipped
    mgr.close()
    assert mgr.all_steps() == [6, 8] and mgr.latest_step() == 8
    assert [s["step"] for s in mgr.saves] == [2, 4, 6, 8]
    assert all(s["write_s"] >= 0 for s in mgr.saves)


def test_the_host_copy_is_taken_before_save_returns(tmp_path):
    """A sparse step updates its table in place right after a save: the
    checkpoint holds the values at the save."""
    state = _random_state()
    want = state.params["item_embedding"].clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, 0)
    state.params["item_embedding"].add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore_params("cpu")["item_embedding"], want)


def test_a_save_is_atomic(tmp_path, monkeypatch):
    """Written into <step>.tmp and renamed when complete: an unfinished
    directory never counts, and a failed write leaves the last checkpoint
    the newest; `wait` surfaces the failure."""
    state = _random_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, 4)
    mgr.wait()
    os.makedirs(tmp_path / "9.tmp")  # a save killed midway
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    real = torch.save

    def failing(obj, f, *a, **k):
        if f.name.endswith(checkpoint.STATE_FILE):
            raise OSError("disk full")
        return real(obj, f, *a, **k)

    monkeypatch.setattr(torch, "save", failing)
    mgr.save(6, state, 6)
    with pytest.raises(RuntimeError, match="save under") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert mgr.all_steps() == [4] and not (tmp_path / "6").exists()
    _, step, pos, _ = mgr.restore(_abstract(state))
    assert (step, pos) == (4, 4)


# ---------------------------------------------------------------------------
# The resumed stream: train_iterator(skip_batches) against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("skip", [0, 5, 33])
def test_train_iterator_skip_batches_equals_jax(tiny_ds, tmp_path, use_native, skip):
    settings = _settings(tmp_path, **{"data.use_native_loader": use_native})
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jtr = jax_trainer.Trainer(_apply(JaxRunConfig(), settings), ds=tiny_ds, mesh=mesh)
    tr = Trainer(_apply(RunConfig(), settings), _port_ds(tiny_ds), device="cpu")
    want, got = jtr.train_iterator(skip_batches=skip), tr.train_iterator(skip_batches=skip)
    assert tr.data_engine == ("native" if use_native else "python")
    try:
        for i in range(10):
            (wb, wbatch), (gb, gbatch) = next(want), next(got)
            assert wb == gb and sorted(wbatch) == sorted(gbatch), i
            for k in wbatch:
                np.testing.assert_array_equal(gbatch[k], wbatch[k], err_msg=f"{i} {k}")
    finally:
        for it in (want, got):
            if hasattr(it, "close"):
                it.close()


# ---------------------------------------------------------------------------
# Killed and resumed equals straight, bit for bit
# ---------------------------------------------------------------------------


def _fit(ds, out_dir, **kw):
    tr = Trainer(_apply(RunConfig(), _settings(out_dir, **kw)), ds, device="cpu")
    state, _ = tr.fit()
    return tr, state


CASES = {
    "bucketed": {},
    "session": {"data.session_parallel": True, "model.loss": "bpr_max", "data.buckets": (),
                "data.neg_sampler": "uniform"},
    "sparse": {"train.sparse_embedding_update": True, "train.optimizer": "adagrad"},
    "sparse_session_capped": {"train.sparse_embedding_update": True, "train.optimizer": "adam",
                              "train.sparse_unique_budget": 40,
                              "data.session_parallel": True, "data.buckets": ()},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_killed_and_resumed_equals_straight_bit_for_bit(tiny_ds, tmp_path, case):
    """num_steps=12, K=4, checkpoint_every=5: the killed run saves at 8 (the
    group boundary past step 5) and stops there (fail_after_step=8); the
    resumed run restores step 8 and its data position, saves past 10 and at
    the end, and its final state (every parameter, optimizer, row-state and
    carry leaf) equals the straight run's."""
    ds = _port_ds(tiny_ds)
    extra = CASES[case]
    _, straight = _fit(ds, tmp_path / "s", **extra)
    tr, killed = _fit(ds, tmp_path / "k", **extra, **{"train.checkpoint_every": 5,
                                                      "train.fail_after_step": 8})
    assert killed.step == 8 and tr.ckpt.all_steps() == [8]
    meta = tr.ckpt.read_meta()
    assert meta["data_position"] == 8 and ("data_state" in meta) == case.startswith(
        ("session", "sparse_session"))
    tr, resumed = _fit(ds, tmp_path / "k", **extra, **{"train.checkpoint_every": 5,
                                                       "train.resume": True})
    # Saves at each group boundary past a multiple of 5 (groups break at a
    # bucket change), then at the end.
    steps = tr.ckpt.all_steps()
    assert resumed.step == 12 and steps[0] == 8 and steps[-1] == 12
    _assert_same_state(resumed, straight)


@pytest.mark.parametrize("writer", ["native", "python"])
def test_session_resume_pins_the_engine_that_took_the_snapshot(tiny_ds, tmp_path, writer):
    """A session snapshot means something only to the loader that took it:
    resumed with the other `data.use_native_loader`, fit still restores it
    with the writer's engine, and lands on the writer's straight run."""
    ds = _port_ds(tiny_ds)
    session = dict(CASES["session"])
    own = {"data.use_native_loader": writer == "native"}
    other = {"data.use_native_loader": writer != "native"}
    _, straight = _fit(ds, tmp_path / "s", **session, **own)
    _fit(ds, tmp_path / "k", **session, **own, **{"train.checkpoint_every": 5,
                                                  "train.fail_after_step": 8})
    tr, resumed = _fit(ds, tmp_path / "k", **session, **other,
                       **{"train.checkpoint_every": 5, "train.resume": True})
    assert tr.data_engine == writer
    _assert_same_state(resumed, straight)


def test_a_session_checkpoint_without_a_snapshot_replays_the_stream(tiny_ds, tmp_path):
    """A checkpoint that carries only its data position (no stream
    snapshot) resumes by replaying that many windows."""
    ds = _port_ds(tiny_ds)
    session = dict(CASES["session"])
    _, straight = _fit(ds, tmp_path / "s", **session)
    tr, _ = _fit(ds, tmp_path / "k", **session, **{"train.checkpoint_every": 5,
                                                   "train.fail_after_step": 8})
    path = os.path.join(tr.ckpt.directory, "8", checkpoint.META_FILE)
    meta = json.loads(open(path).read())
    del meta["data_state"]
    with open(path, "w") as f:
        json.dump(meta, f)
    _, resumed = _fit(ds, tmp_path / "k", **session, **{"train.checkpoint_every": 5,
                                                        "train.resume": True})
    _assert_same_state(resumed, straight)


def test_resume_without_a_checkpoint_starts_fresh(tiny_ds, tmp_path):
    ds = _port_ds(tiny_ds)
    _, straight = _fit(ds, tmp_path / "s")
    tr, resumed = _fit(ds, tmp_path / "r", **{"train.checkpoint_every": 5,
                                              "train.resume": True})
    assert tr.ckpt.latest_step() == 12
    _assert_same_state(resumed, straight)


def test_debug_nans_leaves_the_last_finite_checkpoint_intact(tiny_ds, tmp_path):
    ds = _port_ds(tiny_ds)
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path / "run", **{
        "train.debug_nans": True, "train.checkpoint_every": 2})), ds, device="cpu")
    real = tr.train_step

    def poisoned(state, batch):
        state, m = real(state, batch)
        if state.step == 5:
            m = dict(m, nonfinite=torch.tensor(True))
        return state, m

    tr.train_step = poisoned
    with pytest.raises(FloatingPointError, match="step 4.*checkpoint is intact"):
        tr.fit()
    assert tr.ckpt.all_steps() == [2, 4]
    state, step, pos, _ = tr.ckpt.restore(tr.abstract_state())
    assert step == 4 and pos == 4 and state.step == 4


# ---------------------------------------------------------------------------
# The CLI: eval and recommend --ckpt read what train wrote
# ---------------------------------------------------------------------------


def _cli(argv) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("sparse", [False, True])
def test_eval_and_recommend_read_the_checkpoint(tmp_path, sparse):
    overrides = [f"data.data_dir={tmp_path / 'data'}", "data.dataset=synthetic",
                 "data.synthetic_num_users=60", "data.synthetic_num_items=50",
                 "data.synthetic_max_len=20", "model.embed_dim=16", "model.compute_dtype=float32",
                 "model.loss=sampled_softmax", "model.num_negatives=16", "data.batch_size=8",
                 "data.max_len=12",
                 "data.buckets=[6,12]", "train.num_steps=8", "train.eval_every=0",
                 "train.log_every=1000", "train.checkpoint_every=4", "train.steps_per_call=4",
                 f"train.out_dir={tmp_path / 'run'}", "eval.batch_size=16",
                 f"train.sparse_embedding_update={str(sparse).lower()}",
                 "train.optimizer=adagrad"]
    args = sum((["--set", o] for o in overrides), [])
    lines = _cli(["train", "--device", "cpu", *args]).splitlines()
    final = json.loads(lines[-1])["final_test"]
    cfg = RunConfig().apply_overrides(overrides)
    tr = Trainer(cfg, device="cpu")
    state, step, _, _ = CheckpointManager(str(tmp_path / "run" / "ckpt")).restore(
        tr.abstract_state())
    assert step == 8
    want = tr.evaluate(state, split="test")
    assert final == want
    got = json.loads(_cli(["eval", "--device", "cpu", "--split", "test", *args]))
    assert got == {"step": 8, "split": "test", **want}

    rng = np.random.default_rng(0)
    hist = [{"user": i, "history": rng.integers(1, 51, size=n).tolist()}
            for i, n in enumerate([3, 0, 9, 5])]
    src = tmp_path / "hist.jsonl"
    src.write_text("".join(json.dumps(h) + "\n" for h in hist))
    got = [json.loads(x) for x in _cli(["recommend", "--device", "cpu", "--k", "5",
                                        "--ckpt", str(tmp_path / "run" / "ckpt"),
                                        "--input", str(src), *args]).splitlines()]
    model = build_model(cfg.model, load_dataset(cfg.data).vocab_size, device="cpu")
    model.load_state_dict(state.params)
    model.eval()
    want = list(recommend(model, hist, k=5, max_len=cfg.data.max_len))
    assert got == json.loads(json.dumps(want))
    # --ckpt defaults to out_dir/ckpt.
    assert [json.loads(x) for x in _cli(["recommend", "--device", "cpu", "--k", "5",
                                         "--input", str(src), *args]).splitlines()] == got
    with pytest.raises(SystemExit):
        cli.main(["recommend", "--ckpt", "a", "--weights", "b.npz"])


def test_resume_equals_straight_with_native_and_python_loaders_alike(tiny_ds, tmp_path,
                                                                     monkeypatch):
    """The Python batcher fast-forwards as the native engine does: a resume
    through it lands on its straight run."""
    monkeypatch.setattr(native, "available", lambda: False)
    ds = _port_ds(tiny_ds)
    _, straight = _fit(ds, tmp_path / "s")
    _fit(ds, tmp_path / "k", **{"train.checkpoint_every": 5, "train.fail_after_step": 8})
    tr, resumed = _fit(ds, tmp_path / "k", **{"train.checkpoint_every": 5,
                                              "train.resume": True})
    assert tr.data_engine == "python"
    _assert_same_state(resumed, straight)
    _assert_same_state(clone_state(resumed), resumed)
