"""Resharding on restore (`train/checkpoint.py`) against the JAX package's
orbax restore, on the CPU: the port's gloo ranks (`torch_mesh_worker.py`
"reshard", no JAX there) against `seqrec_tpu.train.checkpoint` on the
conftest's fake devices.

The grid: one random state a case and writer mesh, saved from mesh A and
restored on mesh B, for A and B in MESHES (all 36 pairs). The JAX side
saves it with its CheckpointManager from a Trainer on A and restores it
with `abstract_like` of a Trainer's state on B (sharded by
`state_sharding`); the port side saves the same state from A's ranks (each
its part) and restores it on B's ranks. Wherever JAX restores, every leaf
the port's ranks hold, put together (row shards in model order, the carry
in rank order), equals JAX's bit for bit; wherever JAX raises, every rank
of the port raises, naming each leaf whose global shape differs with both
shapes. Cases (f32, tiny):
- dense: tables whole (no `mesh.shard_embeddings`): every pair restores;
- sharded: vocab 16 (15 items) with `mesh.shard_embeddings`, padded to 16
  at model axis 1 and 2 and to 32 at 4: model axis 1 <-> 2 restores, 4
  only from 4 (adam: the tables' moments follow the tables);
- sparse: the sparse step's row state (adagrad), sharded as above;
- session: session-parallel GRU, vocab 32 (padded to 32 at every model
  axis): the carry restores on the same world size only.

Besides: a fit killed at (1, 2) with sharded tables, resumed at (1, 1) and
at (2, 1) (the state it restores equals the killer's bit for bit, its first
batch is `train_iterator(skip_batches=8)`'s on the new mesh, it reaches
num_steps with finite losses); a round trip (2, 1) -> (4, 1) -> (2, 1), bit
for bit; the `eval` and `recommend --ckpt` subcommands in one process on
that 2-rank checkpoint against the 2-rank evaluate and top-k (1e-5
relative on the metrics and 1e-6 on the scores, as
tests/test_torch_mesh_fit.py: f32 sums in another order; the same items).

One spawn a world size: world 1 runs in this process, worlds 2 and 4 at
once, each waiting for the others' saves before it restores.
"""

import io
import json
import shutil
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from seqrec_tpu.config import RunConfig as JaxRunConfig
from seqrec_tpu.runtime import make_mesh as jax_make_mesh
from seqrec_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from seqrec_tpu.train.checkpoint import abstract_like
from seqrec_tpu.train.trainer import Trainer as JaxTrainer
from seqrec_tpu_torch import cli
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data.dataset import load_dataset
from seqrec_tpu_torch.train.checkpoint import _owner
from seqrec_tpu_torch.train.trainer import Trainer
from torch_mesh_worker import finish, resume_on, start, state_from_leaves, state_leaves

MESHES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (1, 4)]
STEP = 7
BASE = {"model.embed_dim": 8, "model.use_pallas": False, "model.compute_dtype": "float32",
        "model.dropout_rate": 0.0, "model.loss": "sampled_softmax", "model.num_negatives": 4,
        "model.max_len": 6, "data.max_len": 6, "data.batch_size": 2,
        "train.compilation_cache_dir": "", "train.optimizer": "adam"}
CASES = {"dense": {**BASE, "mesh.shard_embeddings": False},
         "sharded": {**BASE, "mesh.shard_embeddings": True},
         "sparse": {**BASE, "mesh.shard_embeddings": True, "train.optimizer": "adagrad",
                    "train.sparse_embedding_update": True},
         "session": {**BASE, "mesh.shard_embeddings": True, "data.session_parallel": True}}
VOCAB = {"dense": 16, "sharded": 16, "sparse": 16, "session": 32}
ROUND_TRIP = "sparse"
# The killed fit: 90 items (vocab 91, padded to 96 at model axis 1 and 2).
DATA = {"data.dataset": "synthetic", "data.synthetic_num_users": 61,
        "data.synthetic_num_items": 90, "data.synthetic_min_len": 4,
        "data.synthetic_max_len": 14, "data.use_native_loader": False}
KILL = {**DATA, "model.embed_dim": 16, "model.use_pallas": False,
        "model.compute_dtype": "float32", "model.dropout_rate": 0.1,
        "model.loss": "sampled_softmax", "model.num_negatives": 16, "model.max_len": 12,
        "data.max_len": 12, "data.batch_size": 4, "data.buckets": [6, 12],
        "train.num_steps": 16, "train.steps_per_call": 4, "train.checkpoint_every": 4,
        "train.log_every": 4, "train.eval_every": 0, "train.learning_rate": 0.01,
        "train.compilation_cache_dir": "", "eval.batch_size": 10, "mesh.model_axis": 2,
        "mesh.shard_embeddings": True}
KILL_AT, TIMEOUT_S = 8, 150


def _name(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _apply(cfg, settings):
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


class _DS:
    def __init__(self, vocab: int, users: int = 0):
        self.vocab_size, self.num_users = vocab, users


# ---- the JAX side ----------------------------------------------------------


def _key(k):
    for attr in ("name", "key", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _port_leaves(jstate) -> dict:
    """A JAX TrainState's array leaves under the port's paths (the rng key
    and the step and count scalars left out)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        keys = [_key(k) for k in path]
        head = keys[0]
        if head == "params":  # params/params/<flax path>
            out["/params/" + ".".join(keys[2:])] = np.asarray(leaf)
        elif head == "opt_state" and keys[-1] != "count":  # a moment: [params/]<flax path>
            at = next(i for i, k in enumerate(keys) if k in ("mu", "nu", "sum_of_squares"))
            tail = keys[at + 2:] if keys[at + 1] == "params" else keys[at + 1:]
            out[f"/opt_state/{keys[at]}/" + ".".join(tail)] = np.asarray(leaf)
        elif head in ("embed_opt", "carry"):
            out[f"/{head}/" + "/".join(str(k) for k in keys[1:])] = np.asarray(leaf)
    return out


def _random_state(jtr, rng):
    """A state of `jtr`'s structure (`init_state`'s, traced, not run) with
    every float leaf drawn from `rng` and every integer leaf (the step and
    the optimizer's counts) set to STEP, each on its `state_sharding`."""
    abstract = jax.eval_shape(lambda: jtr.init_state(0))

    def draw(leaf, sharding):
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            return jax.device_put(jax.random.key(STEP), sharding)
        if np.issubdtype(leaf.dtype, np.floating):
            a = rng.standard_normal(leaf.shape).astype(leaf.dtype)
        else:
            a = np.full(leaf.shape, STEP, leaf.dtype)
        return jax.device_put(a, sharding)

    return jax.tree.map(draw, abstract, jtr.state_sharding(abstract))


def _jax_side(root):
    """Every case's random state on each mesh, saved with the JAX package's
    manager; every pair's restore: the leaves by port path, or None where
    orbax raised. Returns (states, restored)."""
    states, restored = {}, {}
    for case, settings in CASES.items():
        cfg = _apply(JaxRunConfig(), {k: v for k, v in settings.items()
                                      if k != "mesh.model_axis"})
        jstates = {}
        for i, (D, M) in enumerate(MESHES):
            cfg.mesh.model_axis = M
            mesh = jax_make_mesh(M, devices=jax.devices()[:D * M])
            jtr = JaxTrainer(cfg, _DS(VOCAB[case]), mesh=mesh)
            rng = np.random.default_rng(100 * len(states) + i)
            jstates[(D, M)] = _random_state(jtr, rng)
            states[case, (D, M)] = _port_leaves(jstates[(D, M)])
            mgr = JaxCheckpointManager(str(root / "jax" / case / _name((D, M))),
                                       async_save=False)
            mgr.save(STEP, jstates[(D, M)], data_position=STEP)
            mgr.close()
        for a in MESHES:
            mgr = JaxCheckpointManager(str(root / "jax" / case / _name(a)))
            for b in MESHES:
                try:
                    got = mgr.restore(abstract_like(jstates[b]))[0]
                except ValueError:
                    restored[case, a, b] = None
                else:
                    restored[case, a, b] = _port_leaves(got)
            mgr.close()
    return states, restored


# ---- the fixture ------------------------------------------------------------


def _save_one_process(root, states) -> None:
    """World 1's checkpoints (the (1, 1) mesh), from this process."""
    for case, settings in CASES.items():
        tr = Trainer(_apply(RunConfig(), {**settings, "mesh.model_axis": 1}),
                     _DS(VOCAB[case]), device="cpu")
        leaves = {p: torch.from_numpy(np.array(a)) for p, a in states[case, (1, 1)].items()}
        mgr = tr.checkpoint_manager(str(root / "port" / case / "1x1"))
        mgr.save(STEP, state_from_leaves(leaves, STEP), data_position=STEP)
        mgr.wait()


def _restore_one_process(root, out: dict) -> None:
    for case, settings in CASES.items():
        tr = Trainer(_apply(RunConfig(), {**settings, "mesh.model_axis": 1}),
                     _DS(VOCAB[case]), device="cpu")
        out[f"{case}|1x1|sharded"] = np.array([""])
        for a in MESHES:
            prefix = f"{case}|{_name(a)}|1x1|"
            mgr = tr.checkpoint_manager(str(root / "port" / case / _name(a)))
            try:
                state, step, pos, _ = mgr.restore(tr.abstract_state(), "cpu")
            except ValueError as e:
                out[prefix + "error"] = np.array([str(e)])
                continue
            out[prefix + "meta"] = np.array([step, state.step, state.opt_state["count"], pos,
                                             mgr.restores[-1]["bytes_read"]])
            for path, t in state_leaves(state).items():
                out[prefix + path] = t.numpy()


def _cli(argv) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(argv) == 0
    return [json.loads(x) for x in buf.getvalue().splitlines() if x.strip()]


def _sets(settings: dict) -> list:
    out = []
    for k, v in settings.items():
        v = str(v).lower() if isinstance(v, bool) else json.dumps(v) if isinstance(v, list) else v
        out += ["--set", f"{k}={v}"]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("reshard")
    kill = {**KILL, "data.data_dir": str(root / "data")}
    ds = load_dataset(_apply(RunConfig(), kill).data)  # once, before the ranks read it
    rng = np.random.default_rng(3)
    histories = [{"user": i, "history": [int(x) for x in ds.seq(i)[-int(rng.integers(1, 9)):]]}
                 for i in range(9)]
    states, jax_restored = _jax_side(root)
    _save_one_process(root, states)
    (root / "saved.w1").write_text("")
    io_arrays = {f"{case}|{_name(m)}|{p}": a for (case, m), leaves in states.items()
                 for p, a in leaves.items()}
    spec = {"root": str(root), "meshes": MESHES, "cases": CASES, "vocab": VOCAB, "step": STEP,
            "kill": kill, "histories": histories, "round_trip": ROUND_TRIP}
    started = []
    for world in (2, 4):
        d = root / f"w{world}"
        d.mkdir()
        np.savez(d / "inputs.npz", **io_arrays)
        (d / "inputs.json").write_text(json.dumps(spec))
        started.append(start("reshard", world, d, timeout=TIMEOUT_S))
    outs, failed = {}, []
    for world, handle in zip((2, 4), started):
        try:
            outs[world] = finish(handle)
        except AssertionError as e:  # the other world's ranks still finish
            failed.append(str(e))
    assert not failed, failed
    ones = {}
    _restore_one_process(root, ones)
    outs[1] = [ones]
    resume_on(_apply(RunConfig(), {**kill, "mesh.model_axis": 1}),
              root / "kill" / "run" / "ckpt", root / "kill" / "at_1x1", ones, "kill/1x1/")
    one = {k: v for k, v in kill.items() if k != "mesh.model_axis"}
    ckpt = str(root / "kill" / "run" / "ckpt")
    ones["cli/eval"] = _cli(["eval", "--device", "cpu", "--ckpt", ckpt, "--split", "test",
                             *_sets(one)])[-1]
    src = root / "histories.jsonl"
    src.write_text("".join(json.dumps(h) + "\n" for h in histories))
    ones["cli/recommend"] = _cli(["recommend", "--device", "cpu", "--ckpt", ckpt, "--k", "5",
                                  "--batch_size", "4", "--input", str(src), *_sets(one)])
    return root, states, jax_restored, outs


# ---- the grid ---------------------------------------------------------------


def _sharded(outs, case, mesh) -> set:
    return set(outs[mesh[0] * mesh[1]][0][f"{case}|{_name(mesh)}|sharded"]) - {""}


def _whole(ranks: list, prefix: str, path: str, mesh, sharded: set) -> np.ndarray:
    """A leaf put together from the ranks' parts on `mesh`: the carry in
    rank order, a row-sharded leaf from the ranks of data index 0 in model
    order (each model index's ranks alike), any other leaf rank 0's (every
    rank's alike)."""
    parts = [r[prefix + path] for r in ranks]
    D, M = mesh
    if path.startswith("/carry/"):
        return np.concatenate(parts)
    if _owner(path) in sharded:
        for r, p in enumerate(parts):
            assert np.array_equal(p, parts[r % M]), (path, r)
        return np.concatenate(parts[:M])
    for r, p in enumerate(parts):
        assert np.array_equal(p, parts[0]), (path, r)
    return parts[0]


PAIRS = [(case, a, b) for case in CASES for a in MESHES for b in MESHES]


@pytest.mark.parametrize("case,writer,reader", PAIRS,
                         ids=[f"{c}-{_name(a)}-to-{_name(b)}" for c, a, b in PAIRS])
def test_restores_exactly_where_orbax_does(run, case, writer, reader):
    _, states, jax_restored, outs = run
    ranks = outs[reader[0] * reader[1]]
    prefix = f"{case}|{_name(writer)}|{_name(reader)}|"
    want = jax_restored[case, writer, reader]
    if want is None:  # orbax raised: so does every rank, naming the leaves
        a, b = states[case, writer], states[case, reader]
        differ = [p for p in a if a[p].shape != b[p].shape]
        assert differ
        for r in ranks:
            msg = str(r[prefix + "error"][0])
            assert "does not match" in msg
            for p in differ:
                assert f"{p} {a[p].shape} float32 vs {b[p].shape} float32" in msg, (p, msg)
        return
    assert all(prefix + "error" not in r for r in ranks), ranks[0].get(prefix + "error")
    for r in ranks:  # each rank read its own part's bytes, no more
        part = sum(v.nbytes for k, v in r.items() if k.startswith(prefix + "/"))
        assert list(r[prefix + "meta"]) == [STEP, STEP, STEP, STEP, part]
    sharded = _sharded(outs, case, reader)
    assert bool(sharded) == (case != "dense" and reader[1] > 1)
    got = {p[len(prefix):] for p in ranks[0] if p.startswith(prefix + "/")}
    assert got == set(want)
    for p, w in want.items():
        whole = _whole(ranks, prefix, p, reader, sharded)
        assert whole.dtype == w.dtype and np.array_equal(whole, w), p
        assert np.array_equal(w, states[case, writer][p]), p


def test_the_grid_restores_and_refuses_as_stated(run):
    """Where orbax restores, by case: tables whole everywhere; the padded
    tables across model axis 1 <-> 2 and not to or from 4; the carry on
    its own world size."""
    _, _, jax_restored, _ = run
    for (case, a, b), got in jax_restored.items():
        if case == "dense":
            want = True
        elif case == "session":
            want = a[0] * a[1] == b[0] * b[1]
        else:
            want = (a[1] == 4) == (b[1] == 4)
        assert (got is not None) == want, (case, a, b)


# ---- a killed fit resumed on another mesh, a round trip, the subcommands --


def _killer(outs) -> dict:
    """The killed (1, 2) fit's state at step 8, put together."""
    ranks = outs[2]
    paths = [k[len("kill/killer"):] for k in ranks[0] if k.startswith("kill/killer/")]
    sharded = {"item_embedding"}
    return {p: _whole(ranks, "kill/killer", p, (1, 2), sharded) for p in paths}


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
def test_a_killed_fit_resumes_on_another_mesh(run, mesh):
    _, _, _, outs = run
    killer = _killer(outs)
    assert killer["/params/item_embedding"].shape[0] == 96
    prefix = f"kill/{_name(mesh)}/"
    ranks = outs[1] if mesh == (1, 1) else outs[2]
    for r in ranks:
        assert list(r[prefix + "restored/meta"])[:4] == [KILL_AT] * 4
        got = {k[len(prefix + "restored/"):]: v for k, v in r.items()
               if k.startswith(prefix + "restored//")}
        assert sorted(got) == sorted(killer)
        for p, w in killer.items():
            assert np.array_equal(got[p], w), p  # tables whole on every rank (model axis 1)
        assert int(r[prefix + "skip"][0]) == KILL_AT and bool(r[prefix + "first_equal"][0])
        assert int(r[prefix + "final_step"][0]) == KILL["train.num_steps"]
    losses = ranks[0][prefix + "losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_a_round_trip_is_bit_for_bit(run):
    """(2, 1) -> restored at (4, 1) and saved at once -> restored at (2, 1)."""
    _, states, _, outs = run
    ranks = outs[2]
    want = states[ROUND_TRIP, (2, 1)]
    got = {k[len("round_trip|"):] for k in ranks[0] if k.startswith("round_trip|/")}
    assert got == set(want)
    for r in ranks:
        assert list(r["round_trip|meta"])[:4] == [STEP] * 4
    for p, w in want.items():
        assert np.array_equal(_whole(ranks, "round_trip|", p, (2, 1), set()), w), p


def test_eval_subcommand_on_one_process_equals_the_two_rank_eval(run):
    _, _, _, outs = run
    two = outs[2]
    want = dict(zip(two[0]["kill/eval/keys"], two[0]["kill/eval/values"]))
    assert want == dict(zip(two[1]["kill/eval/keys"], two[1]["kill/eval/values"]))
    got = outs[1][0]["cli/eval"]
    assert got.pop("step") == KILL_AT and got.pop("split") == "test"
    assert sorted(got) == sorted(want) and want["count"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)


def test_recommend_subcommand_on_one_process_equals_the_two_rank_topk(run):
    _, _, _, outs = run
    recs = outs[1][0]["cli/recommend"]
    for r in outs[2]:
        np.testing.assert_array_equal([x["items"] for x in recs], r["kill/recommend/items"])
        np.testing.assert_allclose([x["scores"] for x in recs], r["kill/recommend/scores"],
                                   rtol=1e-6, atol=1e-6)


def test_a_checkpoint_without_the_row_sharded_list_derives_it(run, tmp_path):
    """A multi-rank checkpoint written before meta.json held `row_sharded`
    (the format of earlier checkpoints) restores as one with it: its
    tables are shards unless an item table has exactly vocab_size rows."""
    root, states, _, _ = run
    for case, whole in (("sharded", False), ("dense", True)):
        src = tmp_path / case
        shutil.copytree(root / "port" / case / "1x2", src)
        meta_path = src / str(STEP) / "meta.json"
        meta = json.loads(meta_path.read_text())
        assert meta.pop("row_sharded") == ([] if whole else ["item_embedding"])
        meta["vocab_size"] = VOCAB[case]
        meta_path.write_text(json.dumps(meta))
        tr = Trainer(_apply(RunConfig(), {**CASES[case], "mesh.model_axis": 1}),
                     _DS(VOCAB[case]), device="cpu")
        state = tr.checkpoint_manager(str(src)).restore(tr.abstract_state(), "cpu")[0]
        for p, t in state_leaves(state).items():
            assert np.array_equal(t.numpy(), states[case, (1, 2)][p]), (case, p)
