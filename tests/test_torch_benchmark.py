"""The port's `benchmark` subcommand and its runner
(`seqrec_tpu_torch/benchmarks/`) against the JAX repository's
(`benchmarks/timing.py`, `benchmarks/throughput.py`), on the CPU.

- The slope estimator: `_paired_slope` on the same hand-made chain times
  gives the same slope and detail (all but the host's load average), and
  `median_slope` and `deltas_distinguishable` the same answers, over
  positive, mixed, all-negative and too-short chains.
- `fetch_scalar` reads the first floating tensor of a train state.
- `run_benchmark` and `run_pipeline_benchmark`: the JAX runner's key set,
  each value of the same type, and examples/s consistent with the step
  time and device count on both sides (the JAX side on the conftest's 8
  CPU devices at batch_size 1 a device, the port on one process at 8: the
  same global batch).
- The 8 batches the runner stages equal, wire for wire, the ones the JAX
  runner stages, bucketed (buckets 24/32/40) and session-parallel.
- The chain adds no math: the runner's step over n steps, and the timed
  chain's final state, equal `Trainer.train_step` applied n times, bit for
  bit (dense, sparse adagrad, session-parallel); a chain seeded with
  clones leaves the seed state's tables and row state as they were.
- The CLI: one JSON line with the JAX CLI's keys, the same flags and
  defaults, the KeyError of an unknown `--set` key, the no-CUDA error
  without `--device`, and rank 0 alone printing at world 2 over gloo.
"""

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import throughput as jax_throughput
from benchmarks import timing as jax_timing
from seqrec_tpu import cli as jax_cli
from seqrec_tpu.config import RunConfig as JaxRunConfig
from seqrec_tpu.train import trainer as jax_trainer
from seqrec_tpu_torch import cli
from seqrec_tpu_torch.benchmarks import throughput, timing
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data.dataset import synthetic_dataset
from seqrec_tpu_torch.train import trainer as torch_trainer
from seqrec_tpu_torch.train.state import TrainState, clone_state
from seqrec_tpu_torch.train.trainer import Trainer
from torch_mesh_worker import spawn

ROOT = Path(__file__).resolve().parents[1]
JAX_DEVICES = 8  # tests/conftest.py's fake CPU devices
B = 8  # the port's batch on one process; the JAX side's global batch

# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

# (n_short, n_long, reps, short times, long times), in seconds.
TIMES = {
    "positive_odd": (10, 30, 3, [0.50, 0.52, 0.49], [1.50, 1.61, 1.55]),
    "positive_even": (10, 30, 4, [0.50, 0.52, 0.49, 0.51], [1.50, 1.61, 1.55, 1.40]),
    "some_negative": (10, 30, 4, [0.50, 0.90, 0.49, 0.51], [1.50, 0.80, 0.41, 1.70]),
    "all_negative": (10, 30, 4, [0.50, 0.90, 0.49, 0.51], [0.40, 0.80, 0.41, 0.30]),
    "gap_under_50ms": (10, 30, 4, [0.100, 0.101, 0.099, 0.100], [0.130, 0.141, 0.120, 0.125]),
}


def _times(case):
    n_short, n_long, reps, short, long = TIMES[case]
    return {n_short: list(short), n_long: list(long)}, n_short, n_long, reps


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", sorted(TIMES))
def test_paired_slope_equals_jax(case):
    times, n_short, n_long, reps = _times(case)
    got_ms, got = timing._paired_slope(times, n_short, n_long, reps)
    want_ms, want = jax_timing._paired_slope(times, n_short, n_long, reps)
    assert _same(got_ms, want_ms)
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "host_load_1m":  # read at another moment on each side
            assert _same(got[k], want[k]), (k, got[k], want[k])
    assert isinstance(got["host_load_1m"], float)
    if case == "all_negative":
        assert math.isnan(got_ms) and not got["reliable"]
    if case == "gap_under_50ms":
        assert got_ms > 0 and not got["reliable"]
    if case.startswith("positive"):  # the upper median
        assert got["reliable"]
        assert got_ms == pytest.approx(sorted(got["slopes_ms"])[reps // 2], abs=1e-4)


@pytest.mark.parametrize("case", sorted(TIMES))
def test_median_slope_and_deltas_distinguishable_equal_jax(case):
    details = {c: timing._paired_slope(*_times(c))[1] for c in TIMES}
    mine = details[case]
    assert _same(timing.median_slope(mine), jax_timing.median_slope(mine))
    for other in details.values():
        assert (timing.deltas_distinguishable(mine, other)
                == jax_timing.deltas_distinguishable(mine, other))
    # A detail is never distinguishable from itself, and one without a
    # positive rep from anything.
    assert not timing.deltas_distinguishable(mine, mine)
    if case == "all_negative":
        assert not any(timing.deltas_distinguishable(mine, o) for o in details.values())


def test_deltas_distinguishable_sees_a_difference_past_the_spreads():
    fast = timing._paired_slope({10: [0.5] * 4, 30: [1.0, 1.01, 1.02, 1.0]}, 10, 30, 4)[1]
    slow = timing._paired_slope({10: [0.5] * 4, 30: [2.0, 2.01, 2.02, 2.0]}, 10, 30, 4)[1]
    assert timing.deltas_distinguishable(fast, slow)
    assert jax_timing.deltas_distinguishable(fast, slow)


def test_fetch_scalar_reads_the_first_floating_tensor():
    state = TrainState(step=3, params={"a": torch.tensor([[2.5, 1.0]]), "b": torch.ones(2)},
                       opt_state={"count": 0}, rng_seed=1,
                       carry=(torch.zeros(1, dtype=torch.int32),))
    assert timing.fetch_scalar(state) == 2.5
    assert timing.fetch_scalar({"ids": torch.tensor([7, 1]), "x": torch.tensor([0.25])}) == 0.25
    assert timing.fetch_scalar([torch.tensor([4, 5])]) == 4.0
    with pytest.raises(ValueError, match="no tensor leaves"):
        timing.fetch_scalar({"step": 1})


def test_chain_slope_ms_seeds_every_chain_and_counts_its_steps():
    seeds, steps = [], []

    def seed():
        seeds.append(1)
        return torch.zeros(1)

    def step(c, i):
        steps.append(i)
        return c + 1

    ms, detail = timing.chain_slope_ms(step, seed, n_short=2, n_long=5, reps=3)
    assert len(seeds) == 6  # one a chain
    assert steps == ([0, 1, 2] + [0, 1, 2, 3, 4, 5]) * 3
    assert (detail["n_short"], detail["n_long"], detail["reps"]) == (2, 5, 3)
    assert len(detail["slopes_ms"]) == 3


def test_alternated_slopes_interleave_the_candidates_in_every_rep():
    calls = []

    def seed():
        return torch.zeros(1)

    def stepper(name):
        def step(c, i):
            if i == 0:
                calls.append(name)  # a chain's seed step
            return c + 1
        return step

    def runner(name):
        return lambda n: calls.append((name, n))

    chains = timing.alternating_chain_slopes_ms(
        {"a": (stepper("a"), seed), "b": (stepper("b"), seed)}, n_short=2, n_long=4, reps=3)
    assert calls == ["a", "a", "b", "b"] * 3
    calls.clear()
    runs = timing.alternating_run_slopes_ms({"a": runner("a"), "b": runner("b")},
                                            n_short=2, n_long=4, reps=3)
    assert calls == [("a", 2), ("a", 4), ("b", 2), ("b", 4)] * 3
    for out in (chains, runs):
        assert sorted(out) == ["a", "b"]
        assert all(len(d["slopes_ms"]) == 3 and d["n_long"] == 4 for _, d in out.values())


# ---------------------------------------------------------------------------
# The runner against the JAX runner
# ---------------------------------------------------------------------------

MODEL = {"model.embed_dim": 16, "model.dropout_rate": 0.0, "model.loss": "sampled_softmax",
         "model.num_negatives": 16, "model.compute_dtype": "float32"}
CONFIGS = {
    # The runner's histories are min(T, 20)..T+1 long: buckets under 20
    # would never fill, so these sit between 20 and T.
    "bucketed": {**MODEL, "data.max_len": 40, "data.buckets": (24, 32),
                 "data.synthetic_num_items": 60},
    "session": {**MODEL, "model.loss": "bpr_max", "data.max_len": 10, "data.buckets": (),
                "data.session_parallel": True, "data.synthetic_num_items": 60},
}


def _apply(cfg, settings):
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


def _port_cfg(case, **extra):
    return _apply(RunConfig(), {**CONFIGS[case], "data.batch_size": B, **extra})


def _jax_cfg(case, **extra):
    # batch_size is per device: 1 on each of the 8 devices is the port's B.
    return _apply(JaxRunConfig(), {**CONFIGS[case], "data.batch_size": B // JAX_DEVICES,
                                   **extra})


def _wire(tr, batch):
    if isinstance(batch, dict) and not isinstance(
            batch, (jax_trainer.DeclinedDict, torch_trainer.DeclinedDict)):
        packed = tr.pack_batch(batch)
        if packed is not None:
            return np.asarray(packed)
        return {k: np.asarray(v) for k, v in batch.items()}
    return np.asarray(batch)


@contextlib.contextmanager
def _recording_put_batch(cls, staged):
    """`cls.put_batch` records the host wire of every batch it stages."""
    put = cls.put_batch

    def put_batch(self, batch):
        staged.append(_wire(self, batch))
        return put(self, batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "put_batch", put_batch)
        yield


@pytest.fixture(scope="module")
def runs():
    """run_benchmark of each config on both sides (steps=2, warmup=1), with
    the wires each side staged."""
    out = {}
    for case in CONFIGS:
        jax_staged, port_staged = [], []
        with _recording_put_batch(jax_trainer.Trainer, jax_staged):
            jax_res = jax_throughput.run_benchmark(_jax_cfg(case), steps=2, warmup=1)
        with _recording_put_batch(Trainer, port_staged):
            port_res = throughput.run_benchmark(_port_cfg(case), steps=2, warmup=1,
                                                device="cpu")
        out[case] = {"jax": jax_res, "port": port_res, "jax_staged": jax_staged,
                     "port_staged": port_staged}
    return out


def _same_keys_and_types(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert type(got[k]) is type(want[k]), (k, type(got[k]), type(want[k]))


def _consistent(res: dict, devices: int) -> None:
    assert res["num_devices"] == devices and res["global_batch"] == B
    ms = res["step_time_ms"]
    assert math.isfinite(ms) and ms > 0, res
    assert res["examples_per_s"] == res["global_batch"] / (ms / 1e3)
    assert res["examples_per_s_per_chip"] == res["examples_per_s"] / res["num_devices"]
    assert res["backend"] == "cpu" and res["steps"] == 2 and len(res["slopes_ms"]) == 4


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_run_benchmark_has_the_jax_runners_keys_and_types(runs, case):
    got, want = runs[case]["port"], runs[case]["jax"]
    _same_keys_and_types(got, want)
    _consistent(got, 1)
    _consistent(want, JAX_DEVICES)
    assert got["seq_len"] == want["seq_len"]


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_run_benchmark_stages_the_jax_runners_batches(runs, case):
    got, want = runs[case]["port_staged"], runs[case]["jax_staged"]
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, dict):
            assert isinstance(g, dict) and sorted(g) == sorted(w), i
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"batch {i} {k}")
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"batch {i}")
    if case == "bucketed":  # more than one bucket's width occurs
        assert len({g.shape[1] for g in got}) > 1


def test_run_pipeline_benchmark_has_the_jax_runners_keys_and_types():
    want = jax_throughput.run_pipeline_benchmark(_jax_cfg("bucketed"), steps=2, warmup=1)
    got = throughput.run_pipeline_benchmark(_port_cfg("bucketed"), steps=2, warmup=1,
                                            device="cpu")
    _same_keys_and_types(got, want)
    _consistent(got, 1)
    _consistent(want, JAX_DEVICES)
    assert got["loader"] == want["loader"] and got["prefetch_depth"] == want["prefetch_depth"]


def test_run_pipeline_alternating_times_each_config():
    cfgs = {"k2": _port_cfg("bucketed", **{"train.steps_per_call": 2}),
            "k1": _port_cfg("bucketed")}
    both = throughput.run_pipeline_alternating(cfgs, steps=2, warmup=1, reps=2, device="cpu")
    assert sorted(both) == ["k1", "k2"]
    for name, res in both.items():
        assert res["settle_s"] == both["k1"]["settle_s"] > 0
        assert len(res["slopes_ms"]) == 2 and res["backend"] == "cpu"
        # The config was made bare.
        assert cfgs[name].train.out_dir == "" and cfgs[name].train.eval_every == 0


def test_bench_config_equals_the_jax_one():
    kw = dict(batch_size=128, max_len=200, embed_dim=64, num_items=3_417,
              loss="sampled_softmax", num_negatives=256)
    got = json.loads(throughput.bench_config("gru4rec", **kw).to_json())
    want = json.loads(jax_throughput.bench_config("gru4rec", **kw).to_json())
    assert got == want


# ---------------------------------------------------------------------------
# The chain adds no math; seeding leaves the seed alone
# ---------------------------------------------------------------------------

STEP_CASES = {
    "dense": _apply(RunConfig(), {**CONFIGS["bucketed"], "data.batch_size": B,
                                  "model.dropout_rate": 0.2}),
    "sparse": _apply(RunConfig(), {**CONFIGS["bucketed"], "data.batch_size": B,
                                   "data.buckets": (), "train.optimizer": "adagrad",
                                   "train.sparse_embedding_update": True,
                                   "model.tie_embeddings": True}),
    "session": _apply(RunConfig(), {**CONFIGS["session"], "data.batch_size": B,
                                    "model.dropout_rate": 0.1}),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{prefix}/{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def _bitwise_equal(a, b) -> None:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k, v in lb.items():
        if isinstance(v, torch.Tensor):
            assert la[k].dtype == v.dtype and torch.equal(la[k], v), k
        else:
            assert la[k] == v, k


def _trainer(case):
    cfg = RunConfig.from_json(STEP_CASES[case].to_json())
    ds = synthetic_dataset(64, cfg.data.synthetic_num_items, seed=2, min_len=3,
                           max_len=cfg.data.max_len + 1)
    tr = Trainer(cfg, ds, device="cpu")
    return tr, throughput.stage_batches(tr, 8)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_the_chain_equals_train_step_repeated(case):
    tr, staged = _trainer(case)
    state0 = tr.init_state()
    n = 10  # past the 8 staged batches: the chain cycles them
    step = throughput.chain_step(tr, staged)
    got = clone_state(state0)
    for i in range(n):
        got = step(got, i)
    want = clone_state(state0)
    for i in range(n):
        want, _ = tr.train_step(want, staged[i % 8])
    assert got.step == want.step == n
    _bitwise_equal(got, want)

    # The timed chain's last (long) chain: a seed step, then n_long steps.
    last = []

    def recording(c, i):
        c = step(c, i)
        last[:] = [c]
        return c

    timing.chain_slope_ms(recording, lambda: clone_state(state0), n_short=1, n_long=3, reps=1)
    want = clone_state(state0)
    for i in range(4):
        want, _ = tr.train_step(want, staged[i])
    _bitwise_equal(last[0], want)


def test_chains_seeded_with_clones_leave_the_seed_state_alone():
    tr, staged = _trainer("sparse")
    state0 = tr.init_state()
    before = clone_state(state0)
    step = throughput.chain_step(tr, staged)
    timing.chain_slope_ms(step, lambda: clone_state(state0), n_short=1, n_long=2, reps=2)
    _bitwise_equal(state0, before)
    # The check can see an in-place update: a step from the state itself
    # changes its table and row state.
    step(state0, 0)
    table = "item_embedding"
    assert not torch.equal(state0.params[table], before.params[table])
    assert any(not torch.equal(v, before.embed_opt[table][k])
               for k, v in state0.embed_opt[table].items())


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _config_file(tmp_path, case="bucketed", batch_size=B) -> str:
    cfg = _apply(RunConfig(), {**CONFIGS[case], "data.batch_size": batch_size})
    path = tmp_path / f"{case}.json"
    path.write_text(cfg.to_json())
    return str(path)


def _lines(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(x) for x in out.getvalue().splitlines() if x.strip()]


def test_benchmark_cli_prints_one_line_with_the_jax_clis_keys(tmp_path):
    config = _config_file(tmp_path)
    r = subprocess.run([sys.executable, "-m", "seqrec_tpu_torch", "benchmark", "--device", "cpu",
                        "--config", config, "--steps", "2", "--warmup", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [x for x in r.stdout.splitlines() if x.strip()]
    assert len(lines) == 1, r.stdout
    got = json.loads(lines[0])
    want = _lines(jax_cli.main, ["benchmark", "--config", config, "--steps", "2",
                                 "--warmup", "1"])
    assert len(want) == 1
    assert sorted(got) == sorted(want[0])
    assert (got["steps"], got["num_devices"], got["global_batch"], got["backend"]) == (
        2, 1, B, "cpu")
    assert want[0]["num_devices"] == JAX_DEVICES


def test_benchmark_cli_has_the_jax_clis_flags_and_defaults(monkeypatch):
    seen = {}

    def capture(side):
        def cmd(args):
            seen[side] = vars(args)
            return 0
        return cmd

    monkeypatch.setattr(cli, "cmd_benchmark", capture("port"))
    monkeypatch.setattr(jax_cli, "cmd_benchmark", capture("jax"))
    for argv in (["benchmark"], ["benchmark", "--config", "c.json", "--set", "a.b=1",
                                 "--steps", "7", "--warmup", "3", "--coordinator", "h:1",
                                 "--num_processes", "2", "--process_id", "1"]):
        assert cli.main(argv) == 0 and jax_cli.main(argv) == 0
        port, jax_args = dict(seen["port"]), dict(seen["jax"])
        assert port.pop("device") == "cuda"  # the port's one flag more (_add_common's)
        port.pop("fn"), jax_args.pop("fn")
        assert port == jax_args
    assert seen["port"]["steps"] == 7 and seen["port"]["warmup"] == 3
    cli.main(["benchmark"])
    assert (seen["port"]["steps"], seen["port"]["warmup"]) == (100, 10)


def test_benchmark_cli_unknown_set_key_raises_the_jax_keyerror(tmp_path):
    argv = ["benchmark", "--config", _config_file(tmp_path), "--set", "model.nope=1"]
    with pytest.raises(KeyError) as want:
        jax_cli.main(argv)
    with pytest.raises(KeyError) as got:
        cli.main([*argv, "--device", "cpu"])
    assert "nope" in str(got.value) and str(got.value) == str(want.value)


def test_benchmark_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["benchmark", "--config", _config_file(tmp_path), "--steps", "2"])


def test_benchmark_cli_at_world_2_over_gloo(tmp_path):
    d = tmp_path / "w2"
    d.mkdir()
    np.savez(d / "inputs.npz", unused=np.zeros(1))
    (d / "inputs.json").write_text(json.dumps({
        "config": _config_file(tmp_path), "args": ["--steps", "2", "--warmup", "1"]}))
    outs = spawn("benchmark", 2, d, timeout=90)
    assert [int(o["rc"]) for o in outs] == [0, 0]
    assert str(outs[1]["stdout"]) == ""  # rank 0 alone prints
    lines = [x for x in str(outs[0]["stdout"]).splitlines() if x.strip()]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["num_devices"] == 2 and res["global_batch"] == 2 * B
    assert res["examples_per_s_per_chip"] == res["examples_per_s"] / 2
    assert res["backend"] == "cpu"
