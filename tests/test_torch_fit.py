"""The port's fit loop against the JAX package's: the prefetcher (the six
tests of tests/unit/test_prefetch.py, on the port's module), `_crossed` and
`_group_wires` (tests/integration/test_steps_per_call.py), the wire groups
`fit` feeds its step (bit for bit the JAX `fit`'s, both step functions
captured in the test), the K=8 trajectory against K=1 (bit for bit: the
port's K-step group is K eager steps), and what `fit` does around the
steps: the loader's choice, eval, the log, `debug_nans`, `fail_after_step`
and the raises for what is not ported yet."""

import json
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from seqrec_tpu.config import RunConfig as JaxRunConfig
from seqrec_tpu.train import trainer as jax_trainer
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import native
from seqrec_tpu_torch.data.dataset import SequenceDataset
from seqrec_tpu_torch.data.prefetch import DevicePrefetcher
from seqrec_tpu_torch.train import trainer as torch_trainer
from seqrec_tpu_torch.train.trainer import Trainer, _crossed, _group_wires

# ---------------------------------------------------------------------------
# DevicePrefetcher (tests/unit/test_prefetch.py)
# ---------------------------------------------------------------------------


def _source(n):
    for i in range(n):
        yield i % 3, {"inputs": np.full((2, 4), i, np.int32)}


def test_prefetch_order_and_values_preserved():
    staged = []

    def put(b):
        staged.append(int(b["inputs"][0, 0]))
        return {k: v + 100 for k, v in b.items()}

    pf = DevicePrefetcher(_source(7), put, depth=2)
    got = list(pf)
    assert [b for b, _ in got] == [i % 3 for i in range(7)]
    assert [int(d["inputs"][0, 0]) - 100 for _, d in got] == list(range(7))
    assert staged == list(range(7))
    pf.close()


def test_prefetch_stages_ahead_of_consumer():
    put_times = []

    def put(b):
        put_times.append(time.perf_counter())
        return b

    pf = DevicePrefetcher(_source(4), put, depth=3)
    deadline = time.perf_counter() + 5.0
    while len(put_times) < 3 and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert len(put_times) >= 3  # staged before the consumer pulled anything
    assert len(list(pf)) == 4
    pf.close()


def test_prefetch_source_error_surfaces_in_consumer():
    def bad_source():
        yield 0, {"inputs": np.zeros((1, 1), np.int32)}
        raise RuntimeError("disk on fire")

    pf = DevicePrefetcher(bad_source(), lambda b: b, depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(pf)
    pf.close()


def test_prefetch_exhaustion_is_stopiteration():
    pf = DevicePrefetcher(_source(2), lambda b: b, depth=4)
    assert len(list(pf)) == 2
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetch_close_unblocks_full_queue_feeder():
    pf = DevicePrefetcher(_source(100), lambda b: b, depth=1)
    next(pf)
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 5.0
    assert not pf._thread.is_alive()


def test_prefetch_infinite_source_close_from_other_thread():
    def forever():
        i = 0
        while True:
            yield 0, {"inputs": np.full((1,), i, np.int32)}
            i += 1

    pf = DevicePrefetcher(forever(), lambda b: b, depth=2)
    for _ in range(5):
        next(pf)
    closer = threading.Thread(target=pf.close)
    closer.start()
    closer.join(timeout=5.0)
    assert not closer.is_alive()


# ---------------------------------------------------------------------------
# _crossed and _group_wires (tests/integration/test_steps_per_call.py)
# ---------------------------------------------------------------------------


def test_crossed_reduces_to_single_step_cadence_and_matches_jax():
    for every in (0, 1, 3, 5):
        for lo in range(17):
            for k in (1, 2, 4, 8):
                assert _crossed(every, lo, lo + k) == jax_trainer._crossed(every, lo, lo + k)
            if every:
                assert _crossed(every, lo, lo + 1) == ((lo + 1) % every == 0)
    assert not _crossed(0, 3, 7)
    assert _crossed(5, 3, 8)
    assert not _crossed(5, 5, 9)


def _pack(batch):
    return batch["wire"]


def _item(bucket, wire_or_none, tag=0):
    w = None if wire_or_none is None else np.full((2, 3), wire_or_none, np.int16)
    return bucket, {"wire": w, "tag": tag}


def _run_both(items, k, limit):
    got = list(_group_wires(iter(items), _pack, k, limit))
    want = list(jax_trainer._group_wires(iter(items), _pack, k, limit))
    assert len(got) == len(want)
    for (bg, pg), (bw, pw) in zip(got, want):
        assert bg == bw and type(pg).__name__ == type(pw).__name__
        if isinstance(pg, dict):
            assert pg["tag"] == pw["tag"]
        else:
            np.testing.assert_array_equal(pg, pw)
    return got


def test_group_wires_shapes_and_order():
    out = _run_both([_item(30, i) for i in range(7)], 3, limit=7)
    assert [o[1].shape for o in out] == [(3, 2, 3), (3, 2, 3), (2, 3)]
    flat = np.concatenate([o[1].reshape(-1, 2, 3) if o[1].ndim == 3 else o[1][None]
                           for o in out])
    np.testing.assert_array_equal(flat[:, 0, 0], np.arange(7))


def test_group_wires_bucket_change_flushes():
    items = [_item(30, 0), _item(30, 1), _item(50, 2), _item(50, 3), _item(50, 4)]
    out = _run_both(items, 2, limit=5)
    assert [o[1].shape for o in out] == [(2, 2, 3), (2, 2, 3), (2, 3)]
    assert [o[0] for o in out] == [30, 50, 50]


def test_group_wires_non_canonical_passthrough_and_flush():
    items = [_item(30, 0), (30, {"wire": None, "tag": 9}), _item(30, 2), _item(30, 3)]
    out = _run_both(items, 2, limit=4)
    assert out[0][1].shape == (2, 3)
    assert isinstance(out[1][1], torch_trainer.DeclinedDict) and out[1][1]["tag"] == 9
    assert out[2][1].shape == (2, 2, 3)


def test_group_wires_limit_tail_degrades_to_singles():
    out = _run_both([_item(30, i) for i in range(8)], 4, limit=6)
    assert [o[1].shape for o in out] == [(4, 2, 3)] + [(2, 3)] * 4


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


def _port_ds(ds) -> SequenceDataset:
    return SequenceDataset(items=ds.items.copy(), offsets=ds.offsets.copy(),
                           vocab_size=ds.vocab_size, name=ds.name)


def _apply(cfg, settings):
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


def _settings(tmp_path, **kw):
    s = {"model.embed_dim": 16, "model.use_pallas": False, "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "model.loss": "sampled_softmax",
         "model.num_negatives": 16, "data.batch_size": 8, "data.max_len": 12,
         "data.buckets": (6, 12), "train.num_steps": 13, "train.log_every": 4,
         "train.eval_every": 0, "train.checkpoint_every": 0,
         "train.out_dir": str(tmp_path / "run"),
         "train.compilation_cache_dir": str(tmp_path / "cc")}
    s.update(kw)
    return s


def _to_np(batch):
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    return np.asarray(batch.cpu() if isinstance(batch, torch.Tensor) else batch)


class _Recorder:
    """Records what a trainer's step functions are fed: ("multi", group) or
    ("single", wire or dict), in order."""

    def __init__(self):
        self.calls = []
        self.inside_multi = False


def _capture_jax(tr, rec):
    """Replace the JAX trainer's jitted steps by recorders that leave the
    state as it is (only the wire groups are compared)."""
    metrics = {"loss": np.float32(1.0), "tokens": np.float32(1.0),
               "grad_norm": np.float32(1.0), "nonfinite": np.bool_(False)}

    def single(state, batch):
        rec.calls.append(("single", _to_np(batch)))
        return state, metrics

    def multi(state, batch):
        rec.calls.append(("multi", _to_np(batch)))
        return state, metrics

    tr._train_step, tr._train_step_multi = single, multi
    tr.precompile = lambda state: None


def _capture_torch(tr, rec):
    single, multi = tr.train_step, tr.train_step_multi

    def rec_single(state, batch):
        if not rec.inside_multi:
            rec.calls.append(("single", _to_np(batch)))
        return single(state, batch)

    def rec_multi(state, wires):
        rec.calls.append(("multi", _to_np(wires)))
        rec.inside_multi = True
        try:
            return multi(state, wires)
        finally:
            rec.inside_multi = False

    tr.train_step, tr.train_step_multi = rec_single, rec_multi


def _one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _same_calls(a, b):
    assert [kind for kind, _ in a] == [kind for kind, _ in b]
    for i, ((_, x), (_, y)) in enumerate(zip(a, b)):
        if isinstance(y, dict):
            assert isinstance(x, dict) and sorted(x) == sorted(y), i
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"call {i} {k}")
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"call {i}")


@pytest.mark.parametrize("case", [
    dict(),  # native loader, K=1, prefetch 2
    {"train.steps_per_call": 4},
    {"train.steps_per_call": 4, "data.use_native_loader": False, "data.prefetch_to_device": 0},
    {"train.steps_per_call": 3, "data.session_parallel": True, "model.loss": "bpr_max",
     "data.buckets": ()},
])
def test_fit_feeds_the_jax_fits_wire_groups(tiny_ds, tmp_path, case):
    """The same dataset and config: the port's fit hands its step the same
    sequence of wires and [K, B, W] groups (dtype, shape and bits) as the
    JAX fit hands its jitted steps, through each side's loader, packer,
    grouping and prefetcher."""
    settings = _settings(tmp_path, **case)
    jrec, trec = _Recorder(), _Recorder()
    jtr = jax_trainer.Trainer(_apply(JaxRunConfig(), settings), ds=tiny_ds,
                              mesh=_one_device_mesh())
    _capture_jax(jtr, jrec)
    jtr.fit()
    ttr = Trainer(_apply(RunConfig(), settings), _port_ds(tiny_ds), device="cpu")
    _capture_torch(ttr, trec)
    state, _ = ttr.fit()
    assert state.step == settings["train.num_steps"]
    want_engine = "native" if settings.get("data.use_native_loader", True) else "python"
    assert ttr.data_engine == want_engine
    assert len(trec.calls) > 1
    _same_calls(trec.calls, jrec.calls)
    steps = sum(len(x) if kind == "multi" else 1 for kind, x in trec.calls)
    assert steps == settings["train.num_steps"]


def test_fit_k8_trajectory_equals_k1_bit_for_bit(tiny_ds, tmp_path):
    """num_steps=20, K=8: two groups of 8 and four single steps; the final
    parameters and optimizer state equal the K=1 run's bit for bit."""
    ds = _port_ds(tiny_ds)
    ends = []
    for k in (1, 8):
        cfg = _apply(RunConfig(), _settings(tmp_path / str(k), **{
            "train.steps_per_call": k, "train.num_steps": 20, "model.dropout_rate": 0.2}))
        state, _ = Trainer(cfg, ds, device="cpu").fit()
        assert state.step == 20
        ends.append(state)
    a, b = ends
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        for kind in ("mu", "nu"):
            assert torch.equal(a.opt_state[kind][name], b.opt_state[kind][name]), (kind, name)


def test_fit_logs_evaluates_and_matches_evaluate(tiny_ds, tmp_path):
    settings = _settings(tmp_path, **{"train.eval_every": 6, "train.num_steps": 12,
                                      "train.steps_per_call": 2, "eval.batch_size": 16})
    tr = Trainer(_apply(RunConfig(), settings), _port_ds(tiny_ds), device="cpu")
    state, last_eval = tr.fit()
    assert last_eval == tr.evaluate(state, split="val")
    assert 0 < last_eval["count"] and all(np.isfinite(v) for v in last_eval.values())
    run = tmp_path / "run"
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    tags = [(r["tag"], r["step"]) for r in lines]
    assert tags[0] == ("data", 0) and lines[0]["engine"] == "native"
    assert [t for t in tags if t[0] == "train"] == [("train", 3), ("train", 7), ("train", 11)]
    assert [t for t in tags if t[0] == "eval/val"] == [("eval/val", 5), ("eval/val", 11)]
    for r in lines:
        if r["tag"] == "train":
            assert np.isfinite(r["loss"]) and r["examples_per_s"] > 0 and r["lr"] == 1e-3
    assert (run / "config.json").exists() and (run / "heartbeat_0").read_text().startswith("11 ")


def test_fit_takes_the_python_pipeline_when_the_engine_is_missing(tiny_ds, tmp_path,
                                                                   monkeypatch):
    """With no native engine the port falls back to the Python batcher, as
    the JAX package does, and says so: the same steps run."""
    monkeypatch.setattr(native, "available", lambda: False)
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path)), _port_ds(tiny_ds), device="cpu")
    state, _ = tr.fit()
    assert tr.data_engine == "python" and state.step == 13
    first = json.loads((tmp_path / "run" / "metrics.jsonl").read_text().splitlines()[0])
    assert first["engine"] == "python"


def test_fit_debug_nans_halts_and_fail_after_step_returns(tiny_ds, tmp_path):
    ds = _port_ds(tiny_ds)
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path, **{"train.debug_nans": True,
                                                            "train.steps_per_call": 4})),
                 ds, device="cpu")
    assert tr._steps_per_call() == 1
    real = tr.train_step
    seen = []

    def poisoned(state, batch):
        state, m = real(state, batch)
        seen.append(state.step)
        if state.step == 3:
            m = dict(m, nonfinite=torch.tensor(True))
        return state, m

    tr.train_step = poisoned
    with pytest.raises(FloatingPointError, match="step 2"):
        tr.fit()
    assert seen == [1, 2, 3]
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path / "f", **{
        "train.fail_after_step": 9, "train.steps_per_call": 4, "data.buckets": ()})),
        ds, device="cpu")
    state, _ = tr.fit()
    assert state.step == 12  # the group that crosses step 9 ends at 12


@pytest.mark.parametrize("setting,match", [
    ({"train.resume": True, "model.embed_dim": 24},
     r"/params/item_embedding \(\d+, 16\) float32 vs \(\d+, 24\) float32"),
])
def test_fit_raises_for_what_is_not_ported(tiny_ds, tmp_path, setting, match):
    """What fit refuses on resume, as the JAX package's orbax restore does:
    a checkpoint whose leaves' global shapes are not this run's (here a
    narrower model's), every such leaf named with both shapes, before any
    state is read. (A checkpoint of another mesh with this run's global
    shapes restores: tests/test_torch_reshard.py.)"""
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path, **{
        "train.num_steps": 4, "train.checkpoint_every": 4})), _port_ds(tiny_ds), device="cpu")
    tr.fit()
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path, **{
        "train.checkpoint_every": 4, **setting})), _port_ds(tiny_ds), device="cpu")
    with pytest.raises(ValueError, match=match):
        tr.fit()


@pytest.mark.parametrize("k,window,groups", [
    (4, (4, 8), ["[4,8)", "[8,12)"]),
    (4, (5, 50), ["[4,8)", "[8,12)", "[12,13)"]),  # stopped at the loop's end
    (1, (2, 3), ["[2,3)", "[3,4)"]),
])
def test_profile_dir_traces_the_window_of_groups(tiny_ds, tmp_path, k, window, groups):
    """train.profile_dir: the trace starts at the group holding
    profile_steps[0] and stops after the group holding profile_steps[1] (or
    at the loop's end), as the JAX fit's jax.profiler window; it holds those
    groups and no other, each under its label, the steps' work inside them."""
    tr = Trainer(_apply(RunConfig(), _settings(tmp_path, **{
        "train.steps_per_call": k, "data.buckets": (), "train.profile_steps": window,
        "train.profile_dir": str(tmp_path / "prof")})), _port_ds(tiny_ds), device="cpu")
    state, _ = tr.fit()
    assert state.step == 13
    hi = groups[-1].split(",")[1][:-1]
    assert tr.profile_trace == str(tmp_path / "prof" / f"trace_steps_{window[0] - window[0] % k}"
                                                       f"_{hi}.json")
    events = json.loads(Path(tr.profile_trace).read_text())
    names = [e["name"] for e in events["traceEvents"] if e.get("ph") == "X"]
    assert sorted({n for n in names if n.startswith("seqrec_group")}) == sorted(
        f"seqrec_group{g}" for g in groups)
    assert any(n.startswith("aten::") for n in names)  # the steps' ops are in the trace


def test_trainer_without_a_dataset_loads_cfg_data(tmp_path):
    cfg = _apply(RunConfig(), _settings(tmp_path, **{
        "data.dataset": "synthetic", "data.data_dir": str(tmp_path / "data"),
        "data.synthetic_num_users": 40, "data.synthetic_num_items": 30,
        "train.num_steps": 4}))
    tr = Trainer(cfg, device="cpu")
    assert tr.ds.num_users == 40 and tr.ds.vocab_size == 31
    assert (tmp_path / "data" / "synthetic" / "seqs.npz").exists()
    state, _ = tr.fit()
    assert state.step == 4
