"""The port's data pipeline against the JAX package's, array for array: the
raw-file parsers (on the fixtures of tests/unit/test_raw_parsers.py),
`from_interactions`, save/load, `prepare_dataset` and `load_dataset`, the
bucketed batcher and its fast-forward over seeds and host shards, the
session stream with its snapshots, and the native engine's two loaders
(the port builds its own copy of native/seqrec_data.cc; the JAX package
loads its own build). Every comparison is exact: both sides are numpy (or
the same C++ engine) on the same inputs."""

import itertools

import numpy as np
import pytest

from seqrec_tpu.config import DataConfig as JaxDataConfig
from seqrec_tpu.data import batching as jax_batching
from seqrec_tpu.data import dataset as jax_dataset
from seqrec_tpu.data import native as jax_native
from seqrec_tpu_torch.config import DataConfig
from seqrec_tpu_torch.data import batching, dataset, native


def _same_ds(a, b):
    np.testing.assert_array_equal(a.items, b.items)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert a.items.dtype == b.items.dtype and a.offsets.dtype == b.offsets.dtype
    assert (a.vocab_size, a.name, a.num_users) == (b.vocab_size, b.name, b.num_users)


def _same_batches(a, b, n):
    for i in range(n):
        (ba, xa), (bb, xb) = next(a), next(b)
        assert ba == bb, f"bucket at batch {i}"
        assert sorted(xa) == sorted(xb)
        for k in xa:
            assert xa[k].dtype == xb[k].dtype, k
            np.testing.assert_array_equal(xa[k], xb[k], err_msg=f"{k} at batch {i}")


@pytest.fixture(scope="module")
def ds():
    """Short histories, so that epochs are short and streams cross many."""
    return jax_dataset.synthetic_dataset(60, 50, seed=3, min_len=3, max_len=25)


@pytest.fixture(scope="module")
def tds_(ds):
    return dataset.SequenceDataset(items=ds.items.copy(), offsets=ds.offsets.copy(),
                                   vocab_size=ds.vocab_size, name=ds.name)


# ---------------------------------------------------------------------------
# Parsers, from_interactions, persistence
# ---------------------------------------------------------------------------

def _steam_rows():
    rows = ["{'username': %r, 'product_id': %r, 'date': '2015-01-%02d'}\n" % (u, g, i + 1)
            for u in ("u1", "u2", "u3", "u4", "u5")
            for i, g in enumerate(("g1", "g2", "g3", "g4", "g5"))]
    return "".join(rows) + "not a dict\n"


def _rsc15_rows():
    rows = []
    for s in (1, 2, 3, 4, 5):
        rows.append(f"{s},2014-04-07T10:5{s}:09.277Z,100,0\n")
        rows.append(f"{s},2014-04-07T11:5{s}:09.277Z,200,0\n")
    rows.append("3,2014-04-07T09:00:00.000Z,900,0\n")
    rows.append("6,2014-04-07T09:00:00.000Z,900,0\n")
    return "".join(rows)


# (raw file name, its text, parser name, extra parser args): the fixtures
# of tests/unit/test_raw_parsers.py.
FIXTURES = {
    "ml-100k": ("u.data", "1\t10\t5\t100\n1\t20\t4\t200\n1\t30\t3\t50\n2\t10\t2\t10\n"
                          "2\t20\t1\t20\n", "_parse_ml100k", ()),
    "ml-1m": ("ratings.dat", "1::101::5::978300760\n1::102::3::978302109\n"
                             "2::101::4::978301968\n2::103::4::978300275\njunk line\n",
              "_parse_ml1m", ()),
    "beauty": ("ratings_Beauty.csv",
               "".join(f"{u},{item},5.0,{1000 + i}\n" for u in ("A1", "A2", "A3", "A4", "A5")
                       for i, item in enumerate(("B1", "B2", "B3", "B4", "B5"))),
               "_parse_amazon_csv", ("beauty",)),
    "steam": ("steam_reviews.json", _steam_rows(), "_parse_steam", ()),
    "rsc15": ("yoochoose-clicks.dat", _rsc15_rows(), "_parse_rsc15", ()),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_raw_parsers_match_jax(tmp_path, name):
    fname, text, parser, extra = FIXTURES[name]
    p = tmp_path / fname
    p.write_text(text)
    got = getattr(dataset, parser)(str(p), *extra)
    _same_ds(got, getattr(jax_dataset, parser)(str(p), *extra))
    assert got.num_users > 0


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_prepare_dataset_matches_jax_and_persists(tmp_path, name):
    fname, text, _, _ = FIXTURES[name]
    for side in ("port", "jax"):
        raw = tmp_path / side / name
        raw.mkdir(parents=True)
        (raw / fname).write_text(text)
    got = dataset.prepare_dataset(name, str(tmp_path / "port"))
    _same_ds(got, jax_dataset.prepare_dataset(name, str(tmp_path / "jax")))
    for f in ("seqs.npz", "vocab.json"):
        assert (tmp_path / "port" / name / f).exists()
    # Each side reads the other's files.
    _same_ds(dataset.SequenceDataset.load(str(tmp_path / "jax" / name)), got)
    _same_ds(jax_dataset.SequenceDataset.load(str(tmp_path / "port" / name)), got)


def test_prepare_dataset_missing_raw_and_unknown_name(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        dataset.prepare_dataset("steam", str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset"):
        dataset.prepare_dataset("nope", str(tmp_path))


@pytest.mark.parametrize("seed,min_item_count,min_seq_len", [(0, 1, 2), (1, 3, 2), (2, 2, 4)])
def test_from_interactions_matches_jax(seed, min_item_count, min_seq_len):
    """Random (user, item, ts) triples with repeated timestamps (file order
    breaks ties), string users, k-core filtering."""
    rng = np.random.default_rng(seed)
    n = 400
    users = np.array([f"u{u}" for u in rng.integers(0, 40, size=n)])
    items = rng.zipf(1.3, size=n) % 60
    ts = rng.integers(0, 30, size=n)
    kw = dict(min_seq_len=min_seq_len, min_item_count=min_item_count, name="x")
    _same_ds(dataset.from_interactions(users, items, ts, **kw),
             jax_dataset.from_interactions(users, items, ts, **kw))


def test_synthetic_load_dataset_and_eval_examples_match_jax(tmp_path):
    kw = dict(dataset="synthetic", data_dir=str(tmp_path), synthetic_num_users=50,
              synthetic_num_items=80, synthetic_min_len=2, synthetic_max_len=20, seed=4)
    got = dataset.load_dataset(DataConfig(**kw))
    want = jax_dataset.load_dataset(JaxDataConfig(**kw))  # reads the port's files
    _same_ds(got, want)
    _same_ds(dataset.load_dataset(DataConfig(**kw)), got)  # and the port reads them back
    for u in range(got.num_users):
        np.testing.assert_array_equal(got.train_seq(u), want.train_seq(u))
        for split in ("val", "test"):
            a, b = got.eval_example(u, split), want.eval_example(u, split)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a["history"], b["history"])
                assert a["target"] == b["target"]
    with pytest.raises(ValueError, match="split"):
        got.eval_example(int(np.argmax(np.diff(got.offsets))), "train")


# ---------------------------------------------------------------------------
# Bucketed batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("host_shard", [(0, 1), (1, 2)])
@pytest.mark.parametrize("buckets", [(), (8, 16)])
def test_make_train_batches_matches_jax(ds, tds_, seed, host_shard, buckets):
    kw = dict(batch_size=4, max_len=20, buckets=buckets, seed=seed, host_shard=host_shard)
    _same_batches(batching.make_train_batches(tds_, **kw),
                  jax_batching.make_train_batches(ds, **kw), 40)


def test_make_train_batches_finite_epochs_and_flush_match_jax(ds, tds_):
    kw = dict(batch_size=8, max_len=20, buckets=(5, 10), seed=2, num_epochs=2)
    got = list(batching.make_train_batches(tds_, **kw))
    want = list(jax_batching.make_train_batches(ds, **kw))
    assert len(got) == len(want)
    _same_batches(iter(got), iter(want), len(got))


@pytest.mark.parametrize("skip", [0, 1, 7, 33, 130])
@pytest.mark.parametrize("host_shard", [(0, 1), (1, 2)])
def test_fast_forward_matches_jax_and_replay(ds, tds_, skip, host_shard):
    kw = dict(batch_size=4, max_len=20, buckets=(8, 16), seed=5, host_shard=host_shard)
    rng, order, idx, pending = batching.fast_forward_train_batches(tds_, skip_batches=skip, **kw)
    j_rng, j_order, j_idx, j_pending = jax_batching.fast_forward_train_batches(
        ds, skip_batches=skip, **kw)
    np.testing.assert_array_equal(order, j_order)
    assert idx == j_idx and pending == j_pending
    assert rng.bit_generator.state == j_rng.bit_generator.state
    ref = batching.make_train_batches(tds_, **kw)
    for _ in range(skip):
        next(ref)
    got = batching.make_train_batches(tds_, **kw, skip_batches=skip)
    _same_batches(got, jax_batching.make_train_batches(ds, **kw, skip_batches=skip), 20)
    _same_batches(batching.make_train_batches(tds_, **kw, skip_batches=skip), ref, 20)


def test_bucket_batcher_and_pick_bucket_match_jax():
    for length in range(0, 30):
        assert batching._pick_bucket(length, (5, 10, 20)) == \
            jax_batching._pick_bucket(length, (5, 10, 20))
    a = batching.BucketBatcher(3, 12, (4, 8, 30))
    b = jax_batching.BucketBatcher(3, 12, (4, 8, 30))
    assert a.buckets == b.buckets == (4, 8, 12)
    rng = np.random.default_rng(0)
    for u in range(40):
        seq = rng.integers(1, 50, size=int(rng.integers(0, 20)))
        oa, ob = a.add(seq, user=u), b.add(seq, user=u)
        assert (oa is None) == (ob is None)
        if oa is not None:
            _same_batches(iter([oa]), iter([ob]), 1)
    fa, fb = list(a.flush()), list(b.flush())
    _same_batches(iter(fa), iter(fb), len(fb))


# ---------------------------------------------------------------------------
# Session-parallel stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_shard", [(0, 1), (1, 3)])
def test_session_stream_matches_jax_and_restores(ds, tds_, host_shard):
    kw = dict(batch_size=5, window=7, seed=9, host_shard=host_shard, snapshot_depth=4)
    got = batching.make_session_stream(tds_, **kw)
    want = jax_batching.make_session_stream(ds, **kw)
    _same_batches(got, want, 30)
    snap = got.state_at(27)
    assert snap == want.state_at(27)
    with pytest.raises(KeyError):
        got.state_at(20)  # past the ring of 4
    again = batching.make_session_stream(tds_, **kw)
    again.restore(snap)
    want.restore(snap)
    _same_batches(again, want, 10)


# ---------------------------------------------------------------------------
# The native engine (the port's own build of native/seqrec_data.cc)
# ---------------------------------------------------------------------------

def test_native_engine_is_built_into_the_port():
    assert native.available(), native.build_error()
    path = native.lib_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "seqrec_tpu_torch"


@pytest.mark.parametrize("seed,buckets,host_shard,skip", [
    (0, (), (0, 1), 0), (1, (5, 10), (0, 1), 0), (2, (8, 16), (1, 2), 0),
    (3, (8, 16), (0, 1), 37)])
def test_native_train_loader_matches_jax(ds, tds_, seed, buckets, host_shard, skip):
    kw = dict(batch_size=4, max_len=20, buckets=buckets, seed=seed, host_shard=host_shard,
              skip_batches=skip)
    a = native.NativeTrainLoader(tds_, **kw)
    b = jax_native.NativeTrainLoader(ds, **kw)
    try:
        _same_batches(a, b, 40)
    finally:
        a.close()
        b.close()


def test_native_and_python_batches_are_real_training_windows(tds_):
    """The two engines shuffle with their own generators; both emit only
    rows that are the most recent window of a user's training split, in
    the bucket that row picks, with the mask on exactly its transitions."""
    windows = {}
    for u in range(tds_.num_users):
        s = tds_.train_seq(u)[-21:]
        if len(s) >= 2:
            windows[u + 1] = tuple(s.tolist())
    loader = native.NativeTrainLoader(tds_, batch_size=4, max_len=20, buckets=(5, 10), seed=1)
    try:
        for engine in (loader, batching.make_train_batches(tds_, batch_size=4, max_len=20,
                                                           buckets=(5, 10), seed=1)):
            for bucket, batch in itertools.islice(engine, 30):
                lens = batch["mask"].sum(1).astype(int)
                for r in range(4):
                    L = lens[r]
                    if L == 0:
                        continue
                    row = tuple(batch["inputs"][r, :L].tolist()) + (int(batch["targets"][r, L - 1]),)
                    assert row == windows[int(batch["users"][r])]
                    assert batching._pick_bucket(L, (5, 10, 20)) == bucket
                    assert not batch["mask"][r, L:].any()
    finally:
        loader.close()


class _Wire:
    """The session wire's column layout for a window of T (the trainer's)."""

    def __init__(self, T):
        self.T, self.E, self.W = T, T // 2 + 1, (T + 7) // 8


def test_native_session_loader_matches_jax_and_restores(ds, tds_):
    w = _Wire(12)
    kw = dict(batch_size=4, window=w.T, ends_budget=w.E, wire_dtype=np.int16, seed=3,
              host_shard=(0, 1), snapshot_depth=6)
    a = native.NativeSessionLoader(tds_, **kw)
    b = jax_native.NativeSessionLoader(ds, **kw)
    try:
        for _ in range(25):
            (ta, pa), (tb, pb) = next(a), next(b)
            assert ta == tb and type(pa) is type(pb)
            if isinstance(pa, dict):
                _same_batches(iter([(ta, pa)]), iter([(tb, pb)]), 1)
            else:
                assert pa.dtype == pb.dtype == np.int16
                np.testing.assert_array_equal(pa, pb)
        snap = a.state_at(22)
        assert snap == b.state_at(22) and snap["engine"] == "native"
        a.restore(snap)
        b.restore(snap)
        for _ in range(8):
            np.testing.assert_array_equal(np.asarray(next(a)[1]), np.asarray(next(b)[1]))
        # The live head, not pulled yet: peeked, then served by __next__.
        n = a._count
        assert a.state_at(n)["count"] == n == b.state_at(n)["count"]
        np.testing.assert_array_equal(np.asarray(next(a)[1]), np.asarray(next(b)[1]))
    finally:
        a.close()
        b.close()
