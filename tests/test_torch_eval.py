"""The port's eval against the JAX package's: the metrics, the chunked ranks
and top-k, the eval batches and the candidate sampler bit for bit on the
same inputs, and `evaluate` (full and sampled protocols, exclude-history,
the chunked path) on the JAX model's own parameters carried across.

The chunked functions are compared on tables and queries of small integers
in f32: every score is then an exact sum, the same bits in any order, so
ranks and top-k (ties included) must be equal. `evaluate` in f32 is within
1e-5 of the JAX harness: the same scores up to the summation order of the
tower and the score products, so a rank can move only at a tie closer than
that, which the seeds here do not have."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import EvalConfig as JaxEvalConfig
from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.data import batching as jax_batching
from seqrec_tpu.data.dataset import synthetic_dataset
from seqrec_tpu.eval import chunked as jax_chunked
from seqrec_tpu.eval import harness as jax_harness
from seqrec_tpu.eval import metrics as jax_metrics
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu_torch.config import EvalConfig, ModelConfig
from seqrec_tpu_torch.data import batching
from seqrec_tpu_torch.data.dataset import SequenceDataset
from seqrec_tpu_torch.eval import chunked, harness, metrics
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict
from test_torch_model import _jax_params

KS = (1, 5, 10)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _scores(seed, B=9, C=40):
    """Scores with ties (a grid of quarters), a NaN target row and a NaN in
    another row's candidates."""
    rng = np.random.default_rng(seed)
    s = (rng.integers(-8, 8, size=(B, C)) / 4).astype(np.float32)
    target = rng.integers(0, C, size=B).astype(np.int32)
    s[0, target[0]] = np.nan
    s[1, (target[1] + 1) % C] = np.nan
    return s, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_and_metrics_match_jax_bit_for_bit(seed):
    s, target = _scores(seed)
    ranks = metrics.ranks_from_scores(_t(s), _t(target))
    want = jax_metrics.ranks_from_scores(jnp.asarray(s), jnp.asarray(target))
    assert ranks.dtype == torch.int32
    np.testing.assert_array_equal(_np(ranks), np.asarray(want))
    assert int(ranks[0]) == s.shape[1]  # the NaN target ranks last
    valid = (np.arange(len(target)) % 4 != 3).astype(np.float32)
    got = metrics.rank_metrics(ranks, _t(valid), KS)
    exp = jax_metrics.rank_metrics(want, jnp.asarray(valid), KS)
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert got[k].dtype == torch.float32
        assert _np(got[k]).tobytes() == np.asarray(exp[k]).tobytes(), k
    sums = {k: np.float64(_np(v)) for k, v in got.items()}
    assert metrics.finalize_metrics(sums) == jax_metrics.finalize_metrics(
        {k: np.float64(np.asarray(v)) for k, v in exp.items()})
    assert metrics.finalize_metrics({"count": 0.0, "recall@5": 0.0}) == {
        "recall@5": 0.0, "count": 0.0}


def test_first_occurrence_and_mask_scores_match_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 6, size=(5, 9)).astype(np.int32)
    np.testing.assert_array_equal(_np(metrics.first_occurrence_2d(_t(x))),
                                  np.asarray(jax_metrics.first_occurrence_2d(jnp.asarray(x))))
    s = rng.normal(size=(5, 12)).astype(np.float32)
    got = metrics.mask_scores(_t(s), exclude=_t(x))
    want = jax_metrics.mask_scores(jnp.asarray(s), exclude=jnp.asarray(x))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _integer_case(seed, V=53, D=6, B=7, T=5):
    """f32 table, queries and bias of small integers (exact scores), with
    ties; targets include the pad id and a padded-vocab row."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-3, 4, size=(V, D)).astype(np.float32)
    h = rng.integers(-3, 4, size=(B, D)).astype(np.float32)
    bias = rng.integers(-2, 3, size=V).astype(np.float32)
    targets = rng.integers(1, V - 3, size=B).astype(np.int32)
    targets[-1] = 0
    exclude = rng.integers(0, V, size=(B, T)).astype(np.int32)
    exclude[0, :2] = targets[0]  # the target and a repeat in the history
    exclude[1, :3] = exclude[1, 3]
    return table, h, bias, targets, exclude


@pytest.mark.parametrize("chunk", [53, 16, 7, 1000])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_exclude", [False, True])
def test_chunked_ranks_match_jax_and_the_dense_ranks(chunk, with_bias, with_exclude):
    table, h, bias, targets, exclude = _integer_case(chunk)
    kw = dict(num_valid=50, chunk=chunk)
    got = chunked.chunked_ranks(_t(table), _t(h), _t(targets),
                                bias=_t(bias) if with_bias else None,
                                exclude=_t(exclude) if with_exclude else None,
                                compute_dtype=torch.float32, **kw)
    want = jax_chunked.chunked_ranks(jnp.asarray(table), jnp.asarray(h), jnp.asarray(targets),
                                     bias=jnp.asarray(bias) if with_bias else None,
                                     exclude=jnp.asarray(exclude) if with_exclude else None,
                                     compute_dtype=jnp.float32, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # The dense ranks on the same scores (padded-vocab columns and the pad
    # column out, the history excluded but never the target).
    s = h @ table.T + (bias if with_bias else 0)
    s[:, 50:] = metrics.NEG_INF
    excl = None
    if with_exclude:
        excl = _t(np.where(exclude == targets[:, None], 0, exclude))
    dense = metrics.ranks_from_scores(metrics.mask_scores(_t(s), exclude=excl), _t(targets))
    # Not the last row: its target is the pad id, whose dense score is masked
    # (no eval target is the pad; the chunked ranks score it as any id).
    np.testing.assert_array_equal(_np(got)[:-1], _np(dense)[:-1])


@pytest.mark.parametrize("chunk,k", [(53, 5), (16, 5), (7, 3), (4, 10)])
def test_chunked_topk_matches_jax_ties_to_the_lowest_id(chunk, k):
    table, h, bias, _, _ = _integer_case(chunk + k)
    vals, ids = chunked.chunked_topk(_t(table), _t(h), k, bias=_t(bias), num_valid=50,
                                     compute_dtype=torch.float32, chunk=chunk)
    wv, wi = jax_chunked.chunked_topk(jnp.asarray(table), jnp.asarray(h), k,
                                      bias=jnp.asarray(bias), num_valid=50,
                                      compute_dtype=jnp.float32, chunk=chunk)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(_np(vals), np.asarray(wv))
    np.testing.assert_array_equal(_np(ids), np.asarray(wi))
    # A stable descending sort of the dense masked scores gives the same.
    s = _t(h @ table.T + bias)
    s[:, 50:] = float("-inf")
    s[:, 0] = float("-inf")
    dv, di = torch.sort(s, dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(_np(ids), _np(di[:, :k]))


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(45, 29, seed=5, min_len=2, max_len=14)


def _port(ds):
    return SequenceDataset(items=ds.items.copy(), offsets=ds.offsets.copy(),
                           vocab_size=ds.vocab_size, name=ds.name)


@pytest.mark.parametrize("split", ["val", "test"])
@pytest.mark.parametrize("max_batches", [None, 2])
def test_eval_batches_and_padding_match_jax(ds, split, max_batches):
    kw = dict(split=split, batch_size=8, max_len=6, max_batches=max_batches)
    got = list(batching.make_eval_batches(_port(ds), **kw))
    want = list(jax_batching.make_eval_batches(ds, **kw))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        a, b = batching.pad_batch_rows(a, 8), jax_batching.pad_batch_rows(b, 8)
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("N,vocab", [(5, 29), (20, 60)])
def test_eval_candidates_match_jax(N, vocab):
    rng = np.random.default_rng(N)
    inputs = rng.integers(0, vocab, size=(7, 9)).astype(np.int32)
    targets = rng.integers(1, vocab, size=7).astype(np.int32)
    got = harness.sample_eval_candidates_batch(inputs, targets, N, vocab,
                                               np.random.default_rng(4))
    want = jax_harness.sample_eval_candidates_batch(inputs, targets, N, vocab,
                                                    np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    for r in range(7):
        assert got[r, 0] == targets[r]
        assert not set(got[r, 1:]) & (set(inputs[r]) | {0, int(targets[r])})
        assert len(set(got[r, 1:])) == N
        np.testing.assert_array_equal(
            harness.sample_eval_candidates(inputs[r], int(targets[r]), N, vocab,
                                           np.random.default_rng(r)),
            jax_harness.sample_eval_candidates(inputs[r], int(targets[r]), N, vocab,
                                               np.random.default_rng(r)))


EVALS = {
    "full": dict(protocol="full"),
    "full_exclude_history": dict(protocol="full", exclude_history=True),
    "full_chunked": dict(protocol="full", full_chunk_items=11, exclude_history=True),
    "sampled": dict(protocol="sampled", num_negatives=12),
}


@pytest.mark.parametrize("name", sorted(EVALS))
@pytest.mark.parametrize("loss", ["full_softmax", "sampled_softmax"])
def test_evaluate_matches_jax(ds, name, loss):
    """The JAX model's parameters (biases made nonzero) in both harnesses,
    f32: every metric within 1e-5 and the same count."""
    common = dict(arch="gru4rec", embed_dim=16, dropout_rate=0.0, compute_dtype="float32",
                  loss=loss, max_len=10)
    jm = jax_build_model(JaxModelConfig(**common), ds.vocab_size)
    inputs = np.ones((2, 10), np.int32)
    params = _jax_params(jm, inputs, np.ones((2, 10), np.float32), np.zeros(2, np.int32))
    tm = build_model(ModelConfig(**common), ds.vocab_size, device="cpu")
    state = flax_to_state_dict(params)
    ecfg = dict(batch_size=16, ks=KS, seed=3, **EVALS[name])
    got = harness.evaluate(tm, state, _port(ds), EvalConfig(**ecfg), split="test", max_len=10)
    want = jax_harness.evaluate(jm, params, ds, JaxEvalConfig(**ecfg), split="test",
                                max_len=10)
    assert sorted(got) == sorted(want) and got["count"] == want["count"] > 0
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-5, (k, got[k], want[k])


def test_evaluate_switches_to_chunks_past_the_threshold(ds, monkeypatch):
    """Past CHUNK_THRESHOLD_BYTES the full protocol ranks in blocks, with
    the dense path's metrics."""
    common = dict(arch="gru4rec", embed_dim=16, dropout_rate=0.0, compute_dtype="float32",
                  loss="full_softmax", max_len=10)
    tm = build_model(ModelConfig(**common), ds.vocab_size, device="cpu")
    jm = jax_build_model(JaxModelConfig(**common), ds.vocab_size)
    params = _jax_params(jm, np.ones((2, 10), np.int32), np.ones((2, 10), np.float32),
                         np.zeros(2, np.int32))
    state = flax_to_state_dict(params)
    ecfg = EvalConfig(batch_size=16, ks=KS)
    dense = harness.evaluate(tm, state, _port(ds), ecfg, max_len=10)
    calls = []
    real = chunked.chunked_ranks
    monkeypatch.setattr(chunked, "chunked_ranks", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(chunked, "CHUNK_THRESHOLD_BYTES", 4 * 16 * ds.vocab_size - 1)
    assert harness.evaluate(tm, state, _port(ds), ecfg, max_len=10) == dense
    assert calls
    with pytest.raises(ValueError, match="protocol"):
        harness.evaluate(tm, state, _port(ds), EvalConfig(protocol="nope"), max_len=10)
