"""The port's SeqRecModel and recommend vs the JAX package, with the JAX
model's own initialized parameters carried across by models/convert.py.

f32 compute for the tight checks (1e-5: same math, different summation
order); bf16 within 5e-2 on scores, which are dot products of 16-wide bf16
vectors rounded to bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.eval.infer import recommend as jax_recommend
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.models.model import SeqRecModel as JaxSeqRecModel
from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.eval import infer
from seqrec_tpu_torch.models import SeqRecModel, build_model
from seqrec_tpu_torch.models.convert import (
    flax_to_state_dict,
    load_npz,
    random_params,
    save_npz,
)

VOCAB, USERS, T = 30, 6, 8
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(B=4, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 5, 1, 0, 3, 7][:B])
    inputs = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.float32)
    for r, n in enumerate(lengths):
        inputs[r, :n] = rng.integers(1, VOCAB, size=n)
        mask[r, :n] = 1.0
    users = rng.integers(0, USERS + 1, size=B).astype(np.int32)
    return inputs, mask, users


def _jax_params(model, inputs, mask, users, seed=0):
    """JAX init, with biases made nonzero so every bias path is exercised."""
    params = model.init(jax.random.key(seed), jnp.asarray(inputs),
                        jnp.asarray(mask), users=jnp.asarray(users))
    params = jax.tree_util.tree_map(lambda a: np.array(a), params)
    rng = np.random.default_rng(seed + 1)
    p = params["params"]
    for name in list(p["tower"]):
        if name.endswith(("_bx", "_bh")):
            p["tower"][name] = (rng.normal(size=p["tower"][name].shape) * 0.1).astype(np.float32)
    if "output_bias" in p:
        p["output_bias"] = rng.normal(size=p["output_bias"].shape).astype(np.float32)
    return params


CONFIGS = {
    "tied_full_softmax_bias": dict(loss="full_softmax"),
    "tied_sampled_no_bias": dict(loss="sampled_softmax"),
    "untied": dict(loss="full_softmax", tie_embeddings=False),
    "user_table": dict(loss="sampled_softmax", use_user_embedding=True),
    "two_layers_residual": dict(loss="full_softmax", num_layers=2, residual=True),
}


def _pair(compute_dtype="float32", **kw):
    common = dict(arch="gru4rec", embed_dim=16, dropout_rate=0.0,
                  compute_dtype=compute_dtype, **kw)
    num_users = USERS if kw.get("use_user_embedding") else 0
    jm = jax_build_model(JaxModelConfig(**common), VOCAB, num_users=num_users)
    inputs, mask, users = _batch()
    params = _jax_params(jm, inputs, mask, users)
    tm = build_model(ModelConfig(**common), VOCAB, num_users=num_users, device="cpu")
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_last_hidden_and_scores_match_jax(name):
    jm, params, tm = _pair(**CONFIGS[name])
    inputs, mask, users = _batch()
    j_args = (jnp.asarray(inputs), jnp.asarray(mask))
    cands = np.random.default_rng(4).integers(0, VOCAB, size=(4, 5)).astype(np.int32)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm.last_hidden(_t(inputs), _t(mask), users=_t(users)).numpy(),
            np.asarray(jm.apply(params, *j_args, users=jnp.asarray(users),
                                method=jm.last_hidden)), **F32_TOL)
        full = tm.scores(_t(inputs), _t(mask), users=_t(users))
        assert full.dtype == torch.float32 and tuple(full.shape) == (4, VOCAB)
        np.testing.assert_allclose(
            full.numpy(),
            np.asarray(jm.apply(params, *j_args, users=jnp.asarray(users),
                                method=jm.scores)), **F32_TOL)
        np.testing.assert_allclose(
            tm.scores(_t(inputs), _t(mask), users=_t(users),
                      candidates=_t(cands)).numpy(),
            np.asarray(jm.apply(params, *j_args, users=jnp.asarray(users),
                                candidates=jnp.asarray(cands), method=jm.scores)),
            **F32_TOL)


def test_empty_history_reads_position_zero():
    jm, params, tm = _pair(loss="full_softmax")
    inputs, mask, users = _batch()
    assert mask[3].sum() == 0
    with torch.no_grad():
        h = tm.encode(_t(inputs), _t(mask))
        last = tm.last_hidden(_t(inputs), _t(mask))
    np.testing.assert_array_equal(last[3].numpy(), h[3, 0].numpy())
    np.testing.assert_array_equal(last[0].numpy(), h[0, T - 1].numpy())


def test_bf16_scores_match_jax_within_bf16_tolerance():
    jm, params, tm = _pair(compute_dtype="bfloat16", loss="full_softmax")
    inputs, mask, users = _batch()
    with torch.no_grad():
        got = tm.scores(_t(inputs), _t(mask)).numpy()
    want = np.asarray(jm.apply(params, jnp.asarray(inputs), jnp.asarray(mask),
                               method=jm.scores))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_padded_vocab_columns_score_minus_1e30():
    common = dict(vocab_size=20, table_size=24, embed_dim=16, hidden=16,
                  dropout_rate=0.0)
    jm = JaxSeqRecModel(compute_dtype=jnp.float32, use_pallas=False, **common)
    inputs, mask, _ = _batch()
    inputs = np.minimum(inputs, 19)
    params = _jax_params(jm, inputs, mask, np.zeros(4, np.int32))
    tm = SeqRecModel(20, table_size=24, embed_dim=16, hidden=16,
                     compute_dtype=torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tm.scores(_t(inputs), _t(mask)).numpy()
    want = np.asarray(jm.apply(params, jnp.asarray(inputs), jnp.asarray(mask),
                               method=jm.scores))
    assert (got[:, 20:] == -1e30).all()
    np.testing.assert_allclose(got, want, **F32_TOL)


def _histories(n=11, seed=5):
    rng = np.random.default_rng(seed)
    hist = []
    for i in range(n):
        length = [0, 1, 3, T, T + 4][i % 5]  # empty, short, full, truncated
        hist.append({"user": i, "history": rng.integers(1, VOCAB, size=length).tolist()})
    return hist


@pytest.mark.parametrize("exclude", [True, False])
def test_recommend_matches_jax(exclude):
    """Same items, order and exclusion across three batches, the last one
    padded; scores within f32 tolerance."""
    jm, params, tm = _pair(loss="full_softmax")
    hist = _histories()
    want = list(jax_recommend(jm, params, hist, k=5, batch_size=4, max_len=T,
                              exclude_history=exclude))
    got = list(infer.recommend(tm, hist, k=5, batch_size=4, max_len=T,
                               exclude_history=exclude))
    assert [g["user"] for g in got] == list(range(len(hist)))
    for g, w, h in zip(got, want, hist):
        assert g["items"] == w["items"]
        np.testing.assert_allclose(g["scores"], w["scores"], **F32_TOL)
        assert len(g["items"]) == 5 and 0 not in g["items"]
        if exclude:
            assert not set(g["items"]) & set(h["history"])


def test_pack_matches_jax():
    from seqrec_tpu.eval.infer import _pack as jax_pack

    hist = [h["history"] for h in _histories(4)]
    for a, b in zip(infer._pack(hist, [1, 2, 3, 4], 6, T),
                    jax_pack(hist, [1, 2, 3, 4], 6, T)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_recommend_refuses_catalogs_that_need_chunked_topk(monkeypatch):
    _, _, tm = _pair(loss="full_softmax")
    monkeypatch.setattr(infer, "CHUNK_THRESHOLD_BYTES", 4 * 4 * VOCAB - 1)
    with pytest.raises(NotImplementedError, match="chunked top-k"):
        list(infer.recommend(tm, _histories(2), batch_size=4, max_len=T))


def test_training_and_unported_towers_raise():
    """`loss` is ported; session-parallel `loss_stream` and the LSTM and
    SASRec towers still raise, naming their ROADMAP item."""
    _, _, tm = _pair(loss="full_softmax")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        tm.loss_stream({}, None)
    for arch, cell in (("gru4rec", "lstm"), ("sasrec", "gru")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_model(ModelConfig(arch=arch, cell_type=cell), VOCAB, device="cpu")


def test_npz_round_trip_and_random_params(tmp_path):
    _, params, tm = _pair(loss="full_softmax", tie_embeddings=False,
                          use_user_embedding=True)
    path = str(tmp_path / "params.npz")
    save_npz(path, params)
    with np.load(path) as f:
        assert "params/tower/gru0_wx" in f.files
    back = load_npz(path)
    sd = flax_to_state_dict(back)
    for key, val in flax_to_state_dict(params).items():
        np.testing.assert_array_equal(sd[key].numpy(), val.numpy())
    np.testing.assert_array_equal(back["params"]["item_embedding"],
                                  params["params"]["item_embedding"])

    fresh = random_params(tm, seed=3)
    tm.load_state_dict(flax_to_state_dict(fresh))  # strict: every key, every shape
    again = random_params(tm, seed=3)["params"]
    np.testing.assert_array_equal(fresh["params"]["tower"]["gru0_wh"],
                                  again["tower"]["gru0_wh"])
    w_h = fresh["params"]["tower"]["gru0_wh"]  # [H, 3H], orthonormal rows
    np.testing.assert_allclose(w_h @ w_h.T, np.eye(16), atol=1e-5)
    w_x = fresh["params"]["tower"]["gru0_wx"]
    assert np.abs(w_x).max() <= np.sqrt(6.0 / (16 + 48))
    assert not fresh["params"]["tower"]["gru0_bx"].any()


def test_mask_scores_matches_jax():
    from seqrec_tpu.eval.metrics import mask_scores as jax_mask_scores
    from seqrec_tpu_torch.eval.metrics import NEG_INF, mask_scores

    rng = np.random.default_rng(6)
    scores = rng.normal(size=(3, 12)).astype(np.float32)
    exclude = np.array([[1, 5, 0], [0, 0, 0], [11, 2, 2]], np.int32)  # pads, repeats
    for ex in (None, exclude):
        want = jax_mask_scores(jnp.asarray(scores),
                               exclude=None if ex is None else jnp.asarray(ex))
        got = mask_scores(_t(scores), exclude=None if ex is None else _t(ex))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == NEG_INF).all() and got[0, 3] == scores[0, 3]


def test_tower_carry_and_reset_match_jax():
    """RNNTower's session-parallel form: a carry from zero_carry (or a
    previous window) and a reset plane, through the plain GRU path."""
    from seqrec_tpu.models.towers import RNNTower as JaxRNNTower
    from seqrec_tpu.models.towers import zero_carry as jax_zero_carry
    from seqrec_tpu_torch.models.towers import RNNTower, zero_carry

    B, D, L = 3, 8, 2
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    reset = rng.integers(0, 2, size=(B, T)).astype(np.float32)
    jt = JaxRNNTower(hidden=D, num_layers=L, residual=True, use_pallas=False)
    carry0 = jax_zero_carry("gru", L, B, D)
    params = jt.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(mask),
                     carry=carry0, reset=jnp.asarray(reset))
    params = jax.tree_util.tree_map(np.asarray, params)
    tt = RNNTower(D, D, L, residual=True)
    tt.load_state_dict(flax_to_state_dict(params))
    carry = tuple(np.asarray(c) + 0.1 * (i + 1) for i, c in enumerate(carry0))
    want_h, want_c = jt.apply(params, jnp.asarray(x), jnp.asarray(mask),
                              carry=tuple(jnp.asarray(c) for c in carry),
                              reset=jnp.asarray(reset))
    with torch.no_grad():
        assert all(torch.equal(c, torch.zeros(B, D)) for c in zero_carry("gru", L, B, D))
        got_h, got_c = tt(_t(x), _t(mask), carry=tuple(_t(c) for c in carry),
                          reset=_t(reset))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **F32_TOL)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
