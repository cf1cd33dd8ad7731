"""Session-parallel TBPTT training, the port against the JAX package on
identical numpy inputs: the synthetic dataset, the session stream and its
snapshots, the session wire format, `loss_stream` with its carry and every
gradient, a three-window trainer trajectory, and K grouped steps against K
single ones.

Tolerances, each with its reason:
- data, windows, wires: bit for bit (the same numpy code);
- f32 1e-5 (rtol and atol): same formulas, another summation order;
- bf16, as tests/test_torch_train.py: 3e-2 on values, 5e-2 on weight
  gradients (sums over B*T bf16 terms), 0.5 absolute on a loss summed over
  the window's 72 outputs: the port's CPU scans round every gate op to bf16,
  XLA's scan fuses and rounds elsewhere;
- trajectories 1e-5 relative on metrics and 2e-5 on parameters (Adam
  divides by sqrt(nu): last-bit differences show at ~1e-6 of lr).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.config import TrainConfig as JaxTrainConfig
from seqrec_tpu.data import batching as jax_batching
from seqrec_tpu.data import dataset as jax_dataset
from seqrec_tpu.data import negative as jax_negative
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.models.towers import zero_carry as jax_zero_carry
from seqrec_tpu.train import state as jax_state
from seqrec_tpu.train.trainer import Trainer as JaxTrainer
from seqrec_tpu_torch.config import ModelConfig, RunConfig
from seqrec_tpu_torch.data import batching, dataset
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm
from seqrec_tpu_torch.train.trainer import Trainer

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BF16_GRAD_TOL = dict(rtol=5e-2, atol=5e-2)
B, T, H, S = 6, 12, 16, 9
N_ITEMS = 59
VOCAB = N_ITEMS + 1
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _datasets(seed=0, users=40):
    kw = dict(seed=seed, min_len=2, max_len=12)
    return (dataset.synthetic_dataset(users, N_ITEMS, **kw),
            jax_dataset.synthetic_dataset(users, N_ITEMS, **kw))


def _windows(n, seed=0, window=T):
    ds, _ = _datasets(seed)
    stream = batching.make_session_stream(ds, batch_size=B, window=window, seed=seed)
    return [next(stream)[1] for _ in range(n)]


# ---------------------------------------------------------------------------
# Data: the synthetic dataset and the session stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("users,items,lo,hi,seed", [(200, 59, 2, 12, 0),
                                                    (60, 3417, 5, 200, 3)])
def test_synthetic_dataset_matches_jax(users, items, lo, hi, seed):
    got = dataset.synthetic_dataset(users, items, seed=seed, min_len=lo, max_len=hi)
    want = jax_dataset.synthetic_dataset(users, items, seed=seed, min_len=lo, max_len=hi)
    assert got.items.dtype == want.items.dtype and got.offsets.dtype == want.offsets.dtype
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert (got.vocab_size, got.num_users, got.name) == (want.vocab_size, want.num_users,
                                                         want.name)
    for u in (0, users // 2, users - 1):
        np.testing.assert_array_equal(got.train_seq(u), want.train_seq(u))


@pytest.mark.parametrize("seed", [0, 1])
def test_session_stream_windows_match_jax_across_epochs_and_restore(seed):
    """Bit-equal windows for 14 windows (40 users of 2..12 items: an epoch
    every few windows), and after `state_at` -> `restore` on both sides the
    same windows again, equal to the ones first emitted."""
    ds, jds = _datasets(seed)
    ours = batching.make_session_stream(ds, batch_size=B, window=T, seed=seed)
    theirs = jax_batching.make_session_stream(jds, batch_size=B, window=T, seed=seed)
    first = []
    for _ in range(14):
        (w, got), (jw, want) = next(ours), next(theirs)
        assert w == jw == T and sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        first.append(got)
    assert ours._epoch >= 2 and ours._epoch == theirs._epoch
    assert ours.state_at(9) == theirs.state_at(9)
    ours.restore(ours.state_at(9))
    theirs.restore(theirs.state_at(9))
    for n in range(9, 14):
        got, want = next(ours)[1], next(theirs)[1]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{n} {k}")
            np.testing.assert_array_equal(got[k], first[n][k], err_msg=f"{n} {k}")
    with pytest.raises(KeyError, match="no snapshot"):
        ours.state_at(0)


# ---------------------------------------------------------------------------
# The session wire format
# ---------------------------------------------------------------------------


def _wire_pair(vocab):
    """The port's Trainer and a stand-in for the JAX one, wired for packing."""
    cfg = RunConfig.load("configs/rsc15_gru4rec.json").apply_overrides([f"data.max_len={T}"])
    ds = types.SimpleNamespace(vocab_size=vocab, num_users=0)
    tr = Trainer.__new__(Trainer)
    tr.cfg, tr.ds, tr.device = cfg, ds, torch.device("cpu")
    fake = types.SimpleNamespace(cfg=cfg, ds=ds)
    fake._wire_dtype = JaxTrainer._wire_dtype.fget(fake)
    fake._session_wire_cols = JaxTrainer._session_wire_cols.fget(fake)
    return tr, fake


@pytest.mark.parametrize("vocab", [VOCAB, 37_484])
def test_session_wire_matches_jax(vocab):
    tr, fake = _wire_pair(vocab)
    assert tr._session_wire_cols == fake._session_wire_cols == (T, T // 2 + 1, 2)
    for window in _windows(4, seed=2):
        want = JaxTrainer.pack_session_batch(fake, window)
        got = tr.pack_batch(window)
        assert want is not None
        assert got.dtype == want.dtype == (np.int16 if vocab < 2 ** 15 else np.int32)
        assert got.tobytes() == want.tobytes()
        j_planes = JaxTrainer._unpack_session_wire(fake, jnp.asarray(want))
        t_planes = tr._device_batch(got)
        assert sorted(t_planes) == sorted(j_planes) == sorted(window)
        for k in j_planes:
            assert t_planes[k].dtype == {"inputs": torch.int32, "targets": torch.int32,
                                         "mask": torch.float32, "reset": torch.float32}[k]
            np.testing.assert_array_equal(_np(t_planes[k]), _np(j_planes[k]), err_msg=k)
            np.testing.assert_array_equal(_np(t_planes[k]), window[k], err_msg=k)
    # Windows that ship as dicts: on both sides the same Nones.
    window = _windows(2, seed=2)[1]
    dense = dict(window, reset=np.ones_like(window["reset"]))  # T ends > E slots
    broken = dict(window, targets=window["targets"].copy())
    r, t = np.argwhere(window["reset"][:, 1:] == 0)[0]  # targets[r, t] == inputs[r, t+1]
    broken["targets"][r, t] = window["inputs"][r, t + 1] % (VOCAB - 1) + 1
    cases = {"over budget": dense, "mask": dict(window, mask=window["mask"] * 0.5),
             "not a stream": broken, "no reset": {k: v for k, v in window.items() if k != "reset"},
             "length": {k: v[:, :-1] for k, v in window.items()}}
    for name, batch in cases.items():
        assert JaxTrainer.pack_session_batch(fake, batch) is None, name
        assert tr.pack_session_batch(batch) is None, name


# ---------------------------------------------------------------------------
# loss_stream and its gradients
# ---------------------------------------------------------------------------


def _session_models(cell, loss, compute_dtype):
    common = dict(arch="gru4rec", cell_type=cell, num_layers=1 if cell == "gru" else 2,
                  residual=cell == "lstm", embed_dim=H, dropout_rate=0.0,
                  compute_dtype=compute_dtype, loss=loss, num_negatives=S)
    jm = jax_build_model(JaxModelConfig(**common), VOCAB)
    tm = build_model(ModelConfig(**common), VOCAB, device="cpu")
    params = random_params(tm, seed=2)
    rng = np.random.default_rng(9)
    tower = params["params"]["tower"]
    for name, v in tower.items():
        if name.endswith(("_bx", "_bh", "_b")):
            tower[name] = (v + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm


def _carry(cell, layers, rng):
    """A dirty carry: the state a previous window would leave."""
    def leaf():
        return (rng.normal(size=(B, H)) * 0.5).astype(np.float32)
    if cell == "gru":
        return tuple(leaf() for _ in range(layers))
    return tuple((leaf(), leaf()) for _ in range(layers))


def _tree(carry, fn):
    return fn(carry) if isinstance(carry, np.ndarray) else tuple(_tree(c, fn) for c in carry)


def _leaves(carry):
    if isinstance(carry, (tuple, list)):
        return [x for c in carry for x in _leaves(c)]
    return [carry]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", ["bpr_max", "sampled_softmax"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_loss_stream_carry_and_every_grad_match_jax(cell, loss, dtype):
    """From a dirty carry, over a window with resets mid-row: loss, weight
    sum, the new carry and every parameter gradient against JAX's
    `loss_stream` under value_and_grad with stop_gradient on the carry."""
    jdt, tdt = DTYPES[dtype]
    jm, params, tm = _session_models(cell, loss, dtype)
    window = _windows(2, seed=4)[1]
    assert window["reset"][:, 1:].any() and not window["reset"][:, 0].all()
    rng = np.random.default_rng(11)
    carry = _carry(cell, 1 if cell == "gru" else 2, rng)
    neg_ids = rng.integers(1, VOCAB, size=S).astype(np.int32)
    neg_ids[:2] = window["targets"][0, :2]  # accidental hits
    nlq = None
    if loss == "sampled_softmax":
        nlq = np.array(jax_negative.log_uniform_log_prob(jnp.asarray(neg_ids), VOCAB))

    def jloss(p):
        s, w, c = jm.apply(p, {k: jnp.asarray(v) for k, v in window.items()},
                           _tree(carry, lambda a: jnp.asarray(a).astype(jdt)),
                           neg_ids=jnp.asarray(neg_ids),
                           neg_log_q=None if nlq is None else jnp.asarray(nlq),
                           deterministic=True, method=jm.loss_stream)
        return s, (w, jax.lax.stop_gradient(c))

    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    (j_sum, (j_w, j_carry)), j_grads = jax.value_and_grad(jloss, has_aux=True)(j_params)
    t_sum, t_w, t_carry = tm.loss_stream(
        {k: torch.from_numpy(v) for k, v in window.items()},
        _tree(carry, lambda a: torch.from_numpy(a).to(tdt)),
        neg_ids=torch.from_numpy(neg_ids),
        neg_log_q=None if nlq is None else torch.from_numpy(nlq), deterministic=True)
    t_sum.backward()

    f32 = dtype == "float32"
    np.testing.assert_allclose(_np(t_sum), _np(j_sum),
                               **(F32_TOL if f32 else dict(rtol=3e-2, atol=0.5)))
    assert float(t_w) == float(j_w) == B * T
    got_c, want_c = _leaves(t_carry), _leaves(j_carry)
    assert len(got_c) == len(want_c) == (1 if cell == "gru" else 4)
    for a, b in zip(got_c, want_c):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), _np(b), **(F32_TOL if f32 else BF16_TOL))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        np.testing.assert_allclose(_np(p.grad), want[name].numpy(), err_msg=name,
                                   **(F32_TOL if f32 else BF16_GRAD_TOL))


def test_loss_stream_needs_an_rnn_tower():
    m = build_model(ModelConfig(arch="sasrec", embed_dim=H, max_len=T), VOCAB, device="cpu")
    window = {k: torch.from_numpy(v) for k, v in _windows(1)[0].items()}
    with pytest.raises(ValueError, match="RNN tower"):
        m.loss_stream(window, None)


def test_reset_variants_on_cpu_are_the_plain_versions():
    """On CPU tensors the scan and reverse-recurrence wrappers with a keep
    plane are the plain versions, and count no launch."""
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    keep = torch.from_numpy((rng.random((2, 3, 1)) > 0.4).astype(np.float32))
    counters = [(cuda_gru.gru_scan, "reset_launches"), (cuda_gru.gru_backward, "reset_launches"),
                (cuda_lstm.lstm_scan, "reset_launches"),
                (cuda_lstm.lstm_backward, "reset_launches")]
    before = [getattr(f, a) for f, a in counters]
    planes = [t(2, 3, 8) for _ in range(6)]
    w = t(8, 24)
    gplanes = [t(2, 3, 24), t(2, 3, 24), planes[0] * keep, planes[1]]  # x_proj, h_proj, h_in, g
    for a, b in zip(cuda_gru.gru_backward(*gplanes, w, keep),
                    cuda_gru.plain_backward(*gplanes, w, keep)):
        assert torch.equal(a, b)
    w4, dc = t(8, 32), t(2, 8)
    lplanes = planes + [t(2, 3, 8)]
    for a, b in zip(cuda_lstm.lstm_backward(*lplanes, w4, keep, dc),
                    cuda_lstm.plain_backward(*lplanes, w4, keep, dc)):
        assert torch.equal(a, b)
    reset = 1.0 - keep[..., 0]
    x, h0, c0 = t(2, 3, 4), t(2, 8), t(2, 8)
    ys, _ = cuda_gru.gru_scan(x, h0, t(4, 24), w, reset_mask=reset)
    assert tuple(ys.shape) == (2, 3, 8)
    ys, (_, c) = cuda_lstm.lstm_scan(x, h0, c0, t(4, 32), w4, reset_mask=reset)
    assert tuple(c.shape) == (2, 8)
    assert [getattr(f, a) for f, a in counters] == before


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

TRAIN_CONFIGS = {
    "rsc15_gru4rec": ("configs/rsc15_gru4rec.json", []),
    "ml1m_lstm": ("configs/ml1m_lstm.json", ["data.session_parallel=true"]),
}


def _session_cfg(name, *extra):
    path, overrides = TRAIN_CONFIGS[name]
    return RunConfig.load(path).apply_overrides(
        overrides + [f"model.embed_dim={H}", f"model.num_negatives={S}",
                     f"data.batch_size={B}", f"data.max_len={T}"] + list(extra))


@pytest.mark.parametrize("name", sorted(TRAIN_CONFIGS))
def test_session_trainer_trajectory_matches_jax(name, monkeypatch):
    """Three session windows through `Trainer.train_step` (wires; the carry
    threads through) against JAX value_and_grad of `loss_stream` with
    stop_gradient on the new carry and the JAX package's optax chain (Adam,
    clip 5.0), from the same parameters with the same injected negatives
    (dropout off, f32)."""
    cfg = _session_cfg(name, "model.dropout_rate=0.0", "model.compute_dtype=float32")
    ds, _ = _datasets(6)
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(5)
    m = cfg.model
    layers = m.num_layers
    for leaf in _leaves(state.carry):
        assert leaf.dtype == torch.float32 and tuple(leaf.shape) == (B, H) and not leaf.any()
    rng = np.random.default_rng(13)
    negs = []
    for _ in range(3):
        ids = rng.integers(1, VOCAB, size=S).astype(np.int32)
        nlq = np.array(jax_negative.log_uniform_log_prob(jnp.asarray(ids), VOCAB))
        negs.append((ids, nlq if m.loss == "sampled_softmax" else None))
    drawn = iter(negs)
    monkeypatch.setattr(tr, "sample_negatives", lambda gen: tuple(
        None if a is None else torch.from_numpy(a) for a in next(drawn)))
    stream = batching.make_session_stream(ds, batch_size=B, window=T, seed=6)
    windows = [next(stream)[1] for _ in range(3)]

    jm = jax_build_model(JaxModelConfig(**{**m.__dict__}), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, random_params(tr.model, seed=5))
    j_opt = opt.init(j_params["params"])
    j_carry = jax_zero_carry(m.cell_type, layers, B, H, jnp.float32)
    for step, (window, (ids, nlq)) in enumerate(zip(windows, negs)):
        def loss_fn(p, carry=j_carry, window=window, ids=ids, nlq=nlq):
            s, w, c = jm.apply(p, {k: jnp.asarray(v) for k, v in window.items()}, carry,
                               neg_ids=jnp.asarray(ids),
                               neg_log_q=None if nlq is None else jnp.asarray(nlq),
                               deterministic=True, method=jm.loss_stream)
            return s / jnp.maximum(w, 1.0), (w, jax.lax.stop_gradient(c))

        (j_loss, (j_w, j_carry)), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
        j_norm = optax.global_norm(grads["params"])
        upd, j_opt = opt.update(grads["params"], j_opt, j_params["params"])
        j_params = {"params": optax.apply_updates(j_params["params"], upd)}

        wire = tr.pack_batch(window)
        assert wire is not None and wire.shape == (B, T + T // 2 + 1 + 2)
        state, met = tr.train_step(state, wire)
        assert state.step == step + 1
        np.testing.assert_allclose(float(met["loss"]), float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(j_norm), rtol=1e-5)
        assert float(met["tokens"]) == float(j_w) == B * T and not bool(met["nonfinite"])
        for a, b in zip(_leaves(state.carry), _leaves(j_carry)):
            assert a.grad_fn is None and not a.requires_grad
            np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)
        want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_params))
        for k, v in want.items():
            np.testing.assert_allclose(_np(state.params[k]), v.numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"step {step} {k}")


def test_session_train_step_multi_equals_single_steps_exactly():
    """K=3 grouped session steps give bitwise the single steps' state, the
    carry included, with dropout on and negatives from the per-step
    generators; a group given as a list with one window as a dict (the
    path a window that does not pack takes) gives the same bits too."""
    cfg = _session_cfg("rsc15_gru4rec")
    assert cfg.model.compute_dtype == "bfloat16" and cfg.model.dropout_rate > 0
    ds, _ = _datasets(7)
    tr = Trainer(cfg, ds, device="cpu")
    stream = batching.make_session_stream(ds, batch_size=B, window=T, seed=7)
    windows = [next(stream)[1] for _ in range(3)]
    wires = np.stack([tr.pack_batch(w) for w in windows])
    single, ms = tr.init_state(1), []
    for w in wires:
        single, m = tr.train_step(single, w)
        ms.append(m)
    start = tr.init_state(1)
    grouped, gm = tr.train_step_multi(start, wires)
    mixed, _ = tr.train_step_multi(tr.init_state(1), [wires[0], windows[1], wires[2]])
    assert grouped.step == single.step == mixed.step == 3 and start.step == 0
    for other in (grouped, mixed):
        for k in single.params:
            assert torch.equal(other.params[k], single.params[k]), k
        for k in single.opt_state["mu"]:
            assert torch.equal(other.opt_state["mu"][k], single.opt_state["mu"][k]), k
        for a, b in zip(_leaves(other.carry), _leaves(single.carry)):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
            assert a.grad_fn is None and not a.requires_grad
    assert any(bool(leaf.any()) for leaf in _leaves(single.carry))
    assert float(gm["loss"]) == float(torch.stack([m["loss"] for m in ms]).mean())
    assert float(gm["tokens"]) == 3 * B * T and not bool(gm["nonfinite"])
    # The state a step was given is left as it was (the step is functional).
    for leaf in _leaves(start.carry):
        assert not leaf.any()


def test_gru_launch_config_takes_the_rsc15_width():
    """D=H=100 (rsc15_gru4rec): in bf16 a row of x is 200 bytes, copied by
    the input projection in 8-byte pieces with zero-fill past D; H pads to
    112 (7 warps, zero weights and biases past 100), 8 rows a block: 32
    blocks at B=256. The reset variant's reverse recurrence (bf16 weights)
    runs on the tensor cores too, with the same padding and blocks, h_in
    read in f32 as the keep path hands it over; with f32 weights it runs on
    clusters of 2 CTAs of 50 units over 4 rows (128 CTAs). The f32 forward
    runs on clusters of 2 CTAs over 4 rows: 4 CTAs would make 256 CTAs at
    B=256, two waves on 132 SMs."""
    assert cuda_gru.launch_config(256, 50, 100, 100, torch.bfloat16) == {
        "design": "mma.sync", "grid": 32, "threads": 224, "rows_per_block": 8,
        "hidden_padded": 112, "wh_in_regs": 1, "smem_bytes": 2 * 112 * 8 * 2,
        "xproj_grid": [200, 5], "xproj_threads": 128}
    f32 = cuda_gru.launch_config(256, 50, 100, 100, torch.float32)
    assert (f32["design"], f32["cluster_size"], f32["rows_per_cluster"], f32["grid"],
            f32["units_per_cta"], f32["threads"]) == ("cluster", 2, 4, 128, 50, 416)
    bwd = cuda_gru.backward_launch_config(256, 50, 100, torch.bfloat16,
                                          h_in_dtype=torch.float32)
    stage = 6 * 8 * 116 * 4 + 8 * 116 * 4 + 8 * 120 * 2
    assert bwd == {"design": "mma.sync", "grid": 32, "threads": 224, "rows_per_block": 8,
                   "hidden_padded": 112, "w_in_regs": 1, "d_terms": 2,
                   "smem_bytes": 2 * 2 * 3 * 112 * 8 * 2 + 3 * stage}
    assert cuda_gru.backward_launch_config(256, 50, 100, torch.float32) == {
        "design": "cluster", "cluster_size": 2, "rows_per_cluster": 4, "clusters": 64,
        "grid": 128, "threads": 224, "units_per_cta": 50, "k_slices": 32, "k_slice": 12,
        "smem_bytes": (8 * 12 * 224 + 2 * 4 * 388 + 4 * 224 * 12) * 4 + 16}
    with pytest.raises(ValueError, match=r"D\*2 % 8"):
        cuda_gru.launch_config(256, 50, 102, 100, torch.bfloat16)
