"""Every width the JAX package takes: the attention above Dh = 256 (the
Dh-sliced layout), the GRU and LSTM scans at any H and D (the padded route:
zero units and inputs up to multiples of 4) and past the grid layouts'
limits (the stepped layout), and the sampled-softmax head past its resident
rows' limit (h streamed).

On the CPU: the padding transform the wrappers apply (`gru.pad_scan_operands`)
run through the plain scans, forward and backward, against the JAX package's
XLA scans and its Pallas scans in interpret mode, with the padded units
exactly 0; the plain attention at Dh = 512 and the plain head at H = 2,304
against the XLA oracles and the Pallas kernels in interpret mode; whole
models at a tiny depth against the JAX package with weights carried across
by `models/convert.py` (GRU4Rec and the LSTM tower at D = H = 50, SASRec with
one head of d = 512, GRU4Rec at D = H = 2,304); what the launch
configurations choose at each layout's edges; and a digest that every
shape the kernels took before keeps its configuration. The kernels
themselves are held against their plain versions on the card
(tests/test_torch_kernels.py, `-k "sliced or padded or stepped or
streamed"`, and chip_smoke.py phase w).

Tolerances, f32 first: 1e-5 relative and absolute (the same math in another
summation order); 2e-5 against a Pallas kernel in interpret mode (its
online softmax sums in another order); the trainer's updated parameters
1e-4 (Adam divides by sqrt(nu): last-bit differences in a gradient show at
~1e-6 of lr), as tests/test_torch_tower_steps.py. Then bf16: 3e-2 absolute
on the scans' outputs and the attention (both sides round every op to bf16,
at other places), and 2e-2 relative on a model's loss."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.config import TrainConfig as JaxTrainConfig
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import attention as pl_attn
from seqrec_tpu.ops.pallas import gru as pl_gru
from seqrec_tpu.ops.pallas import lstm as pl_lstm
from seqrec_tpu.ops.pallas import softmax_head as pl_head
from seqrec_tpu.train import state as jax_state
from seqrec_tpu_torch.benchmarks.throughput import bench_config
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import attention as cuda_attention
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import head as cuda_head
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm
from seqrec_tpu_torch.train.trainer import Trainer

F32_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BF16_LOSS_RTOL = 2e-2
DTYPES = (torch.float32, torch.bfloat16)
VOCAB = 64  # 63 items and the padding id


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# The padded route: the transform through the plain scans, against JAX
# ---------------------------------------------------------------------------


def _scan_inputs(cell, B, T, D, H, seed):
    rng = np.random.default_rng(seed)
    G = 3 if cell == "gru" else 4

    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    states = [a(B, H, scale=0.5) for _ in range(1 if cell == "gru" else 2)]
    biases = [a(G * H, scale=0.1) for _ in range(2 if cell == "gru" else 1)]
    reset = (rng.random((B, T)) < 0.3).astype(np.float32)
    reset[0, 2] = 1.0
    return (a(B, T, D), states, a(D, G * H, scale=D ** -0.5), a(H, G * H, scale=H ** -0.5),
            biases), a(B, T, H), reset


def _port_scan(cell, x, states, w_x, w_h, biases, reset):
    if cell == "gru":
        return reference.gru_scan(x, states[0], w_x, w_h, *biases, reset_mask=reset)[0]
    return reference.lstm_scan(x, *states, w_x, w_h, *biases, reset_mask=reset)[0]


def _jax_scans(cell):
    if cell == "gru":
        return (xla_ops.gru_scan,
                lambda *a, **kw: pl_gru.gru_scan(*a, **kw, interpret=True))
    return (xla_ops.lstm_scan, lambda *a, **kw: pl_lstm.lstm_scan(*a, **kw, interpret=True))


@pytest.mark.parametrize("with_reset", [False, True])
@pytest.mark.parametrize("H", [50, 102])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_padding_transform_matches_jax_with_the_padded_units_zero(cell, H, with_reset):
    """D = 50 and H = 50 or 102 (not multiples of 4), B = 2, T = 5: the
    wrappers' zero padding (each gate block on its own) through the plain
    scan and its autograd, f32. The padded units' outputs, and the gradients
    the padding passes to its zero weights' rows of the padded units, are
    exactly 0; the real units' outputs and every gradient of the unpadded
    leaves agree with jax.grad through the XLA scan and through the Pallas
    scan in interpret mode (1e-5)."""
    D = 50
    (x, states, w_x, w_h, biases), g, reset = _scan_inputs(cell, 2, 5, D, H, seed=H + D)
    rs = reset if with_reset else None
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *states, w_x, w_h, *biases)]
    n_s = len(states)
    px, pstates, pw_x, pw_h, pbiases = cuda_gru.pad_scan_operands(
        leaves[0], leaves[1:1 + n_s], leaves[1 + n_s], leaves[2 + n_s], leaves[3 + n_s:])
    Hp, Dp = cuda_gru.padded_width(H), cuda_gru.padded_width(D)
    assert px.shape[-1] == Dp and pw_h.shape == (Hp, pw_h.shape[1])
    ys_p = _port_scan(cell, px, pstates, pw_x, pw_h, pbiases,
                      None if rs is None else torch.from_numpy(rs))
    assert torch.equal(ys_p[..., H:], torch.zeros_like(ys_p[..., H:]))
    ys = ys_p[..., :H]
    (ys * torch.from_numpy(g)).sum().backward()
    for name, t in zip(("x", *("state",) * n_s, "w_x", "w_h", *("b",) * len(biases)), leaves):
        assert t.grad is not None and t.grad.shape == t.shape, name
    for scan in _jax_scans(cell):
        def jloss(*a):
            st = a[1:1 + n_s]
            out = scan(a[0], *st, a[1 + n_s], a[2 + n_s], *a[3 + n_s:],
                       reset_mask=None if rs is None else jnp.asarray(rs))
            return jnp.sum(out[0] * g)

        j_args = [jnp.asarray(a) for a in (x, *states, w_x, w_h, *biases)]
        j_ys = scan(*j_args, reset_mask=None if rs is None else jnp.asarray(rs))[0]
        np.testing.assert_allclose(_np(ys), _np(j_ys), **F32_TOL)
        grads = jax.grad(jloss, argnums=tuple(range(len(j_args))))(*j_args)
        for i, (t, j) in enumerate(zip(leaves, grads)):
            np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=str(i), **F32_TOL)


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("H", [50, 102])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_padded_reverse_recurrence_keeps_the_padded_units_zero(cell, H, with_keep):
    """The reverse recurrence the kernels compute (the plain `gru_bwd_fused`
    / `lstm_bwd_scan`) on the padded planes of a padded forward: every
    padded unit's cotangent (d_xp or dz, dh0, dc0) is exactly 0, and the
    real units' equal the unpadded recurrence's (1e-5)."""
    D, B, T = 50, 2, 5
    (x, states, w_x, w_h, biases), g, reset = _scan_inputs(cell, B, T, D, H, seed=H + 7)
    t = [torch.from_numpy(a) for a in (x, *states, w_x, w_h, *biases)]
    keep_r = torch.from_numpy(reset) if with_keep else None
    Hp = cuda_gru.padded_width(H)
    n_s = len(states)

    def recurrence(x_, states_, w_x_, w_h_, biases_, g_):
        hs = _port_scan(cell, x_, states_, w_x_, w_h_, biases_, keep_r)
        if cell == "gru":
            x_proj = torch.matmul(x_, w_x_) + biases_[0]
            h_in, keep, h_proj = reference.gru_bwd_project(x_proj, hs, states_[0], w_h_,
                                                           biases_[1], keep_r)
            d_xp, dh0, _ = reference.gru_bwd_fused(x_proj, h_proj, h_in, g_, w_h_, keep)
            return d_xp, (dh0,)
        x_proj = torch.matmul(x_, w_x_) + biases_[0]
        cs = reference.lstm_recompute_cells(x_proj, hs, *states_, w_h_, keep_r)
        _, keep, *planes = reference.lstm_bwd_hoist(x_proj, hs, cs, *states_, w_h_, keep_r)
        dz, dh0, dc0 = reference.lstm_bwd_scan(*planes, g_, w_h_, keep)
        return dz, (dh0, dc0)

    px, pstates, pw_x, pw_h, pbiases = cuda_gru.pad_scan_operands(
        t[0], t[1:1 + n_s], t[1 + n_s], t[2 + n_s], t[3 + n_s:])
    d_p, carries_p = recurrence(px, pstates, pw_x, pw_h, pbiases,
                                cuda_gru.pad_gates(torch.from_numpy(g), H, Hp))
    d, carries = recurrence(t[0], t[1:1 + n_s], t[1 + n_s], t[2 + n_s], t[3 + n_s:],
                            torch.from_numpy(g))
    G = d.shape[-1] // H
    pad_cols = torch.ones(G, Hp, dtype=torch.bool)
    pad_cols[:, :H] = False
    assert not bool(d_p[..., pad_cols.reshape(-1)].any())
    np.testing.assert_allclose(_np(cuda_gru.unpad_gates(d_p, H, Hp)), _np(d), **F32_TOL)
    for cp, c in zip(carries_p, carries):
        assert not bool(cp[:, H:].any())
        np.testing.assert_allclose(_np(cp[:, :H]), _np(c), **F32_TOL)


@pytest.mark.parametrize("H", [50, 102])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_padding_transform_in_bf16_matches_jax(cell, H):
    """The same padded forward in bf16 (the plain scan rounds every op to
    bf16, as the XLA scan does at other places): within 3e-2 of the JAX
    package's XLA scan in bf16; the padded units exactly 0."""
    (x, states, w_x, w_h, biases), _, reset = _scan_inputs(cell, 2, 5, 50, H, seed=H + 3)
    tb = [torch.from_numpy(a).bfloat16() for a in (x, *states, w_x, w_h)]
    n_s = len(states)
    px, pstates, pw_x, pw_h, pbiases = cuda_gru.pad_scan_operands(
        tb[0], tb[1:1 + n_s], tb[1 + n_s], tb[2 + n_s], [torch.from_numpy(b) for b in biases])
    ys_p = _port_scan(cell, px, pstates, pw_x, pw_h, pbiases, torch.from_numpy(reset))
    assert ys_p.dtype == torch.bfloat16 and not bool(ys_p[..., H:].any())
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, *states, w_x, w_h)]
    want = xla_ops.gru_scan if cell == "gru" else xla_ops.lstm_scan
    j_ys = want(*j, *(jnp.asarray(b) for b in biases), reset_mask=jnp.asarray(reset))[0]
    np.testing.assert_allclose(_np(ys_p[..., :H]), _np(j_ys), **BF16_TOL)


# ---------------------------------------------------------------------------
# The attention at Dh = 512 and the head at H = 2,304
# ---------------------------------------------------------------------------


def test_attention_at_dh_512_matches_xla_and_pallas_interpret():
    """One head of d = 512 (the wide SASRec at embed_dim=512): the plain
    attention (what the Dh-sliced kernels compute on the card) and its
    autograd against the XLA oracle (1e-5; gradients 1e-4) and the Pallas
    kernel in interpret mode (2e-5), f32; then bf16 against the XLA oracle
    in bf16 (3e-2)."""
    rng = np.random.default_rng(512)
    q, k, v = (rng.normal(size=(2, 20, 1, 512)).astype(np.float32) for _ in range(3))
    g = rng.normal(size=q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = cuda_attention.causal_attention(*leaves)
    (got * torch.from_numpy(g)).sum().backward()
    j = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(_np(got), np.asarray(xla_ops.causal_attention(*j)), **F32_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(pl_attn.causal_attention(*j, interpret=True)),
                               **PALLAS_TOL)
    grads = jax.grad(lambda *a: jnp.sum(xla_ops.causal_attention(*a) * g), argnums=(0, 1, 2))(*j)
    for name, t, w in zip("qkv", leaves, grads):
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name, rtol=1e-4, atol=1e-4)
    got_b = cuda_attention.causal_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want_b = xla_ops.causal_attention(*(a.astype(jnp.bfloat16) for a in j))
    np.testing.assert_allclose(_np(got_b), _np(want_b), **BF16_TOL)


def test_head_at_h_2304_matches_xla_and_pallas_interpret():
    """The plain sampled-softmax head (what the streamed layout computes on
    the card) and its backward at H = 2,304 against the JAX package's XLA
    loss and its Pallas head in interpret mode, with accidental hits and
    logQ, f32 (1e-5)."""
    H = 2304
    rng = np.random.default_rng(H)
    N, S = 13, 37
    h, pos = (rng.normal(size=(N, H)).astype(np.float32) * H ** -0.25 for _ in range(2))
    neg = rng.normal(size=(S, H)).astype(np.float32) * H ** -0.25
    targets = rng.integers(1, VOCAB, size=N).astype(np.int32)
    neg_ids = rng.integers(1, VOCAB, size=S).astype(np.int32)
    neg_ids[:3] = targets[:3]
    plq, nlq = (rng.normal(size=n).astype(np.float32) - 4 for n in (N, S))
    w = (np.arange(N) % 4 != 0).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, pos, neg)]
    got, got_w = cuda_head.sampled_softmax_loss(
        *leaves, torch.from_numpy(targets), torch.from_numpy(neg_ids), torch.from_numpy(w),
        pos_log_q=torch.from_numpy(plq), neg_log_q=torch.from_numpy(nlq))
    got.backward()
    for fn in (xla_ops.sampled_softmax_loss,
               lambda *a, **kw: pl_head.sampled_softmax_loss(*a, **kw, interpret=True)):
        def jloss(hh, pp, nn):
            return fn(hh, pp, nn, jnp.asarray(targets), jnp.asarray(neg_ids), jnp.asarray(w),
                      pos_log_q=jnp.asarray(plq), neg_log_q=jnp.asarray(nlq))

        j_args = (jnp.asarray(h), jnp.asarray(pos), jnp.asarray(neg))
        j_sum, j_w = jloss(*j_args)
        np.testing.assert_allclose(_np(got), _np(j_sum), **F32_TOL)
        assert float(got_w) == float(j_w)
        grads = jax.grad(lambda *a: jloss(*a)[0], argnums=(0, 1, 2))(*j_args)
        for name, t, j in zip(("h", "pos", "neg"), leaves, grads):
            np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=name, **F32_TOL)


# ---------------------------------------------------------------------------
# Whole models at a tiny depth, weights carried across by models/convert.py
# ---------------------------------------------------------------------------


class _DS:
    vocab_size, num_users = VOCAB, 0


def _configs():
    cut = ["model.num_negatives=9", "model.dropout_rate=0.0", "model.compute_dtype=float32",
           "data.max_len=4", "model.max_len=4", "data.batch_size=2"]
    sasrec = bench_config("sasrec", batch_size=2, max_len=4, embed_dim=512, num_layers=2,
                          num_items=VOCAB - 1, loss="sampled_softmax", num_negatives=9)
    sasrec.model.compute_dtype = "float32"
    # configs/ml1m_sasrec.json's schedule: its key bias's gradient is zero up
    # to rounding, which Adam at the full rate would turn into a +-lr step
    # (tests/test_torch_tower_steps.py keeps the warmup for the same reason).
    sasrec.train.lr_schedule, sasrec.train.warmup_steps = "warmup_cosine", 1000
    gru2304 = bench_config("gru4rec", batch_size=2, max_len=4, embed_dim=2304,
                           num_items=VOCAB - 1, loss="sampled_softmax", num_negatives=9)
    gru2304.model.compute_dtype = "float32"
    return {
        "gru4rec_d50": RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(
            ["model.embed_dim=50"] + cut),
        "lstm_d50": RunConfig.load("configs/ml1m_lstm.json").apply_overrides(
            ["model.embed_dim=50"] + cut),
        "sasrec_one_head_d512": sasrec,
        "gru4rec_d2304": gru2304,
    }


CONFIGS = _configs()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_at_every_width_matches_jax(name, monkeypatch):
    """GRU4Rec and the LSTM tower at D = H = 50 (the padded route on the
    card), SASRec with one head of d = 512 (the Dh-sliced attention) and
    GRU4Rec at D = H = 2,304 (the stepped scans and the streamed head), cut
    to B = 2, T = 4 and 9 negatives, weights drawn by `random_params` and
    handed to both sides through `flax_to_state_dict`: f32, one
    Trainer.train_step (Adam, the config's clip) against JAX value_and_grad
    and the JAX package's optax chain with the same injected negatives (loss
    and gradient norm 1e-5, updated parameters 1e-4); then bf16, the
    model's loss on the same weights against the JAX model's in bf16 (2e-2
    relative)."""
    cfg = CONFIGS[name]
    if name == "sasrec_one_head_d512":
        assert cfg.model.num_heads == 1 and cfg.model.embed_dim == 512
    tr = Trainer(cfg, _DS(), device="cpu")
    params = random_params(tr.model, seed=5)
    tr.model.load_state_dict(flax_to_state_dict(params))
    state = tr.init_state(5)
    for k, v in flax_to_state_dict(params).items():  # init_state draws the same weights
        assert torch.equal(state.params[k], v), k
    rng = np.random.default_rng(13)
    inputs = np.zeros((2, 4), np.int32)
    targets = np.zeros((2, 4), np.int32)
    for r, n in enumerate((4, 3)):
        seq = rng.integers(1, VOCAB, size=n + 1)
        inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
    batch = {"inputs": inputs, "targets": targets, "mask": (targets != 0).astype(np.float32)}
    ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    ids[0] = targets[0, 0]  # an accidental hit
    nlq = (rng.normal(size=9) - 3).astype(np.float32)
    monkeypatch.setattr(tr, "sample_negatives",
                        lambda gen: (torch.from_numpy(ids), torch.from_numpy(nlq)))

    jm = jax_build_model(JaxModelConfig(**cfg.model.__dict__), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p, model=jm):
        s, w = model.apply(p, j_batch, neg_ids=jnp.asarray(ids), neg_log_q=jnp.asarray(nlq),
                           deterministic=True, method=model.loss)
        return s / jnp.maximum(w, 1.0), w

    (j_loss, j_w), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
    upd, _ = opt.update(grads["params"], opt.init(j_params["params"]), j_params["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(j_params["params"], upd)}))
    state, m = tr.train_step(state, tr.pack_train_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-5)
    assert float(m["tokens"]) == float(j_w) and not bool(m["nonfinite"])
    assert sorted(state.params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(state.params[k]), v.numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)

    # bf16: the same weights through both models' loss.
    cfg_b = cfg.apply_overrides(["model.compute_dtype=bfloat16"])
    tr_b = Trainer(cfg_b, _DS(), device="cpu")
    tr_b.model.load_state_dict(flax_to_state_dict(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        s, w = tr_b.model.loss(tb, neg_ids=torch.from_numpy(ids), neg_log_q=torch.from_numpy(nlq),
                               deterministic=True)
    jm_b = jax_build_model(JaxModelConfig(**cfg_b.model.__dict__), VOCAB)
    j_loss_b, _ = loss_fn(j_params, jm_b)
    np.testing.assert_allclose(float(s / w.clamp(min=1.0)), float(j_loss_b),
                               rtol=BF16_LOSS_RTOL)


# ---------------------------------------------------------------------------
# Launch decisions at each layout's edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_chooses_the_sliced_layout_only_past_256(dtype):
    """Dh = 256 keeps the designs' configuration (no `layout` key); 257,
    512, 513, 1,000 and 2,048 take the Dh-cluster layout (a cluster of one
    CTA a 256-column slice: 8 at 2,048, the portable cluster size), 2,049
    and 2,304 the Dh-sliced layout, one 256-column slice more every 256; the
    cluster layout one CTA a slice, query tile and b n along one grid axis,
    128 threads in bf16 (64-row tiles), 512 in f32 (32-row tiles), TMA
    where the unit is 16 bytes; the sliced layout the designs' threads and query
    tiles; shared memory within SMEM_LIMIT; the unit divides the head's row
    (2 bytes at an odd bf16 Dh)."""
    es = dtype.itemsize
    assert "layout" not in cuda_attention.launch_config(4, 200, 1, 256, dtype)
    for Dh, slices in ((257, 2), (512, 2), (513, 3), (1000, 4), (2048, 8), (2049, 9),
                       (2304, 9)):
        cfg = cuda_attention.launch_config(4, 200, 1, Dh, dtype)
        unit = min(16, (Dh * es) & -(Dh * es))
        assert cfg["slices"] == slices and cfg["unit_bytes"] == unit, Dh
        assert cfg["smem_bytes"] <= cuda_attention.SMEM_LIMIT
        if Dh <= 2048:
            assert cfg["layout"] == "dh-cluster" and cfg["cluster"] == slices, Dh
            assert cfg["smem_bytes"] == cuda_attention.CLUSTER_SMEM[dtype]
            assert cfg["route"] == ("tma" if unit == 16 else "cp.async")
            if dtype == torch.bfloat16:
                assert cfg["grid"] == [slices * 4 * 4] and cfg["threads"] == 128
            else:
                assert cfg["grid"] == [slices * 7 * 4] and cfg["threads"] == 512
            continue
        assert cfg["layout"] == "dh-sliced", Dh
        if dtype == torch.bfloat16:
            assert cfg["grid"] == [4, 4, slices] and cfg["threads"] == 128
            assert cfg["smem_bytes"] == (4 * 64 * 72 + 64 * 264) * 2
        else:
            assert cfg["grid"] == [7 * 4, slices] and cfg["threads"] == 128
            assert cfg["smem_bytes"] == (4 * 32 * 68 + 32 * 260 + 4 * 32 * 12) * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,N,Dh", [(256, 200, 1, 512), (64, 200, 1, 512), (32, 200, 1, 1000),
                                      (3, 65, 2, 257), (1, 1, 1, 2048), (7, 130, 3, 700)])
def test_attention_cluster_items_cover_every_query_tile_once(dtype, B, T, N, Dh):
    """The cluster layout's items, read as its kernels read them
    (cluster_place and cluster_item in csrc/attention.cu): (query tile,
    b n) pairs in bands of `band` pairs, each band from its longest query
    tiles down; one cluster an item without the card's number (the band the
    most pairs whose K and V fit CLUSTER_BAND_BYTES), else `clusters`
    persistent clusters (the least of the items and the clusters the card
    holds at once: 66 of 2 CTAs, 30 of 4, 15 of 8 on an H100) take them in
    rounds dealt forward and backward, so every item is taken once, in
    cluster_band's bands, whose busiest cluster has no more than 5% more key
    tiles than with one band of every pair; the edges of its shared memory:
    the bf16 ring, two Q slices and the slots in 225 KB, f32's in 224 KB,
    both within what one block may opt in to."""
    cfg = cuda_attention.launch_config(B, T, N, Dh, dtype)
    slices, BN = cfg["cluster"], B * N
    n_tiles = -(-T // cfg["query_tile"])
    items = n_tiles * BN
    assert cfg["items"] == cfg["clusters"] == items and cfg["grid"] == [slices * items]
    assert 1 <= cfg["band"] <= BN
    assert cfg["band"] == 1 or (cfg["band"] * 2 * T * Dh * dtype.itemsize
                                <= cuda_attention.CLUSTER_BAND_BYTES)
    at_once = {2: 66, 3: 30, 4: 30, 8: 15}[slices]
    held = cuda_attention.launch_config(B, T, N, Dh, dtype, clusters_at_once=at_once)
    G = min(items, at_once)
    assert held["clusters"] == G and held["grid"] == [slices * G] and 1 <= held["band"] <= BN

    def place(w, band):
        bi, r = divmod(w, band * n_tiles)
        wb = min(band, BN - bi * band)
        return n_tiles - 1 - r // wb, bi * band + r % wb, bi

    for band in (cfg["band"], held["band"]):
        placed = [place(w, band) for w in range(items)]
        assert sorted(p[:2] for p in placed) == [(qi, g) for qi in range(n_tiles)
                                                 for g in range(BN)]
        for (qa, ga, ba), (qb, gb, bb) in zip(placed, placed[1:]):
            assert (ba == bb and qa >= qb) or bb == ba + 1
            assert ga // band == ba

    def walks(band):
        out = [[] for _ in range(G)]
        for w in range(items):
            j, p = divmod(w, G)
            out[G - 1 - p if j % 2 else p].append(w)
        return [sum(place(w, band)[0] + 1 for w in ws) for ws in out], out

    tiles, taken = walks(held["band"])
    assert sorted(w for ws in taken for w in ws) == list(range(items))
    assert max(tiles) <= 1.05 * max(walks(BN)[0])
    assert cuda_attention.CLUSTER_SMEM[torch.bfloat16] == 230_400
    assert cuda_attention.CLUSTER_SMEM[torch.float32] == 229_120


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scans_choose_the_stepped_layout_only_past_the_grid(cell, dtype):
    """At the grid layout's limit the grid layout; 4 past it and at 2,304 the
    stepped layout, forward and reverse: a GEMM of the step's vector (the
    reverse's in bf16 two terms deep, the cotangent's hi and lo, on one K) and
    a gate kernel over the B H pairs, 2T launches a forward scan and 2T + 1
    a reverse one; the limit itself is unchanged (GRU 2,112 / 1,056, LSTM
    1,792 / 1,056). H % 4 != 0 is still the kernels' refusal, which
    `padded_launch_config` resolves."""
    mod, G = (cuda_gru, 3) if cell == "gru" else (cuda_lstm, 4)
    limit = mod.grid_max_hidden(dtype)
    assert limit == {("gru", torch.bfloat16): 2112, ("gru", torch.float32): 1056,
                     ("lstm", torch.bfloat16): 1792, ("lstm", torch.float32): 1056}[
        (cell, dtype)]
    B, T = 256, 200
    assert mod.launch_config(B, T, limit, limit, dtype)["layout"] == "grid"
    assert mod.backward_launch_config(B, T, limit, dtype)["layout"] == "grid"
    bf16 = dtype == torch.bfloat16
    for H in (limit + 4, 2304):
        fwd = mod.launch_config(B, T, H, H, dtype)
        bwd = mod.backward_launch_config(B, T, H, dtype)
        for cfg in (fwd, bwd):
            assert cfg["layout"] == "stepped" and cfg["max_hidden"] == limit, H
            assert cfg["gate_grid"] == -(-B * H // 256) and cfg["threads"] == 256
            assert cfg["gemm_m"] == B
        assert (fwd["gemm_k"], fwd["gemm_n"], fwd["launches_per_scan"]) == (H, G * H, 2 * T)
        assert (bwd["gemm_k"], bwd["gemm_n"], bwd["launches_per_scan"]) == (G * H, H, 2 * T + 1)
        assert bwd["gemm"].get("terms") == (2 if bf16 else None)
        assert bwd.get("d_terms" if cell == "gru" else "dz_terms") == (2 if bf16 else None)
        # the projection's plan is its own (xproj_config's, xproj_f32_config's), not the scan's
        assert "xproj_threads" not in fwd and "xproj_grid" not in fwd
        if bf16:
            assert cuda_gru.xproj_config(B * T, H, G * H)["threads"] == cuda_gru.XPROJ_THREADS
        else:
            xp = cuda_gru.xproj_f32_config(B * T, H, G * H)
            assert xp["threads"] == 128 + 32 * xp["warps"] and 32 * xp["warps"] == xp["block"][0]
    with pytest.raises(ValueError, match="H % 4"):
        mod.launch_config(B, T, 64, 2302, dtype)
    padded = mod.padded_launch_config(B, T, 64, 2302, dtype)
    assert padded["route"] == "padded" and padded["layout"] == "stepped"
    assert padded["padded_from"] == [64, 2302] and padded["padded_to"] == [64, 2304]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_padded_route_names_the_shape_it_launches(cell, dtype):
    """D = H = 50 (SASRec's width in a GRU4Rec or LSTM tower) and H = 102:
    the kernels' configuration at 52 and 104 with `route` "padded"; a shape
    of multiples of 4 keeps launch_config's configuration exactly."""
    mod = cuda_gru if cell == "gru" else cuda_lstm
    for D, H, Dp, Hp in ((50, 50, 52, 52), (50, 102, 52, 104), (13, 7, 16, 8)):
        cfg = mod.padded_launch_config(128, 200, D, H, dtype)
        want = mod.launch_config(128, 200, Dp, Hp, dtype)
        assert cfg == {**want, "route": "padded", "padded_from": [D, H], "padded_to": [Dp, Hp]}
    assert mod.padded_launch_config(128, 200, 64, 128, dtype) == mod.launch_config(
        128, 200, 64, 128, dtype)
    assert cuda_gru.pad_gates(torch.arange(6.0), 2, 4).tolist() == [0, 1, 0, 0, 2, 3, 0, 0,
                                                                    4, 5, 0, 0]
    assert cuda_gru.unpad_gates(cuda_gru.pad_gates(torch.arange(6.0), 2, 4), 2, 4).tolist() == [
        0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_padded_backward_route_names_the_width_it_launches(cell, dtype):
    """The reverse recurrence at H = 50, 102, 7 and past the grid at 2,302:
    backward_launch_config at the padded width with `route` "padded"; H a
    multiple of 4 keeps backward_launch_config's configuration exactly."""
    mod = cuda_gru if cell == "gru" else cuda_lstm
    for H, Hp in ((50, 52), (102, 104), (7, 8), (2302, 2304)):
        cfg = mod.padded_backward_launch_config(128, 200, H, dtype)
        want = mod.backward_launch_config(128, 200, Hp, dtype)
        assert cfg == {**want, "route": "padded", "padded_from": H, "padded_to": Hp}
    for H in (64, 512, 2304):
        assert mod.padded_backward_launch_config(128, 200, H, dtype) == \
            mod.backward_launch_config(128, 200, H, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_chooses_the_streamed_layout_only_past_its_limit(dtype):
    """At `max_hidden` (1,280 bf16, 1,376 f32) the K split with its rows
    resident; one past it and at 2,304 h streamed through the ring: 64-row
    blocks, nothing resident, the same shared memory at any H (bf16 3
    stages of the negatives' and h's 64 x 136 chunks with ids and logQ,
    105,984 bytes; f32 2 stages of 32-deep chunks, 52,224)."""
    limit = cuda_head.max_hidden(dtype)
    assert limit == {torch.bfloat16: 1280, torch.float32: 1376}[dtype]
    assert cuda_head.launch_config(51_200, 512, limit, dtype)["layout"] == "k-split"
    for H in (limit + 1, 2304, 5000):
        cfg = cuda_head.launch_config(51_200, 512, H, dtype)
        assert cfg["layout"] == "streamed" and cfg["max_hidden"] == limit
        assert cfg["rows_per_block"] == 64 and cfg["grid"] == 800 and cfg["threads"] == 128
        assert cfg["smem_bytes"] == (105_984 if dtype == torch.bfloat16 else 52_224)
        assert cfg["hidden_padded"] >= H


# The f32 grid forwards' step plan (gru.grid_f32_plan: its keys and the
# shared memory it sizes), held by tests/test_torch_grid_f32_plan.py.
F32_PLAN_KEYS = ("ring_rows", "row_blocks", "thread_rows", "k_split", "chunk", "stages",
                 "smem_bytes")


def _without_f32_plan(cfg: dict) -> dict:
    """A forward's configuration without the f32 grid plan's keys (f32 grid
    forwards only; any other configuration as it is)."""
    if cfg.get("layout") != "grid" or cfg.get("design") != "fma":
        return cfg
    return {k: v for k, v in cfg.items() if k not in F32_PLAN_KEYS}


def _digest_rows():
    """The launch configurations every kernel took before the attention's
    sliced layout, the scans' padded route and stepped layout and the head's
    streamed layout were added: the attention at every Dh <= 256 and unit,
    the GRU's and LSTM's grid layouts from 260 to their limits (forward and
    reverse, the GRU's reverse at both h_in dtypes), the head's K split from
    257 to its limit."""
    out = []
    for dt in DTYPES:
        aligns = (16, 8, 4, 2) if dt == torch.bfloat16 else (16, 8, 4)
        for Dh in range(1, 257):
            for al in aligns:
                for B, T, N in ((1, 1, 1), (128, 200, 1), (3, 65, 2)):
                    out.append(cuda_attention.launch_config(B, T, N, Dh, dt, al))
        for mod in (cuda_gru, cuda_lstm):
            for H in range(260, mod.grid_max_hidden(dt) + 1, 4):
                for B in (1, 3, 256):
                    out.append(_without_f32_plan(mod.launch_config(B, 50, H, H, dt)))
                    if mod is cuda_gru:
                        for hd in DTYPES:
                            out.append(mod.backward_launch_config(B, 50, H, dt, h_in_dtype=hd))
                    else:
                        out.append(mod.backward_launch_config(B, 50, H, dt))
        for H in range(257, cuda_head.max_hidden(dt) + 1):
            for N in (1, 3, 51_200):
                out.append(cuda_head.launch_config(N, 512, H, dt))
    return out


def test_every_shape_taken_before_keeps_its_configuration():
    """The 21,288 configurations of `_digest_rows` hash to what the parent
    commit's launch_config / backward_launch_config chose (the digest
    computed on commit ff695cd's tree; recomputed on f74e025's with the bf16
    input projection's keys, xproj_grid and xproj_threads, taken out of
    every bf16 GRU and LSTM forward row, since that projection has a plan of
    its own, `cuda_gru.xproj_config`; recomputed on 3568ad8's with the f32
    grid forwards' shared memory, smem_bytes, taken out of their rows, since
    their step product has a plan of its own that sizes it, `F32_PLAN_KEYS`,
    tests/test_torch_grid_f32_plan.py; recomputed on ddc02f9's with the f32
    input projection's keys, xproj_grid and xproj_threads, taken out of
    every f32 GRU and LSTM forward row, since that projection has a plan of
    its own, `cuda_gru.xproj_f32_config`): the new layouts and the padded
    route are chosen only where the kernels refused before. The digests of
    every shape at or below 256 are tests/test_torch_wide_hidden.py's and
    tests/test_torch_wide_lstm.py's, unchanged."""
    rows = _digest_rows()
    assert len(rows) == 21_288
    assert not any(c.get("layout") in ("dh-sliced", "stepped", "streamed") for c in rows)
    digest = hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()
    assert digest == "6c517351cd5d18f4e3f9a96837443719cd0982f3d1962e22544c19dbeaf6a455"
