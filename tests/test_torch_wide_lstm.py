"""Above H = 256: the LSTM scans' grid-persistent layout, and the two paths
that need it: the JAX package's wide LSTM (benchmarks/scan_ab.py's
wide_lstm_D512 in a whole model: benchmarks/shapes.py:70-72's wide GRU4Rec
through the port's bench_config with model.cell_type="lstm", D = H = 512
under a sampled softmax) and configs/ml1m_lstm.json session-parallel at
model.embed_dim=512 (two residual LSTM layers, the carry across windows).

On the CPU: what `launch_config` / `backward_launch_config` choose from 260
to each dtype's limit and refuse past it; that every shape at or below 256
keeps the configuration it had before the layout was added (commit
d90efaf); that `grid_pack`'s layout, read back as the grid kernels index it,
is W_h (three gates and four); the plain versions (the scan and its VJP,
both variants) at H = 512 against the JAX package's XLA ops and its Pallas
kernel run in interpret mode; and both paths end to end, cut to a tiny
depth, against the JAX package. The kernels themselves are held against
their plain versions on the card (tests/test_torch_kernels.py, `-k
lstm_grid`, and chip_smoke.py phase v).

Tolerances: f32 1e-5 relative (and absolute), the same math in another
summation order; the trainer's updated parameters 1e-4 (Adam divides by
sqrt(nu): last-bit differences in a gradient show at ~1e-6 of lr), as
tests/test_torch_wide_hidden.py; recommend's items exactly."""

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
from seqrec_tpu.eval.infer import recommend as jax_recommend
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.models.towers import zero_carry as jax_zero_carry
from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import lstm as pl_lstm
from seqrec_tpu.train import state as jax_state
from seqrec_tpu_torch.benchmarks.throughput import bench_config
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import batching, dataset
from seqrec_tpu_torch.eval import infer
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm
from seqrec_tpu_torch.train.trainer import Trainer

F32_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = (torch.float32, torch.bfloat16)
VOCAB = 64  # 63 items and the padding id


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _leaves(carry):
    if isinstance(carry, (tuple, list)):
        return [x for c in carry for x in _leaves(c)]
    return [carry]


# ---------------------------------------------------------------------------
# What the layout takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_lstm_grid_layout_from_260_to_its_limit(dtype):
    """Forward and reverse at B = 1, 3 and 256, every H % 4 == 0 from 260 to the limit:
    the grid layout, its unit slices and row groups within the card's SMs
    in one cooperative wave, the groups covering every row, a CTA's W_h
    values of four gates (128 Kp bytes) within SMEM_LIMIT, the workspace of
    each direction; the limit is 1,792 in bf16 (shared memory binds) and
    1,056 in f32 (the SMs bind), and H past it takes the stepped layout.
    H = 257 is refused for H % 4 (the kernels still need it; the public entry
    points pad it), and the f32 cluster design's options for the grid
    layout."""
    limit = cuda_lstm.grid_max_hidden(dtype)
    assert limit == {torch.bfloat16: 1792, torch.float32: 1056}[dtype]
    units, tile = cuda_gru.GRID_UNITS[dtype], cuda_gru.GRID_ROW_TILE[dtype]
    for H in range(260, limit + 1, 4):
        for B in (1, 3, 256):
            fwd = cuda_lstm.launch_config(B, 50, H, H, dtype)
            bwd = cuda_lstm.backward_launch_config(B, 50, H, dtype)
            for cfg in (fwd, bwd):
                assert cfg["layout"] == "grid" and cfg["max_hidden"] == limit, (H, B)
                assert cfg["unit_slices"] == -(-H // units)
                assert cfg["grid"] == cfg["unit_slices"] * cfg["row_groups"] <= cuda_gru.NUM_SMS
                assert cfg["row_groups"] * cfg["rows_per_group"] >= B
                assert (cfg["row_groups"] - 1) * cfg["rows_per_group"] < -(-B // tile) * tile
                assert cfg["smem_bytes"] == 128 * cfg["k_padded"] <= cuda_lstm.SMEM_LIMIT
                assert cfg["k_padded"] >= H and cfg["threads"] == cuda_gru.GRID_THREADS
            plane = -(-B // tile) * tile * fwd["k_padded"]
            assert fwd["workspace_bytes"] == cuda_gru.GRID_COUNTER + (2 * dtype.itemsize + 4) * plane
            assert bwd["workspace_bytes"] == cuda_gru.GRID_COUNTER + 40 * plane
            assert bwd.get("dz_terms") == (2 if dtype == torch.bfloat16 else None)
            if dtype == torch.bfloat16:  # the projection's plan is gru.xproj_config's
                assert "xproj_threads" not in fwd
            else:
                assert fwd["xproj_threads"] == cuda_gru.F32_PROJ_THREADS
    for call in (lambda H: cuda_lstm.launch_config(8, 5, H, H, dtype),
                 lambda H: cuda_lstm.backward_launch_config(8, 5, H, dtype)):
        past = call(limit + 4)
        assert past["layout"] == "stepped" and past["max_hidden"] == limit
        with pytest.raises(ValueError, match="H % 4"):
            call(257)
    for call in (lambda: cuda_lstm.launch_config(8, 5, 260, 260, dtype, rows_per_cluster=4),
                 lambda: cuda_lstm.backward_launch_config(8, 5, 260, dtype, cluster_size=4)):
        with pytest.raises(ValueError, match="the grid layout above H = 256 takes neither"):
            call()


def _lstm_configs_at_or_below_256():
    """Every LSTM configuration (H % 4 == 0) at H <= 256, both dtypes, both
    directions, at three batch shapes."""
    rows = []
    for dtype in DTYPES:
        for H in range(4, 257, 4):
            for B, T, D in ((1, 1, 4), (3, 50, 64), (256, 200, H)):
                rows.append(cuda_lstm.launch_config(B, T, D, H, dtype))
                rows.append(cuda_lstm.backward_launch_config(B, T, H, dtype))
    return rows


def test_every_lstm_config_at_or_below_256_is_unchanged():
    """The 768 configurations at H <= 256 hash to what launch_config /
    backward_launch_config gave before the grid layout was added (the
    digest computed on commit d90efaf's tree; recomputed on f74e025's with
    the bf16 input projection's keys taken out of every bf16 forward row,
    its plan now `gru.xproj_config`): the layout is chosen only above
    256."""
    rows = _lstm_configs_at_or_below_256()
    assert len(rows) == 768
    assert all(c.get("layout") != "grid" for c in rows)
    digest = hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()
    assert digest == "d99f0eac44bb8f702808070f4902e8f5a2b76b76390405adc94c827818aed10b"


# ---------------------------------------------------------------------------
# grid_pack, read back as the kernels index it
# ---------------------------------------------------------------------------


def _bf16_positions(ksteps):
    """A bf16 grid kernel's A fragment element e of lane `lane` at k-step
    ks (two k-steps 2c, 2c + 1 a 16-byte B read): its row m of the 16-unit
    tile and its k, with K permuted as the kernels read h (or dz): lane
    (g, q) of k-steps 2c, 2c + 1 covers k = 32 c + 8 q .. + 7. Register
    r = 2 kh + mh holds rows g + 8 mh at mma's k = 2 q + 8 kh (+ 1), which
    the B operand (hv.x, .y for kk 0; .z, .w for kk 1) takes from k =
    32 c + 8 q + 4 kk + 2 kh (+ 1)."""
    ks, lane, e = np.meshgrid(np.arange(ksteps), np.arange(32), np.arange(8), indexing="ij")
    c, kk, g, q = ks // 2, ks % 2, lane // 4, lane % 4
    r, pair = e // 2, e % 2
    mh, kh = r % 2, r // 2
    return g + 8 * mh, 32 * c + 8 * q + 4 * kk + 2 * kh + pair


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gates", [3, 4])
def test_grid_pack_is_what_the_kernels_index(gates, dtype, reverse):
    """`gru.grid_pack` for the GRU's three gates and the LSTM's four, read
    back through the index expressions of csrc/gru.cu's and csrc/lstm.cu's
    grid kernels (each CTA's slice of units; bf16 a lane's 16-byte A
    fragment at `((2c + kk) G + q) 32 + lane` forward and `(2c + kk) 32 +
    lane` reverse; f32 a lane's float4 at `((j 8 + u) G + q) 32 + lane`
    forward and `(j 8 + u) 32 + lane` reverse, G = 1 there): the forward's A is W_h^T of
    each gate, the reverse's W_h's rows over the gates' columns each padded
    to Kp, zero past H, every position read once."""
    H = 260
    rng = np.random.default_rng(gates)
    w = torch.from_numpy(rng.normal(size=(H, gates * H)).astype(np.float32)).to(dtype)
    pack = cuda_gru.grid_pack(w, dtype, reverse=reverse)
    units, kp = cuda_gru.GRID_UNITS[dtype], cuda_gru._grid_kpad(H, dtype)
    tiles = -(-H // units)
    wf = w.float().numpy().reshape(H, gates, H)
    # want[tile][gate][m][k]: the forward's A_q[unit][k] = W_h[k, q H + unit];
    # want[tile][0][m][q Kp + j] = W_h[unit, q H + j] reverse.
    if reverse:
        full = np.zeros((units * tiles, gates, kp), np.float32)
        full[:H, :, :H] = wf
        want = full.reshape(tiles, 1, units, gates * kp)
    else:
        full = np.zeros((gates, units * tiles, kp), np.float32)
        full[:, :H, :H] = wf.transpose(1, 2, 0)
        want = full.reshape(gates, tiles, units, kp).transpose(1, 0, 2, 3)
    K, G = want.shape[-1], want.shape[1]
    got = np.full(want.shape, np.nan, np.float32)
    flat = pack.float().numpy().reshape(tiles, -1)
    if dtype == torch.bfloat16:
        words = flat.reshape(tiles, -1, 8)  # a lane's 16-byte fragment
        ks = K // 16
        m, k = _bf16_positions(ks)
        ksi = np.arange(ks)[:, None, None]
        lane = np.arange(32)[None, :, None]
        e = np.arange(8)[None, None, :]
        for q in range(G):
            idx = (ksi * G + q) * 32 + lane
            got[:, q, m, k] = words[:, idx, e]
    else:
        vecs = flat.reshape(tiles, -1, 4)  # a lane's float4
        j, u, lane, e = np.meshgrid(np.arange(K // 128), np.arange(8), np.arange(32),
                                    np.arange(4), indexing="ij")
        for q in range(G):
            idx = ((j * 8 + u) * G + q) * 32 + lane
            got[:, q, u, 128 * j + 4 * lane + e] = vecs[:, idx, e]
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The plain versions at H = 512 against the JAX package
# ---------------------------------------------------------------------------


def _lstm_inputs(B, T, D, H, seed):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = (a(B, T, D), a(B, H, scale=0.5), a(B, H, scale=0.5), a(D, 4 * H, scale=D ** -0.5),
            a(H, 4 * H, scale=H ** -0.5), a(4 * H, scale=0.1))
    reset = (rng.random((B, T)) < 0.3).astype(np.float32)
    reset[0, 2] = 1.0
    return args, a(B, T, H), a(B, H), reset


@pytest.mark.parametrize("with_reset", [False, True])
@pytest.mark.parametrize("D,H", [(512, 512), (36, 512)])
def test_plain_lstm_scan_and_vjp_match_jax(D, H, with_reset):
    """The port's LSTM on the CPU (the plain scan, `lstm_bwd_math` with the
    plain reverse loop as its backward: what the kernels compute on the
    card) against jax.grad through the XLA scan and through the Pallas
    scan's custom VJP in interpret mode (at D = 36 its gate sends the scan
    to XLA, as on the TPU), B = 2, T = 5, f32, both variants, with h_last
    and c_last in the loss."""
    args, g, g_c, reset = _lstm_inputs(2, 5, D, H, seed=D + H)
    rs = reset if with_reset else None
    for scan in (xla_ops.lstm_scan,
                 lambda *a, **kw: pl_lstm.lstm_scan(*a, **kw, interpret=True)):
        def jloss(*a):
            ys, (h_last, c_last) = scan(*a, reset_mask=None if rs is None else jnp.asarray(rs))
            return jnp.sum(ys * g) + jnp.sum(h_last) + jnp.sum(c_last * g_c)

        j_loss, j_grads = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in args))
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        ys, (h_last, c_last) = cuda_lstm.lstm_scan(
            *leaves, reset_mask=None if rs is None else torch.from_numpy(rs))
        loss = ((ys * torch.from_numpy(g)).sum() + h_last.sum()
                + (c_last * torch.from_numpy(g_c)).sum())
        loss.backward()
        np.testing.assert_allclose(_np(loss), _np(j_loss), **F32_TOL)
        for name, t, j in zip(("x", "h0", "c0", "w_x", "w_h", "b"), leaves, j_grads):
            np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=name, **F32_TOL)


# ---------------------------------------------------------------------------
# The two paths end to end, at a tiny depth
# ---------------------------------------------------------------------------


class _DS:
    vocab_size, num_users = VOCAB, 0


def _wide_lstm_cfg() -> RunConfig:
    """Path (i) as chip_smoke.py builds it (the port's bench_config with
    benchmarks/shapes.py:70-72's arguments, model.cell_type="lstm"), f32,
    cut to B = 2, T = 6, 9 negatives and this test's catalog."""
    cfg = bench_config("gru4rec", batch_size=2, max_len=6, embed_dim=512, num_items=VOCAB - 1,
                       loss="sampled_softmax", num_negatives=9)
    cfg.model.cell_type = "lstm"
    cfg.model.compute_dtype = "float32"
    return cfg


def test_wide_lstm_train_step_and_recommend_match_jax(monkeypatch):
    """The wide LSTM at D = H = 512: one Trainer.train_step (Adam and the
    config's clip) against JAX value_and_grad and the JAX package's optax
    chain from the same parameters with the same injected negatives and
    logQ: loss, gradient norm, every gradient of the loss, every updated
    parameter; then recommend's top-k over the same weights against the JAX
    package's."""
    cfg = _wide_lstm_cfg()
    assert (cfg.model.embed_dim, cfg.model.cell_type, cfg.model.num_layers) == (512, "lstm", 1)
    tr = Trainer(cfg, _DS(), device="cpu")
    state = tr.init_state(5)
    params = random_params(tr.model, seed=5)
    rng = np.random.default_rng(23)
    inputs = np.zeros((2, 6), np.int32)
    targets = np.zeros((2, 6), np.int32)
    for r, n in enumerate((6, 4)):  # a full row and a padded one
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

    def loss_fn(p):
        s, w = jm.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        neg_ids=jnp.asarray(ids), neg_log_q=jnp.asarray(nlq),
                        deterministic=True, method=jm.loss)
        return s / jnp.maximum(w, 1.0), w

    (j_loss, j_w), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
    upd, _ = opt.update(grads["params"], opt.init(j_params["params"]), j_params["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(j_params["params"], upd)}))
    want_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))

    model = tr.model
    model.load_state_dict(flax_to_state_dict(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    s, w = model.loss(tb, neg_ids=torch.from_numpy(ids), neg_log_q=torch.from_numpy(nlq),
                      deterministic=True)
    (s / w.clamp(min=1.0)).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want_grads[name].numpy(), err_msg=name,
                                   **F32_TOL)
    model.zero_grad(set_to_none=True)

    state, m = tr.train_step(state, tr.pack_train_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-5)
    assert float(m["tokens"]) == float(j_w) and not bool(m["nonfinite"])
    assert sorted(state.params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)

    hist = [{"user": i, "history": rng.integers(1, VOCAB, size=n).tolist()}
            for i, n in enumerate((0, 1, 4, 6, 9))]
    wants = list(jax_recommend(jm, j_params, hist, k=5, batch_size=2, max_len=6))
    gots = list(infer.recommend(model, hist, k=5, batch_size=2, max_len=6))
    assert len(gots) == len(wants) == len(hist)
    for g_, w_ in zip(gots, wants):
        assert g_["items"] == w_["items"]
        np.testing.assert_allclose(g_["scores"], w_["scores"], **F32_TOL)


def test_wide_lstm_session_step_matches_jax(monkeypatch):
    """configs/ml1m_lstm.json session-parallel at model.embed_dim=512 (two
    residual LSTM layers, sampled softmax), f32, dropout off, B = 2, T = 6,
    9 negatives: one Trainer.train_step from the zero carry against JAX
    value_and_grad of `loss_stream` (stop_gradient on the new carry) and the
    JAX package's optax chain: loss, gradient norm, the new carry (h and c
    of both layers) and every updated parameter."""
    cfg = RunConfig.load("configs/ml1m_lstm.json").apply_overrides(
        ["data.session_parallel=true", "model.embed_dim=512", "model.num_negatives=9",
         "model.dropout_rate=0.0", "model.compute_dtype=float32", "data.batch_size=2",
         "data.max_len=6"])
    m = cfg.model
    assert m.cell_type == "lstm" and m.num_layers == 2 and m.residual
    ds = dataset.synthetic_dataset(30, VOCAB - 1, seed=4, min_len=2, max_len=9)
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(5)
    rng = np.random.default_rng(19)
    ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    nlq = (rng.normal(size=9) - 3).astype(np.float32)
    monkeypatch.setattr(tr, "sample_negatives",
                        lambda gen: (torch.from_numpy(ids), torch.from_numpy(nlq)))
    window = next(batching.make_session_stream(ds, batch_size=2, window=6, seed=4))[1]
    assert window["reset"].any()

    jm = jax_build_model(JaxModelConfig(**m.__dict__), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, random_params(tr.model, seed=5))
    carry = jax_zero_carry(m.cell_type, m.num_layers, 2, 512, jnp.float32)

    def loss_fn(p):
        s, w, c = jm.apply(p, {k: jnp.asarray(v) for k, v in window.items()}, carry,
                           neg_ids=jnp.asarray(ids), neg_log_q=jnp.asarray(nlq),
                           deterministic=True, method=jm.loss_stream)
        return s / jnp.maximum(w, 1.0), (w, jax.lax.stop_gradient(c))

    (j_loss, (j_w, j_carry)), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
    upd, _ = opt.update(grads["params"], opt.init(j_params["params"]), j_params["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(j_params["params"], upd)}))

    state, met = tr.train_step(state, tr.pack_batch(window))
    np.testing.assert_allclose(float(met["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-5)
    assert float(met["tokens"]) == float(j_w) and not bool(met["nonfinite"])
    got_c, want_c = _leaves(state.carry), jax.tree_util.tree_leaves(j_carry)
    assert len(got_c) == len(want_c) == 4  # (h, c) of each layer
    for a, b in zip(got_c, want_c):
        assert tuple(a.shape) == (2, 512) and a.grad_fn is None
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)
    for k, v in want.items():
        np.testing.assert_allclose(_np(state.params[k]), v.numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)
