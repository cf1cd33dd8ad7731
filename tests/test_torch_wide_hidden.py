"""Above H = 256: the GRU scans' grid-persistent layout and the sampled-softmax
head's K split, and the two configurations that need them: the JAX package's
wide GRU4Rec (benchmarks/shapes.py's gru4rec_D512_B256_T200_S512: D = H =
512 under a sampled softmax) and GRU4Rec with its paper's 1,000 hidden
units (Hidasi et al., ICLR 2016, Table 3: configs/rsc15_gru4rec.json with
model.embed_dim=1000, session-parallel under BPR-max).

On the CPU: what `launch_config` / `backward_launch_config` and the head's
`launch_config` choose from 257 to their limits and refuse past them; that
every shape at or below 256 keeps the configuration it had before these
layouts were added (commit b1b06fd) exactly; the plain versions (the scan
and its VJP, both variants, and the head) at H = 512 and 1,000 against the
JAX package's XLA ops and its Pallas kernels run in interpret mode; and both paths end to end, cut to a tiny
depth, against the JAX package. The kernels themselves are held against
their plain versions on the card (tests/test_torch_kernels.py, `-k "grid
or ksplit"`, and chip_smoke.py phase u).

Tolerances: f32 1e-5 relative (and absolute), the same math in another
summation order; the trainer's updated parameters 1e-4 (Adam divides by
sqrt(nu): last-bit differences in a gradient show at ~1e-6 of lr), as
tests/test_torch_tower_steps.py; recommend's items exactly."""

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
from seqrec_tpu.ops.pallas import gru as pl_gru
from seqrec_tpu.ops.pallas import softmax_head as pl_head
from seqrec_tpu.train import state as jax_state
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import batching, dataset
from seqrec_tpu_torch.eval import infer
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import head as cuda_head
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


# ---------------------------------------------------------------------------
# What the layouts take
# ---------------------------------------------------------------------------


def _wide_widths(limit):
    return (260, 384, 512, 1000, 1024, limit)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gru_grid_layout_from_260_to_its_limit(dtype):
    """Forward and reverse (h_in in either dtype) at B = 1, 3 and 256: the
    grid layout, its unit slices and row groups within the card's SMs in one
    cooperative wave, the groups covering every row, a CTA's W_h values
    within SMEM_LIMIT; the limit is at least 1,024 and H past it takes the
    stepped layout. H = 257 is refused for H % 4 (the kernels still need it;
    the public entry points pad it)."""
    limit = cuda_gru.grid_max_hidden(dtype)
    assert limit >= 1024
    units, tile = cuda_gru.GRID_UNITS[dtype], cuda_gru.GRID_ROW_TILE[dtype]
    for H in _wide_widths(limit):
        for B in (1, 3, 256):
            cfgs = [cuda_gru.launch_config(B, 50, H, H, dtype)] + [
                cuda_gru.backward_launch_config(B, 50, H, dtype, h_in_dtype=hd) for hd in DTYPES]
            for cfg in cfgs:
                assert cfg["layout"] == "grid" and cfg["max_hidden"] == limit, (H, B)
                assert cfg["unit_slices"] == -(-H // units)
                assert cfg["grid"] == cfg["unit_slices"] * cfg["row_groups"] <= cuda_gru.NUM_SMS
                assert cfg["row_groups"] * cfg["rows_per_group"] >= B
                assert (cfg["row_groups"] - 1) * cfg["rows_per_group"] < -(-B // tile) * tile
                assert cfg["k_padded"] >= H and cfg["threads"] == cuda_gru.GRID_THREADS
            fwd, bwd = cfgs[0], cfgs[1]
            for cfg in cfgs[1:]:
                assert cfg["smem_bytes"] == 96 * cfg["k_padded"] <= cuda_gru.SMEM_LIMIT
            # The f32 forward's shared memory is W_h's values and its step
            # product's ring (grid_f32_plan); the bf16 forward's W_h's alone.
            if dtype == torch.float32:
                plan = cuda_gru.grid_f32_plan(fwd["rows_per_group"], fwd["k_padded"], 3)
                assert {k: fwd[k] for k in plan} == plan
                assert 96 * fwd["k_padded"] < fwd["smem_bytes"] <= cuda_gru.SMEM_LIMIT
            else:
                assert fwd["smem_bytes"] == 96 * fwd["k_padded"] <= cuda_gru.SMEM_LIMIT
            plane = -(-B // tile) * tile * fwd["k_padded"]
            assert fwd["workspace_bytes"] == cuda_gru.GRID_COUNTER + 2 * plane * dtype.itemsize
            assert bwd["workspace_bytes"] == cuda_gru.GRID_COUNTER + 28 * plane
    for call in (lambda H: cuda_gru.launch_config(8, 5, H, H, dtype),
                 lambda H: cuda_gru.backward_launch_config(8, 5, H, dtype)):
        past = call(limit + 4)
        assert past["layout"] == "stepped" and past["max_hidden"] == limit
        with pytest.raises(ValueError, match="H % 4"):
            call(257)
        with pytest.raises(ValueError, match="the grid layout above H = 256 takes neither"):
            cuda_gru.launch_config(8, 5, 260, 260, dtype, rows_per_cluster=4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_ksplit_from_257_to_its_limit(dtype):
    """Every width past 256 at N = 1, 3 and 256: the K split (bf16 64-row
    blocks with their h rows resident and 128-deep chunks; f32 32-row
    blocks), within SMEM_LIMIT, up to a limit of at least 1,024; one past it
    takes the streamed layout; check_launchable agrees on tensors."""
    limit = cuda_head.max_hidden(dtype)
    assert limit >= 1024
    for H in (257,) + _wide_widths(limit):
        for N in (1, 3, 256):
            cfg = cuda_head.launch_config(N, 512, H, dtype)
            assert cfg["layout"] == "k-split" and cfg["max_hidden"] == limit, (H, N)
            assert cfg["smem_bytes"] <= cuda_head.SMEM_LIMIT
            rows = cuda_head.KSPLIT_ROWS if dtype == torch.bfloat16 else cuda_head.F32_KSPLIT_ROWS
            assert cfg["rows_per_block"] == rows and cfg["grid"] == -(-N // rows)
            assert cfg["hidden_padded"] >= H
    t = [torch.zeros(3, 260, dtype=dtype), torch.zeros(3, 260, dtype=dtype),
         torch.zeros(5, 260, dtype=dtype), torch.zeros(3, dtype=torch.int32),
         torch.zeros(5, dtype=torch.int32), torch.zeros(3), torch.zeros(5)]
    assert cuda_head.check_launchable(*t) == cuda_head.launch_config(3, 5, 260, dtype)
    past = cuda_head.launch_config(8, 16, limit + 1, dtype)
    assert past["layout"] == "streamed" and past["max_hidden"] == limit


def _configs_at_or_below_256():
    """Every GRU configuration (H % 4 == 0) and head configuration at H <=
    256, both dtypes, at three batch shapes (and both h_in dtypes, and the
    head at two alignments)."""
    rows = []
    for dtype in DTYPES:
        for H in range(4, 257, 4):
            for B, T, D in ((1, 1, 4), (3, 50, 64), (256, 200, H)):
                rows.append(cuda_gru.launch_config(B, T, D, H, dtype))
                for hd in DTYPES:
                    rows.append(cuda_gru.backward_launch_config(B, T, H, dtype, h_in_dtype=hd))
        for H in range(1, 257):
            for N, S in ((1, 1), (257, 100), (25_600, 512)):
                for align in (16, dtype.itemsize):
                    rows.append(cuda_head.launch_config(N, S, H, dtype, align))
    return rows


def test_every_config_at_or_below_256_is_unchanged():
    """The 4,224 configurations at H <= 256 hash to what launch_config /
    backward_launch_config / the head's launch_config gave before the grid
    layout and the K split were added (the digest computed on commit
    b1b06fd's tree; recomputed on f74e025's with the bf16 input
    projection's keys taken out of every bf16 forward row, its plan now
    `cuda_gru.xproj_config`, and on ddc02f9's with the f32 projection's
    taken out of every f32 forward row, its plan now
    `cuda_gru.xproj_f32_config`): the new layouts are chosen only above 256."""
    rows = _configs_at_or_below_256()
    assert len(rows) == 4224
    assert all("grid" != c.get("layout") != "k-split" for c in rows)
    digest = hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()
    assert digest == "ef96ca31295f0b4b23e7b3e2f248b47783578390967fe62898d1dd5d7cd0f4db"


# ---------------------------------------------------------------------------
# The plain versions at H = 512 and 1,000 against the JAX package
# ---------------------------------------------------------------------------


def _gru_inputs(B, T, D, H, seed):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = (a(B, T, D), a(B, H, scale=0.5), a(D, 3 * H, scale=D ** -0.5),
            a(H, 3 * H, scale=H ** -0.5), a(3 * H, scale=0.1), a(3 * H, scale=0.1))
    reset = (rng.random((B, T)) < 0.3).astype(np.float32)
    reset[0, 2] = 1.0
    return args, a(B, T, H), reset


@pytest.mark.parametrize("with_reset", [False, True])
@pytest.mark.parametrize("D,H", [(512, 512), (1000, 1000), (36, 512)])
def test_plain_gru_scan_and_vjp_match_jax(D, H, with_reset):
    """The port's GRU on the CPU (the plain scan, `gru_bwd_math` as its
    backward: what the kernels compute on the card) against jax.grad
    through the XLA scan and through the Pallas scan's custom VJP in
    interpret mode, B = 2, T = 5, f32, both variants."""
    args, g, reset = _gru_inputs(2, 5, D, H, seed=D + H)
    rs = reset if with_reset else None
    for scan in (xla_ops.gru_scan, lambda *a, **kw: pl_gru.gru_scan(*a, **kw, interpret=True)):
        def jloss(*a):
            ys, h_last = scan(*a, reset_mask=None if rs is None else jnp.asarray(rs))
            return jnp.sum(ys * g) + jnp.sum(h_last)

        j_loss, j_grads = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in args))
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        ys, h_last = cuda_gru.gru_scan(*leaves, reset_mask=None if rs is None else
                                       torch.from_numpy(rs))
        loss = (ys * torch.from_numpy(g)).sum() + h_last.sum()
        loss.backward()
        np.testing.assert_allclose(_np(loss), _np(j_loss), **F32_TOL)
        for name, t, j in zip(("x", "h0", "w_x", "w_h", "b_x", "b_h"), leaves, j_grads):
            np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=name, **F32_TOL)


@pytest.mark.parametrize("H", [512, 1000])
def test_plain_head_matches_jax(H):
    """The plain sampled-softmax head (what the K split computes on the
    card) and its backward against the JAX package's XLA loss and its
    Pallas head in interpret mode, with accidental hits and logQ."""
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
# The two paths end to end, at a tiny depth
# ---------------------------------------------------------------------------


class _DS:
    vocab_size, num_users = VOCAB, 0


def _wide_demo_cfg():
    """The wide GRU4Rec as benchmarks/shapes.py builds it (gru4rec, D = 512,
    sampled softmax), f32, dropout off, cut to B = 2, T = 6 and 9 negatives."""
    return RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(
        ["model.embed_dim=512", "model.loss=sampled_softmax", "model.num_negatives=9",
         "model.dropout_rate=0.0", "model.compute_dtype=float32", "model.max_len=6",
         "data.max_len=6", "data.batch_size=2"])


def test_wide_demo_train_step_and_recommend_match_jax(monkeypatch):
    """GRU4Rec at D = H = 512: one Trainer.train_step (Adam and the config's
    clip) against JAX value_and_grad and the JAX package's optax chain from
    the same parameters with the same injected negatives and logQ: loss,
    gradient norm, every gradient of the loss, every updated parameter; then
    recommend's top-k over the same weights against the JAX package's."""
    cfg = _wide_demo_cfg()
    tr = Trainer(cfg, _DS(), device="cpu")
    state = tr.init_state(5)
    params = random_params(tr.model, seed=5)
    rng = np.random.default_rng(13)
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
    for g_, w_ in zip(gots, wants):
        assert g_["items"] == w_["items"]
        np.testing.assert_allclose(g_["scores"], w_["scores"], **F32_TOL)


def test_gru4rec_1000_session_step_matches_jax(monkeypatch):
    """configs/rsc15_gru4rec.json with model.embed_dim=1000 (BPR-max,
    session-parallel), f32, dropout off, B = 2, T = 6, 9 negatives: one
    Trainer.train_step from the zero carry against JAX value_and_grad of
    `loss_stream` (stop_gradient on the new carry) and the JAX package's
    optax chain: loss, gradient norm, the new carry and every updated
    parameter."""
    cfg = RunConfig.load("configs/rsc15_gru4rec.json").apply_overrides(
        ["model.embed_dim=1000", "model.num_negatives=9", "model.dropout_rate=0.0",
         "model.compute_dtype=float32", "data.batch_size=2", "data.max_len=6"])
    assert cfg.data.session_parallel and cfg.model.loss == "bpr_max"
    ds = dataset.synthetic_dataset(30, VOCAB - 1, seed=3, min_len=2, max_len=9)
    tr = Trainer(cfg, ds, device="cpu")
    state = tr.init_state(5)
    rng = np.random.default_rng(17)
    ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    monkeypatch.setattr(tr, "sample_negatives", lambda gen: (torch.from_numpy(ids), None))
    window = next(batching.make_session_stream(ds, batch_size=2, window=6, seed=3))[1]
    assert window["reset"].any()

    m = cfg.model
    jm = jax_build_model(JaxModelConfig(**m.__dict__), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, random_params(tr.model, seed=5))
    carry = jax_zero_carry(m.cell_type, m.num_layers, 2, 1000, jnp.float32)

    def loss_fn(p):
        s, w, c = jm.apply(p, {k: jnp.asarray(v) for k, v in window.items()}, carry,
                           neg_ids=jnp.asarray(ids), neg_log_q=None, deterministic=True,
                           method=jm.loss_stream)
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
    got_c = jax.tree_util.tree_leaves(j_carry)
    assert len(state.carry) == len(got_c) == 1
    for a, b in zip(state.carry, got_c):
        assert tuple(a.shape) == (2, 1000)
        np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)
    for k, v in want.items():
        np.testing.assert_allclose(_np(state.params[k]), v.numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)
