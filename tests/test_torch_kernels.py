"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: gather bit-exact; GRU 1e-5 in f32 (same math, another summation
order) and 3e-2 in bf16 (the plain version rounds every gate op to bf16, the
kernel only the new h). Scatter-add 1e-5 (f32 atomics: the order of each
row's sum changes from run to run). Head 1e-5 relative (both sides multiply
in f32, bf16 inputs exactly; only the summation order differs). GRU backward
1e-4 (f32 carry over T steps, another summation order in each step's 3H-long
dot product)."""

import numpy as np
import pytest
import torch

from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops.cuda import gather as k_gather
from seqrec_tpu_torch.ops.cuda import gru as k_gru
from seqrec_tpu_torch.ops.cuda import head as k_head
from seqrec_tpu_torch.ops import reference

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _nan_equal(a, b) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("D", [8, 16, 128, 200])
def test_gather_kernel_is_bit_exact(cuda, dtype, ids_dtype, D):
    V = 37
    table = torch.randn(V, D, generator=torch.Generator().manual_seed(D)).to(cuda, dtype)
    ids = torch.tensor([[0, 5, V - 1, -1, -V, V, -V - 1, 10 ** 6, 3]] * 3,
                       dtype=ids_dtype, device=cuda)
    before = k_gather.embedding_gather.launches
    got = k_gather.embedding_gather(table, ids)
    torch.cuda.synchronize()
    assert k_gather.embedding_gather.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (3, 9, D)
    assert _nan_equal(got, k_gather.plain(table, ids))
    assert torch.isnan(got[:, 5:8]).all() and not torch.isnan(got[:, :5]).any()


def test_gather_kernel_empty_ids_launch_nothing(cuda):
    table = torch.zeros(4, 16, device=cuda)
    before = k_gather.embedding_gather.launches
    out = k_gather.embedding_gather(table, torch.zeros(0, 3, dtype=torch.int64, device=cuda))
    assert tuple(out.shape) == (0, 3, 16)
    assert k_gather.embedding_gather.launches == before


def test_gather_kernel_raises_on_rows_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="16-byte"):
        k_gather.embedding_gather(torch.zeros(4, 6, device=cuda),
                                  torch.zeros(2, dtype=torch.int32, device=cuda))


def _gru_args(B, T, D, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    # Weights at the initializers' scale (about 1/sqrt(fan-in)), which is what
    # the bf16 tolerance was sized for.
    return (t(B, T, D).to(dtype), (t(B, H) * 0.5).to(dtype), t(D, 3 * H, scale=D ** -0.5),
            t(H, 3 * H, scale=H ** -0.5), t(3 * H, scale=0.1), t(3 * H, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", [(5, 7, 16, 32), (3, 1, 32, 16), (64, 50, 128, 128),
                                     (7, 9, 64, 96)])
def test_gru_kernel_matches_plain(cuda, dtype, B, T, D, H):
    args = _gru_args(B, T, D, H, dtype, cuda)
    before = k_gru.gru_scan.launches
    ys, h = k_gru.gru_scan(*args)
    torch.cuda.synchronize()
    assert k_gru.gru_scan.launches == before + 1
    want, _ = k_gru.plain(*args)
    assert ys.dtype == dtype and tuple(ys.shape) == (B, T, H)
    torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(h, ys[:, -1])


@pytest.mark.parametrize("rows_per_block", [1, 2])
def test_gru_kernel_every_row_tiling(cuda, rows_per_block, monkeypatch):
    """B not a multiple of R leaves the last block's spare rows unwritten."""
    args = _gru_args(11, 6, 32, 32, torch.float32, cuda, seed=1)
    real = k_gru.launch_config
    monkeypatch.setattr(k_gru, "launch_config",
                        lambda *a, **kw: real(*a, rows_per_block=rows_per_block))
    ys, _ = k_gru.gru_scan(*args)
    want, _ = k_gru.plain(*args)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)


def test_gru_kernel_without_biases_and_raises_on_reset(cuda):
    x, h0, w_x, w_h, _, _ = _gru_args(4, 5, 16, 16, torch.float32, cuda, seed=2)
    ys, _ = k_gru.gru_scan(x, h0, w_x, w_h)
    want, _ = k_gru.plain(x, h0, w_x, w_h)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="reset_mask"):
        k_gru.gru_scan(x, h0, w_x, w_h, reset_mask=torch.zeros(4, 5, device=cuda))
    with pytest.raises(ValueError, match="H % 4"):
        k_gru.gru_scan(x, h0[:, :6], w_x[:, :18], w_h[:6, :18])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_model_scores_with_kernels_match_plain(cuda, compute_dtype):
    """Two layers, residual and a user table: every lookup and scan of the
    model goes through the kernels, and the scores agree with the plain path."""
    kw = dict(embed_dim=32, num_layers=2, residual=True, use_user_embedding=True,
              loss="full_softmax", compute_dtype=compute_dtype)
    models = [build_model(ModelConfig(use_pallas=p, **kw), 50, num_users=4, device=cuda)
              for p in (True, False)]
    state = flax_to_state_dict(random_params(models[0], seed=4))
    for m in models:
        m.load_state_dict(state)
    rng = np.random.default_rng(5)
    inputs = torch.from_numpy(rng.integers(0, 50, size=(6, 12)).astype(np.int32)).to(cuda)
    mask = (torch.arange(12, device=cuda)[None] < torch.tensor([[12], [3], [1], [0], [7], [12]],
                                                               device=cuda)).float()
    users = torch.tensor([0, 1, 2, 3, 4, 1], dtype=torch.int32, device=cuda)
    g0, r0 = k_gather.embedding_gather.launches, k_gru.gru_scan.launches
    with torch.inference_mode():
        got = models[0].scores(inputs, mask, users=users)
        assert (k_gather.embedding_gather.launches - g0, k_gru.gru_scan.launches - r0) == (2, 2)
        want = models[1].scores(inputs, mask, users=users)
    assert (k_gather.embedding_gather.launches - g0, k_gru.gru_scan.launches - r0) == (2, 2)
    tol = 1e-4 if compute_dtype == "float32" else 5e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Training-path kernels: scatter-add, GRU backward, sampled-softmax head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("D", [16, 128, 200])
def test_scatter_add_kernel_matches_plain(cuda, ids_dtype, D):
    V = 37
    rng = np.random.default_rng(D)
    ids = rng.integers(0, V, size=(7, 50))
    ids[0, :6] = [-1, -V, V, -V - 1, 10 ** 6, 5]  # wrap, wrap, drop, drop, drop
    ids = torch.from_numpy(ids).to(cuda, ids_dtype)
    g = torch.from_numpy(rng.normal(size=(7, 50, D)).astype(np.float32)).to(cuda)
    before = k_gather.embedding_scatter_add.launches
    got = k_gather.embedding_scatter_add(g, ids, V)
    torch.cuda.synchronize()
    assert k_gather.embedding_scatter_add.launches == before + 1
    want = k_gather.plain_backward(g, ids, V)
    assert got.dtype == torch.float32 and tuple(got.shape) == (V, D)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gather_backward_through_autograd_uses_the_scatter_kernel(cuda):
    table = torch.randn(40, 32, device=cuda, requires_grad=True)
    ids = torch.tensor([[1, 2, 2, -1, 99]], device=cuda)
    before = k_gather.embedding_scatter_add.launches
    out = k_gather.embedding_gather(table, ids)
    (out[:, :4] * 2.0).sum().backward()
    assert k_gather.embedding_scatter_add.launches == before + 1
    want = torch.zeros(40, 32, device=cuda)
    want[1] += 2.0
    want[2] += 4.0
    want[39] += 2.0
    torch.testing.assert_close(table.grad, want)


def _gate_planes(B, T, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, lo=None):
        a = rng.uniform(0.05, 0.95, size=shape) if lo else rng.normal(size=shape) * 0.5
        return torch.from_numpy(a.astype(np.float32)).to(device)

    r, z = t(B, T, H, lo=True), t(B, T, H, lo=True)
    n = torch.tanh(t(B, T, H))
    hn = t(B, T, H)
    h_in = torch.tanh(t(B, T, H)).to(dtype)
    g = t(B, T, H).to(dtype)
    w_h = (t(H, 3 * H) * H ** -0.5).to(dtype)
    return r, z, n, hn, h_in, g, w_h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,R", [(5, 7, 32, None), (3, 1, 16, None),
                                     (128, 50, 128, None), (11, 9, 64, 2),
                                     (4, 6, 256, None)])
def test_gru_backward_kernel_matches_plain(cuda, dtype, B, T, H, R, monkeypatch):
    if R is not None:
        real = k_gru.backward_launch_config
        monkeypatch.setattr(k_gru, "backward_launch_config",
                            lambda *a, **kw: real(*a, rows_per_block=R))
    planes = _gate_planes(B, T, H, dtype, cuda, seed=B + T)
    before = k_gru.gru_backward.launches
    d_xp, dh0 = k_gru.gru_backward(*planes)
    torch.cuda.synchronize()
    assert k_gru.gru_backward.launches == before + 1
    want_xp, want_h0 = k_gru.plain_backward(*planes)
    torch.testing.assert_close(d_xp, want_xp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dh0, want_h0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,T,D,H", [(6, 9, 32, 32), (16, 40, 128, 128)])
def test_gru_autograd_with_kernels_matches_plain_autograd(cuda, B, T, D, H):
    """f32: the kernels' forward and backward against autograd through the
    plain scan's own torch ops."""
    args = [a.detach().requires_grad_(True)
            for a in _gru_args(B, T, D, H, torch.float32, cuda, seed=3)]
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(B, T, H))
                         .astype(np.float32)).to(cuda)
    f0, b0 = k_gru.gru_scan.launches, k_gru.gru_backward.launches
    ys, h_last = k_gru.gru_scan(*args)
    ((ys * g).sum() + h_last.sum()).backward()
    assert (k_gru.gru_scan.launches - f0, k_gru.gru_backward.launches - b0) == (1, 1)
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    ys_p, h_p = k_gru.plain(*args)
    ((ys_p * g).sum() + h_p.sum()).backward()
    for name, x, y in zip(("x", "h0", "w_x", "w_h", "b_x", "b_h"), got, args):
        torch.testing.assert_close(x, y.grad, rtol=1e-4, atol=1e-4, msg=name)


def _head_args(N, S, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    V = 3 * S

    def t(*shape):
        return torch.from_numpy((rng.normal(size=shape) * H ** -0.25)
                                .astype(np.float32)).to(device, dtype)

    targets = torch.from_numpy(rng.integers(1, V, size=N).astype(np.int32)).to(device)
    neg_ids = torch.from_numpy(rng.integers(1, V, size=S).astype(np.int32)).to(device)
    neg_ids[: min(S, 4)] = targets[: min(S, 4)]  # accidental hits
    plq = torch.from_numpy(rng.normal(size=N).astype(np.float32) - 6).to(device)
    nlq = torch.from_numpy(rng.normal(size=S).astype(np.float32) - 6).to(device)
    return t(N, H), t(N, H), t(S, H), targets, neg_ids, plq, nlq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,S,H", [(300, 256, 128), (1000, 100, 64), (64, 37, 32),
                                   (5, 1, 8), (130, 600, 128)])
def test_head_kernel_matches_plain(cuda, dtype, N, S, H):
    es = 4 if dtype == torch.float32 else 2
    if k_head.ROWS_PER_BLOCK * H * 4 + S * H * es > k_head.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            k_head.launch_config(N, S, H, dtype)
        return
    args = _head_args(N, S, H, dtype, cuda, seed=N + S)
    before = k_head.sampled_softmax_nll.launches
    got = k_head.sampled_softmax_nll(*args)
    torch.cuda.synchronize()
    assert k_head.sampled_softmax_nll.launches == before + 1
    want = k_head.plain(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_head_loss_fwd_bwd_matches_the_plain_loss(cuda):
    """f32: the fused head's loss and gradients against autograd through
    `reference.sampled_softmax_loss` (the JAX package's XLA formula)."""
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(257, 100, 64, torch.float32, cuda)
    w = (torch.arange(257, device=cuda) % 5 != 0).float()
    outs = []
    for fn in (k_head.sampled_softmax_loss, reference.sampled_softmax_loss):
        leaves = [a.detach().requires_grad_(True) for a in (h, pos, neg)]
        loss, w_sum = fn(*leaves, targets, neg_ids, w, pos_log_q=plq, neg_log_q=nlq)
        loss.backward()
        outs.append([loss.detach(), w_sum] + [a.grad for a in leaves])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_head_kernel_raises_on_what_it_cannot_take(cuda):
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(8, 16, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        k_head.sampled_softmax_nll(h, pos, torch.zeros(2000, 32, device=cuda),
                                   targets, torch.zeros(2000, dtype=torch.int32, device=cuda),
                                   plq, torch.zeros(2000, device=cuda))
    with pytest.raises(ValueError, match="one dtype"):
        k_head.sampled_softmax_nll(h, pos.bfloat16(), neg, targets, neg_ids, plq, nlq)


@pytest.mark.parametrize("loss", ["sampled_softmax", "bpr"])
def test_model_loss_backward_on_cuda_reaches_every_parameter(cuda, loss):
    """Every kernel of the training step launches the expected number of
    times, and every parameter gets a finite gradient."""
    from seqrec_tpu_torch.data.negative import sample_negatives

    cfg = ModelConfig(embed_dim=32, num_layers=2, loss=loss, num_negatives=40,
                      use_user_embedding=True)
    m = build_model(cfg, 60, num_users=5, device=cuda)
    m.load_state_dict(flax_to_state_dict(random_params(m, seed=1)))
    rng = np.random.default_rng(2)
    seq = torch.from_numpy(rng.integers(1, 60, size=(4, 11)).astype(np.int32)).to(cuda)
    batch = {"inputs": seq[:, :-1], "targets": seq[:, 1:],
             "mask": torch.ones(4, 10, device=cuda),
             "users": torch.tensor([0, 1, 4, 2], dtype=torch.int32, device=cuda)}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    neg_ids, nlq = sample_negatives(gen, 40, 60, "log_uniform")
    counters = (k_gather.embedding_gather, k_gather.embedding_scatter_add, k_gru.gru_scan,
                k_gru.gru_backward, k_head.sampled_softmax_nll)
    before = [c.launches for c in counters]
    loss_sum, w_sum = m.loss(batch, neg_ids=neg_ids, neg_log_q=nlq, generator=gen)
    (loss_sum / w_sum).backward()
    got = [c.launches - b for c, b in zip(counters, before)]
    # gathers: inputs, user, targets, negatives; GRU: one per layer each way.
    assert got == [4, 4, 2, 2, 1 if loss == "sampled_softmax" else 0]
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


def test_train_step_with_kernels_matches_plain(cuda):
    """One training step through the kernels and one through the plain
    versions, from the same state with the same draws: loss and gradient
    norm within bf16 noise."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.train.trainer import Trainer

    class DS:
        vocab_size, num_users = 80, 0

    rng = np.random.default_rng(0)
    tokens = np.zeros((8, 22), np.int16)
    for r in range(8):
        n = rng.integers(3, 21)
        tokens[r, :n + 1] = rng.integers(1, 80, size=n + 1)
    results = []
    for use_pallas in ("true", "false"):
        cfg = RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(
            ["model.embed_dim=32", "model.num_negatives=50", "data.max_len=20",
             f"model.use_pallas={use_pallas}"])
        tr = Trainer(cfg, DS(), device=cuda)
        _, m = tr.train_step(tr.init_state(3), tokens)
        results.append({k: float(v) for k, v in m.items()})
    a, b = results
    assert a["nonfinite"] == b["nonfinite"] == 0.0 and a["tokens"] == b["tokens"]
    assert abs(a["loss"] - b["loss"]) <= 2e-2 * abs(b["loss"])
    assert abs(a["grad_norm"] - b["grad_norm"]) <= 5e-2 * b["grad_norm"]
