"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: gather bit-exact; GRU 1e-5 in f32 (same math, another summation
order) and 3e-2 in bf16 (the plain version rounds every gate op to bf16, the
kernel only the new h)."""

import numpy as np
import pytest
import torch

from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops.cuda import gather as k_gather
from seqrec_tpu_torch.ops.cuda import gru as k_gru

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
