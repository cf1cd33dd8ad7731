"""PyTorch port ops vs the JAX oracle (ops/xla.py) and the Pallas kernels in
interpret mode, on identical numpy inputs; plus the CPU side of the kernel
wrappers. The kernels themselves are held against their plain versions on
the card by tests/test_torch_kernels.py.

Tolerances: f32 1e-5 (same math, different summation order); bf16 3e-2
(both sides round every op to bf16, about 8 ulps near 1.0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import gather as pl_gather
from seqrec_tpu.ops.pallas import gru as pl_gru
from seqrec_tpu_torch.ops import dispatch, reference
from seqrec_tpu_torch.ops.cuda import gather as cuda_gather
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    """JAX or torch array -> float32/int numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

V, D = 7, 16
_WRAP_AND_NAN_IDS = np.array([[0, 3, 6, -1, -7], [7, -8, 100, -100, 2]], np.int32)


def _table(seed=0):
    return np.random.default_rng(seed).normal(size=(V, D)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_matches_xla_including_wrap_and_nan(dtype):
    jdt, tdt = DTYPES[dtype]
    table = _table()
    want = xla_ops.embedding_gather(jnp.asarray(table, jdt),
                                    jnp.asarray(_WRAP_AND_NAN_IDS))
    got = reference.embedding_gather(torch.from_numpy(table).to(tdt),
                                     torch.from_numpy(_WRAP_AND_NAN_IDS))
    assert got.dtype == tdt and tuple(got.shape) == (2, 5, D)
    # Bit-equal, NaN rows included (assert_array_equal treats NaN == NaN).
    np.testing.assert_array_equal(_np(got), _np(want))
    assert np.isnan(_np(got)[1, 1:4]).all() and not np.isnan(_np(got)[0]).any()


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_gather_plain_matches_pallas_interpret(ids_dtype):
    """In-range ids only: the Pallas kernel's DMA clamps other ids where
    jnp.take gives NaN (ROADMAP.md Queue 3), and the port follows jnp.take."""
    table = _table(1)
    ids = np.random.default_rng(2).integers(0, V, size=(3, 9)).astype(ids_dtype)
    want = pl_gather.embedding_gather(jnp.asarray(table),
                                      jnp.asarray(ids.astype(np.int32)),
                                      interpret=True)
    got = reference.embedding_gather(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gather_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    table = torch.from_numpy(_table())
    ids = torch.from_numpy(_WRAP_AND_NAN_IDS)
    before = cuda_gather.embedding_gather.launches
    got = cuda_gather.embedding_gather(table, ids)
    np.testing.assert_array_equal(_np(got), _np(cuda_gather.plain(table, ids)))
    assert cuda_gather.embedding_gather.launches == before


@pytest.mark.parametrize("use_pallas", [True, False])
def test_dispatch_gather_on_cpu_gives_plain(use_pallas):
    table = torch.from_numpy(_table())
    ids = torch.from_numpy(_WRAP_AND_NAN_IDS)
    got = dispatch.embedding_gather(table, ids, use_pallas=use_pallas)
    np.testing.assert_array_equal(_np(got), _np(reference.embedding_gather(table, ids)))


@pytest.mark.parametrize("table,ids,match", [
    (torch.zeros(7, 16, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), "dtype"),
    (torch.zeros(7), torch.zeros(3, dtype=torch.int32), r"\[V, D\]"),
    (torch.zeros(7, 6), torch.zeros(3, dtype=torch.int32), "16-byte"),
    (torch.zeros(7, 16), torch.zeros(3), "ids dtype"),
    (torch.zeros(16, 7).T, torch.zeros(3, dtype=torch.int32), "contiguous"),
    (torch.zeros(7, 16), torch.zeros(3, dtype=torch.int32, device="meta"), "ids on"),
])
def test_gather_kernel_rejects_what_it_cannot_take(table, ids, match):
    with pytest.raises(ValueError, match=match):
        cuda_gather.check_launchable(table, ids)


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------


def _gru_inputs(B=4, T=6, Din=8, H=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, Din)).astype(np.float32)
    h0 = (rng.normal(size=(B, H)) * 0.5).astype(np.float32)
    w_x = (rng.normal(size=(Din, 3 * H)) * 0.3).astype(np.float32)
    w_h = (rng.normal(size=(H, 3 * H)) * 0.3).astype(np.float32)
    b_x = (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
    b_h = (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
    reset = rng.integers(0, 2, size=(B, T)).astype(np.float32)
    return (x, h0, w_x, w_h, b_x, b_h), reset


def _torch(args, dtype=torch.float32):
    x, h0, *w = (torch.from_numpy(a) for a in args)
    return (x.to(dtype), h0.to(dtype), *w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_reset", [False, True])
def test_gru_plain_matches_xla(dtype, with_reset):
    jdt, tdt = DTYPES[dtype]
    args, reset = _gru_inputs()
    jx, jh0, *jw = (jnp.asarray(a) for a in args)
    ys_j, h_j = xla_ops.gru_scan(
        jx.astype(jdt), jh0.astype(jdt), *jw,
        reset_mask=jnp.asarray(reset) if with_reset else None)
    ys_t, h_t = reference.gru_scan(
        *_torch(args, tdt),
        reset_mask=torch.from_numpy(reset) if with_reset else None)
    assert ys_t.dtype == tdt and tuple(ys_t.shape) == (4, 6, 12)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(ys_t), _np(ys_j), **tol)
    np.testing.assert_allclose(_np(h_t), _np(h_j), **tol)


@pytest.mark.parametrize("with_reset", [False, True])
def test_gru_plain_matches_pallas_interpret(with_reset):
    args, reset = _gru_inputs(B=8, T=8, Din=16, H=16, seed=3)
    ys_p, h_p = pl_gru.gru_scan(
        *(jnp.asarray(a) for a in args),
        reset_mask=jnp.asarray(reset) if with_reset else None, interpret=True)
    ys_t, h_t = reference.gru_scan(
        *_torch(args), reset_mask=torch.from_numpy(reset) if with_reset else None)
    np.testing.assert_allclose(_np(ys_t), _np(ys_p), **F32_TOL)
    np.testing.assert_allclose(_np(h_t), _np(h_p), **F32_TOL)


def test_gru_plain_matches_torch_nn_gru():
    """Second oracle: nn.GRU has the same r|z|n blocks and the same
    r * (W_hn h + b_hn) candidate, with the weights transposed."""
    args, _ = _gru_inputs(seed=5)
    x, h0, w_x, w_h, b_x, b_h = _torch(args)
    cell = torch.nn.GRU(8, 12, batch_first=True)
    with torch.no_grad():
        cell.weight_ih_l0.copy_(w_x.T)
        cell.weight_hh_l0.copy_(w_h.T)
        cell.bias_ih_l0.copy_(b_x)
        cell.bias_hh_l0.copy_(b_h)
        want, h_last = cell(x, h0[None])
    ys, h = reference.gru_scan(x, h0, w_x, w_h, b_x, b_h)
    np.testing.assert_allclose(_np(ys), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(h), _np(h_last[0]), **F32_TOL)


def test_gru_without_biases_matches_xla():
    args, _ = _gru_inputs(seed=6)
    ys_j, _ = xla_ops.gru_scan(*(jnp.asarray(a) for a in args[:4]))
    ys_t, _ = reference.gru_scan(*_torch(args)[:4])
    np.testing.assert_allclose(_np(ys_t), _np(ys_j), **F32_TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_gru_dispatch_on_cpu_gives_plain_and_launches_nothing(use_pallas):
    args, reset = _gru_inputs(seed=7)
    before = cuda_gru.gru_scan.launches
    ys, h = dispatch.gru_scan(*_torch(args), reset_mask=torch.from_numpy(reset),
                              use_pallas=use_pallas)
    want, _ = reference.gru_scan(*_torch(args), reset_mask=torch.from_numpy(reset))
    np.testing.assert_array_equal(_np(ys), _np(want))
    np.testing.assert_array_equal(_np(h), _np(ys[:, -1]))
    assert cuda_gru.gru_scan.launches == before


def test_gru_launch_config_at_the_serving_shape():
    bf16 = cuda_gru.launch_config(64, 200, 128, 128, torch.bfloat16)
    assert bf16 == {"grid": 64, "threads": 128, "rows_per_block": 1,
                    "wx_in_smem": 1, "smem_bytes": 198144}
    f32 = cuda_gru.launch_config(64, 200, 128, 128, torch.float32)
    assert f32 == {"grid": 32, "threads": 128, "rows_per_block": 2,
                   "wx_in_smem": 0, "smem_bytes": 200704}
    for cfg in (bf16, f32):
        assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT


@pytest.mark.parametrize("shape,dtype,match", [
    ((4, 5, 8, 12), torch.float64, "dtype"),
    ((4, 5, 8, 10), torch.float32, "H % 4"),
    ((4, 5, 6, 12), torch.float32, "D\\*4 % 16"),
    ((4, 5, 8, 260), torch.float32, "H <= 256"),
    ((4, 5, 8, 256), torch.float32, "shared"),
    ((0, 5, 8, 12), torch.float32, "empty"),
])
def test_gru_kernel_rejects_what_it_cannot_take(shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        cuda_gru.launch_config(*shape, dtype)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [False, True])
def test_full_logits_matches_xla(with_bias):
    rng = np.random.default_rng(8)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    table = rng.normal(size=(11, 16)).astype(np.float32)
    bias = rng.normal(size=(11,)).astype(np.float32) if with_bias else None
    want = xla_ops.full_logits(jnp.asarray(h), jnp.asarray(table),
                               None if bias is None else jnp.asarray(bias))
    got = reference.full_logits(torch.from_numpy(h), torch.from_numpy(table),
                                None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
