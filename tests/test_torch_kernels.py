"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances: gather bit-exact, also when it writes the compute dtype
(against the plain gather cast with `.to`); GRU 1e-5 in f32 (same math, another summation
order) and 3e-2 in bf16 (the plain version rounds every gate op to bf16, the
kernel only the new h); the bf16 GRU and LSTM forwards' input projection
1e-5 (exact bf16 products summed in f32 on both sides, in another order).
Scatter-add 1e-5 against `index_put_` (the kernel
adds each row's terms in another, fixed order) and bit-exact against
`plain_ordered`, which adds in the kernel's order, and against itself from
run to run. Head 1e-5 (both sides multiply
in f32, bf16 inputs exactly, on the tensor cores in bf16; only the summation
order and the exponential's last bits differ). GRU and
LSTM backward 1e-4 (f32 carries over T steps, another summation order in
each step's dot product; the bf16-weight GRU and LSTM reverse recurrences
split their f32 cotangent into two bf16 terms for the tensor cores, which
keeps ~2^-17 of it). LSTM
forward 1e-5 in f32 and 5e-2 in bf16 (the plain version also rounds its
cell state to bf16 every step). The reset
variants keep their no-reset counterparts' tolerances, and with an all-zero
reset plane equal the no-reset kernels bit for bit (a multiply by 1.0). Attention
2e-5 in f32 (an online softmax sums in another order); in bf16 5e-2 against
the plain version, which rounds its scores to bf16, and 2e-2 against the
plain version in f32 on the same bf16 inputs (the kernel rounds only the
probabilities and the output to bf16)."""


import numpy as np
import pytest
import torch

from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops.cuda import attention as k_attn
from seqrec_tpu_torch.ops.cuda import gather as k_gather
from seqrec_tpu_torch.ops.cuda import gru as k_gru
from seqrec_tpu_torch.ops.cuda import head as k_head
from seqrec_tpu_torch.ops.cuda import lstm as k_lstm
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


@pytest.mark.parametrize("table_dtype,dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("V,D,shape", [(3418, 64, (128, 200)), (3418, 128, (64, 200)),
                                       (3418, 128, (256,)), (37, 8, (3, 9)),
                                       (37, 600, (5, 7)), (101, 200, (33,))])
def test_gather_kernel_writes_the_compute_dtype_bit_exact(cuda, table_dtype, dtype, ids_dtype,
                                                          V, D, shape):
    """The gather's output in the compute dtype equals the plain gather
    cast with `.to(dtype)` (f32 -> bf16 rounds to nearest even on both
    sides), NaN rows of out-of-range ids included, and the plain version
    with `dtype=` bit for bit: at the training
    and serving shapes (rows in groups of 8 at D=64, 4 at D=128), the 256
    negatives, a row of 16 bytes and rows longer than a warp's 128 vectors
    (D=600 in f32: two passes)."""
    rng = np.random.default_rng(V + D)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(cuda, table_dtype)
    ids = rng.integers(0, V, size=shape).reshape(-1)
    ids[:5] = [-1, -V, V, -V - 1, 10 ** 6][:min(5, ids.size)]
    ids = torch.from_numpy(ids.reshape(shape)).to(cuda, ids_dtype)
    before = k_gather.embedding_gather.launches
    got = k_gather.embedding_gather(table, ids, dtype=dtype)
    torch.cuda.synchronize()
    assert k_gather.embedding_gather.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (*shape, D)
    cast = k_gather.plain(table, ids).to(dtype)
    assert _nan_equal(got, cast)
    # Bit for bit, -0.0 and the NaN rows' words included, against the plain
    # version with the same dtype (its NaN rows made in that dtype).
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), k_gather.plain(table, ids, dtype=dtype).view(bits))
    flat = got.reshape(-1, D)
    assert bool(torch.isnan(flat[2:5]).all()) and not bool(torch.isnan(flat[:2]).any())


def test_gather_kernel_empty_ids_launch_nothing(cuda):
    table = torch.zeros(4, 16, device=cuda)
    before = k_gather.embedding_gather.launches
    out = k_gather.embedding_gather(table, torch.zeros(0, 3, dtype=torch.int64, device=cuda))
    assert tuple(out.shape) == (0, 3, 16)
    assert k_gather.embedding_gather.launches == before


def test_gather_kernel_raises_on_rows_it_cannot_take(cuda):
    """Rows of 24 bytes (D = 6 in f32), which the 16-byte design refused,
    launch in 8-byte units and give the plain version's bits; a table that
    is not a contiguous [V, D] still raises."""
    table = torch.arange(24, dtype=torch.float32, device=cuda).reshape(4, 6)
    ids = torch.tensor([3, 0, -1, 4], dtype=torch.int32, device=cuda)
    assert k_gather.check_launchable(table, ids)["unit_bytes"] == 8
    got = k_gather.embedding_gather(table, ids)
    assert _nan_equal(got, k_gather.plain(table, ids))
    with pytest.raises(ValueError, match="contiguous"):
        k_gather.embedding_gather(table.t(), ids)


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
                                     (7, 9, 64, 96), (3, 5, 16, 132), (4, 6, 32, 256),
                                     (128, 200, 64, 64), (64, 200, 64, 64),
                                     (128, 50, 256, 256)])
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


@pytest.mark.parametrize("dtype,cluster_size,rows", [
    (torch.float32, 2, 4), (torch.float32, 4, 8), (torch.float32, 8, 16),
    (torch.float32, 1, 16), (torch.float32, 8, 4), (torch.bfloat16, None, None)])
def test_gru_kernel_every_row_tiling(cuda, dtype, cluster_size, rows, monkeypatch):
    """B not a multiple of the rows a block or cluster leaves the last one's
    spare rows unwritten: each design's tilings (f32: clusters of 1 to 8
    CTAs over 4, 8 or 16 rows; bf16: its one n8 tile of 8), at B=11 and
    B=21."""
    if rows is not None:
        real = k_gru.launch_config
        monkeypatch.setattr(k_gru, "launch_config", lambda *a, **kw: real(
            *a, rows_per_cluster=rows, cluster_size=cluster_size))
    for B in (11, 21):
        args = _gru_args(B, 6, 32, 32, dtype, cuda, seed=B)
        ys = torch.full((B, 6, 32), float("nan"), dtype=dtype, device=cuda)
        ys.copy_(k_gru.gru_scan(*args)[0])
        want, _ = k_gru.plain(*args)
        torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,T,D,N3", [(64, 200, 128, 384), (256, 50, 100, 300), (3, 5, 4, 12),
                                      (2, 70, 200, 132)])
def test_gru_input_projection_kernel_matches_plain(cuda, B, T, D, N3):
    """The bf16 forward's input projection: ragged row and column tiles, D not
    a multiple of 16 or of the 64-deep chunk (8-byte pieces, zero-filled);
    exact bf16 products summed in f32 on both sides."""
    rng = np.random.default_rng(B + D)
    x = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32)).to(cuda).bfloat16()
    w_x = torch.from_numpy((rng.normal(size=(D, N3)) * D ** -0.5).astype(np.float32))
    w_x = w_x.to(cuda).bfloat16()
    b_x = torch.from_numpy(rng.normal(size=N3).astype(np.float32)).to(cuda)
    before = k_gru.gru_input_projection.launches
    got = k_gru.gru_input_projection(x, w_x, b_x)
    torch.cuda.synchronize()
    assert k_gru.gru_input_projection.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, N3)
    torch.testing.assert_close(got, k_gru.plain_input_projection(x, w_x, b_x),
                               rtol=1e-5, atol=1e-5)


def _reset_plane(B, T, device, seed=0):
    """A session start about every 6 positions, and one at t=0 in row 0."""
    rng = np.random.default_rng(seed)
    reset = (rng.random((B, T)) < 1 / 6).astype(np.float32)
    reset[0, 0] = 1.0
    return torch.from_numpy(reset).to(device)


def test_gru_kernel_without_biases_and_raises_on_reset(cuda):
    """Without biases the kernel matches the plain scan; a reset plane runs
    the reset variant (which raised before session-parallel training was
    ported) and matches the plain scan; a plane it cannot take raises, and
    H = 6 (refused before) takes the padded route."""
    x, h0, w_x, w_h, _, _ = _gru_args(4, 5, 16, 16, torch.float32, cuda, seed=2)
    ys, _ = k_gru.gru_scan(x, h0, w_x, w_h)
    want, _ = k_gru.plain(x, h0, w_x, w_h)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    reset = _reset_plane(4, 5, cuda)
    before = (k_gru.gru_scan.launches, k_gru.gru_scan.reset_launches)
    ys, _ = k_gru.gru_scan(x, h0, w_x, w_h, reset_mask=reset)
    assert (k_gru.gru_scan.launches, k_gru.gru_scan.reset_launches) == (before[0],
                                                                         before[1] + 1)
    want, _ = k_gru.plain(x, h0, w_x, w_h, reset_mask=reset)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="keep plane"):
        k_gru.gru_scan(x, h0, w_x, w_h, reset_mask=reset[:, :4])
    before = k_gru.gru_scan.padded_launches
    ys, _ = k_gru.gru_scan(x, h0[:, :6], w_x[:, :18], w_h[:6, :18])
    assert k_gru.gru_scan.padded_launches == before + 1 and tuple(ys.shape) == (4, 5, 6)
    want, _ = k_gru.plain(x, h0[:, :6], w_x[:, :18], w_h[:6, :18])
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)


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


def _zipf_ids(rng, n, V, pad_share=0.0):
    p = 1.0 / np.arange(1, V)
    ids = rng.choice(np.arange(1, V), size=n, p=p / p.sum())
    ids[rng.random(n) < pad_share] = 0  # the padding id's positions
    return ids


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,V,D,pad_share", [(25_600, 3_418, 128, 0.0),
                                             (25_600, 3_418, 128, 0.5),
                                             (6_400, 12_102, 256, 0.3),
                                             (12_800, 37_484, 100, 0.0),
                                             (51_200, 500, 30, 0.9),
                                             (1, 5, 4, 0.0), (777, 3, 7, 0.0)])
def test_scatter_add_kernel_is_deterministic_and_plain_ordered(cuda, ids_dtype, n, V, D,
                                                              pad_share):
    """Zipf(1.0) ids (the head item about a tenth of them), a padding row
    with `pad_share` of the positions (runs far longer than a chunk's
    sub-runs), planted out-of-range ids: two runs give equal bits, equal to
    `plain_ordered` (the kernel's order in plain tensor code) bit for bit,
    in two launches and no memset."""
    rng = np.random.default_rng(n + D)
    ids = _zipf_ids(rng, n, V, pad_share)
    ids[:min(n, 5)] = [-1, -V, V, -V - 1, 10 ** 6][:min(n, 5)]
    ids = torch.from_numpy(ids).to(cuda, ids_dtype)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(n, D)).astype(np.float32)).to(cuda)
    before = k_gather.embedding_scatter_add.launches
    a = k_gather.embedding_scatter_add(g, ids, V)
    b = k_gather.embedding_scatter_add(g, ids, V)
    torch.cuda.synchronize()
    assert k_gather.embedding_scatter_add.launches == before + 2
    assert torch.equal(a, b)
    plan = k_gather.scatter_add_plan(n, V, D)
    assert plan["launches"] == 2
    assert torch.equal(a, k_gather.plain_ordered(g, ids, V, plan["chunk"]))
    torch.testing.assert_close(a, k_gather.plain_backward(g, ids, V), rtol=1e-5, atol=1e-5)


def test_scatter_add_kernel_every_id_one_row_and_an_empty_table_row(cuda):
    """Every position on one table row (one run over every chunk), and rows
    no id reaches written as zeros without a memset."""
    V, n, D = 9, 5_000, 128
    g = torch.randn(n, D, generator=torch.Generator().manual_seed(0)).to(cuda)
    ids = torch.full((n,), 4, dtype=torch.int64, device=cuda)
    out = k_gather.embedding_scatter_add(g, ids, V)
    chunk = k_gather.scatter_add_plan(n, V, D)["chunk"]
    assert torch.equal(out, k_gather.plain_ordered(g, ids, V, chunk))
    assert not bool(out[torch.arange(V, device=cuda) != 4].any())


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row0", [0, 37, 2 ** 31 - 1 - 200])
def test_gather_window_kernel_is_bit_exact(cuda, dtype, ids_dtype, row0):
    """The shard-window variant: ids in [row0, row0 + rows) read row
    id - row0, every other id (below, above, negative) a zero row; bit for
    bit against its plain version, in f32 and bf16."""
    rows, D = 64, 128
    shard = torch.randn(rows, D, device=cuda)
    ids = torch.randint(max(row0 - 80, -5), row0 + rows + 80, (7, 41), device=cuda).to(ids_dtype)
    before = k_gather.embedding_gather_window.launches
    got = k_gather.embedding_gather_window(shard, ids, row0, dtype=dtype)
    assert k_gather.embedding_gather_window.launches == before + 1
    want = reference.embedding_gather_window(shard, ids, row0, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                                       else torch.int32),
                                              want.view(torch.int16 if dtype == torch.bfloat16
                                                        else torch.int32))
    local = ids.long() - row0
    assert not bool(got[(local < 0) | (local >= rows)].any())


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,rows,D", [(25_600, 1712, 128), (700, 50, 64), (3, 10, 4)])
def test_scatter_add_window_kernel_is_plain_ordered_and_deterministic(cuda, ids_dtype, g_dtype,
                                                                      n, rows, D):
    """The window scatter-add adds only the window's ids, at id - row0, in
    the scatter-add's order: bit for bit against plain_ordered_window and
    against itself."""
    row0 = rows
    ids = torch.randint(-3, 3 * rows, (n,), device=cuda).to(ids_dtype)
    g = torch.randn(n, D, device=cuda).to(g_dtype)
    before = k_gather.embedding_scatter_add_window.launches
    a = k_gather.embedding_scatter_add_window(g, ids, row0, rows)
    b = k_gather.embedding_scatter_add_window(g, ids, row0, rows)
    assert k_gather.embedding_scatter_add_window.launches == before + 2
    assert torch.equal(a, b)
    chunk = k_gather.scatter_add_plan(n, rows, D)["chunk"]
    assert torch.equal(a, k_gather.plain_ordered_window(g, ids, row0, rows, chunk))
    want = reference.embedding_scatter_add_window(g, ids, row0, rows)
    assert torch.allclose(a, want, rtol=1e-5, atol=1e-5)


def test_window_kernels_raise_on_a_window_they_cannot_take(cuda):
    shard = torch.zeros(8, 4, device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shard window"):
        k_gather.embedding_gather_window(shard, ids, -1)
    with pytest.raises(ValueError, match="shard window"):
        k_gather.embedding_scatter_add_window(torch.zeros(3, 4, device=cuda), ids, 2 ** 31, 8)


@pytest.mark.parametrize("n,D,chunk", [(1, 4, 256), (12_800, 100, 256), (25_600, 128, 512)])
def test_scatter_add_scratch_is_sized_and_checked_in_c(cuda, n, D, chunk):
    """gather.cu owns the scratch layout: its size holds a partial row and
    a run pair a position, 2 * chunk / 32 sub-run rows and a 1,025-int
    directory a chunk; a launch given a byte less refuses and writes
    nothing, and one given the size runs."""
    lib = k_gather._lib()
    chunks = -(-n // chunk)
    nbytes = lib.seqrec_scatter_add_scratch_bytes(n, D, chunk)
    assert nbytes >= chunks * (chunk * D * 4 + chunk // 16 * D * 4 + chunk * 8 + 1025 * 4)
    assert lib.seqrec_scatter_add_scratch_bytes(n, D, 128) == -1
    g = torch.ones(n, D, device=cuda)
    ids = torch.full((n,), 3, dtype=torch.int32, device=cuda)
    out = torch.full((9, D), 7.0, device=cuda)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (g.data_ptr(), 0, ids.data_ptr(), 0, n, 9, D, chunk, scratch.data_ptr())
    assert lib.seqrec_scatter_add_rows(*args, nbytes - 1, out.data_ptr(), stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert lib.seqrec_scatter_add_rows(*args, nbytes, out.data_ptr(), stream) == 0
    assert torch.equal(out, k_gather.plain_ordered(g, ids, 9, chunk))


@pytest.mark.parametrize("n,V,D,pad_share", [(25_600, 3_418, 64, 0.5), (25_600, 3_418, 128, 0.0),
                                             (256, 3_418, 64, 0.0), (777, 3, 7, 0.0),
                                             (12_800, 37_484, 100, 0.0)])
def test_scatter_add_kernel_takes_a_bf16_cotangent(cuda, n, V, D, pad_share):
    """A bf16 cotangent (the bf16 paths' gather output's) is widened to f32
    by the kernel's loads: the result equals the same call on its f32
    widening bit for bit, and `plain_ordered` on it, and two runs agree."""
    rng = np.random.default_rng(n + D)
    ids = torch.from_numpy(_zipf_ids(rng, n, V, pad_share)).to(cuda)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(n, D)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    a = k_gather.embedding_scatter_add(g, ids, V)
    b = k_gather.embedding_scatter_add(g, ids, V)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, k_gather.embedding_scatter_add(g.float(), ids, V))
    chunk = k_gather.scatter_add_plan(n, V, D)["chunk"]
    assert torch.equal(a, k_gather.plain_ordered(g.float(), ids, V, chunk))


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
    """The reverse recurrence's operands: the two f32 projections x_proj and
    h_proj [B, T, 3H] (biases included), h_in, g_ys and W_h in `dtype`."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.5).astype(np.float32)).to(device)

    x_proj, h_proj = t(B, T, 3 * H) * 2, t(B, T, 3 * H) * 2
    h_in = torch.tanh(t(B, T, H)).to(dtype)
    g = t(B, T, H).to(dtype)
    w_h = (t(H, 3 * H) * H ** -0.5).to(dtype)
    return x_proj, h_proj, h_in, g, w_h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,R", [(5, 7, 32, None), (3, 1, 16, None),
                                     (128, 50, 128, None), (11, 9, 64, 8),
                                     (4, 6, 256, None), (128, 200, 64, None),
                                     (128, 50, 256, None)])
def test_gru_backward_kernel_matches_plain(cuda, dtype, B, T, H, R, monkeypatch):
    """bf16 weights run the tensor-core design (8 rows a block, no row
    choice), f32 weights the cluster design (also at 8 rows a cluster)."""
    if R is not None and dtype == torch.float32:
        real = k_gru.backward_launch_config
        monkeypatch.setattr(k_gru, "backward_launch_config",
                            lambda *a, **kw: real(*a, rows_per_cluster=R))
    planes = _gate_planes(B, T, H, dtype, cuda, seed=B + T)
    before = k_gru.gru_backward.launches
    got = k_gru.gru_backward(*planes)
    torch.cuda.synchronize()
    assert k_gru.gru_backward.launches == before + 1
    for name, a, b in zip(("d_xp", "dh0", "dn_r"), got, k_gru.plain_backward(*planes)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


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


@pytest.mark.parametrize("T", [1, 2, 50, 200])
@pytest.mark.parametrize("H", [100, 128, 132, 256])
@pytest.mark.parametrize("with_keep", [False, True])
def test_gru_bf16_backward_kernel_padding_and_ragged_rows(cuda, T, H, with_keep):
    """The tensor-core reverse recurrence (the gates recomputed inside,
    d_hproj split into two bf16 terms) at rsc15's width (H = 100 pads to
    128), the training width, and widths past the registers' (fragments
    read every step), B = 11 (a ragged block): d_xp, dh0 and dn_r within
    1e-4 of the plain f32 loop, relative to their largest values. With a
    keep plane h_in comes in f32, scaled, as `gru_bwd_project` hands it
    over: an all-ones plane gives the no-keep kernel's bits on the same
    operands, and a reset at t=0 zeroes dh0."""
    B = 11
    x_proj, h_proj, h_in, g, w_h = _gate_planes(B, T, H, torch.bfloat16, cuda, seed=T + H)
    keep = None
    if with_keep:
        keep = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]
        h_in = h_in.float() * keep
    planes = (x_proj, h_proj, h_in, g, w_h)
    assert k_gru.backward_launch_config(B, T, H, w_h.dtype, h_in_dtype=h_in.dtype)[
        "design"] == "mma.sync"
    counter = "launches" if keep is None else "reset_launches"
    before = getattr(k_gru.gru_backward, counter)
    got = k_gru.gru_backward(*planes, keep)
    torch.cuda.synchronize()
    assert getattr(k_gru.gru_backward, counter) == before + 1
    for name, a, b in zip(("d_xp", "dh0", "dn_r"), got, k_gru.plain_backward(*planes, keep)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item(), msg=name)
    if with_keep:
        for a, b in zip(k_gru.gru_backward(*planes, torch.ones_like(keep)),
                        k_gru.gru_backward(*planes)):
            assert torch.equal(a, b)
        keep[:, 0] = 0.0
        assert not bool(k_gru.gru_backward(*planes, keep)[1].any())


WIDE_SHAPES = [(H, B, T) for H in (136, 200, 256) for B in (3, 64, 128) for T in (1, 10, 50)]


@pytest.mark.parametrize("with_reset", [False, True])
@pytest.mark.parametrize("H,B,T", WIDE_SHAPES)
def test_gru_bf16_wide_forward_matches_plain_twice(cuda, H, B, T, with_reset):
    """The bf16 forward above Hp = 128 (clusters of 4 CTAs, W_h^T split by
    units, h exchanged through distributed shared memory): widths padded to
    256 from 136 and 200, a ragged cluster (B = 3), serving's B = 64 and
    training's B = 128, one step and beauty's buckets. Within the bf16
    tolerance of the plain version, and two launches agree bit for bit."""
    args = _gru_args(B, T, H, H, torch.bfloat16, cuda, seed=H + B + T)
    reset = _reset_plane(B, T, cuda, seed=H) if with_reset else None
    assert k_gru.launch_config(B, T, H, H, torch.bfloat16)["layout"] == "cluster"
    counter = "reset_launches" if with_reset else "launches"
    before = [getattr(k_gru.gru_scan, c) for c in (counter, "wide_launches")]
    ys = k_gru.gru_scan(*args, reset_mask=reset)[0]
    again = k_gru.gru_scan(*args, reset_mask=reset)[0]
    torch.cuda.synchronize()
    assert [getattr(k_gru.gru_scan, c) for c in (counter, "wide_launches")] == [
        n + 2 for n in before]
    assert torch.equal(ys, again)
    want, _ = k_gru.plain(*args, reset_mask=reset)
    torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("h_in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,B,T", WIDE_SHAPES)
def test_gru_bf16_wide_backward_matches_plain_twice(cuda, H, B, T, h_in_dtype, with_keep):
    """The bf16-weight reverse recurrence above Hp = 128 (clusters of 4 CTAs,
    K split between them, the partial sums of dh_prev exchanged through
    distributed shared memory), h_in in bf16 or f32, with and without a keep
    plane: d_xp, dh0 and dn_r within 1e-4 of the plain f32 loop relative to
    their largest values, and two launches bit for bit."""
    x_proj, h_proj, h_in, g, w_h = _gate_planes(B, T, H, torch.bfloat16, cuda, seed=H + B + T)
    keep = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None] if with_keep else None
    h_in = h_in.to(h_in_dtype) if keep is None else (h_in.float() * keep).to(h_in_dtype)
    planes = (x_proj, h_proj, h_in, g, w_h)
    assert k_gru.backward_launch_config(B, T, H, w_h.dtype, h_in_dtype=h_in_dtype)[
        "layout"] == "cluster"
    counter = "launches" if keep is None else "reset_launches"
    before = [getattr(k_gru.gru_backward, c) for c in (counter, "wide_launches")]
    got = k_gru.gru_backward(*planes, keep)
    again = k_gru.gru_backward(*planes, keep)
    torch.cuda.synchronize()
    assert [getattr(k_gru.gru_backward, c) for c in (counter, "wide_launches")] == [
        n + 2 for n in before]
    for name, a, b, c in zip(("d_xp", "dh0", "dn_r"), got, again,
                             k_gru.plain_backward(*planes, keep)):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(), msg=name)


def test_gru_bf16_wide_autograd_at_beauty_matches_plain(cuda):
    """gru_scan's autograd end to end at configs/beauty_gru.json's step (B=128,
    T=50, D=H=256, bf16): one forward and one reverse launch, each gradient
    within 2^-7 (relative to its largest value, chip_smoke's
    GRU_BWD_BF16_W_TOL) of reference.gru_bwd_math's (the plain reverse loop
    on the kernel forward's states), every gradient rounded to bf16 as the
    autograd path does; twice bit for bit."""
    B, T, D, H = 128, 50, 256, 256
    args = _gru_args(B, T, D, H, torch.bfloat16, cuda, seed=7)
    g = torch.from_numpy(np.random.default_rng(8).normal(scale=1e-2, size=(B, T, H))
                         .astype(np.float32)).to(cuda).bfloat16()
    x, h0, w_x, w_h, b_x, b_h = args

    def grads():
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, h0, w_x, w_h)]
        ys = k_gru.gru_scan(*leaves, b_x, b_h)[0]
        ys.backward(g)
        return ys.detach(), [t.grad for t in leaves]

    counts = lambda: (k_gru.gru_scan.launches, k_gru.gru_backward.launches,  # noqa: E731
                      k_gru.gru_scan.wide_launches, k_gru.gru_backward.wide_launches)
    before = counts()
    ys, got = grads()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)
    ys2, got2 = grads()
    assert torch.equal(ys, ys2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    wx_c, wh_c = w_x.bfloat16(), w_h.bfloat16()
    x_proj = torch.matmul(x.float(), wx_c.float()) + b_x
    d_xp, dh0, dwh, _ = reference.gru_bwd_math(x_proj, ys, h0, wh_c, b_h, g, None)
    want = [t.bfloat16() for t in (torch.matmul(d_xp, wx_c.float().T), dh0,
                                   torch.einsum("btd,btk->dk", x.float(), d_xp), dwh)]
    for name, a, b in zip(("x", "h0", "w_x", "w_h"), got, want):
        err = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        assert err <= 2 ** -7, (name, err)


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
                                   (5, 1, 8), (130, 600, 128), (25_600, 256, 64)])
def test_head_kernel_matches_plain(cuda, dtype, N, S, H):
    """Both designs stream their negatives and take every shape here."""
    args = _head_args(N, S, H, dtype, cuda, seed=N + S)
    before = k_head.sampled_softmax_nll.launches
    got = k_head.sampled_softmax_nll(*args)
    torch.cuda.synchronize()
    assert k_head.sampled_softmax_nll.launches == before + 1
    want = k_head.plain(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,S,H", [(6_400, 256, 256), (300, 2_048, 128), (257, 100, 100),
                                   (25_600, 256, 128), (65, 129, 4), (64, 128, 252)])
def test_head_f32_kernel_streams_any_s_and_a_row_of_only_hits(cuda, N, S, H):
    """The f32 SIMT design at beauty's width (N = 6,400, S = 256, H = 256,
    which the first f32 design refused), at S = 2,048, and ragged (N not a
    multiple of its 64-row block, S of its 128-negative tile, H of its
    32-deep k chunk): the NLL within 1e-4 of the plain version (HEAD_TOL).
    Row 3's target is every negative's id: its NLL is 0 on both sides."""
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(N, S, H, torch.float32, cuda,
                                                         seed=N + S)
    neg_ids[:] = 3 * S + 1
    targets[3] = 3 * S + 1
    assert k_head.launch_config(N, S, H, torch.float32)["design"] == "simt-stream"
    before = k_head.sampled_softmax_nll.launches
    got = k_head.sampled_softmax_nll(h, pos, neg, targets, neg_ids, plq, nlq)
    torch.cuda.synchronize()
    assert k_head.sampled_softmax_nll.launches == before + 1
    want = k_head.plain(h, pos, neg, targets, neg_ids, plq, nlq)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert got[3].item() == 0.0 and want[3].item() == 0.0


@pytest.mark.parametrize("N,S,H", [(300, 100, 128), (25_600, 256, 128), (129, 2048, 128),
                                   (77, 1, 64), (5, 65, 8), (6_400, 256, 256)])
def test_head_bf16_kernel_ragged_tiles_and_a_row_of_only_hits(cuda, N, S, H):
    """The tensor-core head with N not a multiple of its 128-row block, S
    not a multiple of its 64-negative tile (and S = 2048, past what one
    block could stage), H padded to 16, and beauty's step (H = 256): the
    NLL within 1e-5 of the plain version. Row 3's target is every negative's id, so all its negatives
    are accidental hits: its NLL is 0 on both sides."""
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(N, S, H, torch.bfloat16, cuda,
                                                         seed=N + S)
    neg_ids[:] = 3 * S + 1  # an id no other row's target takes
    targets[3] = 3 * S + 1
    before = k_head.sampled_softmax_nll.launches
    got = k_head.sampled_softmax_nll(h, pos, neg, targets, neg_ids, plq, nlq)
    torch.cuda.synchronize()
    assert k_head.sampled_softmax_nll.launches == before + 1
    want = k_head.plain(h, pos, neg, targets, neg_ids, plq, nlq)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert got[3].item() == 0.0 and want[3].item() == 0.0


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


def test_head_f32_kernel_takes_views_off_a_16_byte_boundary(cuda):
    """h and pos_emb as views that start 4 bytes past a 16-byte boundary
    (the f32 design reads aligned ones in float4s): the kernel reads them a
    float at a time, no copy, and the NLL equals the one of aligned copies
    bit for bit (the same products summed in the same order)."""
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(70, 130, 64, torch.float32, cuda)
    flat_h = torch.empty(70 * 64 + 1, device=cuda)
    flat_p = torch.empty(70 * 64 + 1, device=cuda)
    flat_h[1:] = h.reshape(-1)
    flat_p[1:] = pos.reshape(-1)
    hv, pv = flat_h[1:].view(70, 64), flat_p[1:].view(70, 64)
    assert hv.data_ptr() % 16 and pv.data_ptr() % 16
    assert k_head.check_launchable(hv, pv, neg, targets, neg_ids, plq, nlq)[
        "pos_unit_bytes"] == 4
    got = k_head.sampled_softmax_nll(hv, pv, neg, targets, neg_ids, plq, nlq)
    want = k_head.sampled_softmax_nll(h, pos, neg, targets, neg_ids, plq, nlq)
    assert torch.equal(got, want)


def test_head_kernel_raises_on_what_it_cannot_take(cuda):
    """2,000 negatives (past what the first f32 design could stage) launch;
    an f32 width not a multiple of 4 (H = 30), which the float4 design
    refused, launches too, and so does H = 260 (the K split) and a width
    past the K split's limit (1,376 in f32: the streamed layout, within the
    K split's f32 1e-4); operands of two dtypes raise."""
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(8, 16, 32, torch.float32, cuda)
    many = (torch.randn(2000, 32, device=cuda) * 0.1,
            torch.arange(2000, dtype=torch.int32, device=cuda) + 1000,
            torch.zeros(2000, device=cuda))
    got = k_head.sampled_softmax_nll(h, pos, many[0], targets, many[1], plq, many[2])
    torch.testing.assert_close(got, k_head.plain(h, pos, many[0], targets, many[1], plq,
                                                 many[2]), rtol=1e-5, atol=1e-5)
    for width, match in ((1380, "H <= 1376"), (30, None), (260, None)):
        a = _head_args(8, 16, width, torch.float32, cuda)
        if match is None:
            torch.testing.assert_close(k_head.sampled_softmax_nll(*a), k_head.plain(*a),
                                       rtol=1e-5, atol=1e-5)
            continue
        before = k_head.sampled_softmax_nll.streamed_launches
        torch.testing.assert_close(k_head.sampled_softmax_nll(*a), k_head.plain(*a),
                                   rtol=1e-4, atol=1e-4)
        assert k_head.sampled_softmax_nll.streamed_launches == before + 1
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
    from seqrec_tpu_torch.train.state import clone_state
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


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_train_step_multi_is_bitwise_reproducible(cuda, compute_dtype):
    """Two K=4 groups through the kernels from one cloned state on one batch
    group give the same parameters and optimizer state bit for bit (the
    scatter-add is deterministic; cuBLAS on one stream is)."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.train.state import clone_state
    from seqrec_tpu_torch.train.trainer import Trainer

    class DS:
        vocab_size, num_users = 80, 0

    rng = np.random.default_rng(1)
    tokens = np.zeros((4, 8, 22), np.int16)
    for k in range(4):
        for r in range(8):
            n = rng.integers(3, 21)
            tokens[k, r, :n + 1] = rng.integers(1, 80, size=n + 1)
    cfg = RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(
        ["model.embed_dim=32", "model.num_negatives=50", "data.max_len=20",
         f"model.compute_dtype={compute_dtype}"])
    tr = Trainer(cfg, DS(), device=cuda)
    state = tr.init_state(3)
    runs = []
    for _ in range(2):
        runs.append(tr.train_step_multi(clone_state(state), tokens)[0])
    a, b = runs
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for moment in ("mu", "nu"):
        for k in a.opt_state[moment]:
            assert torch.equal(a.opt_state[moment][k], b.opt_state[moment][k]), (moment, k)


# ---------------------------------------------------------------------------
# The SASRec and LSTM towers' kernels: causal attention, LSTM scan and its
# reverse recurrence
# ---------------------------------------------------------------------------


def _qkv(B, T, N, Dh, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, T, N, Dh)).astype(np.float32))
                 .to(device, dtype) for _ in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,N,Dh", [(2, 50, 2, 32), (3, 200, 1, 64), (2, 64, 1, 16),
                                      (1, 7, 2, 256), (4, 129, 3, 8)])
def test_attention_kernel_matches_plain(cuda, dtype, B, T, N, Dh):
    q, k, v = _qkv(B, T, N, Dh, dtype, cuda, seed=T + Dh)
    before = k_attn.causal_attention.launches
    got = k_attn.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert k_attn.causal_attention.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, T, N, Dh)
    want = k_attn.plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)
        exact = k_attn.plain(q.float(), k.float(), v.float())
        torch.testing.assert_close(got.float(), exact, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("Dh", [8, 24, 64])
def test_attention_kernel_ragged_tails(cuda, dtype, T, Dh):
    """T around the 64-row tile (the last tile's rows past T are zero-filled,
    never written) and head dims the bf16 kernel pads to mma's depth."""
    q, k, v = _qkv(2, T, 2, Dh, dtype, cuda, seed=T * Dh)
    got = k_attn.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, k_attn.plain(q, k, v), rtol=2e-5, atol=2e-5)
    else:
        exact = k_attn.plain(q.float(), k.float(), v.float())
        torch.testing.assert_close(got.float(), exact, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_reads_qkv_slices_in_place_and_keeps_causality(cuda, dtype):
    """q, k, v as strided slices of one [B, T, 3, N, Dh] projection (the
    SASRec block's layout, a row stride of 3 N Dh), a custom scale, and no
    leak from future keys."""
    B, T, N, Dh = 3, 70, 2, 32
    qkv = torch.randn(B, T, 3, N, Dh, generator=torch.Generator().manual_seed(0))
    qkv = qkv.to(cuda, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    assert k_attn._kernel_view(q).data_ptr() == q.data_ptr()  # read in place
    got = k_attn.causal_attention(q, k, v, scale=0.3)
    if dtype == torch.float32:
        torch.testing.assert_close(got, k_attn.plain(q, k, v, scale=0.3), rtol=2e-5, atol=2e-5)
    else:
        exact = k_attn.plain(q.float(), k.float(), v.float(), scale=0.3)
        torch.testing.assert_close(got.float(), exact, rtol=2e-2, atol=2e-2)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 0.0
    v2[:, 40:] = -5.0
    again = k_attn.causal_attention(q, k2, v2, scale=0.3)
    assert torch.equal(got[:, :40], again[:, :40])
    assert not torch.allclose(got[:, 40:], again[:, 40:])


def test_attention_autograd_with_the_kernel_matches_plain_autograd(cuda):
    leaves = [t.detach().requires_grad_(True) for t in _qkv(2, 90, 2, 32, torch.float32, cuda)]
    g = torch.randn(2, 90, 2, 32, device=cuda)
    before = k_attn.causal_attention.launches
    (k_attn.causal_attention(*leaves) * g).sum().backward()
    assert k_attn.causal_attention.launches == before + 1
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    (k_attn.plain(*leaves) * g).sum().backward()
    for name, a, t in zip("qkv", got, leaves):
        torch.testing.assert_close(a, t.grad, rtol=1e-4, atol=1e-4, msg=f"d{name}")


def test_attention_kernel_raises_on_what_it_cannot_take(cuda):
    q, k, v = _qkv(2, 8, 1, 264, torch.float32, cuda)  # refused before: the sliced layout
    before = k_attn.causal_attention.sliced_launches
    torch.testing.assert_close(k_attn.causal_attention(q, k, v), k_attn.plain(q, k, v),
                               rtol=2e-5, atol=2e-5)
    assert k_attn.causal_attention.sliced_launches == before + 1
    q, k, v = _qkv(2, 8, 1, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="does not match"):
        k_attn.causal_attention(q, k.bfloat16(), v)


def _lstm_args(B, T, D, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    return (t(B, T, D).to(dtype), (t(B, H) * 0.5).to(dtype), (t(B, H) * 0.5).to(dtype),
            t(D, 4 * H, scale=D ** -0.5), t(H, 4 * H, scale=H ** -0.5), t(4 * H, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", [(5, 7, 16, 32), (3, 1, 32, 16), (64, 50, 128, 128),
                                     (7, 9, 64, 96), (4, 6, 32, 256)])
def test_lstm_kernel_matches_plain(cuda, dtype, B, T, D, H):
    args = _lstm_args(B, T, D, H, dtype, cuda, seed=B + T)
    before = k_lstm.lstm_scan.launches
    ys, (h, c) = k_lstm.lstm_scan(*args)
    torch.cuda.synchronize()
    assert k_lstm.lstm_scan.launches == before + 1
    want, (_, c_want) = k_lstm.plain(*args)
    assert ys.dtype == c.dtype == dtype and tuple(ys.shape) == (B, T, H)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(ys.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c.float(), c_want.float(), rtol=tol, atol=tol)
    assert torch.equal(h, ys[:, -1])


@pytest.mark.parametrize("dtype,cluster_size,rows", [
    (torch.float32, C, R) for C in (2, 4, 8) for R in (4, 8, 16)] + [(torch.bfloat16, None, None)])
def test_lstm_kernel_every_layout_and_the_cell_plane(cuda, cluster_size, rows, dtype,
                                                     monkeypatch):
    """Each design's row tilings (B not a multiple of R) at H=128 (f32: every
    cluster size and rows a cluster that fits, W_h's slice in registers at
    4 CTAs and up to 8 rows; bf16: its one n8 tile of 8); the cell plane the
    kernel writes for the backward equals the plain serial recompute."""
    args = [a.detach() for a in _lstm_args(11, 6, 128, 128, dtype, cuda, seed=1)]
    if rows is not None:
        real = k_lstm.launch_config
        monkeypatch.setattr(k_lstm, "launch_config", lambda *a, **kw: real(
            *a, rows_per_cluster=rows, cluster_size=cluster_size))
    ys, c_last, cs = k_lstm._forward_kernel(
        args[0], args[1], args[2], args[3].to(dtype), args[4].to(dtype), args[5], True)
    want, _ = k_lstm.plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(ys.float(), want.float(), rtol=tol, atol=tol)
    x_proj = torch.matmul(args[0].float(), args[3].to(dtype).float()) + args[5]
    cells = reference.lstm_recompute_cells(x_proj, ys, args[1], args[2], args[4].to(dtype))
    torch.testing.assert_close(cs, cells, rtol=1e-4, atol=1e-4)
    assert torch.equal(c_last, cs[:, -1])


def test_lstm_kernel_raises_on_reset_and_bad_shapes(cuda):
    """A reset plane runs the reset variant (which raised before
    session-parallel training was ported) and matches the plain scan, c_T
    included; a plane it cannot take raises, and H = 6 (refused before)
    takes the padded route."""
    x, h0, c0, w_x, w_h, b = _lstm_args(4, 5, 16, 16, torch.float32, cuda, seed=2)
    reset = _reset_plane(4, 5, cuda)
    before = (k_lstm.lstm_scan.launches, k_lstm.lstm_scan.reset_launches)
    ys, (_, c) = k_lstm.lstm_scan(x, h0, c0, w_x, w_h, b, reset_mask=reset)
    assert (k_lstm.lstm_scan.launches, k_lstm.lstm_scan.reset_launches) == (before[0],
                                                                             before[1] + 1)
    want, (_, c_want) = k_lstm.plain(x, h0, c0, w_x, w_h, b, reset_mask=reset)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, c_want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="keep plane"):
        k_lstm.lstm_scan(x, h0, c0, w_x, w_h, b, reset_mask=reset[:1])
    before = k_lstm.lstm_scan.padded_launches
    ys, (_, c) = k_lstm.lstm_scan(x, h0[:, :6], c0[:, :6], w_x[:, :24], w_h[:6, :24])
    assert k_lstm.lstm_scan.padded_launches == before + 1 and tuple(c.shape) == (4, 6)
    want, (_, c_want) = k_lstm.plain(x, h0[:, :6], c0[:, :6], w_x[:, :24], w_h[:6, :24])
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, c_want, rtol=1e-5, atol=1e-5)


def _lstm_planes(B, T, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, lo=False):
        a = rng.uniform(0.05, 0.95, size=shape) if lo else rng.normal(size=shape) * 0.5
        return torch.from_numpy(a.astype(np.float32)).to(device)

    i, f, o = t(B, T, H, lo=True), t(B, T, H, lo=True), t(B, T, H, lo=True)
    g, tanh_c = torch.tanh(t(B, T, H)), torch.tanh(t(B, T, H))
    c_in = t(B, T, H)
    g_ys = t(B, T, H).to(dtype)
    w_h = (t(H, 4 * H) * H ** -0.5).to(dtype)
    return i, f, g, o, tanh_c, c_in, g_ys, w_h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,R", [(5, 7, 32, None), (3, 1, 16, None),
                                     (128, 50, 128, None), (11, 9, 64, 4),
                                     (4, 6, 256, None)])
def test_lstm_backward_kernel_matches_plain(cuda, dtype, B, T, H, R, monkeypatch):
    if R is not None and dtype == torch.float32:  # bf16 has its one row tiling
        real = k_lstm.backward_launch_config
        monkeypatch.setattr(k_lstm, "backward_launch_config",
                            lambda *a, **kw: real(*a, rows_per_cluster=R))
    planes = _lstm_planes(B, T, H, dtype, cuda, seed=B + T)
    dc_last = torch.randn(B, H, device=cuda)
    before = k_lstm.lstm_backward.launches
    got = k_lstm.lstm_backward(*planes, None, dc_last)
    torch.cuda.synchronize()
    assert k_lstm.lstm_backward.launches == before + 1
    want = k_lstm.plain_backward(*planes, None, dc_last)
    for name, a, b in zip(("dz", "dh0", "dc0"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("B,T,D,H", [(6, 9, 32, 32), (16, 40, 128, 128)])
def test_lstm_autograd_with_kernels_matches_plain_autograd(cuda, B, T, D, H):
    """f32: the kernels' forward and backward against autograd through the
    plain scan's own torch ops, with h_last and c_last in the loss."""
    args = [a.detach().requires_grad_(True)
            for a in _lstm_args(B, T, D, H, torch.float32, cuda, seed=3)]
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(B, T, H))
                         .astype(np.float32)).to(cuda)
    f0, b0 = k_lstm.lstm_scan.launches, k_lstm.lstm_backward.launches
    ys, (h_last, c_last) = k_lstm.lstm_scan(*args)
    ((ys * g).sum() + h_last.sum() + (c_last ** 2).sum()).backward()
    assert (k_lstm.lstm_scan.launches - f0, k_lstm.lstm_backward.launches - b0) == (1, 1)
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    ys_p, (h_p, c_p) = k_lstm.plain(*args)
    ((ys_p * g).sum() + h_p.sum() + (c_p ** 2).sum()).backward()
    for name, x, y in zip(("x", "h0", "c0", "w_x", "w_h", "b"), got, args):
        torch.testing.assert_close(x, y.grad, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("H", [100, 128, 132, 256])
@pytest.mark.parametrize("reset", [False, True])
def test_lstm_bf16_kernel_padding_ragged_rows_and_the_cell_plane(cuda, T, H, reset):
    """The tensor-core forward at H = 100 (padded to 112), 128, 132 and 256
    (the generic instantiation, fragments read every step), B = 11 (a ragged
    n8 tile), T around a power of two: ys and c_T within the bf16
    tolerance, the f32 cell plane against the plain serial recompute, the
    run without it giving the same bits. With a reset plane: an all-zero
    plane gives the no-reset kernel's bits, and a reset at t=0 makes the
    output blind to h0 and c0."""
    B, D = 11, 64
    args = [a.detach() for a in _lstm_args(B, T, D, H, torch.bfloat16, cuda, seed=T + H)]
    x, h0, c0, w_x, w_h, b = args
    wx, wh = w_x.bfloat16(), w_h.bfloat16()
    rs = _reset_plane(B, T, cuda, seed=H) if reset else None
    keep = None if rs is None else 1.0 - rs
    p0, before = k_lstm.lstm_input_projection.launches, k_lstm.lstm_scan.reset_launches
    ys, c_last, cs = k_lstm._forward_kernel(x, h0, c0, wx, wh, b, True, keep)
    torch.cuda.synchronize()
    assert k_lstm.lstm_input_projection.launches == p0 + 1
    assert k_lstm.lstm_scan.reset_launches == before + reset
    want, (_, c_want) = k_lstm.plain(*args, reset_mask=rs)
    torch.testing.assert_close(ys.float(), want.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(c_last, c_want.float(), rtol=5e-2, atol=5e-2)
    x_proj = torch.matmul(x.float(), wx.float()) + b
    cells = reference.lstm_recompute_cells(x_proj, ys, h0, c0, wh, rs)
    torch.testing.assert_close(cs, cells, rtol=1e-4, atol=1e-4)
    assert torch.equal(c_last, cs[:, -1])
    ys2, c2, none = k_lstm._forward_kernel(x, h0, c0, wx, wh, b, False, keep)
    assert none is None and torch.equal(ys2, ys) and torch.equal(c2, c_last)
    if reset:
        zero = k_lstm.lstm_scan(*args, reset_mask=torch.zeros_like(rs))
        plain_run = k_lstm.lstm_scan(*args)
        assert torch.equal(zero[0], plain_run[0]) and torch.equal(zero[1][1], plain_run[1][1])
        rs[:, 0] = 1.0
        a = k_lstm.lstm_scan(*args, reset_mask=rs)
        o = k_lstm.lstm_scan(x, -h0, -c0, w_x, w_h, b, reset_mask=rs)
        assert torch.equal(a[0], o[0]) and torch.equal(a[1][1], o[1][1])


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("H", [100, 128, 132, 256])
@pytest.mark.parametrize("with_keep", [False, True])
def test_lstm_bf16_backward_kernel_padding_and_ragged_rows(cuda, T, H, with_keep):
    """The tensor-core reverse recurrence (dz split into two bf16 terms) at
    the forward's widths and lengths, B = 11: dz, dh0 and dc0 within 1e-4
    of the plain f32 loop. With a keep plane: an all-ones plane gives the
    no-keep kernel's bits, and a reset at t=0 zeroes dh0 and dc0."""
    B = 11
    planes = _lstm_planes(B, T, H, torch.bfloat16, cuda, seed=T + H)
    keep = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None] if with_keep else None
    dc_last = torch.randn(B, H, device=cuda)
    got = k_lstm.lstm_backward(*planes, keep, dc_last)
    torch.cuda.synchronize()
    want = k_lstm.plain_backward(*planes, keep, dc_last)
    for name, a, b in zip(("dz", "dh0", "dc0"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    if with_keep:
        for a, b in zip(k_lstm.lstm_backward(*planes, torch.ones_like(keep), dc_last),
                        k_lstm.lstm_backward(*planes, None, dc_last)):
            assert torch.equal(a, b)
        keep[:, 0] = 0.0
        _, dh0, dc0 = k_lstm.lstm_backward(*planes, keep, dc_last)
        assert not bool(dh0.any()) and not bool(dc0.any())


@pytest.mark.parametrize("B,T,D,H", [(128, 200, 128, 128), (64, 200, 128, 128), (3, 5, 4, 12),
                                     (11, 9, 100, 100), (2, 70, 200, 132)])
def test_lstm_input_projection_kernel_matches_plain(cuda, B, T, D, H):
    """The bf16 LSTM forward's input projection: ragged row and column
    tiles (M = B*T and 4H not multiples of 64), D not a multiple of 16 or
    of the 64-deep chunk; exact bf16 products summed in f32 on both sides."""
    rng = np.random.default_rng(B + D)
    x = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32)).to(cuda).bfloat16()
    w_x = torch.from_numpy((rng.normal(size=(D, 4 * H)) * D ** -0.5).astype(np.float32))
    w_x = w_x.to(cuda).bfloat16()
    b = torch.from_numpy(rng.normal(size=4 * H).astype(np.float32)).to(cuda)
    before = k_lstm.lstm_input_projection.launches
    got = k_lstm.lstm_input_projection(x, w_x, b)
    torch.cuda.synchronize()
    assert k_lstm.lstm_input_projection.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, 4 * H)
    torch.testing.assert_close(got, k_lstm.plain_input_projection(x, w_x, b),
                               rtol=1e-5, atol=1e-5)


TOWERS = {"sasrec": dict(arch="sasrec", num_heads=2, max_len=12),
          "lstm": dict(arch="gru4rec", cell_type="lstm", residual=True)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_tower_scores_with_kernels_match_plain(cuda, tower, compute_dtype):
    """Two layers: every lookup, scan and attention of the model goes
    through the kernels, and the scores agree with the plain path."""
    kw = dict(embed_dim=32, num_layers=2, loss="full_softmax", compute_dtype=compute_dtype,
              **TOWERS[tower])
    models = [build_model(ModelConfig(use_pallas=p, **kw), 50, device=cuda)
              for p in (True, False)]
    state = flax_to_state_dict(random_params(models[0], seed=4))
    for m in models:
        m.load_state_dict(state)
    rng = np.random.default_rng(5)
    inputs = torch.from_numpy(rng.integers(0, 50, size=(6, 12)).astype(np.int32)).to(cuda)
    mask = (torch.arange(12, device=cuda)[None] < torch.tensor([[12], [3], [1], [0], [7], [12]],
                                                               device=cuda)).float()
    counters = (k_gather.embedding_gather, k_attn.causal_attention, k_lstm.lstm_scan)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        got = models[0].scores(inputs, mask)
        want = models[1].scores(inputs, mask)
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == ([1, 2, 0] if tower == "sasrec" else [1, 0, 2])
    tol = 1e-4 if compute_dtype == "float32" else 1e-1
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_tower_loss_backward_on_cuda_reaches_every_parameter(cuda, tower):
    """Each kernel of the new training paths launches the expected number of
    times in one loss and backward, and every parameter gets a finite
    gradient."""
    from seqrec_tpu_torch.data.negative import sample_negatives

    cfg = ModelConfig(embed_dim=32, num_layers=2, loss="sampled_softmax", num_negatives=40,
                      dropout_rate=0.2, **TOWERS[tower])
    m = build_model(cfg, 60, device=cuda)
    m.load_state_dict(flax_to_state_dict(random_params(m, seed=1)))
    rng = np.random.default_rng(2)
    seq = torch.from_numpy(rng.integers(1, 60, size=(4, 13)).astype(np.int32)).to(cuda)
    batch = {"inputs": seq[:, :-1], "targets": seq[:, 1:], "mask": torch.ones(4, 12, device=cuda)}
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    neg_ids, nlq = sample_negatives(gen, 40, 60, "log_uniform")
    counters = (k_gather.embedding_gather, k_gather.embedding_scatter_add,
                k_attn.causal_attention, k_lstm.lstm_scan, k_lstm.lstm_backward,
                k_head.sampled_softmax_nll)
    before = [c.launches for c in counters]
    loss_sum, w_sum = m.loss(batch, neg_ids=neg_ids, neg_log_q=nlq, generator=gen)
    (loss_sum / w_sum).backward()
    got = [c.launches - b for c, b in zip(counters, before)]
    assert got == ([3, 3, 2, 0, 0, 1] if tower == "sasrec" else [3, 3, 0, 2, 2, 1])
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


# ---------------------------------------------------------------------------
# Session-parallel training: the reset variants of the scans and of their
# reverse recurrences
# ---------------------------------------------------------------------------

RESET_SHAPES = [(5, 7, 16, 32), (256, 50, 100, 100), (128, 40, 128, 128), (11, 9, 64, 96),
                (3, 5, 16, 132), (4, 6, 32, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", RESET_SHAPES)
def test_gru_reset_kernel_matches_plain(cuda, dtype, B, T, D, H):
    """Against the plain scan with the same resets; an all-zero plane gives
    the no-reset kernel's bits; with a reset at t=0 the output ignores h0."""
    args = _gru_args(B, T, D, H, dtype, cuda, seed=B + T)
    reset = _reset_plane(B, T, cuda, seed=T)
    ys, h = k_gru.gru_scan(*args, reset_mask=reset)
    want, _ = k_gru.plain(*args, reset_mask=reset)
    torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(h, ys[:, -1])
    assert torch.equal(k_gru.gru_scan(*args, reset_mask=torch.zeros_like(reset))[0],
                       k_gru.gru_scan(*args)[0])
    reset[:, 0] = 1.0
    x, h0, *w = args
    assert torch.equal(k_gru.gru_scan(x, h0, *w, reset_mask=reset)[0],
                       k_gru.gru_scan(x, torch.zeros_like(h0), *w, reset_mask=reset)[0])


@pytest.mark.parametrize("B,T,H", [(5, 7, 32), (256, 50, 100), (128, 40, 128), (11, 9, 64)])
def test_gru_backward_reset_kernel_matches_plain(cuda, B, T, H):
    """The keep path with f32 weights: the cluster design (bf16 weights'
    keep path: test_gru_bf16_backward_kernel_padding_and_ragged_rows)."""
    planes = _gate_planes(B, T, H, torch.float32, cuda, seed=B + T)
    keep = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]
    before = k_gru.gru_backward.reset_launches
    got = k_gru.gru_backward(*planes, keep)
    assert k_gru.gru_backward.reset_launches == before + 1
    for name, a, b in zip(("d_xp", "dh0", "dn_r"), got, k_gru.plain_backward(*planes, keep)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    for a, b in zip(k_gru.gru_backward(*planes, torch.ones_like(keep)),
                    k_gru.gru_backward(*planes)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", [(5, 7, 16, 32), (128, 40, 128, 128), (11, 9, 64, 96)])
def test_lstm_reset_kernel_matches_plain(cuda, dtype, B, T, D, H):
    args = _lstm_args(B, T, D, H, dtype, cuda, seed=B + T)
    reset = _reset_plane(B, T, cuda, seed=T)
    ys, (h, c) = k_lstm.lstm_scan(*args, reset_mask=reset)
    want, (_, c_want) = k_lstm.plain(*args, reset_mask=reset)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(ys.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c.float(), c_want.float(), rtol=tol, atol=tol)
    zero = k_lstm.lstm_scan(*args, reset_mask=torch.zeros_like(reset))
    plain_run = k_lstm.lstm_scan(*args)
    assert torch.equal(zero[0], plain_run[0]) and torch.equal(zero[1][1], plain_run[1][1])
    reset[:, 0] = 1.0
    x, h0, c0, *w = args
    a = k_lstm.lstm_scan(x, h0, c0, *w, reset_mask=reset)
    b = k_lstm.lstm_scan(x, torch.zeros_like(h0), torch.zeros_like(c0), *w, reset_mask=reset)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_reset_kernel_cell_plane(cuda, dtype):
    """The f32 cell plane and c_T the reset variant writes equal the plain
    serial recompute with the same resets."""
    args = [a.detach() for a in _lstm_args(11, 6, 128, 128, dtype, cuda, seed=1)]
    reset = _reset_plane(11, 6, cuda, seed=2)
    wx, wh = args[3].to(dtype), args[4].to(dtype)
    ys, c_last, cs = k_lstm._forward_kernel(args[0], args[1], args[2], wx, wh, args[5], True,
                                            1.0 - reset)
    x_proj = torch.matmul(args[0].float(), wx.float()) + args[5]
    cells = reference.lstm_recompute_cells(x_proj, ys, args[1], args[2], wh, reset)
    torch.testing.assert_close(cs, cells, rtol=1e-4, atol=1e-4)
    assert torch.equal(c_last, cs[:, -1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H", [(5, 7, 32), (128, 40, 128), (11, 9, 64)])
def test_lstm_backward_reset_kernel_matches_plain(cuda, dtype, B, T, H):
    planes = _lstm_planes(B, T, H, dtype, cuda, seed=B + T)
    keep = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]
    dc_last = torch.randn(B, H, device=cuda)
    before = k_lstm.lstm_backward.reset_launches
    got = k_lstm.lstm_backward(*planes, keep, dc_last)
    assert k_lstm.lstm_backward.reset_launches == before + 1
    want = k_lstm.plain_backward(*planes, keep, dc_last)
    for name, a, b in zip(("dz", "dh0", "dc0"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    for a, b in zip(k_lstm.lstm_backward(*planes, torch.ones_like(keep), dc_last),
                    k_lstm.lstm_backward(*planes, None, dc_last)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_reset_autograd_with_kernels_matches_plain_autograd(cuda, cell):
    """f32: the reset variants forward and backward against autograd
    through the plain scans' own torch ops, with h0 (and c0) carried in."""
    B, T, D, H = 16, 30, 64, 64
    if cell == "gru":
        args = _gru_args(B, T, D, H, torch.float32, cuda, seed=5)
        scan, plain, names = k_gru.gru_scan, k_gru.plain, ("x", "h0", "w_x", "w_h", "b_x", "b_h")
    else:
        args = _lstm_args(B, T, D, H, torch.float32, cuda, seed=5)
        scan, plain, names = k_lstm.lstm_scan, k_lstm.plain, ("x", "h0", "c0", "w_x", "w_h", "b")
    args = [a.detach().requires_grad_(True) for a in args]
    reset = _reset_plane(B, T, cuda, seed=6)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(B, T, H))
                         .astype(np.float32)).to(cuda)
    bwd = k_gru.gru_backward if cell == "gru" else k_lstm.lstm_backward
    b0 = bwd.reset_launches
    (scan(*args, reset_mask=reset)[0] * g).sum().backward()
    assert bwd.reset_launches == b0 + 1
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    (plain(*args, reset_mask=reset)[0] * g).sum().backward()
    for name, x, y in zip(names, got, args):
        torch.testing.assert_close(x, y.grad, rtol=1e-4, atol=1e-4, msg=name)


# ---------------------------------------------------------------------------
# The f32 cluster recurrences and the f32 input projection
# ---------------------------------------------------------------------------

F32_SHAPES = [(11, T, H) for T in (1, 2, 50, 200) for H in (100, 128, 132, 256)] + [
    (64, 200, 128), (128, 200, 128), (256, 50, 100)]


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("B,T,H", F32_SHAPES)
def test_f32_gru_cluster_forward_matches_plain(cuda, B, T, H, reset):
    """The f32 GRU forward (f32 input projection, then the cluster
    recurrence) at T = 1, 2, 50, 200, H = 100, 128, 132 and 256 with B = 11
    (ragged against a cluster's rows), and at the main paths' shapes,
    against the plain f32 loop at 1e-5; the reset variant also gives the
    no-reset kernel's bits on an all-zero plane and ignores h0 under a reset
    at t=0."""
    args = _gru_args(B, T, H, H, torch.float32, cuda, seed=B + T + H)
    before = (k_gru.gru_input_projection.f32_launches, k_gru.gru_scan.launches,
              k_gru.gru_scan.reset_launches)
    plane = _reset_plane(B, T, cuda, seed=H) if reset else None
    ys, h = k_gru.gru_scan(*args, reset_mask=plane)
    torch.cuda.synchronize()
    assert (k_gru.gru_input_projection.f32_launches, k_gru.gru_scan.launches,
            k_gru.gru_scan.reset_launches) == (before[0] + 1, before[1] + (not reset),
                                               before[2] + reset)
    assert k_gru.launch_config(B, T, H, H, torch.float32)["design"] == "cluster"
    want, _ = k_gru.plain(*args, reset_mask=plane)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(h, ys[:, -1])
    if reset:
        assert torch.equal(k_gru.gru_scan(*args, reset_mask=torch.zeros_like(plane))[0],
                           k_gru.gru_scan(*args)[0])
        plane[:, 0] = 1.0
        x, h0, *w = args
        assert torch.equal(k_gru.gru_scan(x, h0, *w, reset_mask=plane)[0],
                           k_gru.gru_scan(x, -h0, *w, reset_mask=plane)[0])


LSTM_F32_SHAPES = [(11, T, H) for T in (1, 2, 50, 200) for H in (64, 100, 128, 132, 256)] + [
    (64, 200, 128), (128, 200, 128)]


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("B,T,H", LSTM_F32_SHAPES)
def test_f32_lstm_cluster_forward_matches_plain(cuda, B, T, H, reset):
    """The f32 LSTM forward (the f32 input projection, then the cluster
    recurrence) at T = 1, 2, 50, 200, H = 64, 100, 128, 132 and 256 with
    B = 11 (ragged against a cluster's rows), and at the LSTM paths' shapes,
    against the plain f32 loop at 1e-5 (ys and c_T), the cell plane against
    the plain serial recompute; the reset variant also gives the no-reset
    kernel's bits on an all-zero plane and ignores h0 and c0 under a reset
    at t=0."""
    args = [a.detach() for a in _lstm_args(B, T, H, H, torch.float32, cuda, seed=B + T + H)]
    plane = _reset_plane(B, T, cuda, seed=H) if reset else None
    before = (k_lstm.lstm_input_projection.f32_launches, k_lstm.lstm_scan.launches,
              k_lstm.lstm_scan.reset_launches)
    ys, (h, c) = k_lstm.lstm_scan(*args, reset_mask=plane)
    torch.cuda.synchronize()
    assert (k_lstm.lstm_input_projection.f32_launches, k_lstm.lstm_scan.launches,
            k_lstm.lstm_scan.reset_launches) == (before[0] + 1, before[1] + (not reset),
                                                 before[2] + reset)
    assert k_lstm.launch_config(B, T, H, H, torch.float32)["design"] == "cluster"
    want, (_, c_want) = k_lstm.plain(*args, reset_mask=plane)
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, c_want, rtol=1e-5, atol=1e-5)
    assert torch.equal(h, ys[:, -1])
    ys_k, c_last, cs = k_lstm._forward_kernel(*args, True, None if plane is None else 1 - plane)
    assert torch.equal(ys_k, ys) and torch.equal(c_last, c)
    x_proj = torch.matmul(args[0], args[3]) + args[5]
    cells = reference.lstm_recompute_cells(x_proj, ys, args[1], args[2], args[4], plane)
    torch.testing.assert_close(cs, cells, rtol=1e-4, atol=1e-4)
    if reset:
        zero = k_lstm.lstm_scan(*args, reset_mask=torch.zeros_like(plane))
        base = k_lstm.lstm_scan(*args)
        assert torch.equal(zero[0], base[0]) and torch.equal(zero[1][1], base[1][1])
        plane[:, 0] = 1.0
        x, h0, c0, *w = args
        a = k_lstm.lstm_scan(x, h0, c0, *w, reset_mask=plane)
        o = k_lstm.lstm_scan(x, -h0, -c0, *w, reset_mask=plane)
        assert torch.equal(a[0], o[0]) and torch.equal(a[1][1], o[1][1])


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("B,T,H", F32_SHAPES)
def test_f32_lstm_cluster_backward_matches_plain(cuda, B, T, H, keep):
    """The f32 LSTM reverse recurrence on clusters at the same shapes
    against the plain f32 loop at 1e-4; with a keep plane, an all-ones plane
    gives the no-keep kernel's bits and a reset at t=0 gives dh0 = dc0 = 0."""
    planes = _lstm_planes(B, T, H, torch.float32, cuda, seed=B + T + H)
    dc_last = torch.randn(B, H, device=cuda, generator=torch.Generator(device=cuda).manual_seed(H))
    kp = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None] if keep else None
    assert k_lstm.backward_launch_config(B, T, H, torch.float32)["design"] == "cluster"
    got = k_lstm.lstm_backward(*planes, kp, dc_last)
    torch.cuda.synchronize()
    want = k_lstm.plain_backward(*planes, kp, dc_last)
    for name, a, b in zip(("dz", "dh0", "dc0"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    if keep:
        ones = k_lstm.lstm_backward(*planes, torch.ones_like(kp), dc_last)
        assert all(torch.equal(a, b) for a, b in zip(
            ones, k_lstm.lstm_backward(*planes, None, dc_last)))
        kp[:, 0] = 0.0
        _, dh0, dc0 = k_lstm.lstm_backward(*planes, kp, dc_last)
        assert not bool(dh0.any()) and not bool(dc0.any())


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("B,T,H", F32_SHAPES)
def test_f32_gru_cluster_backward_matches_plain(cuda, B, T, H, keep):
    """The f32 GRU reverse recurrence on clusters, the gate recompute inside,
    against the plain f32 loop at 1e-4; with a keep plane, an all-ones plane
    gives the no-keep kernel's bits and a reset at t=0 gives dh0 = 0."""
    planes = _gate_planes(B, T, H, torch.float32, cuda, seed=B + T + H)
    kp = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None] if keep else None
    assert k_gru.backward_launch_config(B, T, H, torch.float32)["design"] == "cluster"
    got = k_gru.gru_backward(*planes, kp)
    torch.cuda.synchronize()
    want = k_gru.plain_backward(*planes, kp)
    for name, a, b in zip(("d_xp", "dh0", "dn_r"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    if keep:
        ones = k_gru.gru_backward(*planes, torch.ones_like(kp))
        assert all(torch.equal(a, b) for a, b in zip(ones, k_gru.gru_backward(*planes)))
        kp[:, 0] = 0.0
        assert not bool(k_gru.gru_backward(*planes, kp)[1].any())


@pytest.mark.parametrize("cluster_size", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [4, 8, 16])
def test_f32_cluster_kernels_every_tiling(cuda, cluster_size, rows, monkeypatch):
    """Every cluster size and rows a cluster the launch configs accept, at
    B = 11 and H = 64 and 128 (k-slices of 8 or 16 threads a unit; at
    H = 128 the GRU's and the LSTM forward's W_h slice in registers up to 8
    rows), for the four cluster kernels. What a config refuses (one CTA
    for H = 128's 128 units: 1,024 threads; two CTAs of 16 rows of the LSTM
    and GRU reverse at H = 128: 328 and 337 KB; one CTA of 16 rows of the
    GRU reverse at H = 64: 289 KB), the wrapper refuses too."""
    real_f, real_b = k_gru.launch_config, k_lstm.backward_launch_config
    real_lf, real_gb = k_lstm.launch_config, k_gru.backward_launch_config
    monkeypatch.setattr(k_gru, "launch_config", lambda *a, **kw: real_f(
        *a, rows_per_cluster=rows, cluster_size=cluster_size))
    monkeypatch.setattr(k_lstm, "launch_config", lambda *a, **kw: real_lf(
        *a, rows_per_cluster=rows, cluster_size=cluster_size))
    monkeypatch.setattr(k_lstm, "backward_launch_config", lambda *a, **kw: real_b(
        *a, rows_per_cluster=rows, cluster_size=cluster_size))
    monkeypatch.setattr(k_gru, "backward_launch_config", lambda *a, **kw: real_gb(
        *a, rows_per_cluster=rows, cluster_size=cluster_size))
    for H in (64, 128):
        refused = (cluster_size == 1 and H == 128, cluster_size <= 2 and rows == 16 and H == 128)
        args = _gru_args(11, 9, H, H, torch.float32, cuda, seed=rows)
        planes = _lstm_planes(11, 9, H, torch.float32, cuda, seed=rows)
        largs = _lstm_args(11, 9, H, H, torch.float32, cuda, seed=rows)
        if refused[0]:
            with pytest.raises(ValueError, match="threads"):
                k_gru.gru_scan(*args)
            with pytest.raises(ValueError, match="threads"):
                k_lstm.lstm_scan(*largs)
        else:
            ys, _ = k_gru.gru_scan(*args)
            torch.testing.assert_close(ys, k_gru.plain(*args)[0], rtol=1e-5, atol=1e-5)
            ys, (_, c) = k_lstm.lstm_scan(*largs)
            want, (_, c_want) = k_lstm.plain(*largs)
            torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(c, c_want, rtol=1e-5, atol=1e-5)
        if refused[0] or refused[1]:
            with pytest.raises(ValueError, match="shared memory"):
                k_lstm.lstm_backward(*planes)
        else:
            for a, b in zip(k_lstm.lstm_backward(*planes), k_lstm.plain_backward(*planes)):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        gplanes = _gate_planes(11, 9, H, torch.float32, cuda, seed=rows)
        if refused[0] or refused[1] or (cluster_size == 1 and rows == 16):
            with pytest.raises(ValueError, match="shared memory"):
                k_gru.gru_backward(*gplanes)
        else:
            for a, b in zip(k_gru.gru_backward(*gplanes), k_gru.plain_backward(*gplanes)):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,D,N", [(64 * 200, 128, 384), (256 * 50, 100, 300), (15, 4, 12),
                                   (140, 200, 132), (128 * 200, 128, 512),
                                   (128 * 200, 128, 384), (1, 4, 4), (333, 36, 520)])
def test_f32_input_projection_kernel_matches_f64(cuda, M, D, N):
    """The f32 forward's input projection (f32 FMAs, no TF32): ragged row and
    column tiles, D not a multiple of the 32-deep chunk, fewer tiles than
    CTAs and more; against x @ W_x + b in f64 at 1e-5."""
    rng = np.random.default_rng(M + D)
    x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(cuda)
    w_x = torch.from_numpy((rng.normal(size=(D, N)) * D ** -0.5).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
    before = k_gru.gru_input_projection.f32_launches
    got = k_gru.gru_input_projection(x, w_x, b)
    torch.cuda.synchronize()
    assert k_gru.gru_input_projection.f32_launches == before + 1
    want = (x.double() @ w_x.double() + b.double()).float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="of one dtype"):
        k_gru.gru_input_projection(x.bfloat16(), w_x, b)


@pytest.mark.parametrize("M,D,N", [(128 * 200, 128, 512), (64 * 200, 128, 512), (15, 4, 16),
                                   (140, 200, 528)])
def test_lstm_f32_input_projection_kernel_matches_f64(cuda, M, D, N):
    """The f32 LSTM forward's input projection (rnn.cuh's f32 GEMM, N = 4H)
    through the LSTM's own wrapper and counter, against f64 at 1e-5."""
    rng = np.random.default_rng(M + N)
    x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(cuda)
    w_x = torch.from_numpy((rng.normal(size=(D, N)) * D ** -0.5).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
    before = (k_lstm.lstm_input_projection.launches, k_lstm.lstm_input_projection.f32_launches)
    got = k_lstm.lstm_input_projection(x, w_x, b)
    torch.cuda.synchronize()
    assert (k_lstm.lstm_input_projection.launches,
            k_lstm.lstm_input_projection.f32_launches) == (before[0], before[1] + 1)
    want = (x.double() @ w_x.double() + b.double()).float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="of one dtype"):
        k_lstm.lstm_input_projection(x, w_x.bfloat16(), b)


@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("Dh", [4, 32, 64, 100, 256])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_attention_f32_kernel_tiles_head_dims_and_strided_views(cuda, T, Dh, N):
    """The f32 attention kernel around its 32-row tiles (T = 1, 63, 64, 65, 200), at head dims from one float4
    to 256, on q, k and v read in place from one [B, T, 3, N, Dh]
    projection: within 2e-5 of the plain version; half the batch alone
    gives the batch's bits."""
    B = 4
    qkv = torch.randn(B, T, 3, N, Dh, generator=torch.Generator().manual_seed(T * Dh + N))
    qkv = qkv.to(cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert k_attn._kernel_view(q).data_ptr() == q.data_ptr()
    assert k_attn.launch_config(B, T, N, Dh, torch.float32)["design"] == "flash-fma"
    got = k_attn.causal_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, k_attn.plain(q, k, v), rtol=2e-5, atol=2e-5)
    assert torch.equal(k_attn.causal_attention(q[:2], k[:2], v[:2]), got[:2])


def test_attention_f32_kernel_at_the_training_shape_and_serving_batch(cuda):
    """[128, 200, 1, 64] (SASRec's training step) within 2e-5 of the plain
    version, and its first 64 rows (serving's batch) alone give the batch's
    bits."""
    q, k, v = _qkv(128, 200, 1, 64, torch.float32, cuda, seed=9)
    got = k_attn.causal_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, k_attn.plain(q, k, v), rtol=2e-5, atol=2e-5)
    assert torch.equal(k_attn.causal_attention(q[:64], k[:64], v[:64]), got[:64])


# ---------------------------------------------------------------------------
# The fit loop on the card: staging through pinned memory, and fit itself
# ---------------------------------------------------------------------------


def test_host_stager_copies_through_pinned_memory_in_order(cuda):
    """HostStager: wires and dicts staged on a side stream, taken on the
    current stream (`ready`), equal to what went in, many more batches than
    pinned slots (a slot is rewritten only after its copy completed)."""
    from seqrec_tpu_torch.data.prefetch import DevicePrefetcher, HostStager, StagedBatch

    stager = HostStager(cuda, slots=2)
    rng = np.random.default_rng(0)
    src = []
    for i in range(20):
        wire = rng.integers(0, 3000, size=(8, 6, 202)).astype(np.int16)
        src.append((i, wire if i % 3 else {"inputs": wire[0].astype(np.int32),
                                          "mask": np.ones((6, 202), np.float32)}))
    staged = stager(src[1][1])
    assert isinstance(staged, StagedBatch) and staged.tensors.is_pinned() is False
    got = list(DevicePrefetcher(iter(src), stager, depth=3))
    torch.cuda.synchronize()
    assert [b for b, _ in got] == list(range(20))
    for (_, want), (_, dev_batch) in zip(src, got):
        if isinstance(want, dict):
            for k in want:
                assert dev_batch[k].device.type == "cuda"
                np.testing.assert_array_equal(dev_batch[k].cpu().numpy(), want[k])
        else:
            assert dev_batch.dtype == torch.int16 and dev_batch.device.type == "cuda"
            np.testing.assert_array_equal(dev_batch.cpu().numpy(), want)
    assert all(len(ring) <= 2 for ring in stager._pool.values())


@pytest.mark.parametrize("session", [False, True])
def test_fit_on_the_card_is_reproducible_across_prefetch_and_grouping(cuda, tmp_path, session):
    """Trainer.fit through the kernels at a small size: the native loader,
    prefetch depth 2 and K=4 against prefetch 0 and K=1 give the same final
    parameters bit for bit (the same batches, K eager steps a group, a
    deterministic step), and the kernels launched."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.data.dataset import synthetic_dataset
    from seqrec_tpu_torch.train.trainer import Trainer

    ds = synthetic_dataset(80, 300, seed=1, min_len=4, max_len=40)
    finals = []
    for prefetch, k in ((2, 4), (0, 1)):
        cfg = RunConfig()
        cfg.model.embed_dim, cfg.model.loss, cfg.model.num_negatives = 64, "sampled_softmax", 64
        cfg.model.dropout_rate = 0.1
        cfg.data.batch_size, cfg.data.max_len = 16, 32
        cfg.data.session_parallel = session
        cfg.data.prefetch_to_device = prefetch
        cfg.train.steps_per_call, cfg.train.num_steps = k, 12
        cfg.train.eval_every, cfg.train.checkpoint_every = 12, 0
        cfg.train.out_dir = str(tmp_path / f"{prefetch}_{k}")
        tr = Trainer(cfg, ds, device=cuda)
        before = k_gather.embedding_gather.launches
        state, metrics = tr.fit()
        assert tr.data_engine == "native" and state.step == 12
        assert k_gather.embedding_gather.launches > before
        assert metrics["count"] > 0 and all(np.isfinite(v) for v in metrics.values())
        finals.append(state)
    for name in finals[0].params:
        assert torch.equal(finals[0].params[name], finals[1].params[name]), name


# ---------------------------------------------------------------------------
# The sparse embedding step and checkpoint resume on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied,session", [(True, False), (False, False), (True, True)])
def test_sparse_step_kernels_match_plain(cuda, tied, session):
    """One sparse step (f32 compute) through the kernels and through the
    plain versions, each from a clone of one state: loss and gradient norm
    within 1e-4 relative, the tables and their row state within 1e-4 of
    their largest value, rows no id touched unchanged bit for bit. The
    gather fetches each sub-table and does the three lookups on it; the
    scatter-add runs for the lookups only."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.train.state import clone_state
    from seqrec_tpu_torch.train.trainer import Trainer

    class DS:
        vocab_size, num_users = 500, 0

    overrides = ["model.embed_dim=32", "model.num_negatives=50", "data.max_len=20",
                 "data.batch_size=8",
                 "model.compute_dtype=float32", "model.dropout_rate=0.0",
                 "train.sparse_embedding_update=true", "train.optimizer=adagrad",
                 f"model.tie_embeddings={str(tied).lower()}",
                 f"data.session_parallel={str(session).lower()}"]
    if not tied:
        overrides.append("model.hidden_dim=48")
    cfg = RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(overrides)
    rng = np.random.default_rng(2)
    inputs = rng.integers(1, 500, size=(8, 20)).astype(np.int32)
    targets = rng.integers(1, 500, size=(8, 20)).astype(np.int32)
    batch = {"inputs": inputs, "targets": targets, "mask": np.ones((8, 20), np.float32)}
    if session:
        batch["reset"] = (rng.random((8, 20)) < 0.2).astype(np.float32)
    runs = {}
    state = Trainer(cfg, DS(), device=cuda).init_state(3)
    for use_pallas in (True, False):
        tr = Trainer(cfg.apply_overrides([f"model.use_pallas={str(use_pallas).lower()}"]), DS(),
                     device=cuda)
        before = (k_gather.embedding_gather.launches, k_gather.embedding_scatter_add.launches)
        runs[use_pallas] = tr.train_step(clone_state(state), batch)
        torch.cuda.synchronize()
        launched = (k_gather.embedding_gather.launches - before[0],
                    k_gather.embedding_scatter_add.launches - before[1])
        assert launched == (((4 if tied else 5), 3) if use_pallas else (0, 0))
    (k, mk), (p, mp) = runs[True], runs[False]
    for key in ("loss", "grad_norm"):
        assert abs(float(mk[key]) - float(mp[key])) <= 1e-4 * abs(float(mp[key])), key
    names = ["item_embedding"] + ([] if tied else ["output_embedding"])
    for name in names:
        for a, b in [(k.params[name], p.params[name]),
                     (k.embed_opt[name]["acc"], p.embed_opt[name]["acc"])]:
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), name
    touched = np.unique(np.concatenate([inputs.ravel(), targets.ravel()]))
    untouched = torch.ones(500, dtype=torch.bool)
    untouched[torch.from_numpy(touched).long()] = False
    untouched[tr.sample_negatives(tr._generators(state)[0])[0].long().cpu()] = False
    assert torch.equal(k.params["item_embedding"][untouched.to(cuda)],
                       state.params["item_embedding"][untouched.to(cuda)])


@pytest.mark.parametrize("mode", ["bucketed", "session", "sparse"])
def test_fit_resume_equals_straight_on_the_card(cuda, tmp_path, mode):
    """Trainer.fit through the kernels: a run killed at step 8
    (checkpoint_every=5, K=4) and resumed equals a straight 12-step run bit
    for bit, every parameter and optimizer-state leaf."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.data.dataset import synthetic_dataset
    from seqrec_tpu_torch.train.trainer import Trainer

    ds = synthetic_dataset(80, 300, seed=1, min_len=4, max_len=40)

    def fit(out, **train):
        cfg = RunConfig()
        cfg.model.embed_dim, cfg.model.loss, cfg.model.num_negatives = 64, "sampled_softmax", 64
        cfg.model.dropout_rate = 0.1
        cfg.data.batch_size, cfg.data.max_len = 16, 32
        cfg.data.session_parallel = mode == "session"
        cfg.train.sparse_embedding_update = mode == "sparse"
        cfg.train.optimizer = "adagrad" if mode == "sparse" else "adam"
        cfg.train.steps_per_call, cfg.train.num_steps = 4, 12
        cfg.train.eval_every, cfg.train.out_dir = 0, str(tmp_path / out)
        for key, v in train.items():
            setattr(cfg.train, key, v)
        tr = Trainer(cfg, ds, device=cuda)
        return tr, tr.fit()[0]

    _, straight = fit("s", checkpoint_every=0)
    _, killed = fit("k", checkpoint_every=5, fail_after_step=8)
    tr, resumed = fit("k", checkpoint_every=5, resume=True)
    assert killed.step == 8 and resumed.step == 12 and tr.ckpt.all_steps()[0] == 8
    for name in straight.params:
        assert torch.equal(straight.params[name], resumed.params[name]), name
    opt = (lambda s: s.embed_opt["item_embedding"]) if mode == "sparse" else (
        lambda s: s.opt_state["mu"])
    for name, t in opt(straight).items():
        assert torch.equal(t, opt(resumed)[name]), name


# ---------------------------------------------------------------------------
# Every width up to 256: rows that are not 16-byte multiples (SASRec at its
# paper's d = 50, GRU4Rec's 100 units under a sampled softmax). Each kernel
# runs twice on the same inputs (equal bits) and is held against its plain
# version at its usual limit: the gather bit for bit, the head 1e-4
# (HEAD_TOL), the attention 2e-5 in f32 and, in bf16, 5e-2 against the
# plain version and 2e-2 against f32 math on the same inputs.
# ---------------------------------------------------------------------------


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("table_dtype,dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("D", [50, 25, 3])
def test_gather_kernel_takes_every_width_bit_exact_twice(cuda, table_dtype, dtype, D):
    """At serving's [64, 200] Zipf ids with planted out-of-range ones, from
    a [3418, D] table whose rows are not 16-byte multiples (f32 D = 50: 8-byte
    units; 25 and 3: 4-byte; bf16 2- or 4-byte), also through a base 4
    bytes off a 16-byte boundary, and the shard-window variant: bit for bit
    the plain version (NaN rows' words included), the same bits twice."""
    V = 3418
    rng = np.random.default_rng(D)
    ids = rng.integers(0, V, size=(64, 200))
    ids[0, :5] = [-1, -V, V, -V - 1, 10 ** 6]
    ids = torch.from_numpy(ids).to(cuda, torch.int32)
    flat = torch.from_numpy(rng.normal(size=V * D + 2).astype(np.float32)).to(cuda, table_dtype)
    es = flat.element_size()
    for off in (0, 4 // es):
        table = flat[off:off + V * D].view(V, D)
        cfg = k_gather.check_launchable(table, ids, dtype)
        assert cfg == k_gather.launch_config(D, table_dtype, dtype, table.data_ptr())
        assert cfg["unit_bytes"] < 16
        a = k_gather.embedding_gather(table, ids, dtype=dtype)
        b = k_gather.embedding_gather(table, ids, dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(k_gather.plain(table, ids, dtype=dtype)))
        assert bool(torch.isnan(a[0, 2:5]).all()) and not bool(torch.isnan(a[0, :2]).any())
    row0 = 1000
    shard = flat[:V * D].view(V, D)[row0:row0 + 500]
    win = k_gather.embedding_gather_window(shard, ids, row0, dtype=dtype)
    assert torch.equal(_bits(win), _bits(reference.embedding_gather_window(
        shard, ids, row0, dtype=dtype)))


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_at_d50_takes_the_float_unit(cuda, g_dtype):
    """The gather's backward at SASRec d = 50's training shape (25,600 Zipf
    ids, half of them padding, into 3,418 rows): the float-unit path with
    an f32 and a bf16 cotangent, the same bits twice, bit for bit
    plain_ordered and within 1e-5 of the plain version."""
    rng = np.random.default_rng(50)
    V, n, D = 3418, 25_600, 50
    ids = torch.from_numpy(_zipf_ids(rng, n, V, 0.5)).to(cuda)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(n, D)).astype(np.float32)).to(cuda)
    g = g.to(g_dtype)
    plan = k_gather.check_scatter_add_launchable(g, ids, V)
    assert plan["unit"] == "float"
    a = k_gather.embedding_scatter_add(g, ids, V)
    b = k_gather.embedding_scatter_add(g, ids, V)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, k_gather.plain_ordered(g, ids, V, plan["chunk"]))
    torch.testing.assert_close(a, k_gather.plain_backward(g, ids, V), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [50, 25, 6])
@pytest.mark.parametrize("N", [1, 2])
def test_attention_kernel_takes_every_head_dim_twice(cuda, dtype, Dh, N):
    """q, k and v as the SASRec block slices them from one [B, T, 3, N, Dh]
    projection (rows 3 N Dh apart: 4-byte or, for an odd Dh in bf16, 2-byte
    aligned), read in place, T = 200 and a ragged 65: the same bits twice,
    within the usual limits of the plain version; the first rows alone give
    the batch's bits."""
    for T in (200, 65):
        qkv = torch.randn(8, T, 3, N, Dh, generator=torch.Generator().manual_seed(Dh * T + N))
        qkv = qkv.to(cuda, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert k_attn._kernel_view(q).data_ptr() == q.data_ptr()
        cfg = k_attn.launch_config(8, T, N, Dh, dtype, k_attn.operand_align(q, k, v))
        assert cfg["unit_bytes"] < 16
        before = k_attn.causal_attention.launches
        a = k_attn.causal_attention(q, k, v)
        b = k_attn.causal_attention(q, k, v)
        torch.cuda.synchronize()
        assert k_attn.causal_attention.launches == before + 2
        assert a.dtype == dtype and tuple(a.shape) == (8, T, N, Dh)
        assert torch.equal(a, b)
        assert torch.equal(k_attn.causal_attention(q[:3], k[:3], v[:3]), a[:3])
        if dtype == torch.float32:
            torch.testing.assert_close(a, k_attn.plain(q, k, v), rtol=2e-5, atol=2e-5)
        else:
            torch.testing.assert_close(a.float(), k_attn.plain(q, k, v).float(), rtol=5e-2,
                                       atol=5e-2)
            exact = k_attn.plain(q.float(), k.float(), v.float())
            torch.testing.assert_close(a.float(), exact, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [50, 100, 30])
def test_head_kernel_takes_every_width_twice(cuda, dtype, H):
    """The head at widths that are not 16-byte rows (bf16 H = 50 and 30:
    4-byte pieces; H = 100: 8-byte; f32 50 and 30: the positive logit a
    float at a time; f32 100 in float4s), at the training step's N = 25,600, S = 256 and a
    ragged N = 300, S = 100, also with h a view 2 bytes (bf16) or 4 bytes
    (f32) off a 4- or 16-byte boundary: the same bits twice, within 1e-4
    of the plain version."""
    for N, S in ((25_600, 256), (300, 100)):
        h, pos, neg, targets, neg_ids, plq, nlq = _head_args(N, S, H, dtype, cuda, seed=N + H)
        flat = torch.empty(N * H + 1, dtype=dtype, device=cuda)
        flat[1:] = h.reshape(-1)
        for hh in (h, flat[1:].view(N, H)):
            cfg = k_head.check_launchable(hh, pos, neg, targets, neg_ids, plq, nlq)
            unit = cfg.get("unit_bytes", cfg.get("pos_unit_bytes"))
            assert unit < 16 or (dtype == torch.float32 and H % 4 == 0 and hh is h)
            before = k_head.sampled_softmax_nll.launches
            a = k_head.sampled_softmax_nll(hh, pos, neg, targets, neg_ids, plq, nlq)
            b = k_head.sampled_softmax_nll(hh, pos, neg, targets, neg_ids, plq, nlq)
            torch.cuda.synchronize()
            assert k_head.sampled_softmax_nll.launches == before + 2
            assert torch.equal(a, b)
            want = k_head.plain(hh, pos, neg, targets, neg_ids, plq, nlq)
            torch.testing.assert_close(a, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Above H = 256: the GRU's grid-persistent layout and the head's K split
# ---------------------------------------------------------------------------

GRID_SHAPES = [(H, B, T) for H in (260, 384, 512, 1000, 1024) for B in (1, 3, 8, 256)
               for T in (1, 7, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,B,T", GRID_SHAPES)
def test_gru_grid_forward_matches_plain_twice(cuda, H, B, T, dtype):
    """The GRU forward above H = 256 (one cooperative launch, each CTA a
    slice of the units with their W_h values in shared memory, h through L2
    and a grid barrier a step), both variants: within the dtype's tolerance
    of the plain version, two launches bit for bit, each counted by the
    variant's counter and `grid_launches`; an all-zero reset plane gives
    the no-reset kernel's bits."""
    args = _gru_args(B, T, H, H, dtype, cuda, seed=H + B + T)
    assert k_gru.launch_config(B, T, H, H, dtype)["layout"] == "grid"
    for reset in (None, _reset_plane(B, T, cuda, seed=H)):
        counter = "launches" if reset is None else "reset_launches"
        before = [getattr(k_gru.gru_scan, c) for c in (counter, "grid_launches")]
        ys = k_gru.gru_scan(*args, reset_mask=reset)[0]
        again = k_gru.gru_scan(*args, reset_mask=reset)[0]
        torch.cuda.synchronize()
        assert [getattr(k_gru.gru_scan, c) for c in (counter, "grid_launches")] == [
            n + 2 for n in before]
        assert torch.equal(ys, again)
        want, _ = k_gru.plain(*args, reset_mask=reset)
        torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
        if reset is not None:
            assert torch.equal(k_gru.gru_scan(*args, reset_mask=torch.zeros_like(reset))[0],
                               k_gru.gru_scan(*args)[0])


@pytest.mark.parametrize("dtype,h_in_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("H,B,T", GRID_SHAPES)
def test_gru_grid_backward_matches_plain_twice(cuda, H, B, T, dtype, h_in_dtype):
    """The reverse recurrence above H = 256 (each CTA publishes its units'
    d_hproj, a grid barrier, then forms dh_prev for its units from the whole
    d_hproj of its rows), with and without a keep plane, h_in in either
    dtype under bf16 weights: d_xp, dh0 and dn_r within 1e-4 of the plain
    f32 loop relative to their largest values, two launches bit for bit."""
    x_proj, h_proj, h_in, g, w_h = _gate_planes(B, T, H, dtype, cuda, seed=H + B + T)
    assert k_gru.backward_launch_config(B, T, H, dtype, h_in_dtype=h_in_dtype)[
        "layout"] == "grid"
    for keep in (None, (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]):
        h = h_in.to(h_in_dtype) if keep is None else (h_in.float() * keep).to(h_in_dtype)
        planes = (x_proj, h_proj, h, g, w_h)
        counter = "launches" if keep is None else "reset_launches"
        before = [getattr(k_gru.gru_backward, c) for c in (counter, "grid_launches")]
        got = k_gru.gru_backward(*planes, keep)
        again = k_gru.gru_backward(*planes, keep)
        torch.cuda.synchronize()
        assert [getattr(k_gru.gru_backward, c) for c in (counter, "grid_launches")] == [
            n + 2 for n in before]
        for name, a, b, c in zip(("d_xp", "dh0", "dn_r"), got, again,
                                 k_gru.plain_backward(*planes, keep)):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_grid_autograd_at_the_wide_demo_matches_plain(cuda, dtype):
    """gru_scan's autograd at the wide GRU4Rec's step (B=256, T=200,
    D=H=512): one forward and one reverse launch of the grid layout, each
    gradient within 2^-7 (bf16; 1e-4 in f32) relative to its largest value
    of reference.gru_bwd_math's on the kernel forward's states; twice bit
    for bit."""
    B, T, D, H = 256, 200, 512, 512
    args = _gru_args(B, T, D, H, dtype, cuda, seed=11)
    g = torch.from_numpy(np.random.default_rng(12).normal(scale=1e-2, size=(B, T, H))
                         .astype(np.float32)).to(cuda, dtype)
    x, h0, w_x, w_h, b_x, b_h = args

    def grads():
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, h0, w_x, w_h)]
        ys = k_gru.gru_scan(*leaves, b_x, b_h)[0]
        ys.backward(g)
        return ys.detach(), [t.grad for t in leaves]

    counts = lambda: (k_gru.gru_scan.grid_launches, k_gru.gru_backward.grid_launches)  # noqa: E731
    before = counts()
    ys, got = grads()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1)
    ys2, got2 = grads()
    assert torch.equal(ys, ys2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
    x_proj = torch.matmul(x.float(), wx_c.float()) + b_x
    d_xp, dh0, dwh, _ = reference.gru_bwd_math(x_proj, ys, h0, wh_c, b_h, g, None)
    want = [t.to(dtype) for t in (torch.matmul(d_xp, wx_c.float().T), dh0,
                                  torch.einsum("btd,btk->dk", x.float(), d_xp), dwh)]
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(("x", "h0", "w_x", "w_h"), got, want):
        err = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [260, 384, 512, 1000, 1024])
@pytest.mark.parametrize("N,S", [(1, 512), (257, 100), (51_200, 512)])
def test_head_ksplit_matches_plain_twice(cuda, N, S, H, dtype):
    """The head above H = 256 (bf16: 64-row blocks with their h rows
    resident, H walked in chunks of 128 through the negatives' ring; f32:
    32-row blocks): within 1e-5 of the plain version (1e-4 in f32, as
    HEAD_TOL), twice bit for bit, counted by `ksplit_launches`. Row 0's
    target is every negative's id: its NLL is 0 on both sides."""
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(N, S, H, dtype, cuda, seed=N + H)
    neg_ids[:] = 3 * S + 1
    targets[0] = 3 * S + 1
    assert k_head.launch_config(N, S, H, dtype)["layout"] == "k-split"
    before = [k_head.sampled_softmax_nll.launches, k_head.sampled_softmax_nll.ksplit_launches]
    got = k_head.sampled_softmax_nll(h, pos, neg, targets, neg_ids, plq, nlq)
    again = k_head.sampled_softmax_nll(h, pos, neg, targets, neg_ids, plq, nlq)
    torch.cuda.synchronize()
    assert [k_head.sampled_softmax_nll.launches,
            k_head.sampled_softmax_nll.ksplit_launches] == [n + 2 for n in before]
    assert torch.equal(got, again)
    want = k_head.plain(h, pos, neg, targets, neg_ids, plq, nlq)
    tol = 1e-4 if dtype == torch.float32 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert got[0].item() == 0.0 and want[0].item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_ksplit_odd_width_and_the_limit(cuda, dtype):
    """An odd width past 256 (bf16 copies one element at a time, f32 reads
    the positive logit a float at a time) and the widest H each design
    takes, against the plain version; one past it takes the streamed
    layout."""
    limit = k_head.max_hidden(dtype)
    for H in (257, limit):
        args = _head_args(300, 130, H, dtype, cuda, seed=H)
        tol = 1e-4 if dtype == torch.float32 else 1e-5
        torch.testing.assert_close(k_head.sampled_softmax_nll(*args), k_head.plain(*args),
                                   rtol=tol, atol=tol)
    args = _head_args(8, 16, limit + 1, dtype, cuda)
    before = k_head.sampled_softmax_nll.streamed_launches
    tol = 1e-4 if dtype == torch.float32 else 1e-5
    torch.testing.assert_close(k_head.sampled_softmax_nll(*args), k_head.plain(*args),
                               rtol=tol, atol=tol)
    assert k_head.sampled_softmax_nll.streamed_launches == before + 1


# ---------------------------------------------------------------------------
# Above H = 256: the LSTM's grid-persistent layout
# ---------------------------------------------------------------------------

LSTM_GRID_SHAPES = [(H, B, T) for H in (260, 384, 512, 1000) for B in (1, 3, 8, 256)
                    for T in (1, 7, 50)]
LSTM_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _lstm_grid_forward_twice(args, reset, dtype):
    """Two launches of lstm_scan's grid layout (counted by the variant's
    counter and `grid_launches`), bit for bit, within the LSTM's forward
    tolerance of the plain version (ys and c_last); ys."""
    counter = "launches" if reset is None else "reset_launches"
    before = [getattr(k_lstm.lstm_scan, c) for c in (counter, "grid_launches")]
    ys, (h, c) = k_lstm.lstm_scan(*args, reset_mask=reset)
    again, (_, c2) = k_lstm.lstm_scan(*args, reset_mask=reset)
    torch.cuda.synchronize()
    assert [getattr(k_lstm.lstm_scan, c) for c in (counter, "grid_launches")] == [
        n + 2 for n in before]
    assert torch.equal(ys, again) and torch.equal(c, c2) and torch.equal(h, ys[:, -1])
    want, (_, c_want) = k_lstm.plain(*args, reset_mask=reset)
    tol = LSTM_FWD_TOL[dtype]
    torch.testing.assert_close(ys.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c.float(), c_want.float(), rtol=tol, atol=tol)
    return ys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,B,T", LSTM_GRID_SHAPES)
def test_lstm_grid_forward_matches_plain_twice(cuda, H, B, T, dtype):
    """The LSTM forward above H = 256 (one cooperative launch, each CTA a
    slice of the units with their W_h values of four gates in shared memory,
    h through L2 and a grid barrier a step, c in the owner lane's f32 plane),
    both variants (with a carried-in h0, c0): within the dtype's tolerance
    of the plain version, two launches bit for bit; an all-zero reset plane
    gives the no-reset kernel's bits; the f32 cell plane it writes for the
    backward is the plain serial recompute's, and c_last its last step."""
    args = _lstm_args(B, T, H, H, dtype, cuda, seed=H + B + T)
    assert k_lstm.launch_config(B, T, H, H, dtype)["layout"] == "grid"
    for reset in (None, _reset_plane(B, T, cuda, seed=H)):
        _lstm_grid_forward_twice(args, reset, dtype)
        if reset is not None:
            zero = k_lstm.lstm_scan(*args, reset_mask=torch.zeros_like(reset))
            base = k_lstm.lstm_scan(*args)
            assert torch.equal(zero[0], base[0]) and torch.equal(zero[1][1], base[1][1])
        x, h0, c0, w_x, w_h, b = args
        wx, wh = w_x.to(dtype), w_h.to(dtype)
        ys, c_last, cs = k_lstm._forward_kernel(x, h0, c0, wx, wh, b, True,
                                                None if reset is None else 1.0 - reset)
        x_proj = torch.matmul(x.float(), wx.float()) + b
        cells = reference.lstm_recompute_cells(x_proj, ys, h0, c0, wh, reset)
        torch.testing.assert_close(cs, cells, rtol=1e-4, atol=1e-4)
        assert torch.equal(c_last, cs[:, -1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,B,T", LSTM_GRID_SHAPES)
def test_lstm_grid_backward_matches_plain_twice(cuda, H, B, T, dtype):
    """The reverse recurrence above H = 256 (each CTA publishes its units'
    dz, bf16 as hi and lo terms, a grid barrier, then forms dh_prev for its
    units from the whole dz of its rows; dh and dc carried per pair from
    dc_last), with and without a keep plane: dz, dh0 and dc0 within 1e-4 of
    the plain f32 loop relative to their largest values, two launches bit
    for bit; an all-ones keep plane gives the no-keep kernel's bits."""
    planes = _lstm_planes(B, T, H, dtype, cuda, seed=H + B + T)
    dc_last = torch.randn(B, H, device=cuda, generator=torch.Generator(cuda).manual_seed(H + B))
    assert k_lstm.backward_launch_config(B, T, H, dtype)["layout"] == "grid"
    for keep in (None, (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]):
        counter = "launches" if keep is None else "reset_launches"
        before = [getattr(k_lstm.lstm_backward, c) for c in (counter, "grid_launches")]
        got = k_lstm.lstm_backward(*planes, keep, dc_last)
        again = k_lstm.lstm_backward(*planes, keep, dc_last)
        torch.cuda.synchronize()
        assert [getattr(k_lstm.lstm_backward, c) for c in (counter, "grid_launches")] == [
            n + 2 for n in before]
        for name, a, b, c in zip(("dz", "dh0", "dc0"), got, again,
                                 k_lstm.plain_backward(*planes, keep, dc_last)):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(),
                                       msg=name)
        if keep is not None:
            for a, b in zip(k_lstm.lstm_backward(*planes, torch.ones_like(keep), dc_last),
                            k_lstm.lstm_backward(*planes, None, dc_last)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_grid_at_its_limit_and_past_it(cuda, dtype):
    """The widest H each dtype's grid layout takes (bf16 1,792: a CTA's
    W_h values of four gates fill its shared memory; f32 1,056: 132 slices
    of 8 units, one a SM), forward with a reset plane and reverse with a
    keep plane, against the plain versions; one past it takes the stepped
    layout, against the plain versions too."""
    limit = k_lstm.grid_max_hidden(dtype)
    B, T = 5, 6
    args = _lstm_args(B, T, limit, limit, dtype, cuda, seed=limit)
    reset = _reset_plane(B, T, cuda, seed=limit)
    _lstm_grid_forward_twice(args, reset, dtype)
    planes = _lstm_planes(B, T, limit, dtype, cuda, seed=limit)
    keep = (1.0 - reset)[:, :, None]
    dc_last = torch.randn(B, limit, device=cuda)
    for name, a, c in zip(("dz", "dh0", "dc0"), k_lstm.lstm_backward(*planes, keep, dc_last),
                          k_lstm.plain_backward(*planes, keep, dc_last)):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(), msg=name)
    past = _lstm_args(B, T, limit + 4, limit + 4, dtype, cuda)
    before = (k_lstm.lstm_scan.stepped_launches, k_lstm.lstm_backward.stepped_launches)
    torch.testing.assert_close(k_lstm.lstm_scan(*past)[0].float(), k_lstm.plain(*past)[0].float(),
                               rtol=LSTM_FWD_TOL[dtype], atol=LSTM_FWD_TOL[dtype])
    planes = _lstm_planes(B, T, limit + 4, dtype, cuda)
    for name, a, c in zip(("dz", "dh0", "dc0"), k_lstm.lstm_backward(*planes, None, None),
                          k_lstm.plain_backward(*planes, None, None)):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(), msg=name)
    assert (k_lstm.lstm_scan.stepped_launches, k_lstm.lstm_backward.stepped_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_grid_autograd_at_the_wide_lstm_matches_plain(cuda, dtype):
    """lstm_scan's autograd at the wide LSTM's step (B=256, T=200, D=H=512),
    with c_last in the loss: one forward and one reverse launch of the grid
    layout, each gradient within 2^-7 (bf16; 1e-4 in f32) relative to its
    largest value of reference.lstm_bwd_math's on the kernel forward's
    states; twice bit for bit."""
    B, T, D, H = 256, 200, 512, 512
    x, h0, c0, w_x, w_h, b = _lstm_args(B, T, D, H, dtype, cuda, seed=11)
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(B, T, H)).astype(np.float32)).to(cuda, dtype)
    g_c = torch.from_numpy(rng.normal(scale=1e-2, size=(B, H)).astype(np.float32)).to(cuda, dtype)

    def grads():
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, h0, c0, w_x, w_h)]
        ys, (_, c_last) = k_lstm.lstm_scan(*leaves, b)
        torch.autograd.backward((ys, c_last), (g, g_c))
        return ys.detach(), [t.grad for t in leaves]

    counts = lambda: (k_lstm.lstm_scan.grid_launches, k_lstm.lstm_backward.grid_launches)  # noqa: E731
    before = counts()
    ys, got = grads()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1)
    ys2, got2 = grads()
    assert torch.equal(ys, ys2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
    x_proj = torch.matmul(x.float(), wx_c.float()) + b
    with torch.no_grad():
        _, _, cs = k_lstm._forward_kernel(x, h0, c0, wx_c, wh_c, b, True)
    d_xp, dh0, dc0, dwh, _ = reference.lstm_bwd_math(x_proj, ys, cs, h0, c0, wh_c, g, None,
                                                     dc_last=g_c)
    want = [t.to(dtype) for t in (torch.matmul(d_xp, wx_c.float().T), dh0, dc0,
                                  torch.einsum("btd,btk->dk", x.float(), d_xp), dwh)]
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    for name, a, w in zip(("x", "h0", "c0", "w_x", "w_h"), got, want):
        err = (a.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= tol, (name, err)


# ---------------------------------------------------------------------------
# Every width: the Dh-sliced attention, the padded and stepped scans, the
# streamed head
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [257, 512, 1000])
@pytest.mark.parametrize("B,T,N", [(2, 200, 1), (3, 65, 2), (1, 1, 1)])
def test_attention_sliced_matches_plain_twice(cuda, dtype, Dh, B, T, N):
    """Past Dh = 256 (a third grid axis of 256-column slices, S over the
    whole Dh in chunks of 64 through shared memory): within the attention's
    tolerances of the plain version, on q, k, v read in place as slices of
    one [B, T, 3, N, Dh] projection, twice bit for bit, counted by
    `sliced_launches`; the first B - 1 rows alone give the batch's bits."""
    rng = np.random.default_rng(Dh + T)
    proj = torch.from_numpy(rng.normal(size=(B, T, 3, N, Dh)).astype(np.float32)).to(cuda, dtype)
    q, k, v = proj.unbind(2)
    cfg = k_attn.launch_config(B, T, N, Dh, dtype, k_attn.operand_align(q, k, v))
    assert cfg["layout"] == "dh-sliced" and cfg["slices"] == -(-Dh // 256)
    before = [k_attn.causal_attention.launches, k_attn.causal_attention.sliced_launches]
    got = k_attn.causal_attention(q, k, v)
    again = k_attn.causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert [k_attn.causal_attention.launches, k_attn.causal_attention.sliced_launches] == [
        n + 2 for n in before]
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), k_attn.plain(q, k, v).float(), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])
    if dtype == torch.bfloat16:  # the kernel's own rounding only: f32 math on the same inputs
        torch.testing.assert_close(got.float(), k_attn.plain(q.float(), k.float(), v.float()),
                                   rtol=2e-2, atol=2e-2)
    if B > 1:
        assert torch.equal(k_attn.causal_attention(q[:B - 1], k[:B - 1], v[:B - 1]), got[:B - 1])


PAD_SHAPES = [(50, 50), (50, 102), (13, 7), (50, 64)]  # the last pads D alone


def _grads(scan, leaves, rest, reset, g, g_c=None):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = scan(*leaves, *rest, reset_mask=reset)
    if g_c is None:
        out[0].backward(g)
    else:
        torch.autograd.backward((out[0], out[1][1]), (g, g_c))
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H", PAD_SHAPES)
@pytest.mark.parametrize("with_reset", [False, True])
def test_gru_padded_matches_plain_twice(cuda, dtype, D, H, with_reset):
    """D or H not a multiple of 4 (SASRec's d = 50 in a GRU4Rec tower): the
    padded route (zero units and inputs up to multiples of 4, each gate
    block on its own) against the plain version, forward and every gradient
    through autograd (1e-4 relative in f32; bf16 against the plain f32 loop
    on the kernel forward's states at 2^-7), twice bit for bit, counted by
    the forward's `padded_launches`, and the reverse's where H is padded."""
    B, T = 64, 50
    x, h0, w_x, w_h, b_x, b_h = _gru_args(B, T, D, H, dtype, cuda, seed=D + H)
    reset = _reset_plane(B, T, cuda, seed=H) if with_reset else None
    g = torch.from_numpy(np.random.default_rng(H).normal(scale=1e-2, size=(B, T, H))
                         .astype(np.float32)).to(cuda, dtype)
    cfg = k_gru.padded_launch_config(B, T, D, H, dtype)
    assert cfg["route"] == "padded" and cfg["padded_to"] == [-(-D // 4) * 4, -(-H // 4) * 4]
    before = (k_gru.gru_scan.padded_launches, k_gru.gru_backward.padded_launches)
    (ys, h_last), got = _grads(k_gru.gru_scan, (x, h0, w_x, w_h), (b_x, b_h), reset, g)
    (ys2, _), got2 = _grads(k_gru.gru_scan, (x, h0, w_x, w_h), (b_x, b_h), reset, g)
    torch.cuda.synchronize()
    assert (k_gru.gru_scan.padded_launches, k_gru.gru_backward.padded_launches) == (
        before[0] + 2, before[1] + 2 * (H % 4 != 0))
    assert torch.equal(ys, ys2) and all(torch.equal(a, b) for a, b in zip(got, got2))
    assert tuple(ys.shape) == (B, T, H) and torch.equal(h_last, ys[:, -1])
    want, _ = k_gru.plain(x, h0, w_x, w_h, b_x, b_h, reset_mask=reset)
    torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == torch.float32:
        _, want_g = _grads(k_gru.plain, (x, h0, w_x, w_h), (b_x, b_h), reset, g)
        tol = 1e-4
    else:
        x_proj = torch.matmul(x.float(), w_x.to(dtype).float()) + b_x
        d_xp, dh0, dwh, _ = reference.gru_bwd_math(x_proj, ys.detach(), h0, w_h.to(dtype), b_h,
                                                   g, reset)
        want_g = [t.to(dtype) for t in (torch.matmul(d_xp, w_x.to(dtype).float().T), dh0,
                                        torch.einsum("btd,btk->dk", x.float(), d_xp), dwh)]
        tol = 2 ** -7
    for name, a, b in zip(("x", "h0", "w_x", "w_h"), got, want_g):
        err = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H", PAD_SHAPES)
@pytest.mark.parametrize("with_reset", [False, True])
def test_lstm_padded_matches_plain_twice(cuda, dtype, D, H, with_reset):
    """The LSTM's padded route, as the GRU's: forward (c_last included) and
    every gradient through autograd with c_last in the loss, twice bit for
    bit, counted by the forward's `padded_launches`, and the reverse's where
    H is padded."""
    B, T = 64, 50
    x, h0, c0, w_x, w_h, b = _lstm_args(B, T, D, H, dtype, cuda, seed=D + H)
    reset = _reset_plane(B, T, cuda, seed=H) if with_reset else None
    rng = np.random.default_rng(H)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(B, T, H)).astype(np.float32)).to(cuda, dtype)
    g_c = torch.from_numpy(rng.normal(scale=1e-2, size=(B, H)).astype(np.float32)).to(cuda, dtype)
    assert k_lstm.padded_launch_config(B, T, D, H, dtype)["route"] == "padded"
    before = (k_lstm.lstm_scan.padded_launches, k_lstm.lstm_backward.padded_launches)
    (ys, (_, c_last)), got = _grads(k_lstm.lstm_scan, (x, h0, c0, w_x, w_h), (b,), reset, g, g_c)
    (ys2, (_, c2)), got2 = _grads(k_lstm.lstm_scan, (x, h0, c0, w_x, w_h), (b,), reset, g, g_c)
    torch.cuda.synchronize()
    assert (k_lstm.lstm_scan.padded_launches, k_lstm.lstm_backward.padded_launches) == (
        before[0] + 2, before[1] + 2 * (H % 4 != 0))
    assert torch.equal(ys, ys2) and torch.equal(c_last, c2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, got2))
    want, (_, c_want) = k_lstm.plain(x, h0, c0, w_x, w_h, b, reset_mask=reset)
    tol = LSTM_FWD_TOL[dtype]
    torch.testing.assert_close(ys.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c_last.float(), c_want.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:
        _, want_g = _grads(k_lstm.plain, (x, h0, c0, w_x, w_h), (b,), reset, g, g_c)
        for name, a, w in zip(("x", "h0", "c0", "w_x", "w_h"), got, want_g):
            err = (a - w).abs().max().item() / w.abs().max().item()
            assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("H", [50, 102])
@pytest.mark.parametrize("with_keep", [False, True])
def test_padded_reverse_recurrences_match_plain(cuda, H, with_keep):
    """gru_backward and lstm_backward called at H % 4 != 0 in both weight
    dtypes: padded, launched, sliced back; within 1e-4 of the plain loops
    relative to the largest value, twice bit for bit."""
    B, T = 64, 50
    keep = (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None] if with_keep else None
    for dtype in (torch.float32, torch.bfloat16):
        x_proj, h_proj, h_in, g, w_h = _gate_planes(B, T, H, dtype, cuda, seed=H)
        h = h_in if keep is None else (h_in.float() * keep)
        planes = (x_proj, h_proj, h if dtype == torch.bfloat16 else h.float(), g, w_h)
        before = k_gru.gru_backward.padded_launches
        got, again = k_gru.gru_backward(*planes, keep), k_gru.gru_backward(*planes, keep)
        assert k_gru.gru_backward.padded_launches == before + 2
        for name, a, a2, c in zip(("d_xp", "dh0", "dn_r"), got, again,
                                  k_gru.plain_backward(*planes, keep)):
            assert torch.equal(a, a2) and a.shape == c.shape, name
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(),
                                       msg=name)
        lp = _lstm_planes(B, T, H, dtype, cuda, seed=H)
        dcl = torch.randn(B, H, device=cuda)
        got, again = (k_lstm.lstm_backward(*lp, keep, dcl) for _ in range(2))
        for name, a, a2, c in zip(("dz", "dh0", "dc0"), got, again,
                                  k_lstm.plain_backward(*lp, keep, dcl)):
            assert torch.equal(a, a2) and a.shape == c.shape, name
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("D,N", [(50, 150), (13, 21), (50, 200)])
def test_input_projections_pad_any_width(cuda, D, N):
    """The projection GEMMs at D or N not a multiple of 4 (zero rows and
    columns, then sliced): bf16 within 1e-5 of the plain f32 sums of the same
    bf16 products, f32 within 1e-5."""
    rng = np.random.default_rng(D + N)
    x = torch.from_numpy(rng.normal(size=(3, 17, D)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32) * D ** -0.5).to(cuda)
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        for module, proj in ((k_gru, k_gru.gru_input_projection),
                             (k_lstm, k_lstm.lstm_input_projection)):
            if proj is k_lstm.lstm_input_projection and N % 4:
                continue  # the LSTM's N is 4H
            got = proj(x.to(dtype), w.to(dtype), b)
            want = module.plain_input_projection(x.to(dtype), w.to(dtype), b)
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _stepped_widths(dtype, gates):
    limit = k_gru.grid_max_hidden(dtype, gates)
    return (limit + 4, 2302)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [0, 1])
@pytest.mark.parametrize("B,T", [(3, 7), (64, 1)])
def test_gru_stepped_forward_matches_plain_twice(cuda, dtype, edge, B, T):
    """Past the grid layout's limit (the step's GEMM, then its gate kernel,
    T times): at the limit + 4 and at 2,302 (padded to 2,304 too), both
    variants, within the dtype's tolerance of the plain version, twice bit
    for bit, counted by `stepped_launches`; an all-zero reset plane gives
    the no-reset bits."""
    H = _stepped_widths(dtype, 3)[edge]
    args = _gru_args(B, T, 64, H, dtype, cuda, seed=H + B)
    assert k_gru.padded_launch_config(B, T, 64, H, dtype)["layout"] == "stepped"
    for reset in (None, _reset_plane(B, T, cuda, seed=H)):
        before = k_gru.gru_scan.stepped_launches
        ys = k_gru.gru_scan(*args, reset_mask=reset)[0]
        again = k_gru.gru_scan(*args, reset_mask=reset)[0]
        torch.cuda.synchronize()
        assert k_gru.gru_scan.stepped_launches == before + 2
        assert torch.equal(ys, again)
        want, _ = k_gru.plain(*args, reset_mask=reset)
        torch.testing.assert_close(ys.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
        if reset is not None:
            assert torch.equal(k_gru.gru_scan(*args, reset_mask=torch.zeros_like(reset))[0],
                               k_gru.gru_scan(*args)[0])


@pytest.mark.parametrize("dtype,h_in_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("edge", [0, 1])
def test_gru_stepped_backward_matches_plain_twice(cuda, dtype, h_in_dtype, edge):
    """The stepped reverse recurrence (the step's gates, then dh_prev =
    d_hproj W_h^T as one GEMM, bf16 as hi and lo terms), with and without
    a keep plane: within 1e-4 of the plain f32 loop relative to the largest
    value, twice bit for bit, counted by `stepped_launches`."""
    B, T = 5, 6
    H = _stepped_widths(dtype, 3)[edge]
    x_proj, h_proj, h_in, g, w_h = _gate_planes(B, T, H, dtype, cuda, seed=H)
    for keep in (None, (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]):
        h = h_in.to(h_in_dtype) if keep is None else (h_in.float() * keep).to(h_in_dtype)
        planes = (x_proj, h_proj, h, g, w_h)
        before = k_gru.gru_backward.stepped_launches
        got, again = k_gru.gru_backward(*planes, keep), k_gru.gru_backward(*planes, keep)
        torch.cuda.synchronize()
        assert k_gru.gru_backward.stepped_launches == before + 2
        for name, a, b, c in zip(("d_xp", "dh0", "dn_r"), got, again,
                                 k_gru.plain_backward(*planes, keep)):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4 * c.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [0, 1])
def test_lstm_stepped_matches_plain_twice(cuda, dtype, edge):
    """The LSTM past its grid limit, forward with and without a reset plane
    (c_last included; the f32 cell plane against reference.lstm_recompute_cells
    in f32) and the reverse with and without a keep plane and a dc_last,
    against the plain versions, twice bit for bit."""
    B, T = 3, 7
    H = _stepped_widths(dtype, 4)[edge]
    args = _lstm_args(B, T, 32, H, dtype, cuda, seed=H)
    for reset in (None, _reset_plane(B, T, cuda, seed=H)):
        before = k_lstm.lstm_scan.stepped_launches
        ys, (_, c) = k_lstm.lstm_scan(*args, reset_mask=reset)
        ys2, (_, c2) = k_lstm.lstm_scan(*args, reset_mask=reset)
        torch.cuda.synchronize()
        assert k_lstm.lstm_scan.stepped_launches == before + 2
        assert torch.equal(ys, ys2) and torch.equal(c, c2)
        want, (_, c_want) = k_lstm.plain(*args, reset_mask=reset)
        tol = LSTM_FWD_TOL[dtype]
        torch.testing.assert_close(ys.float(), want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(c.float(), c_want.float(), rtol=tol, atol=tol)
    if H % 4 == 0 and dtype == torch.float32:
        x, h0, c0, w_x, w_h, b = args
        with torch.no_grad():
            _, _, cs = k_lstm._forward_kernel(x, h0, c0, w_x, w_h, b, True)
            x_proj = torch.matmul(x, w_x) + b
            want_cs = reference.lstm_recompute_cells(x_proj, k_lstm.lstm_scan(*args)[0], h0, c0, w_h)
        torch.testing.assert_close(cs, want_cs, rtol=1e-5, atol=1e-5)
    planes = _lstm_planes(B, T, H, dtype, cuda, seed=H)
    for keep in (None, (1.0 - _reset_plane(B, T, cuda, seed=H))[:, :, None]):
        dcl = torch.randn(B, H, device=cuda)
        got, again = (k_lstm.lstm_backward(*planes, keep, dcl) for _ in range(2))
        for name, a, a2, w in zip(("dz", "dh0", "dc0"), got, again,
                                  k_lstm.plain_backward(*planes, keep, dcl)):
            assert torch.equal(a, a2), name
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4 * w.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stepped_autograd_matches_plain(cuda, dtype, cell):
    """A whole scan's gradients through autograd past the grid limit (D =
    64, H = 2,304, B = 4, T = 5): one stepped forward and one stepped reverse,
    each gradient within 2^-7 (bf16; 1e-4 in f32) relative to its largest
    value of the plain reverse loop on the kernel forward's states."""
    B, T, D, H = 4, 5, 64, 2304
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(B, T, H)).astype(np.float32)).to(cuda, dtype)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    if cell == "gru":
        x, h0, w_x, w_h, b_x, b_h = _gru_args(B, T, D, H, dtype, cuda, seed=3)
        before = (k_gru.gru_scan.stepped_launches, k_gru.gru_backward.stepped_launches)
        (ys, _), got = _grads(k_gru.gru_scan, (x, h0, w_x, w_h), (b_x, b_h), None, g)
        assert (k_gru.gru_scan.stepped_launches, k_gru.gru_backward.stepped_launches) == (
            before[0] + 1, before[1] + 1)
        wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
        x_proj = torch.matmul(x.float(), wx_c.float()) + b_x
        d_xp, dh0, dwh, _ = reference.gru_bwd_math(x_proj, ys.detach(), h0, wh_c, b_h, g, None)
        want = [torch.matmul(d_xp, wx_c.float().T), dh0,
                torch.einsum("btd,btk->dk", x.float(), d_xp), dwh]
    else:
        x, h0, c0, w_x, w_h, b = _lstm_args(B, T, D, H, dtype, cuda, seed=3)
        before = (k_lstm.lstm_scan.stepped_launches, k_lstm.lstm_backward.stepped_launches)
        (ys, _), got = _grads(k_lstm.lstm_scan, (x, h0, c0, w_x, w_h), (b,), None, g)
        assert (k_lstm.lstm_scan.stepped_launches, k_lstm.lstm_backward.stepped_launches) == (
            before[0] + 1, before[1] + 1)
        wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
        x_proj = torch.matmul(x.float(), wx_c.float()) + b
        with torch.no_grad():
            _, _, cs = k_lstm._forward_kernel(x, h0, c0, wx_c, wh_c, b, True)
        d_xp, dh0, dc0, dwh, _ = reference.lstm_bwd_math(x_proj, ys.detach(), cs, h0, c0, wh_c,
                                                         g, None)
        want = [torch.matmul(d_xp, wx_c.float().T), dh0, dc0,
                torch.einsum("btd,btk->dk", x.float(), d_xp), dwh]
    for i, (a, w) in enumerate(zip(got, want)):
        err = (a.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= tol, (i, err)


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("H", [2116, 2304])
@pytest.mark.parametrize("B", [1, 3, 16, 256, 300])
def test_step_gemm_matches_matmul_twice(cuda, B, H, G, terms):
    """The stepped layouts' bf16 step GEMM alone (TMA, or cp.async's 8-byte
    pieces where a row stride is no 16-byte multiple: H = 2,116 but for the
    LSTM's reverse, whose K = 4H; B = 300 two row blocks): forward h [B, H] @ W_h [H, G H],
    reverse [hi | lo] [B, 2 G H] on W_h as stored; its partial planes
    summed in split order within 1e-5 of torch.matmul in f32 on the same
    bf16 values (reverse: (hi + lo) @ W_h^T, hi + lo exact in f32) relative
    to the largest value, 5e-5 in the reverse (2 K products a sum: up to
    2.2e-5 in one plane on an H100, kernel_probes.py step_gemm): exact
    products, f32 sums in another order; the planes within the same of the
    plain version's, twice bit for bit, counted by `launches` (forward) or
    `reverse_launches`; planned for the card's SMs, as the C side plans."""
    rng = np.random.default_rng(B * H + 10 * G + terms)
    w = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(H, G * H)).astype(np.float32))
    w = w.to(cuda, torch.bfloat16)
    if terms == 1:
        a = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(cuda, torch.bfloat16)
        want = a.float() @ w.float()
    else:
        d = torch.from_numpy(rng.normal(scale=1e-2, size=(B, G * H)).astype(np.float32)).to(cuda)
        hi = d.bfloat16()
        lo = (d - hi.float()).bfloat16()
        a = torch.cat([hi, lo], dim=1)
        want = (hi.float() + lo.float()) @ w.float().T
    K, N = (G * H, H) if terms == 2 else (H, G * H)
    cfg = k_gru.step_gemm_config(B, K, N, terms)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cfg == k_gru.step_gemm_config(B, K, N, terms, sms=sms)  # the C plan's count
    assert cfg["tma"] == (K % 8 == 0 and (terms == 2 or N % 8 == 0))
    counter = "launches" if terms == 1 else "reverse_launches"
    before = getattr(k_gru.step_gemm, counter)
    got, again = k_gru.step_gemm(a, w, terms), k_gru.step_gemm(a, w, terms)
    torch.cuda.synchronize()
    assert getattr(k_gru.step_gemm, counter) == before + 2
    assert tuple(got.shape) == (cfg["splits"], B, N) and got.dtype == torch.float32
    assert torch.equal(got, again)
    scale, tol = want.abs().max().item(), (1e-5 if terms == 1 else 5e-5)
    torch.testing.assert_close(k_gru.step_product(got), want, rtol=tol, atol=tol * scale)
    torch.testing.assert_close(got, k_gru.plain_step_gemm(a, w, terms), rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [0, 1])
@pytest.mark.parametrize("N,S", [(1, 512), (257, 100), (300, 130)])
def test_head_streamed_matches_plain_twice(cuda, dtype, edge, N, S):
    """Past the resident rows' limit (h's chunks streamed through the ring
    beside the negatives'): at the limit + 1 (an odd width: bf16 one
    element a copy, f32 the positive logit a float at a time) and at 2,304,
    within 1e-4 of the plain version (chip_smoke's HEAD_TOL: f32 sums of up
    to 2,304 products in another order), twice bit for bit,
    counted by `streamed_launches`; row 0's target is every negative's id:
    its NLL is 0 on both sides."""
    H = (k_head.max_hidden(dtype) + 1, 2304)[edge]
    h, pos, neg, targets, neg_ids, plq, nlq = _head_args(N, S, H, dtype, cuda, seed=N + H)
    if N == 1:
        neg_ids[:] = 3 * S + 1
        targets[0] = 3 * S + 1
    assert k_head.launch_config(N, S, H, dtype)["layout"] == "streamed"
    before = [k_head.sampled_softmax_nll.launches, k_head.sampled_softmax_nll.streamed_launches]
    args = (h, pos, neg, targets, neg_ids, plq, nlq)
    got, again = k_head.sampled_softmax_nll(*args), k_head.sampled_softmax_nll(*args)
    torch.cuda.synchronize()
    assert [k_head.sampled_softmax_nll.launches,
            k_head.sampled_softmax_nll.streamed_launches] == [n + 2 for n in before]
    assert torch.equal(got, again)
    want = k_head.plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if N == 1:
        assert got[0].item() == 0.0 and want[0].item() == 0.0


# The bf16 input projection's shapes (M = B T, D, N): the narrow GRU and LSTM
# (serving's B=64 and training's B=128 at T=200, D=H=128), rsc15 (D=H=100,
# 8-byte rows: cp.async), d = 50 padded to 52, the wide GRU4Rec and LSTM
# (D=H=512) and w3 (D=H=2,304).
XPROJ_SHAPES = [(12800, 128, 384), (25600, 128, 512), (12800, 100, 300), (25600, 52, 156),
                (25600, 52, 208), (51200, 512, 1536), (51200, 512, 2048), (51200, 2304, 6912),
                (51200, 2304, 9216), (3, 64, 12), (130, 2304, 260)]


@pytest.mark.parametrize("M,D,N", XPROJ_SHAPES)
def test_input_projection_matches_addmm_twice(cuda, M, D, N):
    """The bf16 input projection (csrc/rnn.cuh xproj_wgmma_kernel) through
    the GRU's wrapper (N = 3H) or the LSTM's (N = 4H, where 4 divides N / 4
    and it is the LSTM's shape) against its plain version and
    torch.addmm(b, x, w_x, out_dtype=torch.float32), within 1e-5 absolute
    at D <= 256 (chip_smoke's XPROJ_TOL) and 1e-5 of the largest value above
    (the step GEMM's forward rule: up to 2,304 exact bf16 products summed in
    f32 in another order), twice bit for bit, one launch each, planned for
    the card's SMs as the C side plans."""
    rng = np.random.default_rng(M + D + N)
    x = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(M, D)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)  # embedding rows' scale, as the models feed it
    w_x = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(D, N)).astype(np.float32))
    w_x = w_x.to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.normal(scale=0.1, size=N).astype(np.float32)).to(cuda)
    lstm = N in (512, 208, 2048, 9216)
    project = k_lstm.lstm_input_projection if lstm else k_gru.gru_input_projection
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k_gru.xproj_config(M, D, N) == k_gru.xproj_config(M, D, N, sms=sms)
    before = project.launches
    got, again = project(x, w_x, b), project(x, w_x, b)
    torch.cuda.synchronize()
    assert project.launches == before + 2
    assert tuple(got.shape) == (M, N) and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = torch.addmm(b, x, w_x, out_dtype=torch.float32)
    tol = 1e-5 if D <= 256 else 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(got, k_gru.plain_input_projection(x, w_x, b), rtol=0, atol=tol)


@pytest.mark.parametrize("M,D,N", [(12800, 128, 384), (12800, 128, 512), (12800, 100, 300),
                                   (25600, 52, 208)])
def test_input_projection_runs_on_the_callers_stream(cuda, M, D, N):
    """The bf16 projection launched under `torch.cuda.stream(side)` runs on
    `side` (both wrappers, TMA and cp.async routes): `side` first sleeps
    ~30 ms, then overwrites x, then projects it. A launch on any other
    stream (or on a handle cut to 32 bits) reads the old x, or fails."""
    rng = np.random.default_rng(M + D + N)
    old, new = (torch.from_numpy(rng.normal(scale=D ** -0.5, size=(M, D)).astype(np.float32))
                .to(cuda, torch.bfloat16) for _ in range(2))
    w_x = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(D, N)).astype(np.float32))
    w_x = w_x.to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.normal(scale=0.1, size=N).astype(np.float32)).to(cuda)
    project = k_lstm.lstm_input_projection if N % 8 == 0 and N // 4 == D else (
        k_gru.gru_input_projection)
    x = old.clone()
    side = torch.cuda.Stream(cuda)
    assert side.cuda_stream != torch.cuda.current_stream(cuda).cuda_stream
    torch.cuda.synchronize()
    before = project.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)  # clock cycles
        x.copy_(new)
        got = project(x, w_x, b)
    assert not side.query()  # still asleep: the projection is queued behind the copy
    side.synchronize()
    assert project.launches == before + 1
    want = torch.addmm(b, new, w_x, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
