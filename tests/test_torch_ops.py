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


def _bits(a) -> np.ndarray:
    """The raw bits of a JAX or torch f32/bf16 array, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy().view(
            np.uint16 if a.dtype == torch.bfloat16 else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.name == "bfloat16" else np.uint32)


@pytest.mark.parametrize("table_dtype,dtype", [("float32", "bfloat16"), ("float32", "float32"),
                                               ("bfloat16", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_gather_dtype_matches_jax_astype_bit_for_bit(table_dtype, dtype):
    """`embedding_gather(table, ids, dtype=...)` is JAX's
    `embedding_gather(table, ids).astype(dtype)` (round to nearest even)
    bit for bit, NaN rows of out-of-range ids included, at D=64, through
    the plain version, the kernel wrapper and dispatch on the CPU."""
    rng = np.random.default_rng(64)
    table = rng.normal(size=(V, 64)).astype(np.float32)
    jdt, tdt = DTYPES[table_dtype]
    odt_j, odt_t = DTYPES[dtype]
    want = xla_ops.embedding_gather(jnp.asarray(table, jdt),
                                    jnp.asarray(_WRAP_AND_NAN_IDS)).astype(odt_j)
    t = torch.from_numpy(table).to(tdt)
    ids = torch.from_numpy(_WRAP_AND_NAN_IDS)
    for got in (reference.embedding_gather(t, ids, dtype=odt_t),
                cuda_gather.embedding_gather(t, ids, dtype=odt_t),
                dispatch.embedding_gather(t, ids, dtype=odt_t, use_pallas=False)):
        assert got.dtype == odt_t and tuple(got.shape) == (2, 5, 64)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ids", [_WRAP_AND_NAN_IDS, np.array([[1, 1, 1, 2, 1, 3]] * 4, np.int32)])
def test_gather_bf16_table_gradient_matches_jax_bit_for_bit(ids):
    """The table's gradient through the gather with a bf16 output: the bf16
    cotangent widened to f32 and added at each id (out-of-range ids
    dropped), as JAX's VJP of `embedding_gather(...).astype(bfloat16)`,
    bit for bit; the scatter-add launches nothing on the CPU."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(V, 64)).astype(np.float32)
    g = jnp.asarray(rng.normal(size=(*ids.shape, 64)).astype(np.float32), jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: xla_ops.embedding_gather(t, jnp.asarray(ids)).astype(jnp.bfloat16),
                     jnp.asarray(table))
    (want,) = vjp(g)
    t = torch.from_numpy(table).requires_grad_(True)
    before = cuda_gather.embedding_scatter_add.launches
    out = cuda_gather.embedding_gather(t, torch.from_numpy(ids), dtype=torch.bfloat16)
    out.backward(torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16))
    assert cuda_gather.embedding_scatter_add.launches == before
    assert t.grad.dtype == torch.float32
    np.testing.assert_array_equal(_bits(t.grad), _bits(want))


def test_gather_launchable_checks_at_d64():
    """The kernel's limits at the fit loop's width: an f32 or bf16 table of
    D=64 writes f32 or bf16 in 16-byte units; other output dtypes raise;
    rows that are not a 16-byte multiple (which the 16-byte design refused)
    take a narrower unit."""
    ids = torch.zeros(128, 200, dtype=torch.int32)
    for table_dtype in (torch.float32, torch.bfloat16):
        for dtype in (None, torch.float32, torch.bfloat16):
            cuda_gather.check_launchable(torch.zeros(3418, 64, dtype=table_dtype), ids, dtype)
    with pytest.raises(ValueError, match="output dtype"):
        cuda_gather.check_launchable(torch.zeros(3418, 64), ids, torch.float16)
    assert cuda_gather.check_launchable(torch.zeros(3418, 64), ids)["unit_bytes"] == 16
    assert cuda_gather.check_launchable(torch.zeros(3418, 4, dtype=torch.bfloat16),
                                        ids)["unit_bytes"] == 8
    g = torch.zeros(128, 200, 64, dtype=torch.bfloat16)
    assert cuda_gather.check_scatter_add_launchable(g, ids, 3418)["chunk"] == 512
    with pytest.raises(ValueError, match="g dtype"):
        cuda_gather.check_scatter_add_launchable(g.half(), ids, 3418)


@pytest.mark.parametrize("table,ids,match", [
    (torch.zeros(7, 16, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), "dtype"),
    (torch.zeros(7), torch.zeros(3, dtype=torch.int32), r"\[V, D\]"),
    (torch.zeros(7, 6), torch.zeros(3, dtype=torch.int32), None),  # 8-byte units now
    (torch.zeros(7, 16), torch.zeros(3), "ids dtype"),
    (torch.zeros(16, 7).T, torch.zeros(3, dtype=torch.int32), "contiguous"),
    (torch.zeros(7, 16), torch.zeros(3, dtype=torch.int32, device="meta"), "ids on"),
])
def test_gather_kernel_rejects_what_it_cannot_take(table, ids, match):
    """Other dtypes and shapes, non-contiguous tables and ids elsewhere
    raise; 24-byte f32 rows (refused by the 16-byte design) take 8-byte
    units."""
    if match is None:
        assert cuda_gather.check_launchable(table, ids)["unit_bytes"] == 8
        return
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
    """bf16: the tensor-core design, 8 rows a block (8 blocks at B=64), 8
    warps of 16 units at H=128 with W_h in registers, the h double buffer
    [2][128][8] bf16 (the input projection has a plan of its own,
    `xproj_config`: 128 x 64 tiles over B*T = 12,800 rows and 3H = 384
    columns, 600 tiles on two CTAs a SM). f32: the f32 projection (its own
    plan too, `xproj_f32_config`: at D = 128 the SIMT design, 600 tiles of
    64 x 128 on 4 CTAs a SM: 528 CTAs of 128 threads), then
    clusters of 4 CTAs over 4 rows (16 clusters, 64
    CTAs), each CTA 32 units of 8 k-slices of 16 (256 threads) with its
    W_h columns (48 KB, and in registers: 48 a thread), the h buffers
    [2][4][132] and the operand ring [4][256][4] f32 in shared memory."""
    bf16 = cuda_gru.launch_config(64, 200, 128, 128, torch.bfloat16)
    assert bf16 == {"design": "mma.sync", "grid": 8, "threads": 256, "rows_per_block": 8,
                    "hidden_padded": 128, "wh_in_regs": 1, "smem_bytes": 2 * 128 * 8 * 2}
    xp = cuda_gru.xproj_config(64 * 200, 128, 3 * 128, sms=cuda_gru.NUM_SMS)
    assert (xp["block"], xp["tiles"], xp["grid"], xp["route"]) == ([128, 64, 64], 600, 264, "tma")
    f32 = cuda_gru.launch_config(64, 200, 128, 128, torch.float32)
    assert f32 == {"design": "cluster", "cluster_size": 4, "rows_per_cluster": 4,
                   "clusters": 16, "grid": 64, "threads": 256, "units_per_cta": 32,
                   "k_slices": 8, "k_slice": 16,
                   "smem_bytes": (3 * 16 * 256 + 2 * 4 * 132 + 4 * 256 * 4) * 4 + 16,
                   "w_in_regs": 1}
    xp = cuda_gru.xproj_f32_config(64 * 200, 128, 3 * 128, sms=cuda_gru.NUM_SMS)
    assert (xp["design"], xp["block"], xp["tiles"], xp["grid"], xp["threads"]) == (
        "simt", [64, 128, 32], 600, 528, 128)
    for cfg in (bf16, f32, xp):
        assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT


@pytest.mark.parametrize("M,N", [(1, 4), (63, 300), (64, 384), (65, 512), (12800, 384),
                                 (25600, 384), (25600, 512), (12837, 300)])
@pytest.mark.parametrize("ctas", ["launch", 7])
def test_f32_projection_schedule_covers_every_tile_once(M, N, ctas):
    """The persistent f32 projection (csrc/rnn.cuh xproj_f32_kernel), as its
    index maps lay it out: CTA c of the grid takes tiles c, c + grid, ...
    (tile j: row block j % m_tiles, column block j // m_tiles), each thread
    of a tile its 8 rows (4 tm + r and 32 + 4 tm + r) by 8 columns (4 tn + j
    and 64 + 4 tn + j); every output of [M, N] is written exactly once, over
    the grid launch_config reports and a grid of 7 CTAs alike. A chunk's
    copies cover xT [32][64] and W_x [32][128] once each."""
    tm_rows, tn_cols = cuda_gru.F32_PROJ_TILE
    NT = cuda_gru.F32_PROJ_THREADS
    G = cuda_gru.xproj_f32_grid(M, N) if ctas == "launch" else ctas
    tid = np.arange(NT)
    lane, warp = tid & 31, tid >> 5
    tm, tn = (warp >> 1) * 4 + (lane >> 3), (warp & 1) * 8 + (lane & 7)
    rows = np.concatenate([4 * tm[:, None] + np.arange(4), tm_rows // 2 + 4 * tm[:, None]
                           + np.arange(4)], axis=1)  # [NT, 8]
    cols = np.concatenate([4 * tn[:, None] + np.arange(4), 64 + 4 * tn[:, None]
                           + np.arange(4)], axis=1)  # [NT, 8]
    m_tiles = -(-M // tm_rows)
    tiles = m_tiles * -(-N // tn_cols)
    hits = np.zeros((M, N), np.int64)
    for c in range(G):
        for tile in range(c, tiles, G):
            m0, n0 = tile % m_tiles * tm_rows, tile // m_tiles * tn_cols
            r = (m0 + rows)[:, :, None].repeat(8, axis=2)
            k = (n0 + cols)[:, None, :].repeat(8, axis=1)
            ok = (r < M) & (k < N)
            np.add.at(hits, (r[ok], k[ok]), 1)
    assert (hits == 1).all()
    # One chunk's copies: x transposed (a warp 4 rows by 8 k), W_x in float4s.
    seen_x = np.zeros((32, tm_rows), np.int64)
    for q in range(tm_rows * 32 // NT):
        g = q * (NT // 32) + warp
        np.add.at(seen_x, (g // (tm_rows // 4) * 8 + (lane >> 2),
                           g % (tm_rows // 4) * 4 + (lane & 3)), 1)
    assert (seen_x == 1).all()
    seen_w = np.zeros((32, tn_cols), np.int64)
    for q in range(32 * tn_cols // 4 // NT):
        c = tid + q * NT
        for j in range(4):
            np.add.at(seen_w, (c >> 5, (c & 31) * 4 + j), 1)
    assert (seen_w == 1).all()


@pytest.mark.parametrize("H,hp,in_regs", [(4, 16, 1), (64, 64, 1), (100, 112, 1),
                                          (128, 128, 1), (132, 144, 1), (256, 256, 1)])
def test_gru_bf16_pads_the_hidden_width_to_whole_mma_tiles(H, hp, in_regs):
    """H pads to a multiple of 16 (mma's depth and n8 pairs), W_h's fragments
    in registers at every width: up to Hp = 128 one block of Hp / 16 warps;
    above, a cluster of 4 CTAs of 8 warps (256 threads), each CTA 64 of the
    units and k padded to 256 (h^T's buffers [2][256][8] bf16 and the K
    halves' partial sums [4][2][6][32] f32). Every width the CUDA-core
    design took in bf16 is taken, and wider ones too."""
    cfg = cuda_gru.launch_config(3, 7, 8, H, torch.bfloat16)
    assert (cfg["hidden_padded"], cfg["wh_in_regs"]) == (hp, in_regs)
    if hp <= cuda_gru.WH_REG_LIMIT:
        assert (cfg["threads"], cfg["grid"]) == (2 * hp, 1)
        assert cfg["smem_bytes"] == 2 * hp * 8 * 2 <= cuda_gru.SMEM_LIMIT
    else:
        assert (cfg["threads"], cfg["cluster_size"], cfg["grid"]) == (256, 4, 4)
        assert cfg["smem_bytes"] == 2 * 256 * 8 * 2 + 4 * 2 * 6 * 32 * 4 + 16 <= \
            cuda_gru.SMEM_LIMIT
    xp = cuda_gru.xproj_config(3 * 7, 8, 3 * H)  # the projection's own plan
    assert "xproj_grid" not in cfg and xp["grid"] == xp["tiles"] == -(-3 * H // xp["block"][1])


@pytest.mark.parametrize("B,grid", [(64, 8), (128, 16), (256, 32), (11, 2), (8, 1), (9, 2),
                                    (1, 1)])
def test_gru_bf16_rows_per_block(B, grid):
    """8 batch rows a block (one n8 tile), a ragged last block; the rows and
    the size of a cluster are the f32 design's choice alone, and a bf16
    request for either raises."""
    cfg = cuda_gru.launch_config(B, 50, 64, 64, torch.bfloat16)
    assert (cfg["rows_per_block"], cfg["grid"]) == (cuda_gru.MMA_ROWS, grid) == (8, grid)
    assert cfg["smem_bytes"] == 2 * 64 * 8 * 2
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cuda_gru.launch_config(B, 50, 64, 64, torch.bfloat16, rows_per_cluster=16)
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cuda_gru.launch_config(B, 50, 64, 64, torch.bfloat16, cluster_size=2)


@pytest.mark.parametrize("with_bias", [False, True])
def test_gru_input_projection_on_cpu_matches_the_pallas_step_xp(with_bias):
    """The bf16 forward's input projection (the part of `_gru_step_body`'s
    step that does not depend on h, gru.py:110-113) against the same jnp.dot
    with preferred_element_type=f32; on the CPU the wrapper is the plain
    version and launches nothing."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    w_x = (rng.normal(size=(12, 24)) * 12 ** -0.5).astype(np.float32)
    b_x = (rng.normal(size=24) * 0.1 * with_bias).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_x, jnp.bfloat16)
    want = jnp.dot(xb, wb, preferred_element_type=jnp.float32) + jnp.asarray(b_x)
    before = cuda_gru.gru_input_projection.launches
    got = cuda_gru.gru_input_projection(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(w_x).bfloat16(), torch.from_numpy(b_x))
    assert cuda_gru.gru_input_projection.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, 24)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("shape,dtype,match", [
    ((4, 5, 8, 12), torch.float64, "dtype"),
    ((4, 5, 8, 10), torch.float32, "H % 4"),
    ((4, 5, 6, 12), torch.float32, "D\\*4 % 16"),
    ((4, 5, 8, 1060), torch.float32, "H <= 1056"),
    ((4, 5, 8, 256), torch.float32, "shared"),
    ((4, 5, 8, 2116), torch.bfloat16, "H <= 2112"),
    ((4, 5, 6, 12), torch.bfloat16, "D\\*2 % 8"),
    ((0, 5, 8, 12), torch.float32, "empty"),
])
def test_gru_kernel_rejects_what_it_cannot_take(shape, dtype, match):
    """f32 at H=256 runs on clusters of 8 CTAs (each 32 units' W_h columns,
    96 KB); asked for 2, a CTA's slice (384 KB) and threads (1,024) do not
    fit. Past 256 the grid layout takes H = 260, and past its limit (1,056
    in f32, 2,112 in bf16) the stepped layout."""
    if match.startswith("H <= "):
        cfg = cuda_gru.launch_config(*shape, dtype)
        assert cfg["layout"] == "stepped" and cfg["max_hidden"] == shape[3] - 4
        assert cuda_gru.launch_config(4, 5, 8, 260, dtype)["layout"] == "grid"
        assert cuda_gru.grid_max_hidden(dtype) == shape[3] - 4
        return
    kw = {"cluster_size": 2} if match == "shared" else {}
    with pytest.raises(ValueError, match=match):
        cuda_gru.launch_config(*shape, dtype, **kw)
    if match == "shared":
        assert cuda_gru.launch_config(*shape, dtype)["cluster_size"] == 8


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
