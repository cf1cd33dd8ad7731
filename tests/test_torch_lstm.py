"""The port's LSTM (ops, tower, model, training step) against the JAX
package on identical numpy inputs: `ops/xla.py`'s oracle, the Pallas scan in
interpret mode with its custom VJP, and the flax modules with converted
weights. The LSTM kernels themselves are held against their plain versions
on the card by tests/test_torch_kernels.py.

Tolerances, each with its reason:
- f32 1e-5 (values) and 1e-4 (the final cell state, gradients through the
  reverse recurrence): same formulas, another summation order, and the
  Pallas path's c_last comes from a recompute of the cells;
- bf16 5e-2: both sides round every op to bf16, the cell state included,
  with different fusion of the gate sums; the Pallas path runs narrow bf16
  shapes in f32 (a TPU tiling choice), so it is compared in f32 only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.models.towers import RNNTower as JaxRNNTower
from seqrec_tpu.models.towers import zero_carry as jax_zero_carry
from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import lstm as pl_lstm
from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.models.towers import RNNTower, zero_carry
from seqrec_tpu_torch.ops import dispatch, reference
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _inputs(B=4, T=7, D=8, H=16, seed=0):
    """x, h0, c0, w_x, w_h, b at the initializers' scale, a reset plane and
    an output cotangent."""
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = (a(B, T, D), a(B, H, scale=0.5), a(B, H, scale=0.5), a(D, 4 * H, scale=D ** -0.5),
            a(H, 4 * H, scale=H ** -0.5), a(4 * H, scale=0.1))
    reset = rng.integers(0, 2, size=(B, T)).astype(np.float32)
    return args, reset, a(B, T, H)


def _torch(args, dtype=torch.float32):
    x, h0, c0, *w = (torch.from_numpy(a) for a in args)
    return (x.to(dtype), h0.to(dtype), c0.to(dtype), *w)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_reset", [False, True])
def test_lstm_plain_matches_xla(dtype, with_reset):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    args, reset, _ = _inputs()
    jx, jh0, jc0, *jw = (jnp.asarray(a) for a in args)
    ys_j, (h_j, c_j) = xla_ops.lstm_scan(
        jx.astype(jdt), jh0.astype(jdt), jc0.astype(jdt), *jw,
        reset_mask=jnp.asarray(reset) if with_reset else None)
    ys_t, (h_t, c_t) = reference.lstm_scan(
        *_torch(args, tdt), reset_mask=torch.from_numpy(reset) if with_reset else None)
    assert ys_t.dtype == c_t.dtype == tdt and tuple(ys_t.shape) == (4, 7, 16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got, want in ((ys_t, ys_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("with_reset", [False, True])
def test_lstm_plain_matches_pallas_interpret(with_reset):
    args, reset, _ = _inputs(B=8, T=8, D=16, H=16, seed=1)
    ys_p, (h_p, c_p) = pl_lstm.lstm_scan(
        *(jnp.asarray(a) for a in args),
        reset_mask=jnp.asarray(reset) if with_reset else None, interpret=True)
    ys_t, (h_t, c_t) = reference.lstm_scan(
        *_torch(args), reset_mask=torch.from_numpy(reset) if with_reset else None)
    np.testing.assert_allclose(_np(ys_t), _np(ys_p), **F32_TOL)
    np.testing.assert_allclose(_np(h_t), _np(h_p), **F32_TOL)
    np.testing.assert_allclose(_np(c_t), _np(c_p), **GRAD_TOL)


def test_lstm_plain_matches_torch_nn_lstm():
    """Second oracle: nn.LSTM has the same i|f|g|o blocks, with the weights
    transposed and a second bias (here zero)."""
    args, _, _ = _inputs(seed=2)
    x, h0, c0, w_x, w_h, b = _torch(args)
    cell = torch.nn.LSTM(8, 16, batch_first=True)
    with torch.no_grad():
        cell.weight_ih_l0.copy_(w_x.T)
        cell.weight_hh_l0.copy_(w_h.T)
        cell.bias_ih_l0.copy_(b)
        cell.bias_hh_l0.zero_()
        want, (h_last, c_last) = cell(x, (h0[None], c0[None]))
    ys, (h, c) = reference.lstm_scan(x, h0, c0, w_x, w_h, b)
    np.testing.assert_allclose(_np(ys), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(c), _np(c_last[0]), **F32_TOL)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_lstm_grads_match_jax(oracle, with_bias):
    """The port's LSTM autograd on the CPU (plain forward, `lstm_bwd_math`
    as backward) against jax.grad through the Pallas scan's custom VJP and
    through the XLA scan's autodiff, the final h and c both in the loss."""
    args, _, g = _inputs(B=3, T=6, D=8, H=12, seed=3)
    scan = {"pallas_interpret": lambda *a: pl_lstm.lstm_scan(*a, interpret=True),
            "xla": xla_ops.lstm_scan}[oracle]
    n = 6 if with_bias else 5

    def jloss(*a):
        ys, (h_last, c_last) = scan(*a)
        return jnp.sum(ys * g) + jnp.sum(h_last) + jnp.sum(c_last ** 2)

    j_loss, j_grads = jax.value_and_grad(jloss, argnums=tuple(range(n)))(
        *(jnp.asarray(a) for a in args[:n]))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args[:n]]
    before = cuda_lstm.lstm_scan.launches, cuda_lstm.lstm_backward.launches
    ys, (h_last, c_last) = cuda_lstm.lstm_scan(*leaves)
    loss = (ys * torch.from_numpy(g)).sum() + h_last.sum() + (c_last ** 2).sum()
    loss.backward()
    assert (cuda_lstm.lstm_scan.launches, cuda_lstm.lstm_backward.launches) == before
    np.testing.assert_allclose(_np(loss), _np(j_loss), **GRAD_TOL)
    for name, t, j in zip(("x", "h0", "c0", "w_x", "w_h", "b"), leaves, j_grads):
        np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=name, **GRAD_TOL)


def test_c_last_gradients_match_oracle():
    """The counterpart of the JAX package's test of the same name: c_last's
    cotangent alone reaches every weight, as in the XLA oracle."""
    args, _, _ = _inputs(B=4, T=6, D=8, H=16, seed=4)
    x, h0, c0 = (jnp.asarray(a) for a in args[:3])

    def g(w_x, w_h, b):
        _, (_, c_last) = xla_ops.lstm_scan(x, h0, c0, w_x, w_h, b)
        return jnp.sum(c_last ** 2)

    want = jax.grad(g, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in args[3:]))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args[3:]]
    _, (_, c_last) = cuda_lstm.lstm_scan(*_torch(args)[:3], *leaves)
    (c_last ** 2).sum().backward()
    for name, t, j in zip(("w_x", "w_h", "b"), leaves, want):
        assert float(jnp.max(jnp.abs(j))) > 0.0
        np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=name, **GRAD_TOL)


def test_lstm_backward_math_matches_jax():
    """`reference.lstm_recompute_cells` and `lstm_bwd_math`, the plain
    backward, against `_recompute_cells` and `_lstm_bwd_math`, with and
    without a reset plane."""
    args, reset, g = _inputs(B=3, T=6, D=8, H=12, seed=5)
    x, h0, c0, w_x, w_h, b = args
    ys, _ = xla_ops.lstm_scan(*(jnp.asarray(a) for a in args), reset_mask=jnp.asarray(reset))
    x_proj = np.asarray(jnp.einsum("btd,dh->bth", jnp.asarray(x), jnp.asarray(w_x))) + b
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(x_proj=x_proj, ys=ys, h0=h0, c0=c0, w_h=w_h, g=g).items()}
    for rs in (None, reset):
        j_rs = None if rs is None else jnp.asarray(rs)
        t_rs = None if rs is None else torch.from_numpy(rs)
        cs_j = pl_lstm._recompute_cells(jnp.asarray(x_proj), ys, jnp.asarray(h0),
                                        jnp.asarray(c0), jnp.asarray(w_h), j_rs)
        cs_t = reference.lstm_recompute_cells(t["x_proj"], t["ys"], t["h0"], t["c0"],
                                              t["w_h"], t_rs)
        np.testing.assert_allclose(_np(cs_t), _np(cs_j), **F32_TOL)
        want = pl_lstm._lstm_bwd_math(jnp.asarray(x_proj), ys, cs_j, jnp.asarray(h0),
                                      jnp.asarray(c0), jnp.asarray(w_h), jnp.asarray(g), j_rs)
        got = reference.lstm_bwd_math(t["x_proj"], t["ys"], cs_t, t["h0"], t["c0"],
                                      t["w_h"], t["g"], t_rs)
        for name, a, w in zip(("d_xp", "dh0", "dc0", "dW", "db"), got, want):
            np.testing.assert_allclose(_np(a), _np(w), err_msg=name, **F32_TOL)


def test_lstm_wrappers_on_cpu_are_the_plain_versions():
    args, reset, _ = _inputs(seed=6)
    before = cuda_lstm.lstm_scan.launches, cuda_lstm.lstm_backward.launches
    for use_pallas in (True, False):
        ys, (h, c) = dispatch.lstm_scan(*_torch(args), reset_mask=torch.from_numpy(reset),
                                        use_pallas=use_pallas)
        want, (_, c_want) = reference.lstm_scan(*_torch(args),
                                                reset_mask=torch.from_numpy(reset))
        np.testing.assert_array_equal(_np(ys), _np(want))
        np.testing.assert_array_equal(_np(h), _np(ys[:, -1]))
        np.testing.assert_array_equal(_np(c), _np(c_want))
    rng = np.random.default_rng(7)
    planes = [torch.from_numpy(rng.random((2, 3, 8)).astype(np.float32)) for _ in range(7)]
    w_h = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    dc_last = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    got = cuda_lstm.lstm_backward(*planes, w_h, None, dc_last)
    for a, b in zip(got, cuda_lstm.plain_backward(*planes, w_h, None, dc_last)):
        assert torch.equal(a, b)
    assert (cuda_lstm.lstm_scan.launches, cuda_lstm.lstm_backward.launches) == before


def test_lstm_launch_configs_at_the_training_shape():
    """bf16: the tensor-core design, 8 rows a block (16 blocks at B=128), 8
    warps of 16 units at H=128 with W_h's fragments in registers, the h
    double buffer [2][128][8] bf16 and three xp stages [8][516] f32 in shared
    memory, and the projection's 64 x 64 tiles over B*T = 25,600 rows and
    4H = 512 columns; the reverse recurrence the same blocks with its dz^T
    buffer [hi, lo][512][8] bf16, three stages of six [8][132] f32 gate
    planes and [8][136] bf16 g_ys, and the sums its warp pairs exchange
    ([8][32][4] f32). f32: both directions on thread block clusters. The
    forward: the persistent f32 projection (1,600 tiles of 64 x 128 on 528
    CTAs), then clusters of 4 CTAs
    over 4 rows (32 clusters, 128 CTAs: one wave on the card's 132 SMs),
    each CTA 32 units with their W_h
    columns of all four gates (64 KB) in its shared memory and, at 16 k
    values a thread with 8 slices a unit, in its registers, beside the h
    double buffer and a ring of xp's four gates and keep; at D=H=64 the same
    4 CTAs hold 16 units each with 16 slices of 4. The reverse recurrence:
    clusters of 4 CTAs over 8 rows (16 clusters), each CTA 32 units with
    their W_h rows (64 KB) in its shared memory, a warp of 32 k-slices of 16
    columns for 4 units."""
    assert cuda_lstm.launch_config(128, 200, 128, 128, torch.bfloat16) == {
        "design": "mma.sync", "grid": 16, "threads": 256, "rows_per_block": 8,
        "hidden_padded": 128, "wh_in_regs": 1,
        "smem_bytes": 2 * 128 * 8 * 2 + 3 * 8 * 516 * 4}
    f32 = cuda_lstm.launch_config(128, 200, 128, 128, torch.float32)
    assert f32 == {"design": "cluster", "cluster_size": 4, "rows_per_cluster": 4,
                   "clusters": 32, "grid": 128, "threads": 256, "units_per_cta": 32,
                   "k_slices": 8, "k_slice": 16,
                   "smem_bytes": (4 * 16 * 256 + 2 * 4 * 132 + 4 * 256 * 5) * 4 + 16,
                   "w_in_regs": 1}
    small = cuda_lstm.launch_config(64, 200, 64, 64, torch.float32)
    assert (small["cluster_size"], small["rows_per_cluster"], small["units_per_cta"],
            small["k_slices"], small["k_slice"], small["w_in_regs"]) == (4, 4, 16, 16, 4, 0)
    assert cuda_lstm.backward_launch_config(128, 200, 128, torch.bfloat16) == {
        "design": "mma.sync", "grid": 16, "threads": 256, "rows_per_block": 8,
        "hidden_padded": 128, "w_in_regs": 1, "dz_terms": 2,
        "smem_bytes": 2 * 512 * 8 * 2 + 3 * (6 * 8 * 132 * 4 + 8 * 136 * 2) + 8 * 32 * 16}
    bwd32 = cuda_lstm.backward_launch_config(128, 200, 128, torch.float32)
    assert bwd32 == {"design": "cluster", "cluster_size": 4, "rows_per_cluster": 8,
                     "clusters": 16, "grid": 64, "threads": 256, "units_per_cta": 32,
                     "k_slices": 32, "k_slice": 16,
                     "smem_bytes": (4 * 16 * 256 + 2 * 8 * 516 + 4 * 256 * 8) * 4 + 16}
    for cfg in (f32, small, bwd32):
        assert cfg["smem_bytes"] <= cuda_lstm.SMEM_LIMIT


@pytest.mark.parametrize("H,hp,hb,in_regs", [(4, 16, 32, 1), (64, 64, 64, 1),
                                             (100, 112, 128, 1), (128, 128, 128, 1),
                                             (132, 144, 160, 0), (256, 256, 256, 0)])
def test_lstm_bf16_pads_the_hidden_width_to_whole_mma_tiles(H, hp, hb, in_regs):
    """H pads to a multiple of 16 in the forward and of 32 in the reverse
    recurrence (whose warps pair up): Hp / 16 warps, W_h's fragments in
    registers up to Hp = 128; every width the CUDA-core design took in bf16
    is taken, and the rings fit a block's shared memory up to H = 256."""
    fwd = cuda_lstm.launch_config(3, 7, 8, H, torch.bfloat16)
    bwd = cuda_lstm.backward_launch_config(3, 7, H, torch.bfloat16)
    assert (fwd["hidden_padded"], fwd["threads"], fwd["wh_in_regs"]) == (hp, 2 * hp, in_regs)
    assert (bwd["hidden_padded"], bwd["threads"], bwd["w_in_regs"]) == (hb, 2 * hb, in_regs)
    assert fwd["smem_bytes"] == 2 * hp * 8 * 2 + 3 * 8 * (4 * hp + 4) * 4 <= cuda_lstm.SMEM_LIMIT
    bwd_ring = 3 * (6 * 8 * (hb + 4) * 4 + 8 * (hb + 8) * 2)
    bwd_smem = 2 * 4 * hb * 8 * 2 + bwd_ring + hb // 16 * 32 * 16
    assert bwd["smem_bytes"] == bwd_smem <= cuda_lstm.SMEM_LIMIT
    xp = cuda_gru.xproj_config(3 * 7, 8, 4 * H)  # the projection's own plan
    assert "xproj_grid" not in fwd and xp["grid"] == xp["tiles"] == -(-4 * H // xp["block"][1])


@pytest.mark.parametrize("B,grid", [(128, 16), (64, 8), (11, 2), (1, 1)])
def test_lstm_bf16_rows_per_block(B, grid):
    """8 batch rows a block (one n8 tile) in both recurrences, a ragged last
    block; the rows and size of a cluster are the f32 designs' choice alone
    (both directions), and a bf16 request for one raises."""
    for cfg in (cuda_lstm.launch_config(B, 50, 64, 64, torch.bfloat16),
                cuda_lstm.backward_launch_config(B, 50, 64, torch.bfloat16)):
        assert (cfg["rows_per_block"], cfg["grid"]) == (cuda_lstm.MMA_ROWS, grid) == (8, grid)
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cuda_lstm.launch_config(B, 50, 64, 64, torch.bfloat16, rows_per_cluster=4)
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cuda_lstm.launch_config(B, 50, 64, 64, torch.bfloat16, cluster_size=4)
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cuda_lstm.backward_launch_config(B, 50, 64, torch.bfloat16, rows_per_cluster=8)


def _unpack_fragments(frags: torch.Tensor, M: int, K: int) -> np.ndarray:
    """[M/16, K/16, 32, 8] -> [M, K], lane by lane and register by register
    from the PTX ISA's map of mma.m16n8k16's A fragment (g = lane / 4,
    q = lane % 4; a0 = (g, 2q..2q+1), a1 = (g+8, ..), a2 = (g, 2q+8..),
    a3 = (g+8, 2q+8..))."""
    f = _np(frags)
    a = np.full((M, K), np.nan, np.float32)
    for mt in range(M // 16):
        for st in range(K // 16):
            for lane in range(32):
                g, q = divmod(lane, 4)
                for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                    for pair in range(2):
                        a[16 * mt + g + dm, 16 * st + 2 * q + dk + pair] = \
                            f[mt, st, lane, 2 * r + pair]
    return a


@pytest.mark.parametrize("dtype,P", [(torch.bfloat16, 8)])
def test_lstm_weights_are_k_packed_for_16_byte_reads(dtype, P):
    """The bf16 tensor-core kernels read W_h as packed mma.sync A fragments,
    a lane's P values (its four registers) in 16 bytes: the forward W_h^T
    gate by gate, the reverse recurrence W_h with each gate's columns padded
    to Hp, a warp's two tiles over its half of the k-steps; zero past H
    (H = 20 pads to 32). (The f32 kernels copy W_h into their CTAs' shared
    memory as they are: tests/test_torch_f32_clusters.py.)"""
    H, hp = 20, 32
    w_h = torch.arange(H * 4 * H, dtype=torch.float32).reshape(H, 4 * H).to(dtype)
    fwd = cuda_lstm.forward_fragments(w_h)
    assert fwd.dtype == dtype and fwd.is_contiguous()
    assert tuple(fwd.shape) == (hp // 16, hp // 16, 4, 32, P) and fwd[0, 0, 0, 0].numel() * 2 == 16
    wn = _np(w_h)
    for q in range(4):
        want = np.zeros((hp, hp), np.float32)
        want[:H, :H] = wn[:, q * H:(q + 1) * H].T  # A_q[unit][k] = W_h[k, q H + unit]
        np.testing.assert_array_equal(_unpack_fragments(fwd[:, :, q], hp, hp), want)
    bwd = cuda_lstm.backward_fragments(w_h)
    mt = hp // 16
    assert tuple(bwd.shape) == (mt, 2 * mt, 2, 32, P) and bwd.is_contiguous()
    want = np.zeros((hp, 4 * hp), np.float32)
    for q in range(4):
        want[:H, q * hp:q * hp + H] = wn[:, q * H:(q + 1) * H]
    # Back to [tile][k-step]: warp 2 j + h, k-step s of its half, tile i of
    # its pair hold tile 2 j + i at k-step h * 2 mt + s.
    by_tile = torch.zeros(mt, 4 * mt, 32, P, dtype=dtype)
    for w in range(mt):
        for sl in range(2 * mt):
            for i in range(2):
                by_tile[2 * (w // 2) + i, (w % 2) * 2 * mt + sl] = bwd[w, sl, i]
    np.testing.assert_array_equal(_unpack_fragments(by_tile, hp, 4 * hp), want)


@pytest.mark.parametrize("shape,dtype,match", [
    ((4, 5, 8, 12), torch.float64, "dtype"),
    ((4, 5, 8, 10), torch.float32, "H % 4"),
    ((4, 5, 6, 12), torch.float32, r"D\*4 % 16"),
    ((4, 5, 6, 12), torch.bfloat16, r"D\*2 % 8"),
    ((4, 5, 8, 1060), torch.float32, "H <= 1056"),
    ((0, 5, 8, 12), torch.float32, "empty"),
    ((4, 5, 8, 12), torch.float32, "rows_per_cluster 3"),
    ((4, 5, 8, 12), torch.bfloat16, "rows_per_cluster and cluster_size are the f32 design's"),
])
def test_lstm_kernel_rejects_what_it_cannot_take(shape, dtype, match):
    if "H <=" in match:  # past the grid layout's limit the stepped layout takes it
        cfg = cuda_lstm.launch_config(*shape, dtype)
        assert cfg["layout"] == "stepped" and cfg["max_hidden"] == shape[3] - 4
        assert cuda_lstm.launch_config(4, 5, 8, 260, dtype)["layout"] == "grid"
        return
    with pytest.raises(ValueError, match=match):
        cuda_lstm.launch_config(*shape, dtype,
                                rows_per_cluster=3 if "rows_per_cluster" in match else None)
    if "H <=" in match:  # the limit is the grid layout's, which takes H = 260
        assert cuda_lstm.launch_config(4, 5, 8, 260, dtype)["layout"] == "grid"


@pytest.mark.parametrize("with_bias", [False, True])
def test_lstm_input_projection_on_cpu_matches_the_pallas_step_xp(with_bias):
    """The bf16 forward's input projection (the part of `_lstm_step_body`'s
    step that does not depend on h, lstm.py:89-93, b included) against the
    same jnp.dot with preferred_element_type=f32; on the CPU the wrapper is
    the plain version and launches nothing."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    w_x = (rng.normal(size=(12, 32)) * 12 ** -0.5).astype(np.float32)
    b = (rng.normal(size=32) * 0.1 * with_bias).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_x, jnp.bfloat16)
    want = jnp.dot(xb, wb, preferred_element_type=jnp.float32) + jnp.asarray(b)
    before = cuda_lstm.lstm_input_projection.launches
    got = cuda_lstm.lstm_input_projection(torch.from_numpy(x).bfloat16(),
                                          torch.from_numpy(w_x).bfloat16(), torch.from_numpy(b))
    assert cuda_lstm.lstm_input_projection.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, 32)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("D,H", [(12, 8), (128, 128)])
def test_lstm_f32_input_projection_on_cpu_matches_the_pallas_step_xp(D, H):
    """The f32 forward's input projection (the f32 design now computes it
    for every step before the cluster recurrence, as the bf16 one does)
    against the f32 jnp.dot of `_lstm_step_body`, b included; on the CPU
    the wrapper is the plain version and launches neither kernel."""
    rng = np.random.default_rng(D + H)
    x = rng.normal(size=(2, 7, D)).astype(np.float32)
    w_x = (rng.normal(size=(D, 4 * H)) * D ** -0.5).astype(np.float32)
    b = (rng.normal(size=4 * H) * 0.1).astype(np.float32)
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w_x),
                   precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)
    before = (cuda_lstm.lstm_input_projection.launches,
              cuda_lstm.lstm_input_projection.f32_launches)
    got = cuda_lstm.lstm_input_projection(*(torch.from_numpy(a) for a in (x, w_x, b)))
    assert (cuda_lstm.lstm_input_projection.launches,
            cuda_lstm.lstm_input_projection.f32_launches) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 7, 4 * H)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


class _SplitBf16Product:
    """W_h as the bf16 reverse recurrence multiplies by it, for
    `reference.lstm_bwd_scan`'s `dz @ w_h.float().T`: dz (f32) split into
    `terms` bf16 parts, each the rounding of what the earlier ones left,
    every part's product with the bf16-valued W_h^T summed in f32."""

    def __init__(self, w_h: torch.Tensor, terms: int):
        self.w_t, self.terms = w_h.float().T, terms

    def float(self):
        return self

    @property
    def T(self):
        return self

    def __rmatmul__(self, dz):
        out, rest = torch.zeros(dz.shape[0], self.w_t.shape[1]), dz
        for _ in range(self.terms):
            part = rest.bfloat16().float()
            out, rest = out + part @ self.w_t, rest - part
        return out


def test_lstm_split_bf16_product_keeps_the_f32_contract():
    """The reverse recurrence's contract is an f32 dz times bf16-valued
    weights, summed in f32 (the reference's dz is f32). Through
    `reference.lstm_bwd_scan`'s own loop at B=8, T=200, H=128 on seeded
    planes and an orthogonal W_h: with dz split as the kernel splits it,
    hi = bf16(dz) and lo = bf16(dz - hi), dz, dh0 and dc0 stay within 1e-4
    of the f32 product relative to their largest values (the card check's
    tolerance), with room to spare; one bf16 term alone, rounding dz to 8
    bits every step, does not."""
    B, T, H = 8, 200, 128
    rng = np.random.default_rng(12)

    def t(*shape, gate=False):
        a = rng.uniform(0.05, 0.95, size=shape) if gate else rng.normal(size=shape) * 0.5
        return torch.from_numpy(a.astype(np.float32))

    i, f, o = t(B, T, H, gate=True), t(B, T, H, gate=True), t(B, T, H, gate=True)
    g, tanh_c, c_in = torch.tanh(t(B, T, H)), torch.tanh(t(B, T, H)), t(B, T, H)
    g_ys, dc_last = t(B, T, H).bfloat16(), t(B, H)
    q, r = np.linalg.qr(rng.normal(size=(4 * H, H)))
    w_h = torch.from_numpy((q * np.sign(np.diag(r))).T.astype(np.float32)).bfloat16()
    planes = (i, f, g, o, tanh_c, c_in, g_ys)
    want = reference.lstm_bwd_scan(*planes, w_h, None, dc_last)

    def rel(terms):
        got = reference.lstm_bwd_scan(*planes, _SplitBf16Product(w_h, terms), None, dc_last)
        return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))

    assert rel(2) < 1e-4 / 10
    assert rel(1) > 1e-4


# ---------------------------------------------------------------------------
# The tower, the model and a training step
# ---------------------------------------------------------------------------

VOCAB, T = 30, 8


def test_lstm_tower_matches_flax_with_carry_and_reset():
    """RNNTower(cell="lstm"), two residual layers, against the flax module
    with its own initialized parameters: plain encode, and the
    session-parallel form with a carry and a reset plane."""
    B, D, L = 3, 8, 2
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    reset = rng.integers(0, 2, size=(B, T)).astype(np.float32)
    jt = JaxRNNTower(hidden=D, num_layers=L, cell="lstm", residual=True, use_pallas=False)
    carry0 = jax_zero_carry("lstm", L, B, D)
    params = jt.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(mask),
                     carry=carry0, reset=jnp.asarray(reset))
    params = jax.tree_util.tree_map(np.asarray, params)
    assert sorted(params["params"]) == ["lstm0_b", "lstm0_wh", "lstm0_wx",
                                        "lstm1_b", "lstm1_wh", "lstm1_wx"]
    tt = RNNTower(D, D, L, cell="lstm", residual=True)
    tt.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(tt(torch.from_numpy(x), torch.from_numpy(mask))),
            np.asarray(jt.apply(params, jnp.asarray(x), jnp.asarray(mask))), **F32_TOL)
    carry = tuple(tuple(np.asarray(s) + 0.1 * (i + 1) for s in c)
                  for i, c in enumerate(carry0))
    want_h, want_c = jt.apply(params, jnp.asarray(x), jnp.asarray(mask),
                              carry=jax.tree_util.tree_map(jnp.asarray, carry),
                              reset=jnp.asarray(reset))
    with torch.no_grad():
        assert all(torch.equal(s, torch.zeros(B, D))
                   for c in zero_carry("lstm", L, B, D) for s in c)
        got_h, got_c = tt(torch.from_numpy(x), torch.from_numpy(mask),
                          carry=tuple(tuple(torch.from_numpy(s) for s in c) for c in carry),
                          reset=torch.from_numpy(reset))
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), **F32_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(tuple(got_c)),
                    jax.tree_util.tree_leaves(want_c)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32_TOL)


def _lstm_cfg(**kw):
    return dict(arch="gru4rec", cell_type="lstm", embed_dim=16, num_layers=2,
                residual=True, dropout_rate=0.0, compute_dtype="float32",
                loss="sampled_softmax", num_negatives=9, **kw)


def _batch(rng, B=4):
    inputs = np.zeros((B, T), np.int32)
    targets = np.zeros((B, T), np.int32)
    for r, n in enumerate([T, 5, 1, 3][:B]):
        seq = rng.integers(1, VOCAB, size=n + 1)
        inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
    return {"inputs": inputs, "targets": targets, "mask": (targets != 0).astype(np.float32)}


def test_lstm_model_encode_scores_loss_and_grads_match_jax():
    jm = jax_build_model(JaxModelConfig(**_lstm_cfg()), VOCAB)
    tm = build_model(ModelConfig(**_lstm_cfg()), VOCAB, device="cpu")
    params = random_params(tm, seed=3)
    tm.load_state_dict(flax_to_state_dict(params))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    batch = _batch(np.random.default_rng(9))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(tm.encode(tb["inputs"], tb["mask"])),
            np.asarray(jm.apply(j_params, jb["inputs"], jb["mask"])), **F32_TOL)
        np.testing.assert_allclose(
            _np(tm.scores(tb["inputs"], tb["mask"])),
            np.asarray(jm.apply(j_params, jb["inputs"], jb["mask"], method=jm.scores)),
            **F32_TOL)
    rng = np.random.default_rng(10)
    neg_ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    nlq = (rng.normal(size=9) - 3).astype(np.float32)

    def jloss(p):
        return jm.apply(p, jb, neg_ids=jnp.asarray(neg_ids), neg_log_q=jnp.asarray(nlq),
                        deterministic=True, method=jm.loss)

    j_sum, j_w = jloss(j_params)
    j_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.grad(lambda p: jloss(p)[0])(j_params)))
    t_sum, t_w = tm.loss(tb, neg_ids=torch.from_numpy(neg_ids),
                         neg_log_q=torch.from_numpy(nlq), deterministic=True)
    t_sum.backward()
    np.testing.assert_allclose(_np(t_sum), _np(j_sum), **F32_TOL)
    assert float(t_w) == float(j_w)
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(j_grads)
    for name, p in got.items():
        np.testing.assert_allclose(_np(p.grad), j_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_lstm_random_params_forget_bias_and_initializers():
    tm = build_model(ModelConfig(**_lstm_cfg()), VOCAB, device="cpu")
    tower = random_params(tm, seed=5)["params"]["tower"]
    assert sorted(tower) == ["lstm0_b", "lstm0_wh", "lstm0_wx",
                             "lstm1_b", "lstm1_wh", "lstm1_wx"]
    H = 16
    for layer in (0, 1):
        b = tower[f"lstm{layer}_b"]
        np.testing.assert_array_equal(b[H:2 * H], np.ones(H))
        assert not b[:H].any() and not b[2 * H:].any()
        w_h = tower[f"lstm{layer}_wh"]  # [H, 4H], orthonormal rows
        np.testing.assert_allclose(w_h @ w_h.T, np.eye(H), atol=1e-5)
        assert np.abs(tower[f"lstm{layer}_wx"]).max() <= np.sqrt(6.0 / (H + 4 * H))
    tm.load_state_dict(flax_to_state_dict({"params": {**random_params(tm, 5)["params"]}}))
