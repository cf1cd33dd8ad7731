"""The port's training step against the JAX package, on identical numpy
inputs: GRU and gather gradients, the negative samplers' log-probabilities,
the optimizer, the wire format, the model loss and a trainer trajectory.

Tolerances, each with its reason:
- f32 1e-5: same formulas, another summation order;
- GRU bf16 3e-2 (values) / 5e-2 (weight grads, sums over B*T bf16 terms) /
  0.5 absolute on a loss summed over 216 outputs: the port's forward rounds
  every gate op to bf16 on the CPU, while the JAX Pallas scan runs narrow
  bf16 towers in f32;
- log-probabilities 1 ulp: XLA:CPU's `log` is not correctly rounded (it even
  differs between its own jitted and eager runs), torch's nearly is;
- optimizer and trainer trajectories 1e-5 relative on metrics and 2e-5 on
  parameters: Adam divides by sqrt(nu), so last-bit differences in the
  gradients and in the f32 bias corrections show up at ~1e-6 of lr."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.config import TrainConfig as JaxTrainConfig
from seqrec_tpu.data import negative as jax_negative
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import gru as pl_gru
from seqrec_tpu.train import state as jax_state
from seqrec_tpu.train.trainer import Trainer as JaxTrainer
from seqrec_tpu_torch.config import ModelConfig, RunConfig, TrainConfig
from seqrec_tpu_torch.data import negative
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import gather as cuda_gather
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.train import state as train_state
from seqrec_tpu_torch.train.trainer import Trainer
from test_torch_lstm import _SplitBf16Product, _unpack_fragments

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# GRU and gather gradients
# ---------------------------------------------------------------------------

B, T, D, HID = 3, 6, 8, 12


def _gru_inputs(seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = (a(B, T, D), a(B, HID, scale=0.5), a(D, 3 * HID, scale=D ** -0.5),
            a(HID, 3 * HID, scale=HID ** -0.5), a(3 * HID, scale=0.1),
            a(3 * HID, scale=0.1))
    return args, a(B, T, HID)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_grads_match_jax(oracle, dtype):
    """The port's GRU autograd on the CPU (plain forward, `gru_bwd_math` as
    backward) against jax.grad through the Pallas scan's custom VJP and
    through the XLA scan's autodiff."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    args, g = _gru_inputs(1)
    scan = {"pallas_interpret": lambda *a: pl_gru.gru_scan(*a, interpret=True),
            "xla": xla_ops.gru_scan}[oracle]

    def jloss(x, h0, *w):
        ys, h_last = scan(x.astype(jdt), h0.astype(jdt), *w)
        return jnp.sum(ys.astype(jnp.float32) * g) + jnp.sum(h_last.astype(jnp.float32))

    j_args = [jnp.asarray(a) for a in args]
    j_loss, j_grads = jax.value_and_grad(jloss, argnums=tuple(range(6)))(*j_args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ys, h_last = cuda_gru.gru_scan(leaves[0].to(tdt), leaves[1].to(tdt), *leaves[2:])
    loss = (ys.float() * torch.from_numpy(g)).sum() + h_last.float().sum()
    loss.backward()
    tol = F32_TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(loss), _np(j_loss), **(
        F32_TOL if dtype == "float32" else dict(rtol=3e-2, atol=0.5)))
    for name, t, j in zip(("x", "h0", "w_x", "w_h", "b_x", "b_h"), leaves, j_grads):
        if dtype == "bfloat16" and name in ("w_x", "w_h", "b_x", "b_h"):
            tol = dict(rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(_np(t.grad), _np(j), err_msg=name, **tol)


def test_gru_backward_math_matches_jax():
    """`reference.gru_bwd_math`, the plain backward, against
    `_gru_bwd_math` with and without a reset plane."""
    args, g = _gru_inputs(2)
    x, h0, w_x, w_h, b_x, b_h = args
    reset = (np.random.default_rng(3).random((B, T)) > 0.7).astype(np.float32)
    ys, _ = xla_ops.gru_scan(*(jnp.asarray(a) for a in args), reset_mask=jnp.asarray(reset))
    x_proj = np.asarray(jnp.einsum("btd,dh->bth", jnp.asarray(x), jnp.asarray(w_x))) + b_x
    for rs in (None, reset):
        want = pl_gru._gru_bwd_math(jnp.asarray(x_proj), ys, jnp.asarray(h0), jnp.asarray(w_h),
                                    jnp.asarray(b_h), jnp.asarray(g),
                                    None if rs is None else jnp.asarray(rs))
        got = cuda_gru.reference.gru_bwd_math(
            torch.from_numpy(x_proj), torch.from_numpy(np.array(ys)), torch.from_numpy(h0),
            torch.from_numpy(w_h), torch.from_numpy(b_h), torch.from_numpy(g),
            None if rs is None else torch.from_numpy(rs))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **F32_TOL)


def test_gru_backward_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    proj = [torch.from_numpy(rng.normal(size=(2, 3, 24)).astype(np.float32)) for _ in range(2)]
    planes = [torch.from_numpy(rng.random((2, 3, 8)).astype(np.float32)) for _ in range(2)]
    w_h = torch.from_numpy(rng.normal(size=(8, 24)).astype(np.float32))
    before = cuda_gru.gru_backward.launches
    got = cuda_gru.gru_backward(*proj, *planes, w_h)
    want = cuda_gru.plain_backward(*proj, *planes, w_h)
    assert cuda_gru.gru_backward.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_reset", [False, True])
def test_gru_fused_plain_is_the_gates_then_the_scan(with_reset):
    """`reference.gru_bwd_fused`, the plain version of the reverse kernel
    with the gate recompute folded in, equals the gate recompute
    (`gru_bwd_gates`, the hoisted elementwise passes) followed by
    `gru_bwd_scan` bit for bit, and its third output is d_xp's n-block times
    r (the n-block of d_hproj)."""
    args, g = _gru_inputs(6)
    x, h0, w_x, w_h, b_x, b_h = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(g)
    reset = None
    if with_reset:
        reset = torch.from_numpy((np.random.default_rng(7).random((B, T)) > 0.7)
                                 .astype(np.float32))
    ys, _ = reference.gru_scan(x, h0, w_x, w_h, b_x, b_h, reset_mask=reset)
    x_proj = torch.matmul(x, w_x) + b_x
    h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, h0, w_h, b_h, reset)
    r, z, n, hn = reference.gru_bwd_gates(x_proj, h_proj)
    want_xp, want_h0 = reference.gru_bwd_scan(r, z, n, hn, h_in, g, w_h, keep)
    d_xp, dh0, dn_r = reference.gru_bwd_fused(x_proj, h_proj, h_in, g, w_h, keep)
    assert torch.equal(d_xp, want_xp) and torch.equal(dh0, want_h0)
    assert torch.equal(dn_r, want_xp[..., 2 * HID:] * r)


def test_gru_backward_launch_config_at_the_training_shape():
    """bf16 weights: the tensor-core design, 8 rows a block (16 blocks at
    B=128), 8 warps, each its own tile of units over K = 3 Hp with W_h's
    fragments in registers, the d_hproj^T double buffer [2][hi, lo][384][8]
    bf16 and three stages of the two projections' six [8][132] f32 gate
    blocks, h_in [8][136] bf16 and g_ys [8][136] bf16; the keep path reads
    h_in in f32 ([8][132]). f32 weights: thread block clusters, 2 CTAs of
    64 units over 4 rows (32 clusters), each CTA W_h's rows of its units
    (all 384 columns, 12 a lane of a warp's 32 for 8 units: 96 KB), the
    d_hproj double buffer [2][4][388] and a ring of 4 stages of each pair's
    12 operand floats; at H=256 a CTA of 32 units (8 CTAs) is what fits."""
    bf16 = cuda_gru.backward_launch_config(128, 200, 128, torch.bfloat16)
    stage = 6 * 8 * 132 * 4 + 8 * 136 * 2 + 8 * 136 * 2
    assert bf16 == {"design": "mma.sync", "grid": 16, "threads": 256, "rows_per_block": 8,
                    "hidden_padded": 128, "w_in_regs": 1, "d_terms": 2,
                    "smem_bytes": 2 * 2 * 384 * 8 * 2 + 3 * stage}
    keep = cuda_gru.backward_launch_config(128, 200, 128, torch.bfloat16,
                                           h_in_dtype=torch.float32)
    assert keep["smem_bytes"] - bf16["smem_bytes"] == 3 * 8 * (132 * 4 - 136 * 2)
    for cfg in (bf16, keep):
        assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cuda_gru.backward_launch_config(128, 200, 128, torch.bfloat16, rows_per_cluster=4)
    f32 = cuda_gru.backward_launch_config(128, 200, 128, torch.float32)
    assert f32 == {"design": "cluster", "cluster_size": 2, "rows_per_cluster": 4,
                   "clusters": 32, "grid": 64, "threads": 256, "units_per_cta": 64,
                   "k_slices": 32, "k_slice": 12,
                   "smem_bytes": (8 * 12 * 256 + 2 * 4 * 388 + 4 * 256 * 12) * 4 + 16}
    wide = cuda_gru.backward_launch_config(8, 5, 256, torch.float32)
    assert (wide["cluster_size"], wide["units_per_cta"], wide["threads"], wide["k_slice"]) == (
        8, 32, 128, 24)
    with pytest.raises(ValueError, match="H % 4"):
        cuda_gru.backward_launch_config(8, 5, 10, torch.float32)


@pytest.mark.parametrize("H,hp,in_regs", [(4, 16, 1), (100, 112, 1), (128, 128, 1),
                                          (132, 144, 1), (256, 256, 1)])
def test_gru_bf16_backward_pads_to_whole_tiles(H, hp, in_regs):
    """The bf16 reverse recurrence pads H as the forward does, to a multiple
    of 16, W_h's fragments in registers at every width: up to Hp = 128 one
    block of Hp / 16 warps with d_hproj^T double-buffered; above, a cluster
    of 4 CTAs of 256 threads over 8 rows, K split between them (units and
    gate columns padded to 256: each CTA 64 units' 192 columns, d_hproj^T
    of them [hi, lo][192][8] bf16, the partial sums [2][4][64][8] f32 and
    its units' ring stages, 64 wide). Its shared memory fits a CTA up to
    H = 256 with h_in in f32."""
    for h_dt, h_row, h_es in ((torch.bfloat16, 8, 2), (torch.float32, 4, 4)):
        cfg = cuda_gru.backward_launch_config(11, 7, H, torch.bfloat16, h_in_dtype=h_dt)
        assert (cfg["hidden_padded"], cfg["w_in_regs"]) == (hp, in_regs)
        if hp <= cuda_gru.WH_REG_LIMIT:
            assert (cfg["threads"], cfg["grid"]) == (2 * hp, 2)
            stage = 6 * 8 * (hp + 4) * 4 + 8 * (hp + h_row) * h_es + 8 * (hp + 8) * 2
            assert cfg["smem_bytes"] == 2 * 2 * 3 * hp * 8 * 2 + 3 * stage <= \
                cuda_gru.SMEM_LIMIT
        else:
            assert (cfg["threads"], cfg["cluster_size"], cfg["grid"]) == (256, 4, 8)
            stage = 6 * 8 * 68 * 4 + 8 * (64 + h_row) * h_es + 8 * 72 * 2
            assert cfg["smem_bytes"] == (2 * 192 * 8 * 2 + 2 * 4 * 64 * 8 * 4 + 3 * stage
                                         + 16) <= cuda_gru.SMEM_LIMIT


@pytest.mark.parametrize("H", [100, 128])
def test_gru_backward_fragments_unpack_to_w_h(H):
    """W_h [H, 3H] packed as the bf16 reverse recurrence's A fragments
    (`backward_fragments`): each gate's columns padded to Hp = 16 ceil(H /
    16), zero past H, [tile][k-step][lane]. Unpacked lane by lane from the
    PTX map, it is W_h."""
    hp = 16 * -(-H // 16)
    mt = hp // 16
    w_h = torch.from_numpy(np.random.default_rng(H).normal(size=(H, 3 * H)).astype(np.float32))
    w_h = w_h.bfloat16()
    frags = cuda_gru.backward_fragments(w_h)
    assert frags.dtype == torch.bfloat16 and frags.is_contiguous()
    assert tuple(frags.shape) == (mt, 3 * mt, 32, 8)
    want = np.zeros((hp, 3 * hp), np.float32)
    for q in range(3):
        want[:H, q * hp:q * hp + H] = _np(w_h)[:, q * H:(q + 1) * H]
    np.testing.assert_array_equal(_unpack_fragments(frags, hp, 3 * hp), want)


@pytest.mark.parametrize("with_keep", [False, True])
def test_gru_split_bf16_product_keeps_the_f32_contract(with_keep):
    """The GRU reverse recurrence's contract is an f32 d_hproj times
    bf16-valued weights, summed in f32 (`_gru_bwd_math`'s d_hproj is in
    x_proj's f32). Through `reference.gru_bwd_scan`'s own loop at B=8, T=200,
    H=128 on seeded planes and an orthogonal W_h, with and without a keep
    plane: with d_hproj split as the kernel splits it, hi = bf16(d) and
    lo = bf16(d - hi), d_xp and dh0 stay within 1e-4 / 10 of the f32
    product relative to their largest values (the card check's tolerance is
    1e-4); one bf16 term alone, rounding the cotangent to 8 bits every step,
    does not."""
    Bs, Ts, H = 8, 200, 128
    rng = np.random.default_rng(13)

    def t(*shape, gate=False):
        a = rng.uniform(0.05, 0.95, size=shape) if gate else rng.normal(size=shape) * 0.5
        return torch.from_numpy(a.astype(np.float32))

    r, z = t(Bs, Ts, H, gate=True), t(Bs, Ts, H, gate=True)
    n, hn = torch.tanh(t(Bs, Ts, H)), t(Bs, Ts, H)
    h_in, g_ys = torch.tanh(t(Bs, Ts, H)).bfloat16(), t(Bs, Ts, H).bfloat16()
    q, rr = np.linalg.qr(rng.normal(size=(3 * H, H)))
    w_h = torch.from_numpy((q * np.sign(np.diag(rr))).T.astype(np.float32)).bfloat16()
    keep = None
    if with_keep:
        keep = torch.from_numpy((rng.random((Bs, Ts, 1)) >= 1 / 6).astype(np.float32))
        h_in = h_in.float() * keep
    planes = (r, z, n, hn, h_in, g_ys)
    want = reference.gru_bwd_scan(*planes, w_h, keep)

    def rel(terms):
        got = reference.gru_bwd_scan(*planes, _SplitBf16Product(w_h, terms), keep)
        return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))

    assert rel(2) < 1e-4 / 10
    assert rel(1) > 1e-4


def test_gather_grads_match_jax_including_out_of_range_ids():
    rng = np.random.default_rng(5)
    V, Dg = 9, 4
    table = rng.normal(size=(V, Dg)).astype(np.float32)
    ids = np.array([[0, 3, 8, -1, -9, 9, -10, 100], [2, 2, 2, 5, 0, -3, 7, 1]], np.int32)
    g = rng.normal(size=(2, 8, Dg)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: xla_ops.embedding_gather(t, jnp.asarray(ids)),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    before = cuda_gather.embedding_scatter_add.launches
    cuda_gather.embedding_gather(t, torch.from_numpy(ids)).backward(torch.from_numpy(g))
    assert cuda_gather.embedding_scatter_add.launches == before
    np.testing.assert_allclose(_np(t.grad), _np(want), **F32_TOL)


@pytest.mark.parametrize("g_shape,ids_dtype,num_rows,match", [
    ((2, 3, 4), torch.int32, 9, None),
    ((2, 3, 4), torch.int16, 9, "ids dtype"),
    ((2, 4, 4), torch.int32, 9, "does not match"),
    ((2, 3, 4), torch.int32, 0, "does not match"),
])
def test_scatter_add_kernel_rejects_what_it_cannot_take(g_shape, ids_dtype, num_rows, match):
    g = torch.zeros(g_shape)
    ids = torch.zeros((2, 3), dtype=ids_dtype)
    if match is None:
        cuda_gather.check_scatter_add_launchable(g, ids, num_rows)
        return
    with pytest.raises(ValueError, match=match):
        cuda_gather.check_scatter_add_launchable(g, ids, num_rows)


@pytest.mark.parametrize("n,num_rows,D,chunk,chunks", [
    (0, 9, 4, 256, 0),
    (1, 9, 4, 256, 1),
    (6_400, 12_102, 256, 256, 25),  # beauty's step: B=128, T=50
    (12_800, 37_484, 100, 256, 50),  # rsc15: B=256, T=50
    (25_600, 3_418, 128, 512, 50),  # ML-1M GRU4Rec: B=128, T=200
    (16_384, 3_418, 128, 256, 64),
    (16_385, 3_418, 128, 512, 33),
    (1_000_000, 10_000_001, 128, 512, 1954),
])
def test_scatter_add_plan_chunks_and_launches(n, num_rows, D, chunk, chunks):
    """The deterministic scatter-add's plan: chunks of 256 positions up to
    n = 16,384, else 512 (25 to 50 of them at the training shapes), a
    block of a thread a position for each, two launches (none for no
    ids)."""
    plan = cuda_gather.scatter_add_plan(n, num_rows, D)
    assert (plan["chunk"], plan["chunks"]) == (chunk, chunks)
    assert plan["chunks"] * chunk >= n > (plan["chunks"] - 1) * chunk or n == 0
    assert plan["threads"] == chunk and plan["sub_run"] == 32 and plan["deterministic"]
    assert plan["launches"] == (2 if n else 0)


@pytest.mark.parametrize("n,num_rows,D", [(-1, 9, 4), (5, 0, 4), (5, 2 ** 31, 4), (5, 9, 0),
                                          (2 ** 31, 9, 4)])
def test_scatter_add_plan_rejects_what_it_cannot_take(n, num_rows, D):
    with pytest.raises(ValueError, match="scatter_add"):
        cuda_gather.scatter_add_plan(n, num_rows, D)


def _ordered_loop(g, ids, num_rows, chunk):
    """The scatter-add's stated order, one numpy f32 add at a time: per
    chunk of `chunk` positions, each id's positions in order cut into
    sub-runs of 32, each summed from 0; a run's sub-run sums from 0; a
    table row's chunk partials from 0 in chunk order."""
    n, d = g.shape
    parts = {}
    for c0 in range(0, n, chunk):
        runs = {}
        for p in range(c0, min(n, c0 + chunk)):
            if -num_rows <= ids[p] < num_rows:
                runs.setdefault(int(ids[p]) % num_rows, []).append(p)
        for row, ps in runs.items():
            subs = []
            for s0 in range(0, len(ps), 32):
                acc = np.zeros(d, np.float32)
                for p in ps[s0:s0 + 32]:
                    acc = acc + g[p]
                subs.append(acc)
            part = subs[0]
            if len(subs) > 1:
                part = np.zeros(d, np.float32)
                for sub in subs:
                    part = part + sub
            parts.setdefault(row, []).append(part)
    out = np.zeros((num_rows, d), np.float32)
    for row, ps in parts.items():
        for part in ps:
            out[row] = out[row] + part
    return out


@pytest.mark.parametrize("n,num_rows,D,heavy", [(1, 5, 3, False), (700, 7, 4, False),
                                                (3_000, 40, 8, True), (5_000, 3, 5, True)])
def test_scatter_add_plain_ordered_is_the_stated_order(n, num_rows, D, heavy):
    """`plain_ordered` (what the card's kernel equals bit for bit) adds in
    the order gather.cu states: against a numpy loop of single f32 adds,
    bit for bit, with out-of-range ids and, `heavy`, a row that takes a
    third of all positions (runs of more than 32 in a chunk)."""
    rng = np.random.default_rng(n)
    ids = rng.integers(-num_rows - 2, num_rows + 2, size=n)
    if heavy:
        ids[rng.random(n) < 1 / 3] = 1
    g = rng.normal(size=(n, D)).astype(np.float32)
    chunk = cuda_gather.scatter_add_plan(n, num_rows, D)["chunk"]
    got = cuda_gather.plain_ordered(torch.from_numpy(g), torch.from_numpy(ids), num_rows, chunk)
    assert np.array_equal(got.numpy(), _ordered_loop(g, ids, num_rows, chunk))


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,num_rows,D", [(25_600, 3_418, 16), (6_400, 200, 20)])
def test_scatter_add_plain_ordered_within_the_f32_bound_of_index_put(ids_dtype, n, num_rows, D):
    """`plain_ordered` against the plain version (`index_put_` with
    accumulate) on Zipf(1.0) ids with a heavy padding row and planted
    out-of-range ids: within the f32 summation bound n_max * 2^-24 *
    sum |terms| of the row with the most ids (n_max), as chip_smoke checks
    the kernel."""
    rng = np.random.default_rng(D)
    p = 1.0 / np.arange(1, num_rows)
    ids = rng.choice(np.arange(1, num_rows), size=n, p=p / p.sum())
    ids[rng.random(n) < 0.3] = 0  # the padding id
    ids[:5] = [-1, -num_rows, num_rows, -num_rows - 1, 10 ** 6]
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(n, D)).astype(np.float32))
    ids_t = torch.from_numpy(ids).to(ids_dtype)
    chunk = cuda_gather.scatter_add_plan(n, num_rows, D)["chunk"]
    got = cuda_gather.plain_ordered(g, ids_t, num_rows, chunk)
    want = cuda_gather.plain_backward(g, ids_t, num_rows)
    valid = ids[(ids >= -num_rows) & (ids < num_rows)] % num_rows
    n_max = int(np.bincount(valid, minlength=num_rows).max())
    tol = n_max * 2.0 ** -24 * cuda_gather.plain_backward(g.abs(), ids_t, num_rows).max().item()
    assert n_max > 0.25 * n
    assert (got - want).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# Negative samplers
# ---------------------------------------------------------------------------


def _ulps(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))))


@pytest.mark.parametrize("vocab", [2, 30, 3418, 1_000_007])
def test_log_probs_match_jax(vocab):
    ids = np.concatenate([[0], np.arange(1, min(vocab, 4000))]).astype(np.int32)
    for kind in ("uniform", "log_uniform"):
        want = np.asarray(jax_negative.pos_log_prob(jnp.asarray(ids), vocab, kind))
        got = _np(negative.pos_log_prob(torch.from_numpy(ids), vocab, kind))
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert _ulps(got, want) <= 1.0, kind
    np.testing.assert_array_equal(
        _np(negative.log_uniform_log_prob(torch.from_numpy(ids), vocab)),
        _np(negative.pos_log_prob(torch.from_numpy(ids), vocab, "log_uniform")))
    with pytest.raises(ValueError, match="sampler"):
        negative.pos_log_prob(torch.from_numpy(ids), vocab, "zipf")


@pytest.mark.parametrize("kind", ["uniform", "log_uniform"])
def test_samplers_draw_in_range_with_the_stated_law(kind):
    """200k draws over 50 items: ids in [1, V), the returned log_q is the law's
    log-probability of each id, and the histogram passes a chi-square test
    (49 degrees of freedom; 99.9% quantile 85.4)."""
    V, n = 51, 200_000
    gen = torch.Generator().manual_seed(0)
    ids, log_q = negative.sample_negatives(gen, n, V, kind)
    assert ids.dtype == torch.int32 and ids.shape == (n,) and log_q.shape == (n,)
    assert int(ids.min()) >= 1 and int(ids.max()) <= V - 1
    np.testing.assert_array_equal(_np(log_q), _np(negative.pos_log_prob(ids, V, kind)))
    p = np.exp(_np(negative.pos_log_prob(torch.arange(1, V), V, kind)).astype(np.float64))
    p /= p.sum()
    counts = np.bincount(ids.numpy(), minlength=V)[1:]
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 85.4, chi2
    again, _ = negative.sample_negatives(torch.Generator().manual_seed(0), n, V, kind)
    assert torch.equal(ids, again)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adam_clip": dict(optimizer="adam"),
    "adam_noclip": dict(optimizer="adam", grad_clip_norm=0.0),
    "adagrad_clip": dict(optimizer="adagrad"),
    "adagrad_noclip": dict(optimizer="adagrad", grad_clip_norm=0.0),
    "sgd_clip": dict(optimizer="sgd", learning_rate=0.1),
    "sgd_noclip": dict(optimizer="sgd", grad_clip_norm=0.0, learning_rate=0.1),
    "adam_weight_decay": dict(optimizer="adam", weight_decay=0.01),
    "adam_cosine": dict(optimizer="adam", lr_schedule="cosine", num_steps=4),
    "adam_warmup_cosine": dict(optimizer="adam", lr_schedule="warmup_cosine",
                               warmup_steps=2, num_steps=5),
}


def _opt_params(rng):
    return {"item_embedding": rng.normal(size=(7, 4)).astype(np.float32),
            "tower": {"gru0_wx": rng.normal(size=(4, 12)).astype(np.float32),
                      "gru0_bx": rng.normal(size=(12,)).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_trajectory_matches_optax(case):
    """Five steps of the port's optimizer against the JAX package's optax
    chain. Step 2's gradient has a global norm above the clip of 5.0."""
    cfg_kw = {"learning_rate": 1e-2, **OPT_CASES[case]}
    rng = np.random.default_rng(6)
    params = _opt_params(rng)
    grads = []
    for step in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                   params)
        if step == 2:
            g = jax.tree_util.tree_map(lambda a: a * 10.0, g)
        grads.append(g)
    assert np.sqrt(sum((a ** 2).sum() for a in _flat(grads[2]).values())) > 5.0

    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg_kw))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_opt = opt.init(j_params)
    port = train_state.make_optimizer(TrainConfig(**cfg_kw))
    t_params = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    t_opt = port.init(t_params)
    for g in grads:
        upd, j_opt = opt.update(jax.tree_util.tree_map(jnp.asarray, g), j_opt, j_params)
        j_params = optax.apply_updates(j_params, upd)
        t_upd, t_opt = port.update({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                                   t_opt, t_params)
        t_params = port.apply(t_params, t_upd)
        for k, v in _flat(j_params).items():
            np.testing.assert_allclose(_np(t_params[k]), _np(v), rtol=1e-5, atol=2e-7,
                                       err_msg=k)


def test_decay_mask_matches_jax():
    params = _opt_params(np.random.default_rng(7))
    want = _flat(jax_state.decay_mask(params))
    got = train_state.decay_mask({k: torch.from_numpy(v) for k, v in _flat(params).items()})
    assert got == want == {"item_embedding": False, "tower.gru0_wx": True,
                           "tower.gru0_bx": False}


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_optax(schedule):
    cfg_kw = dict(learning_rate=3e-3, lr_schedule=schedule, num_steps=10, warmup_steps=4)
    want = jax_state.make_schedule(JaxTrainConfig(**cfg_kw))
    got = train_state.make_schedule(TrainConfig(**cfg_kw))
    for count in range(13):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-10)
    with pytest.raises(ValueError, match="lr_schedule"):
        train_state.make_schedule(TrainConfig(lr_schedule="step"))


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


def _train_batch(rng, B=5, T=9, vocab=40, users=7):
    inputs = np.zeros((B, T), np.int32)
    targets = np.zeros((B, T), np.int32)
    for r, n in enumerate([T, 4, 1, 0, 7][:B]):
        seq = rng.integers(1, vocab, size=n + 1)
        inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
    return {"inputs": inputs, "targets": targets,
            "mask": (targets != 0).astype(np.float32),
            "users": rng.integers(0, users + 1, size=B).astype(np.int32)}


class _DS:
    def __init__(self, vocab_size, num_users=0):
        self.vocab_size, self.num_users = vocab_size, num_users


@pytest.mark.parametrize("vocab", [40, 40_000])
def test_wire_format_matches_jax(vocab):
    batch = _train_batch(np.random.default_rng(8), vocab=min(vocab, 40))
    fake = types.SimpleNamespace(ds=_DS(vocab, 7))
    fake._wire_dtype = JaxTrainer._wire_dtype.fget(fake)
    want = JaxTrainer.pack_train_batch(fake, batch)
    tr = Trainer.__new__(Trainer)
    tr.ds = _DS(vocab, 7)
    got = tr.pack_train_batch(batch)
    assert got.dtype == want.dtype == (np.int16 if vocab < 2 ** 15 else np.int32)
    np.testing.assert_array_equal(got, want)
    j_planes = JaxTrainer._unpack_wire(None, jnp.asarray(want))
    t_planes = Trainer._unpack_wire(torch.from_numpy(got))
    assert sorted(j_planes) == sorted(t_planes)
    for k in j_planes:
        np.testing.assert_array_equal(_np(t_planes[k]), _np(j_planes[k]), err_msg=k)
    bad = dict(batch, mask=batch["mask"] * 0.5)
    assert tr.pack_train_batch(bad) is None and JaxTrainer.pack_train_batch(fake, bad) is None
    assert tr.pack_train_batch(dict(batch, reset=batch["mask"])) is None


# ---------------------------------------------------------------------------
# Model loss and the trainer
# ---------------------------------------------------------------------------

VOCAB, USERS = 30, 6


def _model_pair(loss, **kw):
    common = dict(arch="gru4rec", embed_dim=16, dropout_rate=0.0, compute_dtype="float32",
                  loss=loss, num_negatives=9, **kw)
    num_users = USERS if kw.get("use_user_embedding") else 0
    jm = jax_build_model(JaxModelConfig(**common), VOCAB, num_users=num_users)
    tm = build_model(ModelConfig(**common), VOCAB, num_users=num_users, device="cpu")
    params = random_params(tm, seed=2)
    rng = np.random.default_rng(9)
    for name in params["params"]["tower"]:
        if name.endswith(("_bx", "_bh")):
            params["params"]["tower"][name] = rng.normal(scale=0.1, size=48).astype(np.float32)
    if "output_bias" in params["params"]:
        params["params"]["output_bias"] = rng.normal(size=VOCAB).astype(np.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm


LOSS_CASES = {
    "full_softmax": dict(loss="full_softmax"),
    "sampled_softmax": dict(loss="sampled_softmax"),
    "sampled_softmax_user_untied": dict(loss="sampled_softmax", use_user_embedding=True,
                                        tie_embeddings=False),
    "bpr": dict(loss="bpr"),
    "top1": dict(loss="top1"),
    "bpr_max": dict(loss="bpr_max", num_layers=2, residual=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_model_loss_and_every_grad_match_jax(case):
    jm, params, tm = _model_pair(**LOSS_CASES[case])
    batch = _train_batch(np.random.default_rng(10), T=8, vocab=VOCAB, users=USERS)
    rng = np.random.default_rng(11)
    neg_ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    neg_ids[:2] = batch["targets"][0, :2]  # accidental hits
    nlq = np.array(jax_negative.log_uniform_log_prob(jnp.asarray(neg_ids), VOCAB))
    nlq_kw = nlq if LOSS_CASES[case]["loss"] == "sampled_softmax" else None

    def jloss(p):
        return jm.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        neg_ids=jnp.asarray(neg_ids),
                        neg_log_q=None if nlq_kw is None else jnp.asarray(nlq_kw),
                        deterministic=True, method=jm.loss)

    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_sum, j_w = jloss(j_params)
    j_grads = jax.grad(lambda p: jloss(p)[0])(j_params)
    t_sum, t_w = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                         neg_ids=torch.from_numpy(neg_ids),
                         neg_log_q=None if nlq_kw is None else torch.from_numpy(nlq_kw),
                         deterministic=True)
    t_sum.backward()
    np.testing.assert_allclose(_np(t_sum), _np(j_sum), **F32_TOL)
    assert float(t_w) == float(j_w) == float(batch["mask"].sum())
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        np.testing.assert_allclose(_np(p.grad), want[name].numpy(), err_msg=name, **F32_TOL)


def test_model_loss_dropout_uses_flax_formula_and_the_generator():
    """Input dropout keeps an element where a uniform draw from the generator
    falls below 1 - rate and scales it by 1 / (1 - rate); the same generator
    seed gives the same loss, another seed another loss."""
    from seqrec_tpu_torch.models.towers import dropout

    x = torch.ones(4, 1000)
    gen = torch.Generator().manual_seed(1)
    y = dropout(x, 0.25, gen)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, torch.where(u < 0.75, x / 0.75, 0.0))
    assert torch.equal(dropout(x, 0.0, None), x)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)
    _, _, tm = _model_pair("full_softmax", num_layers=2)
    tm.dropout_rate = tm.tower.dropout_rate = 0.5
    batch = {k: torch.from_numpy(v) for k, v in
             _train_batch(np.random.default_rng(12), T=8, vocab=VOCAB).items()}
    det = tm.loss(batch, deterministic=True)[0].detach()
    runs = [tm.loss(batch, generator=torch.Generator().manual_seed(s))[0].detach()
            for s in (3, 3, 4)]
    assert float(runs[0]) == float(runs[1]) != float(runs[2])
    assert float(runs[0]) != float(det)


def _run_cfg(**train):
    return RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(
        ["model.embed_dim=16", "model.num_negatives=9", "model.dropout_rate=0.0",
         "model.compute_dtype=float32", "data.max_len=8"]
        + [f"train.{k}={v}" for k, v in train.items()])


def test_trainer_trajectory_matches_jax(monkeypatch):
    """Three `Trainer.train_step`s against JAX value_and_grad + the JAX
    package's optax chain (Adam, clip 5.0), from the same parameters with
    the same injected negatives (dropout off)."""
    cfg = _run_cfg()
    tr = Trainer(cfg, _DS(VOCAB), device="cpu")
    state = tr.init_state(5)
    params = random_params(tr.model, seed=5)
    rng = np.random.default_rng(13)
    negs = []
    for _ in range(3):
        ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
        negs.append((ids, np.asarray(jax_negative.log_uniform_log_prob(jnp.asarray(ids),
                                                                       VOCAB))))
    drawn = iter(negs)
    monkeypatch.setattr(tr, "sample_negatives",
                        lambda gen: tuple(torch.from_numpy(a) for a in next(drawn)))
    batches = [_train_batch(np.random.default_rng(20 + i), T=8, vocab=VOCAB) for i in range(3)]
    for b in batches:
        b.pop("users")

    jm = jax_build_model(JaxModelConfig(**{**cfg.model.__dict__}), VOCAB)
    opt = jax_state.make_optimizer(JaxTrainConfig(**cfg.train.__dict__))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_opt = opt.init(j_params["params"])
    for step, (batch, (ids, nlq)) in enumerate(zip(batches, negs)):
        def loss_fn(p):
            s, w = jm.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                            neg_ids=jnp.asarray(ids), neg_log_q=jnp.asarray(nlq),
                            deterministic=True, method=jm.loss)
            return s / jnp.maximum(w, 1.0), w

        (j_loss, j_w), grads = jax.value_and_grad(loss_fn, has_aux=True)(j_params)
        j_norm = optax.global_norm(grads["params"])
        upd, j_opt = opt.update(grads["params"], j_opt, j_params["params"])
        j_params = {"params": optax.apply_updates(j_params["params"], upd)}

        state, m = tr.train_step(state, tr.pack_train_batch(batch))
        assert state.step == step + 1
        np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(j_norm), rtol=1e-5)
        assert float(m["tokens"]) == float(j_w) and not bool(m["nonfinite"])
        want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_params))
        for k, v in want.items():
            np.testing.assert_allclose(_np(state.params[k]), v.numpy(), rtol=1e-5,
                                       atol=2e-5, err_msg=f"step {step} {k}")


def test_train_step_multi_equals_single_steps_exactly():
    """K=3 grouped steps give bitwise the K single steps' state, with dropout
    on and negatives drawn from the per-step generators; metrics aggregate
    as the JAX package's (mean loss, summed tokens, max norm, any
    non-finite)."""
    cfg = RunConfig.load("configs/ml1m_gru4rec.json").apply_overrides(
        ["model.embed_dim=16", "model.num_negatives=9", "data.max_len=8"])
    tr = Trainer(cfg, _DS(VOCAB), device="cpu")
    wires = np.stack([tr.pack_train_batch(_train_batch(np.random.default_rng(30 + i), T=8,
                                                       vocab=VOCAB)) for i in range(3)])
    single, ms = tr.init_state(1), []
    for w in wires:
        single, m = tr.train_step(single, w)
        ms.append(m)
    start = tr.init_state(1)
    grouped, gm = tr.train_step_multi(start, wires)
    assert grouped.step == single.step == 3 and start.step == 0
    for k in single.params:
        assert torch.equal(grouped.params[k], single.params[k]), k
    for k in single.opt_state["mu"]:
        assert torch.equal(grouped.opt_state["mu"][k], single.opt_state["mu"][k]), k
    assert float(gm["loss"]) == float(torch.stack([m["loss"] for m in ms]).mean())
    assert float(gm["tokens"]) == sum(float(m["tokens"]) for m in ms)
    assert float(gm["grad_norm"]) == max(float(m["grad_norm"]) for m in ms)
    assert not bool(gm["nonfinite"])
    # The state a step was given is left as it was (the step is functional).
    fresh = tr.init_state(1)
    for k in fresh.params:
        assert torch.equal(start.params[k], fresh.params[k])


def test_train_step_sanitizes_and_flags_nonfinite_grads(monkeypatch):
    cfg = _run_cfg(sanitize_nans="true")
    tr = Trainer(cfg, _DS(VOCAB), device="cpu")
    state = tr.init_state(2)
    state.params["item_embedding"][3, 0] = float("nan")
    wire = tr.pack_train_batch(_train_batch(np.random.default_rng(40), T=8, vocab=VOCAB))
    new, m = tr.train_step(state, wire)
    assert bool(m["nonfinite"])
    # sanitize_nans zeroes the NaN gradients; the NaN parameter itself stays.
    assert bool(torch.isfinite(new.params["tower.gru0_wx"]).all())


def test_trainer_refuses_unported_modes_and_defaults_to_cuda(monkeypatch):
    # One process (no process group): a mesh of model_axis=2 does not fit,
    # and the error is the JAX package's make_mesh's.
    with pytest.raises(ValueError, match="^model_axis=2 must divide device count 1$"):
        Trainer(_run_cfg().apply_overrides(["train.sparse_embedding_update=true",
                                            "mesh.shard_embeddings=true", "mesh.model_axis=2"]),
                _DS(VOCAB), device="cpu")
    with pytest.raises(ValueError, match="^model_axis=2 must divide device count 1$"):
        Trainer(_run_cfg().apply_overrides(["mesh.shard_embeddings=true",
                                            "mesh.model_axis=2"]), _DS(VOCAB), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_run_cfg(), _DS(VOCAB))
