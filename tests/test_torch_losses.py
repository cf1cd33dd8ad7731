"""The port's training losses and the sampled-softmax head against the JAX
package (ops/xla.py and the Pallas head in interpret mode), on identical
numpy inputs: values and gradients.

Tolerances: f32 1e-5 (same formulas, another summation order); bf16 3e-2
(both sides round the [N, S] logits' inputs and products to bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import softmax_head as pl_head
from seqrec_tpu_torch.ops import dispatch, reference
from seqrec_tpu_torch.ops.cuda import head as cuda_head

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
N, S, H, V = 37, 13, 16, 50


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, H)).astype(np.float32)
    pos = rng.normal(size=(N, H)).astype(np.float32) * 0.5
    neg = rng.normal(size=(S, H)).astype(np.float32) * 0.5
    targets = rng.integers(1, V, size=N).astype(np.int32)
    neg_ids = rng.integers(1, V, size=S).astype(np.int32)
    neg_ids[:3] = targets[[0, 5, 9]]  # accidental hits
    weights = (rng.random(N) > 0.3).astype(np.float32)
    plq = (rng.normal(size=N) - 4).astype(np.float32)
    nlq = (rng.normal(size=S) - 4).astype(np.float32)
    return h, pos, neg, targets, neg_ids, weights, plq, nlq


def _sampled_pair(name):
    """(jax fn, torch fn) over (h, pos, neg) with ids, weights and logQ bound."""
    _, _, _, targets, neg_ids, weights, plq, nlq = _inputs()
    jt, jn, jw = jnp.asarray(targets), jnp.asarray(neg_ids), jnp.asarray(weights)
    tt, tn, tw = (torch.from_numpy(a) for a in (targets, neg_ids, weights))
    if name == "sampled_softmax":
        kw_j = dict(pos_log_q=jnp.asarray(plq), neg_log_q=jnp.asarray(nlq))
        kw_t = dict(pos_log_q=torch.from_numpy(plq), neg_log_q=torch.from_numpy(nlq))
    else:
        kw_j = kw_t = {}
    jfn = getattr(xla_ops, f"{name}_loss")
    tfn = getattr(reference, f"{name}_loss")
    return (lambda h, p, n: jfn(h, p, n, jt, jn, jw, **kw_j),
            lambda h, p, n: tfn(h, p, n, tt, tn, tw, **kw_t))


@pytest.mark.parametrize("name", ["sampled_softmax", "bpr", "top1", "bpr_max"])
def test_sampled_losses_and_grads_match_xla(name):
    h, pos, neg = _inputs()[:3]
    jfn, tfn = _sampled_pair(name)
    j_args = [jnp.asarray(a) for a in (h, pos, neg)]
    j_loss, j_w = jfn(*j_args)
    j_grads = jax.grad(lambda *a: jfn(*a)[0], argnums=(0, 1, 2))(*j_args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, pos, neg)]
    t_loss, t_w = tfn(*leaves)
    t_loss.backward()
    np.testing.assert_allclose(_np(t_loss), _np(j_loss), **F32_TOL)
    np.testing.assert_allclose(_np(t_w), _np(j_w), **F32_TOL)
    for t, j in zip(leaves, j_grads):
        np.testing.assert_allclose(_np(t.grad), _np(j), **F32_TOL)


@pytest.mark.parametrize("with_bias,num_valid", [(False, None), (True, None), (True, V - 5)])
def test_full_softmax_loss_and_grads_match_xla(with_bias, num_valid):
    rng = np.random.default_rng(1)
    h = rng.normal(size=(N, H)).astype(np.float32)
    table = rng.normal(size=(V, H)).astype(np.float32) * 0.5
    bias = rng.normal(size=V).astype(np.float32) if with_bias else None
    targets = rng.integers(0, num_valid or V, size=N).astype(np.int32)
    weights = (rng.random(N) > 0.3).astype(np.float32)

    def jfn(h, t, b):
        return xla_ops.full_softmax_loss(h, t, jnp.asarray(targets), jnp.asarray(weights),
                                         bias=b, num_valid=num_valid)

    argnums = (0, 1, 2) if with_bias else (0, 1)
    j_args = [jnp.asarray(h), jnp.asarray(table), None if bias is None else jnp.asarray(bias)]
    j_loss, j_w = jfn(*j_args)
    j_grads = jax.grad(lambda *a: jfn(*a)[0], argnums=argnums)(*j_args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, table)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    t_loss, t_w = reference.full_softmax_loss(leaves[0], leaves[1], torch.from_numpy(targets),
                                              torch.from_numpy(weights), bias=tb,
                                              num_valid=num_valid)
    t_loss.backward()
    np.testing.assert_allclose(_np(t_loss), _np(j_loss), **F32_TOL)
    np.testing.assert_allclose(_np(t_w), _np(j_w), **F32_TOL)
    for t, j in zip(leaves + ([tb] if with_bias else []), j_grads):
        np.testing.assert_allclose(_np(t.grad), _np(j), **F32_TOL)


def test_sampled_softmax_bf16_matches_xla():
    h, pos, neg = _inputs(2)[:3]
    jfn, tfn = _sampled_pair("sampled_softmax")
    want = jfn(*(jnp.asarray(a, jnp.bfloat16) for a in (h, pos, neg)))[0]
    got = tfn(*(torch.from_numpy(a).bfloat16() for a in (h, pos, neg)))[0]
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def _head_args(dtype_j, dtype_t, seed=3):
    h, pos, neg, targets, neg_ids, weights, plq, nlq = _inputs(seed)
    j = [jnp.asarray(a, dtype_j) for a in (h, pos, neg)] + [
        jnp.asarray(a) for a in (targets, neg_ids, plq, nlq)]
    t = [torch.from_numpy(a).to(dtype_t) for a in (h, pos, neg)] + [
        torch.from_numpy(a) for a in (targets, neg_ids, plq, nlq)]
    return j, t, weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_plain_matches_pallas_interpret(dtype):
    """The head wrapper on a CPU tensor (its plain version) against the TPU
    kernel itself, run by Pallas's interpreter. The kernel multiplies in f32,
    so bf16 inputs agree to f32 precision too."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    j, t, _ = _head_args(jdt, tdt)
    want = pl_head._head_pallas(*j, interpret=True)
    before = cuda_head.sampled_softmax_nll.launches
    got = cuda_head.sampled_softmax_nll(*t)
    assert cuda_head.sampled_softmax_nll.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_head_plain_matches_pallas_interpret_at_beauty_width():
    """At beauty's and steam's width (H = 256, 256 negatives) in f32, which
    the first f32 design refused on the card: the wrapper on a CPU tensor
    (its plain version) against the TPU kernel in Pallas's interpreter."""
    rng = np.random.default_rng(11)
    n, s_, h_ = 40, 256, 256
    h = rng.normal(size=(n, h_)).astype(np.float32) * h_ ** -0.25
    pos = rng.normal(size=(n, h_)).astype(np.float32) * h_ ** -0.25
    neg = rng.normal(size=(s_, h_)).astype(np.float32) * h_ ** -0.25
    targets = rng.integers(1, 3 * s_, size=n).astype(np.int32)
    neg_ids = rng.integers(1, 3 * s_, size=s_).astype(np.int32)
    neg_ids[:3] = targets[:3]  # accidental hits
    plq = (rng.normal(size=n) - 6).astype(np.float32)
    nlq = (rng.normal(size=s_) - 6).astype(np.float32)
    arrays = (h, pos, neg, targets, neg_ids, plq, nlq)
    want = pl_head._head_pallas(*(jnp.asarray(a) for a in arrays), interpret=True)
    before = cuda_head.sampled_softmax_nll.launches
    got = cuda_head.sampled_softmax_nll(*(torch.from_numpy(a) for a in arrays))
    assert cuda_head.sampled_softmax_nll.launches == before
    assert tuple(got.shape) == (n,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_head_loss_and_grads_match_pallas_custom_vjp():
    """Loss and gradients of the wrapper's autograd Function (plain forward,
    recompute backward) against jax.grad through the Pallas head's custom
    VJP in interpret mode."""
    j, t, weights = _head_args(jnp.float32, torch.float32, seed=4)

    def jloss(h, p, n):
        return pl_head.sampled_softmax_loss(
            h, p, n, j[3], j[4], jnp.asarray(weights), pos_log_q=j[5], neg_log_q=j[6],
            interpret=True)[0]

    j_loss, j_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*j[:3])
    leaves = [a.requires_grad_(True) for a in t[:3]]
    t_loss, t_w = cuda_head.sampled_softmax_loss(
        *leaves, t[3], t[4], torch.from_numpy(weights), pos_log_q=t[5], neg_log_q=t[6])
    t_loss.backward()
    np.testing.assert_allclose(_np(t_loss), _np(j_loss), **F32_TOL)
    assert float(t_w) == float(weights.sum())
    for a, g in zip(leaves, j_grads):
        np.testing.assert_allclose(_np(a.grad), _np(g), **F32_TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_head_dispatch_on_cpu_gives_plain_and_launches_nothing(use_pallas):
    h, pos, neg, targets, neg_ids, weights, plq, nlq = (
        torch.from_numpy(a) for a in _inputs(5))
    before = cuda_head.sampled_softmax_nll.launches
    got = dispatch.sampled_softmax_loss(h, pos, neg, targets, neg_ids, weights,
                                        pos_log_q=plq, neg_log_q=nlq,
                                        use_pallas=use_pallas)
    want = reference.sampled_softmax_loss(h, pos, neg, targets, neg_ids, weights,
                                          pos_log_q=plq, neg_log_q=nlq)
    assert cuda_head.sampled_softmax_nll.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)


def test_head_without_logq_matches_xla():
    h, pos, neg, targets, neg_ids, weights, _, _ = _inputs(6)
    want = xla_ops.sampled_softmax_loss(*(jnp.asarray(a) for a in
                                          (h, pos, neg, targets, neg_ids, weights)))
    got = cuda_head.sampled_softmax_loss(*(torch.from_numpy(a) for a in
                                           (h, pos, neg, targets, neg_ids, weights)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)


def test_head_launch_config_at_the_training_shape():
    """bf16: the tensor-core design, 128 rows a block (200 blocks at N =
    25,600), a ring of three S-tiles of 64 negatives [64][136] bf16 with
    their ids and logQ. f32: the streamed SIMT design, 128 rows a block of
    256 threads (200 blocks, two an SM: one wave), their h resident
    ([128][132] f32), a ring of two 32-deep k chunks of a 128-negative
    S-tile ([32][132] f32); at beauty's width 64 rows a block of 128
    threads, two an SM."""
    cfg = cuda_head.launch_config(25_600, 256, 128, torch.bfloat16)
    assert cfg == {"design": "mma.sync", "grid": 200, "threads": 256, "rows_per_block": 128,
                   "hidden_padded": 128, "s_tile": 64, "unit_bytes": 16,
                   "smem_bytes": 3 * (64 * 136 * 2 + 64 * 8)}
    assert 2 * cfg["smem_bytes"] <= cuda_head.SMEM_LIMIT  # two blocks share an SM
    f32 = cuda_head.launch_config(25_600, 256, 128, torch.float32)
    assert f32 == {"design": "simt-stream", "grid": 200, "threads": 256,
                   "rows_per_block": 128, "hidden_padded": 128, "s_tile": 128, "k_chunk": 32,
                   "stages": 2, "pos_unit_bytes": 16,
                   "smem_bytes": (128 * 132 + 2 * 32 * 132 + 4 * 128) * 4}
    assert 2 * f32["smem_bytes"] <= cuda_head.SMEM_LIMIT  # two blocks share an SM
    odd = cuda_head.launch_config(100, 100, 100, torch.float32)
    assert (odd["grid"], odd["rows_per_block"], odd["hidden_padded"]) == (2, 64, 128)
    assert odd["smem_bytes"] == (128 * 68 + 2 * 32 * 132 + 4 * 64) * 4
    assert 3 * odd["smem_bytes"] <= cuda_head.SMEM_LIMIT  # three blocks share an SM
    beauty = cuda_head.launch_config(6_400, 256, 256, torch.float32)
    assert (beauty["grid"], beauty["rows_per_block"], beauty["hidden_padded"]) == (100, 64, 256)
    assert 2 * beauty["smem_bytes"] <= cuda_head.SMEM_LIMIT
    wide = cuda_head.launch_config(12_800, 256, 256, torch.float32)
    assert wide["rows_per_block"] == 64  # 128 rows only at H <= 128


@pytest.mark.parametrize("S,H,hp", [(2048, 128, 128), (1, 8, 16), (100_000, 64, 64),
                                    (256, 136, 256)])
def test_head_bf16_takes_any_number_of_negatives(S, H, hp):
    """Both designs stream the negatives in S-tiles, so their shared memory
    does not grow with S: S = 2048 at H = 128 (eight times what the first
    f32 design could stage) is launchable in bf16 and in f32; bf16 pads H
    to a power of two >= 16, f32 to a multiple of its 32-deep k chunk."""
    cfg = cuda_head.launch_config(300, S, H, torch.bfloat16)
    assert (cfg["grid"], cfg["hidden_padded"]) == (3, hp)
    assert 2 * cfg["smem_bytes"] <= cuda_head.SMEM_LIMIT
    if S == 2048:
        f32 = cuda_head.launch_config(300, S, H, torch.float32)
        assert f32["design"] == "simt-stream" and f32["grid"] == 5
        assert f32["smem_bytes"] == cuda_head.launch_config(300, 1, H, torch.float32)[
            "smem_bytes"]


@pytest.mark.parametrize("S", [1, 127, 128, 129, 256, 2048, 100_000])
@pytest.mark.parametrize("N,H", [(6_400, 4), (6_400, 100), (6_400, 128), (6_400, 256),
                                 (25_600, 100), (25_600, 128), (25_600, 256)])
def test_head_f32_takes_any_s_at_h_up_to_256(S, N, H):
    """The f32 design's shared memory depends on H and its rows a block
    only, whatever S: three blocks of 64 rows an SM at H <= 128, two at 256,
    two of 128 rows (at H <= 128 and N >= 12,288)."""
    cfg = cuda_head.launch_config(N, S, H, torch.float32)
    rows = 128 if H <= 128 and N >= 12_288 else 64
    assert (cfg["rows_per_block"], cfg["threads"], cfg["grid"]) == (rows, 2 * rows, -(-N // rows))
    assert cfg["hidden_padded"] == -(-H // 32) * 32
    per_sm = 3 if rows == 64 and H <= 128 else 2
    assert per_sm * cfg["smem_bytes"] <= cuda_head.SMEM_LIMIT


@pytest.mark.parametrize("shape,dtype,match", [
    ((8, 16, 32), torch.float64, "dtype"),
    ((0, 16, 32), torch.float32, "empty"),
    ((8, 400, 1380), torch.float32, "H <= 1376"),
    ((8, 400, 130), torch.float32, None),  # refused by the float4-only design; taken now
    ((8, 800, 1284), torch.bfloat16, "H <= 1280"),
])
def test_head_kernel_rejects_what_it_cannot_take(shape, dtype, match):
    """Other dtypes and empty shapes raise; H = 260 and the K split's limit
    (1,376 in f32, 1,280 in bf16) take the K split, and widths past it the
    streamed layout; an f32 H that is not a multiple of 4 (130) launches,
    its positive logit a float at a time."""
    if match is not None and match.startswith("H <= "):
        limit = int(match[5:])
        assert cuda_head.max_hidden(dtype) == limit
        for H in (260, limit):
            assert cuda_head.launch_config(*shape[:2], H, dtype)["layout"] == "k-split"
        cfg = cuda_head.launch_config(*shape, dtype)
        assert cfg["layout"] == "streamed" and cfg["max_hidden"] == limit
        return
    if match is None:
        cfg = cuda_head.launch_config(*shape, dtype)
        assert (cfg["design"], cfg["pos_unit_bytes"], cfg["hidden_padded"]) == (
            "simt-stream", 4, 160)
        return
    with pytest.raises(ValueError, match=match):
        cuda_head.launch_config(*shape, dtype)


def test_head_check_launchable_rejects_mismatched_operands():
    t = [torch.from_numpy(a) for a in _inputs(7)]
    h, pos, neg, targets, neg_ids, _, plq, nlq = t
    assert cuda_head.check_launchable(h, pos, neg, targets, neg_ids, plq, nlq)["grid"] == 1
    with pytest.raises(ValueError, match="targets"):
        cuda_head.check_launchable(h, pos, neg, targets[:-1], neg_ids, plq, nlq)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_head.check_launchable(h, pos.bfloat16(), neg, targets, neg_ids, plq, nlq)
    with pytest.raises(ValueError, match="2-D"):
        cuda_head.check_launchable(h[0], pos, neg, targets, neg_ids, plq, nlq)
