"""Every width up to 256 in the gather, the causal attention and the
sampled-softmax head, and the published configurations that need it:
SASRec at its paper's d = 50 (Kang & McAuley, ICDM 2018) and GRU4Rec's 100
units under a sampled softmax.

On the CPU: what each kernel's `launch_config` / `check_launchable` accepts
at every width from 1 to 256 in f32 and bf16, and the unit it moves rows in
(the widest of 16, 8, 4 and 2 bytes that divides a row's bytes, its base
and its strides); the plain versions at D = 50 against the JAX package's
XLA oracles (`seqrec_tpu/ops/xla.py`); and the two models end to end
against the JAX models with weights carried across by `models/convert.py`
(f32, no dropout, injected negatives and logQ: scores, loss and every
gradient). The kernels themselves at these widths are held against their
plain versions on the card by tests/test_torch_kernels.py.

Tolerances, each with its reason: f32 values 1e-5 (the same math in
another summation order); gradients 1e-4 through SASRec's two blocks
(tests/test_torch_sasrec.py's limit) and 1e-5 through the GRU
(tests/test_torch_train.py's); the gather bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.data import negative as jax_negative
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu_torch.config import ModelConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import attention as cuda_attention
from seqrec_tpu_torch.ops.cuda import gather as cuda_gather
from seqrec_tpu_torch.ops.cuda import head as cuda_head
from seqrec_tpu_torch.ops.cuda import unit_bytes

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
WIDTHS = range(1, 257)
DTYPES = (torch.float32, torch.bfloat16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _widest(nbytes: int) -> int:
    return next(u for u in (16, 8, 4, 2) if nbytes % u == 0)


# ---------------------------------------------------------------------------
# What each kernel takes, at every width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_takes_every_width(table_dtype, dtype):
    """Every D in 1..256: the unit divides the row (16 bytes where it did
    before, else 8, 4 or, for an odd bf16 row, 2), its lanes cover the row's
    units in one pass up to 32 of them, its output piece is the same values
    in the output dtype; check_launchable on a table says the same, also at
    a base 4 bytes off a 16-byte boundary."""
    es = torch.empty((), dtype=table_dtype).element_size()
    out_es = torch.empty((), dtype=dtype).element_size()
    ids = torch.zeros(3, dtype=torch.int32)
    for D in WIDTHS:
        cfg = cuda_gather.launch_config(D, table_dtype, dtype)
        unit = cfg["unit_bytes"]
        assert unit == _widest(D * es) and unit >= es, D
        assert cfg["units"] * unit == D * es and cfg["out_unit_bytes"] == unit * out_es // es
        assert cfg["lanes"] == min(32, 1 << (cfg["units"] - 1).bit_length())
        assert cfg["rows_per_block"] == 256 // cfg["lanes"] * 4
        assert cuda_gather.check_launchable(torch.zeros(5, D, dtype=table_dtype), ids,
                                            dtype) == cfg
        flat = torch.zeros(5 * D + 4, dtype=table_dtype)
        off = flat[4 // es:4 // es + 5 * D].view(5, D)
        assert cuda_gather.check_launchable(off, ids, dtype)["unit_bytes"] == min(unit, 4)
    # SASRec d = 50: 200-byte f32 rows in 8-byte units, 25 a row on 32 lanes;
    # a bf16 table's 100-byte rows in 4-byte units.
    assert cuda_gather.launch_config(50, torch.float32, torch.bfloat16)["unit_bytes"] == 8
    assert cuda_gather.launch_config(50, torch.bfloat16)["unit_bytes"] == 4


@pytest.mark.parametrize("g_dtype", DTYPES)
def test_scatter_add_takes_every_width_and_d50_takes_floats(g_dtype):
    """The scatter-add took any D already (float units where D % 4 != 0);
    at D = 50 it takes them, float4s at D = 64, and a g off its float4
    boundary takes floats too."""
    ids = torch.zeros(128, 200, dtype=torch.int32)
    for D in WIDTHS:
        plan = cuda_gather.scatter_add_plan(25_600, 3418, D)
        assert plan["unit"] == ("float4" if D % 4 == 0 else "float"), D
    g = torch.zeros(128, 200, 50, dtype=g_dtype)
    assert cuda_gather.check_scatter_add_launchable(g, ids, 3418)["unit"] == "float"
    g64 = torch.zeros(128 * 200 * 64 + 1, dtype=g_dtype)
    assert cuda_gather.check_scatter_add_launchable(
        g64[:-1].view(128, 200, 64), ids, 3418)["unit"] == "float4"
    assert cuda_gather.check_scatter_add_launchable(
        g64[1:].view(128, 200, 64), ids, 3418)["unit"] == "float"


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_takes_every_head_dim(dtype):
    """Every Dh in 1..256: the unit divides the head's row and the
    operands' alignment; bf16 pads Dh to mma's depth, f32 to its float4
    groups; shared memory fits a block. The SASRec block's q, k and v (one
    head, slices of a [B, T, 3, 1, Dh] projection: rows 3 Dh apart) give
    the unit the kernel stages them in; past 256 the Dh-cluster layout."""
    es = torch.empty((), dtype=dtype).element_size()
    for Dh in WIDTHS:
        cfg = cuda_attention.launch_config(128, 200, 1, Dh, dtype)
        assert cfg["unit_bytes"] == _widest(Dh * es), Dh
        assert cfg["smem_bytes"] <= cuda_attention.SMEM_LIMIT
        if dtype == torch.bfloat16:
            assert cfg["head_dim_padded"] == cuda_attention.head_dim_padded(Dh)
        else:
            assert cfg["head_dim_padded"] == -(-Dh // 4) * 4
            assert cfg["smem_bytes"] == (5 * 32 * (cfg["head_dim_padded"] + 4)
                                         + 4 * 32 * 12) * 4
        qkv = torch.zeros(2, 5, 3, 1, Dh, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert cuda_attention._kernel_view(q).data_ptr() == q.data_ptr()
        align = cuda_attention.operand_align(q, k, v)
        assert align == unit_bytes(16, *(t.data_ptr() for t in (q, k, v)), 3 * Dh * es)
        unit = cuda_attention.launch_config(2, 5, 1, Dh, dtype, align)["unit_bytes"]
        assert unit == unit_bytes(Dh * es, align) and unit >= es
    d50 = torch.zeros(2, 5, 3, 1, 50, dtype=dtype)
    want = 4 if dtype == torch.bfloat16 else 8
    assert cuda_attention.launch_config(
        2, 5, 1, 50, dtype, cuda_attention.operand_align(*d50.unbind(2)))["unit_bytes"] == want
    past = cuda_attention.launch_config(2, 5, 1, 257, dtype)
    assert past["layout"] == "dh-cluster" and past["slices"] == 2 and past["unit_bytes"] == es


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_takes_every_width(dtype):
    """Every H in 1..256: bf16 copies a negative's row in the widest unit
    that divides it (8 at GRU4Rec's H = 100, 4 at SASRec's 50, 2 where H is
    odd) and pads it to Hp; f32 reads the positive logit in float4s where H
    % 4 == 0, else a float at a time; two blocks fit an SM at the training
    step's N = 25,600, S = 256; check_launchable agrees on tensors; past 256
    the K split, and past its limit the streamed layout."""
    es = torch.empty((), dtype=dtype).element_size()
    for H in WIDTHS:
        cfg = cuda_head.launch_config(25_600, 256, H, dtype)
        if dtype == torch.bfloat16:
            assert cfg["unit_bytes"] == _widest(2 * H), H
            assert cfg["hidden_padded"] == max(16, 1 << (H - 1).bit_length())
        else:
            assert cfg["pos_unit_bytes"] == (16 if H % 4 == 0 else 4), H
            assert cfg["hidden_padded"] == -(-H // 32) * 32
        assert 2 * cfg["smem_bytes"] <= cuda_head.SMEM_LIMIT
        t = [torch.zeros(7, H, dtype=dtype), torch.zeros(7, H, dtype=dtype),
             torch.zeros(5, H, dtype=dtype), torch.zeros(7, dtype=torch.int32),
             torch.zeros(5, dtype=torch.int32), torch.zeros(7), torch.zeros(5)]
        got = cuda_head.check_launchable(*t)
        assert got == cuda_head.launch_config(7, 5, H, dtype), H
    # h a view one element off its boundary: the narrowest unit, no copy.
    flat = torch.zeros(7 * 48 + 1, dtype=dtype)
    t[:3] = [flat[1:].view(7, 48), torch.zeros(7, 48, dtype=dtype),
             torch.zeros(5, 48, dtype=dtype)]
    off = cuda_head.check_launchable(*t)
    assert off["unit_bytes" if dtype == torch.bfloat16 else "pos_unit_bytes"] == es
    assert cuda_head.launch_config(8, 16, 257, dtype)["layout"] == "k-split"
    limit = cuda_head.max_hidden(dtype)
    assert cuda_head.launch_config(8, 16, limit + 1, dtype)["layout"] == "streamed"


# ---------------------------------------------------------------------------
# The plain versions at D = 50 against the XLA oracles
# ---------------------------------------------------------------------------


def test_plain_versions_at_d50_match_xla():
    """The gather (jnp.take: wrapped and NaN ids), the causal attention
    (one head of Dh = 50 read from the block's qkv slices) and the sampled
    softmax loss at H = 50, f32, against seqrec_tpu/ops/xla.py."""
    rng = np.random.default_rng(50)
    V, D = 61, 50
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(4, 9)).astype(np.int32)
    ids[0, :4] = [-1, -V, V, 10 ** 6]
    got = reference.embedding_gather(torch.from_numpy(table), torch.from_numpy(ids))
    want = np.asarray(xla_ops.embedding_gather(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(_np(got)[~np.isnan(want)], want[~np.isnan(want)])
    assert np.isnan(_np(got)).sum() == np.isnan(want).sum() == 2 * D

    qkv = rng.normal(size=(3, 40, 3, 1, D)).astype(np.float32)
    tq = torch.from_numpy(qkv)
    got = reference.causal_attention(tq[:, :, 0], tq[:, :, 1], tq[:, :, 2])
    want = xla_ops.causal_attention(*(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)

    N, S = 37, 11
    h, pos = (rng.normal(size=(N, D)).astype(np.float32) * 0.3 for _ in range(2))
    neg = rng.normal(size=(S, D)).astype(np.float32) * 0.3
    targets = rng.integers(1, V, size=N).astype(np.int32)
    neg_ids = rng.integers(1, V, size=S).astype(np.int32)
    neg_ids[:2] = targets[:2]
    plq, nlq = (rng.normal(size=n).astype(np.float32) - 4 for n in (N, S))
    w = (np.arange(N) % 4 != 0).astype(np.float32)
    args = [h, pos, neg, targets, neg_ids, w]
    got = reference.sampled_softmax_loss(*(torch.from_numpy(a) for a in args),
                                         pos_log_q=torch.from_numpy(plq),
                                         neg_log_q=torch.from_numpy(nlq))
    want = xla_ops.sampled_softmax_loss(*(jnp.asarray(a) for a in args),
                                        pos_log_q=jnp.asarray(plq), neg_log_q=jnp.asarray(nlq))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32_TOL)


# ---------------------------------------------------------------------------
# The published widths, model against model
# ---------------------------------------------------------------------------

VOCAB = 41

MODELS = {
    # SASRec as published: d = 50, 2 blocks, 1 head (T cut to 12, the
    # vocabulary to 40 items).
    "sasrec_d50": (dict(arch="sasrec", embed_dim=50, num_layers=2, num_heads=1, max_len=12,
                        tie_embeddings=True), GRAD_TOL),
    # GRU4Rec's 100 units under ml1m_gru4rec's sampled softmax.
    "gru4rec_d100": (dict(arch="gru4rec", embed_dim=100, num_layers=1, max_len=12,
                          tie_embeddings=True), F32_TOL),
}


def _batch(rng, B=4, T=12):
    inputs = np.zeros((B, T), np.int32)
    targets = np.zeros((B, T), np.int32)
    for r, n in enumerate([T, 5, 1, 8][:B]):
        seq = rng.integers(1, VOCAB, size=n + 1)
        inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
    return {"inputs": inputs, "targets": targets, "mask": (targets != 0).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_published_width_matches_jax(name):
    """The port's model against the JAX model at the published width, f32,
    no dropout, weights drawn by the port's initializer and carried across
    by models/convert.py (the JAX model's tree): the last hidden state and
    the scores, then the sampled-softmax loss over injected negatives (two
    accidental hits) with their logQ and every parameter's gradient."""
    kw, grad_tol = MODELS[name]
    common = dict(dropout_rate=0.0, compute_dtype="float32", loss="sampled_softmax",
                  num_negatives=9, **kw)
    jm = jax_build_model(JaxModelConfig(**common), VOCAB)
    tm = build_model(ModelConfig(**common), VOCAB, device="cpu")
    params = random_params(tm, seed=3)
    tm.load_state_dict(flax_to_state_dict(params))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    batch = _batch(np.random.default_rng(12))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(tm.scores(tb["inputs"], tb["mask"])),
            np.asarray(jm.apply(j_params, jb["inputs"], jb["mask"], method=jm.scores)),
            **F32_TOL)
    rng = np.random.default_rng(13)
    neg_ids = rng.integers(1, VOCAB, size=9).astype(np.int32)
    neg_ids[:2] = batch["targets"][0, :2]
    nlq = np.array(jax_negative.log_uniform_log_prob(jnp.asarray(neg_ids), VOCAB))

    def jloss(p):
        return jm.apply(p, jb, neg_ids=jnp.asarray(neg_ids), neg_log_q=jnp.asarray(nlq),
                        deterministic=True, method=jm.loss)

    j_sum, j_w = jloss(j_params)
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.grad(lambda p: jloss(p)[0])(j_params)))
    t_sum, t_w = tm.loss(tb, neg_ids=torch.from_numpy(neg_ids),
                         neg_log_q=torch.from_numpy(nlq), deterministic=True)
    t_sum.backward()
    np.testing.assert_allclose(_np(t_sum), _np(j_sum), **F32_TOL)
    assert float(t_w) == float(j_w) == float(batch["mask"].sum())
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    for pname, p in got.items():
        np.testing.assert_allclose(_np(p.grad), want[pname].numpy(), err_msg=pname,
                                   **grad_tol)
