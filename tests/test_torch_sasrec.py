"""The port's causal attention and SASRec tower (op, tower, model, training
step, `recommend` CLI) against the JAX package on identical numpy inputs:
`ops/xla.py`'s oracle, the Pallas flash kernel in interpret mode with its
custom VJP, and the flax modules with converted weights. The attention
kernel itself is held against its plain version on the card by
tests/test_torch_kernels.py; a training step of the SASRec configuration is
in tests/test_torch_tower_steps.py.

Tolerances, each with its reason:
- f32 1e-5 (values) and 2e-5 against the Pallas kernel (its online softmax
  sums in another order), 1e-4 on gradients;
- bf16 3e-2: both sides round the scores and the probabilities to bf16 and
  the outputs are convex combinations of unit-scale values."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.eval.infer import recommend as jax_recommend
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu.models.towers import SASRecTower as JaxSASRecTower
from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu.ops.pallas import attention as pl_attn
from seqrec_tpu_torch.config import ModelConfig, RunConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import (
    flax_to_state_dict,
    load_npz,
    random_params,
    save_npz,
)
from seqrec_tpu_torch.models.towers import LayerNorm, SASRecTower
from seqrec_tpu_torch.ops import dispatch, reference
from seqrec_tpu_torch.ops.cuda import attention as cuda_attention

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _qkv(B=2, T=50, N=2, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, N, Dh)).astype(np.float32) for _ in range(3))


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [16, 128, 200])
def test_attention_plain_matches_xla_and_pallas_interpret(T):
    q, k, v = _qkv(T=T)
    j = [jnp.asarray(a) for a in (q, k, v)]
    got = reference.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(xla_ops.causal_attention(*j)), **F32_TOL)
    np.testing.assert_allclose(
        _np(got), np.asarray(pl_attn.causal_attention(*j, interpret=True)), **PALLAS_TOL)


def test_attention_custom_scale_and_bf16_match_xla():
    q, k, v = _qkv(T=20, seed=1)
    j = [jnp.asarray(a) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        _np(dispatch.causal_attention(*t, scale=0.5)),
        np.asarray(pl_attn.causal_attention(*j, scale=0.5, interpret=True)), **PALLAS_TOL)
    np.testing.assert_allclose(_np(reference.causal_attention(*t, scale=0.5)),
                               np.asarray(xla_ops.causal_attention(*j, scale=0.5)),
                               **F32_TOL)
    got = reference.causal_attention(*(a.bfloat16() for a in t))
    want = xla_ops.causal_attention(*(a.astype(jnp.bfloat16) for a in j))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_attention_causality_leak():
    """Future keys and values must not change earlier outputs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(T=33, seed=3))
    out1 = cuda_attention.causal_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] = 0.0
    v2[:, 20:] = -5.0
    out2 = cuda_attention.causal_attention(q, k2, v2)
    np.testing.assert_array_equal(_np(out1[:, :20]), _np(out2[:, :20]))
    assert not np.allclose(_np(out1[:, 20:]), _np(out2[:, 20:]))


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_attention_grads_match_jax(oracle):
    """q/k/v gradients through the port's `_Attention` Function on the CPU
    (plain forward, recompute backward) against jax.grad through the Pallas
    kernel's custom VJP and through the XLA oracle."""
    q, k, v = _qkv(B=2, T=40, N=1, Dh=16, seed=4)
    cot = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    fn = {"pallas_interpret": lambda *a: pl_attn.causal_attention(*a, interpret=True),
          "xla": xla_ops.causal_attention}[oracle]
    want = jax.grad(lambda *a: jnp.vdot(fn(*a), cot), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = cuda_attention.causal_attention.launches
    (cuda_attention.causal_attention(*leaves) * torch.from_numpy(cot)).sum().backward()
    assert cuda_attention.causal_attention.launches == before
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_attention_launch_config_at_the_training_shape():
    """bf16: the tensor-core design, 4 warps, Q and double-buffered K and V
    tiles of 64 rows of Dh + 8 bf16; f32: FlashAttention-2's structure on
    the CUDA cores, 7 query tiles of 32 rows for each of the 128 (b, n)
    (896 blocks of four warps, 4 query rows a lane), Q and double-buffered
    K and V tiles of 32 rows of Dh + 4 f32 and four warps' [32][12] P tiles
    (49 KB: four blocks an SM)."""
    cfg = cuda_attention.launch_config(128, 200, 1, 64, torch.bfloat16)
    assert cfg == {"design": "mma.sync", "grid": [4, 128], "threads": 128,
                   "head_dim_padded": 64, "unit_bytes": 16, "smem_bytes": 5 * 64 * 72 * 2}
    f32 = cuda_attention.launch_config(128, 200, 1, 64, torch.float32)
    assert f32 == {"design": "flash-fma", "grid": [896], "threads": 128, "query_tile": 32,
                   "key_tile": 32, "head_dim_padded": 64, "unit_bytes": 16,
                   "smem_bytes": (5 * 32 * 68 + 4 * 32 * 12) * 4}
    assert 4 * f32["smem_bytes"] <= 228 * 1024  # an SM's shared memory
    for dtype in (torch.float32, torch.bfloat16):
        wide = cuda_attention.launch_config(2, 10, 1, 256, dtype)
        assert wide["smem_bytes"] <= cuda_attention.SMEM_LIMIT


@pytest.mark.parametrize("B,T,N", [(128, 200, 1), (64, 200, 1), (3, 1, 2), (2, 63, 2),
                                   (2, 64, 1), (2, 65, 3), (1, 257, 2)])
def test_attention_f32_grid_covers_every_query_tile(B, T, N):
    """The f32 kernel's one-dimensional grid, read as the kernel reads it
    (block i takes query tile n_tiles - 1 - i // (B N) of (b, n) = i % (B N)):
    every (32-row query tile, b, n) once, the tiles with the most key tiles
    first, and the tiles' rows cover [0, T) with fewer than 32 past it; its
    shared memory fits a block for every Dh the kernel takes, up to 256."""
    for Dh in range(4, 257, 4):
        smem = cuda_attention.launch_config(B, T, N, Dh, torch.float32)
        assert smem["smem_bytes"] <= cuda_attention.SMEM_LIMIT
    cfg = cuda_attention.launch_config(B, T, N, 64, torch.float32)
    tile = cfg["query_tile"]
    n_tiles = -(-T // tile)
    (grid,) = cfg["grid"]
    assert grid == n_tiles * B * N and cfg["threads"] == 128
    blocks = [(n_tiles - 1 - i // (B * N), i % (B * N)) for i in range(grid)]
    assert sorted(blocks) == [(qi, g) for qi in range(n_tiles) for g in range(B * N)]
    assert all(a[0] >= b[0] for a, b in zip(blocks, blocks[1:]))
    assert 0 <= n_tiles * tile - T < tile


@pytest.mark.parametrize("Dh,kD", [(8, 16), (16, 16), (24, 32), (40, 64), (64, 64),
                                   (72, 128), (136, 256), (256, 256)])
def test_attention_bf16_pads_the_head_dim_to_mma_depth(Dh, kD):
    """mma's depth is 16: every bf16 Dh the kernel took before (a multiple of
    8 up to 256) is padded with zero columns in shared memory to a power of
    two from 16."""
    cfg = cuda_attention.launch_config(3, 65, 2, Dh, torch.bfloat16)
    assert cfg["head_dim_padded"] == cuda_attention.head_dim_padded(Dh) == kD
    assert cfg["grid"] == [2, 6] and cfg["smem_bytes"] == 5 * 64 * (kD + 8) * 2
    assert cfg["smem_bytes"] <= cuda_attention.SMEM_LIMIT


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 8, 1, 64), torch.float64, "dtype"),
    ((2, 8, 1, 264), torch.float32, "Dh <= 256"),
    ((2, 8, 1, 12), torch.bfloat16, None),  # refused by the 16-byte design; 8-byte pieces now
    ((2, 8, 1, 6), torch.float32, None),  # the same; 8-byte pieces, Dh padded to 8
    ((0, 8, 1, 64), torch.float32, "empty"),
])
def test_attention_kernel_rejects_what_it_cannot_take(shape, dtype, match):
    """Other dtypes and empty shapes raise; head dims past 256 take the
    Dh-cluster layout; a head row that is not a 16-byte multiple (Dh = 12 in
    bf16, 6 in f32) launches in 8-byte pieces."""
    if match == "Dh <= 256":  # past the designs' limit: the cluster layout takes it
        cfg = cuda_attention.launch_config(*shape, dtype)
        assert cfg["layout"] == "dh-cluster" and cfg["slices"] == cfg["cluster"] == 2
        assert cfg["grid"] == [2 * 1 * 2 * 1] and cfg["unit_bytes"] == 16
        return
    if match is None:
        cfg = cuda_attention.launch_config(*shape, dtype)
        assert cfg["unit_bytes"] == 8 and cfg["head_dim_padded"] == (16 if shape[3] == 12
                                                                     else 8)
        return
    with pytest.raises(ValueError, match=match):
        cuda_attention.launch_config(*shape, dtype)


def test_layer_norm_matches_flax():
    import flax.linen as fnn

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(3, 5, 16)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    ln = LayerNorm(16)
    ln.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    p = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    for dt, jdt, tol in ((torch.float32, jnp.float32, F32_TOL),
                         (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        want = fnn.LayerNorm(dtype=jdt).apply(p, jnp.asarray(x).astype(jdt))
        with torch.no_grad():
            got = ln(torch.from_numpy(x).to(dt))
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# The tower and the model
# ---------------------------------------------------------------------------

VOCAB, T, D = 30, 12, 16


def test_sasrec_tower_matches_flax():
    """SASRecTower (two blocks, two heads) against the flax module with its
    own initialized parameters, f32, deterministic; pad positions masked."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [5], [0]])).astype(np.float32)
    jt = JaxSASRecTower(hidden=D, num_layers=2, num_heads=2, mlp_dim=32, max_len=20,
                        use_pallas=False)
    params = jax.tree_util.tree_map(
        np.asarray, jt.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(mask)))
    tt = SASRecTower(D, 2, 2, 32, 20)
    tt.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tt(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(
        _np(got), np.asarray(jt.apply(params, jnp.asarray(x), jnp.asarray(mask))), **F32_TOL)
    with pytest.raises(ValueError, match="max_len"):
        tt(torch.zeros(1, 21, D), torch.ones(1, 21))


def _sasrec_cfg(**kw):
    return dict(arch="sasrec", embed_dim=D, num_layers=2, num_heads=1, max_len=T,
                dropout_rate=0.0, compute_dtype="float32", loss="sampled_softmax",
                num_negatives=9, **kw)


def _batch(rng, B=4):
    inputs = np.zeros((B, T), np.int32)
    targets = np.zeros((B, T), np.int32)
    for r, n in enumerate([T, 5, 1, 3][:B]):
        seq = rng.integers(1, VOCAB, size=n + 1)
        inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
    return {"inputs": inputs, "targets": targets, "mask": (targets != 0).astype(np.float32)}


def test_sasrec_model_encode_scores_loss_and_grads_match_jax():
    jm = jax_build_model(JaxModelConfig(**_sasrec_cfg()), VOCAB)
    tm = build_model(ModelConfig(**_sasrec_cfg()), VOCAB, device="cpu")
    batch = _batch(np.random.default_rng(8))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # The JAX model's own initialized tree loads into the port strictly.
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jb["inputs"],
                                                        jb["mask"]))
    tm.load_state_dict(flax_to_state_dict(params))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    with torch.no_grad():
        np.testing.assert_allclose(
            _np(tm.encode(tb["inputs"], tb["mask"])),
            np.asarray(jm.apply(j_params, jb["inputs"], jb["mask"])), **F32_TOL)
        np.testing.assert_allclose(
            _np(tm.scores(tb["inputs"], tb["mask"])),
            np.asarray(jm.apply(j_params, jb["inputs"], jb["mask"], method=jm.scores)),
            **F32_TOL)
    rng = np.random.default_rng(9)
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


def test_sasrec_random_params_nest_without_collisions(tmp_path):
    """Leaves nest by their full path (the blocks' same-named LayerNorms do
    not overwrite each other), with the flax initializers' laws, and the
    tree round-trips through .npz and the JAX model's own tree layout."""
    tm = build_model(ModelConfig(**_sasrec_cfg()), VOCAB, device="cpu")
    params = random_params(tm, seed=4)
    tower = params["params"]["tower"]
    assert sorted(tower) == ["LayerNorm_0", "block0", "block1", "pos_embedding"]
    assert sorted(tower["block0"]) == ["Dense_0", "Dense_1", "LayerNorm_0", "LayerNorm_1",
                                       "proj", "qkv"]
    assert tower["block0"]["qkv"]["kernel"].shape == (D, 3, 1, D)
    assert tower["block1"]["Dense_0"]["kernel"].shape == (D, 4 * D)
    for ln in (tower["LayerNorm_0"], tower["block0"]["LayerNorm_1"],
               tower["block1"]["LayerNorm_0"]):
        np.testing.assert_array_equal(ln["scale"], np.ones(D))
        assert not ln["bias"].any()
    k0, k1 = tower["block0"]["Dense_0"]["kernel"], tower["block1"]["Dense_0"]["kernel"]
    assert not np.array_equal(k0, k1)
    assert np.abs(k0).max() <= 2 * D ** -0.5 / 0.87962566103423978
    assert 0.8 < k0.std() * D ** 0.5 < 1.2  # lecun_normal: variance 1 / fan_in
    assert np.abs(tower["pos_embedding"]).max() < 0.02 * 6
    assert len(flax_to_state_dict(params)) == len(dict(tm.named_parameters()))
    path = str(tmp_path / "p.npz")
    save_npz(path, params)
    tm.load_state_dict(flax_to_state_dict(load_npz(path)))  # strict
    jm = jax_build_model(JaxModelConfig(**_sasrec_cfg()), VOCAB)
    b = _batch(np.random.default_rng(1))
    j_tree = jm.init(jax.random.key(0), jnp.asarray(b["inputs"]), jnp.asarray(b["mask"]))
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, j_tree))
            == jax.tree_util.tree_structure(params))


def test_recommend_cli_on_ml1m_sasrec_matches_jax(tmp_path):
    """`python -m seqrec_tpu_torch recommend` on configs/ml1m_sasrec.json
    (full width, T = 200, f32 compute for the comparison) with `--device
    cpu`, against the JAX package's recommend on the same weights."""
    cfg = RunConfig.load(str(ROOT / "configs/ml1m_sasrec.json")).apply_overrides(
        ["model.compute_dtype=float32"])
    vocab = 400
    model = build_model(cfg.model, vocab, device="cpu")
    params = random_params(model, seed=12)
    weights = tmp_path / "params.npz"
    save_npz(str(weights), params)
    rng = np.random.default_rng(0)
    hist = [{"user": i, "history": rng.integers(1, vocab, size=n).tolist()}
            for i, n in enumerate([3, 0, 9, 1, 250])]
    src = tmp_path / "hist.jsonl"
    src.write_text("".join(json.dumps(h) + "\n" for h in hist))
    cmd = [sys.executable, "-m", "seqrec_tpu_torch", "recommend",
           "--config", str(ROOT / "configs/ml1m_sasrec.json"),
           "--set", "model.compute_dtype=float32", "--weights", str(weights),
           "--input", str(src), "--k", "5", "--batch_size", "2", "--device", "cpu"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = [json.loads(line) for line in r.stdout.splitlines()]
    jm = jax_build_model(JaxModelConfig(**cfg.model.__dict__), vocab)
    want = list(jax_recommend(jm, jax.tree_util.tree_map(jnp.asarray, params), hist, k=5,
                              batch_size=2, max_len=cfg.data.max_len))
    assert [g["user"] for g in got] == [h["user"] for h in hist]
    for g, w, h in zip(got, want, hist):
        assert g["items"] == w["items"]
        np.testing.assert_allclose(g["scores"], w["scores"], **F32_TOL)
        assert len(g["items"]) == 5 and not set(g["items"]) & set(h["history"])
