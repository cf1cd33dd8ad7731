"""The port's mesh and its sharded functions against the JAX package's, on
the CPU: four gloo ranks (`torch_mesh_worker.py`, no JAX) against JAX on the
conftest's fake devices, `make_mesh(M, devices=jax.devices()[:4])`, on the
same numpy inputs. Mirrors tests/sharding/test_mesh.py,
test_sharded_embedding.py, test_sharded_eval.py and test_sparse_sharded.py.

Rank r holds batch rows [r B, (r + 1) B) of the global batch (JAX shards
rows over ('data', 'model') flattened) and table rows [m V/M, (m + 1) V/M),
m = r % M; the test assembles the ranks' outputs and holds them against
JAX's global arrays.

Tolerances, each with its reason:
- the lookups' forward values, `replicated_gather`'s (into bf16), the
  sub-table, the ranks and the top-k ids: bit for bit (exact gathers, sums
  of one value and zeros, integer counts);
- the lookups' gradients: 1e-5 relative to the largest magnitude (JAX's own
  sharded-vs-dense rtol: another order of the duplicate ids' sums);
- the top-k scores: 1e-6 relative (a dot product of 16 terms in another
  order: torch.matmul against XLA's einsum);
- `sharded_row_update`: sgd, adam and adagrad's accumulator bit for bit;
  adagrad's table to 1 ulp (XLA:CPU's rsqrt, as test_torch_sparse.py
  states), 1e-6 relative;
- `sharded_full_softmax_loss` (each rank's loss sum, and the gradients of
  h, the table and the bias) against `ops/xla.py::full_softmax_loss` on the
  whole table and the global batch: 1e-6 relative to the largest magnitude
  (the logsumexp combined over shards, then the same f32 formulas); the
  weight sums bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.eval.sharded import sharded_ranks as jax_ranks
from seqrec_tpu.eval.sharded import sharded_topk as jax_topk
from seqrec_tpu.ops.xla import full_softmax_loss as jax_full_softmax_loss
from seqrec_tpu.parallel.embedding import padded_vocab as jax_padded_vocab
from seqrec_tpu.parallel.embedding import sharded_gather as jax_gather
from seqrec_tpu.runtime import make_mesh as jax_make_mesh
from seqrec_tpu.train import sparse_embed as jax_sparse
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.parallel.embedding import padded_vocab, unique_inverse
from seqrec_tpu_torch.runtime import make_mesh
from seqrec_tpu_torch.runtime.mesh import init_distributed
from seqrec_tpu_torch.train import sparse_embed
from torch_mesh_worker import spawn

WORLD = 4
MESHES = (2, 4, 1)  # model_axis over the 4 ranks: (2, 2), (1, 4), (4, 1)
OPTIMIZERS = ("sgd", "adagrad", "adam")
D, H, NV = 8, 16, 100  # table width, query width, true vocab


def _inputs(M: int, rng: np.random.Generator) -> dict:
    V = padded_vocab(NV, M)
    ids = rng.integers(0, NV, size=(16, 6)).astype(np.int32)
    ids[0] = ids[1]  # duplicate rows: their gradients add
    uids = np.asarray(jax_sparse.collect_unique(jnp.asarray(ids.reshape(-1)), 80))
    io = {
        "table": rng.normal(size=(V, D)).astype(np.float32), "ids": ids,
        "cot": rng.normal(size=(16, 6, D)).astype(np.float32),
        "neg": rng.integers(1, NV, size=20).astype(np.int32),
        "neg_cot": rng.normal(size=(WORLD, 20, D)).astype(np.float32),
        "h": rng.normal(size=(8, H)).astype(np.float32),
        "targets": rng.integers(1, NV, size=8).astype(np.int32),
        "exclude": rng.integers(0, NV, size=(8, 5)).astype(np.int32),
        "out_table": rng.normal(size=(V, H)).astype(np.float32),
        "bias": rng.normal(size=V).astype(np.float32),
        "num_valid": np.array(NV),
        "uids": uids, "sparse_table": rng.normal(size=(V, D)).astype(np.float32),
        "g_rows": rng.normal(size=(uids.shape[0], D)).astype(np.float32),
    }
    # The full softmax's inputs, from a stream of their own (the draws
    # above stay as they were): 6 rows a rank, some weights 0, each rank
    # its own cotangent on its loss sum.
    srng = np.random.default_rng(100 + M)
    io.update({
        "sm_h": srng.normal(size=(WORLD * 6, H)).astype(np.float32),
        "sm_table": srng.normal(size=(V, H)).astype(np.float32),
        "sm_bias": srng.normal(size=V).astype(np.float32),
        "sm_targets": srng.integers(1, NV, size=WORLD * 6).astype(np.int32),
        "sm_weights": (srng.random(WORLD * 6) < 0.8).astype(np.float32),
        "sm_g": srng.uniform(0.5, 2.0, size=WORLD).astype(np.float32),
    })
    io["exclude"][:, 0] = io["targets"]  # the target itself is never excluded
    io["exclude"][:, 1] = io["exclude"][:, 2]  # a repeated id counts once
    for opt in OPTIMIZERS:
        state = jax_sparse.init_row_opt(opt, jnp.asarray(io["sparse_table"]))
        for k, v in state.items():
            io[f"{opt}/{k}"] = (np.asarray(v) + np.abs(rng.normal(size=v.shape)) * 0.01
                                ).astype(np.float32)
    return io


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' outputs and the inputs, by mesh."""
    d = tmp_path_factory.mktemp("mesh_functions")
    rng = np.random.default_rng(0)
    inputs = {M: _inputs(M, rng) for M in MESHES}
    np.savez(d / "inputs.npz", **{f"M{M}/{k}": v for M in MESHES for k, v in inputs[M].items()})
    outs = spawn("functions", WORLD, d)
    return inputs, outs


def _jmesh(M):
    return jax_make_mesh(M, devices=jax.devices()[:WORLD])


def _jit(fn, *args):
    """fn(*args) as one compiled program (JAX's eager op-by-op dispatch
    compiles every small op apart: many times slower here)."""
    return jax.jit(fn)(*args)


def _by_rank(outs, key):
    return np.concatenate([o[key] for o in outs])


def _assembled(outs, key, M):
    """A row-sharded result: the shards of the ranks of data index 0, in
    model order; every data replica must hold the same bits."""
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[key], outs[r % M][key], err_msg=f"{key} rank {r}")
    return np.concatenate([outs[m][key] for m in range(M)])


def _close(got, want, rel, what):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want).max()
    assert got.shape == want.shape and err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("M", MESHES)
def test_make_mesh_lays_ranks_out_as_jax_reshapes_devices(run, M):
    _, outs = run
    want = np.asarray([d.id for d in _jmesh(M).devices.flat]).reshape(WORLD // M, M)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[f"M{M}/shape"], want.shape)
        np.testing.assert_array_equal(o[f"M{M}/coords"], np.argwhere(want == r)[0])


def test_make_mesh_errors_are_jaxs():
    for got, want in ((lambda: make_mesh(3), lambda: jax_make_mesh(3)),
                      (lambda: make_mesh(0), lambda: jax_make_mesh(0)),
                      (lambda: make_mesh(1, 2), lambda: jax_make_mesh(1, 2, jax.devices()[:1]))):
        with pytest.raises(ValueError) as w:
            want()
        with pytest.raises(ValueError) as g:
            got()
        # The device count differs (one process here, 8 fake devices there).
        assert str(g.value).split(" device")[0].split(" does not")[0] \
            == str(w.value).split(" device")[0].split(" does not")[0]
    m = make_mesh(1)
    assert m.shape == {"data": 1, "model": 1} and not m.distributed
    t = torch.arange(6.0).reshape(3, 2)
    assert m.psum(t) is t and m.all_gather(t) is t and m.psum_scatter(t) is t
    with pytest.raises(ValueError, match="coordinator, num_processes and process_id"):
        init_distributed("localhost:1", 2, device="cpu")


@pytest.mark.parametrize("vocab,shards,multiple", [(100, 4, 8), (96, 4, 8), (1, 8, 8),
                                                   (10_000_001, 2, 8), (3418, 2, 8), (7, 1, 8)])
def test_padded_vocab_equals_jax(vocab, shards, multiple):
    assert padded_vocab(vocab, shards, multiple) == jax_padded_vocab(vocab, shards, multiple)


@pytest.mark.parametrize("n,vocab", [(96, 100), (40, 5), (1, 3)])
def test_unique_inverse_is_jnp_unique_with_size_and_inverse(n, vocab):
    ids = np.random.default_rng(n).integers(0, vocab, size=n).astype(np.int32)
    want_u, want_inv = jnp.unique(jnp.asarray(ids), size=n, fill_value=0, return_inverse=True)
    got_u, got_inv = unique_inverse(torch.from_numpy(ids))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv).reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_plain_versions_are_jaxs_where_formulation(dtype):
    """The plain window gather is `jnp.where(owned, shard[clip(id - row0)],
    0)` (then the cast), bit for bit; its transpose adds owned rows only."""
    rng = np.random.default_rng(1)
    shard = rng.normal(size=(12, 8)).astype(np.float32)
    ids = rng.integers(-3, 40, size=(5, 7)).astype(np.int32)
    row0 = 12
    local = jnp.asarray(ids) - row0
    owned = (local >= 0) & (local < 12)
    want = jnp.where(owned[..., None], jnp.asarray(shard)[jnp.clip(local, 0, 11)], 0)
    got = reference.embedding_gather_window(torch.from_numpy(shard), torch.from_numpy(ids),
                                            row0, dtype=dtype)
    want = want.astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    g = rng.normal(size=(5, 7, 8)).astype(np.float32)
    want_g = np.zeros((12, 8), np.float32)
    np.add.at(want_g, np.asarray(local)[np.asarray(owned)], g[np.asarray(owned)])
    got_g = reference.embedding_scatter_add_window(torch.from_numpy(g), torch.from_numpy(ids),
                                                   row0, 12)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M", MESHES)
def test_sharded_gather_forward_and_gradient_equal_jax(run, M):
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    jmesh = _jmesh(M)
    table, ids, cot = (jnp.asarray(io[k]) for k in ("table", "ids", "cot"))
    for dedup in (True, False):
        want = np.asarray(_jit(lambda t: jax_gather(t, ids, jmesh, dedup=dedup), table))
        np.testing.assert_array_equal(_by_rank(outs, p + f"gather_dedup{int(dedup)}"), want)
        grad = np.asarray(_jit(jax.grad(
            lambda t: jnp.vdot(jax_gather(t, ids, jmesh, dedup=dedup), cot)), table))
        _close(_assembled(outs, p + f"grad_dedup{int(dedup)}", M), grad, 1e-5,
               f"M={M} dedup={dedup} grad")


@pytest.mark.parametrize("M", MESHES)
def test_replicated_gather_and_its_gradient(run, M):
    """The shared negatives' lookup: JAX's plain take on the sharded table
    then the bf16 cast; its gradient, the ranks' bf16 cotangents summed."""
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    table, neg = jnp.asarray(io["table"]), jnp.asarray(io["neg"])
    want = np.asarray(jnp.take(table, neg, axis=0).astype(jnp.bfloat16).astype(jnp.float32))
    for o in outs:
        np.testing.assert_array_equal(o[p + "replicated"], want)
    grad = np.asarray(_jit(jax.grad(lambda t: sum(
        jnp.vdot(jnp.take(t, neg, axis=0).astype(jnp.bfloat16).astype(jnp.float32),
                 jnp.asarray(c)) for c in io["neg_cot"])), table))
    _close(_assembled(outs, p + "replicated_grad", M), grad, 1e-5, f"M={M} replicated grad")


@pytest.mark.parametrize("M", MESHES)
@pytest.mark.parametrize("case", ["bias", "nobias", "exclude"])
def test_sharded_ranks_equal_jax(run, M, case):
    """With the bias and without, and with exclude_history; the pad column
    and the padded vocab's rows never count."""
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    want = _jit(lambda t, h, tg, b, ex: jax_ranks(t, h, tg, _jmesh(M), bias=b, num_valid=NV,
                                                  exclude=ex),
                jnp.asarray(io["out_table"]), jnp.asarray(io["h"]), jnp.asarray(io["targets"]),
                None if case == "nobias" else jnp.asarray(io["bias"]),
                jnp.asarray(io["exclude"]) if case == "exclude" else None)
    np.testing.assert_array_equal(_by_rank(outs, p + f"ranks_{case}"), np.asarray(want))


@pytest.mark.parametrize("M", MESHES)
@pytest.mark.parametrize("case", ["bias", "nobias"])
def test_sharded_topk_equals_jax(run, M, case):
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    vals, ids = _jit(lambda t, h, b: jax_topk(t, h, 7, _jmesh(M), bias=b, num_valid=NV),
                     jnp.asarray(io["out_table"]), jnp.asarray(io["h"]),
                     None if case == "nobias" else jnp.asarray(io["bias"]))
    np.testing.assert_array_equal(_by_rank(outs, p + f"topk_ids_{case}"), np.asarray(ids))
    _close(_by_rank(outs, p + f"topk_vals_{case}"), np.asarray(vals), 1e-6, "top-k scores")
    assert (np.asarray(ids) < NV).all() and (np.asarray(ids) != 0).all()


@pytest.mark.parametrize("M", MESHES)
def test_sharded_sub_table_equals_jax(run, M):
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    want = np.asarray(_jit(lambda t, u: jax_sparse.sharded_sub_table(t, u, _jmesh(M)),
                           jnp.asarray(io["sparse_table"]), jnp.asarray(io["uids"])))
    for o in outs:
        np.testing.assert_array_equal(o[p + "sub_table"], want)


@pytest.mark.parametrize("M", MESHES)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_sharded_row_update_equals_jax(run, M, optimizer):
    """Each shard updates the rows it owns; other shards' ids (clipped into
    the window) and the fill duplicates change nothing."""
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    row_opt = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in io.items()
               if k.startswith(optimizer + "/")}
    # Eager, as JAX's own sharded tests run it: under one jit, XLA fuses
    # adam's and adagrad's elementwise chains into other roundings.
    table, new_opt = jax_sparse.sharded_row_update(
        optimizer, jnp.float32(0.05), jnp.asarray(io["sparse_table"]), row_opt,
        jnp.asarray(io["uids"]), jnp.asarray(io["g_rows"]), jnp.int32(6), _jmesh(M))
    got = _assembled(outs, p + f"row_update_{optimizer}/table", M)
    if optimizer == "adagrad":
        _close(got, np.asarray(table), 1e-6, "adagrad table")
    else:
        np.testing.assert_array_equal(got, np.asarray(table))
    for k, v in new_opt.items():
        np.testing.assert_array_equal(_assembled(outs, p + f"row_update_{optimizer}/{k}", M),
                                      np.asarray(v), err_msg=k)


@pytest.mark.parametrize("M", MESHES)
def test_sharded_full_softmax_equals_jax_on_the_whole_table(run, M):
    """Each rank's loss over its own rows, and the gradients of Σ_r g_r ×
    rank r's loss sum (a row's weight times its owner's g), against JAX's
    full softmax on the whole padded table and the global batch, the
    padded rows masked (num_valid)."""
    inputs, outs = run
    io, p = inputs[M], f"M{M}/"
    h, table, bias = (jnp.asarray(io[k]) for k in ("sm_h", "sm_table", "sm_bias"))
    targets, w = jnp.asarray(io["sm_targets"]), io["sm_weights"]
    n = h.shape[0] // WORLD
    w_g = jnp.asarray(w * np.repeat(io["sm_g"], n))

    def loss(h_, t_, b_, weights):
        return jax_full_softmax_loss(h_, t_, targets, weights, bias=b_, num_valid=NV)[0]

    d_h, d_t, d_b = _jit(jax.grad(lambda a, b, c: loss(a, b, c, w_g), argnums=(0, 1, 2)),
                         h, table, bias)
    rows = [slice(r * n, (r + 1) * n) for r in range(WORLD)]
    want = np.array([float(jax_full_softmax_loss(h[s], table, targets[s], jnp.asarray(w[s]),
                                                 bias=bias, num_valid=NV)[0]) for s in rows])
    _close(_by_rank(outs, p + "sm_loss"), want, 1e-6, f"M={M} loss sums")
    np.testing.assert_array_equal(_by_rank(outs, p + "sm_w"),
                                  [w[s].sum(dtype=np.float32) for s in rows])
    _close(_by_rank(outs, p + "sm_d_h"), np.asarray(d_h), 1e-6, f"M={M} d_h")
    _close(_assembled(outs, p + "sm_d_table", M), np.asarray(d_t), 1e-6, f"M={M} d_table")
    _close(_assembled(outs, p + "sm_d_bias", M), np.asarray(d_b), 1e-6, f"M={M} d_bias")
    assert np.abs(np.asarray(d_t)[NV:]).max() == 0.0  # the padded rows take nothing


def test_row_update_indices_and_extra_valid_equal_jax():
    """row_update's shard arguments on one process: local indices and a
    mask, as JAX's."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(10, 4)).astype(np.float32)
    uids = np.array([0, 0, 3, 7, 12, 15, 19], np.int32)
    g = rng.normal(size=(7, 4)).astype(np.float32)
    local = uids - 10
    owned = (local >= 0) & (local < 10)
    idx = np.clip(local, 0, 9)
    for opt in OPTIMIZERS:
        state = {k: np.asarray(v) + 0.01 for k, v in
                 jax_sparse.init_row_opt(opt, jnp.asarray(table)).items()}
        want_t, want_o = jax_sparse.row_update(
            opt, jnp.float32(0.1), jnp.asarray(table), {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(uids), jnp.asarray(g), jnp.int32(2), indices=jnp.asarray(idx),
            extra_valid=jnp.asarray(owned))
        t = torch.from_numpy(table.copy())
        o = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
        sparse_embed.row_update(opt, 0.1, t, o, torch.from_numpy(uids), torch.from_numpy(g), 2,
                                indices=torch.from_numpy(idx), extra_valid=torch.from_numpy(owned))
        _close(t.numpy(), np.asarray(want_t), 1e-6, f"{opt} table")
        for k in o:
            np.testing.assert_array_equal(o[k].numpy(), np.asarray(want_o[k]), err_msg=k)
        # Rows 0..2 of the shard belong to ids 10..12: only id 12 (row 2) moved.
        moved = np.flatnonzero(np.abs(t.numpy() - table).sum(1) > 0)
        np.testing.assert_array_equal(moved, [2, 5, 9])


@pytest.mark.parametrize("row0,rows,ok", [(0, 8, True), (2 ** 31 - 1, 1, True), (-1, 8, False),
                                          (2 ** 31, 8, False), (5, 0, False)])
def test_window_limits_are_stated_and_checked(row0, rows, ok):
    from seqrec_tpu_torch.ops.cuda import gather as k_gather

    if ok:
        k_gather.check_window(row0, rows)
    else:
        with pytest.raises(ValueError, match="shard window"):
            k_gather.check_window(row0, rows)
    # On the CPU the wrappers are the plain versions.
    shard = torch.randn(6, 4)
    ids = torch.tensor([[-1, 6, 7, 11, 12, 3]])
    np.testing.assert_array_equal(
        k_gather.embedding_gather_window(shard, ids, 6).numpy(),
        reference.embedding_gather_window(shard, ids, 6).numpy())


class _StubMesh:
    """A (1, 2) mesh seen from rank `r`, for the in-process model tests
    (the model reads only its shape and this rank's model index)."""

    def __init__(self, r):
        self.shape, self.rank, self.size, self.distributed = {"data": 1, "model": 2}, r, 2, True

    def axis_index(self, axis):
        return self.rank


@pytest.mark.parametrize("block_rows", [7, 1 << 19])
def test_a_shard_draws_the_whole_stream_and_keeps_its_rows(block_rows):
    """`init_state_dict` of a rank's shard is that rank's rows of the whole
    draw (`random_params`, which the JAX tree's layout follows), bit for
    bit, and the tower after the tables is the same on both ranks; the
    model holds [rows / 2, D] and `shard_state_dict` cuts the same rows."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.models import build_model
    from seqrec_tpu_torch.models.convert import (flax_to_state_dict, init_state_dict,
                                                 random_params, shard_state_dict)

    cfg = RunConfig().apply_overrides(["model.embed_dim=8", "model.loss=sampled_softmax",
                                       "model.use_user_embedding=true",
                                       "mesh.shard_embeddings=true", "mesh.model_axis=2"])
    towers = []
    for r in (0, 1):
        model = build_model(cfg.model, 45, num_users=9, device="cpu", mesh=_StubMesh(r),
                            mesh_cfg=cfg.mesh)
        assert model.sharded and model.table_size == 48 == padded_vocab(45, 2)
        assert tuple(model.item_embedding.shape) == (24, 8)
        assert tuple(model.user_embedding.shape) == (8, 8)  # padded_vocab(10, 2) = 16 rows
        whole = flax_to_state_dict(random_params(model, 3))
        assert tuple(whole["item_embedding"].shape) == (48, 8)
        got = init_state_dict(model, 3, "cpu", block_rows=block_rows)
        want = shard_state_dict(whole, model)
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
        np.testing.assert_array_equal(got["item_embedding"].numpy(),
                                      whole["item_embedding"][24 * r:24 * (r + 1)].numpy())
        towers.append({k: v for k, v in got.items() if k.startswith("tower")})
    for k in towers[0]:
        assert torch.equal(towers[0][k], towers[1][k]), k


def test_a_full_softmax_shard_draws_the_whole_stream_and_keeps_its_bias_rows():
    """A full-softmax model's output bias is cut like its table: the
    shard's rows of the whole draw, bit for bit, on each rank; the two
    ranks' shards side by side are the whole tree's bias."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.models import build_model
    from seqrec_tpu_torch.models.convert import (flax_to_state_dict, init_state_dict,
                                                 random_params, shard_state_dict)

    cfg = RunConfig().apply_overrides(["model.embed_dim=8", "model.loss=full_softmax",
                                       "mesh.shard_embeddings=true", "mesh.model_axis=2"])
    biases = []
    for r in (0, 1):
        model = build_model(cfg.model, 45, device="cpu", mesh=_StubMesh(r), mesh_cfg=cfg.mesh)
        whole = flax_to_state_dict(random_params(model, 5))
        assert tuple(whole["output_bias"].shape) == (48,)
        got = init_state_dict(model, 5, "cpu", block_rows=7)
        want = shard_state_dict(whole, model)
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
        model.load_state_dict(got)  # the shapes the model holds
        biases.append(got["output_bias"])
    assert torch.equal(torch.cat(biases), whole["output_bias"])


def test_a_sharded_model_refuses_what_is_not_ported():
    """The full softmax over a row-sharded table builds (the JAX package's
    default loss), its output bias held as the same rows' shard and
    counted among the sharded leaves; scores over the whole catalog of a
    sharded model still refuse, naming the sharded rankers."""
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.models import build_model

    cfg = RunConfig().apply_overrides(["model.embed_dim=8", "model.loss=full_softmax",
                                       "mesh.shard_embeddings=true", "mesh.model_axis=2"])
    for r in (0, 1):
        model = build_model(cfg.model, 45, device="cpu", mesh=_StubMesh(r), mesh_cfg=cfg.mesh)
        assert model.sharded and model.table_size == 48
        assert tuple(model.output_bias.shape) == (24,)
        assert model.sharded_rows == {"item_embedding": 48, "output_bias": 48}
        assert model.table_window("output_bias") == (24 * r, 48)
    for loss in ("full_softmax", "sampled_softmax"):
        model = build_model(cfg.apply_overrides([f"model.loss={loss}"]).model, 45, device="cpu",
                            mesh=_StubMesh(0), mesh_cfg=cfg.mesh)
        with pytest.raises(ValueError, match="sharded_ranks / sharded_topk"):
            model.scores(torch.ones(2, 3, dtype=torch.int32), torch.ones(2, 3))
