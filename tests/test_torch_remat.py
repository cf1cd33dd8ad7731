"""SASRec block rematerialization (`model.remat`) in the port, on the CPU.

- Against the JAX package's `remat=True` model (`nn.remat(SASRecBlock)`) on
  the same weights, in the setting of tests/models/test_remat.py (the full
  softmax, f32, dropout 0): the loss within rtol 1e-6 and every gradient
  within rtol 1e-5 (atol 1e-7), that test's tolerances.
- The port's remat on against off: the tower's output, every gradient and
  the dropout generator's state after the backward pass bit for bit, with
  dropout 0.2 (the replay draws the masks the forward drew, then hands the
  generator back); each block really runs twice (forward and replay); and a
  K=4 group of `Trainer.train_step_multi` (dropout 0.2, the steps' own
  generators) bit for bit in f32 and bf16: every parameter, optimizer leaf
  and metric.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.config import ModelConfig as JaxModelConfig
from seqrec_tpu.models import build_model as jax_build_model
from seqrec_tpu_torch.config import ModelConfig, RunConfig
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict
from seqrec_tpu_torch.models.towers import SASRecTower
from seqrec_tpu_torch.train.trainer import Trainer

VOCAB = 40
ROOT = Path(__file__).resolve().parents[1]


def _cfg(remat: bool, **kw) -> dict:
    return dict(arch="sasrec", embed_dim=32, num_layers=2, max_len=16, dropout_rate=0.0,
                compute_dtype="float32", use_pallas=False, remat=remat, **kw)


def test_remat_equals_jax_remat_on_the_same_weights():
    rng = np.random.default_rng(0)
    inputs = rng.integers(1, VOCAB, size=(4, 12)).astype(np.int32)
    batch = {"inputs": inputs, "targets": rng.integers(1, VOCAB, size=(4, 12)).astype(np.int32),
             "mask": np.ones((4, 12), np.float32)}
    jm = jax_build_model(JaxModelConfig(**_cfg(True)), VOCAB)
    params = jm.init(jax.random.key(0), jnp.asarray(inputs), jnp.asarray(batch["mask"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        s, w = jm.apply(p, jb, method=jm.loss, deterministic=True)
        return s / w

    j_loss, j_grads = jax.value_and_grad(jloss)(params)
    j_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))

    tm = build_model(ModelConfig(**_cfg(True)), VOCAB, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    s, w = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()}, deterministic=True)
    loss = s / w
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(j_grads)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def _tower(remat: bool, seed: int = 3) -> SASRecTower:
    torch.manual_seed(seed)
    t = SASRecTower(16, 2, 2, 32, 10, dropout_rate=0.2, use_pallas=False, remat=remat)
    with torch.no_grad():
        for p in t.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    return t


def test_remat_replays_the_forwards_masks_and_hands_the_generator_back():
    x = torch.randn(3, 10, 16)
    mask = (torch.arange(10)[None, :] < torch.tensor([[10], [6], [1]])).float()
    runs = {}
    for remat in (False, True):
        tower = _tower(remat)
        calls = []
        for i in range(2):
            block = getattr(tower, f"block{i}")
            block.register_forward_pre_hook(lambda *_, i=i: calls.append(i))
        gen = torch.Generator().manual_seed(11)
        xin = x.clone().requires_grad_(True)
        out = tower(xin, mask, deterministic=False, generator=gen)
        (out * torch.linspace(-1, 1, 16)).sum().backward()
        after = torch.rand(4, generator=gen)  # the next draws, past the step
        runs[remat] = (out.detach(), xin.grad, {n: p.grad for n, p in tower.named_parameters()},
                       after, calls)
    (o0, g0, p0, a0, c0), (o1, g1, p1, a1, c1) = runs[False], runs[True]
    assert torch.equal(o0, o1) and torch.equal(g0, g1) and torch.equal(a0, a1)
    assert sorted(p0) == sorted(p1)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    assert c0 == [0, 1] and sorted(c1) == [0, 0, 1, 1]  # each block replayed once


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_group_equals_the_group_without_remat(dtype):
    class DS:
        vocab_size, num_users = 50, 0

    rng = np.random.default_rng(1)
    seqs = rng.integers(1, 50, size=(4, 6, 13))
    lens = rng.integers(2, 13, size=(4, 6))
    out = {}
    for remat in (False, True):
        cfg = RunConfig.load(str(ROOT / "configs/ml1m_sasrec.json")).apply_overrides(
            ["model.embed_dim=16", "model.num_negatives=20", "data.max_len=12",
             "model.max_len=12", f"model.compute_dtype={dtype}", "train.warmup_steps=0",
             "model.use_pallas=false", f"model.remat={str(remat).lower()}"])
        assert cfg.model.dropout_rate == 0.2
        tr = Trainer(cfg, DS(), device="cpu")
        wires = []
        for s, n in zip(seqs, lens):
            keep = np.arange(12)[None, :] < n[:, None]
            wires.append(tr.pack_train_batch({
                "inputs": s[:, :-1] * keep, "targets": s[:, 1:] * keep,
                "mask": keep.astype(np.float32)}))
        out[remat] = tr.train_step_multi(tr.init_state(0), np.stack(wires))
    (a, ma), (b, mb) = out[False], out[True]
    assert a.step == b.step == 4
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for part in ("mu", "nu"):
        for k in a.opt_state[part]:
            assert torch.equal(a.opt_state[part][k], b.opt_state[part][k]), (part, k)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
