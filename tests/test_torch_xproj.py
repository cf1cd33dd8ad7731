"""The bf16 input projection (csrc/rnn.cuh xproj_wgmma_kernel), on the CPU:
what `gru.xproj_config` plans (the C side's xproj_plan computes the same and
the entry points refuse a caller whose plan differs), and the plain version
(`gru.plain_input_projection`, what the wrappers run on a CPU tensor)
against the JAX package's `jnp.dot(x, w_x, preferred_element_type=f32) + b`
(seqrec_tpu/ops/pallas/gru.py:110-113) at the widths the models take. The
kernel itself is held against its plain version and torch.addmm in f32 on
the card (tests/test_torch_kernels.py, `-k input_projection_matches_addmm`).

Tolerance: 1e-5 of the largest value (the same exact bf16 products summed in
f32 in another order, up to 2,304 of them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm

ROWS = (1, 3, 12_800, 25_600, 51_200)
WIDTHS = (52, 64, 100, 128, 512, 1000, 2304)


def _check_plan(M, D, N, sms):
    cfg = cuda_gru.xproj_config(M, D, N, sms=sms)
    bm, bn, bk = cfg["block"]
    assert (cfg["design"], cfg["layout"], bk, cfg["threads"]) == ("wgmma", "persistent", 64, 384)
    assert (bm, bn) in cuda_gru.XPROJ_TILES and bm * bn // 256 <= 128  # accumulators a thread
    assert cfg["warpgroups"] == {"producer": 1, "consumers": 2}
    m_tiles, n_tiles = -(-M // bm), -(-N // bn)
    assert cfg["tiles"] == m_tiles * n_tiles
    ctas = 2 if (bm, bn) == (128, 64) else 1  # CTAs a SM
    assert cfg["ctas_per_sm"] == ctas
    assert cfg["grid"] == min(cfg["tiles"], ctas * sms) <= ctas * sms

    def most_a_cta(tm, tn):  # a CTA's most tiles times their area
        return -(-(-(-M // tm) * -(-N // tn)) // sms) * tm * tn

    if -(-D // bk) <= 2:  # K at most two chunks: the small tiles, two CTAs a SM
        assert (bm, bn) == (128, 64)
    else:
        costs = {t: most_a_cta(*t) for t in ((256, 128), (128, 256), (128, 128))}
        large = (256, 128) if costs[(256, 128)] <= costs[(128, 256)] else (128, 256)
        large_tiles = -(-M // large[0]) * -(-N // large[1])
        if 10 * costs[(128, 128)] < 9 * costs[large] or (
                costs[(128, 128)] <= costs[large] and large_tiles < 2 * sms):
            assert (bm, bn) == (128, 128)
        else:
            assert (bm, bn) == large
    stage = (bm + bn) * bk * 2
    limit = cuda_gru.SMEM_LIMIT if ctas == 1 else cuda_gru.SM_SMEM // 2 - 1024  # a CTA's share
    most = min(cuda_gru.XPROJ_MAX_STAGES, (limit - 1024) // stage)
    assert cfg["stages"] == min(most, 4 if -(-D // bk) > 8 else 3) >= 3
    assert cfg["smem_bytes"] == cfg["stages"] * stage + 1024 <= cuda_gru.SMEM_LIMIT == 232_448
    assert ctas * (cfg["smem_bytes"] + 1024) <= cuda_gru.SM_SMEM == 233_472  # the SM holds them
    strides = (D * 2, N * 2)  # bytes a row of x and of W_x
    assert cfg["tma"] == all(s % 16 == 0 for s in strides)
    assert (cfg["route"], cfg["unit_bytes"]) == (("tma", 16) if cfg["tma"] else ("cp.async", 8))
    bands = -(-n_tiles // cfg["band"])
    assert 2 * D * cfg["band"] * bn <= cuda_gru.XPROJ_L2_BUDGET or cfg["band"] == 1
    if 2 * D * n_tiles * bn <= cuda_gru.XPROJ_L2_BUDGET:
        assert cfg["band"] == n_tiles and bands == 1
    regs = cfg["registers"]
    if ctas == 1:  # setmaxnreg's counts
        assert 128 * regs["producer"] + 256 * regs["consumer"] == 384 * 168  # the launch holds
        assert regs["consumer"] >= bm * bn // 256 + 64  # the accumulators and room beside them
    else:  # no setmaxnreg: the launch's share of the SM's 65,536 a thread
        assert regs == {"producer": 80, "consumer": 80} and 2 * 384 * 80 <= 65_536
        assert regs["consumer"] >= bm * bn // 256 + 48
    return cfg


@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("M", ROWS)
def test_xproj_config_fits_the_card(M, D, G):
    """At every row count and width the models give it (N = 3H for the GRU,
    4H for the LSTM, H = D): at most one CTA a SM (two of 128 x 64 tiles
    where K is at most two chunks deep), shared memory within the 227 KB a
    CTA may have and the SM's share, at least 3 ring stages (4 where K is more than 8
    chunks deep), TMA exactly where every row stride is a 16-byte multiple
    (else cp.async's 8-byte pieces), the tile by the rule, each band's W_x
    within the L2 budget, and the registers setmaxnreg hands out within
    what the launch holds. Planned, as by default, for the card present
    (NUM_SMS without one)."""
    N = G * D
    cfg = _check_plan(M, D, N, cuda_gru.card_sms())
    assert cfg == cuda_gru.xproj_config(M, D, N)
    assert cuda_gru.xproj_plan_args(M, D, N) == (
        *cfg["block"][:2], cfg["stages"], int(cfg["tma"]), cfg["grid"], cfg["band"],
        cfg["smem_bytes"])


@pytest.mark.parametrize("sms", [114, 66])
@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("D", [52, 128, 2304])
@pytest.mark.parametrize("M", [12_800, 51_200])
def test_xproj_config_plans_for_other_sm_counts(M, D, G, sms):
    """A card with other SMs than the H100 SXM's 132 (the PCIe card's 114,
    half a card's 66) gets the same rule at its count, as rnn.cuh's
    xproj_plan computes it from the device: the grid at most its SMs (twice
    them for 128 x 64 tiles), the route, stages and bands as at 132 for the
    same tile."""
    N = G * D
    cfg = _check_plan(M, D, N, sms)
    full = _check_plan(M, D, N, cuda_gru.NUM_SMS)
    assert cfg["route"] == full["route"]
    if cfg["block"] == full["block"]:
        assert (cfg["stages"], cfg["band"], cfg["smem_bytes"]) == (
            full["stages"], full["band"], full["smem_bytes"])


@pytest.mark.parametrize("M,D,N", [(0, 64, 64), (4, 66, 64), (4, 64, 66), (4, 0, 8)])
def test_xproj_config_refuses_what_the_kernel_cannot_take(M, D, N):
    """An empty shape, or D or N not a multiple of 4, reaches no kernel: the
    config raises (the C side returns cudaErrorInvalidValue); the wrappers
    zero-pad D and N to multiples of 4 before it."""
    with pytest.raises(ValueError, match="input projection"):
        cuda_gru.xproj_config(M, D, N)


def _operands(M, D, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=D ** -0.5, size=(M, D)).astype(np.float32)
    w = rng.normal(scale=D ** -0.5, size=(D, N)).astype(np.float32)
    b = rng.normal(scale=0.1, size=N).astype(np.float32)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    return xb, wb, torch.from_numpy(b)


@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("D", WIDTHS)
def test_plain_projection_matches_jax(D, G):
    """The plain version (the wrappers' on a CPU tensor: bf16 products in
    f32, then b) against the JAX package's projection, jnp.dot of the bf16
    x and W_x with preferred_element_type=f32, then b_x, on the same values;
    through the GRU's wrapper (G = 3) and the LSTM's (G = 4), whose launch
    counters a CPU tensor leaves alone."""
    M, N = 37, G * D
    x, w, b = _operands(M, D, N, seed=D * G)
    want = np.asarray(jnp.dot(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jnp.asarray(w.float().numpy(), jnp.bfloat16),
                              preferred_element_type=jnp.float32)) + b.numpy()
    project = cuda_gru.gru_input_projection if G == 3 else cuda_lstm.lstm_input_projection
    before = project.launches
    got = project(x, w, b)
    assert project.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert torch.equal(got, cuda_gru.plain_input_projection(x, w, b))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
