"""The stepped layouts' bf16 step GEMM (csrc/step_gemm.cuh), on the CPU:
what `gru.step_gemm_config` chooses (the C side's step_gemm_plan checks the
same), and the K-split partial planes that the gate kernels sum in split
order, through the plain version of the GEMM (`gru.plain_step_gemm`, what
`gru.step_gemm` runs on a CPU tensor) and the gate math, against the JAX
package's gates (`seqrec_tpu/ops/xla.py`) on the exact product rounded
once to f32. The kernel itself is held against torch.matmul and
its plain version on the card (tests/test_torch_kernels.py, `-k step_gemm`).

Tolerances: the forward's product 1e-5 relative to its largest value (the
same exact bf16 products summed in f32 in another order), its gates 1e-5;
the reverse's 1e-4 relative to its largest value (the f32 cotangent split
into two bf16 terms keeps ~2^-17 of it, as every reverse recurrence's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu.ops import xla as xla_ops
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import gru as cuda_gru

BATCHES = (1, 3, 16, 64, 256, 300, 512)
# Each dtype's grid limit + 4 (the GRU's three gates, the LSTM's four), 2,304
# (the wide demo at embed_dim=2,304) and 4,096.
WIDTHS = ("bf16_limit", "f32_limit", 2304, 4096)


def _width(width, G: int) -> int:
    if isinstance(width, int):
        return width
    dtype = torch.bfloat16 if width == "bf16_limit" else torch.float32
    return cuda_gru.grid_max_hidden(dtype, G) + 4


def _dims(G: int, H: int, reverse: bool):
    """(K, N, terms) of a step's GEMM: forward h [B, H] @ W_h [H, G H];
    reverse the cotangent [B, G H] @ W_h^T, as two bf16 terms."""
    return (G * H, H, 2) if reverse else (H, G * H, 1)


def _check_one_wave(B, width, G, reverse, sms):
    H = _width(width, G)
    K, N, terms = _dims(G, H, reverse)
    cfg = cuda_gru.step_gemm_config(B, K, N, terms, sms=sms)
    bm, bn, bk = cfg["block"]
    assert (cfg["design"], cfg["threads"], bn, bk, cfg["stages"]) == ("wgmma", 256, 128, 64, 3)
    assert bm == (256 if not reverse and B > 128 else 128)  # the reverse's two A tiles: 128
    m_blocks = -(-B // bm)
    if not reverse and B <= 256:
        assert m_blocks == 1  # every W_h tile into shared memory once a step
    assert cfg["tiles"] == -(-N // bn) * m_blocks
    assert cfg["grid"] <= sms
    assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT and cfg["stages"] >= 3
    assert cfg["workspace_bytes"] == cfg["splits"] * B * N * 4
    chunks, S, per = -(-K // bk), cfg["splits"], cfg["chunks_per_split"]
    assert 1 <= S <= cuda_gru.STEP_GEMM_MAX_SPLITS
    assert (S - 1) * per < chunks <= S * per  # every split has chunks
    if cfg["tiles"] >= sms:
        assert S == 1 and cfg["grid"] == sms
    else:
        assert cfg["grid"] == cfg["tiles"] * S
        target = min(cuda_gru.STEP_GEMM_MAX_SPLITS, sms // cfg["tiles"],
                     max(1, chunks // cuda_gru.STEP_GEMM_MIN_CHUNKS))
        assert per == -(-chunks // target) and S <= target
        if chunks >= cuda_gru.STEP_GEMM_MIN_CHUNKS:
            assert per >= cuda_gru.STEP_GEMM_MIN_CHUNKS
    strides = [K * 2, N * 2] if terms == 1 else [2 * K * 2, K * 2, K * 2]  # bytes
    assert cfg["unit_bytes"] == (16 if all(s % 16 == 0 for s in strides) else 8)
    assert cfg["tma"] == (cfg["unit_bytes"] == 16)  # TMA wants 16-byte strides
    assert cfg["w_layout"] == ("[N, K]" if reverse else "[K, N]")
    return cfg


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_step_gemm_config_fits_one_wave(B, width, G, reverse):
    """At most one wave of CTAs (K split to fill it while the tiles are
    fewer than the SMs, no split empty and none under the minimum depth K
    allows), every row of a row block of up to 256 in one CTA forward (W_h
    read once a step at B <= 256) and of 128 in the reverse (at B = 256 a W
    tile's second read from L2), shared memory within the 227 KB a CTA may
    have, the workspace S B N f32, and the TMA route (16-byte pieces)
    exactly where every row stride and base of a, its lo term and w is a
    16-byte multiple, else cp.async's 8-byte pieces. Planned, as by default,
    for the SMs of the card present (NUM_SMS without one)."""
    cfg = _check_one_wave(B, width, G, reverse, cuda_gru.card_sms())
    H = _width(width, G)
    K, N, terms = _dims(G, H, reverse)
    assert cfg == cuda_gru.step_gemm_config(B, K, N, terms)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("sms", [114, 66])
@pytest.mark.parametrize("width", [2304, "bf16_limit"])
@pytest.mark.parametrize("B", [16, 256, 512])
def test_step_gemm_config_plans_for_other_sm_counts(B, width, sms, reverse):
    """A card with other SMs than the H100 SXM's 132 (the PCIe card's 114,
    half a card's 66) gets the same rule at its count, as step_gemm.cuh's
    step_gemm_plan computes it from the device: one wave of at most `sms`
    CTAs, and the splits and workspace change with the count where the
    tiles are fewer than the SMs."""
    G = 3
    cfg = _check_one_wave(B, width, G, reverse, sms)
    full = _check_one_wave(B, width, G, reverse, cuda_gru.NUM_SMS)
    assert cfg["tiles"] == full["tiles"] and cfg["block"] == full["block"]
    if full["tiles"] >= cuda_gru.NUM_SMS:
        assert cfg["splits"] == full["splits"] == 1
    assert cfg["splits"] <= full["splits"]  # fewer SMs, no more planes


def test_card_sms_reads_the_current_device(monkeypatch):
    """NUM_SMS without a card; the current device's multiprocessor count
    with one (what the C side's plan reads)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cuda_gru.card_sms() == cuda_gru.NUM_SMS

    class Props:
        multi_processor_count = 114

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    assert cuda_gru.card_sms() == 114
    K, N = 3 * 2304, 2304
    assert (cuda_gru.step_gemm_config(256, K, N, 2) ==
            cuda_gru.step_gemm_config(256, K, N, 2, sms=114))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stepped_config_carries_the_gemm(cell, dtype):
    """The stepped layout's `gemm`: bf16 the step GEMM's configuration (the
    reverse two terms deep on W_h as stored, no stacked copy), f32 the
    CUDA-core projection in one plane."""
    G = 3 if cell == "gru" else 4
    H = cuda_gru.grid_max_hidden(dtype, G) + 4
    for reverse in (False, True):
        cfg = cuda_gru.stepped_config(256, 200, H, dtype, G, reverse)
        K, N, terms = _dims(G, H, reverse)
        assert (cfg["gemm_m"], cfg["gemm_k"], cfg["gemm_n"]) == (256, K, N)
        if dtype == torch.bfloat16:
            assert cfg["gemm"] == cuda_gru.step_gemm_config(256, K, N, terms)
        else:
            assert cfg["gemm"] == cuda_gru.step_gemm_f32_config(256, K, N)
            assert cfg["gemm"]["workspace_bytes"] == cfg["gemm"]["splits"] * 256 * N * 4


def test_step_gemm_config_refuses_what_the_kernel_cannot_take():
    for M, K, N, terms in ((0, 64, 64, 1), (4, 66, 64, 1), (4, 64, 66, 2), (4, 64, 64, 3)):
        with pytest.raises(ValueError, match="step gemm"):
            cuda_gru.step_gemm_config(M, K, N, terms)


def _operands(B, G, H, reverse, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(H, G * H)).astype(np.float32))
    w = w.bfloat16()
    if reverse:
        d = torch.from_numpy(rng.normal(scale=1e-2, size=(B, G * H)).astype(np.float32))
        hi = d.bfloat16()
        return torch.cat([hi, (d - hi.float()).bfloat16()], dim=1), w, d
    return torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).bfloat16(), w, None


def _exact_dot(a, b) -> np.ndarray:
    """a @ b summed in f64 and rounded once to f32: the correctly rounded
    product here (each f32 product is exact in f64, and 9,216 terms at most
    lose nothing at f32's precision), so a comparison against it carries the
    port's rounding alone. An f32 reference product (the CPU's BLAS, summed in its
    own order) differs from the plain version's by up to ~1e-5 of the
    largest value at K = 2,116, what the product check allows, and the gate
    check's 1e-5 absolute then saw both products' rounding at once."""
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [3, 16])
@pytest.mark.parametrize("H", [2116, 2304])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_forward_partials_summed_in_split_order_give_the_gates(cell, H, B, dtype):
    """Forward: the partial planes (split over K as the kernel splits it:
    bf16 the wgmma step GEMM's split, f32 the FMA GEMM's) summed in split
    order, then b_h (the GRU's; the gate kernel adds it), through the
    cell's gate math equal the JAX package's gates on x_proj and the exact
    h @ W_h rounded to f32, + b_h."""
    G = 3 if cell == "gru" else 4
    h, w, _ = _operands(B, G, H, False, seed=H + B + G)
    if dtype == torch.float32:  # f32 values of the same draw
        h, w = h.float(), w.float()
        parts = cuda_gru.step_gemm_f32(h, w)  # a CPU tensor: the plain version
        assert parts.shape[0] == cuda_gru.step_gemm_f32_config(B, H, G * H)["splits"] > 1
    else:
        parts = cuda_gru.step_gemm(h, w, 1)  # a CPU tensor: the plain version
        assert parts.shape[0] == cuda_gru.step_gemm_config(B, H, G * H, 1)["splits"]
    rng = np.random.default_rng(B)
    x_proj = rng.normal(size=(B, G * H)).astype(np.float32)
    b_h = rng.normal(scale=0.1, size=G * H).astype(np.float32) if cell == "gru" else None
    hp = cuda_gru.step_product(parts, None if b_h is None else torch.from_numpy(b_h))
    h32 = h.float().numpy()
    want = _exact_dot(h32, w.float().numpy()) + (0.0 if b_h is None else b_h)
    scale = np.abs(want).max()
    why = _product_errors(h32, w, b_h, hp.numpy(), want)
    np.testing.assert_allclose(hp.numpy(), want, rtol=1e-5, atol=1e-5 * scale, err_msg=why)
    xp = torch.from_numpy(x_proj)
    if cell == "gru":
        got = (reference.gru_gates(xp, hp, h.float()),)
        ref = (xla_ops.gru_gates(jnp.asarray(x_proj), jnp.asarray(want), jnp.asarray(h32)),)
    else:
        c = rng.normal(size=(B, H)).astype(np.float32)
        got = reference.lstm_gates(xp, hp, torch.from_numpy(c))
        ref = xla_ops.lstm_gates(jnp.asarray(x_proj), jnp.asarray(want), jnp.asarray(c))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=why)


def _product_errors(h32, w, b_h, port, exact) -> str:
    """Which side of the gate check moved, should it fail: the largest
    error, over the largest value, of the port's summed product and of
    JAX's f32 product (jnp.dot, preferred_element_type=f32) against the
    exact one, and the matmul precision settings of both frameworks."""
    b = 0.0 if b_h is None else b_h
    jax_dot = np.asarray(jnp.dot(jnp.asarray(h32), jnp.asarray(w.float().numpy()),
                                 preferred_element_type=jnp.float32)) + b
    scale = np.abs(exact).max()
    return (f"product error / largest value: port {np.abs(port - exact).max() / scale:.3g}, "
            f"jnp.dot {np.abs(jax_dot - exact).max() / scale:.3g}; torch float32 matmul "
            f"precision {torch.get_float32_matmul_precision()!r}, torch threads "
            f"{torch.get_num_threads()}, jax default matmul precision "
            f"{jax.config.jax_default_matmul_precision!r}")


@pytest.mark.parametrize("B", [3, 16])
@pytest.mark.parametrize("H", [2116, 2304])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_reverse_partials_summed_in_split_order_give_dh_prev(cell, H, B):
    """Reverse: the hi and lo terms' partial planes on W_h as stored, K split
    into several planes, summed in split order, equal the exact d @ W_h^T,
    rounded to f32, on the f32 cotangent, within what two bf16 terms keep;
    and the GRU's carry z dh + that product."""
    G = 3 if cell == "gru" else 4
    a, w, d = _operands(B, G, H, True, seed=H + B + G + 1)
    cfg = cuda_gru.step_gemm_config(B, G * H, H, 2)
    assert cfg["splits"] > 1
    parts = cuda_gru.step_gemm(a, w, 2)
    assert tuple(parts.shape) == (cfg["splits"], B, H)
    p = cuda_gru.step_product(parts)
    want = _exact_dot(d.numpy(), w.float().numpy().T)
    scale = np.abs(want).max()
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-4, atol=1e-4 * scale)
    if cell == "gru":
        zdh = np.random.default_rng(H).normal(scale=1e-2, size=(B, H)).astype(np.float32)
        np.testing.assert_allclose((torch.from_numpy(zdh) + p).numpy(), zdh + want, rtol=1e-4,
                                   atol=1e-4 * scale)
