"""The f32 FMA GEMM (csrc/fma_gemm.cuh), on the CPU: what `gru.fma_gemm_config`
plans for its two roles, the f32 input projection (`xproj_f32_config`, no K
split) and the f32 stepped layouts' step GEMM (`step_gemm_f32_config`, K
split into partial planes); the C side's fma_plan computes the same and the
entry points refuse a caller whose plan differs. The split follows K, N and
the SMs alone, so a row's bits never depend on its batch. The plain
versions (what the wrappers run on a CPU tensor) against the JAX package's
f32 dots (seqrec_tpu/ops/pallas/gru.py:110-117, lstm.py:89-93). The kernel
is held against f64, its plain split and the k-order FMA sum on the card
(tests/test_torch_kernels.py, `-k "fma or k_order or stepped_forward_f32"`).

Tolerance: 1e-5 of the largest value (f32 products summed in another order,
up to 9,216 of them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqrec_tpu_torch.ops.cuda import gru as cuda_gru

ROWS = (1, 3, 16, 64, 256, 12_800, 25_600, 51_200)
# (K, N) of the projection (K = D, N = 3H or 4H, H = D) and of the step GEMM
# (forward K = H, N = G H; reverse K = G H, N = H) at the widths the models
# take, the stepped ones from the f32 grid limit + 4 to w3's 2,304.
WIDTHS = (52, 100, 128, 512, 1000, 2304)
STEPPED = (1060, 2116, 2304)


def _check_simt_plan(M, D, N, sms):
    """Below FMA_MIN_DEPTH the projection keeps the SIMT design: 64 x 128
    tiles, 4 CTAs a SM of 128 threads, the k chunk 16 deep where that pads D
    less than 32 does."""
    cfg = cuda_gru.xproj_f32_config(M, D, N, sms=sms)
    bm, bn, bk = cfg["block"]
    assert (cfg["design"], bm, bn, cfg["threads"]) == ("simt", 64, 128, 128)
    assert bk == (16 if -(-D // 16) * 16 < -(-D // 32) * 32 else 32)
    assert cfg["tiles"] == -(-M // 64) * -(-N // 128)
    assert cfg["grid"] == min(cfg["tiles"], 4 * sms) == cuda_gru.xproj_f32_grid(M, N, sms)
    assert cfg["smem_bytes"] == cfg["stages"] * bk * (64 + 4 + 128) * 4
    assert 4 * (cfg["smem_bytes"] + 1024) <= cuda_gru.SM_SMEM
    return cfg


def _check_simt_split_plan(M, K, N, sms):
    """Up to STEP_SIMT_ROWS rows the step GEMM runs the SIMT kernel on the
    FMA GEMM's split: 64 x 128 tiles of 128 threads, 32-deep chunks (the
    split's), an item a tile and a split, at most 4 CTAs a SM."""
    cfg = cuda_gru.step_gemm_f32_config(M, K, N, sms=sms)
    fma = cuda_gru.fma_gemm_config(M, K, N, True, sms=sms)
    assert (cfg["design"], cfg["block"], cfg["threads"], cfg["stages"]) == (
        "simt", [64, 128, 32], 128, 2)
    assert (cfg["splits"], cfg["chunks_per_split"], cfg["workspace_bytes"]) == (
        fma["splits"], fma["chunks_per_split"], fma["workspace_bytes"])
    assert cfg["tiles"] == -(-M // 64) * -(-N // 128)
    assert cfg["grid"] == min(cfg["tiles"] * cfg["splits"], 4 * sms)
    assert cfg["smem_bytes"] == 2 * 32 * (64 + 4 + 128) * 4
    assert 4 * (cfg["smem_bytes"] + 1024) <= cuda_gru.SM_SMEM
    return cfg


def _check_plan(M, K, N, split, sms):
    if not split and K < cuda_gru.FMA_MIN_DEPTH:
        return _check_simt_plan(M, K, N, sms)
    if split and M <= cuda_gru.STEP_SIMT_ROWS:
        return _check_simt_split_plan(M, K, N, sms)
    cfg = cuda_gru.fma_gemm_config(M, K, N, split, sms=sms)
    bm, bn, bk = cfg["block"]
    W = cfg["warps"]
    assert (cfg["design"], cfg["layout"], cfg["route"], bn, bk) == (
        "fma", "persistent", "tma", 128, 32)
    # 8 consumer warps of 32 rows and a producer warpgroup, one CTA a SM: a
    # consumer's 8 x 16 sums in 240 registers, the producer's 24 (setmaxnreg),
    # 384 x 168 at launch
    assert W == cuda_gru.FMA_WARPS == 8 and bm == 256
    assert cfg["threads"] == 128 + 32 * W == cuda_gru.FMA_THREADS
    assert 128 * 24 + 32 * W * 240 == cfg["threads"] * 168 <= 65536
    assert cfg["ctas_per_sm"] == 1 and cfg["stages"] == cuda_gru.FMA_STAGES == 4
    stage = (bm * cuda_gru.FMA_BOX_K + bk * bn) * 4
    assert cfg["smem_bytes"] == cfg["stages"] * stage + 1024 <= cuda_gru.SMEM_LIMIT
    assert cfg["smem_bytes"] + 1024 <= cuda_gru.SM_SMEM  # the SM holds it
    chunks, n_tiles = -(-K // bk), -(-N // bn)
    assert cfg["tiles"] == -(-M // bm) * n_tiles
    per, s = cfg["chunks_per_split"], cfg["splits"]
    assert (s - 1) * per < chunks <= s * per  # no split empty
    assert cfg["grid"] == min(cfg["tiles"] * s, sms)
    if split:
        assert cfg["workspace_bytes"] == s * M * N * 4
        assert bm == 256 and cfg == cuda_gru.step_gemm_f32_config(M, K, N, sms=sms)
        assert s <= cuda_gru.FMA_MAX_SPLITS
        assert s == 1 or per >= min(chunks, cuda_gru.FMA_MIN_CHUNKS)
    else:
        assert s == 1 and per == chunks and cfg["workspace_bytes"] == 0
    return cfg


@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("M", ROWS)
def test_xproj_f32_config_fits_the_card(M, D, G):
    """The f32 projection at every row count and width the models give it
    (N = 3H, 4H): from D = 256 the FMA GEMM, one CTA of 256 rows a SM (8
    consumer warps and a producer warpgroup), the ring within the 227 KB a
    CTA may have, the registers within the SM's, no split (each output one
    k-order sum, then b); below it the SIMT design. Planned, as by default, for the card present (NUM_SMS without
    one)."""
    N = G * D
    cfg = _check_plan(M, D, N, False, cuda_gru.card_sms())
    assert cfg == cuda_gru.xproj_f32_config(M, D, N)
    assert cfg["design"] == ("fma" if D >= cuda_gru.FMA_MIN_DEPTH else "simt")
    assert cuda_gru.xproj_f32_plan_args(M, D, N) == (cfg["block"][0], cfg["grid"],
                                                     cfg["smem_bytes"])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("H", STEPPED)
@pytest.mark.parametrize("M", [1, 16, 64, 100, 256, 300])
def test_step_gemm_f32_config_fits_the_card(M, H, G, reverse):
    """The f32 step GEMM at the stepped widths, both directions: the split
    plan fits as the projection's does, its workspace the partial planes;
    up to STEP_SIMT_ROWS rows on the SIMT kernel, above on the FMA GEMM's 8
    warps."""
    K, N = (G * H, H) if reverse else (H, G * H)
    cfg = _check_plan(M, K, N, True, cuda_gru.card_sms())
    assert cfg == cuda_gru.step_gemm_f32_config(M, K, N)
    assert cfg["design"] == ("simt" if M <= cuda_gru.STEP_SIMT_ROWS else "fma")
    stepped = cuda_gru.stepped_config(M, 20, H, torch.float32, G, reverse)
    assert stepped["gemm"] == cfg and stepped["design"] == "fma"


@pytest.mark.parametrize("sms", [114, 66, 132])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("H", STEPPED)
def test_f32_split_is_the_same_for_every_batch(H, G, reverse, sms):
    """The split (splits and chunks a split) at each (K, N) is the same for
    B = 1, 16, 64 and 256 (and 300, past one 256-row tile): a row's partial
    sums, so its bits, do not depend on the batch around it. The tiles do
    follow M."""
    K, N = (G * H, H) if reverse else (H, G * H)
    plans = {B: _check_plan(B, K, N, True, sms) for B in (1, 16, 64, 256, 300)}
    assert len({(c["splits"], c["chunks_per_split"]) for c in plans.values()}) == 1
    assert len({c["block"][0] for c in plans.values()}) == 2
    assert plans[1]["splits"] == cuda_gru.fma_splits(K, N, sms)


def test_f32_split_at_w3():
    """The rule at w3's steps on an H100 (H = 2,304): the forward GRU 2
    splits of 36 chunks, the LSTM 9 of 8, both reverses 7 (31 and 42
    chunks): the fewest waves of chunks with each plane's traffic costed."""
    want = {(2304, 6912): (2, 36), (2304, 9216): (9, 8), (6912, 2304): (7, 31),
            (9216, 2304): (7, 42)}
    for (K, N), (s, per) in want.items():
        cfg = cuda_gru.step_gemm_f32_config(256, K, N, sms=cuda_gru.NUM_SMS)
        assert (cfg["splits"], cfg["chunks_per_split"]) == (s, per), (K, N)


@pytest.mark.parametrize("M,K,N", [(0, 64, 64), (4, 66, 64), (4, 64, 66), (4, 0, 8)])
def test_f32_gemm_config_refuses_what_the_kernel_cannot_take(M, K, N):
    """An empty shape, or K or N not a multiple of 4, reaches no kernel: the
    config raises (the C side returns cudaErrorInvalidValue); the wrappers
    zero-pad D and N to multiples of 4 before it. So does the step GEMM's,
    at every M (its SIMT plan up to STEP_SIMT_ROWS rows too)."""
    for split in (False, True):
        with pytest.raises(ValueError, match="f32 gemm"):
            cuda_gru.fma_gemm_config(M, K, N, split)
    with pytest.raises(ValueError, match="f32 gemm"):
        cuda_gru.step_gemm_f32_config(M, K, N)


@pytest.mark.parametrize("M,K,N", [(3, 2304, 6912), (16, 1060, 4240), (5, 9216, 2304),
                                   (2, 100, 300)])
def test_plain_f32_step_gemm_planes_match_jax(M, K, N):
    """The plain f32 step GEMM (what `step_gemm_f32` runs on a CPU tensor):
    plane s holds K's chunks of split s, and the planes summed in split
    order equal jnp.dot in f32 within 1e-5 of the largest value."""
    rng = np.random.default_rng(M + K)
    a = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(scale=K ** -0.5, size=(K, N)).astype(np.float32)
    parts = cuda_gru.step_gemm_f32(torch.from_numpy(a), torch.from_numpy(w))
    cfg = cuda_gru.step_gemm_f32_config(M, K, N)
    assert tuple(parts.shape) == (cfg["splits"], M, N)
    per = cfg["chunks_per_split"] * cfg["block"][2]
    for s in range(cfg["splits"]):
        np.testing.assert_allclose(parts[s].numpy(), a[:, s * per:(s + 1) * per]
                                   @ w[s * per:(s + 1) * per], rtol=1e-5, atol=1e-5)
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(w), preferred_element_type=jnp.float32))
    got = cuda_gru.step_product(parts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("M,N", [(1, 4), (63, 300), (64, 384), (65, 512), (12800, 384),
                                 (25600, 384), (25600, 512), (12837, 300)])
@pytest.mark.parametrize("ctas", ["launch", 7])
def test_fma_gemm_schedule_covers_every_tile_once(M, N, ctas):
    """The f32 FMA GEMM (csrc/fma_gemm.cuh fma_gemm_kernel) as the projection
    from FMA_MIN_DEPTH runs it (D = 512, the wide towers'), as its index
    maps lay it out: CTA c of the grid takes items c, c + grid,
    ... (fm_item: tiles in bands of FMA_ROW_GROUP row blocks, every column
    block of a band before the next), each thread of a tile its 8
    rows (warp 32 + lane // 8 + 4 i) by 16 columns (32 c + 4 (lane % 8) +
    j); every output of [M, N] is written exactly once, over the grid
    xproj_f32_config plans and a grid of 7 CTAs alike. Each 16-byte A read
    of a warp falls in four distinct bank groups (A box rows of FMA_BOX_K
    values), each B read on 8 lanes' 128 contiguous bytes; and the step
    GEMM's K split covers every chunk of K once, whatever M."""
    bn, bk = cuda_gru.FMA_TILE
    cfg = cuda_gru.xproj_f32_config(M, 512, N, sms=cuda_gru.NUM_SMS)
    assert cfg["design"] == "fma"
    W = cfg["warps"]
    BM = cfg["block"][0]
    assert BM == 32 * W and cfg["threads"] == 128 + 32 * W and cfg["splits"] == 1
    G = cfg["grid"] if ctas == "launch" else ctas
    tid = np.arange(32 * W)  # the consumer threads, after the producer warpgroup's 128
    lane, warp = tid & 31, tid >> 5
    lm, ln = lane >> 3, lane & 7
    rows = warp[:, None] * 32 + lm[:, None] + 4 * np.arange(8)  # [threads, 8]
    cols = (32 * np.arange(4)[:, None] + np.arange(4)).ravel()[None, :] + 4 * ln[:, None]
    m_tiles, n_tiles = -(-M // BM), -(-N // bn)
    band = cuda_gru.FMA_ROW_GROUP * n_tiles
    hits = np.zeros((M, N), np.int64)
    for c in range(G):
        for it in range(c, m_tiles * n_tiles, G):
            first = it // band * cuda_gru.FMA_ROW_GROUP
            height, r = min(m_tiles - first, cuda_gru.FMA_ROW_GROUP), it % band
            m0, n0 = (first + r % height) * BM, r // height * bn
            rr = (m0 + rows)[:, :, None].repeat(16, axis=2)
            kk = (n0 + cols)[:, None, :].repeat(8, axis=1)
            ok = (rr < M) & (kk < N)
            np.add.at(hits, (rr[ok], kk[ok]), 1)
    assert (hits == 1).all()
    # A warp's 16-byte reads of A at k group g: four rows, four bank groups.
    for w in range(W):
        for i in range(8):
            for g in range(bk // 4):
                r = w * 32 + np.arange(4) + 4 * i
                assert len(set((r * cuda_gru.FMA_BOX_K + 4 * g) // 4 % 8)) == 4
    assert sorted(set(4 * ln)) == list(range(0, 32, 4))  # B: 8 float4s, 128 bytes
    # The step GEMM's split at this N (K = 2,304, as w3's forward): chunk
    # ranges cover K once, the same for every M.
    K = 2304
    split = {m: cuda_gru.step_gemm_f32_config(m, K, N, sms=cuda_gru.NUM_SMS)
             for m in (1, 16, 64, 256, M)}
    assert len({(s["splits"], s["chunks_per_split"]) for s in split.values()}) == 1
    s = split[M]
    chunks = [c for p in range(s["splits"])
              for c in range(p * s["chunks_per_split"],
                             min(-(-K // bk), (p + 1) * s["chunks_per_split"]))]
    assert chunks == list(range(-(-K // bk)))


@pytest.mark.parametrize("M,K,N", [(1, 2304, 6912), (16, 1060, 4240), (64, 6912, 2304),
                                   (100, 9216, 2304), (128, 2304, 9216)])
@pytest.mark.parametrize("ctas", ["launch", 5])
def test_simt_step_gemm_schedule_covers_every_chunk_once(M, K, N, ctas):
    """The step GEMM's SIMT kernel (csrc/rnn.cuh xproj_f32_kernel with a
    split) as its index maps lay it out: CTA c takes iterations i = 0, 1,
    ... of items c, c + grid, ... (item j: split j % splits of tile j //
    splits, tile t: row block t % m_tiles, column block t // m_tiles), chunk
    split * per + i % per of K; each (tile, chunk of K) is summed exactly
    once, into its split's plane, every chunk past K (the last split's) is
    zeros, and each plane's output written once, over the planned grid and a
    grid of 5 alike. So each plane sums its 32-deep chunks in k order from
    0, as the FMA GEMM does at the same split: the same bits."""
    cfg = cuda_gru.step_gemm_f32_config(M, K, N, sms=cuda_gru.NUM_SMS)
    assert cfg["design"] == "simt"
    tm, tn, bk = cfg["block"]
    per, splits = cfg["chunks_per_split"], cfg["splits"]
    chunks, m_tiles = -(-K // bk), -(-M // tm)
    tiles = m_tiles * -(-N // tn)
    items = tiles * splits
    G = cfg["grid"] if ctas == "launch" else ctas
    summed = np.zeros((tiles, chunks), np.int64)
    stored = np.zeros((splits, tiles), np.int64)
    for c in range(G):
        iters = (items - c + G - 1) // G * per
        for i in range(iters):
            item = c + i // per * G
            tile, split = item // splits, item % splits
            k = split * per + i % per
            assert (k < chunks) == (k * bk < K)
            if k < chunks:
                summed[tile, k] += 1
                assert k // per == split  # its own plane's range
            if i % per == per - 1:
                stored[split, tile] += 1
    assert (summed == 1).all() and (stored == 1).all()
