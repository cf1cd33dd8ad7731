"""The bf16 GRU recurrences above Hp = 128 (`csrc/gru.cu`'s cluster layouts):
what `launch_config` and `backward_launch_config` choose and refuse there,
and the packed A fragments both read, unpacked on the CPU against W_h.

This file imports no JAX: the layouts are the port's own (the JAX package
runs one Pallas program over the whole width). The kernels themselves are
held against their plain versions on the card (`tests/test_torch_kernels.py
-m cuda`, `chip_smoke.py` phase s3)."""

import numpy as np
import pytest
import torch

from seqrec_tpu_torch.ops.cuda import gru as cuda_gru


def _unpack(frags: torch.Tensor) -> np.ndarray:
    """[M/16, K/16, 32, 8] bf16 -> [M, K], lane by lane and register by
    register from the PTX ISA's map of mma.m16n8k16's A fragment (g = lane /
    4, q = lane % 4; a0 = (g, 2q..2q+1), a1 = (g+8, ..), a2 = (g, 2q+8..),
    a3 = (g+8, 2q+8..))."""
    f = frags.float().numpy()
    mt, kt = f.shape[:2]
    a = np.full((16 * mt, 16 * kt), np.nan, np.float32)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for pair in range(2):
            rows = 16 * np.arange(mt)[:, None, None] + (g + dm)[None, None, :]
            cols = 16 * np.arange(kt)[None, :, None] + (2 * q + dk + pair)[None, None, :]
            a[rows, cols] = f[:, :, :, 2 * r + pair]
    return a


def _w_h(H: int) -> torch.Tensor:
    rng = np.random.default_rng(H)
    return torch.from_numpy(rng.normal(size=(H, 3 * H)).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("B", [3, 64, 128])
@pytest.mark.parametrize("H", [136, 200, 256])
def test_wide_forward_launch_config(H, B):
    """Above Hp = 128 the bf16 forward runs on clusters of 4 CTAs of 256
    threads, a cluster 8 batch rows (one n8 tile): 2, 32 and 64 CTAs at
    B = 3, 64 and 128 (16 and 8 clusters fit the card at once). Units and k
    pad to 256 whatever Hp (H = 136 -> 144, 200 -> 208), 64 units a CTA,
    every fragment in registers, two warps a tile over K's halves; shared
    memory: h^T's two buffers [2][256][8] bf16, the halves' partial sums
    [4][2][6][32] f32 and two mbarriers."""
    cfg = cuda_gru.launch_config(B, 50, 256, H, torch.bfloat16)
    clusters = -(-B // 8)
    assert cfg == {
        "design": "mma.sync", "layout": "cluster", "cluster_size": 4, "clusters": clusters,
        "grid": 4 * clusters, "threads": 256, "rows_per_block": 8,
        "hidden_padded": 16 * -(-H // 16), "width_padded": 256, "units_per_cta": 64,
        "k_split": 2, "wh_in_regs": 1, "smem_bytes": 2 * 256 * 8 * 2 + 4 * 2 * 6 * 32 * 4 + 16}
    assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT
    assert cfg["grid"] <= cuda_gru.NUM_SMS


@pytest.mark.parametrize("h_in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [3, 64, 128])
@pytest.mark.parametrize("H", [136, 200, 256])
def test_wide_backward_launch_config(H, B, h_in_dtype):
    """The bf16 reverse recurrence above Hp = 128: clusters of 4 CTAs of 256
    threads over 8 rows, K split between them (each CTA its 64 units' 192
    gate columns, W_h's rows of all 256 units over them in registers);
    shared memory: d_hproj^T of its columns [hi, lo][192][8] bf16, the
    partial sums [2][4][64][8] f32, three ring stages of its units'
    operands (six [8][68] f32 gate blocks, h_in [8][68] f32 or [8][72]
    bf16, g_ys [8][72] bf16) and two mbarriers."""
    cfg = cuda_gru.backward_launch_config(B, 50, H, torch.bfloat16, h_in_dtype=h_in_dtype)
    h_row = 68 * 4 if h_in_dtype == torch.float32 else 72 * 2
    stage = 6 * 8 * 68 * 4 + 8 * h_row + 8 * 72 * 2
    clusters = -(-B // 8)
    assert cfg == {
        "design": "mma.sync", "layout": "cluster", "cluster_size": 4, "clusters": clusters,
        "grid": 4 * clusters, "threads": 256, "rows_per_block": 8,
        "hidden_padded": 16 * -(-H // 16), "width_padded": 256, "units_per_cta": 64,
        "w_in_regs": 1, "d_terms": 2,
        "smem_bytes": 2 * 192 * 8 * 2 + 2 * 4 * 64 * 8 * 4 + 3 * stage + 16}
    assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT


@pytest.mark.parametrize("config", ["forward", "backward"])
def test_wide_layouts_refuse_what_they_cannot_take(config):
    """H = 260 is past the 256 the cluster layouts pad to: it takes the grid
    layout, and H past the grid layout's limit (2,112 in bf16) the stepped
    layout; the cluster size (4) and the rows a cluster (8, one n8 tile) are
    no choice."""
    def cfg(B, H, **kw):
        if config == "forward":
            return cuda_gru.launch_config(B, 50, 64, H, torch.bfloat16, **kw)
        return cuda_gru.backward_launch_config(B, 50, H, torch.bfloat16, **kw)

    assert cfg(64, 260)["layout"] == "grid"
    limit = cuda_gru.grid_max_hidden(torch.bfloat16)
    assert cfg(64, limit)["layout"] == "grid"
    assert cfg(64, limit + 4)["layout"] == "stepped"
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cfg(64, 256, rows_per_cluster=4)
    with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
        cfg(64, 128, cluster_size=4)


@pytest.mark.parametrize("H", [136, 256])
@pytest.mark.parametrize("config", ["forward", "backward"])
def test_wide_layouts_take_no_cluster_size(config, H):
    """Above Hp = 128 as below it, bf16 takes no cluster size: the layouts
    are built for 4 CTAs alone, and even 4 asked for by name is refused, as
    the one-block designs refuse it."""
    for C in (2, 4, 8):
        with pytest.raises(ValueError, match="rows_per_cluster and cluster_size are the f32"):
            if config == "forward":
                cuda_gru.launch_config(128, 50, 256, H, torch.bfloat16, cluster_size=C)
            else:
                cuda_gru.backward_launch_config(128, 50, H, torch.bfloat16, cluster_size=C)


def test_wide_constants_match_the_source():
    """The wrapper's copies of csrc/gru.cu's cluster-layout constants: the
    padded width, the CTAs a cluster, the threads a CTA and the widest H
    the one-block designs take."""
    import re
    from pathlib import Path

    src = (Path(cuda_gru.__file__).resolve().parents[2] / "csrc" / "gru.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (cuda_gru.WIDE, cuda_gru.WIDE_CLUSTER, cuda_gru.WIDE_THREADS, cuda_gru.WH_REG_LIMIT) == (
        const("kWide"), const("kWideCluster"), 32 * const("kWideWarps"), const("kMaxMmaBlock"))


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_wide_wrappers_take_the_plain_versions_on_the_cpu(kernel):
    """At beauty's width a CPU tensor goes to the plain version, and no
    launch counter moves, the cluster layout's included."""
    B, T, H = 3, 4, 256
    rng = np.random.default_rng(5)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    counters = ("launches", "reset_launches", "wide_launches")
    if kernel == "forward":
        fn = cuda_gru.gru_scan
        args = (t(B, T, H).bfloat16(), t(B, H).bfloat16(), (t(H, 3 * H) * 0.06).bfloat16(),
                (t(H, 3 * H) * 0.06).bfloat16(), t(3 * H), t(3 * H))
        before = [getattr(fn, c) for c in counters]
        got = fn(*args)[0]
        want = cuda_gru.plain(*args)[0]
    else:
        fn = cuda_gru.gru_backward
        args = (t(B, T, 3 * H), t(B, T, 3 * H), torch.tanh(t(B, T, H)).bfloat16(),
                (t(B, T, H) * 0.01).bfloat16(), (t(H, 3 * H) * 0.06).bfloat16())
        before = [getattr(fn, c) for c in counters]
        got = fn(*args)[0]
        want = cuda_gru.plain_backward(*args)[0]
    assert [getattr(fn, c) for c in counters] == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("H,hp,threads", [(4, 16, 32), (64, 64, 128), (100, 112, 224),
                                          (128, 128, 256)])
def test_block_layouts_unchanged_up_to_hp_128(H, hp, threads):
    """Up to Hp = 128 both recurrences keep their one-block designs exactly:
    Hp / 16 warps over 8 rows, W_h in registers, no cluster."""
    assert cuda_gru.launch_config(64, 200, 64, H, torch.bfloat16) == {
        "design": "mma.sync", "grid": 8, "threads": threads, "rows_per_block": 8,
        "hidden_padded": hp, "wh_in_regs": 1, "smem_bytes": 2 * 8 * hp * 2}
    stage = 6 * 8 * (hp + 4) * 4 + 8 * (hp + 8) * 2 + 8 * (hp + 8) * 2
    assert cuda_gru.backward_launch_config(64, 200, H, torch.bfloat16) == {
        "design": "mma.sync", "grid": 8, "threads": threads, "rows_per_block": 8,
        "hidden_padded": hp, "w_in_regs": 1, "d_terms": 2,
        "smem_bytes": 2 * 2 * 3 * hp * 8 * 2 + 3 * stage}


@pytest.mark.parametrize("H", [136, 200, 256])
def test_forward_fragments_unpack_to_w_h_transposed(H):
    """The cluster forward's A operand: per gate q, W_h^T (A[unit][k] =
    W_h[k, q H + unit]) with units and k padded to 256 by zeros,
    [tile][k-step][gate][lane]; unpacked lane by lane, it is exactly that."""
    w_h = _w_h(H)
    frags = cuda_gru.forward_fragments(w_h)
    assert frags.dtype == torch.bfloat16 and frags.is_contiguous()
    assert tuple(frags.shape) == (16, 16, 3, 32, 8)
    w = w_h.float().numpy()
    for q in range(3):
        want = np.zeros((256, 256), np.float32)
        want[:H, :H] = w[:, q * H:(q + 1) * H].T
        np.testing.assert_array_equal(_unpack(frags[:, :, q]), want)


@pytest.mark.parametrize("H", [136, 200, 256])
def test_wide_backward_fragments_unpack_to_w_h(H):
    """The cluster reverse recurrence's A operand: CTA c's W_h rows of all
    256 (padded) units over its own gate columns, local column q U + j
    being W_h's q H + c U + j (U = 64), zero past H in rows and columns,
    [CTA][tile][k-step][lane]; unpacked, it is exactly that, and the 4
    CTAs' columns together are every gate column once."""
    w_h = _w_h(H)
    C, U = 4, 64
    frags = cuda_gru.wide_backward_fragments(w_h)
    assert frags.dtype == torch.bfloat16 and frags.is_contiguous()
    assert tuple(frags.shape) == (C, 16, 3 * U // 16, 32, 8)
    w = np.zeros((256, 3, 256), np.float32)
    w[:H, :, :H] = w_h.float().numpy().reshape(H, 3, H)
    seen = np.zeros((3, 256), np.int64)
    for c in range(C):
        got = _unpack(frags[c]).reshape(256, 3, U)
        np.testing.assert_array_equal(got, w[:, :, c * U:(c + 1) * U])
        seen[:, c * U:(c + 1) * U] += 1
    assert (seen == 1).all()
