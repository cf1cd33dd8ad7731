"""The f32 cluster recurrences' layout (csrc/rnn.cuh: the f32 GRU forward
and reverse recurrence, the f32 LSTM forward and reverse recurrence), on the
CPU: what
`launch_config` and `backward_launch_config` choose and refuse, and the
index maps the kernels use, checked here in numpy as the kernels compute
them: the k-sliced weight image each CTA copies into its shared memory, the
slice layout of the exchanged vector, the reduce-scatter that leaves each
(unit, row) pair one owner lane, and (LSTM forward) the owner's operand
slots, cell update and keep scaling; (GRU reverse) the owners' gate
cotangents, where their d_hproj values land, and the carry. Exact: only
indices and f64 sums are compared."""

import numpy as np
import pytest
import torch

from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm


def _slice_pos(k, L, S):
    """rnn::slice_pos."""
    s, o = k // L, k % L
    return ((o >> 2) * S + s) * 4 + (o & 3)


def _weight_image(w_rows, U, u0, cfg, gates, block):
    """The shared-memory weight image one CTA of the kernel writes, from its
    copy loop: `w_rows(k, g, u)` is the weight of input k, gate g, unit u;
    `block` units a thread group (1: the GRU forward, S threads a unit,
    image [L/4][gates][threads][4]; 4: the LSTM reverse, a warp for 4 units,
    image [L/4][4][threads][4])."""
    S, L, NT = cfg["k_slices"], cfg["k_slice"], cfg["threads"]
    H = cfg["H"]
    up = NT // S * block
    ws = np.full(S * L * gates * up if block == 1 else S * L * up, np.nan)
    for vl in range(up):
        for k in range(S * L):
            for g in range(gates):
                ks, o = k // L, k % L
                inside = k < cfg["K"] and vl < U and u0 + vl < H
                val = w_rows(k, g, u0 + vl) if inside else 0.0
                if block == 1:
                    ws[(((o >> 2) * gates + g) * NT + vl * S + ks) * 4 + (o & 3)] = val
                else:
                    ws[(((o >> 2) * block + vl % block) * NT + vl // block * S + ks) * 4
                       + (o & 3)] = val
    return ws.reshape(L // 4, gates if block == 1 else block, NT, 4)


def _reduce_scatter(v):
    """rnn::reduce_scatter: v [groups, lanes, R, UT, G] partial sums ->
    [groups, lanes, NR, NU, G]: the rows split first, then the units, then
    what is left sums whole."""
    lanes = np.arange(v.shape[1])
    nr, nu, m = v.shape[2], v.shape[3], v.shape[1] // 2
    while m >= 1:
        partner = v[:, lanes ^ m]
        hi = ((lanes & m) != 0)[None, :, None, None, None]
        if nr > 1:
            v = np.where(hi, v[:, :, nr // 2:nr] + partner[:, :, nr // 2:nr],
                         v[:, :, :nr // 2] + partner[:, :, :nr // 2])
            nr //= 2
        elif nu > 1:
            v = np.where(hi, v[:, :, :, nu // 2:nu] + partner[:, :, :, nu // 2:nu],
                         v[:, :, :, :nu // 2] + partner[:, :, :, :nu // 2])
            nu //= 2
        else:
            v = v + partner
        m //= 2
    return v


def _owner(R, UT, lanes):
    """rnn::Owner: (NR, NU, row0, ut0, owner) of each lane of a group."""
    ll = int(np.log2(lanes))
    lr = min(int(np.log2(R)), ll)
    lu = min(int(np.log2(UT)), ll - lr)
    a = ll - lr - lu
    idx = np.arange(lanes)
    return (R >> lr, UT >> lu, (idx >> (ll - lr)) * (R >> lr),
            ((idx >> a) & ((1 << lu) - 1)) * (UT >> lu), (idx & ((1 << a) - 1)) == 0)


GRU_SHAPES = [(64, 128), (128, 128), (256, 100), (11, 132), (4, 256)]


@pytest.mark.parametrize("B,H", GRU_SHAPES)
@pytest.mark.parametrize("which", ["gru", "lstm", "lstm forward", "gru backward"])
def test_cluster_layout_partitions_the_work(which, B, H):
    """Every hidden unit has one CTA, every (unit, row) one owner lane; the
    threads are whole warps of (unit, k-slice) pairs; the slices cover the
    K inputs, padded with zeros to S L; the shared memory is the weight
    slice, the vector's two buffers, the operand ring and two mbarriers,
    within a block's limit."""
    if which == "gru":
        cfg, K, w_per_k, ring, block = cuda_gru.launch_config(B, 50, H, H, torch.float32), H, 3, 4, 1
    elif which == "lstm forward":  # four gates of a unit; xp's four gates and keep a step
        cfg, K, w_per_k, ring, block = cuda_lstm.launch_config(B, 50, H, H, torch.float32), H, 4, 5, 1
    elif which == "gru backward":  # a warp for 8 units; the step's 9 operands in 12 floats
        cfg = cuda_gru.backward_launch_config(B, 50, H, torch.float32)
        block = cuda_gru.BWD_UNITS
        K, w_per_k, ring = 3 * H, block, 12
    else:
        cfg = cuda_lstm.backward_launch_config(B, 50, H, torch.float32)
        K, w_per_k, ring, block = 4 * H, 4, 8, 4
    C, R, S, U, L, NT = (cfg[k] for k in ("cluster_size", "rows_per_cluster", "k_slices",
                                          "units_per_cta", "k_slice", "threads"))
    assert cfg["design"] == "cluster" and C * U >= H > (C - 1) * U
    assert cfg["clusters"] == -(-B // R) and cfg["grid"] == cfg["clusters"] * C
    assert NT % 32 == 0 and NT // S * block >= U and NT <= cuda_gru.CLUSTER_THREADS
    assert L % 4 == 0 and S * L >= K > S * (L - 4)
    ring_bytes = cuda_gru.CLUSTER_RING * max(R * block // S, 1) * NT * ring * 4
    assert cfg["smem_bytes"] == (w_per_k * L * NT + 2 * R * (S * L + 4)) * 4 + ring_bytes + 16
    assert cfg["smem_bytes"] <= cuda_gru.SMEM_LIMIT
    assert sorted(_slice_pos(k, L, S) for k in range(S * L)) == list(range(S * L))
    nr, nu, row0, ut0, owner = _owner(R, block, S)
    pairs = [(r0 + k, u + m) for r0, u, o in zip(row0, ut0, owner) if o
             for k in range(nr) for m in range(nu)]
    assert sorted(pairs) == [(r, u) for r in range(R) for u in range(block)]


@pytest.mark.parametrize("which,B,H,C,R", [
    ("gru", 64, 128, None, None), ("gru", 256, 100, None, None), ("gru", 7, 132, 4, 4),
    ("gru", 9, 256, None, None), ("gru", 5, 40, 2, 16),
    ("lstm", 128, 128, None, None), ("lstm", 9, 256, None, None), ("lstm", 6, 100, 4, 8),
    ("lstm", 5, 36, 2, 4),
    ("lstm forward", 128, 128, None, None), ("lstm forward", 11, 256, None, None),
    ("lstm forward", 6, 100, 4, 8), ("lstm forward", 5, 36, 2, 4),
    ("lstm forward", 9, 64, 8, 16), ("lstm forward", 20, 132, 4, 16)])
def test_cluster_kernel_index_maps_compute_the_step(which, B, H, C, R):
    """One step of the kernel, as its index maps lay it out: each thread's
    slice of the weight image against its slice of the vector (read at
    rnn::slice_pos), summed by the reduce-scatter, gives each owner lane the
    exact product of its (unit, row): h @ W_h's three gate columns (GRU
    forward, S threads a unit), its four (LSTM forward) or dz @ W_h^T (LSTM
    reverse, a warp for 4 units), in f64. The LSTM forward's owner lanes
    then read xp's four gates and keep[t+1] from their ring slots, update
    their cells and push h' keep into the next buffer: every (row, unit) of
    that buffer and of the cells is written once, as one step of
    reference.lstm_scan with a reset before the next."""
    rng = np.random.default_rng(H + (R or 0))
    if which in ("gru", "lstm forward"):
        gates = 3 if which == "gru" else 4
        config = cuda_gru.launch_config if which == "gru" else cuda_lstm.launch_config
        cfg = config(B, 3, H, H, torch.float32, rows_per_cluster=R, cluster_size=C)
        K = H
        w = rng.normal(size=(H, gates * H))
        w_rows = lambda k, g, u: w[k, g * H + u]  # noqa: E731
    else:
        cfg = cuda_lstm.backward_launch_config(B, 3, H, torch.float32, rows_per_cluster=R,
                                               cluster_size=C)
        K, gates = 4 * H, 1
        w = rng.normal(size=(H, 4 * H))
        w_rows = lambda k, g, u: w[u, k]  # noqa: E731
    cfg = dict(cfg, H=H, K=K)
    C, R, S, U, L, NT = (cfg[k] for k in ("cluster_size", "rows_per_cluster", "k_slices",
                                          "units_per_cta", "k_slice", "threads"))
    vec = rng.normal(size=(R, K))
    buf = np.zeros((R, S * L + 4))
    buf[:, [_slice_pos(k, L, S) for k in range(K)]] = vec
    want = vec @ w.T if which == "lstm" else vec @ w  # [R, H] or [R, gates H]
    v4 = buf[:, :S * L].reshape(R, L // 4, S, 4)  # float4 j S + s of each row
    block = 4 if which == "lstm" else 1
    nr, nu, row0, ut0, owner = _owner(R, block, S)
    # The LSTM forward's step operands: xp (b included), the cells, keep[t+1].
    xp = rng.normal(size=(R, 4 * H))
    cell = rng.normal(size=(R, H))
    keep = (rng.random(R) < 0.7).astype(np.float64)
    h_next = np.zeros((R, S * L + 4))
    cell_next = np.full((R, H), np.nan)
    written = np.zeros((R, H), np.int64)
    for c in range(C):
        u0 = c * U
        # Thread S g + s (GRU: g a unit; LSTM: a warp of 4 units), chunk j:
        # weight float4 ws[j][gate or unit of the group][tid].
        ws = _weight_image(w_rows, U, u0, cfg, gates, block)
        w4 = ws.reshape(L // 4, ws.shape[1], NT // S, S, 4)
        acc = np.einsum("rjse,jxgse->gsrx", v4, w4)  # [groups, lanes, R, gates or units]
        acc = acc[..., None] if which == "lstm" else acc[:, :, :, None, :]
        red = _reduce_scatter(acc)  # [groups, lanes, NR, NU, G]
        for g in range(NT // S):
            for s in range(S):
                for k in range(nr):
                    for m in range(nu):
                        ul = g * block + ut0[s] + m
                        if not owner[s] or ul >= U or u0 + ul >= H:
                            continue
                        r = row0[s] + k
                        exp = ([want[r, u0 + ul]] if which == "lstm"
                               else [want[r, q * H + u0 + ul] for q in range(gates)])
                        np.testing.assert_allclose(red[g, s, k, m], exp, rtol=1e-12, atol=1e-12)
                        if which != "lstm forward":
                            continue
                        # The lane's ring slot of row r: xp[r, q H + u], keep[r].
                        u = u0 + ul
                        x = xp[r, [q * H + u for q in range(4)]] + red[g, s, k, m]
                        sg = 1.0 / (1.0 + np.exp(-x))
                        c_new = sg[1] * cell[r, u] + sg[0] * np.tanh(x[2])
                        h_new = sg[3] * np.tanh(c_new)
                        h_next[r, _slice_pos(u, L, S)] = h_new * keep[r]
                        cell_next[r, u] = c_new * keep[r]
                        written[r, u] += 1
    if which == "lstm forward":
        z = xp + vec @ w
        zi, zf, zg, zo = (z[:, q * H:(q + 1) * H] for q in range(4))
        sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
        c_ref = sig(zf) * cell + sig(zi) * np.tanh(zg)
        h_ref = sig(zo) * np.tanh(c_ref)
        assert (written == 1).all()
        np.testing.assert_allclose(cell_next, c_ref * keep[:, None], rtol=1e-12, atol=1e-12)
        pos = [_slice_pos(k, L, S) for k in range(H)]
        np.testing.assert_allclose(h_next[:, pos], h_ref * keep[:, None], rtol=1e-12, atol=1e-12)
        pad = np.ones(S * L + 4, bool)
        pad[pos] = False
        assert not h_next[:, pad].any()


@pytest.mark.parametrize("which,B,H,want", [
    ("gru", 64, 128, (4, 4, 64, 32, 8, 16)),     # serving: 16 clusters of 4 CTAs
    ("gru", 128, 128, (4, 4, 128, 32, 8, 16)),   # training: 128 CTAs, one wave
    ("gru", 256, 100, (2, 4, 128, 50, 8, 16)),   # rsc15: 4 CTAs would be 256, two waves
    ("gru", 11, 256, (8, 4, 24, 32, 8, 32)),     # 4 CTAs' slices (192 KB + ring) do not fit
    ("gru", 11, 132, (4, 4, 12, 33, 8, 20)),
    ("lstm", 128, 128, (4, 8, 64, 32, 32, 16)),  # training: 16 clusters of 4 CTAs
    ("lstm", 256, 100, (4, 8, 128, 25, 32, 16)),
    ("lstm", 11, 256, (8, 8, 16, 32, 32, 32)),   # W_h rows of 64 units are 256 KB
    ("lstm forward", 64, 128, (4, 4, 64, 32, 8, 16)),    # serving: 16 clusters of 4 CTAs
    ("lstm forward", 128, 128, (4, 4, 128, 32, 8, 16)),  # training: 128 CTAs, one wave
    ("lstm forward", 256, 100, (2, 4, 128, 50, 8, 16)),  # 4 CTAs would be 256, two waves
    ("lstm forward", 11, 256, (8, 4, 24, 32, 8, 32)),    # 64 units' columns + ring do not fit
    ("gru backward", 128, 128, (2, 4, 64, 64, 32, 12)),  # training: 32 clusters of 2 CTAs
    ("gru backward", 64, 128, (2, 4, 32, 64, 32, 12)),
    ("gru backward", 256, 100, (2, 4, 128, 50, 32, 12)),  # rsc15's keep path
    ("gru backward", 11, 256, (8, 4, 24, 32, 32, 24)),   # 64 or more units' rows do not fit
])
def test_cluster_choice_at_the_paths_shapes(which, B, H, want):
    """(cluster size, rows a cluster, CTAs, units a CTA, k-slices, slice
    length) the launch configs choose: each kernel's measured preference,
    fewer CTAs than the card's SMs, and a slice that fits."""
    if which == "gru":
        cfg = cuda_gru.launch_config(B, 50, H, H, torch.float32)
    elif which == "lstm forward":
        cfg = cuda_lstm.launch_config(B, 50, H, H, torch.float32)
    elif which == "gru backward":
        cfg = cuda_gru.backward_launch_config(B, 50, H, torch.float32)
    else:
        cfg = cuda_lstm.backward_launch_config(B, 50, H, torch.float32)
    keys = ("cluster_size", "rows_per_cluster", "grid", "units_per_cta", "k_slices", "k_slice")
    assert tuple(cfg[k] for k in keys) == want
    assert cfg["grid"] <= cuda_gru.NUM_SMS


@pytest.mark.parametrize("call,match", [
    (lambda: cuda_gru.launch_config(8, 5, 16, 16, torch.float32, rows_per_cluster=3),
     "rows_per_cluster 3"),
    (lambda: cuda_gru.launch_config(8, 5, 16, 16, torch.float32, cluster_size=3),
     "cluster_size 3"),
    (lambda: cuda_lstm.backward_launch_config(8, 5, 256, torch.float32, cluster_size=4),
     "shared memory"),
    (lambda: cuda_gru.launch_config(8, 5, 16, 256, torch.float32, cluster_size=2),
     "1024 threads"),
    (lambda: cuda_lstm.backward_launch_config(8, 5, 16, torch.bfloat16, cluster_size=4),
     "f32 design"),
    (lambda: cuda_lstm.backward_launch_config(8, 5, 260, torch.float32), "H <= 256"),
    (lambda: cuda_lstm.launch_config(8, 5, 16, 16, torch.float32, rows_per_cluster=3),
     "rows_per_cluster 3"),
    (lambda: cuda_lstm.launch_config(8, 5, 16, 256, torch.float32, cluster_size=4),
     "shared memory"),
    (lambda: cuda_lstm.launch_config(8, 5, 16, 128, torch.float32, cluster_size=1),
     "1024 threads"),
    (lambda: cuda_lstm.launch_config(8, 5, 16, 16, torch.bfloat16, cluster_size=4),
     "f32 design"),
    (lambda: cuda_lstm.launch_config(8, 5, 16, 260, torch.float32), "H <= 256"),
    (lambda: cuda_gru.backward_launch_config(8, 5, 256, torch.float32, cluster_size=4),
     "shared memory"),
    (lambda: cuda_gru.backward_launch_config(8, 5, 16, torch.float32, rows_per_cluster=3),
     "rows_per_cluster 3"),
    (lambda: cuda_gru.backward_launch_config(8, 5, 16, torch.bfloat16, cluster_size=2),
     "f32 design"),
    (lambda: cuda_gru.backward_launch_config(8, 5, 1060, torch.float32), "H <= 1056"),
    (lambda: cuda_gru.backward_launch_config(8, 5, 260, torch.float32, cluster_size=4),
     "the grid layout above H = 256 takes neither"),
])
def test_cluster_configs_refuse_what_the_kernels_cannot_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("B,H,C,R", [(128, 128, None, None), (256, 100, None, None),
                                     (6, 100, 4, 8), (9, 256, None, None), (5, 36, 2, 16)])
def test_gru_backward_cluster_step_matches_the_reference_step(B, H, C, R):
    """One step of the f32 GRU reverse recurrence as its index maps lay it
    out, against the loop body of reference.gru_bwd_scan in f64: each owner
    lane's gates from its operands (the two projections' r, z, n columns,
    h_in, g_y, keep), its d_xp, and its three d_hproj values pushed to
    rnn::slice_pos(q H + u) of the exchanged buffer, every value of which is
    written once; then each CTA's slice of W_h's rows (the weight image)
    against that buffer, summed by the reduce-scatter, gives each owner the
    carry dh z + d_hproj W_h^T, times keep."""
    cfg = cuda_gru.backward_launch_config(B, 3, H, torch.float32, rows_per_cluster=R,
                                          cluster_size=C)
    C, R, S, U, L, NT = (cfg[k] for k in ("cluster_size", "rows_per_cluster", "k_slices",
                                          "units_per_cta", "k_slice", "threads"))
    K = 3 * H
    rng = np.random.default_rng(H + R)
    w = rng.normal(size=(H, K))
    xp, hp = rng.normal(size=(R, K)), rng.normal(size=(R, K))
    h_in, g_y, carry = (rng.normal(size=(R, H)) for _ in range(3))
    keep = (rng.random(R) < 0.7).astype(np.float64)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731

    def step(x3, h3, hin, gy, dh_c):  # reference.gru_bwd_scan's loop body
        r, z = sig(x3[0] + h3[0]), sig(x3[1] + h3[1])
        n = np.tanh(x3[2] + r * h3[2])
        dh = dh_c + gy
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_z = dh * (hin - n) * z * (1.0 - z)
        dpre_r = dpre_n * h3[2] * r * (1.0 - r)
        return (dpre_r, dpre_z, dpre_n), (dpre_r, dpre_z, dpre_n * r), dh * z

    blocks = lambda a: [a[:, q * H:(q + 1) * H] for q in range(3)]  # noqa: E731
    d_xp_ref, d_hp_ref, dhz_ref = step(blocks(xp), blocks(hp), h_in, g_y, carry)
    carry_ref = (dhz_ref + np.concatenate(d_hp_ref, axis=1) @ w.T) * keep[:, None]

    UT = cuda_gru.BWD_UNITS
    nr, nu, row0, ut0, owner = _owner(R, UT, S)
    buf = np.zeros((R, S * L + 4))
    written = np.zeros((R, K), np.int64)
    d_xp = np.full((R, K), np.nan)
    pairs = []
    for c in range(C):
        for g in range(NT // S):
            for s in range(S):
                for k in range(nr):
                    for m in range(nu):
                        ul = g * UT + ut0[s] + m
                        if not owner[s] or ul >= U or c * U + ul >= H:
                            continue
                        r, u = row0[s] + k, c * U + ul
                        # The lane's ring slot: xp's and hp's three gates of (r, u).
                        cols = [q * H + u for q in range(3)]
                        dx, dhp, _ = step(xp[r, cols], hp[r, cols], h_in[r, u], g_y[r, u],
                                          carry[r, u])
                        for q in range(3):
                            buf[r, _slice_pos(q * H + u, L, S)] = dhp[q]
                            written[r, q * H + u] += 1
                        d_xp[r, cols] = dx
                        pairs.append((c, g, s, k, m, r, u))
    assert (written == 1).all()
    np.testing.assert_allclose(d_xp, np.concatenate(d_xp_ref, axis=1), rtol=1e-12, atol=1e-12)
    v4 = buf[:, :S * L].reshape(R, L // 4, S, 4)
    got = np.full((R, H), np.nan)
    for c in range(C):
        ws = _weight_image(lambda k, g, u: w[u, k], U, c * U, dict(cfg, H=H, K=K), 1, UT)
        w4 = ws.reshape(L // 4, UT, NT // S, S, 4)
        red = _reduce_scatter(np.einsum("rjse,jxgse->gsrx", v4, w4)[..., None])
        for cc, g, s, k, m, r, u in pairs:
            if cc == c:
                got[r, u] = (dhz_ref[r, u] + red[g, s, k, m, 0]) * keep[r]
    np.testing.assert_allclose(got, carry_ref, rtol=1e-12, atol=1e-12)
