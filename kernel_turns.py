"""Time two checkouts of the port's kernels and main paths in turns on one
NVIDIA GPU: parent, change, change, parent.

    git archive <parent commit> seqrec_tpu_torch chip_smoke.py configs | tar -x -C <dir>
    python3 kernel_turns.py --parent <dir> [--out FILE]
    python3 kernel_turns.py --parent <dir> --pairs 10 [--path gru4rec] [--out FILE]
    python3 kernel_turns.py --parent <dir> --only rnn [--out FILE]
    python3 kernel_turns.py --parent <dir> --only f32 [--out FILE]

<dir> is a directory that .gitignore lists, inside the checkout or not.

Each turn is a process of its own, started from the root of its checkout
with that root first on sys.path, so it builds and imports that checkout's
kernels (`seqrec_tpu_torch`) and its `chip_smoke.py`, whose timer and
main-path phases it reuses (public names only, which both checkouts must
have). chip_smoke times each kernel of one checkout; this script gives what
it cannot: the parent's and the change's kernels and paths alternated on one
card, on the same inputs, and the serving encode timed on the device alone.
A turn times, by CUDA events (chip_smoke.time_ms, median of 21 runs):

  - kernels at the main paths' shapes: causal attention bf16 and f32 at
    [128, 200, 1, 64] and [64, 200, 1, 64], and past Dh = 256 on q, k and v
    slices of one projection at w1's step ([256, 200, 1, 512] and
    [64, 200, 1, 512]) and at Dh = 1,000 and 257 (B = 32), beside
    F.scaled_dot_product_attention on the same inputs; the f32 GRU forward
    at B=64 and B=128, T=200, D=H=128, beside torch.nn.GRU in f32 (cuDNN,
    TF32 off); the f32 GRU reverse recurrence at B=128, T=200, D=H=128 and
    its keep path at B=256, T=50, D=H=100 (each checkout's kernel on the
    operands its own backward hands it), and the whole GRU backward through
    gru_scan's autograd at both shapes (the bf16 GRU: the recurrences' rows
    below); the f32 input
    projection at M=12,800 and 25,600 with N=384 and N=512 (D=128), beside
    torch.addmm f32 on the same values; the
    sampled-softmax head forward at N=25,600, S=256, H=128, bf16 and f32
    (f32 beside `h @ neg.T` alone), and f32 at beauty's N=6,400, S=256,
    H=256 (a checkout that refuses it records its error); the scatter-add
    (the gather's backward) at 25,600 Zipf ids into the [3418, 128] table,
    unpadded and padded as the training path pads (about half of the
    positions on the padding row), and at rsc15's 12,800 ids into
    [37,484, 100] and beauty's 6,400 into [12,102, 256], each beside
    index_add_ and with its ids on the heaviest row; the gather from an f32
    table into bf16 and f32 at serving's [64, 200] ids, training's
    [128, 200] and the 256 negatives, D=64 and 128 (a checkout whose gather
    takes no dtype: its gather, then .to(dtype), as its model did), beside
    F.embedding then .to(dtype), and the scatter-add on a bf16 cotangent
    at the training shape, padded (a checkout that widens it first: its
    widening and its kernel);
    the LSTM forward bf16 and f32 (projection included) at B=64 and B=128,
    its reset variant bf16 and f32 at B=128, beside torch.nn.LSTM in f32 (cuDNN,
    TF32 off) forward and backward (fwd+bwd - fwd) on the same inputs; the
    LSTM reverse recurrence bf16 and f32 at B=128, without and with a keep
    plane; the f32 GRU forward (projection included) at B=64 and B=128 and
    its reset variant at B=256, T=50, D=H=100;
  - the main paths, through chip_smoke's phases: GRU4Rec, SASRec and LSTM
    serving (encode ms and batch ms), GRU4Rec, SASRec and LSTM training
    (device forward and step ms, the wall step ms and the device launches a
    step), rsc15_gru4rec and ml1m_lstm session training (the same), and the
    f32 paths (model.compute_dtype=float32 on ml1m_gru4rec, ml1m_sasrec and
    ml1m_lstm for serving and training, SASRec's warmup 0; a checkout whose
    phase_serve takes no overrides gets them through its RunConfig.load);
    and
    each serving model's
    `encode` of one batch of 64 behind a ~30 ms device sleep
    (`encode_device_ms`), so that the events bracket the device's work even
    where the host takes longer than chip_smoke's ~1 ms sleep to queue a
    batch's launches (SASRec's encode).

The attention, head, scatter-add, gather and LSTM rows also carry a digest
(sha1) of their outputs, as the recurrences' rows do: `same_bits` in the
last line says where parent and change agree bit for bit. The rows that
the bf16 input projection feeds (the bf16 GRU and LSTM forwards, the
projection alone) keep their outputs from each label's first turn in a
temporary directory, and `differences` gives, for each of them whose bits
changed, the largest difference from the parent's output beside the row's
bf16 tolerance. The reverse recurrences' rows take their operands from the
plain forward, so that no kernel of the turn feeds them.

Every turn also times the recurrences' rows (`_rnn_rows`, alone with
--only rnn, a turn of ~1 minute): the bf16 GRU forward (gru_scan, the
projection included) at B=64 and 128, T=200, D=H=128, its reset variant at
B=256, T=50, D=H=100, and at beauty_gru's step, B=64 and 128, T=50,
D=H=256; the bf16 GRU reverse recurrence (gru_backward on the operands of
reference.gru_bwd_project, the whole backward through autograd too) at
B=128, T=200, H=128, its keep path at B=256, T=50, H=100 and at B=128,
T=50, H=256; each with a digest (sha1) of its outputs, so that the turns
show bit for bit where parent and change agree; beside torch.nn.GRU in
bf16 and in f32 (TF32 off) on the same values, forward and forward +
backward - forward; and torch.nn.LSTM in bf16 at the LSTM's main shapes
(B=64 and 128, T=200, D=H=128; its backward at B=128), the bf16 library
times of the LSTM's rows; and past the grid limits in bf16 (the stepped
layouts) the GRU and LSTM forwards (the projection included, and timed
alone) and reverse recurrences (and the device memory a reverse call takes
beyond its inputs)
at w3's step (B=256, T=200, D=H=2,304; nn.GRU / nn.LSTM in bf16
and cuDNN's backward beside them) and at the stepped edges (B=16, T=20,
D=64, H at each cell's bf16 grid limit + 4: 2,116 and 1,796), each with a
digest; and the bf16 input projection alone (each checkout's wrapper) at
XPROJ_ROWS (the narrow GRU and LSTM, rsc15, d = 52, the wide towers and w3),
beside its plain version and torch.addmm(..., out_dtype=torch.float32);
and the f32 FMA GEMM's rows (`_f32_gemm_rows`): the f32 input projection
alone at XPROJ_ROWS beside torch.addmm in f32, the f32 step GEMM alone at
w3's widths with M = 256, 64 and 16 beside torch.mm in f32, and the f32
stepped forwards (the projection included) and reverses at w3's step, at
its serving batch (B=64) and at the f32 stepped edge (B=16, T=20, D=64,
H=1,060) with nn.GRU / nn.LSTM in f32 and cuDNN's backward beside them at
w3, each with a digest (its outputs kept; with --only f32 these rows
alone);
and the grid layouts' bf16 forwards (the projection included) at the wide
towers' step (B=256, T=200, D=H=512), nn.GRU / nn.LSTM in bf16 beside them;
and the grid layouts' f32 forwards (the projection included; `_grid_f32_rows`)
at the wide step, at rsc15's reset shape with 1,000 units (B=256, T=50) and at
ml1m_lstm's (B=128, T=200, H=512), each with a digest (its outputs kept) and
its bound, nn.GRU / nn.LSTM in f32 (TF32 off) beside the wide ones, and the
f32 input projection alone at the wide step (M = 51,200, D = 512, N = 1,536
and 2,048) beside torch.addmm in f32, so that a forward's row splits into
projection and recurrence.

With --pairs N, a turn is only one training path (--path, a chip_smoke
CONFIGS key, default gru4rec): chip_smoke.phase_train with two groups, its
device step split (CUDA events, median of a group of 8 steps), wall step and
device launches a step; N pairs of turns, the order alternating (parent
first in even pairs), for a difference smaller than the four-turn run's
spread.

The last line is one JSON object: {"device": ..., "turns": [{"label",
"root", "kernels": {...}, "paths": {...}}, ...]} (with --pairs, each turn
{"label", "root", "pair", "path": {...}}). It exits non-zero without CUDA or
when a turn fails.
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ORDER = ("parent", "change", "change", "parent")
RESET_EVERY = 6  # a session start about every 6 positions, as chip_smoke's rsc15 planes
F32 = "model.compute_dtype=float32"


def _serve(cs, dev, path: str, requests: list, overrides=()) -> dict:
    """chip_smoke.phase_serve on `path` with `overrides`, also in a checkout
    whose phase_serve takes none (its RunConfig.load applies them)."""
    if not overrides or "overrides" in inspect.signature(cs.phase_serve).parameters:
        return cs.phase_serve(dev, 0, path, requests, **({"overrides": overrides}
                                                         if overrides else {}))
    real = cs.RunConfig

    class _Over:
        @staticmethod
        def load(p):
            return real.load(p).apply_overrides(list(overrides))

    cs.RunConfig = _Over
    try:
        return cs.phase_serve(dev, 0, path, requests)
    finally:
        cs.RunConfig = real


def _path_worker(label: str, path: str) -> dict:
    """One training path's step on this checkout, on the data of rng 1."""
    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    over = {"sasrec": ("train.warmup_steps=0",)}.get(path, ())
    r = cs.phase_train(np.random.default_rng(1), torch.device("cuda", 0), 0, path, groups=2,
                       overrides=over)
    return {"label": label, "root": str(Path.cwd()),
            "path": {"device_step_ms": r["device_step_ms"], "step_ms": r["step_ms_median"],
                     "device_launches_per_step": r["profile"]["device_launches_per_step"]}}


def _digest(ts, keep: str = "") -> str:
    """sha1 of the tensors' bytes: equal digests are equal bits. `keep`: a
    row whose outputs the bf16 input projection or the f32 grid forwards'
    step product feed; the first turn of
    each label saves them as $KERNEL_TURNS_KEEP/<label>/<keep>.pt (the
    directory main makes), so that the last line can give the change's
    largest difference from the parent's."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    root = os.environ.get("KERNEL_TURNS_KEEP")
    if keep and root:
        path = Path(root) / os.environ["KERNEL_TURNS_LABEL"] / f"{keep}.pt"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save([t.detach().cpu() for t in ts], path)
    return h.hexdigest()


# The bf16 input projection's shapes (M, D, N), as chip_smoke.py's phases
# c, g and w hold it: the narrow GRU and LSTM (serving's B=64 and
# training's B=128, T=200, D=128), rsc15 (B=256, T=50, D=100), d = 50
# padded to 52 (B=128, T=200), the wide towers (B=256, T=200, D=512) and w3
# (D=2,304); N = 3H (GRU) and 4H (LSTM), H = D.
XPROJ_ROWS = {"gru_B64": (12800, 128, 384), "gru_B128": (25600, 128, 384),
              "lstm_B64": (12800, 128, 512), "lstm_B128": (25600, 128, 512),
              "gru_rsc15": (12800, 100, 300), "gru_d52": (25600, 52, 156),
              "lstm_d52": (25600, 52, 208), "gru_wide": (51200, 512, 1536),
              "lstm_wide": (51200, 512, 2048), "gru_w3": (51200, 2304, 6912),
              "lstm_w3": (51200, 2304, 9216)}


def _xproj_rows(rng, dev) -> dict:
    """The bf16 input projection alone at XPROJ_ROWS through each checkout's
    wrapper (ms, a digest, its outputs kept), beside its plain version and
    torch.addmm(b, x, w_x, out_dtype=torch.float32), with its bound."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    med = lambda fn: cs.time_ms(fn)["median"]  # noqa: E731
    rows = {}
    for label, (M, D, N) in XPROJ_ROWS.items():
        x = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(M, D)).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        w = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(D, N)).astype(np.float32))
        w = w.to(dev, torch.bfloat16)
        b = torch.from_numpy(rng.normal(scale=0.1, size=N).astype(np.float32)).to(dev)
        project = (k_lstm.lstm_input_projection if label.startswith("lstm")
                   else k_gru.gru_input_projection)
        flops, nbytes = 2.0 * M * D * N, (M * D + D * N) * 2 + N * 4 + M * N * 4
        rows[f"xproj_bfloat16_{label}"] = {
            "M": M, "D": D, "N": N, "ms": med(lambda: project(x, w, b)),
            "digest": _digest([project(x, w, b)], keep=f"xproj_bfloat16_{label}"),
            "plain_ms": med(lambda: k_gru.plain_input_projection(x, w, b)),
            "addmm_out_f32_ms": med(lambda: torch.addmm(b, x, w, out_dtype=torch.float32)),
            "bound_ms": max(flops / cs.PEAK_FLOPS[torch.bfloat16],
                            nbytes / cs.HBM_BYTES_PER_S) * 1e3}
        del x, w, b
    torch.cuda.empty_cache()
    return rows


# The f32 grid forwards' rows (key: cell, B, T, H, reset): the wide step
# (B=256, T=200, D=H=512, GRU and LSTM), rsc15's reset shape with 1,000
# units (the GRU, B=256, T=50) and ml1m_lstm's reset shape (B=128, T=200,
# D=H=512); and the f32 input projection alone at the wide step (M = 51,200,
# D = 512, N = 3H and 4H).
GRID_F32_ROWS = {"gru_grid_float32_wide_B256_T200_H512": ("gru", 256, 200, 512, False),
                 "lstm_grid_float32_wide_B256_T200_H512": ("lstm", 256, 200, 512, False),
                 "gru_grid_float32_rsc15_B256_T50_H1000_reset": ("gru", 256, 50, 1000, True),
                 "lstm_grid_float32_ml1m_B128_T200_H512_reset": ("lstm", 128, 200, 512, True)}
XPROJ_F32_ROWS = {"gru_wide": (51200, 512, 1536), "lstm_wide": (51200, 512, 2048)}


def _grid_f32_rows(dev) -> dict:
    """The f32 grid forwards (gru_scan / lstm_scan, the projection included)
    at GRID_F32_ROWS on the data of rng 3, with a carried-in state: ms, a
    digest (its outputs kept: ys, and c_last for the LSTM), the bound
    (chip_smoke's: the projection's and the recurrence's FMAs at the f32
    peak, beside the bytes) and, without a reset, nn.GRU / nn.LSTM in f32
    (cuDNN, TF32 off) on the same values; then the f32 input projection
    alone at XPROJ_F32_ROWS (each checkout's wrapper, a digest), beside
    torch.addmm in f32."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    med = lambda fn: cs.time_ms(fn)["median"]  # noqa: E731
    f32 = torch.float32
    rows = {}
    for key, (cell, B, T, H, reset) in GRID_F32_ROWS.items():
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        plane = cs._reset_plane(rng, B, T, dev) if reset else None
        G = 3 if cell == "gru" else 4
        flops = 2.0 * B * T * 2 * H * G * H
        nbytes = (2 * B * T * H + 2 * H * G * H + B * H) * 4 + B * T * 4 * reset
        rec = {"B": B, "T": T, "D": H, "H": H, "reset": reset,
               "bound_ms": max(flops / cs.PEAK_FLOPS[f32], nbytes / cs.HBM_BYTES_PER_S) * 1e3}
        with torch.no_grad():
            if cell == "gru":
                w = [t.to(dev) for t in cs.gru_weights(rng, H, H)]
                h0 = cs._state(rng, dev, B, H)
                fn = lambda: k_gru.gru_scan(x, h0, *w, reset_mask=plane)  # noqa: E731
                rec.update(ms=med(fn), digest=_digest([fn()[0]], keep=key))
                if not reset:
                    lib = torch.nn.GRU(H, H, batch_first=True, device=dev, dtype=f32)
                    lib.weight_ih_l0.copy_(w[0].T)
                    lib.weight_hh_l0.copy_(w[1].T)
                    lib.bias_ih_l0.copy_(w[2])
                    lib.bias_hh_l0.copy_(w[3])
                    rec["nn_gru_float32_ms"] = med(lambda: lib(x, h0[None]))
            else:
                w_x, w_h, b = (t.to(dev) for t in cs.lstm_weights(rng, H, H))
                s0 = (cs._state(rng, dev, B, H), cs._state(rng, dev, B, H))
                fn = lambda: k_lstm.lstm_scan(x, *s0, w_x, w_h, b, reset_mask=plane)  # noqa: E731
                ys, (_, c_last) = fn()
                rec.update(ms=med(fn), digest=_digest([ys, c_last], keep=key))
                if not reset:
                    lib = torch.nn.LSTM(H, H, batch_first=True, device=dev, dtype=f32)
                    lib.weight_ih_l0.copy_(w_x.T)
                    lib.weight_hh_l0.copy_(w_h.T)
                    lib.bias_ih_l0.copy_(b)
                    lib.bias_hh_l0.zero_()
                    rec["nn_lstm_float32_ms"] = med(lambda: lib(x, (s0[0][None], s0[1][None])))
        rows[key] = rec
        del x, plane
    for label, (M, D, N) in XPROJ_F32_ROWS.items():
        x = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(M, D)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(D, N)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(scale=0.1, size=N).astype(np.float32)).to(dev)
        project = (k_lstm.lstm_input_projection if label.startswith("lstm")
                   else k_gru.gru_input_projection)
        flops, nbytes = 2.0 * M * D * N, (M * D + D * N + N + M * N) * 4
        rows[f"xproj_float32_{label}"] = {
            "M": M, "D": D, "N": N, "ms": med(lambda: project(x, w, b)),
            "digest": _digest([project(x, w, b)]),
            "addmm_ms": med(lambda: torch.addmm(b, x, w)),
            "bound_ms": max(flops / cs.PEAK_FLOPS[f32], nbytes / cs.HBM_BYTES_PER_S) * 1e3}
        del x, w, b
    torch.cuda.empty_cache()
    return rows


# The f32 stepped layouts' rows (label, B, T, D, H): w3's step, its
# serving batch and the stepped edge (H at the f32 grid limit + 4, both
# cells).
STEPPED_F32_ROWS = (("w3", 256, 200, 2304, 2304), ("serve", 64, 200, 2304, 2304),
                    ("edge", 16, 20, 64, 1060))
# The f32 step GEMM alone at w3's widths: (label, M) of the training
# batch, the serving batch and the stepped edge's batch.
STEP_GEMM_F32_ROWS = (("w3", 256), ("B64", 64), ("B16", 16))


def _f32_gemm_rows(dev) -> dict:
    """The f32 FMA GEMM's rows (csrc/fma_gemm.cuh in a checkout that has
    it), on the data of rng 4: the f32 input projection alone at XPROJ_ROWS
    (but the wide towers', `_grid_f32_rows`' own) beside torch.addmm in
    f32; the f32 step GEMM alone at w3's step (h @ W_h and d @ W_h^T; a
    checkout without `step_gemm_f32` runs its stepped scans' step GEMM,
    the f32 projection with zero bias) beside torch.mm in f32; and the f32
    stepped forwards (the projection included, also timed alone) and
    reverse recurrences at STEPPED_F32_ROWS, nn.GRU / nn.LSTM in f32 and
    cuDNN's backward beside them at w3; each with a digest, its outputs
    kept. TF32 off."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import reference
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    med = lambda fn: cs.time_ms(fn)["median"]  # noqa: E731
    f32 = torch.float32
    rows = {}

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(np.float32)).to(dev)

    for label, (M, D, N) in XPROJ_ROWS.items():
        if label in XPROJ_F32_ROWS:
            continue
        x, w, b = t(M, D, scale=D ** -0.5), t(D, N, scale=D ** -0.5), t(N, scale=0.1)
        project = (k_lstm.lstm_input_projection if label.startswith("lstm")
                   else k_gru.gru_input_projection)
        flops, nbytes = 2.0 * M * D * N, (M * D + D * N + N + M * N) * 4
        key = f"xproj_float32_{label}"
        rows[key] = {"M": M, "D": D, "N": N, "ms": med(lambda: project(x, w, b)),
                     "digest": _digest([project(x, w, b)], keep=key),
                     "addmm_ms": med(lambda: torch.addmm(b, x, w)),
                     "bound_ms": max(flops / cs.PEAK_FLOPS[f32],
                                     nbytes / cs.HBM_BYTES_PER_S) * 1e3}
        del x, w, b
    H = 2304
    for (tag, M), (cell, G), way in itertools.product(
            STEP_GEMM_F32_ROWS, (("gru", 3), ("lstm", 4)), ("forward", "reverse")):
        K, N = (G * H, H) if way == "reverse" else (H, G * H)
        a, w = t(M, K, scale=1e-2 if way == "reverse" else 1.0), t(K, N, scale=K ** -0.5)
        if hasattr(k_gru, "step_gemm_f32"):
            fn = lambda: k_gru.step_product(k_gru.step_gemm_f32(a, w))  # noqa: E731
            gemm = lambda: k_gru.step_gemm_f32(a, w)  # noqa: E731
        else:
            zeros = torch.zeros(N, device=dev)
            fn = gemm = lambda: k_gru.gru_input_projection(a, w, zeros)  # noqa: E731
        flops, nbytes = 2.0 * M * K * N, (M * K + K * N + M * N) * 4
        rows[f"step_gemm_float32_{cell}_{way}_{tag}"] = {
            "M": M, "K": K, "N": N, "ms": med(gemm), "digest": _digest([fn()]),
            "mm_ms": med(lambda: torch.mm(a, w)),
            "bound_ms": max(flops / cs.PEAK_FLOPS[f32], nbytes / cs.HBM_BYTES_PER_S) * 1e3}
        del a, w
    for label, B, T, D, H in STEPPED_F32_ROWS:
        x = cs._zipf_embeddings(rng, dev, B, T, D)
        g = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02
        w = [t_.to(dev) for t_ in cs.gru_weights(rng, D, H)]
        h0 = torch.zeros(B, H, device=dev)
        key = f"gru_stepped_float32_{label}_B{B}_T{T}_H{H}"
        with torch.no_grad():
            rec = {"ms": med(lambda: k_gru.gru_scan(x, h0, *w)),
                   "digest": _digest([k_gru.gru_scan(x, h0, *w)[0]], keep=key),
                   "input_projection_ms": med(lambda: k_gru.gru_input_projection(x, w[0], w[2]))}
        if label == "w3":
            lib = torch.nn.GRU(D, H, batch_first=True, device=dev, dtype=f32)
            with torch.no_grad():
                lib.weight_ih_l0.copy_(w[0].T)
                lib.weight_hh_l0.copy_(w[1].T)
                lib.bias_ih_l0.copy_(w[2])
                lib.bias_hh_l0.copy_(w[3])
            xg = x.clone().requires_grad_(True)
            fw = med(lambda: lib(xg, h0[None])[0])
            rec.update(nn_gru_float32_ms=fw, nn_gru_float32_backward_ms=med(
                lambda: lib(xg, h0[None])[0].backward(g)) - fw)
            del lib, xg
        rows[key] = rec
        w_x, w_h, b_x, b_h = w
        with torch.no_grad():  # the operands from the plain forward, no kernel of the turn
            ys = k_gru.plain(x, h0, w_x, w_h, b_x, b_h)[0]
            x_proj = torch.matmul(x, w_x) + b_x
            h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, h0, w_h, b_h, None)
        args = (x_proj, h_proj, h_in, g, w_h, keep)
        key = f"gru_backward_stepped_float32_{label}_B{B}_T{T}_H{H}"
        rows[key] = {"ms": med(lambda: k_gru.gru_backward(*args)),
                     "digest": _digest(k_gru.gru_backward(*args), keep=key)}
        del w, ys, x_proj, h_in, h_proj, args
        w_x, w_h, b = (t_.to(dev) for t_ in cs.lstm_weights(rng, D, H))
        state = (torch.zeros(B, H, device=dev), torch.zeros(B, H, device=dev))
        key = f"lstm_stepped_float32_{label}_B{B}_T{T}_H{H}"
        with torch.no_grad():
            ys, (_, c_last) = k_lstm.lstm_scan(x, *state, w_x, w_h, b)
            rec = {"ms": med(lambda: k_lstm.lstm_scan(x, *state, w_x, w_h, b)),
                   "digest": _digest([ys, c_last], keep=key),
                   "input_projection_ms": med(lambda: k_lstm.lstm_input_projection(x, w_x, b))}
        del ys, c_last
        if label == "w3":
            lib = torch.nn.LSTM(D, H, batch_first=True, device=dev, dtype=f32)
            with torch.no_grad():
                lib.weight_ih_l0.copy_(w_x.T)
                lib.weight_hh_l0.copy_(w_h.T)
                lib.bias_ih_l0.copy_(b)
                lib.bias_hh_l0.zero_()
            xg = x.clone().requires_grad_(True)
            s0 = (state[0][None], state[1][None])
            fw = med(lambda: lib(xg, s0)[0])
            rec.update(nn_lstm_float32_ms=fw, nn_lstm_float32_backward_ms=med(
                lambda: lib(xg, s0)[0].backward(g)) - fw)
            del lib, xg
        rows[key] = rec
        # The reverse on gate planes in the forward's ranges.
        i_, f_, o_, gp = (torch.from_numpy(rng.uniform(0.05, 0.95, size=(B, T, H))
                                           .astype(np.float32)).to(dev) for _ in range(4))
        g_ = torch.tanh(gp * 4 - 2)
        tanh_c = torch.tanh(cs._state(rng, dev, B * T, H).reshape(B, T, H))
        c_in = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 2
        largs = (i_, f_, g_, o_, tanh_c, c_in, g, w_h, None, state[1])
        key = f"lstm_backward_stepped_float32_{label}_B{B}_T{T}_H{H}"
        rows[key] = {"ms": med(lambda: k_lstm.lstm_backward(*largs)),
                     "digest": _digest(k_lstm.lstm_backward(*largs), keep=key)}
        del i_, f_, o_, gp, g_, tanh_c, c_in, largs, x, g
        torch.cuda.empty_cache()
    return rows


def _rnn_rows() -> dict:
    """The recurrences' rows of a turn (see the module note), on the data
    of rng 2: kernel ms, digests of the outputs and the library times."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import reference
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    med = lambda fn: cs.time_ms(fn)["median"]  # noqa: E731
    bf16, f32 = torch.bfloat16, torch.float32

    digest = _digest

    def nn_rnn(cls, w_x, w_h, b_x, b_h, dtype):
        lib = cls(w_x.shape[0], w_h.shape[0], batch_first=True, device=dev, dtype=dtype)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_x.T)
            lib.weight_hh_l0.copy_(w_h.T)
            lib.bias_ih_l0.copy_(b_x)
            lib.bias_hh_l0.copy_(b_h)
        return lib

    def library(cls, x, state, w, g, dtypes=(bf16, f32)):
        """nn.GRU / nn.LSTM in `dtypes`: forward ms, fwd+bwd - fwd ms."""
        rec = {}
        for dtype in dtypes:
            lib = nn_rnn(cls, *w, dtype)
            xd = x.to(dtype).detach().clone().requires_grad_(True)
            sd = tuple(t.to(dtype)[None] for t in state)
            sd = sd[0] if cls is torch.nn.GRU else sd
            gd = g.to(dtype)
            fw = med(lambda: lib(xd, sd)[0])
            rec[f"nn_{cls.__name__.lower()}_{str(dtype)[6:]}_ms"] = fw
            rec[f"nn_{cls.__name__.lower()}_{str(dtype)[6:]}_backward_ms"] = med(
                lambda: lib(xd, sd)[0].backward(gd)) - fw
        return rec

    rows = {}
    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False), (256, 50, 100, True),
                           (64, 50, 256, False), (128, 50, 256, False)):
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        w = [t.to(dev) for t in cs.gru_weights(rng, H, H)]
        h0 = cs._state(rng, dev, B, H)
        plane = cs._reset_plane(rng, B, T, dev) if reset else None
        g = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02
        xb, hb = x.bfloat16(), h0.bfloat16()
        key = f"gru_bfloat16_B{B}_T{T}_H{H}" + ("_reset" if reset else "")
        rec = {"ms": med(lambda: k_gru.gru_scan(xb, hb, *w, reset_mask=plane)),
               "digest": digest([k_gru.gru_scan(xb, hb, *w, reset_mask=plane)[0]], keep=key)}
        if not reset:
            rec.update(library(torch.nn.GRU, x, (h0,), w, g))
        rows[key] = rec
        if (B, T) in ((64, 200), (64, 50)):
            continue
        # The reverse recurrence on the operands the backward hands it, and
        # the whole backward through autograd.
        w_x, w_h, b_x, b_h = w
        wxb, whb = w_x.bfloat16(), w_h.bfloat16()
        gb = g.bfloat16()
        with torch.no_grad():  # the operands from the plain forward, no kernel of the turn
            ys = k_gru.plain(xb, hb, wxb, whb, b_x, b_h, reset_mask=plane)[0]
            x_proj = torch.matmul(xb.float(), wxb.float()) + b_x
            h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, hb, whb, b_h, plane)
        args = (x_proj, h_proj, h_in, gb, whb, keep)
        leaves = [t.clone().requires_grad_(True) for t in (xb, hb, *w)]
        ys_a = k_gru.gru_scan(*leaves, reset_mask=plane)[0]
        rows[f"gru_backward_bfloat16_B{B}_T{T}_H{H}" + ("_keep" if reset else "")] = {
            "ms": med(lambda: k_gru.gru_backward(*args)),
            "digest": digest(k_gru.gru_backward(*args)),
            "autograd_backward_ms": med(
                lambda: torch.autograd.backward(ys_a, gb, retain_graph=True))}
    for B in (64, 128):
        x = cs._zipf_embeddings(rng, dev, B, 200, 128)
        w_x, w_h, b = (t.to(dev) for t in cs.lstm_weights(rng, 128, 128))
        state = (cs._state(rng, dev, B, 128), cs._state(rng, dev, B, 128))
        g = cs._state(rng, dev, B * 200, 128).reshape(B, 200, 128) * 0.02
        rows[f"nn_lstm_B{B}_T200_H128"] = library(
            torch.nn.LSTM, x, state, (w_x, w_h, b, torch.zeros_like(b)), g)

    def peak_over(fn) -> int:
        """Device memory a call takes at its peak beyond what was allocated
        before it (its outputs and scratch)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - before

    # Above H = 256, bf16: the grid layouts' forwards (the projection
    # included) at the wide towers' step (B=256, T=200, D=H=512), with
    # nn.GRU / nn.LSTM in bf16 beside them.
    B, T, H = 256, 200, 512
    x = cs._zipf_embeddings(rng, dev, B, T, H)
    xb = x.bfloat16()
    w = [t.to(dev) for t in cs.gru_weights(rng, H, H)]
    h0 = torch.zeros(B, H, device=dev)
    hb = h0.bfloat16()
    key = f"gru_grid_bfloat16_wide_B{B}_T{T}_H{H}"
    lib = nn_rnn(torch.nn.GRU, *w, bf16)
    with torch.no_grad():
        rows[key] = {"ms": med(lambda: k_gru.gru_scan(xb, hb, *w)),
                     "digest": digest([k_gru.gru_scan(xb, hb, *w)[0]], keep=key),
                     "nn_gru_bfloat16_ms": med(lambda: lib(xb, hb[None]))}
    w_x, w_h, b = (t.to(dev) for t in cs.lstm_weights(rng, H, H))
    sb = (hb, hb)
    with torch.no_grad():
        ys, (_, c_last) = k_lstm.lstm_scan(xb, *sb, w_x, w_h, b)
        key = f"lstm_grid_bfloat16_wide_B{B}_T{T}_H{H}"
        lib = nn_rnn(torch.nn.LSTM, w_x, w_h, b, torch.zeros_like(b), bf16)
        rows[key] = {"ms": med(lambda: k_lstm.lstm_scan(xb, *sb, w_x, w_h, b)),
                     "digest": digest([ys, c_last], keep=key),
                     "nn_lstm_bfloat16_ms": med(lambda: lib(xb, (hb[None], hb[None])))}
    del x, xb, w, ys, c_last, lib

    # Past the grid limits, bf16: the stepped layouts at w3's step and at the
    # stepped edges, forward (the projection included) and reverse (with the
    # peak memory a call takes), with nn.GRU / nn.LSTM in bf16 and cuDNN's
    # backward beside them at w3.
    for label, B, T, D, Hg, Hl in (("w3", 256, 200, 2304, 2304, 2304),
                                   ("edge", 16, 20, 64, 2116, 1796)):
        x = cs._zipf_embeddings(rng, dev, B, T, D)
        xb = x.bfloat16()
        w = [t.to(dev) for t in cs.gru_weights(rng, D, Hg)]
        h0 = torch.zeros(B, Hg, device=dev)
        hb = h0.bfloat16()
        g = cs._state(rng, dev, B * T, Hg).reshape(B, T, Hg) * 0.02
        key = f"gru_stepped_bfloat16_{label}_B{B}_T{T}_H{Hg}"
        rec = {"ms": med(lambda: k_gru.gru_scan(xb, hb, *w)),
               "digest": digest([k_gru.gru_scan(xb, hb, *w)[0]], keep=key)}
        if label == "w3":
            rec.update(library(torch.nn.GRU, x, (h0,), w, g, dtypes=(bf16,)))
        rows[key] = rec
        w_x, w_h, b_x, b_h = w
        wxb, whb, gb = w_x.bfloat16(), w_h.bfloat16(), g.bfloat16()
        rec["input_projection_ms"] = med(lambda: k_gru.gru_input_projection(xb, wxb, b_x))
        with torch.no_grad():  # the operands from the plain forward, no kernel of the turn
            ys = k_gru.plain(xb, hb, wxb, whb, b_x, b_h)[0]
            x_proj = torch.matmul(xb.float(), wxb.float()) + b_x
            h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, hb, whb, b_h, None)
        args = (x_proj, h_proj, h_in, gb, whb, keep)
        rows[f"gru_backward_stepped_bfloat16_{label}_B{B}_T{T}_H{Hg}"] = {
            "ms": med(lambda: k_gru.gru_backward(*args)),
            "digest": digest(k_gru.gru_backward(*args)),
            "peak_bytes_over_inputs": peak_over(lambda: k_gru.gru_backward(*args))}
        del w, g, gb, ys, x_proj, h_in, h_proj, args
        w_x, w_h, b = (t.to(dev) for t in cs.lstm_weights(rng, D, Hl))
        state = (torch.zeros(B, Hl, device=dev), torch.zeros(B, Hl, device=dev))
        sb = tuple(t.bfloat16() for t in state)
        ys, (_, c_last) = k_lstm.lstm_scan(xb, *sb, w_x, w_h, b)
        wxl = w_x.bfloat16()
        key = f"lstm_stepped_bfloat16_{label}_B{B}_T{T}_H{Hl}"
        rec = {"ms": med(lambda: k_lstm.lstm_scan(xb, *sb, w_x, w_h, b)),
               "digest": digest([ys, c_last], keep=key),
               "input_projection_ms": med(lambda: k_lstm.lstm_input_projection(xb, wxl, b))}
        del ys, c_last
        if label == "w3":
            g = cs._state(rng, dev, B * T, Hl).reshape(B, T, Hl) * 0.02
            rec.update(library(torch.nn.LSTM, x, state, (w_x, w_h, b, torch.zeros_like(b)), g,
                               dtypes=(bf16,)))
            del g
        rows[key] = rec
        # The reverse on gate planes in the forward's ranges.
        i_, f_, o_, gp = (torch.from_numpy(rng.uniform(0.05, 0.95, size=(B, T, Hl))
                                           .astype(np.float32)).to(dev) for _ in range(4))
        g_ = torch.tanh(gp * 4 - 2)
        tanh_c = torch.tanh(cs._state(rng, dev, B * T, Hl).reshape(B, T, Hl))
        c_in = cs._state(rng, dev, B * T, Hl).reshape(B, T, Hl) * 2
        g_ys = (cs._state(rng, dev, B * T, Hl).reshape(B, T, Hl) * 0.02).bfloat16()
        whb = w_h.bfloat16()
        largs = (i_, f_, g_, o_, tanh_c, c_in, g_ys, whb, None, state[1])
        rows[f"lstm_backward_stepped_bfloat16_{label}_B{B}_T{T}_H{Hl}"] = {
            "ms": med(lambda: k_lstm.lstm_backward(*largs)),
            "digest": digest(k_lstm.lstm_backward(*largs)),
            "peak_bytes_over_inputs": peak_over(lambda: k_lstm.lstm_backward(*largs))}
        del i_, f_, o_, gp, g_, tanh_c, c_in, g_ys, largs, x, xb
    rows.update(_xproj_rows(rng, dev))
    rows.update(_grid_f32_rows(dev))
    rows.update(_f32_gemm_rows(dev))
    return rows


def _worker(label: str, only: str = "") -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.config import RunConfig
    from seqrec_tpu_torch.eval import infer
    from seqrec_tpu_torch.models import build_model
    from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
    from seqrec_tpu_torch.ops import _build, reference
    from seqrec_tpu_torch.ops.cuda import attention as k_attn
    from seqrec_tpu_torch.ops.cuda import gather as k_gather
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import head as k_head
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if only in ("rnn", "f32"):
        _build.build(["gru", "lstm"])
        rows = _rnn_rows() if only == "rnn" else _f32_gemm_rows(dev)
        return {"label": label, "root": str(Path.cwd()), "kernels": rows, "paths": {}}
    _build.build()
    rng = np.random.default_rng(0)
    med = lambda fn: cs.time_ms(fn)["median"]  # noqa: E731
    dname = lambda dtype: str(dtype).split(".")[-1]  # noqa: E731
    kern = {}

    def zipf_embeddings(B, T, D):  # rows of a random [VOCAB, D] table at Zipf ids
        table = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(cs.VOCAB, D))
                                 .astype(np.float32))
        ids = torch.from_numpy(cs.zipf_items(rng, B * T).astype(np.int64))
        return table[ids].reshape(B, T, D).to(dev)

    def state(B, H):  # a carried-in recurrent state, N(0, 0.5)
        return torch.from_numpy(rng.normal(scale=0.5, size=(B, H)).astype(np.float32)).to(dev)

    for Bq, dtype in ((128, torch.bfloat16), (64, torch.bfloat16), (128, torch.float32),
                      (64, torch.float32)):
        q, k, v = (torch.from_numpy(rng.normal(size=(Bq, 200, 1, 64)).astype(np.float32))
                   .to(dev, dtype) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kern[f"attention_{dname(dtype)}_B{Bq}"] = {
            "ms": med(lambda: k_attn.causal_attention(q, k, v)),
            "digest": _digest([k_attn.causal_attention(q, k, v)]),
            "sdpa_ms": med(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))}
    # Past Dh = 256 (the Dh-cluster layout; the Dh-sliced one before it), on
    # inputs of their own: q, k and v slices of one [B, 200, 3, 1, Dh]
    # projection, as the SASRec block reads them.
    wide_rng = np.random.default_rng(25)
    for row, Bq, Dh in (("w1_B256", 256, 512), ("w1_B64", 64, 512),
                        ("Dh1000_B32", 32, 1000), ("Dh257_B32", 32, 257)):
        proj = torch.from_numpy(wide_rng.normal(size=(Bq, 200, 3, 1, Dh))
                                .astype(np.float32)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = proj.to(dtype).unbind(2)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            kern[f"attention_{dname(dtype)}_{row}"] = {
                "ms": med(lambda: k_attn.causal_attention(q, k, v)),
                "digest": _digest([k_attn.causal_attention(q, k, v)]),
                "sdpa_ms": med(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))}
        del proj, q, k, v, qt, kt, vt

    def gru_inputs(Bg, T, D):
        w_x, w_h, b_x, b_h = (w.to(dev) for w in cs.gru_weights(rng, D, D))
        return zipf_embeddings(Bg, T, D), state(Bg, D), (w_x, w_h, b_x, b_h)

    # The f32 GRU rows (the bf16 ones are _rnn_rows').
    for Bg, dtype in ((64, torch.float32), (128, torch.float32)):
        x, h0, (w_x, w_h, b_x, b_h) = gru_inputs(Bg, 200, 128)
        xd, hd = x.to(dtype), h0.to(dtype)
        rec = {"ms": med(lambda: k_gru.gru_scan(xd, hd, w_x, w_h, b_x, b_h))}
        lib = torch.nn.GRU(128, 128, batch_first=True, device=dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_x.T)
            lib.weight_hh_l0.copy_(w_h.T)
            lib.bias_ih_l0.copy_(b_x)
            lib.bias_hh_l0.copy_(b_h)
            rec["nn_gru_f32_ms"] = med(lambda: lib(x, h0[None]))
        kern[f"gru_{dname(dtype)}_B{Bg}"] = rec

    x, h0, w = gru_inputs(256, 50, 100)
    reset = torch.from_numpy((rng.random((256, 50)) < 1 / RESET_EVERY)
                             .astype(np.float32)).to(dev)
    kern["gru_reset_float32_B256_rsc15"] = {
        "ms": med(lambda: k_gru.gru_scan(x, h0, *w, reset_mask=reset))}

    def gru_reverse(x, h0, w, reset=None, dtype=torch.float32):
        """(ms of the reverse-recurrence kernel, ms of the whole backward
        through gru_scan's autograd) in `dtype`, on a kernel forward: the kernel on
        the operands the checkout's own backward hands it, the two projections
        of reference.gru_bwd_project (a wrapper that recomputes the gates
        inside) or, in a checkout whose wrapper takes the gate planes, those
        of its reference.gru_bwd_hoist."""
        w_x, w_h, b_x, b_h = w
        xb, hb, wxb, whb = (t.to(dtype).clone() for t in (x, h0, w_x, w_h))
        with torch.no_grad():
            ys, _ = k_gru.gru_scan(xb, hb, wxb, whb, b_x, b_h, reset_mask=reset)
            x_proj = torch.matmul(xb.float(), wxb.float()) + b_x
            g = torch.randn_like(ys)
            if "x_proj" in inspect.signature(k_gru.gru_backward).parameters:
                h_in, keep, h_proj = reference.gru_bwd_project(x_proj, ys, hb, whb, b_h, reset)
                args = (x_proj, h_proj, h_in, g, whb, keep)
            else:
                h_in, keep, *gates = reference.gru_bwd_hoist(x_proj, ys, hb, whb, b_h, reset)
                args = (*gates, h_in, g, whb, keep)
        kernel_ms = med(lambda: k_gru.gru_backward(*args))
        leaves = [xb.requires_grad_(True), hb.requires_grad_(True),
                  *(t.clone().requires_grad_(True) for t in w)]
        ys, _ = k_gru.gru_scan(*leaves, reset_mask=reset)
        return kernel_ms, med(lambda: torch.autograd.backward(ys, g, retain_graph=True))

    ms, autograd_ms = gru_reverse(x, h0, w, reset, torch.float32)
    kern["gru_backward_keep_float32_B256_rsc15"] = {"ms": ms, "autograd_backward_ms": autograd_ms}
    x, h0, w = gru_inputs(128, 200, 128)
    H = 128
    ms, autograd_ms = gru_reverse(x, h0, w, None, torch.float32)
    kern["gru_backward_float32_B128"] = {"ms": ms, "autograd_backward_ms": autograd_ms}

    # The f32 input projection at the f32 paths' shapes, beside torch.addmm.
    for M, N, project in ((64 * 200, 384, k_gru.gru_input_projection),
                          (128 * 200, 384, k_gru.gru_input_projection),
                          (64 * 200, 512, k_lstm.lstm_input_projection),
                          (128 * 200, 512, k_lstm.lstm_input_projection)):
        xm = torch.from_numpy(rng.normal(size=(M, 128)).astype(np.float32)).to(dev)
        wm = torch.from_numpy((rng.normal(size=(128, N)) * 128 ** -0.5).astype(np.float32)).to(dev)
        bm = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        kern[f"xproj_float32_M{M}_N{N}"] = {"ms": med(lambda: project(xm, wm, bm)),
                                            "addmm_ms": med(lambda: torch.addmm(bm, xm, wm))}

    # The sampled-softmax head at GRU4Rec's training shape: N = B*T rows,
    # S = 256 shared negatives, H = 128, rows of a table at Zipf ids.
    N, S = 128 * 200, 256
    table = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(cs.VOCAB, H))
                             .astype(np.float32)).to(dev)
    targets = torch.from_numpy(cs.zipf_items(rng, N, ranked=True).astype(np.int32)).to(dev)
    neg_ids = torch.from_numpy(cs.zipf_items(rng, S, ranked=True).astype(np.int32)).to(dev)
    hh = torch.tanh(torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))).to(dev)
    plq = torch.from_numpy(rng.normal(size=N).astype(np.float32) - 6).to(dev)
    nlq = torch.from_numpy(rng.normal(size=S).astype(np.float32) - 6).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        hargs = (hh.to(dtype), table[targets.long()].to(dtype), table[neg_ids.long()].to(dtype),
                 targets, neg_ids, plq, nlq)
        kern[f"head_{dname(dtype)}_N{N}"] = {
            "ms": med(lambda: k_head.sampled_softmax_nll(*hargs)),
            "digest": _digest([k_head.sampled_softmax_nll(*hargs)])}
        if dtype == torch.float32:
            hn = hargs[2]
            kern[f"head_{dname(dtype)}_N{N}"]["matmul_f32_ms"] = med(lambda: hh @ hn.T)
    # The f32 head at beauty's step (B=128, T=50, D=H=256, S=256): a
    # checkout whose kernel refuses the shape records its error.
    Nb, Db = 128 * 50, 256
    wide = torch.from_numpy(rng.normal(scale=Db ** -0.5, size=(cs.VOCAB, Db))
                            .astype(np.float32)).to(dev)
    hw = torch.tanh(torch.from_numpy(rng.normal(size=(Nb, Db)).astype(np.float32))).to(dev)
    bargs = (hw, wide[targets[:Nb].long()], wide[neg_ids.long()], targets[:Nb], neg_ids,
             plq[:Nb], nlq)
    try:
        kern[f"head_float32_N{Nb}_H{Db}"] = {
            "ms": med(lambda: k_head.sampled_softmax_nll(*bargs)),
            "digest": _digest([k_head.sampled_softmax_nll(*bargs)]),
            "matmul_f32_ms": med(lambda: hw @ bargs[2].T)}
    except ValueError as e:
        kern[f"head_float32_N{Nb}_H{Db}"] = {"error": str(e)}

    # The scatter-add (the gather's backward), beside index_add_, on Zipf(1.0)
    # ids over items 1..V-1: at GRU4Rec's training shape (25,600 ids into
    # the [3418, 128] table), unpadded and padded as the training path pads
    # (rows of 5..200 positions, the rest on the padding row 0: about half
    # of all positions); at rsc15's (12,800 ids, [37,484, 100]) and beauty's
    # (6,400 ids, [12,102, 256]) step.
    def zipf_over(V, n):
        p = 1.0 / np.arange(1, V)
        return rng.choice(np.arange(1, V), size=n, p=p / p.sum())

    padded = zipf_over(cs.VOCAB, N).reshape(128, 200)
    padded[np.arange(200)[None, :] >= rng.integers(5, 201, size=(128, 1))] = 0
    for row, V, D, ids_np in (
            (f"scatter_add_N{N}", cs.VOCAB, H, cs.zipf_items(rng, N)),
            (f"scatter_add_N{N}_padded", cs.VOCAB, H, padded.reshape(-1)),
            ("scatter_add_N12800_V37484_D100", 37_484, 100, zipf_over(37_484, 12_800)),
            ("scatter_add_N6400_V12102_D256", 12_102, 256, zipf_over(12_102, 6_400))):
        sids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
        sg = torch.from_numpy(rng.normal(scale=1e-2, size=(len(ids_np), D))
                              .astype(np.float32)).to(dev)
        kern[row] = {
            "ms": med(lambda: k_gather.embedding_scatter_add(sg, sids, V)),
            "digest": _digest([k_gather.embedding_scatter_add(sg, sids, V)]),
            "index_add_ms": med(lambda: torch.zeros(V, D, device=dev).index_add_(0, sids, sg)),
            "max_ids_per_row": int(np.bincount(ids_np, minlength=V).max()),
            "padding_share": float(np.mean(ids_np == 0))}

    # The gather into the compute dtype (a checkout whose gather takes no
    # dtype: its gather, then .to(dtype), as its model did), beside
    # F.embedding then .to(dtype), at serving's [64, 200] ids, training's
    # [128, 200] and the 256 negatives, D=64 and D=128; and the scatter-add
    # on a bf16 cotangent at the training shape, padded ids (a checkout
    # that widens it first: its widening and its kernel).
    takes_dtype = "dtype" in inspect.signature(k_gather.embedding_gather).parameters
    for D in (64, 128):
        gtable = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(cs.VOCAB, D))
                                  .astype(np.float32)).to(dev)
        for shape in ((64, 200), (128, 200), (256,)):
            gids = torch.from_numpy(cs.zipf_items(rng, int(np.prod(shape))).reshape(shape)
                                    .astype(np.int32)).to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                if takes_dtype:
                    fn = lambda: k_gather.embedding_gather(gtable, gids, dtype=dtype)  # noqa: E731
                else:
                    fn = lambda: k_gather.embedding_gather(gtable, gids).to(dtype)  # noqa: E731
                kern[f"gather_{dname(dtype)}_D{D}_{'x'.join(map(str, shape))}"] = {
                    "ms": med(fn), "digest": _digest([fn()]),
                    "one_launch": takes_dtype or dtype == torch.float32,
                    "embedding_to_ms": med(lambda: torch.nn.functional.embedding(
                        gids, gtable).to(dtype))}
        g16 = torch.from_numpy(rng.normal(scale=1e-2, size=(N, D)).astype(np.float32)).to(
            dev, torch.bfloat16)
        pids = torch.from_numpy(padded.reshape(-1).astype(np.int64)).to(dev)
        kern[f"scatter_add_bf16_cotangent_D{D}_padded"] = {
            "ms": med(lambda: k_gather.embedding_scatter_add(g16, pids, cs.VOCAB)),
            "digest": _digest([k_gather.embedding_scatter_add(g16, pids, cs.VOCAB)])}

    # The LSTM: forward scans beside nn.LSTM f32 on the same values, then the
    # reverse recurrence on gate planes of the forward's ranges.
    x, h0, _ = gru_inputs(128, 200, 128)
    c0 = state(128, H)
    w_x, w_h, b = (t.to(dev) for t in cs.lstm_weights(rng, 128, H))
    lib = torch.nn.LSTM(128, H, batch_first=True, device=dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(w_x.T)
        lib.weight_hh_l0.copy_(w_h.T)
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    reset = torch.from_numpy((rng.random((128, 200)) < 1 / RESET_EVERY)
                             .astype(np.float32)).to(dev)
    for Bl, dtype in ((128, torch.bfloat16), (64, torch.bfloat16), (128, torch.float32),
                      (64, torch.float32)):
        xd, hd, cd = x[:Bl].to(dtype), h0[:Bl].to(dtype), c0[:Bl].to(dtype)
        ys, (_, c_last) = k_lstm.lstm_scan(xd, hd, cd, w_x, w_h, b)
        key = f"lstm_{dname(dtype)}_B{Bl}"
        rec = {"ms": med(lambda: k_lstm.lstm_scan(xd, hd, cd, w_x, w_h, b)),
               "digest": _digest([ys, c_last], keep=key * (dtype == torch.bfloat16))}
        xf, state0 = x[:Bl], (h0[:Bl][None], c0[:Bl][None])
        with torch.no_grad():
            rec["nn_lstm_f32_ms"] = med(lambda: lib(xf, state0))
        kern[key] = rec
    xb, hb, cb = x.bfloat16(), h0.bfloat16(), c0.bfloat16()
    for key, args in (("lstm_reset_bfloat16_B128", (xb, hb, cb)),
                      ("lstm_reset_float32_B128", (x, h0, c0))):
        ys, (_, c_last) = k_lstm.lstm_scan(*args, w_x, w_h, b, reset_mask=reset)
        kern[key] = {
            "ms": med(lambda: k_lstm.lstm_scan(*args, w_x, w_h, b, reset_mask=reset)),
            "digest": _digest([ys, c_last], keep=key * ("bfloat16" in key))}
    xg = x.detach().clone().requires_grad_(True)
    g32 = (x * 0.1).detach()

    def lib_fwd_bwd():
        lib(xg, (h0[None], c0[None]))[0].backward(g32)

    kern["nn_lstm_f32_backward_B128"] = {
        "ms": med(lib_fwd_bwd) - med(lambda: lib(xg, (h0[None], c0[None]))[0]),
        "what": "torch.nn.LSTM f32 (cuDNN), fwd+bwd - fwd"}
    lplanes = [torch.from_numpy(rng.uniform(0.05, 0.95, size=(128, 200, H))
                                .astype(np.float32)).to(dev) for _ in range(4)]
    i_, f_, o_ = lplanes[:3]
    g_, tanh_c = torch.tanh(lplanes[3] * 4 - 2), torch.tanh(x)
    c_in = x * 2
    g_ys = (x * 0.1).bfloat16()
    dc_last = h0 * 0.01
    keep = (1.0 - reset)[:, :, None]
    whb = w_h.bfloat16()
    for key, kp in (("lstm_backward_bfloat16_B128", None),
                    ("lstm_backward_keep_bfloat16_B128", keep)):
        kern[key] = {"ms": med(lambda: k_lstm.lstm_backward(
            i_, f_, g_, o_, tanh_c, c_in, g_ys, whb, kp, dc_last)),
            "digest": _digest(k_lstm.lstm_backward(i_, f_, g_, o_, tanh_c, c_in, g_ys, whb,
                                                   kp, dc_last))}
    g32 = g_ys.float()
    for key, kp in (("lstm_backward_float32_B128", None),
                    ("lstm_backward_keep_float32_B128", keep)):
        kern[key] = {"ms": med(lambda: k_lstm.lstm_backward(
            i_, f_, g_, o_, tanh_c, c_in, g32, w_h, kp, dc_last)),
            "digest": _digest(k_lstm.lstm_backward(i_, f_, g_, o_, tanh_c, c_in, g32, w_h,
                                                   kp, dc_last))}

    def encode_device_ms(path: str, batch: list, overrides=()) -> float:
        cfg = RunConfig.load(cs.CONFIGS[path]).apply_overrides(list(overrides))
        m = build_model(cfg.model, cs.VOCAB, device=dev)
        m.load_state_dict(flax_to_state_dict(random_params(m, 0)))
        m.eval()
        packed = infer._pack([r["history"] for r in batch], [r["user"] for r in batch],
                             len(batch), cfg.data.max_len)
        inputs, mask, _ = (torch.from_numpy(a).to(dev) for a in packed)
        ts = []
        with torch.inference_mode():
            for rep in range(24):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(50_000_000)
                start.record()
                m.encode(inputs, mask)
                end.record()
                torch.cuda.synchronize()
                if rep >= 3:  # warm-up
                    ts.append(start.elapsed_time(end))
        return float(np.median(ts))

    kern.update(_rnn_rows())

    # The paths draw from their own generator, so that both checkouts serve
    # and train on the same data whatever the kernel phase drew.
    rng = np.random.default_rng(1)
    requests = cs.make_requests(rng, RunConfig.load(cs.CONFIGS["gru4rec"]).data.max_len)
    paths = {}
    for key, path, over in (("serve_gru4rec", "gru4rec", ()), ("serve_sasrec", "sasrec", ()),
                            ("serve_lstm", "lstm", ()), ("serve_gru4rec_f32", "gru4rec", (F32,)),
                            ("serve_sasrec_f32", "sasrec", (F32,)),
                            ("serve_lstm_f32", "lstm", (F32,))):
        r = _serve(cs, dev, path, requests, over)
        paths[key] = {"encode_ms": r["batch_breakdown"]["encode_ms"],
                      "batch_ms": r["batch_ms_median"],
                      "encode_device_ms": encode_device_ms(path, requests[:cs.B], over)}
    for key, path, over in (
            ("train_gru4rec", "gru4rec", ()),
            ("train_sasrec", "sasrec", ("train.warmup_steps=0",)),
            ("train_lstm", "lstm", ()),
            ("train_rsc15_gru4rec_session", "rsc15_gru4rec", ()),
            ("train_lstm_session", "lstm", ("data.session_parallel=true",)),
            ("train_lstm_f32", "lstm", (F32,)),
            ("train_gru4rec_f32", "gru4rec", (F32,)),
            ("train_sasrec_f32", "sasrec", (F32, "train.warmup_steps=0"))):
        r = cs.phase_train(rng, dev, 0, path, groups=2, overrides=over)
        paths[key] = {"device_forward_ms": r["device_step_ms"]["forward"],
                      "device_step_ms": r["device_step_ms"]["total"],
                      "step_ms": r["step_ms_median"],
                      "device_launches_per_step": r["profile"]["device_launches_per_step"]}
    return {"label": label, "root": str(Path.cwd()), "kernels": kern, "paths": paths}


def _kept_differences(root: Path, turns: list) -> dict:
    """For each kept row (see `_digest`) whose digests differ between the
    parent and the change: the largest absolute difference between the two
    labels' outputs, and the row's tolerance (chip_smoke's: the GRU
    forward's GRU_BF16_TOL, the LSTM's LSTM_BF16_TOL; the projection's
    XPROJ_TOL, or XPROJ_WIDE_REL_TOL of the parent's largest value above
    D = 256; the f32 grid and stepped forwards' GRU_F32_TOL, the f32
    stepped reverses' the same of the parent's largest value)."""
    import torch

    import chip_smoke as cs

    out = {}
    for path in sorted((root / "parent").glob("*.pt")):
        key, other = path.stem, root / "change" / path.name
        digests = {t["label"]: t["kernels"].get(key, {}).get("digest") for t in turns}
        if not other.exists() or digests["parent"] == digests["change"]:
            continue
        a, b = torch.load(path), torch.load(other)
        diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
        if key.startswith("xproj"):
            D = turns[0]["kernels"][key]["D"]
            tol = (cs.XPROJ_TOL if D <= 256 else
                   cs.XPROJ_WIDE_REL_TOL * max(x.abs().max().item() for x in a))
        elif "backward_stepped_float32" in key:  # 1e-5 of the parent's largest value
            tol = cs.GRU_F32_TOL * max(x.abs().max().item() for x in a)
        elif "_float32_" in key:  # the f32 grid forwards' and stepped forwards' rows
            tol = cs.GRU_F32_TOL
        else:
            tol = cs.GRU_BF16_TOL if key.startswith("gru") else cs.LSTM_BF16_TOL
        out[key] = {"max_abs_diff": diff, "tolerance": tol, "within": diff <= tol}
        del a, b
    return out


def _same_bits(turns: list) -> dict:
    """For each row with a digest: whether all turns, the parent's two and
    the change's two gave the same bits."""
    keys = [k for k, v in turns[0]["kernels"].items() if isinstance(v, dict) and "digest" in v]
    out = {}
    for k in keys:
        got = [(t["label"], t["kernels"][k]["digest"]) for t in turns]
        out[k] = {"all": len({d for _, d in got}) == 1,
                  **{lab: len({d for a, d in got if a == lab}) == 1 for lab in ("parent", "change")}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the parent checkout")
    ap.add_argument("--out", help="also write the result (indented JSON) to this file")
    ap.add_argument("--pairs", type=int, default=0,
                    help="time one training path in this many alternating pairs instead")
    ap.add_argument("--path", default="gru4rec", help="the training path of --pairs")
    ap.add_argument("--only", choices=("rnn", "f32"), default="",
                    help="time only the recurrences' rows (rnn) or the f32 GEMM's (f32), "
                         "no paths")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        sys.path.insert(0, str(Path.cwd()))
        rec = (_path_worker(args.worker, args.path) if args.pairs
               else _worker(args.worker, args.only))
        print(json.dumps(rec), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    roots = {"parent": Path(args.parent).resolve(), "change": HERE}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.pairs:
        order = [(i, label) for i in range(args.pairs)
                 for label in (ORDER[:2] if i % 2 == 0 else ORDER[2:])]
        extra = ["--pairs", str(args.pairs), "--path", args.path]
    else:
        order = [(None, label) for label in ORDER]
        extra = ["--only", args.only] if args.only else []
    turns = []
    keep_dir = Path(tempfile.mkdtemp(prefix="kernel_turns_"))
    for pair, label in order:
        root = roots[label]
        cmd = [sys.executable, str(HERE / "kernel_turns.py"), "--worker", label, *extra]
        env = dict(os.environ, PYTHONPATH=str(root), KERNEL_TURNS_KEEP=str(keep_dir),
                   KERNEL_TURNS_LABEL=label)
        r = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
            return 1
        turns.append(json.loads(r.stdout.strip().splitlines()[-1]))
        if pair is not None:
            turns[-1]["pair"] = pair
        print(json.dumps({"turn": label, **turns[-1]}), flush=True)
    result = {"device": smi, "turns": turns}
    if not args.pairs:
        result["same_bits"] = _same_bits(turns)
        sys.path.insert(0, str(HERE))
        result["differences"] = _kept_differences(keep_dir, turns)
    shutil.rmtree(keep_dir, ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
