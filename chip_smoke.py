"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py [--seed 0]

Runs from the root of a checkout and builds everything it needs (the CUDA
kernels under seqrec_tpu_torch/csrc/, with nvcc for sm_90a). Each phase
prints one JSON line:

  a. device   the card's name and power limit (nvidia-smi);
  b. build    compile the kernels from the checkout's sources, timed;
  c. kernels  each kernel against its plain PyTorch version at the serving
              shapes (gather: [3418, 128] table, [64, 200] ids with planted
              out-of-range ids, bit-exact; GRU: B=64, T=200, D=H=128 in f32
              and bf16, and against torch.nn.GRU as a second oracle), with
              kernel, plain, library and bound times;
  d. serve    `recommend` on the ML-1M GRU4Rec configuration
              (configs/ml1m_gru4rec.json, seeded random weights) for a few
              hundred Zipf-distributed histories, batch 64, k=10: once with
              the kernels (use_pallas=true; launch counters reset just
              before and read just after) and once with the plain versions,
              which must agree;
  e. train_kernels  the training path's kernels against their plain
              versions at its shapes (B=128, T=200, D=H=128, S=256, the
              [3418, 128] table): the gather's scatter-add backward with
              planted out-of-range ids; the GRU reverse recurrence (d_xp,
              dh0) and the weight gradients through autograd, bf16 and f32;
              the sampled-softmax head's NLL and its loss and gradients,
              bf16 and f32; with kernel, plain, library and bound times;
  f. train    `Trainer.train_step_multi` on the same configuration at full
              width: Zipf histories of 5..200 items packed into [8, 128, 202]
              int16 wire groups, six groups through the kernels (counters
              reset just before and read just after) and one through the
              plain versions; step-1 loss and gradient norm of the two
              agree, every loss is finite, the last group's mean loss is
              below the first's, and each kernel launches its expected
              number of times per step (none in the plain run); examples/s,
              step ms and a device-time split of a step by CUDA events;
  g. the kernels line: {"kernels": [{name, route, source, replaces,
              launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
              library_ms}, ...]} for all five kernels, `launches` counted
              on the training path (the serving path's count beside it).

Then the raw nvidia-smi name/power-limit line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises: the script exits non-zero without the ok line. It
exits non-zero too when CUDA is not available; there is no CPU path.

Times come from CUDA events: each rep first queues a ~1 ms device sleep, so
the events bracket the device's work and not the host's launch latency (the
plain GRU, ~2,000 small launches, stays host-bound and is timed as it runs).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data.negative import log_uniform_log_prob, sample_log_uniform
from seqrec_tpu_torch.eval import infer
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops import _build, reference
from seqrec_tpu_torch.ops.cuda import gather as k_gather
from seqrec_tpu_torch.ops.cuda import gru as k_gru
from seqrec_tpu_torch.ops.cuda import head as k_head
from seqrec_tpu_torch.train.trainer import Trainer

CONFIG = "configs/ml1m_gru4rec.json"
VOCAB = 3418  # ML-1M: 3,417 items + the pad row (bench.py's catalog)
B, K = 64, 10  # serving batch (the CLI default) and top-k
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 w/o tensor cores
REPS = 21

# Tolerances, each with its reason.
GRU_F32_TOL = 1e-5  # same f32 math, another summation order
GRU_CUDNN_F32_TOL = 1e-4  # cuDNN's own GEMM order, TF32 off
GRU_BF16_TOL = 3e-2  # plain rounds every gate op to bf16, the kernel only h
SCORE_TOL = 1e-2  # serve: bf16 scores through two GRU numerics (CPU emulation: 1e-3)
# Training path (B=128, T=200, S=256).
TRAIN_B, TRAIN_T, NUM_NEG = 128, 200, 256
HEAD_TOL = 1e-4  # nll ~6: f32 sums of 128 products and 257 exps in another order
HEAD_LOSS_BF16_TOL = 1e-2  # relative: the plain loss rounds its logits to bf16
GRU_BWD_TOL = 1e-4  # relative to the largest value: f32 carry over 200 steps, another order
GRU_BWD_BF16_W_TOL = 2 ** -7  # relative: weight grads rounded to bf16 on both sides
STEP1_LOSS_TOL = 2e-2  # relative, kernels vs plain: bf16 compute, two GRU numerics
STEP1_NORM_TOL = 5e-2  # relative, the same, through the backward


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = REPS):
    """Median, min and max ms of `fn` over `reps` runs, by CUDA events, each
    run behind a ~1 ms device sleep so its launches queue up first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    ts.sort()
    return {"median": ts[len(ts) // 2], "min": ts[0], "max": ts[-1], "reps": reps}


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_items(rng: np.random.Generator, n: int, ranked: bool = False) -> np.ndarray:
    """Item ids 1..VOCAB-1 with Zipf(1.0) popularity over a random ranking,
    or, `ranked`, with id = popularity rank (as the data prep assigns ids,
    and as the log-uniform negative sampler assumes)."""
    ranks = np.arange(1, VOCAB)
    p = 1.0 / ranks
    p /= p.sum()
    order = ranks if ranked else rng.permutation(ranks)
    return order[rng.choice(VOCAB - 1, size=n, p=p)]


def gru_weights(rng: np.random.Generator, D: int, H: int):
    """w_x [D, 3H] Glorot-uniform, w_h [H, 3H] orthogonal rows, biases
    N(0, 0.1): f32 on the CPU."""
    lim = np.sqrt(6.0 / (D + 3 * H))
    w_x = torch.from_numpy(rng.uniform(-lim, lim, size=(D, 3 * H)).astype(np.float32))
    q, r = np.linalg.qr(rng.normal(size=(3 * H, H)))
    w_h = torch.from_numpy((q * np.sign(np.diag(r))).T.astype(np.float32))
    b_x = torch.from_numpy(rng.normal(scale=0.1, size=3 * H).astype(np.float32))
    b_h = torch.from_numpy(rng.normal(scale=0.1, size=3 * H).astype(np.float32))
    return w_x, w_h, b_x, b_h


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference over the largest magnitude of `b`."""
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def phase_device() -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi, name


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {n: [line.strip() for line in log.splitlines() if "Used" in line or "spill" in line]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs), "ptxas": ptxas})


def phase_kernels(rng: np.random.Generator, dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D = H = 128
    T = 200
    out = {}

    # --- gather ------------------------------------------------------------
    table = torch.from_numpy(
        rng.normal(scale=D ** -0.5, size=(VOCAB, D)).astype(np.float32)).to(dev)
    ids_np = zipf_items(rng, B * T).reshape(B, T).astype(np.int32)
    ids_ok = torch.from_numpy(ids_np.copy()).to(dev)
    planted = np.array([-1, -VOCAB, VOCAB, -VOCAB - 1, 10 ** 6], np.int32)
    ids_np[0, :5] = planted
    ids = torch.from_numpy(ids_np).to(dev)
    got = k_gather.embedding_gather(table, ids)
    torch.cuda.synchronize()
    want = k_gather.plain(table, ids)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    check(bool(same.all()), "gather kernel is not bit-exact against its plain version")
    check(bool(torch.isnan(got[0, 2:5]).all()) and not bool(torch.isnan(got[0, :2]).any()),
          "gather: planted ids do not wrap / NaN as jnp.take does")
    valid = ids_np[(ids_np >= -VOCAB) & (ids_np < VOCAB)] % VOCAB
    g_bytes = np.unique(valid).size * D * 4 + ids_np.size * 4 + ids_np.size * D * 4
    g_bound, g_by = bound(g_bytes, 0, torch.float32)
    out["gather"] = {
        "shape": {"table": [VOCAB, D], "ids": [B, T], "dtype": "float32"},
        "max_abs_err": 0.0, "bit_exact": True,
        "kernel_ms": time_ms(lambda: k_gather.embedding_gather(table, ids)),
        "plain_ms": time_ms(lambda: k_gather.plain(table, ids)),
        # F.embedding asserts on out-of-range ids: timed on the in-range copy.
        "library_ms": time_ms(lambda: torch.nn.functional.embedding(ids_ok, table)),
        "bound_ms": g_bound, "bound_by": g_by, "bytes": int(g_bytes),
    }

    # --- GRU scan ------------------------------------------------------------
    w_x, w_h, b_x, b_h = gru_weights(rng, D, H)
    x32 = k_gather.plain(table, ids_ok)  # the embeddings serving feeds in
    weights = [w.to(dev) for w in (w_x, w_h, b_x, b_h)]
    for dtype, tol in ((torch.float32, GRU_F32_TOL), (torch.bfloat16, GRU_BF16_TOL)):
        x = x32.to(dtype)
        h0 = torch.zeros(B, H, dtype=dtype, device=dev)
        args = (x, h0, *weights)
        ys, h_last = k_gru.gru_scan(*args)
        torch.cuda.synchronize()
        ys_plain, _ = k_gru.plain(*args)
        err = (ys.float() - ys_plain.float()).abs().max().item()
        check(bool(torch.isfinite(ys).all()), f"gru {dtype}: non-finite output")
        check(torch.equal(h_last, ys[:, -1]), f"gru {dtype}: h_last is not ys[:, -1]")
        check(err <= tol, f"gru {dtype}: kernel vs plain max abs err {err} > {tol}")
        lib = torch.nn.GRU(D, H, batch_first=True, device=dev, dtype=dtype)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_x.T)
            lib.weight_hh_l0.copy_(w_h.T)
            lib.bias_ih_l0.copy_(b_x)
            lib.bias_hh_l0.copy_(b_h)
        with torch.no_grad():
            ys_lib, _ = lib(x, h0[None])
        lib_err = (ys.float() - ys_lib.float()).abs().max().item()
        lib_tol = GRU_CUDNN_F32_TOL if dtype == torch.float32 else GRU_BF16_TOL
        check(lib_err <= lib_tol,
              f"gru {dtype}: kernel vs torch.nn.GRU max abs err {lib_err} > {lib_tol}")
        es = x.element_size()
        r_bytes = (B * T * D + B * H + (D + H) * 3 * H + B * T * H) * es + 2 * 3 * H * 4
        r_flops = 2 * B * T * (D + H) * 3 * H
        r_bound, r_by = bound(r_bytes, r_flops, dtype)
        with torch.no_grad():
            lib_ms = time_ms(lambda: lib(x, h0[None]))
        out[f"gru_scan_{str(dtype).split('.')[-1]}"] = {
            "shape": {"B": B, "T": T, "D": D, "H": H, "dtype": str(dtype).split(".")[-1]},
            "launch": k_gru.launch_config(B, T, D, H, dtype),
            "max_abs_err": err, "tolerance": tol,
            "max_abs_err_vs_nn_gru": lib_err, "tolerance_vs_nn_gru": lib_tol,
            "kernel_ms": time_ms(lambda: k_gru.gru_scan(*args)),
            "plain_ms": time_ms(lambda: k_gru.plain(*args)),
            "library_ms": lib_ms,
            "bound_ms": r_bound, "bound_by": r_by, "bytes": int(r_bytes),
            "flops": int(r_flops),
            "serial_steps": T,
        }
    emit({"phase": "kernels", **out})
    return out


def _agree(a: dict, b: dict, tol: float) -> tuple:
    """Plain-run recs `b` vs kernel-run recs `a` for one request: scores
    within `tol` position by position, and ids equal wherever the score gap
    exceeds it (a differing id must be a near-tie in both runs)."""
    sa, sb = np.asarray(a["scores"]), np.asarray(b["scores"])
    diff = float(np.abs(sa - sb).max())
    mismatched = 0
    pos_b = {item: j for j, item in enumerate(b["items"])}
    for j, item in enumerate(a["items"]):
        if item == b["items"][j]:
            continue
        mismatched += 1
        if item in pos_b:
            near = abs(sa[j] - sb[pos_b[item]]) <= 2 * tol
        else:
            near = sa[j] <= sb[-1] + 2 * tol
        check(near, f"serve: item {item} at rank {j} differs beyond the tolerance")
    return diff, mismatched


def phase_serve(rng: np.random.Generator, dev, seed: int, n_requests: int = 320) -> dict:
    cfg = RunConfig.load(CONFIG)
    check(cfg.model.use_pallas, f"{CONFIG} must enable the kernels")
    models = {}
    for use_pallas in (True, False):
        mcfg = cfg.apply_overrides([f"model.use_pallas={str(use_pallas).lower()}"]).model
        m = build_model(mcfg, VOCAB, device=dev)
        models[use_pallas] = m
    state = flax_to_state_dict(random_params(models[True], seed))
    for m in models.values():
        m.load_state_dict(state)
        m.eval()
    max_len = cfg.data.max_len
    lengths = rng.integers(5, max_len + 1, size=n_requests)
    requests = [{"user": i, "history": zipf_items(rng, n).tolist()}
                for i, n in enumerate(lengths)]
    batches = [requests[i:i + B] for i in range(0, n_requests, B)]

    def serve(model):
        recs, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            recs += list(infer.recommend(model, batch, k=K, batch_size=B, max_len=max_len))
            times.append((time.perf_counter() - t0) * 1e3)
        return recs, times

    for m in models.values():  # warm caches and the allocator
        list(infer.recommend(m, batches[0], k=K, batch_size=B, max_len=max_len))
    torch.cuda.synchronize()

    k_gather.embedding_gather.launches = 0
    k_gru.gru_scan.launches = 0
    recs, times = serve(models[True])
    launches = {"gather": k_gather.embedding_gather.launches,
                "gru_scan": k_gru.gru_scan.launches}
    plain_recs, plain_times = serve(models[False])
    plain_launches = {"gather": k_gather.embedding_gather.launches - launches["gather"],
                      "gru_scan": k_gru.gru_scan.launches - launches["gru_scan"]}

    n_b, layers = len(batches), cfg.model.num_layers
    check(launches == {"gather": n_b, "gru_scan": n_b * layers},
          f"serve: kernel launches {launches}, expected one gather and "
          f"{layers} GRU scan(s) per batch of {n_b}")
    check(plain_launches == {"gather": 0, "gru_scan": 0},
          f"serve: the plain run launched kernels {plain_launches}")
    check(len(recs) == len(plain_recs) == n_requests, "serve: lost requests")
    max_diff, mismatched = 0.0, 0
    for req, a, b in zip(requests, recs, plain_recs):
        check(a["user"] == req["user"] and b["user"] == req["user"], "serve: order changed")
        for rec in (a, b):
            items = rec["items"]
            check(len(items) == K and len(set(items)) == K, "serve: not k distinct items")
            check(all(0 < i < VOCAB for i in items), "serve: pad or unknown item")
            check(not set(items) & set(req["history"]), "serve: recommended a seen item")
            s = np.asarray(rec["scores"])
            check(bool(np.isfinite(s).all()) and bool((np.diff(s) <= 0).all()),
                  "serve: scores not finite and descending")
        diff, mis = _agree(a, b, SCORE_TOL)
        check(diff <= SCORE_TOL, f"serve: score diff {diff} > {SCORE_TOL}")
        max_diff, mismatched = max(max_diff, diff), mismatched + mis

    # Where one batch's time goes on the kernel path (after the counted run).
    first = batches[0]
    t0 = time.perf_counter()
    packed = infer._pack([r["history"] for r in first], [r["user"] for r in first], B, max_len)
    pack_ms = (time.perf_counter() - t0) * 1e3
    inputs, mask, users = (torch.from_numpy(a).to(dev) for a in packed)
    fetch_k = min(K + max_len, VOCAB - 1)
    m = models[True]
    with torch.inference_mode():
        step = {
            "encode_ms": time_ms(lambda: m.encode(inputs, mask))["median"],
            "scores_ms": time_ms(lambda: m.scores(inputs, mask))["median"],
            "topk_step_ms": time_ms(
                lambda: infer.topk_step(m, inputs, mask, users, fetch_k))["median"],
        }
    breakdown = {
        "pack_host_ms": pack_ms, **step,
        # H2D and D2H copies, the sync, history exclusion and Python.
        "rest_host_ms": float(np.median(times)) - pack_ms - step["topk_step_ms"],
    }

    result = {
        "phase": "serve", "config": CONFIG, "vocab": VOCAB, "requests": n_requests,
        "batch_size": B, "k": K, "batches": n_b,
        "requests_per_s": n_requests / (sum(times) / 1e3),
        "batch_ms_median": float(np.median(times)), "batch_ms_min": min(times),
        "batch_ms_max": max(times),
        "plain_requests_per_s": n_requests / (sum(plain_times) / 1e3),
        "plain_batch_ms_median": float(np.median(plain_times)),
        "launches": launches, "plain_launches": plain_launches,
        "max_score_diff_vs_plain": max_diff, "score_tolerance": SCORE_TOL,
        "rank_swaps_within_tolerance": mismatched,
        "batch_breakdown": breakdown,
    }
    emit(result)
    return result


def _scatter_add_check(rng, dev, table) -> dict:
    D = table.shape[1]
    N = TRAIN_B * TRAIN_T
    ids_np = zipf_items(rng, N).astype(np.int32)
    ids_ok = torch.from_numpy(ids_np.copy()).to(dev)
    ids_np[:5] = np.array([-1, -VOCAB, VOCAB, -VOCAB - 1, 10 ** 6], np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    g = torch.from_numpy(rng.normal(scale=1e-2, size=(N, D)).astype(np.float32)).to(dev)
    got = k_gather.embedding_scatter_add(g, ids, VOCAB)
    torch.cuda.synchronize()
    want = k_gather.plain_backward(g, ids, VOCAB)
    err = max_err(got, want)
    # Atomics add each row's terms in an order that changes run to run: the
    # classic bound for n terms is n * 2^-24 * sum |terms|.
    valid = ids_np[(ids_np >= -VOCAB) & (ids_np < VOCAB)] % VOCAB
    n_max = int(np.bincount(valid, minlength=VOCAB).max())
    tol = n_max * 2.0 ** -24 * k_gather.plain_backward(g.abs(), ids, VOCAB).max().item()
    check(err <= tol, f"scatter-add kernel vs plain max abs err {err} > {tol}")
    s_bytes = N * D * 4 + N * 4 + VOCAB * D * 4
    s_bound, s_by = bound(s_bytes, 0, torch.float32)
    ids_long = ids_ok.long()
    return {
        "shape": {"table": [VOCAB, D], "ids": [TRAIN_B, TRAIN_T], "dtype": "float32"},
        "max_abs_err": err, "tolerance": tol, "max_ids_per_row": n_max,
        "kernel_ms": time_ms(lambda: k_gather.embedding_scatter_add(g, ids, VOCAB)),
        "plain_ms": time_ms(lambda: k_gather.plain_backward(g, ids, VOCAB)),
        # index_add_ errors on out-of-range ids: timed on the in-range copy.
        "library_ms": time_ms(lambda: torch.zeros(VOCAB, D, device=dev)
                              .index_add_(0, ids_long, g)),
        "bound_ms": s_bound, "bound_by": s_by, "bytes": int(s_bytes),
    }


def _gru_backward_checks(rng, dev, x32) -> dict:
    B, T, D = x32.shape
    H = D
    w_x, w_h, b_x, b_h = (w.to(dev) for w in gru_weights(rng, D, H))
    g32 = torch.from_numpy(rng.normal(scale=1e-2, size=(B, T, H)).astype(np.float32)).to(dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, g = x32.to(dtype), g32.to(dtype)
        h0 = torch.zeros(B, H, dtype=dtype, device=dev)
        wx_c, wh_c = w_x.to(dtype), w_h.to(dtype)
        with torch.no_grad():
            ys, _ = k_gru.gru_scan(x, h0, wx_c, wh_c, b_x, b_h)
            x_proj = torch.matmul(x.float(), wx_c.float()) + b_x
            h_in, _, r, z, n, hn = reference.gru_bwd_hoist(x_proj, ys, h0, wh_c, b_h)
        planes = (r, z, n, hn, h_in, g, wh_c)
        d_xp, dh0 = k_gru.gru_backward(*planes)
        torch.cuda.synchronize()
        want_xp, want_h0 = k_gru.plain_backward(*planes)
        errs = {"d_xp": rel_err(d_xp, want_xp), "dh0": rel_err(dh0, want_h0)}
        for k, e in errs.items():
            check(e <= GRU_BWD_TOL, f"gru backward {name}: {k} kernel vs plain "
                                    f"relative err {e} > {GRU_BWD_TOL}")
        # The whole backward through autograd (forward and backward kernels).
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, w_x, w_h)]
        ys_k, _ = k_gru.gru_scan(leaves[0], h0, leaves[1], leaves[2], b_x, b_h)
        ys_k.backward(g)
        if dtype == torch.bfloat16:
            # Against reference.gru_bwd_math (the plain reverse loop), with
            # the weight gradients rounded to bf16 as the autograd path does.
            want_dxp, _, want_dwh, _ = reference.gru_bwd_math(x_proj, ys, h0, wh_c, b_h, g)
            want_dwx = torch.einsum("btd,btk->dk", x.float(), want_dxp)
            w_tol = GRU_BWD_BF16_W_TOL
            w_errs = {"dW_h": rel_err(leaves[2].grad, want_dwh.to(dtype)),
                      "dW_x": rel_err(leaves[1].grad, want_dwx.to(dtype))}
        else:
            # Against autograd through the plain scan's own torch ops.
            plain_leaves = [t.detach().clone().requires_grad_(True) for t in (x, w_x, w_h)]
            ys_p, _ = k_gru.plain(plain_leaves[0], h0, plain_leaves[1], plain_leaves[2],
                                  b_x, b_h)
            ys_p.backward(g)
            w_tol = GRU_BWD_TOL
            w_errs = {"dW_h": rel_err(leaves[2].grad, plain_leaves[2].grad),
                      "dW_x": rel_err(leaves[1].grad, plain_leaves[1].grad),
                      "d_x": rel_err(leaves[0].grad, plain_leaves[0].grad)}
        for k, e in w_errs.items():
            check(e <= w_tol, f"gru backward {name}: {k} relative err {e} > {w_tol}")
        es = x.element_size()
        b_bytes = (4 * B * T * H * 4 + 2 * B * T * H * es + 3 * H * H * es
                   + B * T * 3 * H * 4 + B * H * 4)
        # d_hproj is f32, so the product runs at the f32 rate.
        b_flops = 2 * B * T * 3 * H * H
        b_bound, b_by = bound(b_bytes, b_flops, torch.float32)
        out[name] = {
            "shape": {"B": B, "T": T, "H": H, "dtype": name},
            "launch": k_gru.backward_launch_config(B, T, H, dtype),
            "rel_err": {**errs, **w_errs}, "tolerance": GRU_BWD_TOL,
            "weight_tolerance": w_tol,
            "max_abs_err": max(max_err(d_xp, want_xp), max_err(dh0, want_h0)),
            "kernel_ms": time_ms(lambda: k_gru.gru_backward(*planes)),
            "plain_ms": time_ms(lambda: k_gru.plain_backward(*planes), reps=5),
            "bound_ms": b_bound, "bound_by": b_by, "bytes": int(b_bytes),
            "flops": int(b_flops), "serial_steps": T,
        }
    # Library yardstick: cuDNN's GRU backward in f32 (TF32 off), timed as
    # (forward + backward) - forward. The port never calls it.
    lib = torch.nn.GRU(D, H, batch_first=True, device=dev, dtype=torch.float32)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(w_x.T)
        lib.weight_hh_l0.copy_(w_h.T)
        lib.bias_ih_l0.copy_(b_x)
        lib.bias_hh_l0.copy_(b_h)
    xg = x32.detach().clone().requires_grad_(True)
    h0f = torch.zeros(1, B, H, device=dev)

    def lib_fwd_bwd():
        lib(xg, h0f)[0].backward(g32)

    fb = time_ms(lib_fwd_bwd)
    fw = time_ms(lambda: lib(xg, h0f)[0])
    lib_ms = fb["median"] - fw["median"]
    for rec in out.values():
        rec["library_ms"] = {"median": lib_ms, "fwd_bwd": fb, "fwd": fw,
                             "what": "torch.nn.GRU f32 (cuDNN), backward = fwd+bwd - fwd"}
    return out


def _head_checks(rng, dev, table) -> dict:
    D = table.shape[1]
    N, S = TRAIN_B * TRAIN_T, NUM_NEG
    targets = torch.from_numpy(zipf_items(rng, N).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    neg_ids, nlq = sample_log_uniform(gen, S, VOCAB)
    neg_ids[:2] = targets[:2]  # plant accidental hits beside the natural ones
    nlq = log_uniform_log_prob(neg_ids, VOCAB)
    plq = log_uniform_log_prob(targets, VOCAB)
    h32 = torch.tanh(torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))).to(dev)
    pos32, neg32 = table[targets.long()], table[neg_ids.long()]
    w = torch.ones(N, device=dev)
    hits = int((neg_ids[None, :] == targets[:, None]).sum())
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        args = (h32.to(dtype), pos32.to(dtype), neg32.to(dtype), targets, neg_ids, plq, nlq)
        got = k_head.sampled_softmax_nll(*args)
        torch.cuda.synchronize()
        want = k_head.plain(*args)
        err = max_err(got, want)
        check(bool(torch.isfinite(got).all()), f"head {name}: non-finite nll")
        check(err <= HEAD_TOL, f"head {name}: kernel vs plain max abs err {err} > {HEAD_TOL}")
        # Loss and gradients, kernel forward + recompute backward, against
        # autograd through the plain loss (the JAX package's XLA formula).
        res = []
        for fn in (k_head.sampled_softmax_loss, reference.sampled_softmax_loss):
            leaves = [a.detach().clone().requires_grad_(True) for a in args[:3]]
            loss, _ = fn(*leaves, targets, neg_ids, w, pos_log_q=plq, neg_log_q=nlq)
            loss.backward()
            res.append([loss.detach()] + [a.grad for a in leaves])
        tol = HEAD_LOSS_BF16_TOL if dtype == torch.bfloat16 else GRU_BWD_TOL
        loss_rel = abs(res[0][0].item() - res[1][0].item()) / abs(res[1][0].item())
        grad_rel = {k: rel_err(a, b) for k, a, b in zip(("dh", "dpos", "dneg"),
                                                        res[0][1:], res[1][1:])}
        check(loss_rel <= tol, f"head {name}: loss relative err {loss_rel} > {tol}")
        for k, e in grad_rel.items():
            check(e <= 2 * tol, f"head {name}: {k} relative err {e} > {2 * tol}")
        es = args[0].element_size()
        h_bytes = (2 * N * D + S * D) * es + N * 4 * 3 + S * 4 * 2
        h_flops = 2 * N * S * D + 2 * N * D
        h_bound, h_by = bound(h_bytes, h_flops, dtype)
        hb, nb = args[0], args[2]
        out[name] = {
            "shape": {"N": N, "S": S, "H": D, "dtype": name, "accidental_hits": hits},
            "launch": k_head.launch_config(N, S, D, dtype),
            "max_abs_err": err, "tolerance": HEAD_TOL,
            "loss_rel_err": loss_rel, "grad_rel_err": grad_rel, "loss_tolerance": tol,
            "kernel_ms": time_ms(lambda: k_head.sampled_softmax_nll(*args)),
            "plain_ms": time_ms(lambda: k_head.plain(*args)),
            # No single PyTorch call computes this function.
            "library_ms": None,
            "partial_yardstick_matmul_ms": time_ms(lambda: hb @ nb.T),
            "bound_ms": h_bound, "bound_by": h_by, "bytes": int(h_bytes),
            "flops": int(h_flops),
        }
    return out


def phase_train_kernels(rng: np.random.Generator, dev) -> dict:
    D = 128
    table = torch.from_numpy(
        rng.normal(scale=D ** -0.5, size=(VOCAB, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(zipf_items(rng, TRAIN_B * TRAIN_T).astype(np.int32)).to(dev)
    x32 = k_gather.plain(table, ids.reshape(TRAIN_B, TRAIN_T))
    out = {"gather_backward": _scatter_add_check(rng, dev, table),
           "gru_backward": _gru_backward_checks(rng, dev, x32),
           "softmax_head": _head_checks(rng, dev, table)}
    emit({"phase": "train_kernels", **out})
    return out


COUNTERS = {
    "gather": k_gather.embedding_gather,
    "gather_backward": k_gather.embedding_scatter_add,
    "gru_scan": k_gru.gru_scan,
    "gru_backward": k_gru.gru_backward,
    "softmax_head": k_head.sampled_softmax_nll,
}


def read_counters() -> dict:
    return {k: fn.launches for k, fn in COUNTERS.items()}


class PhaseTimedTrainer(Trainer):
    """A Trainer that records a CUDA event at the start of a step's forward
    and at the end of its forward, backward and update."""

    events: list = []

    def _mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)

    def forward(self, *args, **kwargs):
        self._mark()
        out = super().forward(*args, **kwargs)
        self._mark()
        return out

    def backward(self, *args, **kwargs):
        out = super().backward(*args, **kwargs)
        self._mark()
        return out

    def update(self, *args, **kwargs):
        out = super().update(*args, **kwargs)
        self._mark()
        return out


def profile_steps(tr: Trainer, state, wires: torch.Tensor, top: int = 15) -> dict:
    """torch.profiler over len(wires) steps: device time and launches per
    step, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    n = wires.shape[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n):
            state, _ = tr.train_step(state, wires[k])
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, memsets): a CPU op's entry
    # repeats the device time of the kernels it launched.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(rows), "profile: the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": n,
        "device_ms_per_step": sum(r[1] for r in rows) / 1e3 / n,
        "device_launches_per_step": sum(r[2] for r in rows) / n,
        "top": [{"name": k[:90], "ms_per_step": t / 1e3 / n, "calls_per_step": c / n}
                for k, t, c in rows[:top]],
    }, state


class _Catalog:
    vocab_size, num_users = VOCAB, 0


def _train_wires(rng, trainer, groups: int, K: int, B: int, T: int) -> np.ndarray:
    """[groups, K, B, T+2] wires of Zipf histories (ids ranked by
    popularity), 5..T positions a row."""
    wires = []
    for _ in range(groups * K):
        inputs = np.zeros((B, T), np.int32)
        targets = np.zeros((B, T), np.int32)
        for r, n in enumerate(rng.integers(5, T + 1, size=B)):
            seq = zipf_items(rng, n + 1, ranked=True)
            inputs[r, :n], targets[r, :n] = seq[:-1], seq[1:]
        wire = trainer.pack_train_batch({"inputs": inputs, "targets": targets,
                                         "mask": (targets != 0).astype(np.float32)})
        check(wire is not None, "train: a canonical batch did not pack")
        wires.append(wire)
    return np.stack(wires).reshape(groups, K, B, T + 2)


def phase_train(rng: np.random.Generator, dev, seed: int, groups: int = 6) -> dict:
    cfg = RunConfig.load(CONFIG)
    check(cfg.model.use_pallas, f"{CONFIG} must enable the kernels")
    K, B = cfg.train.steps_per_call, cfg.data.batch_size
    T = max(cfg.data.buckets or (cfg.data.max_len,))
    layers = cfg.model.num_layers
    trainers = {}
    for use_pallas in (True, False):
        c = cfg.apply_overrides([f"model.use_pallas={str(use_pallas).lower()}"])
        trainers[use_pallas] = PhaseTimedTrainer(c, _Catalog(), device=dev)
    t0 = time.perf_counter()
    wires = _train_wires(rng, trainers[True], groups, K, B, T)
    data_s = time.perf_counter() - t0
    check(wires.dtype == np.int16 and wires.shape == (groups, K, B, T + 2),
          f"train: wires {wires.dtype} {wires.shape}")

    # Step 1 through the kernels and through the plain versions: same state,
    # batch and generators. (Also warms the kernel path up.)
    step1 = {}
    for use_pallas, tr in trainers.items():
        _, m = tr.train_step(tr.init_state(seed), wires[0, 0])
        step1[use_pallas] = {k: float(v) for k, v in m.items()}
    a, b = step1[True], step1[False]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    norm_rel = abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
    check(loss_rel <= STEP1_LOSS_TOL,
          f"train: step-1 loss {a['loss']} (kernels) vs {b['loss']} (plain)")
    check(norm_rel <= STEP1_NORM_TOL,
          f"train: step-1 grad_norm {a['grad_norm']} (kernels) vs {b['grad_norm']} (plain)")
    check(a["tokens"] == b["tokens"], "train: step-1 token counts differ")
    torch.cuda.synchronize()

    # The counted run: `groups` groups of K steps through the kernels.
    tr = trainers[True]
    for fn in COUNTERS.values():
        fn.launches = 0
    state = tr.init_state(seed)
    torch.cuda.reset_peak_memory_stats()
    times, group_metrics = [], []
    for gi in range(groups):
        t0 = time.perf_counter()
        state, m = tr.train_step_multi(state, wires[gi])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        group_metrics.append({k: float(v) for k, v in m.items()})
    launches = read_counters()
    peak_mem = torch.cuda.max_memory_allocated()
    steps = groups * K

    # One group through the plain versions: no kernel may launch.
    before = read_counters()
    t0 = time.perf_counter()
    _, pm = trainers[False].train_step_multi(trainers[False].init_state(seed), wires[0])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_launches = {k: v - before[k] for k, v in read_counters().items()}
    plain_group = {k: float(v) for k, v in pm.items()}

    for gm in group_metrics:
        check(np.isfinite(gm["loss"]) and np.isfinite(gm["grad_norm"]),
              f"train: non-finite metrics {gm}")
        check(gm["nonfinite"] == 0.0, f"train: a step flagged non-finite {gm}")
    check(group_metrics[-1]["loss"] < group_metrics[0]["loss"],
          f"train: loss did not fall ({group_metrics[0]['loss']} -> "
          f"{group_metrics[-1]['loss']})")
    want = {"gather": 3 * steps, "gather_backward": 3 * steps, "gru_scan": layers * steps,
            "gru_backward": layers * steps, "softmax_head": steps}
    check(launches == want, f"train: kernel launches {launches}, expected {want}")
    check(all(v == 0 for v in plain_launches.values()),
          f"train: the plain run launched kernels {plain_launches}")
    check(abs(plain_group["loss"] - group_metrics[0]["loss"])
          <= STEP1_LOSS_TOL * abs(plain_group["loss"]),
          f"train: group-1 mean loss {group_metrics[0]['loss']} (kernels) vs "
          f"{plain_group['loss']} (plain)")

    # Device time of a step, split by CUDA events: each step (its wire
    # already on the device) is queued behind a device sleep so the events
    # bracket the device's work, not the host's launch latency. Median over
    # the steps of one group.
    splits = []
    last = torch.from_numpy(wires[-1]).to(dev)
    for k in range(K):
        tr.events.clear()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        state, _ = tr.train_step(state, last[k])
        torch.cuda.synchronize()
        e = tr.events
        splits.append({"forward": e[0].elapsed_time(e[1]),
                       "backward": e[1].elapsed_time(e[2]),
                       "optimizer": e[2].elapsed_time(e[3]),
                       "total": e[0].elapsed_time(e[3])})
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    prof, state = profile_steps(tr, state, last[:4])
    step_ms = float(np.median(times)) / K
    result = {
        "phase": "train", "config": CONFIG, "vocab": VOCAB, "batch_size": B, "seq_len": T,
        "num_negatives": cfg.model.num_negatives, "steps_per_call": K, "groups": groups,
        "wire": {"dtype": str(wires.dtype), "shape": list(wires.shape[1:])},
        "data_seconds": data_s,
        "examples_per_s": steps * B / (sum(times) / 1e3),
        "step_ms_median": step_ms,
        "group_ms": times,
        "plain_group_ms": plain_ms, "plain_examples_per_s": K * B / (plain_ms / 1e3),
        "device_step_ms": split, "device_idle_share": 1.0 - split["total"] / step_ms,
        "profile": prof,
        "step1": {"kernels": a, "plain": b, "loss_rel_err": loss_rel,
                  "grad_norm_rel_err": norm_rel, "loss_tolerance": STEP1_LOSS_TOL,
                  "grad_norm_tolerance": STEP1_NORM_TOL},
        "group_metrics": group_metrics, "plain_group_metrics": plain_group,
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "plain_launches": plain_launches, "peak_memory_bytes": int(peak_mem),
    }
    emit(result)
    return result


def _kernel_entry(name, source, replaces, launches, rec, plain_key="plain_ms", **extra):
    lib = rec["library_ms"]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"]["median"], "plain_ms": rec[plain_key]["median"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None if lib is None else lib["median"], **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    smi, name = phase_device()
    phase_build()
    kern = phase_kernels(rng, dev)
    serve = phase_serve(rng, dev, args.seed)
    tkern = phase_train_kernels(rng, dev)
    train = phase_train(rng, dev, args.seed)

    g, r = kern["gather"], kern["gru_scan_bfloat16"]
    tl, sl = train["launches"], serve["launches"]
    src = "seqrec_tpu_torch/csrc/"
    emit({"kernels": [
        _kernel_entry("gather", src + "gather.cu", "seqrec_tpu/ops/pallas/gather.py:86",
                      tl["gather"], g, serve_launches=sl["gather"]),
        _kernel_entry("gather_backward", src + "gather.cu",
                      "seqrec_tpu/ops/pallas/gather.py:106",
                      tl["gather_backward"], tkern["gather_backward"]),
        _kernel_entry("gru_scan", src + "gru.cu", "seqrec_tpu/ops/pallas/gru.py:177",
                      tl["gru_scan"], r, dtype="bfloat16", serve_launches=sl["gru_scan"]),
        _kernel_entry("gru_backward", src + "gru.cu", "seqrec_tpu/ops/pallas/gru.py:190",
                      tl["gru_backward"], tkern["gru_backward"]["bfloat16"],
                      dtype="bfloat16"),
        _kernel_entry("softmax_head", src + "softmax_head.cu",
                      "seqrec_tpu/ops/pallas/softmax_head.py:115",
                      tl["softmax_head"], tkern["softmax_head"]["bfloat16"],
                      dtype="bfloat16"),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
