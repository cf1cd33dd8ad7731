"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

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
  e. the kernels line: {"kernels": [{name, route, source, replaces,
              launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
              library_ms}, ...]}.

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
from seqrec_tpu_torch.eval import infer
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params
from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.cuda import gather as k_gather
from seqrec_tpu_torch.ops.cuda import gru as k_gru

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


def zipf_items(rng: np.random.Generator, n: int) -> np.ndarray:
    """Item ids 1..VOCAB-1 with Zipf(1.0) popularity over a random ranking."""
    ranks = np.arange(1, VOCAB)
    p = 1.0 / ranks
    p /= p.sum()
    order = rng.permutation(ranks)
    return order[rng.choice(VOCAB - 1, size=n, p=p)]


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
    lim = np.sqrt(6.0 / (D + 3 * H))
    w_x = torch.from_numpy(rng.uniform(-lim, lim, size=(D, 3 * H)).astype(np.float32))
    q, r = np.linalg.qr(rng.normal(size=(3 * H, H)))
    w_h = torch.from_numpy((q * np.sign(np.diag(r))).T.astype(np.float32))
    b_x = torch.from_numpy(rng.normal(scale=0.1, size=3 * H).astype(np.float32))
    b_h = torch.from_numpy(rng.normal(scale=0.1, size=3 * H).astype(np.float32))
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

    g, r = kern["gather"], kern["gru_scan_bfloat16"]
    emit({"kernels": [
        {"name": "gather", "route": "cuda", "source": "seqrec_tpu_torch/csrc/gather.cu",
         "replaces": "seqrec_tpu/ops/pallas/gather.py:86",
         "launches": serve["launches"]["gather"], "max_abs_err": g["max_abs_err"],
         "ms": g["kernel_ms"]["median"], "plain_ms": g["plain_ms"]["median"],
         "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
         "library_ms": g["library_ms"]["median"]},
        {"name": "gru_scan", "route": "cuda", "source": "seqrec_tpu_torch/csrc/gru.cu",
         "replaces": "seqrec_tpu/ops/pallas/gru.py:177", "dtype": "bfloat16",
         "launches": serve["launches"]["gru_scan"], "max_abs_err": r["max_abs_err"],
         "ms": r["kernel_ms"]["median"], "plain_ms": r["plain_ms"]["median"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]["median"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
