"""Probes of the port's kernels on one NVIDIA GPU.

    python3 kernel_probes.py clusters [--out FILE]
    python3 kernel_probes.py xproj [--out FILE]

`clusters` sweeps the f32 cluster recurrences over their cluster size C and
rows a cluster R (each launch checked against its plain version first):
the GRU forward at B=64 and 128, T=200, D=H=128 and its reset variant at
B=256, T=50, D=H=100, the LSTM forward at B=64 and 128, T=200, D=H=128 and
its reset variant at B=128 and at B=256, T=50, D=H=100 (each forward with
its f32 input projection, as the wrapper runs it), the LSTM reverse
recurrence at B=128, T=200, H=128 with and without a keep plane, and the
GRU reverse recurrence (its gates recomputed inside) at B=64 and 128,
T=200, H=128, at B=128, T=200, H=100 and at B=256, T=50, H=100 with and
without a keep plane; median of 21 CUDA-event runs (chip_smoke.time_ms)
for each (C, R) that fits, beside the launch_config default.

`xproj` builds kernel_probes.cu (nvcc, into seqrec_tpu_torch/build/) and
times, at M=12,800 and 25,600 with N=384 and N=512 (D=128) and at
M=12,800, D=100, N=300, each against x @ W_x + b in f64 first: variants of
the f32 input projection (tile rows, k chunk, ring stages, CTAs a SM; the
shipped one is m64_k32_s2_c4) beside torch.addmm f32, and an 8 x 8
outer-product loop with its refills, its shared-memory reads and its stores
switched off one by one; and the card's f32 FMA rate on independent
register chains.

Each prints one JSON object as its last line, beside the card's name and
power limit, and exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def probe_clusters() -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import _build, reference
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(["gru", "lstm"])
    rng = np.random.default_rng(0)
    out = {"gru_forward": {}, "lstm_forward": {}, "lstm_backward": {}, "gru_backward": {}}

    def sweep(module, attr, run, want, B, H, tol, key, group):
        real = getattr(module, attr)
        default = real(B, 200, H, torch.float32) if attr == "backward_launch_config" else \
            real(B, 200, H, H, torch.float32)
        rows = {"default": {k: default[k] for k in ("cluster_size", "rows_per_cluster")}}
        for C in (2, 4, 8):
            for R in (4, 8, 16):
                try:
                    real(*((B, 200, H) if attr == "backward_launch_config" else (B, 200, H, H)),
                         torch.float32, rows_per_cluster=R, cluster_size=C)
                except ValueError:
                    continue
                setattr(module, attr, lambda *a, **kw: real(*a, rows_per_cluster=R,
                                                             cluster_size=C))
                try:
                    got = run()
                    torch.cuda.synchronize()
                    err = max(cs.rel_err(g, w) for g, w in zip(got, want))
                    if err > tol:
                        raise AssertionError(f"{key} C={C} R={R}: relative err {err} > {tol}")
                    rows[f"C{C}_R{R}"] = {"ms": cs.time_ms(run)["median"], "rel_err": err}
                finally:
                    setattr(module, attr, real)
        out[group][key] = rows

    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False), (256, 50, 100, True)):
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        w_x, w_h, b_x, b_h = (w.to(dev) for w in cs.gru_weights(rng, H, H))
        h0 = cs._state(rng, dev, B, H)
        keep = None if not reset else 1.0 - cs._reset_plane(rng, B, T, dev)

        def run_fwd():
            return (k_gru._forward_kernel(x, h0, w_x, w_h, b_x, b_h, keep),)

        want = (reference.gru_scan(x, h0, w_x, w_h, b_x, b_h,
                                   reset_mask=None if keep is None else 1.0 - keep)[0],)
        sweep(k_gru, "launch_config", run_fwd, want, B, H, 1e-5,
              f"B{B}_T{T}_H{H}" + ("_reset" if reset else ""), "gru_forward")

    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False),
                           (128, 200, 128, True), (256, 50, 100, True)):
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        w_x, w_h, b = (w.to(dev) for w in cs.lstm_weights(rng, H, H))
        h0, c0 = cs._state(rng, dev, B, H), cs._state(rng, dev, B, H)
        plane = cs._reset_plane(rng, B, T, dev) if reset else None

        def run_lstm():
            return k_lstm._forward_kernel(x, h0, c0, w_x, w_h, b, False,
                                          None if plane is None else 1.0 - plane)[:2]

        ys, (_, c_last) = reference.lstm_scan(x, h0, c0, w_x, w_h, b, reset_mask=plane)
        sweep(k_lstm, "launch_config", run_lstm, (ys, c_last), B, H, 1e-5,
              f"B{B}_T{T}_H{H}" + ("_reset" if reset else ""), "lstm_forward")

    B, T, H = 128, 200, 128
    planes = [torch.from_numpy(rng.uniform(0.05, 0.95, size=(B, T, H)).astype(np.float32))
              .to(dev) for _ in range(4)]
    i_, f_, o_ = planes[:3]
    g_ = torch.tanh(planes[3] * 4 - 2)
    tc = torch.tanh(cs._state(rng, dev, B * T, H).reshape(B, T, H))
    c_in = cs._state(rng, dev, B * T, H).reshape(B, T, H)
    g_ys = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02
    w_h = cs.lstm_weights(rng, H, H)[1].to(dev)
    dcl = cs._state(rng, dev, B, H) * 0.02
    for key, keep in (("B128_T200_H128", None),
                      ("B128_T200_H128_keep", (1.0 - cs._reset_plane(rng, B, T, dev))[..., None])):
        args = (i_, f_, g_, o_, tc, c_in, g_ys, w_h, keep, dcl)
        want = reference.lstm_bwd_scan(*args)
        sweep(k_lstm, "backward_launch_config", lambda: k_lstm.lstm_backward(*args), want, B, H,
              1e-4, key, "lstm_backward")

    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False),
                           (128, 200, 100, False), (256, 50, 100, False), (256, 50, 100, True)):
        x_proj = cs._state(rng, dev, B * T, 3 * H).reshape(B, T, 3 * H) * 4
        h_proj = cs._state(rng, dev, B * T, 3 * H).reshape(B, T, 3 * H) * 4
        h_in = torch.tanh(cs._state(rng, dev, B * T, H).reshape(B, T, H))
        g_ys = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02
        w_h = cs.gru_weights(rng, H, H)[1].to(dev)
        keep = (1.0 - cs._reset_plane(rng, B, T, dev))[..., None] if reset else None
        args = (x_proj, h_proj, h_in, g_ys, w_h, keep)
        want = k_gru.plain_backward(*args)
        sweep(k_gru, "backward_launch_config", lambda: k_gru.gru_backward(*args), want, B, H,
              1e-4, f"B{B}_T{T}_H{H}" + ("_keep" if reset else ""), "gru_backward")
    return out


def probe_xproj() -> dict:
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libkernel_probes.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(HERE), "-o",
                        str(lib_path), str(HERE / "kernel_probes.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc kernel_probes.cu failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    variants = ["m128_k32_s3_c2", "m64_k32_s2_c4", "m64_k32_s3_c3", "m64_k16_s3_c4",
                "m64_k16_s4_c4"]
    loops = ["loop_full", "loop_no_refill", "loop_no_smem_reads", "loop_no_stores", "loop_bare"]
    for name in variants + loops:
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ffma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, device=dev)
    iters, blocks = 20000, 2 * sms
    ms = cs.time_ms(lambda: lib.ffma_rate(sink.data_ptr(), iters, blocks), reps=5)["median"]
    out = {"ffma_tflops": 2.0 * blocks * 256 * iters * 8 * 16 / ms / 1e9, "shapes": {}}
    rng = np.random.default_rng(0)
    for M, D, N in ((12800, 128, 384), (25600, 128, 384), (12800, 128, 512), (25600, 128, 512),
                    (12800, 100, 300)):
        x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.normal(size=(D, N)) * D ** -0.5).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        want = x.double() @ w.double() + b.double()
        rec = {"addmm_ms": cs.time_ms(lambda: torch.addmm(b, x, w))["median"],
               "bound_ms": 2.0 * M * D * N / cs.PEAK_FLOPS[torch.float32] * 1e3}
        for name in variants + loops:
            xp = torch.empty(M, N, device=dev)
            fn = getattr(lib, name)

            def call():
                rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), xp.data_ptr(), M, D, N,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = (xp.double() - want).abs().max().item() if name in variants + loops[:1] else None
            if err is not None and err > 1e-5:
                raise AssertionError(f"xproj {name} {M}x{D}x{N}: max abs err {err} vs f64")
            rec[name] = {"ms": cs.time_ms(call)["median"], "max_abs_err_vs_f64": err}
        out["shapes"][f"M{M}_D{D}_N{N}"] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="probe", required=True)
    for name, text in (("clusters", "the f32 cluster recurrences over C and R"),
                       ("xproj", "the f32 input projection's variants and its loop's parts")):
        sub.add_parser(name, help=text).add_argument(
            "--out", help="also write the result (indented JSON) to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_probes: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    result = probe_clusters() if args.probe == "clusters" else probe_xproj()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(_smi(), flush=True)
    print(json.dumps({"probe": args.probe, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
