"""Probes of the port's recurrent kernels on one NVIDIA GPU.

    python3 kernel_probes.py sass --root <checkout>
    python3 kernel_probes.py clusters [--out FILE]

`sass` builds <checkout>'s csrc/gru.cu (with that checkout's own _build,
into its build directory) and counts the instructions of its CUDA-core
reverse kernel, `gru_backward_kernel` with one row a block, W_h^T in shared
memory and no reset, by opcode from `cuobjdump -sass`, for each dtype it was
instantiated in: what an instantiation executes for each of its FMAs. (The
parent of the bf16 tensor-core redesign instantiated it in bf16 and f32.)

`clusters` sweeps the f32 cluster recurrences over their cluster size C and
rows a cluster R (each launch checked against its plain version first):
the GRU forward at B=64 and 128, T=200, D=H=128 and its reset variant at
B=256, T=50, D=H=100, the LSTM forward at B=64 and 128, T=200, D=H=128 and
its reset variant at B=128 and at B=256, T=50, D=H=100 (each forward with its f32 input projection, as
the wrapper runs it), and the LSTM reverse recurrence at B=128, T=200,
H=128 with and without a keep plane; median of 21 CUDA-event runs
(chip_smoke.time_ms) for each (C, R) that fits, beside the launch_config
default.

Each prints one JSON object as its last line, beside the card's name and
power limit, and exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def probe_sass(root: Path) -> dict:
    from seqrec_tpu_torch.ops import _build

    subprocess.run([sys.executable, "-c",
                    "from seqrec_tpu_torch.ops import _build; _build.build(['gru'])"],
                   cwd=root, check=True, env=dict(os.environ, PYTHONPATH=str(root)))
    lib = max((root / "seqrec_tpu_torch/build").glob("libgru-*.so"), key=lambda p: p.stat().st_mtime)
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    mix = {}
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        name, body = m.groups()
        # gru_backward_kernel<T, R = 1, kWInSmem = true, kReset = false>
        if "gru_backward_kernel" not in name or "Li1ELb1ELb0E" not in name:
            continue
        ops = [op.split(".")[0] for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]
        counts = {}
        for op in ops:
            counts[op] = counts.get(op, 0) + 1
        mix["bfloat16" if "nv_bfloat16" in name else "float32"] = {
            "instructions": len(ops),
            "by_opcode": dict(sorted(counts.items(), key=lambda kv: -kv[1])[:20])}
    return {"library": lib.name, "gru_backward_kernel": mix}


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
    out = {"gru_forward": {}, "lstm_forward": {}, "lstm_backward": {}}

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
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="probe", required=True)
    sass = sub.add_parser("sass", help="the CUDA-core reverse kernel's instruction mix")
    sass.add_argument("--root", default=str(HERE), help="the checkout to build and read")
    clusters = sub.add_parser("clusters", help="the f32 cluster recurrences over C and R")
    clusters.add_argument("--out", help="also write the result (indented JSON) to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_probes: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    if args.probe == "sass":
        result = probe_sass(Path(args.root).resolve())
    else:
        result = probe_clusters()
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
    print(_smi(), flush=True)
    print(json.dumps({"probe": args.probe, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
