"""A probe of the GRU reverse recurrence's CUDA-core kernel on one NVIDIA GPU.

    python3 kernel_probes.py sass --root <checkout>

Builds <checkout>'s csrc/gru.cu (with that checkout's own _build, into its
build directory) and counts the instructions of its CUDA-core reverse
kernel, `gru_backward_kernel` with one row a block, W_h^T in shared memory
and no reset, by opcode from `cuobjdump -sass`, for each dtype it was
instantiated in: what an instantiation executes for each of its FMAs. (The
parent of the bf16 tensor-core redesign instantiated it in bf16 and f32.)

It prints one JSON object as its last line, beside the card's name and
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="probe", required=True)
    sass = sub.add_parser("sass", help="the CUDA-core reverse kernel's instruction mix")
    sass.add_argument("--root", default=str(HERE), help="the checkout to build and read")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_probes: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    result = probe_sass(Path(args.root).resolve())
    print(_smi(), flush=True)
    print(json.dumps({"probe": args.probe, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
