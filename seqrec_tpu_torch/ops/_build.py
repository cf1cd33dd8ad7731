"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own into
`build/lib<name>-<hash>.so` inside the package (listed in .gitignore), at
first use. The hash covers the source, the shared headers (`csrc/*.cuh`)
and the flags, so an edited source or header is rebuilt and an unchanged
one is reused. `build()` starts one nvcc per source
that needs it, all at once, and waits for every one. A failed build raises
with nvcc's output; nothing falls back.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

`-Xptxas -v` leaves each kernel's registers, shared memory and spills in
`build/<name>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("attention", "gather", "gru", "lstm", "softmax_head")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else the CUDA toolkit's default location."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
        "the CUDA kernels of seqrec_tpu_torch are built at first use and "
        "need the CUDA toolkit"
    )


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not built yet, in parallel. Returns
    {name: nvcc's log} for the sources compiled by this call."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = BUILD_DIR / f"{name}.log"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log_path))
    logs, failed = {}, []
    for name, proc, tmp, out, log_path in jobs:
        rc = proc.wait()
        logs[name] = log_path.read_text()
        if rc != 0:
            failed.append(f"{name}.cu (nvcc exit {rc}):\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
