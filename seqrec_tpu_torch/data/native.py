"""ctypes bindings for the native C++ data engine (`native/seqrec_data.cc`):
the port's copy of `seqrec_tpu/data/native.py`.

The native loader owns shuffled epoch iteration, truncation, bucketed
padding and a background thread that fills a ring of ready batches (and,
for session-parallel training, packs the compact session wire): the host
side of the feed. The port builds its own copy of the engine from the
checkout's `native/seqrec_data.cc` with g++ at first use, into
`seqrec_tpu_torch/build/libseqrec_data-<hash>.so` (the hash covers the
source and the flags), and never loads the JAX package's build.

When the engine cannot be built (no g++, no source), `available()` is False
and the trainer takes the Python pipeline (`data/batching.py`), as the JAX
package does. `NativeTrainLoader` gives the same batches as the JAX
package's native loader for the same dataset and seed (the same engine); its
shuffle is the engine's own generator, so it is a deterministic alternative
to `make_train_batches`, with the same batch semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from seqrec_tpu_torch.data.dataset import SequenceDataset
from seqrec_tpu_torch.ops._build import BUILD_DIR, PKG_DIR

SOURCE = PKG_DIR.parent / "native" / "seqrec_data.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libseqrec_data-{digest}.so"


def build() -> Path:
    """Compile the engine with g++ unless this source and these flags are
    built already; returns the library's path. Raises on a failed build."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data engine is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native data engine build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The bound engine, building it first if needed; None (and the reason
    in `build_error()`) when it cannot be built or bound."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None and _build_error is None:
            try:
                if not SOURCE.exists():
                    raise RuntimeError(f"{SOURCE} not found")
                _lib = _bind(build())
            except (RuntimeError, OSError, AttributeError, subprocess.SubprocessError) as e:
                _build_error = str(e)
    return _lib


def build_error() -> Optional[str]:
    """Why the engine is not available, or None."""
    _load()
    return _build_error


def _bind(path: Path) -> ctypes.CDLL:
    """Load the library and bind its C ABI."""
    lib = ctypes.CDLL(str(path))
    lib.srd_create.restype = ctypes.c_void_p
    lib.srd_create.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64,
    ]
    lib.srd_next_batch.restype = ctypes.c_int
    lib.srd_next_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.srd_destroy.restype = None
    lib.srd_destroy.argtypes = [ctypes.c_void_p]
    lib.srs_create.restype = ctypes.c_void_p
    lib.srs_create.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.srs_next.restype = ctypes.c_int
    lib.srs_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.srs_destroy.restype = None
    lib.srs_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the native engine is built and bound."""
    return _load() is not None


class NativeTrainLoader:
    """Infinite stream of bucketed train batches from the C++ engine."""

    def __init__(
        self,
        ds: SequenceDataset,
        *,
        batch_size: int,
        max_len: int,
        buckets: Sequence[int] = (),
        seed: int = 0,
        host_shard: Tuple[int, int] = (0, 1),
        hold_out: int = 2,  # leave-last-out: last 2 items held for val/test
        prefetch: int = 4,
        skip_batches: int = 0,  # resume: batches to skip without building them
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native data engine not available: {build_error()}")
        self._lib = lib
        self.batch_size = batch_size
        self.max_len = max_len
        items = np.ascontiguousarray(ds.items, dtype=np.int32)
        offsets = np.ascontiguousarray(ds.offsets, dtype=np.int64)
        bucket_arr = np.ascontiguousarray(
            sorted(set(min(b, max_len) for b in buckets)) or [max_len],
            dtype=np.int32,
        )
        self._handle = lib.srd_create(
            items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(items),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offsets),
            batch_size, max_len,
            bucket_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(bucket_arr),
            seed + 1_000_003 * host_shard[0],
            host_shard[0], host_shard[1], hold_out, prefetch,
            skip_batches,
        )
        if not self._handle:
            raise RuntimeError("srd_create failed")
        # Reused output buffers at max size; sliced per bucket on yield.
        self._inputs = np.empty((batch_size, max_len), np.int32)
        self._targets = np.empty((batch_size, max_len), np.int32)
        self._mask = np.empty((batch_size, max_len), np.float32)
        self._users = np.empty((batch_size,), np.int32)

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        if self._handle is None:
            raise StopIteration
        bucket = self._lib.srd_next_batch(
            self._handle,
            self._inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._targets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if bucket < 0:
            raise StopIteration
        B, T = self.batch_size, bucket
        n = B * T
        # The engine writes row-major [B, T]; copy out so the caller owns it.
        return bucket, {
            "inputs": self._inputs.ravel()[:n].reshape(B, T).copy(),
            "targets": self._targets.ravel()[:n].reshape(B, T).copy(),
            "mask": self._mask.ravel()[:n].reshape(B, T).copy(),
            "users": self._users.copy(),
        }

    def close(self) -> None:
        if self._handle is not None:
            self._lib.srd_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeSessionLoader:
    """Infinite session-parallel packed stream from the C++ engine.

    Yields ``(window, payload)`` where payload is a ready [B, T+E+W] wire
    array (the trainer's compact session format, packed in C++) or, when a
    window has more session ends than the budget E, the raw {inputs,
    targets, mask, reset} planes. Same stream semantics as
    `data.batching.SessionStream` (lanes, epochs, per-shard users, snapshot
    resume); the shuffle is the engine's mt19937_64, so the two loaders are
    deterministic alternatives, not equal streams: a snapshot is restored
    by the loader kind that took it (its "engine" key says which).
    """

    def __init__(
        self,
        ds: SequenceDataset,
        *,
        batch_size: int,
        window: int,
        ends_budget: int,
        wire_dtype=np.int16,
        seed: int = 0,
        host_shard: Tuple[int, int] = (0, 1),
        hold_out: int = 2,
        prefetch: int = 4,
        snapshot_depth: int = 16,
        state: Optional[dict] = None,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native data engine not available: {build_error()}")
        self._lib = lib
        self._ds = ds
        self.batch_size = batch_size
        self.window = window
        self.ends_budget = ends_budget
        self._wire_dtype = wire_dtype
        self._seed = seed
        self._host_shard = host_shard
        self._hold_out = hold_out
        self._prefetch = prefetch
        self._snapshot_depth = snapshot_depth
        self._items = np.ascontiguousarray(ds.items, dtype=np.int32)
        self._offsets = np.ascontiguousarray(ds.offsets, dtype=np.int64)
        W = (window + 7) // 8
        self._wire = np.empty((batch_size, window + ends_budget + W), np.int32)
        self._inputs = np.empty((batch_size, window), np.int32)
        self._targets = np.empty((batch_size, window), np.int32)
        self._reset = np.empty((batch_size, window), np.float32)
        self._snap = np.empty((2 + 3 * batch_size,), np.int64)
        self._snapshots: list = []
        self._pending = None  # one-slot pushback for state_at's peek
        # Guards _pull/_pending/_count/_snapshots: state_at's live-head peek
        # runs on the loop's thread while a DevicePrefetcher feeder may be
        # inside __next__; both share the C queue and the output buffers.
        self._pull_lock = threading.Lock()
        self._count = 0
        self._handle = None
        self._open(state)

    def _open(self, state: Optional[dict]) -> None:
        if state is None:
            epoch, pos, lanes_ptr = -1, 0, None
        else:
            epoch = int(state["epoch"])
            pos = int(state["pos"])
            lanes = np.full((self.batch_size, 3), -1, np.int64)
            for r, l in enumerate(state["lanes"]):
                if l is not None:
                    lanes[r] = (int(l[0]), int(l[1]), int(bool(l[2])))
            lanes = np.ascontiguousarray(lanes)
            self._restore_lanes = lanes  # keep alive through the C call
            lanes_ptr = lanes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            self._count = int(state.get("count", 0))
        self._handle = self._lib.srs_create(
            self._items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self._items),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self._offsets),
            self.batch_size, self.window, self.ends_budget,
            self._seed + 1_000_003 * self._host_shard[0],
            self._host_shard[0], self._host_shard[1],
            self._hold_out, self._prefetch,
            epoch, pos, lanes_ptr,
        )
        if not self._handle:
            raise RuntimeError("srs_create failed (does the host shard have "
                               "sessions with a transition?)")

    # ---- position snapshots (same contract as SessionStream) -------------

    def _snap_dict(self, snap: np.ndarray) -> dict:
        return {
            "engine": "native",
            "count": self._count,
            "epoch": int(snap[0]),
            "pos": int(snap[1]),
            "lanes": [
                None if snap[2 + 3 * r] < 0 else
                [int(snap[2 + 3 * r]), int(snap[3 + 3 * r]),
                 bool(snap[4 + 3 * r])]
                for r in range(self.batch_size)
            ],
        }

    def state_at(self, n: int) -> dict:
        with self._pull_lock:
            for count, snap in list(self._snapshots):
                if count == n:
                    return snap
            if n == self._count and self._pending is None and self._handle:
                # The live head, not pulled yet: the snapshot before batch
                # n rides on batch n, so pull it, keep it for the next
                # __next__, and serve the snapshot it carried.
                self._pending = self._pull_locked()
                return self._snapshots[-1][1]
        raise KeyError(
            f"no snapshot for batch {n} "
            f"(have {[c for c, _ in self._snapshots]})"
        )

    def restore(self, state: dict) -> None:
        self.close()
        with self._pull_lock:
            self._snapshots = []
            self._pending = None
            self._open(state)

    # ---- iteration -------------------------------------------------------

    def __iter__(self) -> "NativeSessionLoader":
        return self

    def __next__(self):
        with self._pull_lock:
            if self._pending is not None:
                item, self._pending = self._pending, None
                return item
            return self._pull_locked()

    def _pull_locked(self):
        if self._handle is None:
            raise StopIteration
        kind = self._lib.srs_next(
            self._handle,
            self._wire.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._targets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._reset.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._snap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if kind < 0:
            raise StopIteration
        self._snapshots.append((self._count, self._snap_dict(self._snap)))
        if len(self._snapshots) > self._snapshot_depth:
            self._snapshots.pop(0)
        self._count += 1
        if kind == 1:
            return self.window, self._wire.astype(self._wire_dtype)
        B, T = self.batch_size, self.window
        return self.window, {
            "inputs": self._inputs.copy(),
            "targets": self._targets.copy(),
            "mask": np.ones((B, T), np.float32),
            "reset": self._reset.copy(),
        }

    def close(self) -> None:
        if self._handle is not None:
            self._lib.srs_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
