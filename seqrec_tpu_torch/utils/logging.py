"""Structured metrics logging: the port's copy of
`seqrec_tpu/utils/logging.py`.

One JSON line per record to stdout and to `metrics.jsonl` in the run's
out dir; TensorBoard scalars too when `tensorboard` is set and
`torch.utils.tensorboard` imports. Host 0 writes (`host0`: the rank's say;
the other ranks' loggers write nothing). Every rank beats its own
`heartbeat_<rank>`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, tensorboard: bool = False,
                 host0: bool = True):
        self._is_host0 = host0
        self._file = None
        self._tb = None
        if host0 and out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
                except ImportError:
                    self._tb = None

    def log(self, step: int, tag: str, metrics: Dict[str, Any]) -> None:
        if not self._is_host0:
            return
        rec = {"step": int(step), "tag": tag, "time": time.time()}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        line = json.dumps(rec)
        print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._tb:
            for k, v in metrics.items():
                v = _to_py(v)
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{tag}/{k}", v, step)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()


def _to_py(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class Heartbeat:
    """A heartbeat file a monitor can watch, one a process
    (`heartbeat_<rank>`): the last logged step and time."""

    def __init__(self, out_dir: str, rank: int = 0):
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, f"heartbeat_{rank}")

    def beat(self, step: int) -> None:
        with open(self._path, "w") as f:
            f.write(f"{step} {time.time()}\n")
