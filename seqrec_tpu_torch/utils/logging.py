"""Structured metrics logging: the port's copy of
`seqrec_tpu/utils/logging.py`.

One JSON line per record to stdout and to `metrics.jsonl` in the run's
out dir; TensorBoard scalars too when `tensorboard` is set and
`torch.utils.tensorboard` imports. One process writes (the port runs one).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, tensorboard: bool = False):
        self._file = None
        self._tb = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
                except ImportError:
                    self._tb = None

    def log(self, step: int, tag: str, metrics: Dict[str, Any]) -> None:
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
    """A heartbeat file a monitor can watch: the last logged step and time."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, "heartbeat_0")  # one process: index 0

    def beat(self, step: int) -> None:
        with open(self._path, "w") as f:
            f.write(f"{step} {time.time()}\n")
