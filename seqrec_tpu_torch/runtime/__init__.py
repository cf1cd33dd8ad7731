"""Device selection for the port's entry points, and the multi-device
runtime (`runtime.mesh`: the process group and the ('data', 'model') mesh)."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another one. A CUDA device on a machine without CUDA raises; nothing
    carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev


from seqrec_tpu_torch.runtime.mesh import (  # noqa: E402,F401
    DATA_AXIS,
    MODEL_AXIS,
    WORLD,
    Mesh,
    init_distributed,
    make_mesh,
    process_count,
    process_index,
    rank_device,
)
