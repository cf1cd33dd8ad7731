"""Device selection for the port's entry points."""

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
