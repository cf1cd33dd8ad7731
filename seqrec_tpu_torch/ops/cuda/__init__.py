"""Hand-written Hopper kernels, one module per kernel.

Each module holds the kernel's wrapper (which launches `csrc/<name>.cu` for a
CUDA tensor, counts the launch, and raises on what the kernel cannot take),
its plain PyTorch version (`plain`, from ops/reference.py; the wrapper uses it
only for a tensor on the CPU), and its launch counter (`<wrapper>.launches`).
Nothing here builds or loads a kernel at import time.
"""
