"""Hand-written Hopper kernels, one module per CUDA source: `attention`,
`gather`, `gru`, `head` (`csrc/softmax_head.cu`) and `lstm`.

Each module holds its kernels' wrappers (which launch `csrc/<name>.cu` for a
CUDA tensor, count the launch, and raise on what the kernel cannot take),
their plain PyTorch versions (`plain`, `plain_backward`, from
ops/reference.py; a wrapper uses them only for a tensor on the CPU), their
launch counters (`<wrapper>.launches`), and the `torch.autograd.Function`
that joins a forward kernel to its backward. Nothing here builds or loads a
kernel at import time.
"""
