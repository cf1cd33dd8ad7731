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

UNITS = (16, 8, 4, 2)  # the bytes a kernel's load or store may move at once


def unit_bytes(*byte_counts: int) -> int:
    """The widest unit of UNITS that divides every count (row bytes, strides
    in bytes, base addresses): what the gather, the attention and the head
    move their rows in. 0 where none does (an odd count)."""
    a = UNITS[0]
    for c in byte_counts:
        a |= c
    low = a & -a  # the largest power of two dividing every count, at most 16
    return low if low >= UNITS[-1] else 0
