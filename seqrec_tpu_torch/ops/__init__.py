"""Compute ops: hand-written Hopper kernels and their plain PyTorch versions.

- `ops.reference`: plain PyTorch, the oracle and the CPU path;
- `ops.cuda.*`: the kernels (`csrc/*.cu`, built by `ops._build`);
- `ops.dispatch`: picks per call from `use_pallas` and the tensor's device.
"""

from seqrec_tpu_torch.ops.dispatch import (  # noqa: F401
    embedding_gather,
    gru_scan,
    sampled_softmax_loss,
)
