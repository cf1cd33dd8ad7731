"""seqrec_tpu_torch — the PyTorch/CUDA port of seqrec_tpu for one NVIDIA H100.

A second package beside the JAX reference (`seqrec_tpu/`), built slice by
slice. It imports torch and numpy only: never JAX, and nothing of the JAX
package. Layout and names mirror the reference so each counterpart is easy to
find:

- `config`: the same config tree, so `configs/*.json` load unchanged;
- `ops.reference`: plain PyTorch versions of the hot ops (the oracle and the
  CPU path); `ops.cuda.*`: hand-written Hopper kernels (CUDA C++ in `csrc/`,
  built with nvcc at first use, bound with ctypes); `ops.dispatch` picks;
- `models`: `SeqRecModel` (serving methods and every training loss),
  `RNNTower`, and `convert` (JAX params -> state_dict);
- `data.negative`: the negative samplers, drawn on the device;
- `train`: `TrainState`, the optax-equivalent optimizer and schedules, and
  `Trainer.train_step` / `train_step_multi`: the training step;
- `eval.infer.recommend` and the `recommend` CLI: the serving path.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from seqrec_tpu_torch.config import (  # noqa: F401
    DataConfig,
    EvalConfig,
    MeshConfig,
    ModelConfig,
    RunConfig,
    TrainConfig,
)
