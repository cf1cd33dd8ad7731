"""The multi-device runtime: the port of `seqrec_tpu/runtime/mesh.py` on
`torch.distributed`, one process per device.

    init_distributed()                        # torchrun: RANK, WORLD_SIZE, LOCAL_RANK
    init_distributed("host:port", 2, rank)    # or explicit, as the JAX CLI's flags
    mesh = make_mesh(model_axis=2)            # ('data', 'model') over the world

The mesh has the JAX package's two axes, `('data', 'model')`:

- `data`: data parallelism of the sequence tower (gradients summed);
- `model`: row sharding of the embedding tables.

JAX reshapes its devices to (data, model) and shards batch rows over both
axes flattened, so rank r has model index r % M and data index r // M,
holds batch rows [r B, (r + 1) B) of the global batch, and, when the tables
are sharded, table rows [(r % M) V / M, (r % M + 1) V / M). Each rank builds
two subgroups, in the same order on every rank: its model group (the ranks
of its data index) and its data group (the ranks of its model index).

Collectives (`all_gather`, `psum`, `psum_scatter`) go over an axis:
`"model"`, `"data"` or `WORLD`, tiled along dim 0 as JAX's `tiled=True`.
Without a process group (one process) the mesh is 1 x 1 and every
collective is the identity: today's single-device path, unchanged. With
one, every collective runs, over a group of one rank too (a sum over one
rank is an exact copy).

Backends: `init_distributed(backend=None)` takes NCCL for a CUDA device and
gloo for the CPU, and switches to no other when that fails. A caller that
wants gloo on CUDA tensors (two ranks sharing one card: NCCL refuses two
ranks on one device) asks for it by name. Under gloo every collective on a
CUDA tensor is staged through host memory: the tensor is copied to the
host, the collective runs there, the result is copied back. That is
explicit here and happens under gloo only; under NCCL the collectives run
on the device. `psum_scatter` under gloo is an all-reduce and a slice (gloo
has no reduce-scatter).

`Mesh.stats` counts the collectives a rank issued, their bytes, and the
seconds the host spent in them (with a device synchronize before and after
each one when `timed` is set: a copy through the host waits for the device
anyway; NCCL's own calls only enqueue).
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from seqrec_tpu_torch.runtime import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger("seqrec")

DATA_AXIS = "data"
MODEL_AXIS = "model"
WORLD = "world"


def is_distributed() -> bool:
    """True when a process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """This process's device index on its host: torchrun's LOCAL_RANK (0
    without one)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _local(device: Union[str, torch.device]) -> torch.device:
    """A CUDA device without an index as cuda:LOCAL_RANK; others as given."""
    dev = torch.device(device)
    return torch.device("cuda", local_rank()) if dev.type == "cuda" and dev.index is None else dev


def rank_device(device: Union[str, torch.device] = DEFAULT_DEVICE) -> torch.device:
    """The device of this rank: a CUDA device without an index is
    cuda:LOCAL_RANK once a process group is up; any other device is the
    caller's. Raises (resolve_device) for CUDA without CUDA."""
    return resolve_device(_local(device) if is_distributed() else device)


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    timeout: Optional[datetime.timedelta] = None,
) -> torch.device:
    """Start the process group; returns this rank's device.

    With no arguments it reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); without that either it stays one
    process (no group) and returns `device`. `coordinator` is "host:port"
    (rank 0's address, as the JAX CLI's --coordinator) or an init URL
    ("tcp://...", "file://..."). `backend`: None takes NCCL for a CUDA
    device and gloo for the CPU; a name is used as given. Nothing falls back
    to another backend or device. `timeout`: how long a collective waits for
    its peers (torch.distributed's default when None)."""
    if coordinator is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return resolve_device(device)
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("init_distributed needs coordinator, num_processes and "
                             "process_id together (or torchrun's environment)")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dev = resolve_device(_local(device))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(num_processes), rank=int(process_id), **kwargs)
    logger.info("distributed initialized: process %d/%d on %s over %s",
                dist.get_rank(), dist.get_world_size(), dev, backend)
    return dev


def shutdown() -> None:
    """Tear the process group down (a no-op without one)."""
    if is_distributed():
        dist.destroy_process_group()


class Mesh:
    """The ('data', 'model') mesh of the world's ranks (see the module
    docstring). `shape` is {'data': D, 'model': M}, as JAX's `mesh.shape`."""

    def __init__(self, data: int, model: int, timed: bool = False):
        self.shape: Dict[str, int] = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = data * model
        self.distributed = is_distributed()
        self.rank = process_index()
        self.backend = dist.get_backend() if self.distributed else None
        # rank = data_index * M + model_index (JAX's reshape to (data, model))
        self.coords: Dict[str, int] = {DATA_AXIS: self.rank // model, MODEL_AXIS: self.rank % model}
        self.timed = timed
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._groups: Dict[str, Optional[object]] = {WORLD: None, MODEL_AXIS: None, DATA_AXIS: None}
        if self.distributed:
            # Every rank creates every group, in one order (new_group's rule).
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if d == self.coords[DATA_AXIS]:
                    self._groups[MODEL_AXIS] = g
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if m == self.coords[MODEL_AXIS]:
                    self._groups[DATA_AXIS] = g
            self._groups[WORLD] = dist.group.WORLD

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, backend={self.backend})")

    def axis_size(self, axis: str) -> int:
        return self.size if axis == WORLD else self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.rank if axis == WORLD else self.coords[axis]

    def _live(self, axis: str) -> bool:
        """Whether a collective runs: always once a process group is up (a
        group of one rank too: its sum is an exact copy), never without."""
        return self.distributed

    def _run(self, t: torch.Tensor, fn) -> torch.Tensor:
        """Run fn(host_or_device_tensor) -> tensor, staged through host
        memory for a CUDA tensor under gloo, with the stats."""
        t0 = time.perf_counter()
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        stage = self.backend == "gloo" and t.is_cuda
        out = fn(t.cpu() if stage else t.contiguous())
        if stage:
            out = out.to(t.device)
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def psum(self, t: torch.Tensor, axis: str = WORLD) -> torch.Tensor:
        """The sum of `t` over the ranks of `axis` (a new tensor)."""
        if not self._live(axis):
            return t

        def fn(x):
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self._groups[axis])
            return x

        return self._run(t, fn)

    def all_gather(self, t: torch.Tensor, axis: str = WORLD) -> torch.Tensor:
        """The ranks' `t`s of `axis` concatenated along dim 0, in axis-index
        order (JAX's all_gather(tiled=True))."""
        if not self._live(axis):
            return t
        n = self.axis_size(axis)
        group = self._groups[axis]

        def fn(x):
            if self.backend == "nccl":
                out = x.new_empty((n * x.shape[0], *x.shape[1:]))
                dist.all_gather_into_tensor(out, x, group=group)
                return out
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            return torch.cat(parts)

        return self._run(t, fn)

    def psum_scatter(self, t: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
        """The sum over the ranks of `axis`, of which this rank keeps its
        axis index's block of dim 0 (JAX's psum_scatter(tiled=True)); dim 0
        must divide the axis size."""
        if not self._live(axis):
            return t
        n = self.axis_size(axis)
        if t.shape[0] % n:
            raise ValueError(f"psum_scatter: dim 0 of {tuple(t.shape)} must divide {n}")
        rows = t.shape[0] // n
        i = self.axis_index(axis)
        group = self._groups[axis]

        def fn(x):
            if self.backend == "nccl":
                out = x.new_empty((rows, *x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
                return out
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
            return x[i * rows:(i + 1) * rows].clone()

        return self._run(t, fn)

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor the backend reduces: on the current CUDA
        device for NCCL (which reduces device tensors only)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(torch.cuda.current_device()) if self.backend == "nccl" else t

    def psum_host(self, a: np.ndarray) -> np.ndarray:
        """`psum` over the world of a host array (metric sums)."""
        if not self._live(WORLD):
            return a
        return self.psum(self._host_tensor(a), WORLD).cpu().numpy()

    def pmax_int(self, v: int) -> int:
        """The largest of the world's `v`s."""
        if not self._live(WORLD):
            return int(v)

        def fn(x):
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            return x

        return int(self._run(self._host_tensor(np.array([int(v)], np.int64)), fn).item())

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def make_mesh(model_axis: int = 1, data_axis: int = -1, *, timed: bool = False) -> Mesh:
    """The 2-axis ('data', 'model') mesh over the world's ranks (one rank
    without a process group). model_axis = embedding-table row shards (must
    divide the rank count); data_axis = -1: all remaining ranks. The errors
    are the JAX package's."""
    n = process_count()
    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    if n % model_axis != 0:
        raise ValueError(f"model_axis={model_axis} must divide device count {n}")
    data = n // model_axis if data_axis == -1 else data_axis
    if data * model_axis != n:
        raise ValueError(f"mesh {data}x{model_axis} does not cover {n} devices")
    return Mesh(data, model_axis, timed=timed)
