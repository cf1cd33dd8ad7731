"""Checkpoint and resume: the port of `seqrec_tpu/train/checkpoint.py`,
with torch files in place of orbax.

A checkpoint is a directory `<dir>/<step>/` holding

    params.pt   the parameters (`TrainState.params`, f32 tensors by name)
    state.pt    the rest of the state: `opt_state` (count, then mu/nu or
                sum_of_squares), `embed_opt` (the sparse tables' row state)
                and `carry` (the session-parallel recurrent state)
    meta.json   step, rng_seed, data_position (batches the run consumed)
                and, for a session-parallel stream, data_state (its
                position snapshot, with the engine that took it), the mesh's
                shape past one device, and the caller's `info` (the trainer's: vocab_size
                and num_users, which `recommend --ckpt` reads)

so that `recommend` reads the parameters alone. A save copies the state's
tensors to host memory on the caller's thread (a sparse step updates its
tables in place, so the copy must be taken before the next step), then
writes the files on a background thread, the counterpart of orbax's async
save; `wait()` joins it. Each step is written into `<step>.tmp/` and renamed
to `<step>/` when complete, so a killed save never leaves a checkpoint that
`latest_step` would pick; the last `keep` steps are kept. `restore` loads
the newest step onto a device and checks every tensor against the shapes
and dtypes of an abstract state (`Trainer.abstract_state`: meta tensors).

This reads the port's own checkpoints, not the JAX package's orbax ones;
JAX weights come through `models/convert.py` (`save_npz` / `load_npz`).

Over a mesh of more than one rank (`mesh`), each rank writes its own part:
`params.rank<r>.pt` and `state.rank<r>.pt` (its shard of the row-sharded
tables and their row state, its copy of the rest, its carry) and
`data.rank<r>.json` (its loader position and session snapshot), then a
marker `done.rank<r>` that holds the save's token (drawn by rank 0 and
shared when the manager is made). Rank 0's writer waits until every
rank's marker with that token is there, writes `meta.json` (step,
rng_seed, the mesh's shape) and renames the directory; no collective runs
on the writer threads. A restore asks for the mesh that wrote the
checkpoint and raises, naming both shapes, for another (resharding on
restore is not ported).
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from seqrec_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from seqrec_tpu_torch.train.state import TrainState

PARAMS_FILE, STATE_FILE, META_FILE = "params.pt", "state.pt", "meta.json"
WAIT_S = 600.0  # rank 0's longest wait for the other ranks' parts of a save


def _rank_file(name: str, rank: int) -> str:
    """A rank's part of a checkpoint: params.pt -> params.rank<r>.pt."""
    stem, ext = os.path.splitext(name)
    return f"{stem}.rank{rank}{ext}"


def _map(tree, fn):
    """`fn` applied to every tensor of a tree of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _tensors(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tensors(v, f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _tensors(v, f"{path}/{i}")]
    return []


def _to_host(t: torch.Tensor) -> torch.Tensor:
    # A copy even of a CPU tensor: the caller's next step may update it in place.
    return t.detach().to("cpu", copy=True)


def _write_durably(path: str, write) -> None:
    """`write(file)`, then flush it to the disk: the rename that publishes a
    checkpoint must not come before its bytes."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 mesh: Optional[Mesh] = None, info: Optional[Dict[str, Any]] = None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(1, int(keep))
        self._async = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None  # the step being written
        self._saved: Optional[int] = None  # the last step this process wrote its part of
        self._info = dict(info or {})
        self._mesh_shape = {DATA_AXIS: 1, MODEL_AXIS: 1}
        self._rank, self._world, self._token = 0, 1, ""
        if mesh is not None:
            self._mesh_shape = dict(mesh.shape)
            self._rank, self._world = mesh.rank, mesh.size
        if self._world > 1:  # rank 0's token, on every rank (a collective)
            tok = np.array([secrets.randbits(62) if self._rank == 0 else 0], np.int64)
            self._token = str(int(mesh.psum_host(tok)[0]))
        # One record a save: step, bytes, the host copy's and the write's seconds.
        self.saves: List[Dict[str, float]] = []

    @property
    def directory(self) -> str:
        return self._dir

    def all_steps(self) -> List[int]:
        """The complete checkpoints' steps, ascending (a `<step>.tmp`
        directory is an unfinished save and does not count)."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> Optional[int]:
        """The newest step saved or being saved, or None."""
        steps = self.all_steps()
        steps += [s for s in (self._pending, self._saved) if s is not None]
        return max(steps) if steps else None

    def save(self, step: int, state: TrainState, data_position: int,
             data_state: Optional[dict] = None) -> bool:
        """Save `state` as step `step`, unless a step at or past it is saved
        already (as orbax's manager skips it); True when it saves.
        `data_state` is a JSON-serializable pipeline snapshot for streams
        whose position is not a batch count (the session-parallel lane
        cursors)."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        self.wait()
        t0 = time.perf_counter()
        params = _map(state.params, _to_host)
        rest = {"opt_state": _map(state.opt_state, _to_host),
                "embed_opt": _map(state.embed_opt, _to_host),
                "carry": _map(state.carry, _to_host)}
        meta = {"step": int(step), "rng_seed": int(state.rng_seed),
                "data_position": int(data_position), **self._info}
        if self._mesh_shape != {DATA_AXIS: 1, MODEL_AXIS: 1}:  # no key: one device
            meta["mesh"] = self._mesh_shape
        if data_state is not None:
            meta["data_state"] = data_state
        record = {"step": int(step), "host_copy_s": time.perf_counter() - t0,
                  "bytes": sum(t.numel() * t.element_size()
                               for _, t in _tensors(params) + _tensors(rest))}
        self.saves.append(record)
        self._pending = self._saved = int(step)
        if self._async:
            self._thread = threading.Thread(target=self._write, args=(step, params, rest, meta,
                                                                      record),
                                            name="seqrec-checkpoint", daemon=True)
            self._thread.start()
        else:
            self._write(step, params, rest, meta, record)
            self._raise()
        return True

    def _write(self, step, params, rest, meta, record) -> None:
        try:
            t0 = time.perf_counter()
            tmp = os.path.join(self._dir, f"{step}.tmp")
            if self._world > 1:
                self._write_part(tmp, params, rest, meta)
                if self._rank != 0:
                    record["write_s"] = time.perf_counter() - t0
                    return
                meta = {k: v for k, v in meta.items() if k not in ("data_position", "data_state")}
            else:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                _write_durably(os.path.join(tmp, PARAMS_FILE), lambda f: torch.save(params, f))
                _write_durably(os.path.join(tmp, STATE_FILE), lambda f: torch.save(rest, f))
            _write_durably(os.path.join(tmp, META_FILE),
                           lambda f: f.write(json.dumps(meta).encode()))
            final = os.path.join(self._dir, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self.all_steps()[:-self._keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)), ignore_errors=True)
            record["write_s"] = time.perf_counter() - t0
        except BaseException as e:  # surfaced by wait()
            self._error = e
        finally:
            self._pending = None

    def _write_part(self, tmp, params, rest, meta) -> None:
        """This rank's part of a multi-rank save, its marker last; on rank 0,
        then wait for every rank's marker of this save's token."""
        os.makedirs(tmp, exist_ok=True)  # another rank may have made it
        r = self._rank
        data = {k: meta[k] for k in ("data_position", "data_state") if k in meta}
        _write_durably(os.path.join(tmp, _rank_file(PARAMS_FILE, r)),
                       lambda f: torch.save(params, f))
        _write_durably(os.path.join(tmp, _rank_file(STATE_FILE, r)), lambda f: torch.save(rest, f))
        _write_durably(os.path.join(tmp, f"data.rank{r}.json"),
                       lambda f: f.write(json.dumps(data).encode()))
        _write_durably(os.path.join(tmp, f"done.rank{r}"), lambda f: f.write(self._token.encode()))
        if r != 0:
            return
        deadline = time.monotonic() + WAIT_S
        for other in range(self._world):
            marker = os.path.join(tmp, f"done.rank{other}")
            while not (os.path.exists(marker) and open(marker).read() == self._token):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rank {other}'s part of {tmp} did not come in "
                                       f"{WAIT_S:.0f} s")
                time.sleep(0.05)

    def _raise(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"checkpoint save under {self._dir} failed") from e

    def wait(self) -> None:
        """Block until the save in flight, if any, is on disk; raise if it
        failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def close(self) -> None:
        self.wait()

    def _checked_meta(self, step: int) -> dict:
        """meta.json of `step`; a ValueError naming both meshes unless this
        manager's mesh wrote it (read before any rank's part)."""
        with open(os.path.join(self._dir, str(step), META_FILE)) as f:
            meta = json.load(f)
        written = meta.get("mesh", {DATA_AXIS: 1, MODEL_AXIS: 1})
        if written != self._mesh_shape:
            raise ValueError(
                f"checkpoint step {step} under {self._dir} was written by a mesh of "
                f"{written[DATA_AXIS]} x {written[MODEL_AXIS]} (data x model); this run's is "
                f"{self._mesh_shape[DATA_AXIS]} x {self._mesh_shape[MODEL_AXIS]}: restore it "
                "on the same mesh (resharding on restore is not ported)")
        return meta

    def read_meta(self, step: Optional[int] = None) -> dict:
        """meta.json of `step` (the newest when None); over a mesh, with this
        rank's data position and snapshot. Refuses another mesh's checkpoint."""
        step = self._step_or_latest(step)
        meta = self._checked_meta(step)
        if self._world > 1:
            with open(os.path.join(self._dir, str(step), f"data.rank{self._rank}.json")) as f:
                meta.update(json.load(f))
        return meta

    def _file(self, step: int, name: str) -> str:
        return os.path.join(self._dir, str(step),
                            _rank_file(name, self._rank) if self._world > 1 else name)

    def _step_or_latest(self, step: Optional[int]) -> int:
        self.wait()
        if step is None:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {self._dir}")
            step = steps[-1]
        return step

    def restore_params(self, device=None, step: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
        """The parameters of `step` (the newest when None) on `device`.
        Refuses another mesh's checkpoint."""
        step = self._step_or_latest(step)
        self._checked_meta(step)
        return torch.load(self._file(step, PARAMS_FILE), map_location=device, weights_only=True)

    def restore(self, abstract_state: TrainState, device=None
                ) -> Tuple[TrainState, int, int, Optional[dict]]:
        """The newest checkpoint on `device` -> (state, step, data_position,
        data_state). Every tensor must match `abstract_state`'s (meta
        tensors: `Trainer.abstract_state`) in name, shape and dtype."""
        step = self._step_or_latest(None)
        meta = self.read_meta(step)
        params = self.restore_params(device, step)
        rest = torch.load(self._file(step, STATE_FILE), map_location=device, weights_only=True)
        state = TrainState(step=int(meta["step"]), params=params, opt_state=rest["opt_state"],
                           rng_seed=int(meta["rng_seed"]), carry=rest["carry"],
                           embed_opt=rest["embed_opt"])
        want = {p: (tuple(t.shape), t.dtype) for p, t in _tensors(_as_tree(abstract_state))}
        got = {p: (tuple(t.shape), t.dtype) for p, t in _tensors(_as_tree(state))}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))
            raise ValueError(f"checkpoint step {step} under {self._dir} does not match the "
                             f"state it restores into: {diff[:6]}")
        return state, step, int(meta["data_position"]), meta.get("data_state")


def _as_tree(state: TrainState) -> Dict[str, Any]:
    return {"params": state.params, "opt_state": state.opt_state,
            "embed_opt": state.embed_opt, "carry": state.carry}
