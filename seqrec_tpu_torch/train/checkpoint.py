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
`latest_step` would pick; the last `keep` steps are kept.

This reads the port's own checkpoints, not the JAX package's orbax ones;
JAX weights come through `models/convert.py` (`save_npz` / `load_npz`).

Over a mesh of more than one rank (`mesh`), each rank writes its own part:
`params.rank<r>.pt` and `state.rank<r>.pt` (its shard of the row-sharded
tables and their row state, its copy of the rest, its carry) and
`data.rank<r>.json` (its loader position and session snapshot), then a
marker `done.rank<r>` that holds the save's token (drawn by rank 0 and
shared when the manager is made). Rank 0's writer waits until every
rank's marker with that token is there, writes `meta.json` (step,
rng_seed, the mesh's shape and the parameters held as row shards,
`row_sharded`) and renames the directory; no collective runs on the writer
threads.

A restore reshards, with orbax's rule: a checkpoint of any mesh restores
onto any mesh on which every leaf has its global shape and dtype, and is
refused, every leaf that differs named with both global shapes, where one
does not. A leaf's global tensor is its writer's parts put together (rank
r = d * model + m): a row-sharded leaf (a table, its optimizer moments and
row state, the output bias) is the row blocks of the ranks of data index
0 in model order, the session carry every rank's block in rank order (the
JAX package shards it like a batch), any other leaf rank 0's copy. Each
rank then takes its own part for its mesh, reading only those rows (the
files are opened with mmap): a row shard's host memory stays near the
shard. Padding decides where a sharded table restores (`padded_vocab`
rounds the rows up to 8 x model), and the carry restores only on the
writer's world size, as in the JAX package. `restore` checks and cuts the
whole state (fit's resume, `eval`), `restore_params` the parameters alone
(`recommend --ckpt`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import shutil
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

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
                 mesh: Optional[Mesh] = None, info: Optional[Dict[str, Any]] = None,
                 row_sharded: Iterable[str] = ()):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(1, int(keep))
        self._async = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None  # the step being written
        self._saved: Optional[int] = None  # the last step this process wrote its part of
        self._info = dict(info or {})
        # The parameters this run holds as row shards (`SeqRecModel.sharded_rows`).
        self._row_sharded = sorted(row_sharded)
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
        # One record a restore: step, the writer's mesh, leaves, bytes read, seconds.
        self.restores: List[Dict[str, Any]] = []

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
            meta["row_sharded"] = self._row_sharded
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

    def _meta(self, step: int) -> dict:
        with open(os.path.join(self._dir, str(step), META_FILE)) as f:
            return json.load(f)

    def read_meta(self, step: Optional[int] = None) -> dict:
        """meta.json of `step` (the newest when None), with the data
        position, from a checkpoint of any mesh. A multi-rank checkpoint's
        ranks hold one position (they step in lockstep); a ValueError if
        they do not. The session snapshot (`data_state`) is per rank: it
        comes with the meta only on the writer's world size (rank r takes
        rank r's), the only world on which its carry restores."""
        step = self._step_or_latest(step)
        meta = self._meta(step)
        world = _Layout.of_meta(meta).world
        if world > 1:
            data = []
            for r in range(world):
                with open(os.path.join(self._dir, str(step), f"data.rank{r}.json")) as f:
                    data.append(json.load(f))
            positions = sorted({int(d["data_position"]) for d in data})
            if len(positions) > 1:
                raise ValueError(f"checkpoint step {step} under {self._dir}: its ranks hold "
                                 f"other data positions {positions}")
            meta["data_position"] = positions[0]
            if world == self._world and "data_state" in data[self._rank]:
                meta["data_state"] = data[self._rank]["data_state"]
        elif self._world > 1:
            meta.pop("data_state", None)
        return meta

    def _step_or_latest(self, step: Optional[int]) -> int:
        self.wait()
        if step is None:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {self._dir}")
            step = steps[-1]
        return step

    def restore_params(self, device=None, step: Optional[int] = None,
                       like: Optional[Dict[str, torch.Tensor]] = None,
                       row_sharded: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
        """This rank's part of the parameters of `step` (the newest when
        None) on `device`, from a checkpoint of any mesh. `like` (this
        rank's parameters, any device: their shapes and dtypes) is what they
        restore into, each leaf's global shape checked as `restore` checks
        it; without it the checkpoint's global shapes are taken.
        `row_sharded`: the parameters this rank holds as row shards (the
        manager's when None)."""
        step = self._step_or_latest(step)
        want = None if like is None else {f"/params/{k}": v for k, v in like.items()}
        return self._read(step, (PARAMS_FILE,), want, device, row_sharded)[PARAMS_FILE]

    def restore(self, abstract_state: TrainState, device=None
                ) -> Tuple[TrainState, int, int, Optional[dict]]:
        """The newest checkpoint, written by any mesh, on `device` ->
        (state, step, data_position, data_state): this rank's part of every
        leaf of `abstract_state` (meta tensors: `Trainer.abstract_state`,
        this rank's shapes). Every leaf's global shape and dtype must be the
        checkpoint's, as orbax's restore requires: a ValueError names every
        leaf that differs, with both global shapes, before any is read."""
        step = self._step_or_latest(None)
        meta = self.read_meta(step)
        trees = self._read(step, (PARAMS_FILE, STATE_FILE),
                           dict(_tensors(_as_tree(abstract_state))), device, None)
        rest = trees[STATE_FILE]
        state = TrainState(step=int(meta["step"]), params=trees[PARAMS_FILE],
                           opt_state=rest["opt_state"], rng_seed=int(meta["rng_seed"]),
                           carry=rest["carry"], embed_opt=rest["embed_opt"])
        return state, step, int(meta["data_position"]), meta.get("data_state")

    def _read(self, step: int, files, want: Optional[Dict[str, torch.Tensor]], device,
              row_sharded: Optional[Iterable[str]]) -> Dict[str, Any]:
        """The trees of `files` of `step`, each leaf this rank's part on
        `device`: checked against `want` (path -> this rank's tensor) or,
        when None, against the checkpoint's own global shapes, then cut."""
        t0 = time.perf_counter()
        meta = self._meta(step)
        parts = _Parts(os.path.join(self._dir, str(step)), _Layout.of_meta(meta).world)
        writer = _Layout.of_meta(meta, parts)
        reader = _Layout(self._mesh_shape[DATA_AXIS], self._mesh_shape[MODEL_AXIS],
                         frozenset(self._row_sharded if row_sharded is None else row_sharded))
        have = _written(parts, writer, files)
        if want is None:  # the checkpoint's global shapes, cut for this mesh
            want = {p: torch.empty(reader.narrow(p, g.shape), dtype=g.dtype, device="meta")
                    for p, g in have.items()}
        target = {p: (reader.widen(p, tuple(t.shape)), t.dtype) for p, t in want.items()}
        written = {p: (g.shape, g.dtype) for p, g in have.items()}
        if target != written:
            raise ValueError(
                f"checkpoint step {step} under {self._dir} does not match the state it "
                f"restores into, leaf by leaf by global shape (the checkpoint's, written by "
                f"a mesh of {writer.data} x {writer.model} (data x model), against this "
                f"run's, {reader.data} x {reader.model}): "
                + "; ".join(_differences(written, target)))
        record = {"step": int(step), "bytes_read": 0, "leaves": len(want),
                  "writer_mesh": [writer.data, writer.model]}
        index = {"rows": self._rank % reader.model, "carry": self._rank}  # rank = d M + m

        def cut(path: str, _):
            g, t = have[path], want[path]
            if not t.shape:  # a scalar leaf: whole
                out = g.pieces[0][1].to(device, copy=True)
                record["bytes_read"] += out.numel() * out.element_size()
                return out
            lo = index.get(reader.kind(path), 0) * t.shape[0]
            out, n = _rows(g.pieces, lo, lo + t.shape[0], tuple(t.shape), g.dtype, device)
            record["bytes_read"] += n
            return out

        trees = {name: _map_paths(parts.tree(name, 0), _PREFIX[name], cut) for name in files}
        record["seconds"] = time.perf_counter() - t0
        self.restores.append(record)
        return trees


_PREFIX = {PARAMS_FILE: "/params", STATE_FILE: ""}
# The parameters a mesh may hold as row shards (`SeqRecModel.sharded_rows`).
TABLES = ("item_embedding", "output_embedding", "output_bias", "user_embedding")


def _owner(path: str) -> Optional[str]:
    """The parameter a state leaf belongs to: `/params/<p>`,
    `/opt_state/<moment>/<p>`, `/embed_opt/<p>/<leaf>`; None for the carry."""
    parts = path.split("/")[1:]
    if parts[0] in ("params", "embed_opt"):
        return parts[1]
    if parts[0] == "opt_state" and len(parts) == 3:
        return parts[2]
    return None


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a state's leaves live over a (data, model) mesh, rank
    d * model + m: a row-sharded parameter's leaves (the parameter, its
    optimizer moments, its row state) as `model` row blocks, block m on the
    ranks of model index m; the carry as one block a rank, in rank order
    (the JAX package's carry is sharded like a batch, over the flattened
    mesh); every other leaf whole on every rank."""

    data: int
    model: int
    row_sharded: frozenset = frozenset()

    @property
    def world(self) -> int:
        return self.data * self.model

    @classmethod
    def of_meta(cls, meta: dict, parts: Optional["_Parts"] = None) -> "_Layout":
        """The writer's layout: meta.json's mesh (no key: one device) and
        its `row_sharded` list. A multi-rank checkpoint written before that
        list was recorded holds its tables as shards unless they are whole:
        a whole item table has exactly `vocab_size` rows (no padding), a
        shard padded_vocab / model (`parts` reads its rows)."""
        mesh = meta.get("mesh", {DATA_AXIS: 1, MODEL_AXIS: 1})
        data, model = int(mesh[DATA_AXIS]), int(mesh[MODEL_AXIS])
        names = meta.get("row_sharded")
        if names is None and model > 1 and parts is not None:
            params = parts.tree(PARAMS_FILE, 0)
            whole = ("vocab_size" in meta and "item_embedding" in params
                     and params["item_embedding"].shape[0] == meta["vocab_size"])
            names = () if whole else [n for n in TABLES if n in params]
        return cls(data, model, frozenset(names or ()))

    def kind(self, path: str) -> str:
        if path.startswith("/carry/"):
            return "carry"
        if self.model > 1 and _owner(path) in self.row_sharded:
            return "rows"
        return "whole"

    def parts(self, path: str, shape: tuple) -> int:
        """How many row blocks make the leaf's global rows."""
        if not shape:
            return 1
        return {"carry": self.world, "rows": self.model}.get(self.kind(path), 1)

    def widen(self, path: str, shape: tuple) -> tuple:
        """A rank's part's shape -> the leaf's global shape."""
        return (shape[0] * self.parts(path, shape), *shape[1:]) if shape else shape

    def narrow(self, path: str, shape: tuple) -> tuple:
        """A leaf's global shape -> a rank's part's shape."""
        n = self.parts(path, shape)
        if shape and shape[0] % n:
            raise ValueError(f"{path}'s {shape[0]} rows do not divide into {n} parts")
        return (shape[0] // n, *shape[1:]) if shape else shape


class _Parts:
    """A checkpoint's files, opened by rank on first use with mmap: nothing
    but a file's header is read until a slice of one of its tensors is
    copied."""

    def __init__(self, root: str, world: int):
        self._root, self._world = root, world
        self._trees: Dict[Tuple[str, int], Any] = {}
        self._flat: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}

    def tree(self, name: str, rank: int):
        key = (name, rank)
        if key not in self._trees:
            path = os.path.join(self._root, _rank_file(name, rank) if self._world > 1 else name)
            self._trees[key] = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        return self._trees[key]

    def leaf(self, name: str, rank: int, path: str) -> torch.Tensor:
        key = (name, rank)
        if key not in self._flat:
            self._flat[key] = dict(_tensors(self.tree(name, rank), _PREFIX[name]))
        return self._flat[key][path]


@dataclasses.dataclass
class _Global:
    """A leaf of a checkpoint as its writer's parts: (first global row,
    part) in row order."""

    shape: tuple
    dtype: torch.dtype
    pieces: List[Tuple[int, torch.Tensor]]


def _written(parts: _Parts, writer: _Layout, files) -> Dict[str, _Global]:
    """Every leaf of `files` as its global tensor's pieces: a row-sharded
    leaf from the ranks of data index 0 (ranks 0..model-1, in model order),
    the carry from every rank in rank order, any other leaf rank 0's."""
    out = {}
    for name in files:
        for path, t in _tensors(parts.tree(name, 0), _PREFIX[name]):
            n = writer.parts(path, tuple(t.shape))
            pieces = [(0, t)] + [(r * t.shape[0], parts.leaf(name, r, path)) for r in range(1, n)]
            for r, (_, p) in enumerate(pieces):
                if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
                    raise ValueError(f"{path}: rank {r}'s part {tuple(p.shape)} {p.dtype} is "
                                     f"not rank 0's {tuple(t.shape)} {t.dtype}")
            out[path] = _Global(writer.widen(path, tuple(t.shape)), t.dtype, pieces)
    return out


def _differences(written: dict, target: dict) -> List[str]:
    """Each leaf whose global shape or dtype differs, or that only one side
    holds, in path order."""
    out = []
    for path in sorted(set(written) | set(target)):
        if path not in target:
            out.append(f"{path} only in the checkpoint")
        elif path not in written:
            out.append(f"{path} only in this run's state")
        elif written[path] != target[path]:
            (ws, wd), (ts, td) = written[path], target[path]
            out.append(f"{path} {ws} {wd} vs {ts} {td}".replace("torch.", ""))
    return out


def _rows(pieces, lo: int, hi: int, shape: tuple, dtype, device) -> Tuple[torch.Tensor, int]:
    """Global rows [lo, hi) of a leaf from its pieces, on `device`, and the
    bytes copied: only the pieces' rows in the window are read."""
    out = torch.empty(shape, dtype=dtype, device=device)
    nbytes = 0
    for g0, p in pieces:
        a, b = max(lo, g0), min(hi, g0 + p.shape[0])
        if a < b:
            src = p[a - g0:b - g0]
            out[a - lo:b - lo].copy_(src)
            nbytes += src.numel() * src.element_size()
    return out, nbytes


def _map_paths(tree, prefix: str, fn):
    """`fn(path, tensor)` in place of every tensor of a tree, with
    `_tensors`'s paths."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _map_paths(v, f"{prefix}/{k}", fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(v, f"{prefix}/{i}", fn) for i, v in enumerate(tree))
    return tree


def _as_tree(state: TrainState) -> Dict[str, Any]:
    return {"params": state.params, "opt_state": state.opt_state,
            "embed_opt": state.embed_opt, "carry": state.carry}
