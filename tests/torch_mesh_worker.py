"""One gloo rank of the port's multi-rank tests, on the CPU, importing no JAX.

    python tests/torch_mesh_worker.py <init url> <world> <rank> <scenario> <dir>

The test spawns `world` of these (`spawn`), each joins the process group
through a `file://` store in the test's own directory (so parallel test
workers never race for a port), reads `<dir>/inputs.npz` (and
`<dir>/inputs.json`), runs its scenario and writes `<dir>/out.rank<r>.npz`.
The JAX side of each comparison runs in the test's process.

Scenarios:
- functions: the mesh, `sharded_gather` (forward and gradient, dedup on and
  off), `replicated_gather`, `sharded_ranks`, `sharded_topk`,
  `sharded_sub_table`, `sharded_row_update` and `sharded_full_softmax_loss`
  (loss, weights and gradients) on meshes of model_axis 2, 4 and 1 over the
  world;
- steps: the trainer's K steps (dense, dense full softmax, sparse exact,
  sparse capped, session-parallel) from given parameters, batches and
  negatives;
- fit: the full-protocol eval of given parameters (a sampled-loss model and
  a full-softmax one with its bias), the full-softmax model's candidate
  scores, the bucketed stream's first batches (each engine), a straight fit
  against a killed and resumed one, a profiled fit, and `recommend` sharded
  against one rank's whole model;
- reshard: checkpoints of every case saved from each mesh of this world
  and restored on each (world 2 and world 4 run at once, and wait for each
  other's saves), a fit killed at (1, 2) and resumed at (2, 1), and a
  round trip (2, 1) -> (4, 1) -> (2, 1);
- benchmark: the `benchmark` subcommand with `--coordinator`,
  `--num_processes` and `--process_id` (the CLI joins the process group
  itself), each rank's standard output kept.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spawn(scenario: str, world: int, directory: Path, timeout: float = 150.0) -> list:
    """Run `world` ranks of `scenario` over `directory`; their outputs, by
    rank. Each rank has `timeout` seconds: a hang fails this test only (the
    ranks are killed), it does not eat the suite's clock."""
    return finish(start(scenario, world, directory, timeout))


def start(scenario: str, world: int, directory: Path, timeout: float = 150.0) -> tuple:
    """Start `world` ranks of `scenario` over `directory` (`finish` waits
    for them): spawns of other directories may run meanwhile."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
           "SEQREC_WORKER_DUMP_S": str(max(5, int(timeout) - 10))}
    store = directory / "store"
    store.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_worker.py"), f"file://{store}", str(world),
         str(r), scenario, str(directory)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
        for r in range(world)]
    return scenario, directory, procs, time.monotonic() + timeout


def finish(started: tuple) -> list:
    scenario, directory, procs, deadline = started
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-4000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"{scenario} ranks failed: {bad}"
    return [dict(np.load(directory / f"out.rank{r}.npz")) for r in range(len(procs))]


# ---------------------------------------------------------------------------
# The ranks' side (imports torch and the port only)
# ---------------------------------------------------------------------------


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _functions(io: dict, rank: int) -> dict:
    import torch

    from seqrec_tpu_torch.eval.sharded import sharded_ranks, sharded_topk
    from seqrec_tpu_torch.parallel.embedding import replicated_gather, sharded_gather
    from seqrec_tpu_torch.parallel.softmax import sharded_full_softmax_loss
    from seqrec_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from seqrec_tpu_torch.train import sparse_embed

    out = {}
    for M in (2, 4, 1):
        mesh = make_mesh(M)
        p = f"M{M}/"
        out[p + "shape"] = np.array([mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]])
        out[p + "coords"] = np.array([mesh.axis_index(DATA_AXIS), mesh.axis_index(MODEL_AXIS)])
        m = mesh.axis_index(MODEL_AXIS)
        world = mesh.size
        # Lookups: rank r's batch rows [r B, (r + 1) B); its table shard.
        table, ids, cot = io[p + "table"], io[p + "ids"], io[p + "cot"]
        rows = table.shape[0] // M
        B = ids.shape[0] // world
        mine = slice(rank * B, (rank + 1) * B)
        for dedup in (True, False):
            shard = _t(table[m * rows:(m + 1) * rows]).requires_grad_(True)
            acts = sharded_gather(shard, _t(ids[mine]), mesh, dedup=dedup, use_pallas=True)
            (acts * _t(cot[mine])).sum().backward()
            out[p + f"gather_dedup{int(dedup)}"] = _np(acts)
            out[p + f"grad_dedup{int(dedup)}"] = _np(mesh.psum(shard.grad, DATA_AXIS))
        shard = _t(table[m * rows:(m + 1) * rows]).requires_grad_(True)
        neg = _t(io[p + "neg"])
        rep = replicated_gather(shard, neg, mesh, dtype=torch.bfloat16)
        (rep.float() * _t(io[p + "neg_cot"][rank])).sum().backward()
        out[p + "replicated"] = _np(rep.float())
        out[p + "replicated_grad"] = _np(mesh.psum(shard.grad, DATA_AXIS))
        # Ranking: rank r's query rows.
        h, tg, excl = io[p + "h"], io[p + "targets"], io[p + "exclude"]
        Bq = h.shape[0] // world
        q = slice(rank * Bq, (rank + 1) * Bq)
        otab, bias = io[p + "out_table"], io[p + "bias"]
        orows = otab.shape[0] // M
        oshard, bshard = _t(otab[m * orows:(m + 1) * orows]), _t(bias[m * orows:(m + 1) * orows])
        nv = int(io[p + "num_valid"])
        for tag, b, ex in (("bias", bshard, None), ("nobias", None, None),
                           ("exclude", bshard, _t(excl[q]))):
            out[p + f"ranks_{tag}"] = _np(sharded_ranks(oshard, _t(h[q]), _t(tg[q]), mesh,
                                                        bias=b, num_valid=nv, exclude=ex))
        for tag, b in (("bias", bshard), ("nobias", None)):
            vals, top = sharded_topk(oshard, _t(h[q]), 7, mesh, bias=b, num_valid=nv)
            out[p + f"topk_vals_{tag}"], out[p + f"topk_ids_{tag}"] = _np(vals), _np(top)
        # The sharded sparse pair.
        uids = _t(io[p + "uids"])
        stab = io[p + "sparse_table"]
        srows = stab.shape[0] // M
        out[p + "sub_table"] = _np(sparse_embed.sharded_sub_table(
            _t(stab[m * srows:(m + 1) * srows]), uids, mesh))
        for opt in ("sgd", "adagrad", "adam"):
            t = _t(stab[m * srows:(m + 1) * srows])
            row_opt = {k: _t(v[m * srows:(m + 1) * srows])
                       for k, v in _opt_leaves(io, p + opt).items()}
            sparse_embed.sharded_row_update(opt, 0.05, t, row_opt, uids, _t(io[p + "g_rows"]),
                                            6, mesh)
            out[p + f"row_update_{opt}/table"] = _np(t)
            for k, v in row_opt.items():
                out[p + f"row_update_{opt}/{k}"] = _np(v)
        # The full softmax over the sharded table: rank r's rows, its
        # cotangent g[r] on its loss sum.
        sh, st, sb = io[p + "sm_h"], io[p + "sm_table"], io[p + "sm_bias"]
        n = sh.shape[0] // world
        mine = slice(rank * n, (rank + 1) * n)
        srows = st.shape[0] // M
        h = _t(sh[mine]).requires_grad_(True)
        shard = _t(st[m * srows:(m + 1) * srows]).requires_grad_(True)
        bshard = _t(sb[m * srows:(m + 1) * srows]).requires_grad_(True)
        loss, w = sharded_full_softmax_loss(h, shard, bshard, _t(io[p + "sm_targets"][mine]),
                                            _t(io[p + "sm_weights"][mine]), mesh,
                                            num_valid=int(io[p + "num_valid"]))
        (loss * float(io[p + "sm_g"][rank])).backward()
        out[p + "sm_loss"], out[p + "sm_w"] = _np(loss)[None], _np(w)[None]
        out[p + "sm_d_h"] = _np(h.grad)
        out[p + "sm_d_table"] = _np(mesh.psum(shard.grad, DATA_AXIS))
        out[p + "sm_d_bias"] = _np(mesh.psum(bshard.grad, DATA_AXIS))
    return out


def _opt_leaves(io: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in io.items() if k.startswith(prefix + "/")}


class _DS:
    def __init__(self, vocab: int, users: int = 0):
        self.vocab_size, self.num_users = vocab, users


def _config(settings: dict):
    from seqrec_tpu_torch.config import RunConfig

    cfg = RunConfig()
    for key, v in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    return cfg


def _gather_state(tr, state, out: dict, prefix: str) -> None:
    """Every leaf of this rank's state under `prefix` (the test assembles the
    shards)."""
    for k, v in state.params.items():
        out[f"{prefix}params/{k}"] = _np(v)
    for k, tree in (state.embed_opt or {}).items():
        for leaf, v in tree.items():
            out[f"{prefix}embed_opt/{k}/{leaf}"] = _np(v)
    for part in ("mu", "nu", "sum_of_squares"):
        for k, v in state.opt_state.get(part, {}).items():
            out[f"{prefix}opt/{part}/{k}"] = _np(v)
    if state.carry is not None:
        for i, c in enumerate(state.carry):
            out[f"{prefix}carry/{i}"] = _np(c)


def _steps(io: dict, rank: int, spec: dict) -> dict:
    import torch

    from seqrec_tpu_torch.models.convert import shard_state_dict
    from seqrec_tpu_torch.train.trainer import Trainer

    out = {}
    for case, settings in spec["cases"].items():
        cfg = _config(settings)
        tr = Trainer(cfg, _DS(spec["vocab"]), device="cpu")
        world, B = tr.mesh.size, tr.local_batch
        whole = {k[len(case) + 8:]: torch.from_numpy(v) for k, v in io.items()
                 if k.startswith(f"{case}/params/")}
        state = tr._state(shard_state_dict(whole, tr.model), 3, torch.device("cpu"))
        if f"{case}/carry" in io:
            state.carry = (_t(io[f"{case}/carry"][rank * B:(rank + 1) * B]),)
        negs = [(_t(n), _t(q) if q.size else None)
                for n, q in zip(io[f"{case}/neg"], io[f"{case}/neg_log_q"])]
        drawn = iter(negs)
        tr.sample_negatives = lambda gen: next(drawn)
        keys = [k for k in ("inputs", "targets", "mask", "reset") if f"{case}/{k}" in io]
        metrics = []
        for s in range(io[f"{case}/inputs"].shape[0]):
            batch = {k: io[f"{case}/{k}"][s, rank * B:(rank + 1) * B] for k in keys}
            state, m = tr.train_step(state, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["tokens"])])
        out[f"{case}/metrics"] = np.array(metrics)
        out[f"{case}/world"] = np.array([world, B])
        _gather_state(tr, state, out, f"{case}/")
    return out


def _fit(io: dict, rank: int, spec: dict, directory: Path) -> dict:
    import torch

    from seqrec_tpu_torch.data.dataset import synthetic_dataset
    from seqrec_tpu_torch.eval.infer import recommend
    from seqrec_tpu_torch.models import build_model
    from seqrec_tpu_torch.models.convert import shard_state_dict
    from seqrec_tpu_torch.train.trainer import Trainer

    out = {}
    ds = synthetic_dataset(**spec["dataset"])
    whole = {k[len("params/"):]: torch.from_numpy(v) for k, v in io.items()
             if k.startswith("params/")}
    # Both protocols' eval of the given parameters.
    for protocol in ("full", "sampled"):
        cfg = _config({**spec["eval"], "eval.protocol": protocol})
        tr = Trainer(cfg, ds, device="cpu")
        state = tr._state(shard_state_dict(whole, tr.model), 0, torch.device("cpu"))
        for split in ("val", "test"):
            m = tr.evaluate(state, split=split)
            out[f"eval/{protocol}/{split}/keys"] = np.array(sorted(m))
            out[f"eval/{protocol}/{split}/values"] = np.array([m[k] for k in sorted(m)])
    # recommend: the sharded top-k against one rank's whole model.
    tr.model.load_state_dict(state.params)
    tr.model.eval()
    full = build_model(cfg.model, ds.vocab_size, device="cpu")
    full.load_state_dict({k: v[:ds.vocab_size] if k == "item_embedding" else v
                          for k, v in whole.items()})
    full.eval()
    hist = [{"user": i, "history": [int(x) for x in ds.seq(i)[-5:]]} for i in range(9)]
    for tag, model in (("sharded", tr.model), ("whole", full)):
        recs = list(recommend(model, hist, k=5, batch_size=4, max_len=cfg.data.max_len))
        out[f"recommend/{tag}/items"] = np.array([r["items"] for r in recs])
        out[f"recommend/{tag}/scores"] = np.array([r["scores"] for r in recs])
    # The full-softmax model (its output bias sharded too): the full
    # protocol's eval, and candidate scores against one rank's whole model.
    fs = {k[len("fs_params/"):]: torch.from_numpy(v) for k, v in io.items()
          if k.startswith("fs_params/")}
    cfg = _config({**spec["eval_fs"], "eval.protocol": "full"})
    tr = Trainer(cfg, ds, device="cpu")
    state = tr._state(shard_state_dict(fs, tr.model), 0, torch.device("cpu"))
    for split in ("val", "test"):
        m = tr.evaluate(state, split=split)
        out[f"eval_fs/full/{split}/keys"] = np.array(sorted(m))
        out[f"eval_fs/full/{split}/values"] = np.array([m[k] for k in sorted(m)])
    tr.model.load_state_dict(state.params)
    tr.model.eval()
    full = build_model(cfg.model, ds.vocab_size, device="cpu")
    full.load_state_dict({k: v[:ds.vocab_size] if k in ("item_embedding", "output_bias") else v
                          for k, v in fs.items()})
    full.eval()
    n = io["fs_cand/inputs"].shape[0] // 2
    rows = slice(rank * n, (rank + 1) * n)
    args = (_t(io["fs_cand/inputs"][rows]), _t(io["fs_cand/mask"][rows]))
    cands = _t(io["fs_cand/candidates"][rows])
    with torch.no_grad():
        out["fs_scores/sharded"] = _np(tr.model.scores(*args, candidates=cands))
        out["fs_scores/whole"] = _np(full.scores(*args, candidates=cands))
    # The bucketed stream of a sharded model: each engine's first batches.
    for engine in ("python", "native"):
        c = _config({**spec["stream"], "data.use_native_loader": engine == "native"})
        tr = Trainer(c, ds, device="cpu")
        it = tr.train_iterator()
        out[f"stream/{engine}/engine"] = np.array([tr.data_engine])
        for i in range(spec["stream_batches"]):
            bucket, b = next(it)
            out[f"stream/{engine}/{i}/bucket"] = np.array([bucket])
            for k, v in b.items():
                out[f"stream/{engine}/{i}/{k}"] = v
        it.close()
    # A profiled fit: process 0 alone writes the trace.
    c = _config({**spec["profile"], "train.out_dir": str(directory / "profiled"),
                 "train.profile_dir": str(directory / "prof")})
    tr = Trainer(c, ds, device="cpu")
    tr.fit()
    out["profile/trace"] = np.array([tr.profile_trace or ""])
    labels = []
    if tr.profile_trace:
        events = json.loads(Path(tr.profile_trace).read_text())["traceEvents"]
        labels = sorted({e["name"] for e in events if e.get("name", "").startswith("seqrec_group[")})
    out["profile/labels"] = np.array(labels)
    # A straight fit against one killed and resumed, each case.
    for case, settings in spec["fit"].items():
        for run, extra in (("straight", {}), ("killed", {"train.fail_after_step": 8}),
                           ("resumed", {"train.resume": True})):
            where = directory / case / ("straight" if run == "straight" else "resumed")
            c = _config({**settings, "train.out_dir": str(where), **extra})
            tr = Trainer(c, ds, device="cpu")
            final, _ = tr.fit()
            out[f"fit/{case}/{run}/step"] = np.array([final.step])
            _gather_state(tr, final, out, f"fit/{case}/{run}/")
    return out


# ---- reshard: checkpoints written on one mesh, restored on another -------


def state_from_leaves(leaves: dict, step: int):
    """A TrainState from its leaves by path (`/params/<p>`,
    `/opt_state/<moment>/<p>`, `/embed_opt/<p>/<leaf>`, `/carry/<layer>`)."""
    from seqrec_tpu_torch.train.state import TrainState

    params, opt, embed, carry = {}, {"count": step}, {}, {}
    for path, t in leaves.items():
        parts = path.split("/")[1:]
        if parts[0] == "params":
            params[parts[1]] = t
        elif parts[0] == "opt_state":
            opt.setdefault(parts[1], {})[parts[2]] = t
        elif parts[0] == "embed_opt":
            embed.setdefault(parts[1], {})[parts[2]] = t
        else:
            carry[int(parts[1])] = t
    return TrainState(step=step, params=params, opt_state=opt, rng_seed=1,
                      carry=tuple(carry[i] for i in sorted(carry)) or None,
                      embed_opt=embed or None)


def state_leaves(state) -> dict:
    """Every tensor of a TrainState by path (the inverse of
    `state_from_leaves`)."""
    from seqrec_tpu_torch.train.checkpoint import _as_tree, _tensors

    return dict(_tensors(_as_tree(state)))


def _part(tr, path: str, a: np.ndarray) -> np.ndarray:
    """This rank's part of the global leaf `a` on the trainer's mesh."""
    from seqrec_tpu_torch.train.checkpoint import _owner

    mesh = tr.mesh
    if path.startswith("/carry/"):
        n = a.shape[0] // mesh.size
        return a[mesh.rank * n:(mesh.rank + 1) * n]
    if _owner(path) in tr._sharded:
        n = a.shape[0] // mesh.shape["model"]
        m = mesh.coords["model"]
        return a[m * n:(m + 1) * n]
    return a


def _wait_for(paths, seconds: float = 100.0) -> None:
    deadline = time.monotonic() + seconds
    while not all(p.exists() for p in paths):
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited {seconds} s for {[str(p) for p in paths]}")
        time.sleep(0.05)


def _save_part(tr, leaves: dict, step: int, where: Path) -> None:
    """Save this rank's part of the global `leaves` as step `step`."""
    state = state_from_leaves({p: _t(_part(tr, p, a)) for p, a in leaves.items()}, step)
    mgr = tr.checkpoint_manager(str(where))
    mgr.save(step, state, data_position=step)
    mgr.wait()


def _restored(tr, where: Path, out: dict, prefix: str) -> None:
    """Restore the newest checkpoint under `where` on the trainer's mesh:
    every leaf of this rank's part, the step, count, data position and
    bytes read under `prefix`, or the refusal's message."""
    mgr = tr.checkpoint_manager(str(where))
    try:
        state, step, pos, _ = mgr.restore(tr.abstract_state(), device="cpu")
    except ValueError as e:
        out[prefix + "error"] = np.array([str(e)])
        return
    out[prefix + "meta"] = np.array([step, state.step, state.opt_state["count"], pos,
                                     mgr.restores[-1]["bytes_read"]])
    for path, t in state_leaves(state).items():
        out[prefix + path] = _np(t)


class _First:
    """An iterator that keeps its first item (fit's first resumed batch)."""

    def __init__(self, it):
        self.it, self.first = it, None

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.it)
        if self.first is None:
            self.first = item
        return item

    def close(self) -> None:
        if hasattr(self.it, "close"):
            self.it.close()


def resume_on(cfg, ckpt_from: Path, out_dir: Path, out: dict, prefix: str, rank: int = 0):
    """Resume the fit of `cfg` with train.resume into `out_dir` from a copy
    of the checkpoint directory `ckpt_from`: the state it restores, its
    first batch beside `train_iterator(skip_batches=<position>)`'s, its
    final step and the losses it logged, under `prefix`. Rank 0 makes the
    copy; the trainer's mesh waits for it."""
    import shutil

    from seqrec_tpu_torch.train.trainer import Trainer

    cfg.train.out_dir, cfg.train.resume = str(out_dir), True
    if rank == 0:
        shutil.copytree(ckpt_from, out_dir / "ckpt")
    tr = Trainer(cfg, device="cpu")
    tr.mesh.barrier()
    _restored(tr, out_dir / "ckpt", out, prefix + "restored/")
    real = tr.train_iterator
    seen = {}

    def spy(skip_batches: int = 0):
        seen["skip"] = skip_batches
        seen["it"] = _First(real(skip_batches=skip_batches))
        return seen["it"]

    tr.train_iterator = spy
    final, _ = tr.fit()
    fresh = real(skip_batches=seen["skip"])
    bucket, batch = next(fresh)
    fresh.close()
    first_bucket, first = seen["it"].first
    out[prefix + "skip"] = np.array([seen["skip"]])
    out[prefix + "first_equal"] = np.array([first_bucket == bucket and sorted(first) == sorted(batch)
                                            and all(np.array_equal(first[k], batch[k])
                                                    for k in batch)])
    out[prefix + "final_step"] = np.array([final.step])
    if rank == 0:
        logged = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
        out[prefix + "losses"] = np.array([x["loss"] for x in logged if x["tag"] == "train"])


def _reshard(io: dict, rank: int, spec: dict, directory: Path) -> dict:
    """Phase 1: save every case's state from each mesh of this world (the
    test gives the global leaves; each rank keeps its part), and on world 2
    the killed fit at (1, 2) with its eval and top-k; then mark this world
    saved. Phase 2, once every world has saved: restore every case's
    checkpoint of every mesh on each mesh of this world. Then world 4
    restores the round trip's (2, 1) checkpoint at (4, 1) and saves it at
    once; world 2 resumes the killed fit at (2, 1) and restores that round
    trip at (2, 1)."""
    import torch

    from seqrec_tpu_torch.eval.infer import recommend
    from seqrec_tpu_torch.runtime.mesh import process_count
    from seqrec_tpu_torch.train.trainer import Trainer

    from seqrec_tpu_torch.runtime.mesh import make_mesh

    root, world = Path(spec["root"]), process_count()
    mine = [m for m in spec["meshes"] if m[0] * m[1] == world]
    meshes = {m[1]: make_mesh(m[1]) for m in mine}  # each made once: its groups too
    out = {}
    t0 = time.perf_counter()

    def trainer(case: str, mesh):
        return Trainer(_config({**spec["cases"][case], "mesh.model_axis": mesh[1]}),
                       _DS(spec["vocab"][case]), device="cpu", mesh=meshes[mesh[1]])

    def lap(what: str) -> None:
        print(f"rank {rank}: {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    def name(mesh) -> str:
        return f"{mesh[0]}x{mesh[1]}"

    for mesh in mine:
        for case in spec["cases"]:
            leaves = {k.split("|")[2]: v for k, v in io.items()
                      if k.startswith(f"{case}|{name(mesh)}|")}
            tr = trainer(case, mesh)
            out[f"{case}|{name(mesh)}|sharded"] = np.array(sorted(tr._sharded) or [""])
            _save_part(tr, leaves, spec["step"], root / "port" / case / name(mesh))
    if world == 2:  # the killed fit at (1, 2), its eval and top-k at step 8
        kill = _config({**spec["kill"], "train.out_dir": str(root / "kill" / "run"),
                        "train.fail_after_step": 8})
        tr = Trainer(kill, device="cpu")
        killed, _ = tr.fit()
        for path, t in state_leaves(killed).items():
            out["kill/killer" + path] = _np(t)
        tr = Trainer(_config(spec["kill"]), device="cpu")
        state = tr.checkpoint_manager(str(root / "kill" / "run" / "ckpt")).restore(
            tr.abstract_state(), device="cpu")[0]
        m = tr.evaluate(state, split="test")
        out["kill/eval/keys"] = np.array(sorted(m))
        out["kill/eval/values"] = np.array([m[k] for k in sorted(m)])
        tr.model.load_state_dict(state.params)
        tr.model.eval()
        with torch.no_grad():
            recs = list(recommend(tr.model, spec["histories"], k=5, batch_size=4,
                                  max_len=tr.cfg.data.max_len))
        out["kill/recommend/items"] = np.array([r["items"] for r in recs])
        out["kill/recommend/scores"] = np.array([r["scores"] for r in recs])
    lap("saved")
    if rank == 0:
        (root / f"saved.w{world}").write_text("")
    _wait_for([root / f"saved.w{w}" for w in (1, 2, 4)])
    for reader in mine:
        for case in spec["cases"]:
            for writer in spec["meshes"]:
                _restored(trainer(case, reader), root / "port" / case / name(writer), out,
                          f"{case}|{name(writer)}|{name(reader)}|")
    lap("restored")
    case = spec["round_trip"]
    if world == 4:  # the round trip: (2, 1) restored at (4, 1), saved at once
        tr = trainer(case, (4, 1))
        state, step, pos, _ = tr.checkpoint_manager(
            str(root / "port" / case / "2x1")).restore(tr.abstract_state(), device="cpu")
        mgr = tr.checkpoint_manager(str(root / "round_trip"))
        mgr.save(step, state, data_position=pos)
        mgr.wait()
        if rank == 0:
            (root / "round_trip.saved").write_text("")
    if world == 2:
        resume_on(_config({**spec["kill"], "mesh.model_axis": 1}), root / "kill" / "run" / "ckpt",
                  root / "kill" / "at_2x1", out, "kill/2x1/", rank)
        _wait_for([root / "round_trip.saved"])
        _restored(trainer(case, (2, 1)), root / "round_trip", out, "round_trip|")
    lap("done")
    return out


def _benchmark(rank: int, world: int, init_url: str, spec: dict) -> dict:
    import contextlib
    import io

    from seqrec_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["benchmark", "--device", "cpu", "--config", spec["config"],
                       "--coordinator", init_url, "--num_processes", str(world),
                       "--process_id", str(rank), *spec["args"]])
    return {"rc": np.array(rc), "stdout": np.array(out.getvalue())}


def main(argv) -> int:
    init_url, world, rank, scenario, directory = argv[1:6]
    # A hang prints every thread's stack and exits (the test shows it).
    faulthandler.dump_traceback_later(int(os.environ.get("SEQREC_WORKER_DUMP_S", "600")),
                                      exit=True)
    import torch

    torch.set_num_threads(1)
    from seqrec_tpu_torch.runtime import mesh as rt

    if scenario != "benchmark":  # the benchmark subcommand joins the group itself
        rt.init_distributed(init_url, int(world), int(rank), device="cpu")
    directory = Path(directory)
    with np.load(directory / "inputs.npz") as f:
        io = {k: f[k] for k in f.files}
    spec_path = directory / "inputs.json"
    spec = json.loads(spec_path.read_text()) if spec_path.exists() else {}
    rank = int(rank)
    if scenario == "functions":
        out = _functions(io, rank)
    elif scenario == "steps":
        out = _steps(io, rank, spec)
    elif scenario == "fit":
        out = _fit(io, rank, spec, directory)
    elif scenario == "reshard":
        out = _reshard(io, rank, spec, directory)
    elif scenario == "benchmark":
        out = _benchmark(rank, int(world), init_url, spec)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    np.savez(directory / f"out.rank{rank}.npz", **out)
    torch.distributed.barrier()
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
