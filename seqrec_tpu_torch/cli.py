"""CLI: ``python -m seqrec_tpu_torch {train,eval,prepare-data,recommend,benchmark} ...``.

The port's counterpart of `seqrec_tpu/cli.py`:

    python -m seqrec_tpu_torch train --config configs/ml1m_gru4rec.json \
        --set data.dataset=synthetic
    python -m seqrec_tpu_torch train --config configs/ml1m_gru4rec.json \
        --set data.dataset=synthetic --set train.resume=true
    python -m seqrec_tpu_torch eval --config configs/ml1m_gru4rec.json \
        --set data.dataset=synthetic --split test
    python -m seqrec_tpu_torch prepare-data synthetic --data_dir data
    python -m seqrec_tpu_torch recommend --config configs/ml1m_gru4rec.json \
        --ckpt runs/ml1m_gru4rec/ckpt --input histories.jsonl --k 10
    python -m seqrec_tpu_torch recommend --config configs/ml1m_gru4rec.json \
        --weights params.npz --input histories.jsonl --k 10
    python -m seqrec_tpu_torch benchmark --config configs/beauty_gru.json --steps 100

`train` runs `Trainer.fit` (the dataset from `data.dataset` under
`data.data_dir`, prepared on the fly when it is missing), with checkpoints
under `train.out_dir`/ckpt every `train.checkpoint_every` steps and at the
end, resuming the newest with `train.resume=true`; then the test split's
eval, and prints `{"final_test": {...}}` after the logger's lines. `eval`
restores the newest checkpoint (`--ckpt`, default `train.out_dir`/ckpt)
and prints `{"step", "split", **metrics}`. `prepare-data` builds a dataset's
canonical files under `--data_dir/<name>` from its raw file there (nothing
is downloaded; `synthetic` needs none) and prints `{"dataset", "num_users",
"num_items", "num_interactions"}`, as the JAX CLI does.

`recommend` reads the parameters of the port's newest checkpoint
(`--ckpt`), or a `.npz` of the JAX parameter tree (`--weights`, see
models.convert); the catalog size is the row count of `item_embedding` (and
the user count that of `user_embedding`, less one; a checkpoint's meta.json
names both). `--device` defaults to cuda and raises without it.

`benchmark` times the train step of the config (`--set` applies) on a
synthetic dataset of `data.synthetic_num_items` items, over 8 batches
staged on the device, by the slope between chains of `--steps` and 3 x
`--steps` steps after `--warmup` steps (`benchmarks/throughput.py`), and
prints the JAX CLI's JSON line: steps, global_batch, seq_len, num_devices,
step_time_ms, examples_per_s, examples_per_s_per_chip, chain_short_s,
chain_long_s, slopes_ms, spread_ms, spread_pct, host_load_1m, reliable,
warmup_s, backend. `--device cpu` runs the plain versions on the CPU.

`eval` and `recommend --ckpt` read a checkpoint of any mesh on their own
(`train/checkpoint.py` reshards it where every leaf's global shape agrees,
as orbax does): a 2-rank run's checkpoint serves from one process,

    python -m seqrec_tpu_torch recommend --config configs/ml1m_gru4rec.json \
        --set mesh.shard_embeddings=true --ckpt runs/sharded/ckpt

and `train.resume=true` resumes a run on another mesh. `recommend` reads
the parameters alone, so it also serves a session-parallel checkpoint on
another world size, which the whole state (the carry) would refuse.

Every subcommand runs on several devices, one process each, under torchrun
or with the JAX CLI's flags:

    torchrun --nproc_per_node=2 -m seqrec_tpu_torch train \
        --config configs/synthetic10m_sharded.json
    python -m seqrec_tpu_torch train --config ... --coordinator host:port \
        --num_processes 2 --process_id 0        # and 1, on the other process

Each rank takes cuda:LOCAL_RANK (or its --device), the mesh comes from
`mesh.model_axis`, and rank 0 prints; the torch.distributed backend is
nccl on CUDA and gloo on the CPU. There `benchmark` times every rank's
chain and reports num_devices = the world size, global_batch =
batch_size x world and examples_per_s_per_chip = examples_per_s / world,
as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE
from seqrec_tpu_torch.runtime.mesh import init_distributed, make_mesh, process_index


def _load_cfg(args) -> RunConfig:
    cfg = RunConfig.load(args.config) if args.config else RunConfig()
    if args.set:
        cfg = cfg.apply_overrides(args.set)
    return cfg


def _init_runtime(args):
    """The process group from the flags or torchrun's environment (none for
    one process); this rank's device."""
    return init_distributed(args.coordinator, args.num_processes, args.process_id,
                            device=args.device)


def _print0(obj) -> None:
    if process_index() == 0:
        print(json.dumps(obj), flush=True)


def cmd_train(args) -> int:
    """Train, then evaluate on the test split."""
    cfg = _load_cfg(args)
    device = _init_runtime(args)
    from seqrec_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device=device)
    state, _ = tr.fit()
    _print0({"final_test": tr.evaluate(state, split="test")})
    return 0


def _ckpt_dir(args, cfg: RunConfig) -> str:
    return args.ckpt or f"{cfg.train.out_dir}/ckpt"


def cmd_eval(args) -> int:
    """Evaluate the newest checkpoint on a split."""
    cfg = _load_cfg(args)
    device = _init_runtime(args)
    from seqrec_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device=device)
    state, step, _, _ = tr.checkpoint_manager(_ckpt_dir(args, cfg)).restore(
        tr.abstract_state(), device=tr.device)
    m = tr.evaluate(state, split=args.split)
    _print0({"step": step, "split": args.split, **m})
    return 0


def cmd_prepare_data(args) -> int:
    """Build the canonical dataset format (`data.dataset.prepare_dataset`)."""
    from seqrec_tpu_torch.config import DataConfig
    from seqrec_tpu_torch.data.dataset import prepare_dataset

    cfg = DataConfig(dataset=args.dataset, data_dir=args.data_dir)
    if args.config:
        cfg = RunConfig.load(args.config).data
    ds = prepare_dataset(args.dataset, args.data_dir, cfg)
    print(json.dumps({
        "dataset": args.dataset,
        "num_users": ds.num_users,
        "num_items": ds.vocab_size - 1,
        "num_interactions": int(len(ds.items)),
    }), flush=True)
    return 0


def cmd_recommend(args) -> int:
    """Batch inference: JSON-lines histories in, top-k recommendations out."""
    cfg = _load_cfg(args)
    device = _init_runtime(args)
    from seqrec_tpu_torch.eval.infer import recommend
    from seqrec_tpu_torch.models import build_model
    from seqrec_tpu_torch.models.convert import flax_to_state_dict, load_npz, shard_state_dict
    from seqrec_tpu_torch.train.checkpoint import CheckpointManager

    mesh = make_mesh(cfg.mesh.model_axis)
    shapes = {}
    if args.weights:
        state = flax_to_state_dict(load_npz(args.weights))
        shapes = {k: v.shape for k, v in state.items()}
        meta = {}
    else:
        mgr = CheckpointManager(_ckpt_dir(args, cfg), mesh=mesh)
        meta = mgr.read_meta()
        if "vocab_size" not in meta:  # written without the trainer's info: the tables' rows
            shapes = {k: v.shape for k, v in mgr.restore_params(device="cpu").items()}
    num_users = meta.get("num_users", shapes["user_embedding"][0] - 1
                         if "user_embedding" in shapes else 0)
    model = build_model(cfg.model, meta.get("vocab_size", shapes.get("item_embedding", (0,))[0]),
                        num_users=num_users, device=device, mesh=mesh, mesh_cfg=cfg.mesh)
    if args.weights:  # a whole tree: this rank's shard of it
        state = shard_state_dict(state, model)
    else:  # a checkpoint of any mesh: this rank's part of each parameter
        state = mgr.restore_params(device="cpu", like=dict(model.named_parameters()),
                                   row_sharded=model.sharded_rows)
    model.load_state_dict(state)
    model.eval()

    def read_histories():
        src = open(args.input) if args.input else sys.stdin
        try:
            for line in src:
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            if src is not sys.stdin:
                src.close()

    for out in recommend(
        model, read_histories(), k=args.k, batch_size=args.batch_size,
        max_len=cfg.data.max_len, exclude_history=not args.allow_repeats,
    ):
        _print0(out)
    return 0


def cmd_benchmark(args) -> int:
    """Examples/s of the train step (`benchmarks.throughput.run_benchmark`)."""
    cfg = _load_cfg(args)
    device = _init_runtime(args)
    from seqrec_tpu_torch.benchmarks.throughput import run_benchmark

    _print0(run_benchmark(cfg, steps=args.steps, warmup=args.warmup, device=device))
    return 0


def _add_common(p) -> None:
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VAL",
        help="dotted config override, e.g. model.use_pallas=false",
    )
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda, cuda:LOCAL_RANK under a process group; "
                        "'cpu' runs the plain path)")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's address host:port (or an init URL) for a multi-process run")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="seqrec_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model, then evaluate it on the test split")
    _add_common(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate the newest checkpoint")
    _add_common(p)
    p.add_argument("--ckpt", default=None, help="checkpoint dir (default out_dir/ckpt)")
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("prepare-data", help="build the canonical dataset format")
    p.add_argument("dataset", help="ml-100k | ml-1m | beauty | steam | synthetic")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_prepare_data)

    p = sub.add_parser("recommend", help="top-k recommendations for histories")
    _add_common(p)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--ckpt", default=None,
                     help="checkpoint dir of this package (default out_dir/ckpt)")
    src.add_argument("--weights", default=None,
                     help=".npz of the JAX parameter tree (models/convert.py)")
    p.add_argument("--input", default=None,
                   help="JSONL file of {'user':..,'history':[..]} (default stdin)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--allow_repeats", action="store_true",
                   help="do not exclude items already in the history")
    p.set_defaults(fn=cmd_recommend)

    p = sub.add_parser("benchmark", help="measure examples/s/chip of the train step")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.set_defaults(fn=cmd_benchmark)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
