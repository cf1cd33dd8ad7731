"""CLI: ``python -m seqrec_tpu_torch recommend ...``.

The port's counterpart of `seqrec_tpu/cli.py`. This slice has the
`recommend` subcommand (JSON-lines histories in, top-k JSON lines out):

    python -m seqrec_tpu_torch recommend --config configs/ml1m_gru4rec.json \
        --weights params.npz --input histories.jsonl --k 10

`--weights` is a `.npz` of the JAX parameter tree (see models.convert) where
the JAX CLI takes an orbax `--ckpt`; the catalog size is the row count of
`item_embedding` (and the user count that of `user_embedding`, less one).
`--device` defaults to cuda and raises without it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE


def _load_cfg(args) -> RunConfig:
    cfg = RunConfig.load(args.config) if args.config else RunConfig()
    if args.set:
        cfg = cfg.apply_overrides(args.set)
    return cfg


def cmd_recommend(args) -> int:
    """Batch inference: JSON-lines histories in, top-k recommendations out."""
    cfg = _load_cfg(args)
    from seqrec_tpu_torch.eval.infer import recommend
    from seqrec_tpu_torch.models import build_model
    from seqrec_tpu_torch.models.convert import flax_to_state_dict, load_npz

    state = flax_to_state_dict(load_npz(args.weights))
    num_users = (state["user_embedding"].shape[0] - 1
                 if "user_embedding" in state else 0)
    model = build_model(cfg.model, state["item_embedding"].shape[0],
                        num_users=num_users, device=args.device)
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
        print(json.dumps(out))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="seqrec_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("recommend", help="top-k recommendations for histories")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VAL",
        help="dotted config override, e.g. model.use_pallas=false",
    )
    p.add_argument("--weights", required=True,
                   help=".npz of the JAX parameter tree (models/convert.py)")
    p.add_argument("--input", default=None,
                   help="JSONL file of {'user':..,'history':[..]} (default stdin)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--allow_repeats", action="store_true",
                   help="do not exclude items already in the history")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' runs the plain path)")
    p.set_defaults(fn=cmd_recommend)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
