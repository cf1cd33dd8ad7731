"""Loss curves of chip_smoke phase w's w3 paths (the wide demo at
embed_dim=2,304, GRU and LSTM cells) over their first steps, through the
kernels and through the plain versions, in bf16 and f32, at several
learning rates, on one NVIDIA GPU.

    python3 lr_curves.py [--steps 4] [--lrs 1e-3,2.2222e-4] [--cells gru,lstm]
                         [--seed 0] [--out FILE]

Every run of one cell starts from one initial state (init_state at --seed,
cloned) and trains on the same Zipf batches (chip_smoke._train_wires), one
train_step a batch, so the runs differ only in the route (kernels or plain
versions), the compute dtype and the learning rate. It prints, and writes to
FILE if given, one JSON line: each run's loss and gradient norm at every
step, and, for each cell, dtype and rate, the largest relative difference
of the kernels' loss from the plain versions' over the steps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from seqrec_tpu_torch.train.state import clone_state


def curves(cell: str, steps: int, lrs, seed: int, dev) -> dict:
    rng = np.random.default_rng(seed)
    vocab = cs.WIDE_ITEMS + 1
    base = cs.w_wide_config(cell)
    ds = cs._Catalog(vocab)
    B, T = base.data.batch_size, base.data.max_len
    runs, state0, wires = {}, None, None
    for dtype in ("bfloat16", "float32"):
        for lr in lrs:
            for use_pallas in (True, False):
                cfg = base.apply_overrides([f"model.compute_dtype={dtype}",
                                            f"train.learning_rate={lr!r}",
                                            f"model.use_pallas={str(use_pallas).lower()}"])
                tr = cs.Trainer(cfg, ds, device=dev)
                if state0 is None:  # one draw and one batch stream for every run of the cell
                    state0 = tr.init_state(seed)
                    wires = cs._train_wires(rng, tr, 1, steps, B, T, vocab)[0]
                state, losses, norms = clone_state(state0), [], []
                t0 = time.perf_counter()
                for wire in wires:
                    state, m = tr.train_step(state, wire)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                runs[f"{dtype}_lr{lr:g}_{'kernels' if use_pallas else 'plain'}"] = {
                    "loss": losses, "grad_norm": norms, "seconds": time.perf_counter() - t0}
                del tr, state
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        for lr in lrs:
            k, p = (runs[f"{dtype}_lr{lr:g}_{r}"]["loss"] for r in ("kernels", "plain"))
            gaps[f"{dtype}_lr{lr:g}"] = max(abs(a - b) / abs(b) for a, b in zip(k, p))
    return {"config": f"chip_smoke.w_wide_config({cell!r})", "B": B, "T": T,
            "steps": steps, "runs": runs, "kernels_vs_plain_max_rel_loss_diff": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lrs", default=f"1e-3,{cs.W3_LR!r}")
    ap.add_argument("--cells", default="gru,lstm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lr_curves: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lrs = [float(s) for s in args.lrs.split(",")]
    card = cs.phase_device()[0]  # nvidia-smi's name and power limit (its own JSON line)
    cs.phase_build()
    out = {"card": card,
           "cells": {c: curves(c, args.steps, lrs, args.seed, dev)
                     for c in args.cells.split(",")}}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
