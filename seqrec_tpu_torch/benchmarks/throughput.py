"""Throughput runner (examples/s a device): the port of the JAX
repository's `benchmarks/throughput.py`, behind the `benchmark` subcommand.

    result = run_benchmark(cfg, steps=100, warmup=10)            # the step alone
    result = run_pipeline_benchmark(cfg, steps=96)               # Trainer.fit
    both = run_pipeline_alternating({"k8": cfg8, "k1": cfg1})    # A against B

`run_benchmark` times the steady-state train step over batches staged on
the device before the timed region (no host I/O in it); the `run_pipeline_*`
functions time `Trainer.fit`'s own loop: the loader, the prefetcher's
staging and the steps. Both take the slope between a chain of `steps`
steps and one of 3 x `steps` (`benchmarks.timing`), and return the JAX
runner's keys with the same meaning; `backend` is the trainer's device
type ("cuda" or "cpu").
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from seqrec_tpu_torch.benchmarks.timing import (
    alternating_run_slopes_ms,
    chain_slope_ms,
    fetch_scalar,
    run_slope_ms,
)
from seqrec_tpu_torch.config import RunConfig
from seqrec_tpu_torch.data import native
from seqrec_tpu_torch.data.dataset import synthetic_dataset
from seqrec_tpu_torch.data.prefetch import StagedBatch
from seqrec_tpu_torch.runtime import DEFAULT_DEVICE
from seqrec_tpu_torch.train.state import TrainState, clone_state
from seqrec_tpu_torch.train.trainer import Trainer


def default_dataset(cfg: RunConfig):
    """The runner's synthetic dataset when the caller gives none: max(4 B,
    512) users with histories of min(T, 20)..T+1 items over
    `data.synthetic_num_items` items, from `data.seed`."""
    return synthetic_dataset(
        num_users=max(cfg.data.batch_size * 4, 512),
        num_items=cfg.data.synthetic_num_items,
        seed=cfg.data.seed,
        min_len=min(cfg.data.max_len, 20),
        max_len=cfg.data.max_len + 1,
    )


def stage_batches(tr: Trainer, n: int) -> List:
    """The first `n` batches of the trainer's stream, staged on its device
    through `put_batch` and ready on this thread (a CUDA `StagedBatch` waits
    for its side stream's copy here): the device tensors the timed steps
    read."""
    it = tr.train_iterator()
    try:
        staged = []
        for _ in range(n):
            _, batch = next(it)
            out = tr.put_batch(batch)
            staged.append(out.ready() if isinstance(out, StagedBatch) else out)
        return staged
    finally:
        if hasattr(it, "close"):
            it.close()


def chain_step(tr: Trainer, staged: List) -> Callable[[TrainState, int], TrainState]:
    """`step(state, i)`: `Trainer.train_step` on staged batch i (cycling),
    the new state out; nothing else."""

    def step(carry: TrainState, i: int) -> TrainState:
        new_state, _metrics = tr.train_step(carry, staged[i % len(staged)])
        return new_state

    return step


def run_benchmark(
    cfg: RunConfig,
    *,
    steps: int = 100,
    warmup: int = 10,
    num_staged_batches: int = 8,
    ds=None,
    device=DEFAULT_DEVICE,
) -> Dict[str, float]:
    """The train step alone, on `num_staged_batches` batches staged on the
    device up front. `ds` overrides the default synthetic dataset.

    Every chain starts from a clone of one `init_state()`: the sparse step
    updates its [V, D] tables and their row state in place, so a chain from
    the state itself would change the next chain's start, and drawing a
    10M-item table again for each chain would cost far more than the
    chains. The previous chain's state is released before each clone
    (`chain_slope_ms`), so at most the seed and one chain's state are on
    the device."""
    if ds is None:
        ds = default_dataset(cfg)
    tr = Trainer(cfg, ds=ds, device=device)
    staged = stage_batches(tr, num_staged_batches)

    # Warmup (the first launch builds the kernels).
    t_compile = time.perf_counter()
    state0 = tr.init_state()
    state = clone_state(state0)
    for i in range(max(warmup, 1)):
        state, metrics = tr.train_step(state, staged[i % len(staged)])
    fetch_scalar(metrics["loss"])
    warmup_s = time.perf_counter() - t_compile
    del state, metrics

    step_ms, detail = chain_slope_ms(
        chain_step(tr, staged), lambda: clone_state(state0),
        n_short=steps, n_long=3 * steps,
    )
    finite = np.isfinite(step_ms) and step_ms > 0
    eps = tr.global_batch / (step_ms / 1e3) if finite else 0.0

    n_dev = tr.num_devices
    return {
        "steps": steps,
        "global_batch": tr.global_batch,
        "seq_len": cfg.data.max_len,
        "num_devices": n_dev,
        "step_time_ms": step_ms if finite else float("nan"),
        "examples_per_s": eps,
        "examples_per_s_per_chip": eps / n_dev,
        "chain_short_s": detail["chain_short_s"],
        "chain_long_s": detail["chain_long_s"],
        "slopes_ms": detail["slopes_ms"],
        "spread_ms": detail["spread_ms"],
        "spread_pct": detail["spread_pct"],
        "host_load_1m": detail["host_load_1m"],
        # False when the long/short wall-time gap is under 0.05 s: rerun
        # with more `steps` before trusting the number.
        "reliable": detail["reliable"],
        "warmup_s": warmup_s,
        "backend": tr.device.type,
    }


def make_pipeline_runner(cfg: RunConfig, ds=None, device=DEFAULT_DEVICE):
    """(trainer, run): `run(n)` executes `Trainer.fit`'s own loop for n steps
    from a fresh state and ends in a `fetch_scalar` of the final state. The
    config is forced bare: no out_dir, checkpoints, eval or per-step log
    lines, no debug_nans."""
    if ds is None:
        ds = default_dataset(cfg)
    cfg.train.out_dir = ""
    cfg.train.checkpoint_every = 0
    cfg.train.eval_every = 0
    cfg.train.log_every = 1_000_000_000
    cfg.train.debug_nans = False
    tr = Trainer(cfg, ds=ds, device=device)

    def run(n: int) -> None:
        cfg.train.num_steps = n
        state, _ = tr.fit()
        fetch_scalar(state)

    return tr, run


def _pipeline_result(tr, cfg, step_ms, detail, warmup_s) -> Dict[str, float]:
    finite = np.isfinite(step_ms) and step_ms > 0
    eps = tr.global_batch / (step_ms / 1e3) if finite else 0.0
    n_dev = tr.num_devices
    return {
        "steps": detail["n_short"],
        "global_batch": tr.global_batch,
        "seq_len": cfg.data.max_len,
        "num_devices": n_dev,
        "step_time_ms": step_ms if finite else float("nan"),
        "examples_per_s": eps,
        "examples_per_s_per_chip": eps / n_dev,
        "chain_short_s": detail["chain_short_s"],
        "chain_long_s": detail["chain_long_s"],
        "slopes_ms": detail["slopes_ms"],
        "spread_ms": detail["spread_ms"],
        "spread_pct": detail["spread_pct"],
        "host_load_1m": detail["host_load_1m"],
        "reliable": detail["reliable"],
        "warmup_s": warmup_s,
        "loader": "native" if _native_loader_active(cfg) else "python",
        "prefetch_depth": cfg.data.prefetch_to_device,
        "backend": tr.device.type,
    }


def run_pipeline_benchmark(
    cfg: RunConfig,
    *,
    steps: int = 100,
    warmup: int = 5,
    ds=None,
    device=DEFAULT_DEVICE,
) -> Dict[str, float]:
    """End-to-end throughput: `Trainer.fit`'s own loop (native or Python
    loader, `DevicePrefetcher` staging, the steps), timed by the slope
    between a short and a long `fit`, which cancels per-call setup (the
    iterator, the prefetch thread, state init). `ds` as in run_benchmark.
    With `train.steps_per_call` set, pick `steps` divisible by it: a tail
    that does not fill a group runs as single steps and skews the slope.
    To compare two configs use `run_pipeline_alternating`."""
    tr, run = make_pipeline_runner(cfg, ds=ds, device=device)

    t_compile = time.perf_counter()
    run(max(warmup, 1))  # the kernels' builds, the allocator, the loader
    warmup_s = time.perf_counter() - t_compile

    step_ms, detail = run_slope_ms(run, n_short=steps, n_long=3 * steps)
    return _pipeline_result(tr, cfg, step_ms, detail, warmup_s)


def run_pipeline_alternating(
    cfgs: "Dict[str, RunConfig]",
    *,
    steps: int = 96,
    warmup: int = 5,
    reps: int = 5,
    settle: bool = True,
    ds=None,
    device=DEFAULT_DEVICE,
) -> "Dict[str, Dict[str, float]]":
    """End-to-end throughput for several configs, alternated in one process
    (`alternating_run_slopes_ms`): every rep times each config's (short,
    long) pair back to back, so per-rep ratios compare like with like.

    `settle=True` runs one untimed `steps`-step chain a config after every
    warmup, so that the first timed rep does not carry the warmups' after-
    effects (the allocator's growth, the loader's first reads); its seconds
    are `settle_s`. `steps` must be divisible by every config's
    steps_per_call.
    """
    runners, trainers, warmups = {}, {}, {}
    for name, cfg in cfgs.items():
        tr, run = make_pipeline_runner(cfg, ds=ds, device=device)
        t0 = time.perf_counter()
        run(max(warmup, 1))
        warmups[name] = time.perf_counter() - t0
        trainers[name], runners[name] = tr, run

    settle_s = 0.0
    if settle:
        t0 = time.perf_counter()
        for run in runners.values():
            run(steps)
        settle_s = time.perf_counter() - t0

    slopes = alternating_run_slopes_ms(
        runners, n_short=steps, n_long=3 * steps, reps=reps
    )
    out = {}
    for name, (step_ms, detail) in slopes.items():
        r = _pipeline_result(
            trainers[name], cfgs[name], step_ms, detail, warmups[name]
        )
        r["settle_s"] = settle_s
        out[name] = r
    return out


def _native_loader_active(cfg: RunConfig) -> bool:
    return bool(cfg.data.use_native_loader) and native.available()


def bench_config(
    arch: str = "gru4rec",
    *,
    batch_size: int = 256,
    max_len: int = 50,
    embed_dim: int = 64,
    num_items: int = 10_000,
    loss: str = "full_softmax",
    use_pallas: bool = True,
    num_layers: int = 1,
    num_negatives: Optional[int] = None,
) -> RunConfig:
    """A bare benchmark config (dropout 0, no out_dir, eval or checkpoints),
    as the JAX runner's `bench_config`. The repo's headline configuration:
    `bench_config("gru4rec", batch_size=128, max_len=200, embed_dim=64,
    num_items=3_417, loss="sampled_softmax", num_negatives=256)`."""
    cfg = RunConfig()
    cfg.model.arch = arch
    cfg.model.embed_dim = embed_dim
    cfg.model.num_layers = num_layers
    cfg.model.max_len = max_len
    cfg.model.loss = loss
    if num_negatives is not None:
        cfg.model.num_negatives = num_negatives
    cfg.model.dropout_rate = 0.0
    cfg.model.use_pallas = use_pallas
    cfg.data.batch_size = batch_size
    cfg.data.max_len = max_len
    cfg.data.synthetic_num_items = num_items
    cfg.train.out_dir = ""
    cfg.train.checkpoint_every = 0
    cfg.train.eval_every = 0
    return cfg
