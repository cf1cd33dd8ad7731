"""Slope timing of serially dependent chains: the port of the JAX
repository's `benchmarks/timing.py`, with its estimator, arguments and
detail keys unchanged.

A chain is timed on the host's clock from its first step to a sync on its
final value, at two lengths; the reported number is the slope between
them, which cancels whatever a call costs once (iterator build, prefetch
threads, the first launch's kernel builds, the final sync itself).

- Chains must be serially dependent (each step consumes the previous
  step's output), so that the final value needs every step.
- Each chain ends in `fetch_scalar`. On a CUDA device that synchronizes the
  carry's device, which waits for all the work queued on it (every stream,
  the staging copies' side stream included), then reads one element to the
  host. On the CPU every operation has finished when it returns, and the
  read alone ends the chain.
- Each rep times its (short, long) pair back to back; the slope is the
  upper median of the reps' positive slopes, with their spread beside it,
  and `reliable` says whether the long chain outlasted the short one by
  more than 0.05 s.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterator, Tuple

import torch

Carry = Any


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a carry (a tensor, a dataclass such as `TrainState`,
    or dicts, lists and tuples of them) in field and insertion order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fetch_scalar(carry: Carry) -> float:
    """Wait for every computation `carry` depends on, and return one element
    of its first floating tensor (of its first tensor when none floats)."""
    leaves = list(_tensors(carry))
    if not leaves:
        raise ValueError("carry has no tensor leaves to fetch")
    x = next((t for t in leaves if t.is_floating_point()), leaves[0])
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[0].item())


def _paired_slope(
    times: dict, n_short: int, n_long: int, reps: int
) -> Tuple[float, dict]:
    """Median per-rep positive slope (ms a step) from paired (short, long)
    chain timings. A rep's pair is timed back to back, so a drift of the
    host's clock over minutes cancels within it; a negative slope can only
    come from such drift and is dropped. Of the positive slopes the upper
    median is reported (the middle one, the higher of two for an even
    count), with the spread (max - min) of the positive ones: two numbers
    whose difference lies inside their spreads are not told apart
    (`deltas_distinguishable`)."""
    slopes = [
        (times[n_long][r] - times[n_short][r]) / (n_long - n_short) * 1e3
        for r in range(reps)
    ]
    positive = sorted(s for s in slopes if s > 0)
    slope = positive[len(positive) // 2] if positive else float("nan")
    spread = (positive[-1] - positive[0]) if positive else float("nan")
    # The long/short gap of the reported rep: below 0.05 s the number is
    # at the mercy of the host's scheduling.
    med_r = slopes.index(slope) if positive else 0
    diff_s = times[n_long][med_r] - times[n_short][med_r]
    try:
        # A loaded host inflates every chain that runs host threads (the
        # loader, the prefetcher, the launches): the load average makes a
        # poisoned capture show itself.
        load_1m = round(os.getloadavg()[0], 2)
    except OSError:  # pragma: no cover - non-Linux
        load_1m = float("nan")
    return slope, {
        "host_load_1m": load_1m,
        "host_cpus": os.cpu_count(),
        "chain_short_s": times[n_short][med_r],
        "chain_long_s": times[n_long][med_r],
        "n_short": n_short,
        "n_long": n_long,
        "reps": reps,
        "slopes_ms": [round(s, 4) for s in slopes],
        "spread_ms": round(spread, 4) if spread == spread else spread,
        "spread_pct": (
            round(100.0 * spread / slope, 1)
            if positive and slope > 0
            else float("nan")
        ),
        "reliable": bool(positive) and diff_s > 0.05,
    }


def median_slope(detail: dict) -> float:
    """The reported slope of a `_paired_slope` detail (upper median of the
    positive per-rep slopes), recomputed from `slopes_ms`. NaN when no rep
    is positive."""
    positive = sorted(s for s in detail.get("slopes_ms", []) if s > 0)
    return positive[len(positive) // 2] if positive else float("nan")


def deltas_distinguishable(a: dict, b: dict) -> bool:
    """True when two `_paired_slope` details differ by more than the larger
    of their own cross-rep spreads. Details without a spread (NaN) are
    never distinguishable."""
    sa, sb = a.get("spread_ms", float("nan")), b.get("spread_ms", float("nan"))
    ma, mb = median_slope(a), median_slope(b)
    if not (sa == sa and sb == sb and ma == ma and mb == mb):
        return False
    return abs(ma - mb) > max(sa, sb)


def chain_slope_ms(
    step: Callable[[Carry, int], Carry],
    seed: Callable[[], Carry],
    *,
    n_short: int = 50,
    n_long: int = 150,
    reps: int = 4,
) -> Tuple[float, dict]:
    """Per-step wall time (ms) of `step`, slope method.

    `step(carry, i) -> carry` must be serially dependent on `carry`.
    `seed()` returns the carry a chain starts from, one of its own each
    call (a step that updates its carry in place would otherwise change
    the next chain's start). Returns (slope_ms, detail).
    """
    times = {n_short: [], n_long: []}
    c = None
    for _ in range(reps):
        for n in (n_short, n_long):
            # Release the previous chain's carry BEFORE seeding the next:
            # holding both doubles peak memory, which matters when the
            # carry is a train state of several GB (a 10M-item table).
            c = None
            c = step(seed(), 0)  # the first launch's builds + drain marker
            fetch_scalar(c)  # the queue is empty now
            t0 = time.perf_counter()
            for i in range(n):
                c = step(c, i + 1)
            fetch_scalar(c)
            times[n].append(time.perf_counter() - t0)
    return _paired_slope(times, n_short, n_long, reps)


def alternating_chain_slopes_ms(
    chains: "dict[str, Tuple[Callable, Callable]]",
    *,
    n_short: int = 50,
    n_long: int = 150,
    reps: int = 4,
) -> "dict[str, Tuple[float, dict]]":
    """chain_slope_ms for several (step, seed) candidates, alternated: every
    rep times each candidate's (short, long) pair back to back, so the
    per-rep comparisons between candidates sample the same moment of the
    host (see alternating_run_slopes_ms)."""
    times = {name: {n_short: [], n_long: []} for name in chains}
    for _ in range(reps):
        for name, (step, seed) in chains.items():
            for n in (n_short, n_long):
                c = step(seed(), 0)  # drain marker
                fetch_scalar(c)
                t0 = time.perf_counter()
                for i in range(n):
                    c = step(c, i + 1)
                fetch_scalar(c)
                times[name][n].append(time.perf_counter() - t0)
                c = None
    return {
        name: _paired_slope(times[name], n_short, n_long, reps)
        for name in chains
    }


def run_slope_ms(
    run: Callable[[int], None],
    *,
    n_short: int = 50,
    n_long: int = 150,
    reps: int = 4,
) -> Tuple[float, dict]:
    """Per-step wall time (ms) of a self-contained chain runner.

    `run(n)` must execute an n-step serially dependent chain and end in a
    `fetch_scalar` of its final carry. Per-call setup (iterator build,
    prefetch threads, state init) is constant in n and cancels in the
    slope: this is how end-to-end loops such as `Trainer.fit` are timed.
    """
    times = {n_short: [], n_long: []}
    for _ in range(reps):
        for n in (n_short, n_long):
            t0 = time.perf_counter()
            run(n)
            times[n].append(time.perf_counter() - t0)
    return _paired_slope(times, n_short, n_long, reps)


def alternating_run_slopes_ms(
    runs: "dict[str, Callable[[int], None]]",
    *,
    n_short: int = 50,
    n_long: int = 150,
    reps: int = 5,
) -> "dict[str, Tuple[float, dict]]":
    """Time several self-contained chain runners, alternated.

    The host's clock drifts over minutes (other work on the host's cores,
    its clocks), so two configurations timed in separate blocks can differ
    by more than the effect measured. Here rep r times runner A's (short,
    long) pair, then runner B's, then A's again for rep r + 1: every runner
    samples the same moments, and the per-rep ratios between runners
    (`slopes_ms[r]` of one over the other) compare like with like. This is
    the method for any A-against-B claim.

    Each `runs[name](n)` must execute an n-step chain ending in a fetch
    (see run_slope_ms). Returns per name (median_slope_ms, detail).
    """
    times = {name: {n_short: [], n_long: []} for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            for n in (n_short, n_long):
                t0 = time.perf_counter()
                run(n)
                times[name][n].append(time.perf_counter() - t0)
    return {
        name: _paired_slope(times[name], n_short, n_long, reps)
        for name in runs
    }
