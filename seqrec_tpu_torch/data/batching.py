"""Batching: the port's copy of `seqrec_tpu/data/batching.py`.

Numpy only, copied rather than imported: the same dataset and seed give the
same batches, bit for bit.

- Bucketed next-item batches (`BucketBatcher`, `make_train_batches`): a
  small fixed set of length buckets; every batch is padded to its bucket's
  length. Batch dict: inputs [B, T] int32 (0 = pad), targets [B, T] int32,
  mask [B, T] float32, users [B]. Row r trains next-item prediction at every
  real step (inputs s[:-1] -> targets s[1:]), truncated to the most recent
  `max_len` steps; pad positions carry mask 0. `fast_forward_train_batches`
  computes the stream's state after N batches without building them.
- Session-parallel packed windows (`SessionStream`, `make_session_stream`).
- Eval batches (`make_eval_batches`, `pad_batch_rows`): held-out targets
  with their histories.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from seqrec_tpu_torch.data.dataset import SequenceDataset

Batch = Dict[str, np.ndarray]


def _pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class BucketBatcher:
    """Groups (input, target) windows into fixed-shape bucketed batches."""

    def __init__(
        self,
        batch_size: int,
        max_len: int,
        buckets: Sequence[int] = (),
    ):
        if not buckets:
            buckets = (max_len,)
        self.buckets: Tuple[int, ...] = tuple(sorted(set(min(b, max_len) for b in buckets)))
        if self.buckets[-1] < max_len:
            self.buckets = self.buckets + (max_len,)
        self.batch_size = batch_size
        self.max_len = max_len
        self._pending: Dict[int, List[Tuple[int, np.ndarray]]] = {
            b: [] for b in self.buckets
        }

    def add(self, seq: np.ndarray, user: int = 0) -> Optional[Tuple[int, Batch]]:
        """Add one training sequence; returns a full batch when one fills."""
        if len(seq) < 2:
            return None
        if len(seq) > self.max_len + 1:
            seq = seq[-(self.max_len + 1):]
        b = _pick_bucket(len(seq) - 1, self.buckets)
        self._pending[b].append((user, seq))
        if len(self._pending[b]) == self.batch_size:
            return b, self._emit(b)
        return None

    def flush(self, pad_incomplete: bool = True) -> Iterator[Tuple[int, Batch]]:
        """Emit remaining partial batches, zero-padded to full batch size."""
        for b in self.buckets:
            if self._pending[b] and pad_incomplete:
                yield b, self._emit(b)

    def _emit(self, b: int) -> Batch:
        rows = self._pending[b]
        self._pending[b] = []
        B, T = self.batch_size, b
        inputs = np.zeros((B, T), dtype=np.int32)
        targets = np.zeros((B, T), dtype=np.int32)
        mask = np.zeros((B, T), dtype=np.float32)
        users = np.zeros((B,), dtype=np.int32)
        for r, (user, seq) in enumerate(rows):
            L = len(seq) - 1
            inputs[r, :L] = seq[:-1]
            targets[r, :L] = seq[1:]
            mask[r, :L] = 1.0
            users[r] = user
        return {"inputs": inputs, "targets": targets, "mask": mask,
                "users": users}


def _train_steps_per_user(ds: SequenceDataset, max_len: int) -> np.ndarray:
    """[num_users] transition count each user contributes to training, after
    the leave-last-out holdout (dataset.train_seq) and truncation to the most
    recent max_len+1 items (BucketBatcher.add). 0 = user is skipped."""
    L = np.diff(ds.offsets)
    train_len = np.where(L >= 3, L - 2, np.where(L > 1, L - 1, L))
    steps = np.minimum(train_len, max_len + 1) - 1
    return np.maximum(steps, 0).astype(np.int64)


def fast_forward_train_batches(
    ds: SequenceDataset,
    *,
    batch_size: int,
    max_len: int,
    buckets: Sequence[int] = (),
    seed: int = 0,
    host_shard: Tuple[int, int] = (0, 1),
    skip_batches: int = 0,
) -> Tuple[np.random.Generator, np.ndarray, int, Dict[int, List[int]]]:
    """The exact stream state after `skip_batches` emissions, without
    building any batch (a resume at a million batches takes seconds).

    Per epoch this draws the same permutation the live stream draws and does
    a few vectorized bucket counts: O(num_epochs * num_users) numpy work.

    Returns (rng, current_epoch_order, next_index_within_order,
    pending_user_lists_by_bucket) — everything make_train_batches needs to
    continue emitting batch `skip_batches` onward, bit-identically.
    """
    rng = np.random.default_rng(seed + 1_000_003 * host_shard[0])
    users = np.arange(ds.num_users)
    users = users[users % host_shard[1] == host_shard[0]]
    tmp = BucketBatcher(batch_size, max_len, buckets)  # canonical bucket set
    bucket_vals = np.asarray(tmp.buckets, dtype=np.int64)
    nb = len(bucket_vals)

    steps = _train_steps_per_user(ds, max_len)
    # _pick_bucket: first bucket >= steps, last bucket if none fits.
    bidx_all = np.minimum(
        np.searchsorted(bucket_vals, steps, side="left"), nb - 1
    )

    pending: List[List[int]] = [[] for _ in range(nb)]
    remaining = int(skip_batches)
    while True:
        order = rng.permutation(users)
        valid = steps[order] >= 1
        pu = order[valid]
        bids = bidx_all[pu]
        counts = np.bincount(bids, minlength=nb)
        emitted = sum(
            (len(pending[b]) + int(counts[b])) // batch_size for b in range(nb)
        )
        if remaining > 0 and emitted <= remaining:
            # Consume the whole epoch (pure bookkeeping). The == case also
            # consumes fully: the users after the epoch's last emission still
            # land in pending, so the resumed stream must account for them —
            # it then continues from index 0 of the NEXT permutation.
            for b in range(nb):
                eb = pu[bids == b]
                total = pending[b] + eb.tolist()
                pending[b] = total[len(total) - (len(total) % batch_size):]
            remaining -= emitted
            continue
        if remaining == 0:
            return rng, order, 0, {
                int(bucket_vals[b]): pending[b] for b in range(nb)
            }
        # Position lands inside this epoch: locate the emitting add() call.
        # Cumulative emissions after each valid user of this epoch.
        em = np.zeros(len(pu), dtype=np.int64)
        for b in range(nb):
            cum = np.cumsum(bids == b)
            em += (len(pending[b]) + cum) // batch_size
        j = int(np.searchsorted(em, remaining, side="left"))  # j-th valid user
        # Map back to an index into `order` (invalid users interleave).
        valid_pos = np.flatnonzero(valid)
        next_idx = int(valid_pos[j]) + 1
        for b in range(nb):
            eb = pu[: j + 1][bids[: j + 1] == b]
            total = pending[b] + eb.tolist()
            pending[b] = total[len(total) - (len(total) % batch_size):]
        return rng, order, next_idx, {
            int(bucket_vals[b]): pending[b] for b in range(nb)
        }


def make_train_batches(
    ds: SequenceDataset,
    *,
    batch_size: int,
    max_len: int,
    buckets: Sequence[int] = (),
    seed: int = 0,
    num_epochs: Optional[int] = None,
    host_shard: Tuple[int, int] = (0, 1),  # (process_index, process_count)
    skip_batches: int = 0,
) -> Iterator[Tuple[int, Batch]]:
    """Infinite (or num_epochs) shuffled stream of bucketed train batches.

    Each host sees a disjoint shard of users (`host_shard`). `skip_batches`
    resumes the stream after N emissions by `fast_forward_train_batches`
    (no batch is built), so a resume costs O(epochs) vectorized work.
    """
    if skip_batches and num_epochs is not None:
        raise ValueError("skip_batches requires the infinite stream")
    batcher = BucketBatcher(batch_size, max_len, buckets)
    if skip_batches:
        rng, order, start_idx, pending = fast_forward_train_batches(
            ds, batch_size=batch_size, max_len=max_len, buckets=buckets,
            seed=seed, host_shard=host_shard, skip_batches=skip_batches,
        )
        for b, pend_users in pending.items():
            # Same truncation add() applies before storing a pending row.
            batcher._pending[b] = [
                (int(u) + 1, ds.train_seq(int(u))[-(max_len + 1):])
                for u in pend_users
            ]
    else:
        rng = np.random.default_rng(seed + 1_000_003 * host_shard[0])
        order = None
        start_idx = 0
    users = np.arange(ds.num_users)
    users = users[users % host_shard[1] == host_shard[0]]
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        if order is None:
            order = rng.permutation(users)
        for u in order[start_idx:]:
            s = ds.train_seq(int(u))
            # user id u+1 at the model boundary: row 0 = unknown user.
            out = batcher.add(s, user=int(u) + 1)
            if out is not None:
                yield out
        order = None
        start_idx = 0
        epoch += 1
        if num_epochs is not None and epoch == num_epochs:
            yield from batcher.flush()


class SessionStream:
    """Session-parallel packed stream, the original GRU4Rec training regime
    (Hidasi et al., ICLR'16 §3.1.1).

    B lanes each stream a concatenation of training sessions; every window
    is a dense [B, window] block of (input, target) pairs with no padding
    (mask all ones), plus a `reset` plane marking the positions where a new
    session begins (the recurrent state is zeroed before consuming them).
    Sessions that cross a window boundary continue in the next window, and
    the trainer carries the recurrent state across windows (truncated BPTT).
    An infinite iterator, deterministic given (seed, host shard).

    The stream's whole position is (epochs consumed, index into the current
    permutation, per-lane (user, pair index, fresh) cursors). `state_at(n)`
    returns it for recent batch boundaries (a ring of snapshots absorbs a
    prefetcher's read-ahead); `restore()` rebuilds the stream from it by
    redrawing the permutations, with no batch replay.
    """

    # Default ring depth: it covers the DevicePrefetcher's look-ahead (depth
    # batches + one in flight) between the loop's position and the feeder's;
    # the trainer passes a larger value when steps_per_call grouping widens
    # that gap to whole K-groups.
    SNAPSHOT_DEPTH = 16

    def __init__(
        self,
        ds: SequenceDataset,
        *,
        batch_size: int,
        window: int,
        seed: int = 0,
        host_shard: Tuple[int, int] = (0, 1),
        snapshot_depth: Optional[int] = None,
    ):
        self._snapshot_depth = (
            snapshot_depth if snapshot_depth is not None else self.SNAPSHOT_DEPTH
        )
        self._ds = ds
        self._batch_size = batch_size
        self._window = window
        self._seed = seed
        self._host_shard = host_shard
        self._rng = np.random.default_rng(seed + 1_000_003 * host_shard[0])
        users = np.arange(ds.num_users)
        users = users[users % host_shard[1] == host_shard[0]]
        if len(users) == 0:
            raise ValueError("host shard has no users")
        self._users = users
        self._epoch = 0  # permutations fully consumed
        self._perm = self._rng.permutation(self._users)
        self._pos = 0  # index of the next session to draw from _perm
        # lane = [user, seq, pair_idx, fresh] or None; pair t = (s[t]->s[t+1]).
        self._lanes: List[Optional[list]] = [None] * batch_size
        self._count = 0  # batches emitted
        self._snapshots: List[Tuple[int, dict]] = []

    # ---- position snapshots ------------------------------------------------

    def _snapshot(self) -> dict:
        return {
            "count": self._count,  # absolute batch index of the next emission
            "epoch": self._epoch,
            "pos": self._pos,
            "lanes": [
                None if l is None else [int(l[0]), int(l[2]), bool(l[3])]
                for l in self._lanes
            ],
        }

    def state_at(self, n: int) -> dict:
        """Stream state immediately before emitting batch `n` (a restored
        stream's next batch is batch `n`). Available for `n` within the
        snapshot depth of the newest emission and for the live head."""
        # The ring first: a feeder thread may be inside __next__ for batch n,
        # having pushed (n, snapshot) before it touched the lanes.
        for count, snap in list(self._snapshots):
            if count == n:
                return snap
        if n == self._count:
            return self._snapshot()
        raise KeyError(
            f"no snapshot for batch {n} (have head {self._count} and "
            f"{[c for c, _ in self._snapshots]})"
        )

    def restore(self, state: dict) -> None:
        """Move this stream to a `state_at` snapshot: redraw the permutations
        from a fresh generator up to the snapshot's epoch (permutations are
        the generator's only use) and reload lane sequences by user id."""
        self._rng = np.random.default_rng(
            self._seed + 1_000_003 * self._host_shard[0]
        )
        for _ in range(int(state["epoch"])):
            self._rng.permutation(self._users)
        self._perm = self._rng.permutation(self._users)
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        lanes: List[Optional[list]] = []
        for l in state["lanes"]:
            if l is None:
                lanes.append(None)
            else:
                u, idx, fresh = int(l[0]), int(l[1]), bool(l[2])
                lanes.append([u, self._ds.train_seq(u), idx, fresh])
        self._lanes = lanes
        # The absolute batch index carries on from the restored position.
        self._count = int(state.get("count", 0))
        self._snapshots = []

    # ---- iteration -----------------------------------------------------

    def _next_session(self) -> Tuple[int, np.ndarray]:
        while True:
            if self._pos >= len(self._perm):
                self._epoch += 1
                self._perm = self._rng.permutation(self._users)
                self._pos = 0
            u = int(self._perm[self._pos])
            self._pos += 1
            s = self._ds.train_seq(u)
            if len(s) >= 2:
                return u, s

    def __iter__(self) -> "SessionStream":
        return self

    def __next__(self) -> Tuple[int, Batch]:
        self._snapshots.append((self._count, self._snapshot()))
        if len(self._snapshots) > self._snapshot_depth:
            self._snapshots.pop(0)
        B, window = self._batch_size, self._window
        inputs = np.zeros((B, window), np.int32)
        targets = np.zeros((B, window), np.int32)
        reset = np.zeros((B, window), np.float32)
        lanes = self._lanes
        for r in range(B):
            pos = 0
            while pos < window:
                if lanes[r] is None:
                    u, s = self._next_session()
                    lanes[r] = [u, s, 0, True]
                user, seq, idx, fresh = lanes[r]
                take = min((len(seq) - 1) - idx, window - pos)
                inputs[r, pos:pos + take] = seq[idx:idx + take]
                targets[r, pos:pos + take] = seq[idx + 1:idx + take + 1]
                if fresh:
                    reset[r, pos] = 1.0
                pos += take
                idx += take
                lanes[r] = (
                    None if idx >= len(seq) - 1 else [user, seq, idx, False]
                )
        self._count += 1
        return window, {
            "inputs": inputs,
            "targets": targets,
            "mask": np.ones((B, window), np.float32),
            "reset": reset,
        }


def make_session_stream(
    ds: SequenceDataset,
    *,
    batch_size: int,
    window: int,
    seed: int = 0,
    host_shard: Tuple[int, int] = (0, 1),
    snapshot_depth: Optional[int] = None,
) -> SessionStream:
    """See SessionStream; the constructor name the trainer uses."""
    return SessionStream(
        ds, batch_size=batch_size, window=window, seed=seed,
        host_shard=host_shard, snapshot_depth=snapshot_depth,
    )


def make_eval_batches(
    ds: SequenceDataset,
    *,
    split: str,
    batch_size: int,
    max_len: int,
    max_batches: Optional[int] = None,
    host_shard: Tuple[int, int] = (0, 1),
) -> Iterator[Batch]:
    """Eval batches: history (padded to max_len) and held-out target.

    Keys: inputs [B, T], mask [B, T], target [B], valid [B] (0 = padding
    row), users [B]. Row layout matches `scores()`: the last real position
    predicts. The last batch may have fewer rows (`pad_batch_rows`).
    """
    rows: List[Dict[str, np.ndarray]] = []
    emitted = 0
    for u in range(ds.num_users):
        if u % host_shard[1] != host_shard[0]:
            continue
        ex = ds.eval_example(u, split)
        if ex is None:
            continue
        ex = dict(ex, user=u + 1)  # row 0 = unknown user
        rows.append(ex)
        if len(rows) == batch_size:
            yield _pack_eval(rows, max_len)
            rows = []
            emitted += 1
            if max_batches is not None and emitted >= max_batches:
                return
    if rows:
        yield _pack_eval(rows, max_len)


def _pack_eval(rows: List[Dict[str, np.ndarray]], max_len: int) -> Batch:
    B = len(rows)
    inputs = np.zeros((B, max_len), dtype=np.int32)
    mask = np.zeros((B, max_len), dtype=np.float32)
    target = np.zeros((B,), dtype=np.int32)
    valid = np.zeros((B,), dtype=np.float32)
    users = np.zeros((B,), dtype=np.int32)
    for r, ex in enumerate(rows):
        h = ex["history"]
        if len(h) > max_len:
            h = h[-max_len:]
        inputs[r, : len(h)] = h
        mask[r, : len(h)] = 1.0
        target[r] = ex["target"]
        valid[r] = 1.0
        users[r] = ex.get("user", 0)
    return {"inputs": inputs, "mask": mask, "target": target, "valid": valid,
            "users": users}


def pad_batch_rows(batch: Batch, to_rows: int) -> Batch:
    """Zero-pad a batch's leading dim to `to_rows` (one eval batch shape)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] < to_rows:
            pad = np.zeros((to_rows - v.shape[0],) + v.shape[1:], dtype=v.dtype)
            out[k] = np.concatenate([v, pad], axis=0)
        else:
            out[k] = v
    return out
