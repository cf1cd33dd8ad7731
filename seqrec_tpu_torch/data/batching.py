"""Session-parallel packed windows: the port's copy of `SessionStream` and
`make_session_stream` from `seqrec_tpu/data/batching.py`.

Numpy only, copied rather than imported: the same dataset and seed give the
same windows, bit for bit. The bucketed batcher comes with the data pipeline
(ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from seqrec_tpu_torch.data.dataset import SequenceDataset

Batch = Dict[str, np.ndarray]


class SessionStream:
    """Session-parallel packed stream, the original GRU4Rec training regime
    (Hidasi et al., ICLR'16 §3.1.1).

    B lanes each stream a concatenation of training sessions; every window
    is a dense [B, window] block of (input, target) pairs with no padding
    (mask all ones), plus a `reset` plane marking the positions where a new
    session begins (the recurrent state is zeroed before consuming them).
    Sessions that cross a window boundary continue in the next window, and
    the trainer carries the recurrent state across windows (truncated BPTT).
    An infinite iterator, deterministic given the seed. Single-host: it
    draws as the JAX package's shard 0 of 1 does.

    The stream's whole position is (epochs consumed, index into the current
    permutation, per-lane (user, pair index, fresh) cursors). `state_at(n)`
    returns it for recent batch boundaries (a ring of `SNAPSHOT_DEPTH`
    entries absorbs a prefetcher's read-ahead); `restore()` rebuilds the
    stream from it by redrawing the permutations, with no batch replay.
    """

    SNAPSHOT_DEPTH = 16

    def __init__(
        self,
        ds: SequenceDataset,
        *,
        batch_size: int,
        window: int,
        seed: int = 0,
    ):
        if ds.num_users == 0:
            raise ValueError("dataset has no users")
        self._ds = ds
        self._batch_size = batch_size
        self._window = window
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._users = np.arange(ds.num_users)
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
            "lanes": [None if lane is None else [int(lane[0]), int(lane[2]), bool(lane[3])]
                      for lane in self._lanes],
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
        raise KeyError(f"no snapshot for batch {n} (have head {self._count} and "
                       f"{[c for c, _ in self._snapshots]})")

    def restore(self, state: dict) -> None:
        """Move this stream to a `state_at` snapshot: redraw the permutations
        from a fresh generator up to the snapshot's epoch (permutations are
        the generator's only use) and reload lane sequences by user id."""
        self._rng = np.random.default_rng(self._seed)
        for _ in range(int(state["epoch"])):
            self._rng.permutation(self._users)
        self._perm = self._rng.permutation(self._users)
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        lanes: List[Optional[list]] = []
        for lane in state["lanes"]:
            if lane is None:
                lanes.append(None)
            else:
                u, idx, fresh = int(lane[0]), int(lane[1]), bool(lane[2])
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
        if len(self._snapshots) > self.SNAPSHOT_DEPTH:
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
                lanes[r] = None if idx >= len(seq) - 1 else [user, seq, idx, False]
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
) -> SessionStream:
    """See SessionStream; the constructor name the JAX package's trainer uses."""
    return SessionStream(ds, batch_size=batch_size, window=window, seed=seed)
