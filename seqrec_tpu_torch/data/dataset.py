"""The dataset container and its synthetic generator: the port's copy of
`seqrec_tpu/data/dataset.py` (`SequenceDataset`, `synthetic_dataset`).

Numpy only, copied rather than imported, so that the same seed gives the same
sequences, array for array. The ragged per-user chronological item sequences
are a flat ``items`` array and ``offsets``. Item ids are 1..N (id 0 = pad).
Split rule: leave-last-out per user (``seq[:-2]`` trains). The on-disk
format, the eval split, the raw-file parsers, `prepare_dataset` and
`load_dataset` come with the data pipeline (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SequenceDataset:
    """Ragged per-user sequences, chronological, ids already remapped."""

    items: np.ndarray  # [total] int32, concatenated sequences
    offsets: np.ndarray  # [num_users + 1] int64
    vocab_size: int  # num real items + 1 (pad)
    name: str = "synthetic"

    @property
    def num_users(self) -> int:
        return len(self.offsets) - 1

    def seq(self, u: int) -> np.ndarray:
        return self.items[self.offsets[u]: self.offsets[u + 1]]

    def train_seq(self, u: int) -> np.ndarray:
        """History available for training: the last 2 items are held out
        (val + test); shorter sequences keep all but their last item."""
        s = self.seq(u)
        if len(s) < 3:
            return s[:-1] if len(s) > 1 else s
        return s[:-2]


def synthetic_dataset(
    num_users: int,
    num_items: int,
    *,
    seed: int = 0,
    zipf_a: float = 1.1,
    min_len: int = 5,
    max_len: int = 60,
    name: str = "synthetic",
) -> SequenceDataset:
    """Zipf-distributed synthetic interaction stream with weak sequential
    structure (a Markov bigram blend), so that a model has a next-item
    signal to learn. Vectorized: O(users * max_len) numpy work."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=num_users)
    Lmax = int(lengths.max()) if num_users else 0

    # Zipf draws (rank 1 = most likely = id 1): values beyond the catalog are
    # redrawn a few rounds, then the stragglers are clipped into range.
    grid = rng.zipf(zipf_a, size=(num_users, Lmax)).astype(np.int64)
    for _ in range(4):
        bad = grid > num_items
        if not bad.any():
            break
        grid[bad] = rng.zipf(zipf_a, size=int(bad.sum()))
    np.clip(grid, 1, num_items, out=grid)
    seq = grid.astype(np.int64)

    # Bigram structure, one column at a time: with p=0.5, item[t] is a
    # function of item[t-1] in the modified sequence.
    coin = rng.random(size=(num_users, Lmax)) < 0.5
    for t in range(1, Lmax):
        f_prev = (seq[:, t - 1] * 2) % num_items + 1
        seq[:, t] = np.where(coin[:, t], f_prev, seq[:, t])

    mask = np.arange(Lmax)[None, :] < lengths[:, None]
    flat = seq[mask].astype(np.int32)
    offsets = np.zeros(num_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return SequenceDataset(items=flat, offsets=offsets, vocab_size=num_items + 1, name=name)
