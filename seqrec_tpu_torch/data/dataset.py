"""The dataset container, its on-disk format, the raw-file parsers and the
synthetic generator: the port's copy of `seqrec_tpu/data/dataset.py`.

Numpy only, copied rather than imported, so that the same files and seed
give the same sequences, array for array. On disk (`prepare_dataset`):
``{data_dir}/{name}/seqs.npz`` holds the ragged per-user chronological item
sequences as a flat ``items`` array and ``offsets``, and ``vocab.json`` the
id mapping's metadata.

Split rule: leave-last-out per user. ``seq[:-2]`` trains, ``seq[-2]`` is
the validation target and ``seq[-1]`` the test target (users with fewer
than 3 interactions train on what they have and are skipped in eval). Item
ids are 1..N by decreasing global frequency (id 0 = pad), so the
log-uniform negative sampler approximates the unigram distribution.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from seqrec_tpu_torch.config import DataConfig

PAD_ID = 0


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

    def sequences(self) -> List[np.ndarray]:
        return [self.seq(u) for u in range(self.num_users)]

    # ---- splits (leave-last-out) ------------------------------------

    def train_seq(self, u: int, for_eval_split: str = "test") -> np.ndarray:
        """History available for training. With the standard protocol the
        last 2 items are held out (val + test)."""
        s = self.seq(u)
        if len(s) < 3:
            return s[:-1] if len(s) > 1 else s
        return s[:-2]

    def eval_example(self, u: int, split: str) -> Optional[Dict[str, np.ndarray]]:
        """(history, target) for val/test eval; None if user too short."""
        s = self.seq(u)
        if len(s) < 3:
            return None
        if split == "val":
            return {"history": s[:-2], "target": s[-2]}
        if split == "test":
            return {"history": s[:-1], "target": s[-1]}
        raise ValueError(f"unknown split {split!r}")

    # ---- persistence -------------------------------------------------

    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(
            os.path.join(out_dir, "seqs.npz"), items=self.items, offsets=self.offsets
        )
        with open(os.path.join(out_dir, "vocab.json"), "w") as f:
            json.dump(
                {"vocab_size": int(self.vocab_size), "name": self.name,
                 "num_users": int(self.num_users), "pad_id": PAD_ID},
                f,
            )

    @classmethod
    def load(cls, in_dir: str) -> "SequenceDataset":
        z = np.load(os.path.join(in_dir, "seqs.npz"))
        with open(os.path.join(in_dir, "vocab.json")) as f:
            meta = json.load(f)
        return cls(
            items=z["items"].astype(np.int32),
            offsets=z["offsets"].astype(np.int64),
            vocab_size=int(meta["vocab_size"]),
            name=meta.get("name", "unknown"),
        )


# ---------------------------------------------------------------------------
# Construction from raw interactions
# ---------------------------------------------------------------------------


def from_interactions(
    users: Sequence,
    items: Sequence,
    timestamps: Sequence,
    *,
    min_seq_len: int = 2,
    min_item_count: int = 1,
    name: str = "dataset",
) -> SequenceDataset:
    """Build a SequenceDataset from (user, item, ts) triples.

    - items seen < min_item_count times are dropped (5-core filtering for
      Beauty/Steam uses min_item_count=5 applied to users AND items);
    - item ids assigned by decreasing frequency (1 = most popular);
    - per-user sort by timestamp (stable, so file order breaks ties);
    - users with < min_seq_len interactions dropped.
    """
    users = np.asarray(users)
    items_raw = np.asarray(items)
    ts = np.asarray(timestamps)

    if min_item_count > 1:
        # Iterative k-core on users and items.
        keep = np.ones(len(users), dtype=bool)
        for _ in range(20):
            u_vals, u_counts = np.unique(users[keep], return_counts=True)
            i_vals, i_counts = np.unique(items_raw[keep], return_counts=True)
            bad_u = set(u_vals[u_counts < min_item_count].tolist())
            bad_i = set(i_vals[i_counts < min_item_count].tolist())
            if not bad_u and not bad_i:
                break
            new_keep = keep & ~np.isin(users, list(bad_u)) & ~np.isin(
                items_raw, list(bad_i)
            )
            if new_keep.sum() == keep.sum():
                break
            keep = new_keep
        users, items_raw, ts = users[keep], items_raw[keep], ts[keep]

    # Frequency-ordered item vocab: id 1 = most frequent.
    vals, counts = np.unique(items_raw, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    id_map = {v: i + 1 for i, v in enumerate(vals[order].tolist())}
    mapped = np.array([id_map[v] for v in items_raw.tolist()], dtype=np.int32)

    # Stable sort by (user, ts).
    sort_idx = np.lexsort((ts, users))
    users_s, mapped_s = users[sort_idx], mapped[sort_idx]

    out_items: List[np.ndarray] = []
    offsets = [0]
    start = 0
    n = len(users_s)
    for i in range(1, n + 1):
        if i == n or users_s[i] != users_s[start]:
            seq = mapped_s[start:i]
            if len(seq) >= min_seq_len:
                out_items.append(seq)
                offsets.append(offsets[-1] + len(seq))
            start = i
    flat = (
        np.concatenate(out_items).astype(np.int32)
        if out_items
        else np.zeros((0,), np.int32)
    )
    return SequenceDataset(
        items=flat,
        offsets=np.asarray(offsets, dtype=np.int64),
        vocab_size=len(vals) + 1,
        name=name,
    )


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
    return SequenceDataset(
        items=flat,
        offsets=offsets,
        vocab_size=num_items + 1,
        name=name,
    )


# ---------------------------------------------------------------------------
# Raw-file parsers (the files are placed by hand: nothing is downloaded)
# ---------------------------------------------------------------------------


def _parse_ml100k(path: str) -> SequenceDataset:
    """MovieLens-100K `u.data`: user \\t item \\t rating \\t ts."""
    data = np.loadtxt(path, dtype=np.int64)
    return from_interactions(
        data[:, 0], data[:, 1], data[:, 3], min_seq_len=2, name="ml-100k"
    )


def _parse_ml1m(path: str) -> SequenceDataset:
    """MovieLens-1M `ratings.dat`: user::item::rating::ts."""
    users, items, ts = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) != 4:
                continue
            users.append(int(parts[0]))
            items.append(int(parts[1]))
            ts.append(int(parts[3]))
    return from_interactions(users, items, ts, min_seq_len=2, name="ml-1m")


def _parse_amazon_csv(path: str, name: str) -> SequenceDataset:
    """Amazon ratings csv: user,item,rating,timestamp (5-core filtered)."""
    users, items, ts = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 4:
                continue
            users.append(parts[0])
            items.append(parts[1])
            ts.append(float(parts[3]))
    return from_interactions(
        users, items, ts, min_seq_len=5, min_item_count=5, name=name
    )


def _parse_steam(path: str) -> SequenceDataset:
    """Steam reviews jsonl with `username`, `product_id`, `date` fields."""
    import ast

    users, items, ts = [], [], []
    with open(path) as f:
        for line in f:
            try:
                d = ast.literal_eval(line.strip())
            except (ValueError, SyntaxError):
                continue
            u, it = d.get("username"), d.get("product_id")
            date = d.get("date", "")
            if u is None or it is None:
                continue
            users.append(u)
            items.append(it)
            ts.append(date)
    return from_interactions(
        users, items, ts, min_seq_len=5, min_item_count=5, name="steam"
    )


def _parse_rsc15(path: str) -> SequenceDataset:
    """RecSys Challenge 2015 / yoochoose `yoochoose-clicks.dat`:
    session_id,ISO-timestamp,item_id,category. Sessions are the sequences
    (session-based recommendation, the GRU4Rec paper's dataset). Standard
    preprocessing: drop items clicked < 5 times, then sessions shorter
    than 2 (item filter first, NOT iterative session/item k-core)."""
    sessions, items, ts = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 3:
                continue
            sessions.append(int(parts[0]))
            # ISO8601 lexicographic order == chronological; keep the string.
            ts.append(parts[1])
            items.append(int(parts[2]))
    items_arr = np.asarray(items)
    vals, counts = np.unique(items_arr, return_counts=True)
    # Vectorized membership: the real yoochoose-clicks.dat is ~33M rows; a
    # Python set-lookup loop over every click dominates prep time there.
    keep = np.isin(items_arr, vals[counts >= 5])
    return from_interactions(
        np.asarray(sessions)[keep], items_arr[keep], np.asarray(ts)[keep],
        min_seq_len=2, name="rsc15",
    )


_RAW_FILES = {
    "ml-100k": ("u.data", _parse_ml100k),
    "ml-1m": ("ratings.dat", _parse_ml1m),
    "beauty": ("ratings_Beauty.csv", lambda p: _parse_amazon_csv(p, "beauty")),
    "steam": ("steam_reviews.json", _parse_steam),
    "rsc15": ("yoochoose-clicks.dat", _parse_rsc15),
}


def prepare_dataset(name: str, data_dir: str, cfg: Optional[DataConfig] = None) -> SequenceDataset:
    """Build + persist the canonical format from raw files (or synthesize)."""
    cfg = cfg or DataConfig()
    out_dir = os.path.join(data_dir, name)
    if name == "synthetic":
        ds = synthetic_dataset(
            cfg.synthetic_num_users,
            cfg.synthetic_num_items,
            seed=cfg.seed,
            zipf_a=cfg.synthetic_zipf_a,
            min_len=cfg.synthetic_min_len,
            max_len=cfg.synthetic_max_len,
        )
    elif name in _RAW_FILES:
        raw_name, parser = _RAW_FILES[name]
        candidates = [
            os.path.join(data_dir, name, raw_name),
            os.path.join(data_dir, "raw", name, raw_name),
            os.path.join(data_dir, raw_name),
        ]
        raw_path = next((p for p in candidates if os.path.exists(p)), None)
        if raw_path is None:
            raise FileNotFoundError(
                f"raw file {raw_name!r} for dataset {name!r} not found under "
                f"{data_dir!r} (nothing is downloaded; place it there manually)"
            )
        ds = parser(raw_path)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    ds.save(out_dir)
    return ds


def load_dataset(cfg: DataConfig) -> SequenceDataset:
    """Load prepared data, preparing it on the fly if needed/possible."""
    out_dir = os.path.join(cfg.data_dir, cfg.dataset)
    if os.path.exists(os.path.join(out_dir, "seqs.npz")):
        return SequenceDataset.load(out_dir)
    return prepare_dataset(cfg.dataset, cfg.data_dir, cfg)
