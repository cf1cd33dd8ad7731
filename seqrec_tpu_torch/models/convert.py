"""JAX parameters -> the port's `state_dict`, and `.npz` files of them.

The JAX model's parameters are a flax tree, here as nested dicts of numpy
arrays:

    {'params': {'item_embedding': [rows, D],
                'output_embedding': [rows, H],   # untied tables only
                'output_bias': [rows],           # full_softmax only
                'user_embedding': [users+1, D],  # use_user_embedding only
                'tower': {'gru0_wx': [D, 3H], 'gru0_wh': [H, 3H],
                          'gru0_bx': [3H], 'gru0_bh': [3H], ...}}}

(an LSTM tower has `lstm{l}_wx` [D, 4H], `lstm{l}_wh` [H, 4H], `lstm{l}_b`
[4H]; a SASRec tower `pos_embedding`, `LayerNorm_0` and `block{i}` subtrees
of `LayerNorm_{0,1}`, `qkv`, `proj`, `Dense_{0,1}`).

The port keeps the flax names and layouts, so a leaf at path `a/b/c` becomes
`state_dict['a.b.c']` unchanged. A `.npz` file holds the same leaves under
their `/`-joined paths (`params/tower/gru0_wx`).

`random_params` draws such a tree with numpy from a seed, with the flax
initializers' distributions, for runs that need weights without a trained
checkpoint: normal(1/sqrt(D)) tables; Glorot-uniform `*_wx`, orthogonal
`*_wh`, zero biases but the LSTM's forget block at +1; and SASRec's
normal(0.02) `pos_embedding`, LeCun-normal dense `kernel`s (truncated at two
standard deviations, over the fan-in), LayerNorm `scale` ones and zero
`bias`es. `init_state_dict` gives the same values as a state_dict on a
device, drawing the embedding tables in row blocks straight into the device
tensor (a 10M-row table is never whole on the host).

A model with row-sharded tables (`SeqRecModel.table_window`) holds one
rank's shard of each (and of the full softmax's output bias):
`random_params` draws the whole tables all the same
(the JAX tree), `shard_state_dict` cuts a whole state_dict into this rank's
shard, and `init_state_dict` draws the whole stream and keeps the shard's
rows only: a rank draws, and drops, the blocks of every other shard (the
tower's draws come after the tables' in the one numpy stream), and never
holds more than a block of another shard's rows.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (with or without the top 'params' level) as the
    port's state_dict."""
    params = tree["params"] if "params" in tree else tree
    return {path.replace("/", "."): torch.from_numpy(np.array(v))
            for path, v in _flatten(params).items()}


def save_npz(path: str, tree: Mapping) -> None:
    """Write a flax tree's leaves under their '/'-joined paths."""
    np.savez(path, **_flatten(tree))


def load_npz(path: str) -> Dict:
    """Read a file written by `save_npz` back into a nested tree."""
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files})


def _orthogonal(rng: np.random.Generator, shape) -> np.ndarray:
    """flax.linen.initializers.orthogonal(column_axis=-1) for a 2-D shape."""
    n_rows, n_cols = shape
    a = rng.normal(size=(n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    return q.T if n_rows < n_cols else q


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal draws redrawn until they fall within two standard
    deviations, as `jax.random.truncated_normal(-2, 2)`."""
    a = rng.standard_normal(size=shape)
    bad = np.abs(a) > 2.0
    while bad.any():
        a[bad] = rng.standard_normal(size=int(bad.sum()))
        bad = np.abs(a) > 2.0
    return a


def _init_leaf(rng: np.random.Generator, leaf: str, shape) -> np.ndarray:
    """One parameter, by its flax name, with its flax initializer's law."""
    if leaf == "pos_embedding":
        return rng.normal(scale=0.02, size=shape)
    if leaf.endswith("_embedding"):
        return rng.normal(scale=1.0 / np.sqrt(shape[1]), size=shape)
    if leaf == "kernel":  # lecun_normal: variance 1 / fan_in, truncated
        std = np.sqrt(1.0 / shape[0]) / 0.87962566103423978
        return _truncated_normal(rng, shape) * std
    if leaf == "scale":
        return np.ones(shape)
    if leaf.endswith("_wx"):
        limit = np.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-limit, limit, size=shape)
    if leaf.endswith("_wh"):
        return _orthogonal(rng, shape)
    a = np.zeros(shape)  # biases and output_bias
    if leaf.startswith("lstm") and leaf.endswith("_b"):
        H = shape[0] // 4
        a[H:2 * H] = 1.0  # the forget gate's +1 (blocks i|f|g|o)
    return a


def _is_table(leaf: str) -> bool:
    return leaf.endswith("_embedding") and leaf != "pos_embedding"


def _whole_shape(model, name: str, p) -> tuple:
    """The shape of the whole parameter `name` (a row-sharded table's whole
    rows; `model` may be any module without `table_window`)."""
    window = getattr(model, "table_window", lambda _: None)(name)
    return tuple(p.shape) if window is None else (window[1], *p.shape[1:])


def random_params(model, seed: int) -> Dict:
    """A flax-layout tree for `model` (a SeqRecModel), drawn with numpy from
    `seed` with the flax initializers' distributions, in f32. Leaves nest by
    their full path (`tower.block0.LayerNorm_0.scale` ->
    params/tower/block0/LayerNorm_0/scale). A row-sharded model's tables are
    drawn whole."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        flat[path] = _init_leaf(rng, path.rsplit("/", 1)[-1],
                                _whole_shape(model, name, p)).astype(np.float32)
    return {"params": _unflatten(flat)}


def shard_state_dict(state: Mapping[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """A whole state_dict (`flax_to_state_dict` of a JAX tree) cut to the
    shard `model` holds of each row-sharded table; other leaves as given."""
    out = {}
    for name, t in state.items():
        window = model.table_window(name)
        if window is not None:
            rows = getattr(model, name).shape[0]
            t = t[window[0]:window[0] + rows]
        out[name] = t
    return out


TABLE_BLOCK_ROWS = 1 << 19  # rows a block of init_state_dict's table draws


def init_state_dict(model, seed: int, device, block_rows: int = TABLE_BLOCK_ROWS
                    ) -> Dict[str, torch.Tensor]:
    """`flax_to_state_dict(random_params(model, seed))` on `device`, bit for
    bit, without the whole tree on the host: an embedding table's normal
    draws are made `block_rows` rows at a time (a numpy Generator gives the
    same stream in consecutive blocks) and each block, cast to f32, is
    written into the device tensor. The other leaves are drawn whole, in
    the same order from the same generator."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = _whole_shape(model, name, p)
        # The rows this module keeps: all of them, or its shard's window.
        window = getattr(model, "table_window", lambda _: None)(name)
        if not _is_table(leaf):  # drawn whole; a sharded one (the output bias) cut
            a = _init_leaf(rng, leaf, shape)
            if window is not None:
                a = a[window[0]:window[0] + p.shape[0]]
            out[name] = torch.from_numpy(a.astype(np.float32)).to(device)
            continue
        lo = 0 if window is None else window[0]
        hi = lo + p.shape[0]
        t = torch.empty((hi - lo, shape[1]), dtype=torch.float32, device=device)
        scale = 1.0 / np.sqrt(shape[1])
        for r0 in range(0, shape[0], block_rows):
            n = min(block_rows, shape[0] - r0)
            block = rng.normal(scale=scale, size=(n, shape[1])).astype(np.float32)
            a, b = max(r0, lo), min(r0 + n, hi)
            if a < b:  # the part of the block in the window
                t[a - lo:b - lo].copy_(torch.from_numpy(block[a - r0:b - r0]))
        out[name] = t
    return out
